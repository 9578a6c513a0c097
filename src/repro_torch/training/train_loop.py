"""Training loop substrate (the port of ``repro/training/train_loop.py``):
a train-step factory with microbatched gradient accumulation.

The train state is the reference's tree, ``{"params", "opt", "step"}``,
with ``step`` a 0-dim int32 tensor on the params' device, so a state
checkpoint written by either package restores in the other. Gradients are
PyTorch autograd through the model's own forward (:meth:`DenseModel.loss`;
the reference's ``jax.value_and_grad``). A step reads nothing on the host:
its metrics (``loss``, ``lr``, ``grad_norm``) stay tensors on the device.

The step updates params and optimizer state in place (the optimizers'
in-place form) and returns them in a new state dict with the next step
counter: the reference's CLI donates its state to the jitted step, so
nothing keeps the old one, and one copy of the state is held instead of
two. A caller that needs the state before a step clones it.

The data-parallel step with compressed gradient all-reduce
(``make_train_step_ddp``) comes with the multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.optim.optimizers import (OptimizerConfig, make_optimizer,
                                          tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """``unroll_accum`` is kept for the reference's configs: there it
    replaces the accumulation ``lax.scan`` with a Python loop for the
    dry-run's cost lowering. Eager PyTorch has only the loop form, so the
    field changes nothing here."""
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1          # gradient-accumulation steps per update
    compute_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32  # grad-accumulation carry dtype
    unroll_accum: bool = False


def init_train_state(model, seed: int = 0, *, device="cuda",
                     tcfg: TrainConfig = TrainConfig()) -> Dict[str, Any]:
    """Params from ``seed`` (the model's own init), the optimizer's state
    and step 0."""
    params = model.init(seed, device=device)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    return {"params": params, "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["embed"].device)}


def loss_and_grads(model, params, batch):
    """(loss, grads, metrics) of ``model.loss`` on one batch: the params
    are detached into leaves that require grad (the caller's tensors keep
    no grad flag and no graph), and the gradient comes back as a tree of
    the params' structure. A leaf the loss never reads (the audio
    frontend's ``embed``: frames stand in for tokens) gets a zero
    gradient, as ``jax.value_and_grad`` gives it, so the optimizer still
    decays it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = []
    tree_map(flat.append, leaves)
    with torch.enable_grad():
        loss, metrics = model.loss(leaves, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return (loss.detach(), tree_map(lambda _: next(it), leaves),
            {k: v.detach() for k, v in metrics.items()})


def split_microbatches(batch, n: int) -> list:
    """The reference's interleaved split: microbatch i is rows i, n + i,
    2n + i, ... of the batch (element (i, j) = ``batch[j·n + i]``)."""
    def split(x):
        b = x.shape[0]
        return x.reshape(b // n, n, *x.shape[1:]).transpose(0, 1)
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def compute_grads(model, tcfg: TrainConfig, params, batch):
    """(loss, grads) of one update's batch: one backward, or with
    ``microbatches`` > 1 the batch split as the reference splits it
    (:func:`split_microbatches`) and the gradients accumulated in
    ``accum_dtype`` — each microbatch's gradient added in f32 and the sum
    rounded to ``accum_dtype`` — with the loss as Σ loss/n. Each
    microbatch's graph is freed before the next is built (memory = one
    microbatch's activations), and each leaf's gradient is added into the
    accumulator as soon as backward has it and then dropped (a
    post-accumulate-grad hook), so beside the params and the accumulator
    the card holds one leaf's gradient at a time, not a second gradient
    tree (24.9 GB for the MoE phase's 6.2e9 f32 parameters on the
    card)."""
    n = tcfg.microbatches
    if n <= 1:
        loss, grads, _ = loss_and_grads(model, params, batch)
        return loss, grads
    acc_t = tcfg.accum_dtype
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_t,
                                          device=p.device), params)
    flat, hooks = [], []

    def hook_into(acc):
        def hook(p):
            _accumulate(acc, p.grad, n)
            p.grad = None
        return hook

    def register(p, acc):
        flat.append(p)
        hooks.append(p.register_post_accumulate_grad_hook(hook_into(acc)))

    tree_map(register, leaves, gacc)
    loss = None
    try:
        for mb in split_microbatches(batch, n):
            with torch.enable_grad():
                part, _ = model.loss(leaves, mb)
                torch.autograd.backward(part, inputs=flat)
            part = part.detach() / n
            loss = part if loss is None else loss + part
    finally:
        for h in hooks:
            h.remove()
    return loss, gacc


def _accumulate(a: torch.Tensor, g: torch.Tensor, n: int) -> None:
    """a ← (a + g/n) rounded to a's dtype, the sum in f32 (the
    reference's carry), written into ``a``. A stacked leaf (ndim ≥ 3) is
    summed one layer at a time, so the f32 temporary is one layer's.
    ``g`` is autograd's and is not written: it may be shared between
    leaves or broadcast."""
    for ai, gi in (zip(a.unbind(0), g.unbind(0)) if a.dim() >= 3
                   else ((a, g),)):
        part = gi.to(torch.float32) / n
        if ai.dtype == torch.float32:
            ai.add_(part)
        else:
            ai.copy_(ai.to(torch.float32) + part)


def make_train_step(model, tcfg: TrainConfig):
    """Returns ``(train_step, opt_init)``; ``train_step(state, batch) ->
    (state, metrics)`` with metrics ``{"loss", "lr", "grad_norm"}``."""
    opt_init, opt_update = make_optimizer(tcfg.optimizer)

    def train_step(state, batch):
        loss, grads = compute_grads(model, tcfg, state["params"], batch)
        params, opt, om = opt_update(grads, state["opt"], state["params"])
        del grads
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, **om}

    return train_step, opt_init


__all__ = ["TrainConfig", "compute_grads", "init_train_state",
           "loss_and_grads", "make_train_step", "split_microbatches"]
