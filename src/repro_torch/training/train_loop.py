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
    the params' structure."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = []
    tree_map(flat.append, leaves)
    with torch.enable_grad():
        loss, metrics = model.loss(leaves, batch)
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
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
    microbatch's activations)."""
    n = tcfg.microbatches
    if n <= 1:
        loss, grads, _ = loss_and_grads(model, params, batch)
        return loss, grads
    acc_t = tcfg.accum_dtype
    loss = None
    gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_t,
                                          device=p.device), params)
    for mb in split_microbatches(batch, n):
        part, grads, _ = loss_and_grads(model, params, mb)
        gacc = tree_map(lambda a, g: (a.to(torch.float32)
                                      + g.to(torch.float32) / n).to(acc_t),
                        gacc, grads)
        del grads
        part = part / n
        loss = part if loss is None else loss + part
    return loss, gacc


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
