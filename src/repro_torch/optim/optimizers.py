"""Optimizers from scratch: AdamW and Adafactor (the port of
``repro/optim/optimizers.py``).

AdamW      — full m/v states (small / medium models).
Adafactor  — factored second moments for ≥2D leaves (row/col RMS), O(n+m)
             state instead of O(n·m).
Both return ``(new_params, new_state, {"lr", "grad_norm"})``; all state is
a tree of nested dicts mirroring params (``{"m", "v", "step"}`` and
``{"v", "step"}``), so it checkpoints under the reference's key paths.
Every quantity stays a tensor on the params' device: the schedule, the
clip and the bias corrections are computed from the 0-dim int32 ``step``
there, and nothing is read on the host.

The updates write params and moments IN PLACE and return the same tensors
(a new step counter): the reference's train CLI donates the state, so no
caller keeps the old one, and the in-place form saves a second copy of
params and moments (15 GB at llama32-1b). The clipped gradient is not
materialized either: each leaf is scaled inside its update. Each
operation is the reference's, in its order, so the bits are those of the
functional form.

Per-layer semantics are the reference's: its AdamW maps the update over
the layer axis of leaves with ndim ≥ 3, which for an elementwise update is
the update of the whole stack at once; its Adafactor factors every leaf
with ndim ≥ 2 and maps leaves with ndim ≥ 3 per layer, so their row and
column statistics, the normaliser and the relative-step clip's RMS are
one layer's (reduced here over every axis but the layer axis).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: Literal["adamw", "adafactor"] = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def tree_map(fn, *trees):
    """``fn`` over the aligned tensor leaves of nested dicts (the structure
    of the first tree)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    """Leaves in sorted key order (the order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr, in f32 on the
    step's device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf in f32, the leaves' sums added in key
    order."""
    sq = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(gn, 1e-9)), the clip's factor."""
    return torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9),
                       max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def _f32_view(p: torch.Tensor) -> torch.Tensor:
    """``p`` itself when f32 (updated in place), else an f32 copy."""
    return p if p.dtype == torch.float32 else p.to(torch.float32)


def _write_back(p: torch.Tensor, p32: torch.Tensor) -> torch.Tensor:
    if p32 is not p:
        p.copy_(p32)
    return p


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params):
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params)).device)
    return {"m": zeros, "v": tree_map(torch.clone, zeros), "step": step}


def adamw_update(grads, state, params, cfg: OptimizerConfig):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gn = global_norm(grads)
    scale = clip_scale(gn, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    # the bias corrections as f32 powers, as the reference's b1 ** t
    bc1 = 1 - torch.pow(_f32(b1, t), t)
    bc2 = 1 - torch.pow(_f32(b2, t), t)

    def upd(g, m, v, p):
        # m2 = b1·m + (1 − b1)·g;  v2 = b2·v + ((1 − b2)·g)·g
        # p2 = p − lr·(m2/bc1 / (√(v2/bc2) + eps) + wd·p)
        g = g.to(torch.float32) * scale
        p32 = _f32_view(p)
        m.mul_(b1).add_((1 - b1) * g)
        tmp = (1 - b2) * g
        tmp.mul_(g)
        v.mul_(b2).add_(tmp)
        del g
        delta = m / bc1
        torch.div(v, bc2, out=tmp).sqrt_().add_(cfg.eps)
        delta.div_(tmp).add_(torch.mul(p32, cfg.weight_decay, out=tmp))
        del tmp
        p32.sub_(delta.mul_(lr))
        return _write_back(p, p32), m, v

    out = tree_map(upd, grads, state["m"], state["v"], params)
    return _part(out, 0), {"m": _part(out, 1), "v": _part(out, 2),
                           "step": step}, {"lr": lr, "grad_norm": gn}


def _part(tree, i: int):
    """The ``i``-th element of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _part(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Adafactor (factored v for ≥2D, momentum-free)
# ---------------------------------------------------------------------------

def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params):
    def leaf(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            # factor over the last two dims; leading dims (layer stack) kept
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params)).device)
    return {"v": tree_map(leaf, params), "step": step}


def _adafactor_leaf(g, v, p, scale, decay, lr, cfg: OptimizerConfig):
    """One leaf's (or one layer's) update, in place: the factored second
    moment over the last two dims (the full one for vectors), the update
    clipped to RMS 1 and decayed weights."""
    g = g.to(torch.float32) * scale
    p32 = _f32_view(p)
    g2 = g * g + 1e-30
    if _factored(p):
        vr = v["vr"].mul_(decay).add_((1 - decay) * g2.mean(dim=-1))
        vc = v["vc"].mul_(decay).add_((1 - decay) * g2.mean(dim=-2))
        denom = vr.mean(dim=-1, keepdim=True)[..., None]
        vhat = torch.mul(vr[..., None], vc[..., None, :], out=g2)
        vhat.div_(torch.clamp(denom, min=1e-30))
    else:
        vhat = v["v"].mul_(decay).add_((1 - decay) * g2)
    del g2
    update = g.div_(vhat.add(cfg.eps).sqrt_())
    del vhat
    # relative step clipping (adafactor d=1.0)
    rms = torch.sqrt((update * update).mean())
    update.div_(torch.clamp(rms, min=1.0))
    decayed = (lr * cfg.weight_decay) * p32
    p32.sub_(update.mul_(lr)).sub_(decayed)
    return _write_back(p, p32), v


def adafactor_update(grads, state, params, cfg: OptimizerConfig):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gn = global_norm(grads)
    scale = clip_scale(gn, cfg.clip_norm)
    decay = 1.0 - torch.pow(step.to(torch.float32), -0.8)  # beta2 schedule

    def upd(g, v, p):
        if p.dim() >= 3:
            # the reference's lax.map over the layer axis of a stacked
            # leaf: one layer's f32 temporaries at a time, its statistics
            # and relative-step RMS its own
            for i in range(p.shape[0]):
                _adafactor_leaf(g[i], {k: t[i] for k, t in v.items()}, p[i],
                                scale, decay, lr, cfg)
            return p, v
        return _adafactor_leaf(g, v, p, scale, decay, lr, cfg)

    out = tree_map(upd, grads, state["v"], params)
    return (_part(out, 0), {"v": _part(out, 1), "step": step},
            {"lr": lr, "grad_norm": gn})


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(g, s, p, cfg)
    if cfg.name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(g, s, p, cfg)
    raise ValueError(cfg.name)


__all__ = ["OptimizerConfig", "make_optimizer", "adamw_init", "adamw_update",
           "adafactor_init", "adafactor_update", "lr_schedule", "global_norm",
           "clip_by_global_norm", "clip_scale", "tree_map", "tree_leaves"]
