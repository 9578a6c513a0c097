"""Calibration statistics for activation-aware compression.

Per linear layer: the input auto-correlation ``C = (1/n) Xᵀ X`` (paper
Alg. 1) plus the per-channel Σ|x| that AWQ-style scales need. Batches are
folded in one at a time, so the calibration set is never materialized.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class CalibStats(NamedTuple):
    """Sufficient statistics of one linear layer's input activations."""
    n: torch.Tensor          # () f32 — tokens folded in
    c_sum: torch.Tensor      # (d_in, d_in) f32 — Σ xᵀx
    abs_sum: torch.Tensor    # (d_in,) f32 — Σ |x|


def init(d_in: int, device="cuda") -> CalibStats:
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return CalibStats(n=torch.zeros((), dtype=torch.float32, device=dev),
                      c_sum=torch.zeros((d_in, d_in), dtype=torch.float32,
                                        device=dev),
                      abs_sum=torch.zeros((d_in,), dtype=torch.float32,
                                          device=dev))


def update(stats: CalibStats, acts: torch.Tensor) -> CalibStats:
    """Fold a batch of activations (..., d_in); leading dims are tokens."""
    a = acts.reshape(-1, acts.shape[-1]).to(torch.float32)
    return CalibStats(n=stats.n + a.shape[0],
                      c_sum=stats.c_sum + a.T @ a,
                      abs_sum=stats.abs_sum + a.abs().sum(dim=0))


def covariance(stats: CalibStats, damp: float = 0.0) -> torch.Tensor:
    """C = (1/n) Σ xᵀx, damped by ``damp·mean(diag(C))·I`` when ``damp``.
    Broadcasts over leading batch dims: stacked stats give (B, d_in, d_in)."""
    n = torch.clamp(stats.n, min=1.0)
    c = stats.c_sum / n[..., None, None]
    if damp:
        d_in = c.shape[-1]
        tr = torch.diagonal(c, dim1=-2, dim2=-1).sum(-1)
        c = c + (damp * tr[..., None, None] / d_in) * torch.eye(
            d_in, dtype=c.dtype, device=c.device)
    return c


def act_mean_abs(stats: CalibStats) -> torch.Tensor:
    """Per-channel mean |x| (AWQ's activation scale)."""
    return stats.abs_sum / torch.clamp(stats.n, min=1.0)[..., None]


def col_l2(stats: CalibStats) -> torch.Tensor:
    """Per-channel ‖X[:, i]‖₂ (Wanda's activation scale) = sqrt(n·C_ii)."""
    return torch.sqrt(torch.clamp(
        torch.diagonal(stats.c_sum, dim1=-2, dim2=-1), min=0.0))


def stack_stats(stats_list: Sequence[CalibStats]) -> CalibStats:
    """Stack B layers' stats into one batched CalibStats (leading dim B)."""
    return CalibStats(*(torch.stack(xs) for xs in zip(*stats_list)))


__all__ = ["CalibStats", "init", "update", "covariance", "act_mean_abs",
           "col_l2", "stack_stats"]
