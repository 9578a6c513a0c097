"""Wanda (Sun et al. 2023): prune by |W_ij| · ‖X[:, j]‖₂, row-wise groups.

Equivalent to approximating C^½ by its diagonal in Eq. (3); also AWP's
pruning initializer (§4.1). Paper orientation (d_out, d_in): the activation
scale multiplies columns. Leading dims of ``w`` and ``c`` are a stack of
independent layers (the batched engine's buckets).
"""
from __future__ import annotations

import torch

from repro_torch.core import calibration as calib, projections as proj, registry
from repro_torch.core.specs import PruneSpec


def scores(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Wanda importance: |W| · sqrt(C_jj) (∝ ‖X[:, j]‖₂; the constant n
    drops out of top-k)."""
    col_scale = torch.sqrt(torch.clamp(torch.diagonal(c, dim1=-2, dim2=-1),
                                       min=0.0))
    return w.abs() * col_scale[..., None, :]


def prune_weight(w: torch.Tensor, c: torch.Tensor, k: int) -> torch.Tensor:
    """Zero everything outside the per-row top-k of the Wanda score (ties
    by lower index, as ``jax.lax.top_k`` ranks them)."""
    mask = proj.topk_row_mask(scores(w, c), k)
    return torch.where(mask, w, torch.zeros_like(w))


def prune_weight_n_m(w: torch.Tensor, c: torch.Tensor, n: int = 2,
                     m: int = 4) -> torch.Tensor:
    """N:M structured Wanda: keep the n best-scored of every m consecutive
    entries along d_in."""
    s = scores(w, c)
    d_in = w.shape[-1]
    group = w.shape[:-1] + (d_in // m, m)
    keep = proj.n_m_keep(s.reshape(group), n)
    g = w.reshape(group)
    return torch.where(keep, g, torch.zeros_like(g)).reshape(w.shape)


@registry.register("wanda", spec_cls=PruneSpec)
def _compress(w, stats, spec):
    c = calib.covariance(stats, damp=spec.damp)
    if spec.nm is not None:
        theta = prune_weight_n_m(w, c, *spec.nm)
    else:
        theta = prune_weight(w, c, spec.k_for(w.shape[1]))
    return registry.CompressResult(theta=theta, mask=theta != 0,
                                   aux={"covariance": c})


__all__ = ["scores", "prune_weight", "prune_weight_n_m"]
