"""Wanda (Sun et al. 2023): prune by |W_ij| · ‖X[:, j]‖₂, row-wise groups.

Equivalent to approximating C^½ by its diagonal in Eq. (3); also AWP's
pruning initializer (§4.1). Paper orientation (d_out, d_in): the activation
scale multiplies columns.
"""
from __future__ import annotations

import torch

from repro_torch.core import calibration as calib, projections as proj, registry
from repro_torch.core.specs import PruneSpec


def scores(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Wanda importance: |W| · sqrt(C_jj) (∝ ‖X[:, j]‖₂; the constant n
    drops out of top-k)."""
    col_scale = torch.sqrt(torch.clamp(torch.diagonal(c), min=0.0))
    return w.abs() * col_scale[None, :]


def prune_weight(w: torch.Tensor, c: torch.Tensor, k: int) -> torch.Tensor:
    """Zero everything outside the per-row top-k of the Wanda score (ties
    by lower index, as ``jax.lax.top_k`` ranks them)."""
    mask = proj.topk_row_mask(scores(w, c), k)
    return torch.where(mask, w, torch.zeros_like(w))


@registry.register("wanda", spec_cls=PruneSpec)
def _compress(w, stats, spec):
    if spec.nm is not None:
        raise NotImplementedError("N:M Wanda is not ported")
    c = calib.covariance(stats, damp=spec.damp)
    theta = prune_weight(w, c, spec.k_for(w.shape[1]))
    return registry.CompressResult(theta=theta, mask=theta != 0,
                                   aux={"covariance": c})


__all__ = ["scores", "prune_weight"]
