"""Magnitude pruning — the activation-blind baseline of Eq. (1)."""
from __future__ import annotations

import torch

from repro_torch.core import projections as proj, registry
from repro_torch.core.specs import PruneSpec


def prune_weight(w: torch.Tensor, k: int, per_row: bool = True) -> torch.Tensor:
    """Keep the k largest |w| per row (Wanda's comparison groups, which the
    paper's Tables 1-2 use), or k·d_out over the whole matrix."""
    if per_row:
        return proj.topk_row(w, k)
    return proj.topk_matrix(w, k * w.shape[0])


@registry.register("magnitude", spec_cls=PruneSpec)
def _compress(w, stats, spec):
    theta = prune_weight(w, spec.k_for(w.shape[1]))
    return registry.CompressResult(theta=theta, mask=theta != 0)


__all__ = ["prune_weight"]
