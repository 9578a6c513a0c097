"""Gradient compressors for the data-parallel sync (the port of
``repro/optim/grad_compress.py``): int8 linear quantization around the
max-|g| scale, its all-reduce-mean :func:`int8_psum` (used by the
data-parallel train step ``training.train_loop.make_train_step_ddp``,
where the gradient reduction is explicit and can therefore be
compressed), and top-k sparsification with error feedback.
"""
from __future__ import annotations

from typing import Tuple

import torch


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce-mean of int8-compressed gradients over ``group`` (a
    process group; None = the default group).

    Quantize locally, all-gather the int8 payload and the scales,
    dequantize and take the mean in rank order: each rank sends a quarter
    of its f32 gradient's bytes."""
    import torch.distributed as dist
    q, scale = int8_compress(g)
    n = dist.get_world_size(group)
    qs = torch.empty((n * q.numel(),), dtype=q.dtype, device=q.device)
    ss = torch.empty((n,), dtype=scale.dtype, device=scale.device)
    # torch 2.13 renames all_gather_into_tensor to all_gather_single
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(qs, q.reshape(-1), group=group)
    gather(ss, scale.reshape(1), group=group)
    deq = (qs.reshape((n,) + tuple(q.shape)).to(torch.float32)
           * ss.reshape((n,) + (1,) * g.dim()))
    return deq.mean(dim=0)


def topk_error_feedback(g: torch.Tensor, err: torch.Tensor, k: int):
    """Keep the k largest-|.| entries of (g + err); return (sparse_g,
    new_err). Ties rank the lower flat index first, as ``jax.lax.top_k``
    does: a stable descending sort, not ``torch.topk``."""
    corrected = g.to(torch.float32) + err
    flat = corrected.reshape(-1)
    _, order = torch.sort(torch.abs(flat), descending=True, stable=True)
    mask = torch.zeros_like(flat, dtype=torch.bool)
    mask[order[:k]] = True
    sparse = torch.where(mask, flat, 0.0).reshape(g.shape)
    return sparse, corrected.reshape(g.shape) - sparse


__all__ = ["int8_compress", "int8_decompress", "int8_psum",
           "topk_error_feedback"]
