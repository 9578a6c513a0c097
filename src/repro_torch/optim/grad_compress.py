"""Gradient compressors for the data-parallel sync (the port of
``repro/optim/grad_compress.py``): int8 linear quantization around the
max-|g| scale, and top-k sparsification with error feedback.

The reference's ``int8_psum`` (an all-gather of the int8 payload inside
``shard_map``) needs a collective; it comes with the multi-device slice's
data-parallel train step.
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


__all__ = ["int8_compress", "int8_decompress", "topk_error_feedback"]
