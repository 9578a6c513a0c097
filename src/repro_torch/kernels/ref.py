"""Plain PyTorch versions of the hand-written kernels K1–K6, K4x and K6p
(K1b, the batched K1, is :func:`awp_pgd_step` on a stack).

Each has the signature of its wrapper in :mod:`repro_torch.kernels.ops`, so
the two are interchangeable: the wrappers take these on CPU tensors, the
tests hold them against the JAX package, and ``chip_smoke.py`` holds every
kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import projections as proj


def awp_pgd_step(w, theta, c, eta):
    """Z = Θ + η (W − Θ) C and ‖(W − Θ) C‖_F for (M, K) or batched
    (B, M, K) operands (η a scalar tensor, or (B,) in the batched form;
    the norm per item when batched)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=w.device)
    resid = (w.float() - theta.float()) @ c.float()
    scale = eta.reshape(-1, 1, 1) if w.dim() == 3 else eta
    z = (theta.float() + scale * resid).to(w.dtype)
    return z, torch.linalg.vector_norm(resid, dim=(-2, -1))


def topk_row(z, k: int):
    return proj.topk_row(z, k)


def quant_project(z, bits: int, group_size: int = 128):
    return proj.quant_project(z, bits, group_size)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(…, n/2) uint8 → (…, n) codes; the low nibble holds the even index."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)


def dequant(codes, scale, zero, group_size: int = 128):
    """(N, K) integer codes → (N, K) f32 (code − zero)·scale with
    per-(row, group) scale, zero (N, K/group). K4's plain version and
    ``QTensor.dequant`` both go through it to ``projections.dequant``, the
    port's one dequant expression."""
    n, k = codes.shape
    qp = proj.QuantParams(q=codes.reshape(n, k // group_size, group_size),
                          scale=scale[..., None], zero=zero[..., None])
    return proj.dequant(qp)


def dequant_matmul(x, packed, scale, zero, group_size: int = 128):
    """y (M, N) = x (M, K) · dequant(W)ᵀ, W nibble-packed (N, K/2)."""
    deq = dequant(unpack_int4(packed), scale, zero, group_size)
    return (x.to(torch.float32) @ deq.T).to(x.dtype)


def dequant_matmul_experts(x, packed, scale, zero, group_size: int = 128,
                           per_expert: bool = False):
    """K4x's plain version: :func:`dequant_matmul` for each expert e of a
    stack — packed (E, N, K/2), scale and zero (E, N, K/group) — against x
    (M, K) shared by every expert, or x[e] of (E, M, K) with
    ``per_expert``. y is (M, E, N) shared and (E, M, N) per expert, the
    reference's layouts (``repro/models/layers.py::expert_apply``). One 2-D
    product an expert, K4's plain version, so under unsplit cuBLAS each
    expert sums in the tile's order at M > 8 (at M <= 8 cuBLAS's kernels
    sum in another)."""
    ys = [dequant_matmul(x[e] if per_expert else x, packed[e], scale[e],
                         zero[e], group_size)
          for e in range(packed.shape[0])]
    return torch.stack(ys, dim=0 if per_expert else 1)


def kv_dequant(codes, scale, zero, group_size: int):
    """(R, K) uint8 codes + per-group (R, K/g) f16 scale/zero → (R, K) f32
    by ``(float(code) − float(zero)) · float(scale)`` (the reference's
    ``kernels/ref.py::kv_dequant``)."""
    r, k = codes.shape
    g = codes.to(torch.float32).reshape(r, k // group_size, group_size)
    deq = ((g - zero.to(torch.float32)[..., None])
           * scale.to(torch.float32)[..., None])
    return deq.reshape(r, k)


def _dequant_kv(codes, scale, zero, group_size: int):
    """(B, T, Hk, D) codes + (B, T, Hk, D/g) planes → dense f32 through
    the flattened-row :func:`kv_dequant` (``ops._ref_dequant_kv`` of the
    reference)."""
    rows = codes.numel() // codes.shape[-1]
    flat = kv_dequant(codes.reshape(rows, codes.shape[-1]),
                      scale.reshape(rows, -1), zero.reshape(rows, -1),
                      group_size)
    return flat.reshape(codes.shape)


def decode_attn(q, k, v, lengths, k_scale=None, k_zero=None, v_scale=None,
                v_zero=None, group_size: int = 0, block_t: int = 256):
    """Length-masked decode attention: q (B, H, D), one token per row,
    against k/v (B, T, Hk, D) — dense, or uint8 codes with per-head-group
    scale/zero planes, dequantized first. Row b attends [0, lengths[b]);
    a row of length 0 gives exact zeros, a NaN row stays NaN (the emit
    guard is ``l == 0`` exactly). ``block_t`` is the kernel's tile and
    does not change this version. After the reference's
    ``kernels/ref.py::decode_attn`` and the dequant-then-attend oracle of
    its ``ops.decode_attn``."""
    if k_scale is not None:
        k = _dequant_kv(k, k_scale, k_zero, group_size)
        v = _dequant_kv(v, v_scale, v_zero, group_size)
    b, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    qh = q.reshape(b, hk, g, d).to(torch.float32)
    s = torch.einsum("bkgd,btkd->bkgt", qh, k.to(torch.float32))
    s = s * (1.0 / math.sqrt(d))
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths.to(torch.int64)[:, None])              # (B, T)
    valid = valid[:, None, None, :]
    zero = torch.zeros((), device=q.device)
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, zero))
    p = torch.where(valid, p, zero)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgt,btkd->bkgd", p, v.to(torch.float32))
    dead = l == 0.0
    out = torch.where(dead, zero, pv / torch.where(dead, torch.ones_like(l), l))
    return out.reshape(b, h, d).to(q.dtype)


def gather_pages(pool, table):
    """Each table row's pages of one layer's pool (P, page, …) as a
    contiguous (B, n_pages·page, …) view. Entries are clipped to
    [0, P − 1]: the sentinel P reads page P − 1, whose positions lie past
    every row's length."""
    b, npg = table.shape
    idx = table.to(torch.int64).clamp(0, pool.shape[0] - 1)
    return pool[idx].reshape(b, npg * pool.shape[1], *pool.shape[2:])


def decode_attn_paged(q, k_pool, v_pool, table, lengths, k_scale=None,
                      k_zero=None, v_scale=None, v_zero=None,
                      group_size: int = 0, block_t: int = 256):
    """:func:`decode_attn` through a block table: k/v are one layer's page
    pools (P, page, Hk, D) — dense, or uint8 codes with (P, page, Hk, D/g)
    planes — and ``table`` (B, n_pages) int32 maps row b's positions to
    pages. Each row's contiguous view is gathered (:func:`gather_pages`,
    planes alike), then attended by :func:`decode_attn`, which
    dequantizes INT8 views through :func:`kv_dequant`; row b attends
    [0, min(lengths[b], n_pages·page)). After the reference's
    ``kernels/ref.py::decode_attn_paged`` and its
    ``ops.decode_attn_paged(use_pallas=False)``."""
    planes = [None if x is None else gather_pages(x, table)
              for x in (k_scale, k_zero, v_scale, v_zero)]
    return decode_attn(q, gather_pages(k_pool, table),
                       gather_pages(v_pool, table), lengths, *planes,
                       group_size=group_size, block_t=block_t)


__all__ = ["awp_pgd_step", "topk_row", "quant_project", "unpack_int4",
           "dequant", "dequant_matmul", "dequant_matmul_experts", "kv_dequant", "decode_attn",
           "decode_attn_paged", "gather_pages"]
