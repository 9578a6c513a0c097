"""Plain PyTorch versions of the hand-written kernels K1–K4.

Each has the signature of its wrapper in :mod:`repro_torch.kernels.ops`, so
the two are interchangeable: the wrappers take these on CPU tensors, the
tests hold them against the JAX package, and ``chip_smoke.py`` holds every
kernel against them on the card.
"""
from __future__ import annotations

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


__all__ = ["awp_pgd_step", "topk_row", "quant_project", "unpack_int4",
           "dequant", "dequant_matmul"]
