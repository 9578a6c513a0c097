"""Projection operators onto AWP constraint sets, in plain PyTorch.

Paper orientation throughout: weights are ``(d_out, d_in)`` and "row" means
an output row; quantization groups tile the ``d_in`` axis. These are the
plain versions of the hand-written kernels K2 (``topk_row``) and K3
(``quant_project``) — ``repro_torch.kernels.ref`` re-exports them — and
they match ``repro/core/projections.py`` bit for bit: exact-k top-k with
leftmost ties, and the min/max quantizer with half-to-even rounding
(``torch.round``), IEEE f32 division by the scale, and the scale itself
as the reference's compiled code computes it (:func:`inv_qmax`). Leading
dims are independent matrices throughout, so the batched engine projects a
whole (B, d_out, d_in) stack in one call.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Sparsity projections (hard thresholding, Proj_{C_row})
# ---------------------------------------------------------------------------

def topk_row(z: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-|.| entries of each row of z; zero the rest.

    Exact-k semantics, ties broken by lower index (as ``jax.lax.top_k``).
    Leading dims of z are independent rows.
    """
    if k >= z.shape[-1]:
        return z
    if k <= 0:
        return torch.zeros_like(z)
    return torch.where(topk_row_mask(z, k), z, torch.zeros_like(z))


def _leftmost_keep(mag: torch.Tensor, thr: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """Entries above ``thr`` plus the first ``k - count(above)`` entries
    equal to it, in index order."""
    gt = mag > thr
    need = k - gt.sum(dim=-1, keepdim=True)
    eq = mag == thr
    return gt | (eq & (torch.cumsum(eq.to(torch.int64), dim=-1) <= need))


def topk_row_mask(z: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean keep-mask of :func:`topk_row`: the kth-largest magnitude per
    row as threshold, plus leftmost tie-keeping."""
    if k >= z.shape[-1]:
        return torch.ones(z.shape, dtype=torch.bool, device=z.device)
    if k <= 0:
        return torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    mag = z.abs()
    thr = torch.topk(mag, k, dim=-1, sorted=True).values[..., -1:]
    return _leftmost_keep(mag, thr, torch.full((), k, dtype=torch.int64,
                                               device=z.device))


def topk_matrix(z: torch.Tensor, k_total: int) -> torch.Tensor:
    """Whole-matrix top-k (the unconstrained C_sparse variant of Eq. (1))."""
    return topk_row(z.reshape(1, -1), k_total).reshape(z.shape)


def prune_n_m(z: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """N:M structured sparsity (e.g. 2:4): keep the n largest |.| of every
    m consecutive entries along d_in, ties to the lower index (the ranking
    of ``jax.lax.top_k``). Leading dims are independent."""
    d_in = z.shape[-1]
    if d_in % m:
        raise ValueError(f"d_in={d_in} not divisible by m={m}")
    g = z.reshape(z.shape[:-1] + (d_in // m, m))
    keep = n_m_keep(g.abs(), n)
    return torch.where(keep, g, torch.zeros_like(g)).reshape(z.shape)


def n_m_keep(score: torch.Tensor, n: int) -> torch.Tensor:
    """Keep-mask of the n largest entries along the last (group) axis:
    an entry's rank is the count of larger entries plus equal entries at
    a lower index, and it is kept when that rank is below n."""
    m = score.shape[-1]
    a, b = score[..., :, None], score[..., None, :]        # (…, m, m): i, j
    lower = torch.ones((m, m), dtype=torch.bool,
                       device=score.device).tril(-1)        # j < i
    rank = ((b > a) | ((b == a) & lower)).sum(dim=-1)
    return rank < n


def ramp_ratio(t: Union[int, torch.Tensor], target: float,
               ramp_iters: int) -> torch.Tensor:
    """Linear pruning-ratio schedule of the joint recipe (§4.3):
    ratio(t) = target * min(1, (t+1)/ramp_iters), in f32."""
    t = torch.as_tensor(t, dtype=torch.float32)
    frac = torch.clamp((t + 1.0) / float(ramp_iters), max=1.0)
    return target * frac


def ramp_keep_k(t: int, target: float, ramp_iters: int, d_in: int) -> int:
    """Kept entries per row at step ``t`` of the joint recipe's ramp:
    round((1 − ratio(t)) · d_in), every operation in f32 as the reference
    traces ``topk_row_dynamic(z, 1 − ramp_ratio(t, …))``. The step index is
    a host integer here, so k is computed on the host (no device read) and
    the exact-k projection :func:`topk_row` (kernel K2 on the card) keeps
    the same entries as ``topk_row_dynamic``."""
    f32 = np.float32
    frac = min(f32(1.0), (f32(t) + f32(1.0)) / f32(ramp_iters))
    keep = f32(1.0) - f32(target) * frac
    return int(np.round(keep * f32(d_in)))


def topk_row_dynamic(z: torch.Tensor,
                     keep_ratio: Union[float, torch.Tensor]) -> torch.Tensor:
    """Row top-k where the kept *ratio* is a runtime scalar:
    k = round(keep_ratio · d_in) in f32, exact-k with leftmost ties."""
    d_in = z.shape[-1]
    mag = z.abs()
    ratio = torch.as_tensor(keep_ratio, dtype=torch.float32, device=z.device)
    k = torch.round(ratio * d_in).to(torch.int32)
    srt = torch.sort(mag, dim=-1, descending=True).values
    idx = torch.clamp(k - 1, 0, d_in - 1).to(torch.int64)
    thr = torch.gather(srt, -1, idx.expand(srt.shape[:-1] + (1,)))
    keep = _leftmost_keep(mag, thr, k)
    return torch.where(keep & (k > 0), z, torch.zeros_like(z))


# ---------------------------------------------------------------------------
# Quantization projection (Proj_{C_INTb}): group-wise asymmetric min/max
# ---------------------------------------------------------------------------

class QuantParams(NamedTuple):
    """Integer codes + affine dequant parameters for one weight matrix
    (or a stack of them: leading dims ride along)."""
    q: torch.Tensor        # (…, d_out, n_groups, group) integer codes
    scale: torch.Tensor    # (…, d_out, n_groups, 1) f32
    zero: torch.Tensor     # (…, d_out, n_groups, 1) f32 (integer-valued)


def _group(z: torch.Tensor, group_size: int) -> torch.Tensor:
    d_in = z.shape[-1]
    if d_in % group_size:
        raise ValueError(f"d_in={d_in} not divisible by group {group_size}")
    return z.reshape(z.shape[:-1] + (d_in // group_size, group_size))


def inv_qmax(bits: int) -> float:
    """1/(2^bits − 1) rounded to f32.

    The reference writes ``(max − min) / qmax``, and XLA folds a division
    by a constant into a multiplication by the constant's f32 reciprocal
    in every compiled caller (its PGD recipes, its ops wrapper, its Pallas
    kernel). The port multiplies by that reciprocal explicitly, so this
    plain version, the CUDA kernel K3 and the reference agree bit for bit
    on every device."""
    return float(np.float32(1.0) / np.float32(2 ** bits - 1))


def quant_params(z: torch.Tensor, bits: int,
                 group_size: int = 128) -> QuantParams:
    """Min/max asymmetric quantizer per (row, group)."""
    g = _group(z, group_size).to(torch.float32)
    gmax = g.amax(dim=-1, keepdim=True)
    gmin = g.amin(dim=-1, keepdim=True)
    qmax = float(2 ** bits - 1)
    scale = torch.clamp((gmax - gmin) * inv_qmax(bits), min=1e-8)
    zero = torch.clamp(torch.round(-gmin / scale), 0.0, qmax)
    q = torch.clamp(torch.round(g / scale) + zero, 0.0, qmax)
    return QuantParams(q=q.to(torch.int8 if bits <= 7 else torch.int32),
                       scale=scale, zero=zero)


def dequant(qp: QuantParams, dtype=torch.float32) -> torch.Tensor:
    g = (qp.q.to(torch.float32) - qp.zero) * qp.scale
    return g.reshape(g.shape[:-2] + (g.shape[-2] * g.shape[-1],)).to(dtype)


def quant_project(z: torch.Tensor, bits: int,
                  group_size: int = 128) -> torch.Tensor:
    """Proj onto the INT-b group-quantizable set: quantize-dequantize."""
    return dequant(quant_params(z, bits, group_size), dtype=z.dtype)


def joint_project(z: torch.Tensor, keep_ratio, bits: int,
                  group_size: int = 128) -> torch.Tensor:
    """Joint prune+quant projection of §4.3: Proj_INTb(Proj_row(Z)) (the
    reference's ``joint_project``). Prune first to get the support,
    quantize the pruned matrix, then re-apply the mask (quantizing can
    move pruned zeros off zero because the group zero-point is not
    exactly representable)."""
    pruned = topk_row_dynamic(z, keep_ratio)
    return quant_project(pruned, bits, group_size) * (pruned != 0)


__all__ = ["QuantParams", "inv_qmax", "topk_row", "topk_row_mask",
           "topk_matrix", "prune_n_m", "n_m_keep", "ramp_ratio", "ramp_keep_k",
           "topk_row_dynamic", "quant_params", "dequant", "quant_project",
           "joint_project"]
