"""AWQ (Lin et al., 2024) — activation-aware weight quantization by a
per-input-channel scale search.

For each α of a grid over [0, 1]: s_j = (mean|x_j|)^α (normalized), quantize
W·diag(s) with RTN group quantization (K3 on the card), fold the scale back
(Ŵ = Q(W·s)/s), and keep the α whose activation-aware loss tr(E C Eᵀ) is
least — evaluated exactly from the calibration covariance, with no extra
forward pass. Candidates are tried one at a time and the best is kept on
the device (no host read).
"""
from __future__ import annotations

import torch

from repro_torch.core import calibration as calib, registry
from repro_torch.core.awp import channel_scale, select_min
from repro_torch.core.specs import QuantSpec
from repro_torch.kernels import impl

_ALPHA_GRID = tuple(i / 20 for i in range(21))   # 0.00, 0.05, ..., 1.00


def _loss(e: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """tr(E C Eᵀ), the reference's ``einsum("ij,jk,ik->")``."""
    return ((e @ c) * e).sum()


def quantize_weight_with_scale(w: torch.Tensor, c: torch.Tensor,
                               act_mean_abs: torch.Tensor, bits: int,
                               group_size: int = 128):
    """(dequantized AWQ weight, winning per-channel scale s).
    ``act_mean_abs``: per-input-channel mean |x| from calibration
    (:func:`repro_torch.core.calibration.act_mean_abs`)."""
    w = w.to(torch.float32)
    c = c.to(torch.float32)
    a = torch.clamp(act_mean_abs.to(torch.float32), min=1e-8)
    quant_project = impl("quant_project")
    best = None
    for alpha in _ALPHA_GRID:
        s = channel_scale(a, alpha)
        wq = quant_project(w * s[None, :], bits, group_size) / s[None, :]
        best = select_min(best, (_loss(w - wq, c), wq, s))
    return best[1], best[2]


def quantize_weight(w: torch.Tensor, c: torch.Tensor,
                    act_mean_abs: torch.Tensor, bits: int,
                    group_size: int = 128) -> torch.Tensor:
    """The dequantized AWQ weight (paper orientation d_out × d_in)."""
    return quantize_weight_with_scale(w, c, act_mean_abs, bits, group_size)[0]


@registry.register("awq", spec_cls=QuantSpec)
def _compress(w, stats, spec):
    from repro_torch.quant import QTensor
    c = calib.covariance(stats, damp=spec.damp)
    g = spec.group_for(w.shape[1])
    wq, s = quantize_weight_with_scale(w, c, calib.act_mean_abs(stats),
                                       spec.bits, g)
    # wq·diag(s) lies on the group grid, so packing in scaled space
    # (col_scale=s) round-trips: qt.dequant() == wq up to regrid rounding
    qt = QTensor.from_dense(wq, spec.bits, g, col_scale=s)
    return registry.CompressResult(theta=qt.dequant(), qtensor=qt,
                                   aux={"col_scaled": True, "covariance": c})


__all__ = ["quantize_weight", "quantize_weight_with_scale"]
