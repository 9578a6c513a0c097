"""GPTQ (Frantar et al., 2022) — OBS-based group quantization with error
propagation. The Hessian machinery of SparseGPT: columns are quantized left
to right, each column's error is folded into the columns after it, and the
group scales (asymmetric min/max per output row) are refreshed at every
group boundary from the current, error-corrected weights.

As :mod:`.sparsegpt`, the reference's numpy f64 algorithm in torch f64 on
the weight's device, with no host read in the column loop. The grids are
divided as the reference divides them (``(max − min) / qmax`` in f64, not a
multiply by a reciprocal), and ``torch.round`` rounds half to even, as
``np.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core import calibration as calib, registry
from repro_torch.core.baselines.sparsegpt import (F64, _dead_zeroed,
                                                  _prepare_hinv)
from repro_torch.core.specs import QuantSpec


def _group_qparams(block: torch.Tensor, bits: int):
    """Asymmetric min/max scale and zero per row for one group of columns."""
    gmax = block.amax(dim=1)
    gmin = block.amin(dim=1)
    qmax = 2 ** bits - 1
    scale = torch.clamp((gmax - gmin) / qmax, min=1e-8)
    zero = torch.clamp(torch.round(-gmin / scale), 0, qmax)
    return scale, zero


def _quant_col(col, scale, zero, qmax: int):
    q = torch.clamp(torch.round(col / scale) + zero, 0, qmax)
    return (q - zero) * scale, q


def quantize_weight(w: torch.Tensor, c: torch.Tensor, bits: int,
                    group_size: int = 128, blocksize: int = 128,
                    return_qparams: bool = False):
    """Quantize w (d_out, d_in) to INT-``bits`` with per-(row, group)
    scales; returns f32. With ``return_qparams`` also the integer codes and
    the per-group scale and zero used (f64) — the grids are refreshed from
    error-corrected weights, so they cannot be recovered from the output."""
    w = _dead_zeroed(w, c)
    d_out, d_in = w.shape
    hinv = _prepare_hinv(c)
    qmax = 2 ** bits - 1
    n_groups = (d_in + group_size - 1) // group_size
    codes = torch.zeros((d_out, d_in), dtype=F64, device=w.device)
    g_scale = torch.ones((d_out, n_groups), dtype=F64, device=w.device)
    g_zero = torch.zeros((d_out, n_groups), dtype=F64, device=w.device)
    scale = zero = None
    for i1 in range(0, d_in, blocksize):
        i2 = min(i1 + blocksize, d_in)
        count = i2 - i1
        w1 = w[:, i1:i2].clone()
        q1 = torch.zeros_like(w1)
        err1 = torch.zeros_like(w1)
        hinv1 = hinv[i1:i2, i1:i2]
        for j in range(count):
            col = i1 + j
            if col % group_size == 0:
                g_end = min(col + group_size, d_in)
                # scales from the error-corrected current weights
                if g_end > i2:
                    g_block = torch.cat([w1[:, j:min(j + group_size, count)],
                                         w[:, i2:g_end]], dim=1)
                else:
                    g_block = w1[:, j:j + (g_end - col)]
                scale, zero = _group_qparams(g_block, bits)
                g_scale[:, col // group_size] = scale
                g_zero[:, col // group_size] = zero
            wj = w1[:, j]
            q, q_int = _quant_col(wj, scale, zero, qmax)
            q1[:, j] = q
            codes[:, col] = q_int
            err = (wj - q) / hinv1[j, j]
            w1[:, j:] -= torch.outer(err, hinv1[j, j:])
            err1[:, j] = err
        w[:, i1:i2] = q1
        w[:, i2:] -= err1 @ hinv[i1:i2, i2:]
    out = w.to(torch.float32)
    if return_qparams:
        return out, codes, g_scale, g_zero
    return out


@registry.register("gptq", spec_cls=QuantSpec)
def _compress(w, stats, spec):
    from repro_torch.quant import QTensor
    c = calib.covariance(stats, damp=spec.damp)
    g = spec.group_for(w.shape[1])
    _, codes, g_scale, g_zero = quantize_weight(
        w.to(torch.float32), c.to(F64), spec.bits, g, return_qparams=True)
    # pack GPTQ's own codes and grids (refreshed mid-stream, not
    # recoverable from the dense output); theta = dequant(codes) keeps the
    # checkpoint and the serving path consistent with the artifact
    qt = QTensor.from_codes(codes.to(torch.int32),
                            g_scale.to(torch.float32),
                            g_zero.to(torch.float32), spec.bits, g)
    return registry.CompressResult(theta=qt.dequant(), qtensor=qt,
                                   aux={"covariance": c})


__all__ = ["quantize_weight"]
