"""SparseGPT (Frantar & Alistarh, 2023) — OBS-based one-shot pruning.

The reference's algorithm: Hessian H ∝ XXᵀ with 1% dampening, its inverse
through Cholesky, columns processed left to right in blocks with a
per-block mask chosen by w²/[H⁻¹]_jj² and the error propagated into the
columns not yet pruned. The reference runs it in numpy f64 on the host;
the port runs the same f64 arithmetic in torch on the weight's device (at
llama2-7b's widths the host would take minutes a layer). Every count comes
from shapes and every threshold and mask stays on the device, so the
column loop makes no host read. The inverse and the Cholesky factor are
the library's (``torch.linalg``), as ``np.linalg``'s are the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core import calibration as calib, registry
from repro_torch.core.specs import PruneSpec

F64 = torch.float64


def _prepare_hinv(c: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """H = C (scale-free), a dead-column guard, 1% dampening, then the
    upper Cholesky factor of H⁻¹ (cholesky → inverse → cholesky, upper)."""
    h = c.to(F64).clone()
    diag = torch.diagonal(h)
    diag.copy_(torch.where(diag == 0, torch.ones_like(diag), diag))
    diag.add_(damp_frac * diag.mean())
    # the ``_ex`` forms report a failure on the device instead of reading
    # it on the host; H is damped, so it is positive definite
    hinv = torch.linalg.inv_ex(h).inverse
    # hinv = Uᵀ U: the upper factor is the lower factor's transpose
    return torch.linalg.cholesky_ex(hinv).L.mT.contiguous()


def _dead_zeroed(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """w (f64 copy) with the columns of dead inputs (C_jj = 0) zeroed."""
    dead = torch.diagonal(c) == 0
    return torch.where(dead[None, :], torch.zeros((), dtype=F64,
                                                  device=w.device),
                       w.to(F64))


def prune_weight(w: torch.Tensor, c: torch.Tensor, k: int,
                 blocksize: int = 128) -> torch.Tensor:
    """Prune each row of w (d_out, d_in) to k nonzeros; c (d_in, d_in).
    Returns f32."""
    w = _dead_zeroed(w, c)
    d_in = w.shape[1]
    sparsity = 1.0 - k / d_in
    hinv = _prepare_hinv(c)
    for i1 in range(0, d_in, blocksize):
        i2 = min(i1 + blocksize, d_in)
        count = i2 - i1
        w1 = w[:, i1:i2].clone()
        q1 = torch.zeros_like(w1)
        err1 = torch.zeros_like(w1)
        hinv1 = hinv[i1:i2, i1:i2]
        # per-block mask: prune the `sparsity` share with the smallest
        # w² / [H⁻¹]_jj² within each row's block slice
        tmp = w1 ** 2 / (torch.diagonal(hinv1) ** 2)[None, :]
        n_prune = int(round(count * sparsity))
        if n_prune > 0:
            thresh = torch.sort(tmp, dim=1).values[:, n_prune - 1:n_prune]
            mask1 = tmp <= thresh
        else:
            mask1 = torch.zeros_like(tmp, dtype=torch.bool)
        for j in range(count):
            wj = w1[:, j]
            q = torch.where(mask1[:, j], torch.zeros_like(wj), wj)
            q1[:, j] = q
            err = (wj - q) / hinv1[j, j]
            w1[:, j:] -= torch.outer(err, hinv1[j, j:])
            err1[:, j] = err
        w[:, i1:i2] = q1
        w[:, i2:] -= err1 @ hinv[i1:i2, i2:]
    # the block-local thresholds track the rate but may drift by a few
    # entries a row: keep exactly k a row on the final matrix (the OBS-
    # updated values, dropping the smallest |.| surplus)
    idx = torch.topk(w.abs(), k, dim=1).indices
    mask = torch.zeros_like(w, dtype=torch.bool).scatter_(1, idx, True)
    return (w * mask).to(torch.float32)


@registry.register("sparsegpt", spec_cls=PruneSpec)
def _compress(w, stats, spec):
    c = calib.covariance(stats, damp=spec.damp)
    theta = prune_weight(w.to(torch.float32), c.to(F64),
                         spec.k_for(w.shape[1]))
    return registry.CompressResult(theta=theta, mask=theta != 0,
                                   aux={"covariance": c})


__all__ = ["prune_weight"]
