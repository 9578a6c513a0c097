"""Evaluation metrics: the activation-aware reconstruction loss, perplexity,
and the theory-side quantities of Appendix A (condition number, certified
step size). The port of ``repro/core/metrics.py``."""
from __future__ import annotations

import math

import torch

from repro_torch.core.awp import activation_loss  # re-export  # noqa: F401


def recon_loss(w, theta, c) -> torch.Tensor:
    """Unnormalized tr((W−Θ) C (W−Θ)ᵀ) = ‖WX − ΘX‖_F² / n."""
    e = torch.as_tensor(w, dtype=torch.float32) - torch.as_tensor(
        theta, dtype=torch.float32)
    return ((e @ torch.as_tensor(c, dtype=torch.float32)) * e).sum()


def _eigvalsh64(c) -> torch.Tensor:
    """Ascending eigenvalues of C in f64."""
    return torch.linalg.eigvalsh(torch.as_tensor(c).to(torch.float64))


def condition_number(c) -> float:
    """κ = λmax(C)/λmin(C) — Appendix A.2's convergence-rate driver."""
    ev = _eigvalsh64(c)
    return float(ev[-1] / max(float(ev[0]), 1e-12))


def certified_eta(c) -> float:
    """Step size η = 1/β = 1/(2λmax(C)) certified by the RSC/RSM analysis
    (the paper's practical 2/‖C‖_F is its inexpensive surrogate)."""
    ev = _eigvalsh64(c)
    return float(1.0 / (2.0 * max(float(ev[-1]), 1e-12)))


def sparsity(theta) -> float:
    """Fraction of exactly-zero entries."""
    return float((torch.as_tensor(theta) == 0).to(torch.float64).mean())


def perplexity(loss_fn, params, batches) -> float:
    """exp(mean token NLL) over an iterable of (tokens, labels) batches;
    ``loss_fn(params, tokens, labels) -> (sum_nll, token_count)``. One
    host read of each batch's sums, as in the reference."""
    tot, cnt = 0.0, 0.0
    for tokens, labels in batches:
        nll, n = loss_fn(params, tokens, labels)
        tot += float(nll)
        cnt += float(n)
    return float(math.exp(tot / max(cnt, 1.0)))


__all__ = ["activation_loss", "recon_loss", "condition_number",
           "certified_eta", "sparsity", "perplexity"]
