"""AWP — Algorithm 1: activation-aware weight compression via PGD/IHT.

Paper orientation: ``w`` is ``(d_out, d_in)``, the calibration
auto-correlation ``c = (1/n) Xᵀ X`` is ``(d_in, d_in)``, and one step is

    z = theta + eta * (w - theta) @ c          # K1, the O(d_out·d_in²) step
    theta = Proj_C(z)                          # K2 (prune) or K3 (quantize)

* :func:`prune`    — η = 2/‖C‖_F, ≤200 iters, stop ‖∇f‖_F/‖W‖_F < 1e-4,
                     Θ⁰ = Wanda solution (§4.1).
* :func:`quantize` — η = 1.5/‖C‖_F, 10 iters, Θ⁰ = RTN (§4.2).

The gradient step and both projections go through
:func:`repro_torch.kernels.impl`: the hand-written kernels on the card,
their plain versions on the CPU. The loop is eager; its stop rule reads the
gradient norm on the host once per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import calibration as calib, registry
from repro_torch.core.specs import PruneSpec, QuantSpec
from repro_torch.kernels import impl


class AWPResult(NamedTuple):
    theta: torch.Tensor       # compressed weight, paper orientation
    iters: int                # iterations actually run
    grad_norm: torch.Tensor   # final ‖∇f‖_F / ‖W‖_F (f32 scalar)


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    """PGD loop settings (the recipes below fill these in)."""
    max_iters: int = 200
    tol: float = 1e-4                 # on ‖∇f‖_F / ‖W‖_F
    eta_scale: float = 2.0            # η = eta_scale / ‖C‖_F


def _eta(c: torch.Tensor, eta_scale: float) -> torch.Tensor:
    return eta_scale / torch.clamp(torch.linalg.matrix_norm(c), min=1e-12)


def _loss(w, theta, c) -> torch.Tensor:
    """Normalized activation-aware loss ‖(W−Θ)C^½‖_F / ‖W‖_F (Fig. 1),
    via tr(E C Eᵀ) = ‖E C^½‖_F²."""
    e = (w - theta).to(torch.float32)
    val = ((e @ c.to(torch.float32)) * e).sum()
    return (torch.sqrt(torch.clamp(val, min=0.0))
            / torch.clamp(torch.linalg.matrix_norm(w), min=1e-12))


def pgd(w: torch.Tensor, c: torch.Tensor,
        project: Callable[[torch.Tensor, int], torch.Tensor],
        theta0: torch.Tensor, cfg: PGDConfig) -> AWPResult:
    """Run Algorithm 1 with projection ``project(z, t) -> theta``.

    Continues while ``t < max_iters and gnorm >= tol`` — the condition of
    the reference's ``lax.while_loop``, so a NaN norm stops the loop too.
    The residual norm comes from the step's f32 accumulator (K1's tile
    partials on the card), never from ‖Z − Θ‖/η, which cancels near
    convergence."""
    w = w.to(torch.float32)
    c = c.to(torch.float32)
    eta = _eta(c, cfg.eta_scale)
    w_norm = torch.clamp(torch.linalg.matrix_norm(w), min=1e-12)
    theta = theta0.to(torch.float32)
    step = impl("awp_pgd_step")
    gnorm = torch.tensor(float("inf"), device=w.device)
    t = 0
    while t < cfg.max_iters and bool(gnorm >= cfg.tol):   # host sync
        z, resid_norm = step(w, theta, c, eta)
        gnorm = 2.0 * resid_norm / w_norm
        theta = project(z, t)
        t += 1
    return AWPResult(theta=theta, iters=t, grad_norm=gnorm)


def prune(w: torch.Tensor, c: torch.Tensor, k: int, *,
          theta0: Optional[torch.Tensor] = None,
          max_iters: int = 200) -> AWPResult:
    """§4.1 pruning recipe; ``k`` = kept entries per row = (1-p)·d_in.
    Θ⁰ defaults to the Wanda solution."""
    if theta0 is None:
        from repro_torch.core.baselines import wanda   # avoid import cycle
        theta0 = wanda.prune_weight(w, c, k)
    cfg = PGDConfig(max_iters=max_iters, tol=1e-4, eta_scale=2.0)
    topk_row = impl("topk_row")
    return pgd(w, c, lambda z, t: topk_row(z, k), theta0, cfg)


def quantize(w: torch.Tensor, c: torch.Tensor, bits: int, *,
             group_size: int = 128, theta0: Optional[torch.Tensor] = None,
             max_iters: int = 10) -> AWPResult:
    """§4.2 quantization recipe (group-wise INT-b, RTN init, all iters)."""
    quant_project = impl("quant_project")
    if theta0 is None:
        theta0 = quant_project(w.to(torch.float32), bits, group_size)
    cfg = PGDConfig(max_iters=max_iters, tol=0.0, eta_scale=1.5)
    res = pgd(w, c, lambda z, t: quant_project(z, bits, group_size),
              theta0, cfg)
    # the min/max grid moves with the iterate, so the loss is not monotone:
    # keep the better of {init, final} (decided on the device)
    better = _loss(w, res.theta, c) <= _loss(w, theta0, c)
    theta = torch.where(better, res.theta, theta0.to(torch.float32))
    return res._replace(theta=theta)


def activation_loss(w: torch.Tensor, theta: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Public normalized activation-aware loss (Fig. 1 metric)."""
    return _loss(w.to(torch.float32), theta.to(torch.float32),
                 c.to(torch.float32))


# ---------------------------------------------------------------------------
# Registry adapters: compress(w, stats, spec) -> CompressResult. Each hands
# the covariance it built to the driver in aux["covariance"] so the loss
# reuses it.
# ---------------------------------------------------------------------------

@registry.register("awp_prune", spec_cls=PruneSpec)
def _awp_prune(w, stats, spec):
    if spec.nm is not None:
        raise NotImplementedError("N:M AWP pruning is not ported")
    c = calib.covariance(stats, damp=spec.damp)
    res = prune(w, c, spec.k_for(w.shape[1]))
    return registry.CompressResult(
        theta=res.theta, mask=res.theta != 0, iters=res.iters,
        aux={"grad_norm": res.grad_norm, "covariance": c})


@registry.register("awp_quant", spec_cls=QuantSpec)
def _awp_quant(w, stats, spec):
    from repro_torch.quant import QTensor
    c = calib.covariance(stats, damp=spec.damp)
    g = spec.group_for(w.shape[1])
    res = quantize(w, c, spec.bits, group_size=g)
    # theta is on the group grid already; the codes become the source of
    # truth (theta = dequant(codes))
    qt = QTensor.from_dense(res.theta, spec.bits, g)
    return registry.CompressResult(theta=qt.dequant(), qtensor=qt,
                                   iters=res.iters,
                                   aux={"grad_norm": res.grad_norm,
                                        "covariance": c})


__all__ = ["AWPResult", "PGDConfig", "pgd", "prune", "quantize",
           "activation_loss"]
