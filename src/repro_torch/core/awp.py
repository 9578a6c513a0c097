"""AWP — Algorithm 1: activation-aware weight compression via PGD/IHT.

Paper orientation: ``w`` is ``(d_out, d_in)``, the calibration
auto-correlation ``c = (1/n) Xᵀ X`` is ``(d_in, d_in)``, and one step is

    z = theta + eta * (w - theta) @ c          # K1, the O(d_out·d_in²) step
    theta = Proj_C(z)                          # K2 (prune) or K3 (quantize)

* :func:`prune`    — η = 2/‖C‖_F, ≤200 iters, stop ‖∇f‖_F/‖W‖_F < 1e-4,
                     Θ⁰ = Wanda solution (§4.1); ``nm=(n, m)`` for N:M.
* :func:`quantize` — η = 1.5/‖C‖_F, 10 iters, Θ⁰ = RTN (§4.2).
* :func:`joint`    — η = 1.5/‖C‖_F, 100 iters: the pruning ratio ramps
                     over iters 0–24, prune-only through 49,
                     Proj_INTb∘Proj_row for 50–99, the final mask applied
                     after quantization (§4.3).

The gradient step and both projections go through
:func:`repro_torch.kernels.impl`: the hand-written kernels on the card,
their plain versions on the CPU. :func:`pgd_batched` runs the same loop
over a (B, d_out, d_in) stack (K1b on the card). Both loops are runs of
masked steps (:func:`_steps`) with no host read inside: :func:`pgd` reads
the gradient norm on the host once per chunk of ``PGD_CHUNK_ITERS`` steps
(never when tol is 0), :func:`pgd_batched` never.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import calibration as calib, projections as proj, registry
from repro_torch.core.specs import JointSpec, PruneSpec, QuantSpec
from repro_torch.kernels import impl

PGD_CHUNK_ITERS = 25       # steps between the host's reads of the norm


class AWPResult(NamedTuple):
    theta: torch.Tensor       # compressed weight, paper orientation
    iters: torch.Tensor       # int32 steps actually applied: () or (B,)
    grad_norm: torch.Tensor   # final ‖∇f‖_F / ‖W‖_F: () or (B,) f32


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    """PGD loop settings (the recipes below fill these in)."""
    max_iters: int = 200
    tol: float = 1e-4                 # on ‖∇f‖_F / ‖W‖_F
    eta_scale: float = 2.0            # η = eta_scale / ‖C‖_F


# §4.1: the prune recipe's loop, shared by the sequential and batched drivers
PRUNE_CONFIG = PGDConfig(max_iters=200, tol=1e-4, eta_scale=2.0)


def _eta(c: torch.Tensor, eta_scale: float) -> torch.Tensor:
    """η = eta_scale / ‖C‖_F; per item, (B,), for a (B, d, d) stack."""
    return eta_scale / torch.clamp(torch.linalg.matrix_norm(c), min=1e-12)


def _loss(w, theta, c) -> torch.Tensor:
    """Normalized activation-aware loss ‖(W−Θ)C^½‖_F / ‖W‖_F (Fig. 1),
    via tr(E C Eᵀ) = ‖E C^½‖_F²; per item for a stack."""
    e = (w - theta).to(torch.float32)
    val = ((e @ c.to(torch.float32)) * e).sum(dim=(-2, -1))
    return (torch.sqrt(torch.clamp(val, min=0.0))
            / torch.clamp(torch.linalg.matrix_norm(w), min=1e-12))


def _steps(w, c, eta, w_norm, project, theta, gnorm, iters, t0: int,
           n: int, tol: float):
    """Steps ``t0 … t0+n−1`` of Algorithm 1 on one problem or a stack,
    masked per item as the reference's ``while_loop`` stops: an item steps
    while its norm is ≥ tol (a NaN norm freezes it, since ``nan >= tol``
    is false); a frozen item keeps its θ and norm, and ``iters`` counts
    only the steps an item took. The residual norm comes from the step's
    f32 accumulator (K1's tile partials on the card), never from
    ‖Z − Θ‖/η, which cancels near convergence. No host read."""
    step = impl("awp_pgd_step")              # K1b on a (B, d_out, d_in) stack
    for t in range(t0, t0 + n):
        active = gnorm >= tol
        z, resid_norm = step(w, theta, c, eta)
        theta = torch.where(active.reshape(active.shape + (1, 1)),
                            project(z, t), theta)
        gnorm = torch.where(active, 2.0 * resid_norm / w_norm, gnorm)
        iters = iters + active.to(torch.int32)
    return theta, gnorm, iters


def _start(w, c, theta0, cfg: PGDConfig):
    """f32 operands, η, ‖W‖ and the loop state before step 0 (norm +inf,
    so every item takes step 0)."""
    w = w.to(torch.float32)
    c = c.to(torch.float32)
    lead = w.shape[:-2]
    state = (theta0.to(torch.float32),
             torch.full(lead, float("inf"), device=w.device),
             torch.zeros(lead, dtype=torch.int32, device=w.device))
    w_norm = torch.clamp(torch.linalg.matrix_norm(w), min=1e-12)
    return (w, c, _eta(c, cfg.eta_scale), w_norm), state


def pgd(w: torch.Tensor, c: torch.Tensor,
        project: Callable[[torch.Tensor, int], torch.Tensor],
        theta0: torch.Tensor, cfg: PGDConfig) -> AWPResult:
    """Run Algorithm 1 with projection ``project(z, t) -> theta``.

    θ, ``iters`` and ``grad_norm`` are those of the reference's
    ``while_loop`` (continue while ``t < max_iters and gnorm >= tol``). The
    loop runs in chunks of ``PGD_CHUNK_ITERS`` masked steps and reads the
    norm on the host once per chunk, to stop after the chunk in which it
    fell below tol; the steps computed after convergence inside that chunk
    are discarded. With tol 0 it never reads the norm."""
    ops_, (theta, gnorm, iters) = _start(w, c, theta0, cfg)
    chunk = PGD_CHUNK_ITERS if cfg.tol > 0 else cfg.max_iters
    t = 0
    while t < cfg.max_iters:
        n = min(chunk, cfg.max_iters - t)
        theta, gnorm, iters = _steps(*ops_, project, theta, gnorm, iters,
                                     t, n, cfg.tol)
        t += n
        if t < cfg.max_iters and not bool(gnorm >= cfg.tol):  # host read
            break
    return AWPResult(theta=theta, iters=iters, grad_norm=gnorm)


def pgd_batched(w_b: torch.Tensor, c_b: torch.Tensor,
                project: Callable[[torch.Tensor, int], torch.Tensor],
                theta0_b: torch.Tensor, cfg: PGDConfig) -> AWPResult:
    """Algorithm 1 over a stack of B independent problems: ``w_b`` (B,
    d_out, d_in), ``c_b`` (B, d_in, d_in), η per item, ``project`` acting
    item-wise on the (B, d_out, d_in) iterate.

    Per-item results are the reference's exactly: an item is active while
    its norm is ≥ tol (a NaN norm freezes it), a frozen item's θ and norm
    stay unchanged, and ``iters`` counts only its active steps. The loop is
    ``max_iters`` masked steps on the device with no host read; unlike the
    reference's ``while_loop`` it does not stop once every item has
    converged — those trailing steps are computed and discarded.
    :func:`repro_torch.core.batched.prune_batched_compacted` reads the
    norms between chunks to retire converged items."""
    ops_, (theta, gnorm, iters) = _start(w_b, c_b, theta0_b, cfg)
    theta, gnorm, iters = _steps(*ops_, project, theta, gnorm, iters, 0,
                                 cfg.max_iters, cfg.tol)
    return AWPResult(theta=theta, iters=iters, grad_norm=gnorm)


# ---------------------------------------------------------------------------
# Paper recipes (2-D; the batched engine stacks the same projections)
# ---------------------------------------------------------------------------

def prune_projection(k: int, nm: Optional[tuple] = None):
    """Proj onto row-wise top-k (K2 on the card) or N:M sparsity; acts on
    the last axis, so it projects a stack item by item."""
    if nm is None:
        topk_row = impl("topk_row")
        return lambda z, t: topk_row(z, k)
    return lambda z, t: proj.prune_n_m(z, *nm)


def prune(w: torch.Tensor, c: torch.Tensor, k: int, *,
          theta0: Optional[torch.Tensor] = None,
          max_iters: int = PRUNE_CONFIG.max_iters,
          nm: Optional[tuple] = None) -> AWPResult:
    """§4.1 pruning recipe; ``k`` = kept entries per row = (1-p)·d_in.
    Θ⁰ defaults to the Wanda solution; ``nm=(2, 4)`` switches the
    constraint to N:M structured sparsity."""
    if theta0 is None:
        from repro_torch.core.baselines import wanda   # avoid import cycle
        theta0 = wanda.prune_weight(w, c, k)
    cfg = dataclasses.replace(PRUNE_CONFIG, max_iters=max_iters)
    return pgd(w, c, prune_projection(k, nm), theta0, cfg)


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


def joint_projection(k: int, d_in: int, bits: int, group_size: int,
                     ramp_iters: int, prune_only_iters: int):
    """The joint recipe's step-indexed projection: row top-k with k on the
    ramp (:func:`projections.ramp_keep_k`), then from ``prune_only_iters``
    on quantized and re-masked. Acts on the last axis (stack-safe)."""
    topk_row, quant_project = impl("topk_row"), impl("quant_project")
    target = 1.0 - k / d_in                        # pruning ratio p

    def project(z, t):
        pruned = topk_row(z, proj.ramp_keep_k(t, target, ramp_iters, d_in))
        if t < prune_only_iters:
            return pruned
        return quant_project(pruned, bits, group_size) * (pruned != 0)
    return project


def joint_finish(res: AWPResult, k: int, bits: int,
                 group_size: int) -> AWPResult:
    """Exact-k mask from the last iterate, quantize, re-mask (§4.3: the
    final weight is both sparse and quantized)."""
    mask = proj.topk_row_mask(res.theta, k)
    theta = impl("quant_project")(res.theta * mask, bits, group_size) * mask
    return res._replace(theta=theta)


def joint(w: torch.Tensor, c: torch.Tensor, k: int, bits: int = 4, *,
          group_size: int = 128, ramp_iters: int = 25,
          prune_only_iters: int = 50, total_iters: int = 100) -> AWPResult:
    """§4.3 joint prune+quant recipe. Iters [0, ramp) ramp the pruning
    ratio linearly to its target, [ramp, prune_only) prune only, [prune_only,
    total) Proj_INTb(Proj_row(.)); then :func:`joint_finish`. Θ⁰ = W; tol 0
    runs all ``total_iters``."""
    project = joint_projection(k, w.shape[-1], bits, group_size, ramp_iters,
                               prune_only_iters)
    cfg = PGDConfig(max_iters=total_iters, tol=0.0, eta_scale=1.5)
    res = pgd(w, c, project, w.to(torch.float32), cfg)
    return joint_finish(res, k, bits, group_size)


def activation_loss(w: torch.Tensor, theta: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Public normalized activation-aware loss (Fig. 1 metric); per item,
    (B,), for (B, d_out, d_in) stacks."""
    return _loss(w.to(torch.float32), theta.to(torch.float32),
                 c.to(torch.float32))


# ---------------------------------------------------------------------------
# Registry adapters: compress(w, stats, spec) -> CompressResult. Each hands
# the covariance it built to the driver in aux["covariance"] so the loss
# reuses it. Metrics stay on the device; the driver reads them.
# ---------------------------------------------------------------------------

def _prune_result(res: AWPResult, c) -> registry.CompressResult:
    return registry.CompressResult(
        theta=res.theta, mask=res.theta != 0, iters=res.iters,
        aux={"grad_norm": res.grad_norm, "covariance": c})


@registry.register("awp_prune", spec_cls=PruneSpec)
def _awp_prune(w, stats, spec):
    c = calib.covariance(stats, damp=spec.damp)
    return _prune_result(prune(w, c, spec.k_for(w.shape[1])), c)


@registry.register("awp_prune_nm", spec_cls=PruneSpec)
def _awp_prune_nm(w, stats, spec):
    c = calib.covariance(stats, damp=spec.damp)
    return _prune_result(prune(w, c, spec.k_for(w.shape[1]),
                               nm=spec.nm or (2, 4)), c)


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


@registry.register("awp_joint", spec_cls=JointSpec)
def _awp_joint(w, stats, spec):
    from repro_torch.quant import QTensor
    c = calib.covariance(stats, damp=spec.damp)
    g = spec.group_for(w.shape[1])
    res = joint(w, c, spec.k_for(w.shape[1]), spec.bits, group_size=g)
    mask = res.theta != 0
    # zeros land exactly on the zero-point code, so the packed artifact
    # keeps the sparsity pattern
    qt = QTensor.from_dense(res.theta, spec.bits, g)
    return registry.CompressResult(theta=qt.dequant() * mask, mask=mask,
                                   qtensor=qt, iters=res.iters,
                                   aux={"covariance": c})


__all__ = ["AWPResult", "PGDConfig", "PGD_CHUNK_ITERS", "PRUNE_CONFIG", "pgd",
           "pgd_batched", "prune", "prune_projection", "quantize", "joint",
           "joint_projection", "joint_finish", "activation_loss"]
