"""Shape-bucketed batched compression engine (the default of
:func:`repro_torch.core.compress.compress_model`).

The paper's cost is the O(d_out·d_in²) PGD step, run once per linear and
iteration. This module buckets a block's linears by ``(weight shape,
spec)`` — k/v heads, gate/up pairs, all E experts' gate and up projections
(and apart from them all E down projections) land in one bucket — stacks
their weights into ``(B, d_out, d_in)`` and
their :class:`~repro_torch.core.calibration.CalibStats` into one batched
set, and compresses the bucket with :func:`repro_torch.core.awp.pgd_batched`:
one launch of the batched step K1b per iteration for the whole bucket,
per-item convergence masking, no host read inside the loop. A bucket
whose stack would take more than ``BUCKET_BYTES`` of device memory runs as
consecutive sub-stacks (:func:`substacks`); every quantity of the recipes
(η, the convergence mask, the projection, the loss) is per item, so each
item's result is the same as in one stack of the whole bucket.

Methods opt in through :func:`repro_torch.core.registry.register_batched`;
a method without a batched form, or a bucket of one, runs per layer with
the sequential driver's numerics, so the engine does everything the
sequential driver does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import awp, calibration as calib, projections as proj
from repro_torch.core import registry
from repro_torch.core.baselines import wanda as _wanda
from repro_torch.core.specs import CompressSpec
from repro_torch.device import to_device
from repro_torch.kernels import impl


# ---------------------------------------------------------------------------
# work units and bucketing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerWork:
    """One linear queued for compression (weight in paper orientation)."""
    name: str                    # short per-block name ("wq", "wu")
    qname: str                   # qualified name ("blocks.2.mlp.wu")
    path: tuple                  # param-tree path
    layer: Optional[int]         # stacked-block index (None for shared)
    spec: CompressSpec
    stats: calib.CalibStats
    w: torch.Tensor              # (d_out, d_in), a view of its leaf


def bucket_key(work: LayerWork) -> Tuple[tuple, CompressSpec]:
    """Two linears batch together iff their weights have the same shape and
    their policy resolved to the same (frozen, hashable) spec."""
    return (tuple(work.w.shape), work.spec)


def bucket_works(works: Sequence[LayerWork]) -> Dict[tuple, List[int]]:
    """Work indices grouped by bucket key, in first-seen order."""
    buckets: Dict[tuple, List[int]] = {}
    for j, wk in enumerate(works):
        buckets.setdefault(bucket_key(wk), []).append(j)
    return buckets


# device bytes a bucket's stack may take before it runs as sub-stacks: at
# qwen3-moe's full width the {wg, wu} bucket of 256 experts would hold
# 17.2 GB of covariances alone
BUCKET_BYTES = 8 << 30


def item_bytes(work: LayerWork) -> int:
    """Device bytes one item adds to a stack, reckoned from its shapes:
    about eight (d_out, d_in) f32 tensors (W, Θ, Z, the initial Θ, the
    residual, the projection's and the loss's temporaries) and three
    (d_in, d_in) (the stacked Σxᵀx, C, and the loss's product)."""
    d_out, d_in = work.w.shape
    return 4 * (8 * d_out * d_in + 3 * d_in * d_in)


def substacks(bucket: Sequence[LayerWork], budget: int):
    """A bucket's positions cut into consecutive sub-stacks of near-equal
    size that fit ``budget`` bytes (:func:`item_bytes`), at least 3 items
    each, so that no sub-stack is a single item (which would take the
    per-layer path). One sub-stack when the bucket fits."""
    n = len(bucket)
    cap = max(3, budget // max(1, item_bytes(bucket[0])))
    if n <= cap:
        return [list(range(n))]
    return [part.tolist() for part in np.array_split(np.arange(n),
                                                     -(-n // cap))]


def compress_block(works: Sequence[LayerWork], metrics=None,
                   on_results=None):
    """Compress every queued linear; per-work ``(CompressResult, loss)`` in
    ``works`` order. Losses stay on the device: the driver reads them with
    the rest of the block's metrics in one transfer at the block's end.
    Each bucket runs as :func:`substacks` of ``BUCKET_BYTES``;
    ``on_results(indices, results)`` is called after each (where
    ``compress_model`` writes the weights back), with the works' indices
    and their results.

    ``metrics`` (a :class:`repro_torch.obs.MetricsRegistry`) receives the
    reference's per-bucket telemetry: buckets, layers a bucket, and each
    bucket's wall time. That time covers queueing the bucket's work only:
    the host reads nothing until the block's end, so it understates the
    card's time."""
    out: List[Optional[tuple]] = [None] * len(works)
    for (shape, spec), idxs in bucket_works(works).items():
        t0 = time.perf_counter()
        for part in substacks([works[j] for j in idxs], BUCKET_BYTES):
            sub = [idxs[p] for p in part]
            results, losses = _compress_bucket([works[j] for j in sub])
            for pos, j in enumerate(sub):
                out[j] = (results[pos], losses[pos])
            if on_results is not None:
                on_results(sub, results)
        if metrics is not None:
            lab = {"method": spec.method,
                   "shape": "x".join(str(d) for d in shape)}
            names = ("method", "shape")
            metrics.counter("compress_buckets_total",
                            "shape/spec buckets dispatched",
                            labelnames=names).labels(**lab).inc()
            metrics.counter("compress_bucket_layers_total",
                            "layers routed through each bucket",
                            labelnames=names).labels(**lab).inc(len(idxs))
            metrics.histogram(
                "compress_bucket_seconds",
                "per-bucket dispatch wall (host syncs deferred to the "
                "block boundary)", labelnames=names,
                unit="seconds").labels(**lab).observe(
                    time.perf_counter() - t0)
    return out


def _compress_bucket(bucket: List[LayerWork]):
    spec = bucket[0].spec
    fn = registry.get_batched(spec.method)
    if fn is None or len(bucket) == 1:
        # per layer: the sequential driver's numerics, the covariance
        # still built once per layer (handed back through aux)
        results, losses = [], []
        for wk in bucket:
            w = wk.w.contiguous()
            res = registry.get_method(spec.method)(w, wk.stats, spec)
            c = res.aux.pop("covariance", None)
            if c is None:
                c = calib.covariance(wk.stats, damp=spec.damp)
            losses.append(awp.activation_loss(w, res.theta, c))
            results.append(res)
        return results, losses

    w_b = torch.stack([wk.w for wk in bucket])
    stats_b = calib.stack_stats([wk.stats for wk in bucket])
    c_b = calib.covariance(stats_b, damp=spec.damp)     # once per bucket
    results = fn(w_b, c_b, stats_b, spec)
    theta_b = torch.stack([r.theta for r in results])
    losses = awp.activation_loss(w_b, theta_b, c_b)
    for r in results:
        r.aux.pop("covariance", None)
    return results, list(losses)


# ---------------------------------------------------------------------------
# batched recipes
# ---------------------------------------------------------------------------

def prune_batched(w_b, c_b, k: int, *, nm: Optional[tuple] = None
                  ) -> awp.AWPResult:
    """§4.1 pruning recipe over a (B, d_out, d_in) stack (Wanda init), as
    one run of the recipe's 200 masked steps."""
    return _prune_chunk(w_b, c_b, None, k, iters=awp.PRUNE_CONFIG.max_iters,
                        nm=nm)


def _prune_chunk(w_b, c_b, theta_b, k: int, *, iters: int,
                 nm: Optional[tuple] = None) -> awp.AWPResult:
    """``iters`` steps of the §4.1 prune loop over a stack, from ``theta_b``
    or, when it is None, from the Wanda warm start. The projection does
    not depend on the step index, so restarting the counter each chunk
    leaves every item's trajectory that of one uninterrupted run."""
    if theta_b is None:
        theta_b = _wanda.prune_weight(w_b, c_b, k)
    cfg = dataclasses.replace(awp.PRUNE_CONFIG, max_iters=iters)
    return awp.pgd_batched(w_b, c_b, awp.prune_projection(k, nm), theta_b,
                           cfg)


def _take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Items ``idx`` (host integers) of a stack: basic-index views stacked
    on the device, so no index tensor goes up to the card."""
    return torch.stack([x[int(i)] for i in idx])


def prune_batched_compacted(w_b, c_b, k: int, *,
                            nm: Optional[tuple] = None) -> awp.AWPResult:
    """§4.1 prune over a stack, re-compacted between chunks of
    ``awp.PGD_CHUNK_ITERS`` steps.

    :func:`prune_batched` pays the whole stack's step until its last item
    converges. This driver reads the (B,) norms and iteration counts on the
    host once per chunk (one transfer), retires the items whose norm fell
    below the recipe's tol, and restacks the rest, so the late chunks pay
    only for the items still moving. Per-item results are
    :func:`prune_batched`'s exactly: within a chunk the masking applies as
    before, and the projection does not depend on the step index. The
    survivors are restacked as they are: the reference pads them to a power
    of two to bound how many chunk shapes JAX compiles, and eager PyTorch
    has no per-shape compile to bound."""
    cfg = awp.PRUNE_CONFIG
    b = w_b.shape[0]
    theta_parts: Dict[int, torch.Tensor] = {}
    gnorm_parts: Dict[int, float] = {}
    iter_counts = np.zeros(b, np.int32)
    active = np.arange(b)
    w_act, c_act, theta_act = w_b, c_b, None          # Wanda init chunk
    done = 0
    while len(active) and done < cfg.max_iters:
        it = min(awp.PGD_CHUNK_ITERS, cfg.max_iters - done)
        res = _prune_chunk(w_act, c_act, theta_act, k, iters=it, nm=nm)
        done += it
        host = torch.stack([res.grad_norm,
                            res.iters.to(torch.float32)]).cpu().numpy()
        gn = host[0]                                  # the chunk's one read
        iter_counts[active] += host[1].astype(np.int32)
        conv = (gn < cfg.tol) | (done >= cfg.max_iters)
        if not conv.any():                            # nothing retired:
            theta_act = res.theta                     # keep the stacks
            continue
        for j in np.nonzero(conv)[0]:
            theta_parts[int(active[j])] = res.theta[j]
            gnorm_parts[int(active[j])] = float(gn[j])
        keep = np.nonzero(~conv)[0]
        active = active[keep]
        if len(active):
            w_act, c_act = _take(w_act, keep), _take(c_act, keep)
            theta_act = _take(res.theta, keep)
    gnorms = np.array([gnorm_parts[i] for i in range(b)], np.float32)
    return awp.AWPResult(
        theta=torch.stack([theta_parts[i] for i in range(b)]),
        iters=to_device(iter_counts, w_b.device),
        grad_norm=to_device(gnorms, w_b.device))


def quantize_batched(w_b, c_b, bits: int, *, group_size: int = 128,
                     max_iters: int = 10) -> awp.AWPResult:
    """§4.2 quantization recipe over a stack (RTN init; tol 0, so no host
    read), keeping per item the better of {init, final}, as
    :func:`awp.quantize` does."""
    quant_project = impl("quant_project")
    theta0 = quant_project(w_b.to(torch.float32), bits, group_size)
    cfg = awp.PGDConfig(max_iters=max_iters, tol=0.0, eta_scale=1.5)
    res = awp.pgd_batched(w_b, c_b,
                          lambda z, t: quant_project(z, bits, group_size),
                          theta0, cfg)
    better = (awp.activation_loss(w_b, res.theta, c_b)
              <= awp.activation_loss(w_b, theta0, c_b))
    theta = torch.where(better[:, None, None], res.theta, theta0)
    return res._replace(theta=theta)


def joint_batched(w_b, c_b, k: int, bits: int = 4, *, group_size: int = 128,
                  ramp_iters: int = 25, prune_only_iters: int = 50,
                  total_iters: int = 100) -> awp.AWPResult:
    """§4.3 joint prune+quant recipe over a stack (the same schedule for
    every item; tol 0, so no host read)."""
    project = awp.joint_projection(k, w_b.shape[-1], bits, group_size,
                                   ramp_iters, prune_only_iters)
    cfg = awp.PGDConfig(max_iters=total_iters, tol=0.0, eta_scale=1.5)
    res = awp.pgd_batched(w_b, c_b, project, w_b.to(torch.float32), cfg)
    return awp.joint_finish(res, k, bits, group_size)


# ---------------------------------------------------------------------------
# packing a bucket at once: per-item QTensors from slices of one stack
# ---------------------------------------------------------------------------

def _pack_batched(theta_b, bits: int, group_size: int):
    """Batched :meth:`QTensor.from_dense` + ``dequant``: (packed, scale,
    zero, dequant) stacks whose items equal the single-layer path's."""
    from repro_torch.quant.qtensor import pack_int4
    b, d_out, d_in = theta_b.shape
    qp = proj.quant_params(theta_b, bits, group_size)
    codes = qp.q.reshape(b, d_out, d_in)
    if bits == 4 and d_in % 2 == 0:
        packed = pack_int4(codes)
    elif bits <= 8:
        packed = codes.to(torch.uint8)
    else:
        packed = codes.to(torch.int32)
    return packed, qp.scale[..., 0], qp.zero[..., 0], proj.dequant(qp)


def _qtensors_from_stack(theta_b, bits: int, group_size: int):
    """[(QTensor, dequantized theta)] for each item of a theta stack."""
    from repro_torch.quant import QTensor
    packed, scale, zero, deq = _pack_batched(theta_b, bits, group_size)
    shape = tuple(theta_b.shape[1:])
    return [(QTensor(packed=packed[i], scale=scale[i], zero=zero[i],
                     bits=bits, group_size=group_size, shape=shape), deq[i])
            for i in range(theta_b.shape[0])]


# ---------------------------------------------------------------------------
# batched registry adapters
# ---------------------------------------------------------------------------

def _prune_results(res: awp.AWPResult):
    return [registry.CompressResult(theta=res.theta[i],
                                    mask=res.theta[i] != 0,
                                    iters=res.iters[i],
                                    aux={"grad_norm": res.grad_norm[i]})
            for i in range(res.theta.shape[0])]


@registry.register_batched("awp_prune")
def _awp_prune_b(w_b, c_b, stats_b, spec):
    return _prune_results(
        prune_batched_compacted(w_b, c_b, spec.k_for(w_b.shape[-1])))


@registry.register_batched("awp_prune_nm")
def _awp_prune_nm_b(w_b, c_b, stats_b, spec):
    return _prune_results(
        prune_batched_compacted(w_b, c_b, spec.k_for(w_b.shape[-1]),
                                nm=spec.nm or (2, 4)))


@registry.register_batched("awp_quant")
def _awp_quant_b(w_b, c_b, stats_b, spec):
    g = spec.group_for(w_b.shape[-1])
    res = quantize_batched(w_b, c_b, spec.bits, group_size=g)
    # one packing for the bucket (a near-exact regrid; the codes become
    # the source of truth)
    return [registry.CompressResult(theta=deq, qtensor=qt, iters=res.iters[i],
                                    aux={"grad_norm": res.grad_norm[i]})
            for i, (qt, deq) in enumerate(
                _qtensors_from_stack(res.theta, spec.bits, g))]


@registry.register_batched("awp_joint")
def _awp_joint_b(w_b, c_b, stats_b, spec):
    g = spec.group_for(w_b.shape[-1])
    res = joint_batched(w_b, c_b, spec.k_for(w_b.shape[-1]), spec.bits,
                        group_size=g)
    mask_b = res.theta != 0
    return [registry.CompressResult(theta=deq * mask_b[i], mask=mask_b[i],
                                    qtensor=qt, iters=res.iters[i])
            for i, (qt, deq) in enumerate(
                _qtensors_from_stack(res.theta, spec.bits, g))]


@registry.register_batched("wanda")
def _wanda_b(w_b, c_b, stats_b, spec):
    if spec.nm is not None:
        theta_b = _wanda.prune_weight_n_m(w_b, c_b, *spec.nm)
    else:
        theta_b = _wanda.prune_weight(w_b, c_b, spec.k_for(w_b.shape[-1]))
    return [registry.CompressResult(theta=theta_b[i], mask=theta_b[i] != 0)
            for i in range(w_b.shape[0])]


@registry.register_batched("magnitude")
def _magnitude_b(w_b, c_b, stats_b, spec):
    theta_b = proj.topk_row(w_b, spec.k_for(w_b.shape[-1]))    # row-local
    return [registry.CompressResult(theta=theta_b[i], mask=theta_b[i] != 0)
            for i in range(w_b.shape[0])]


__all__ = ["BUCKET_BYTES", "LayerWork", "bucket_key", "bucket_works",
           "compress_block", "item_bytes", "substacks",
           "prune_batched", "prune_batched_compacted", "quantize_batched",
           "joint_batched"]
