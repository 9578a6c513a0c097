"""Whole-model layer-wise compression driver (the paper's pipeline).

Block-wise compression with error propagation:

  1. embed the calibration batches,
  2. per block: capture every linear's input activations → fold them into
     per-linear CalibStats (per-expert stats for MoE blocks),
  3. compress each linear with the method its policy rule selects — by
     default with the batched engine (``core/batched.py``: one program per
     shape bucket, the block's metrics read in one transfer at its end),
     or layer by layer with ``engine="sequential"``, the reference driver,
  4. re-run the block with compressed weights to produce the next block's
     (error-propagated) inputs.

Telemetry goes to a :class:`repro_torch.obs.MetricsRegistry` as in the
reference: per layer its PGD iterations, residual and (block-amortized)
seconds, per bucket of the batched engine its counts and seconds, per block
its seconds; one block can be wrapped in a ``torch.profiler`` window. Every
value recorded is one the driver already brought to the host.

Weights are stored (d_in, d_out); the compression math runs in paper
orientation (d_out, d_in), transposed at this boundary only. The driver
works on a copy of the params and writes compressed weights into it in
place, so the caller's tree is untouched and the model is held twice at
most. ``compress_model`` returns ``(params, CompressionReport)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import awp, calibration as calib, registry
from repro_torch.core.specs import CompressSpec, Policy, qualified_name
from repro_torch.device import to_device, to_host
from repro_torch.obs import (ITER_BUCKETS, RESIDUAL_BUCKETS, MetricsRegistry,
                             default_registry, trace_window)

@dataclasses.dataclass
class CompressionConfig:
    """Legacy flat config — one method/ratio/bits for every linear.

    Kept as a thin front-end: it converts to a single-rule :class:`Policy`
    (``as_policy``). New code should build Policy/specs directly.
    """
    method: str = "awp_prune"
    ratio: float = 0.5           # pruning ratio p (fraction zeroed)
    bits: int = 4
    group_size: int = 128
    damp: float = 0.01           # covariance damping (MoE low-token guard)
    skip: tuple = ()             # linear-name substrings to leave dense

    def spec(self) -> CompressSpec:
        cls = registry.spec_cls_for(self.method)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: getattr(self, k)
                  for k in ("ratio", "bits", "group_size", "damp")
                  if k in fields}
        return cls(method=self.method, **kwargs)

    def as_policy(self) -> Policy:
        # alias_only: legacy skip substrings match the SHORT layer name only
        # ("o" must hit "wo", not the "o" in "blocks.0.…")
        return Policy([(f"*{s}*", None, True) for s in self.skip],
                      default=self.spec())


PolicyLike = Union[Policy, CompressSpec, CompressionConfig]


def as_policy(policy: PolicyLike) -> Policy:
    if isinstance(policy, Policy):
        return policy
    if isinstance(policy, CompressSpec):
        return Policy(default=policy)
    if isinstance(policy, CompressionConfig):
        return policy.as_policy()
    raise TypeError(f"expected Policy/CompressSpec/CompressionConfig, "
                    f"got {type(policy).__name__}")


def compress_weight(w_paper: torch.Tensor, stats: calib.CalibStats,
                    cfg: Union[CompressSpec, CompressionConfig]) -> torch.Tensor:
    """Legacy single-weight entry point: dense compressed weight only."""
    spec = cfg.spec() if isinstance(cfg, CompressionConfig) else cfg
    if not isinstance(spec, CompressSpec):
        raise TypeError(f"compress_weight takes one spec/config, "
                        f"got {type(cfg).__name__}")
    return compress_layer(w_paper, stats, spec).theta


def compress_layer(w_paper: torch.Tensor, stats: calib.CalibStats,
                   spec: CompressSpec) -> registry.CompressResult:
    """Compress one weight (paper orientation) via the registered method."""
    registry.validate_spec(spec)
    return registry.get_method(spec.method)(w_paper, stats, spec)


# ---------------------------------------------------------------------------
# capture folding
# ---------------------------------------------------------------------------

def _fold_experts(st: calib.CalibStats, mask: torch.Tensor, acts,
                  t: int) -> calib.CalibStats:
    """Fold one batch into stacked (E, …) expert stats, in place: expert e
    adds Σ_t m_te·a_tᵀa_t and Σ_t m_te·|a_t| over the (T, d) inputs
    ``acts(e)`` it sees, with ``mask`` (T, E) its 0/1 routing. The reference
    writes this as one einsum over the expert axis (``te,td,tf->edf``),
    which naively materializes (T, E, d); here it runs expert by expert.
    ``n`` counts every token, routed or not, as the reference's does."""
    for e in range(mask.shape[1]):
        a = acts(e)
        m = mask[:, e]
        st.c_sum[e].addmm_((a * m[:, None]).T, a)
        st.abs_sum[e].add_(m @ a.abs())
    return st._replace(n=st.n + t)


def _fold_captures(stats: Dict[Any, calib.CalibStats],
                   caps: Dict[str, torch.Tensor], num_experts: int) -> None:
    """Fold one batch's captures into the per-capture-key stats dict. MoE
    experts fold into stacked (E, d, d) statistics under the keys
    ``("moe",)`` (the gate and up projections' inputs) and
    ``("moe_down",)`` (each expert's down-projection inputs)."""
    for key, val in caps.items():
        if key in ("moe_mask", "moe_up"):
            continue
        if key == "moe_in":
            x = val.reshape(-1, val.shape[-1]).to(torch.float32)    # (T, d)
            mask = caps["moe_mask"].to(torch.float32)               # (T, E)
            up = caps["moe_up"].to(torch.float32)                   # (T, E, f)
            t = x.shape[0]
            for skey, width, acts in ((("moe",), x.shape[-1], lambda e: x),
                                      (("moe_down",), up.shape[-1],
                                       lambda e: up[:, e])):
                st = stats.get(skey)
                if st is None:
                    st = calib.init(width, device=x.device,
                                    lead=(num_experts,))
                stats[skey] = _fold_experts(st, mask, acts, t)
            continue
        st = stats.get(key)
        if st is None:
            st = calib.init(val.shape[-1], device=val.device)
        stats[key] = calib.update(st, val)


def _stats_for(stats, cap_key: str, name: str) -> calib.CalibStats:
    """A linear's stats: its capture key's, or for an expert ("moe_wu_3")
    its slice of the stacked expert stats."""
    if cap_key in ("moe", "moe_down"):
        return calib.slice_stats(stats[(cap_key,)],
                                 int(name.rsplit("_", 1)[1]))
    return stats[cap_key]


# ---------------------------------------------------------------------------
# param tree get/set by path. Path grammar: dict keys, optionally ending in
# one int (expert index); a leading "blocks" key means the leaf is
# layer-stacked and ``layer`` selects the leading dim, e.g.
# ("blocks", "moe", "wu", e) → params["blocks"]["moe"]["wu"][layer, e].
# ---------------------------------------------------------------------------

def resolve_path(path, layer: Optional[int]):
    """(dict-key path, stacked-leaf index tuple) for one linear's path."""
    dict_path = [p for p in path if not isinstance(p, int)]
    idx = tuple(p for p in path if isinstance(p, int))
    if dict_path[0] == "blocks" and layer is not None:
        idx = (layer,) + idx
    return dict_path, idx


def _leaf(params, dict_path):
    node = params
    for p in dict_path:
        node = node[p]
    return node


def _linear_view(params, path, layer: Optional[int]) -> torch.Tensor:
    """Weight in PAPER orientation (d_out, d_in), as a view of its leaf."""
    dict_path, idx = resolve_path(path, layer)
    leaf = _leaf(params, dict_path)
    return (leaf[idx] if idx else leaf).T


def get_linear(params, path, layer: Optional[int]) -> torch.Tensor:
    """Weight in PAPER orientation (d_out, d_in), as a contiguous copy."""
    return _linear_view(params, path, layer).contiguous()


def set_linear(params, path, layer: Optional[int], w_paper: torch.Tensor):
    """Write one PAPER-orientation (d_out, d_in) weight into its leaf, in
    place for a stacked slice; returns ``params``."""
    dict_path, idx = resolve_path(path, layer)
    value = w_paper.T
    if idx:
        leaf = _leaf(params, dict_path)
        leaf[idx] = value.to(leaf.dtype)
    else:
        parent = _leaf(params, dict_path[:-1])
        parent[dict_path[-1]] = value.to(parent[dict_path[-1]].dtype).contiguous()
    return params


def _tree_set_many(params, dict_path, idx_list, values) -> None:
    """Write many PAPER-orientation weights of one stacked leaf in place:
    ``idx_list`` their stacked-leaf index tuples (one arity), ``values``
    the weights. One indexed write for the lot (all of a sub-stack's
    experts of one leaf), not one a weight."""
    leaf = _leaf(params, dict_path)
    if len(values) == 1:
        leaf[idx_list[0]] = values[0].T.to(leaf.dtype)
        return
    cols = tuple(to_device(np.array(col), leaf.device)
                 for col in zip(*idx_list))
    leaf[cols] = torch.stack([v.T for v in values]).to(leaf.dtype)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerReport:
    block: int
    name: str
    loss_before: float           # activation loss of uncompressed (=0)
    loss_after: float            # normalized activation-aware loss
    sparsity: float
    seconds: float
    method: str = ""
    qualname: str = ""


@dataclasses.dataclass
class LayerArtifact:
    """One layer's structured compression output, addressable for
    write-back. The result's ``theta`` is None: the dense weight lives in
    the returned params."""
    name: str                    # qualified name, e.g. "blocks.3.attn.wq"
    path: tuple                  # param-tree path
    layer: Optional[int]         # stacked-block index (None for shared)
    spec: CompressSpec
    result: registry.CompressResult


@dataclasses.dataclass
class CompressionReport:
    """Per-layer metrics + artifacts. Iterates like a list of LayerReport."""
    layers: List[LayerReport] = dataclasses.field(default_factory=list)
    artifacts: Dict[str, LayerArtifact] = dataclasses.field(default_factory=dict)
    policy: Optional[Policy] = None

    def __iter__(self):
        return iter(self.layers)

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        return self.layers[i]

    def packed_layers(self) -> Dict[str, LayerArtifact]:
        """Artifacts that carry packed QTensor codes (quantizing methods)."""
        return {n: a for n, a in self.artifacts.items()
                if a.result.qtensor is not None}

    def mean_loss(self) -> float:
        return (float(np.mean([r.loss_after for r in self.layers]))
                if self.layers else 0.0)

    def mean_sparsity(self) -> float:
        return (float(np.mean([r.sparsity for r in self.layers]))
                if self.layers else 0.0)

    def summary(self) -> str:
        by_method: Dict[str, int] = {}
        for r in self.layers:
            by_method[r.method] = by_method.get(r.method, 0) + 1
        packed = self.packed_layers()
        packed_bytes = sum(a.result.qtensor.nbytes() for a in packed.values())
        lines = [f"{len(self.layers)} layers compressed "
                 f"({', '.join(f'{m}×{n}' for m, n in sorted(by_method.items()))})",
                 f"mean loss {self.mean_loss():.4f}  "
                 f"mean sparsity {self.mean_sparsity():.2f}"]
        if packed:
            lines.append(f"{len(packed)} packed QTensors, "
                         f"{packed_bytes / 1e6:.2f} MB")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _record_layer_metrics(metrics: Optional[MetricsRegistry], method: str,
                          loss: float, seconds: float, iters) -> None:
    """Per-layer convergence telemetry: the PGD iterations the layer took,
    the residual it reached and its (possibly block-amortized) wall time."""
    if metrics is None:
        return
    lab = {"method": method}
    metrics.counter("compress_layers_total", "layers compressed",
                    labelnames=("method",)).labels(**lab).inc()
    metrics.histogram(
        "compress_residual",
        "normalized activation-aware loss after compression",
        labelnames=("method",),
        buckets=RESIDUAL_BUCKETS).labels(**lab).observe(loss)
    metrics.histogram(
        "compress_layer_seconds",
        "per-layer compression wall time (batched: block time amortized)",
        labelnames=("method",), unit="seconds").labels(**lab).observe(seconds)
    if iters is not None:
        metrics.histogram(
            "compress_pgd_iters",
            "projected-gradient iterations to convergence",
            labelnames=("method",),
            buckets=ITER_BUCKETS).labels(**lab).observe(int(iters))


def _compress_block_sequential(model, params, block_idx: int, stats,
                               policy: Policy, report: CompressionReport,
                               verbose: bool,
                               metrics: Optional[MetricsRegistry] = None):
    """Layer-at-a-time reference driver (host reads per layer for the
    metrics); the numerical baseline the batched engine is held to."""
    for (name, path, cap_key) in model.block_linears(block_idx):
        layer = block_idx if path[0] == "blocks" else None
        qname = qualified_name(path, layer)
        spec = policy.spec_for(qname, name)
        if spec is None:
            continue                     # rule says: leave dense
        st = _stats_for(stats, cap_key, name)
        if float(st.n) < 1:
            continue                     # no calibration token: keep dense
        w = get_linear(params, path, layer)
        t0 = time.time()
        res = compress_layer(w, st, spec)
        c = res.aux.pop("covariance", None)
        if c is None:
            c = calib.covariance(st, damp=spec.damp)
        loss = float(awp.activation_loss(w, res.theta, c))
        if res.loss is None:
            res.loss = loss
        sp = float((res.theta == 0).to(torch.float32).mean())
        if res.iters is not None:
            res.iters = int(res.iters)
        seconds = time.time() - t0
        report.layers.append(LayerReport(block_idx, name, 0.0, loss, sp,
                                         seconds, method=spec.method,
                                         qualname=qname))
        report.artifacts[qname] = LayerArtifact(qname, tuple(path), layer,
                                                spec, res)
        _record_layer_metrics(metrics, spec.method, loss, seconds, res.iters)
        if verbose:
            print(f"  block {block_idx} {name} [{spec.method}]: "
                  f"loss={loss:.4f} sparsity={sp:.2f} iters={res.iters}")
        set_linear(params, path, layer, res.theta)
        # written back: drop theta and host the mask, so the report pins
        # no second copy of the model on the device
        res.theta = None
        if res.mask is not None:
            res.mask = res.mask.cpu().numpy()
    return params


def _block_works(model, params, block_idx: int, stats, policy: Policy):
    """This block's linears resolved against the policy, as LayerWork
    items; one host read per block (the token counts) drops layers that
    saw no calibration token. Each item's weight is a view of its leaf:
    the engine stacks a bucket's weights itself, so no second copy of the
    block's weights is held."""
    from repro_torch.core import batched as _batched
    works = []
    for (name, path, cap_key) in model.block_linears(block_idx):
        layer = block_idx if path[0] == "blocks" else None
        qname = qualified_name(path, layer)
        spec = policy.spec_for(qname, name)
        if spec is None:
            continue                         # rule says: leave dense
        works.append(_batched.LayerWork(name, qname, tuple(path), layer,
                                        spec, _stats_for(stats, cap_key, name),
                                        _linear_view(params, path, layer)))
    if not works:
        return works
    (ns,) = to_host([torch.stack([wk.stats.n for wk in works])])
    return [wk for wk, n in zip(works, ns) if n >= 1]


def _compress_block_batched(model, params, block_idx: int, stats,
                            policy: Policy, report: CompressionReport,
                            verbose: bool,
                            metrics: Optional[MetricsRegistry] = None):
    """Shape-bucketed block compression: one program per bucket (or
    sub-stack of one), and the block's losses, sparsities, masks and
    iteration counts read on the host in one transfer at the block's end.
    Each sub-stack's weights are written back as soon as it is done, one
    indexed write a leaf (the reference's grouped ``_tree_set_many`` at
    the block's end): no work reads another's weight, and the block's
    compressed weights are never all held beside the params."""
    from repro_torch.core import batched as _batched
    t0 = time.time()
    works = _block_works(model, params, block_idx, stats, policy)
    if not works:
        return params
    sparsity: List[Optional[torch.Tensor]] = [None] * len(works)

    def write_back(idxs, results):
        groups: Dict[tuple, list] = {}
        for j, res in zip(idxs, results):
            dict_path, idx = resolve_path(works[j].path, works[j].layer)
            groups.setdefault(tuple(dict_path), []).append((idx, res.theta))
            sparsity[j] = (res.theta == 0).to(torch.float32).mean()
        for dict_path, entries in groups.items():
            _tree_set_many(params, dict_path, [i for i, _ in entries],
                           [v for _, v in entries])
        for res in results:
            res.theta = None    # written back: the report must not pin a
                                # second copy of the model on the device

    outcomes = _batched.compress_block(works, metrics=metrics,
                                       on_results=write_back)
    results = [res for res, _ in outcomes]

    # the block's one read: every metric and mask in a single transfer
    # iteration counts on the device ride along; a method that reports a
    # host int (AWP-S's fixed 10) keeps it, since uploading it would wait
    has_iters = [j for j, r in enumerate(results) if torch.is_tensor(r.iters)]
    has_mask = [j for j, r in enumerate(results) if r.mask is not None]
    host = to_host(
        [torch.stack([loss for _, loss in outcomes]),
         torch.stack(sparsity)]
        + [results[j].iters.to(torch.int32) for j in has_iters]
        + [results[j].mask for j in has_mask])
    losses, sps = host[:2]
    its = dict(zip(has_iters, host[2:2 + len(has_iters)]))
    masks = dict(zip(has_mask, host[2 + len(has_iters):]))
    seconds = (time.time() - t0) / len(works)   # block time, amortized

    for j, wk in enumerate(works):
        res = results[j]
        loss, sp = float(losses[j]), float(sps[j])
        if res.loss is None:
            res.loss = loss
        if j in masks:
            res.mask = masks[j]
        if j in its:
            res.iters = int(its[j])
        report.layers.append(LayerReport(block_idx, wk.name, 0.0, loss, sp,
                                         seconds, method=wk.spec.method,
                                         qualname=wk.qname))
        report.artifacts[wk.qname] = LayerArtifact(wk.qname, wk.path,
                                                   wk.layer, wk.spec, res)
        _record_layer_metrics(metrics, wk.spec.method, loss, seconds,
                              res.iters)
        if verbose:
            print(f"  block {block_idx} {wk.name} [{wk.spec.method}]: "
                  f"loss={loss:.4f} sparsity={sp:.2f} iters={res.iters}")
    return params


def compress_model(model, params, calib_batches: List[dict],
                   policy: PolicyLike, verbose: bool = False,
                   engine: str = "batched",
                   metrics: Optional[MetricsRegistry] = None,
                   profile_dir: str = "", profile_block: int = -1):
    """Compress every linear of every block per the policy.

    ``engine="batched"`` (the default, as in the reference) buckets each
    block's linears by (shape, spec) and compresses each bucket at once,
    reading the block's metrics on the host once at its end;
    ``engine="sequential"`` is the layer-at-a-time reference driver. Both
    return ``(params, CompressionReport)`` with per-layer losses within
    ~1e-5 of each other. ``calib_batches`` are input batches on the
    params' device, read only through ``model.embed``: ``"tokens"``; an
    audio config's ``"frames"`` instead; a vlm config's ``"patches"``
    beside its tokens (``models.make_batch`` gives each).

    ``metrics`` receives the telemetry (per-layer iterations, residual and
    seconds, per-bucket counts and seconds, per-block seconds); None uses
    the process-global :func:`repro_torch.obs.default_registry`.
    ``profile_block`` wraps that block (capture, compress, propagate) in a
    ``torch.profiler`` window written under ``profile_dir``."""
    if engine not in ("batched", "sequential"):
        raise ValueError(f"engine must be 'batched' or 'sequential', "
                         f"got {engine!r}")
    policy = as_policy(policy)
    for s in [r.spec for r in policy.rules] + [policy.default]:
        if s is not None:
            registry.validate_spec(s)
    if metrics is None:
        metrics = default_registry()
    block_fn = (_compress_block_batched if engine == "batched"
                else _compress_block_sequential)
    params = _clone(params)
    num_experts = getattr(model.cfg, "num_experts", 0)
    hs = [model.embed(params, b) for b in calib_batches]
    report = CompressionReport(policy=policy)
    h_block = metrics.histogram(
        "compress_block_seconds",
        "per-block wall time: capture + compress + propagate",
        labelnames=("engine",), unit="seconds").labels(engine=engine)
    for i in range(model.num_blocks()):
        ctx = (trace_window(profile_dir) if i == profile_block
               else contextlib.nullcontext())
        tb = time.time()
        with ctx:
            stats: Dict[Any, calib.CalibStats] = {}
            for h in hs:
                _, caps = model.block_apply_one(params, i, h, capture=True)
                _fold_captures(stats, caps, num_experts)
                del caps
            params = block_fn(model, params, i, stats, policy, report,
                              verbose, metrics=metrics)
            hs = [model.block_apply_one(params, i, h)[0] for h in hs]
        h_block.observe(time.time() - tb)
    return params, report


__all__ = ["CompressionConfig", "CompressionReport", "LayerArtifact",
           "LayerReport", "as_policy", "compress_layer", "compress_model",
           "compress_weight", "get_linear", "resolve_path",
           "set_linear"]
