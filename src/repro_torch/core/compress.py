"""Whole-model layer-wise compression driver (the paper's pipeline).

Block-wise compression with error propagation:

  1. embed the calibration batches,
  2. per block: capture every linear's input activations → fold them into
     per-linear CalibStats,
  3. compress each linear with the method its policy rule selects — by
     default with the batched engine (``core/batched.py``: one program per
     shape bucket, the block's metrics read in one transfer at its end),
     or layer by layer with ``engine="sequential"``, the reference driver,
  4. re-run the block with compressed weights to produce the next block's
     (error-propagated) inputs.

Weights are stored (d_in, d_out); the compression math runs in paper
orientation (d_out, d_in), transposed at this boundary only. The driver
works on a copy of the params and writes compressed weights into it in
place, so the caller's tree is untouched and the model is held twice at
most. ``compress_model`` returns ``(params, CompressionReport)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import awp, calibration as calib, registry
from repro_torch.core.specs import CompressSpec, Policy, qualified_name
from repro_torch.device import to_host

PolicyLike = Union[Policy, CompressSpec]


def as_policy(policy: PolicyLike) -> Policy:
    if isinstance(policy, Policy):
        return policy
    if isinstance(policy, CompressSpec):
        return Policy(default=policy)
    raise TypeError(f"expected Policy/CompressSpec, got {type(policy).__name__}")


def compress_layer(w_paper: torch.Tensor, stats: calib.CalibStats,
                   spec: CompressSpec) -> registry.CompressResult:
    """Compress one weight (paper orientation) via the registered method."""
    registry.validate_spec(spec)
    return registry.get_method(spec.method)(w_paper, stats, spec)


# ---------------------------------------------------------------------------
# param tree get/set by path. Path grammar: dict keys, optionally ending in
# one int (expert index); a leading "blocks" key means the leaf is
# layer-stacked and ``layer`` selects the leading dim.
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


def get_linear(params, path, layer: Optional[int]) -> torch.Tensor:
    """Weight in PAPER orientation (d_out, d_in), as a contiguous copy."""
    dict_path, idx = resolve_path(path, layer)
    leaf = _leaf(params, dict_path)
    return (leaf[idx] if idx else leaf).T.contiguous()


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

def _compress_block_sequential(model, params, block_idx: int, stats,
                               policy: Policy, report: CompressionReport,
                               verbose: bool):
    """Layer-at-a-time reference driver (host reads per layer for the
    metrics); the numerical baseline the batched engine is held to."""
    for (name, path, cap_key) in model.block_linears(block_idx):
        layer = block_idx if path[0] == "blocks" else None
        qname = qualified_name(path, layer)
        spec = policy.spec_for(qname, name)
        if spec is None:
            continue                     # rule says: leave dense
        st = stats[cap_key]
        if float(st.n) < 1:
            continue
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
    saw no calibration token."""
    from repro_torch.core import batched as _batched
    works = []
    for (name, path, cap_key) in model.block_linears(block_idx):
        layer = block_idx if path[0] == "blocks" else None
        qname = qualified_name(path, layer)
        spec = policy.spec_for(qname, name)
        if spec is None:
            continue                         # rule says: leave dense
        st = stats[cap_key]
        works.append(_batched.LayerWork(name, qname, tuple(path), layer,
                                        spec, st,
                                        get_linear(params, path, layer)))
    if not works:
        return works
    (ns,) = to_host([torch.stack([wk.stats.n for wk in works])])
    return [wk for wk, n in zip(works, ns) if n >= 1]


def _compress_block_batched(model, params, block_idx: int, stats,
                            policy: Policy, report: CompressionReport,
                            verbose: bool):
    """Shape-bucketed block compression: one program per bucket, and the
    block's losses, sparsities, masks and iteration counts read on the
    host in one transfer at the block's end."""
    from repro_torch.core import batched as _batched
    t0 = time.time()
    works = _block_works(model, params, block_idx, stats, policy)
    if not works:
        return params
    outcomes = _batched.compress_block(works)
    results = [res for res, _ in outcomes]
    # in place, slice by slice: the reference gathers a leaf's writes into
    # one scatter because each functional update copies the whole leaf
    for wk, res in zip(works, results):
        set_linear(params, wk.path, wk.layer, res.theta)

    # the block's one read: every metric and mask in a single transfer
    has_iters = [j for j, r in enumerate(results) if r.iters is not None]
    has_mask = [j for j, r in enumerate(results) if r.mask is not None]
    dev = works[0].w.device
    host = to_host(
        [torch.stack([loss for _, loss in outcomes]),
         torch.stack([(r.theta == 0).to(torch.float32).mean()
                      for r in results])]
        + [torch.as_tensor(results[j].iters, dtype=torch.int32, device=dev)
           for j in has_iters]
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
        res.theta = None        # written back: the report must not pin a
        if j in masks:          # second copy of the model on the device
            res.mask = masks[j]
        if j in its:
            res.iters = int(its[j])
        report.layers.append(LayerReport(block_idx, wk.name, 0.0, loss, sp,
                                         seconds, method=wk.spec.method,
                                         qualname=wk.qname))
        report.artifacts[wk.qname] = LayerArtifact(wk.qname, wk.path,
                                                   wk.layer, wk.spec, res)
        if verbose:
            print(f"  block {block_idx} {wk.name} [{wk.spec.method}]: "
                  f"loss={loss:.4f} sparsity={sp:.2f} iters={res.iters}")
    return params


def compress_model(model, params, calib_batches: List[dict],
                   policy: PolicyLike, verbose: bool = False,
                   engine: str = "batched"):
    """Compress every linear of every block per the policy.

    ``engine="batched"`` (the default, as in the reference) buckets each
    block's linears by (shape, spec) and compresses each bucket at once,
    reading the block's metrics on the host once at its end;
    ``engine="sequential"`` is the layer-at-a-time reference driver. Both
    return ``(params, CompressionReport)`` with per-layer losses within
    ~1e-5 of each other. ``calib_batches`` are dicts with ``"tokens"``
    tensors on the params' device."""
    if engine not in ("batched", "sequential"):
        raise ValueError(f"engine must be 'batched' or 'sequential', "
                         f"got {engine!r}")
    policy = as_policy(policy)
    for s in [r.spec for r in policy.rules] + [policy.default]:
        if s is not None:
            registry.validate_spec(s)
    block_fn = (_compress_block_batched if engine == "batched"
                else _compress_block_sequential)
    params = _clone(params)
    hs = [model.embed(params, b) for b in calib_batches]
    report = CompressionReport(policy=policy)
    for i in range(model.num_blocks()):
        stats: Dict[str, calib.CalibStats] = {}
        for h in hs:
            _, caps = model.block_apply_one(params, i, h, capture=True)
            for key, val in caps.items():
                st = stats.get(key)
                if st is None:
                    st = calib.init(val.shape[-1], device=val.device)
                stats[key] = calib.update(st, val)
        params = block_fn(model, params, i, stats, policy, report, verbose)
        hs = [model.block_apply_one(params, i, h)[0] for h in hs]
    return params, report


__all__ = ["CompressionReport", "LayerArtifact", "LayerReport", "as_policy",
           "compress_layer", "compress_model", "get_linear", "resolve_path",
           "set_linear"]
