"""Whole-model layer-wise compression driver (the paper's pipeline).

Sequential block-wise compression with error propagation:

  1. embed the calibration batches,
  2. per block: capture every linear's input activations → fold them into
     per-linear CalibStats,
  3. compress each linear with the method its policy rule selects,
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
    """Layer-at-a-time driver (host sync per layer for the metrics)."""
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


def compress_model(model, params, calib_batches: List[dict],
                   policy: PolicyLike, verbose: bool = False,
                   engine: str = "sequential"):
    """Compress every linear of every block per the policy.

    ``calib_batches`` are dicts with ``"tokens"`` tensors on the params'
    device. Only the sequential engine is ported (the reference driver
    the JAX package's batched engine is tested against)."""
    if engine != "sequential":
        raise ValueError(f"engine {engine!r} is not ported; use 'sequential'")
    policy = as_policy(policy)
    for s in [r.spec for r in policy.rules] + [policy.default]:
        if s is not None:
            registry.validate_spec(s)
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
        params = _compress_block_sequential(model, params, i, stats, policy,
                                            report, verbose)
        hs = [model.block_apply_one(params, i, h)[0] for h in hs]
    return params, report


__all__ = ["CompressionReport", "LayerArtifact", "LayerReport", "as_policy",
           "compress_layer", "compress_model", "get_linear", "resolve_path",
           "set_linear"]
