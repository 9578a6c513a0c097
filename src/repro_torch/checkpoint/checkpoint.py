"""Checkpoints in the format of ``repro/checkpoint/checkpoint.py``: dense
(:func:`save_checkpoint`, :func:`restore_checkpoint`,
:class:`CheckpointManager`) and packed.

Layout:  <dir>/step_<N>/
           manifest.json     — keys, step, packed-layer metadata, policy
           arrays.npz        — one entry per leaf, keyed by its path as JAX's
                               ``keystr`` writes it (``['blocks']['attn']['wq']``)
           packed.npz        — per packed layer: ``<name>#packed``, ``#scale``,
                               ``#zero`` (and ``#col_scale``, ``#mask``)

A dense checkpoint has no packed.npz and no ``packed`` manifest entry; a
checkpoint written by either package restores in the other. In a packed
one, quantized layers' dense slices are zeroed in arrays.npz (compressed, so
the holes cost nothing); loading rebuilds the QTensors. A leaf stays a
stacked packed QTensor only when every slice of it is uniformly quantized
and unmasked (:func:`_packable_groups`); other packed layers are
materialized densely. Writes are atomic (``step_<N>.tmp`` then
``os.rename``); :class:`CheckpointManager` keeps the newest ``keep_n``.

Sharded trees: a tree of DTensors is saved whole — every rank gathers each
leaf, rank 0 writes — and a restore with ``shardings`` (a tree of
:class:`repro_torch.sharding.NamedSharding`, or the target's own DTensor
placements) reads each leaf whole and places it on the target mesh, which
may differ from the one that saved it (elastic restart).
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import types
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.compress import resolve_path, set_linear
from repro_torch.device import resolve_device
from repro_torch.quant import QTensor


def _is_dtensor(t) -> bool:
    return hasattr(t, "full_tensor") and hasattr(t, "placements")


def _gathered(tree):
    """``tree`` with every DTensor leaf gathered whole (a collective: every
    rank calls it), and whether there was one."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if _is_dtensor(node):
            found.append(True)
            return node.full_tensor()
        return node
    out = walk(tree)
    return out, bool(found)


def _writes() -> bool:
    """False on ranks other than 0 of an initialized process group."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _np(t) -> np.ndarray:
    """Host numpy copy of a leaf; bf16 widens to f32 (npz has no bf16; the
    widening is exact), as the reference stores it."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(t)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _paths(tree, prefix=()):
    """(dict-key path, leaf) of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, Any]:
    return {_keystr(path): leaf for path, leaf in _paths(tree)}


def _write_step_dir(directory: str, step: int, tree: Any, *,
                    extra_manifest: Optional[dict] = None,
                    extra_arrays: Optional[dict] = None,
                    compress: bool = False) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: _np(v) for k, v in _flatten(tree).items()}
    savez = np.savez_compressed if compress else np.savez
    savez(os.path.join(tmp, "arrays.npz"), **arrays)
    if extra_arrays:
        np.savez_compressed(os.path.join(tmp, "packed.npz"), **extra_arrays)
    manifest = {"step": step, "keys": sorted(arrays)}
    manifest.update(extra_manifest or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomicity point
    return final


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Atomic dense save; returns the final path. A tree with DTensor
    leaves is gathered on every rank and written by rank 0; the ranks meet
    at a barrier after the write."""
    tree, sharded = _gathered(tree)
    if not sharded:
        return _write_step_dir(directory, step, tree)
    import torch.distributed as dist
    path = os.path.join(directory, f"step_{step:08d}")
    if _writes():
        path = _write_step_dir(directory, step, tree)
    dist.barrier()
    return path


def restore_checkpoint(path: str, target: Any,
                       shardings: Optional[Any] = None, *,
                       _allow_packed: bool = False,
                       _skip_keys: frozenset = frozenset(),
                       _device: Optional[torch.device] = None) -> Any:
    """Restore into the structure of ``target`` (nested dicts of tensors):
    every leaf comes back with the target leaf's dtype, on its device.

    ``shardings`` (a tree of :class:`~repro_torch.sharding.NamedSharding`
    mirroring ``target``; None leaves stay plain) places each leaf, read
    whole, on its mesh as a DTensor; a DTensor target leaf without one
    keeps its own mesh and placements. A packed checkpoint is
    refused (its dense arrays hold zeroed holes where the codes live):
    load it with :func:`load_packed_checkpoint`. ``_skip_keys`` (for the
    packed loader) names leaves whose stored arrays are not read; the
    target's own leaf stands in for the caller to replace; ``_device``
    places every leaf there instead of on its target leaf's device."""
    if not _allow_packed:
        man_path = os.path.join(path, "manifest.json")
        if os.path.exists(man_path):
            with open(man_path) as f:
                if "packed" in json.load(f):
                    raise ValueError(
                        f"{path} is a packed checkpoint — load it with "
                        f"load_packed_checkpoint (serve with --packed)")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        # skipped leaves' (zeroed-hole) entries are never decompressed
        data = {k: z[k] for k in z.files if k not in _skip_keys}
    out = _copy_dicts(target)
    for key_path, leaf in _paths(target):
        key = _keystr(key_path)
        if key in _skip_keys:
            continue                      # placeholder; caller replaces it
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = torch.from_numpy(data[key])
        sh = None
        if shardings is not None:
            try:
                sh = _leaf_at(shardings, key_path)
            except (KeyError, TypeError):
                raise ValueError(
                    f"restore_checkpoint: shardings has no entry for leaf "
                    f"{key}; give a NamedSharding (a mesh and a spec) or "
                    f"None for every leaf of the target") from None
        if sh is None and _is_dtensor(leaf):
            sh = types.SimpleNamespace(mesh=leaf.device_mesh,
                                       placements=list(leaf.placements))
        if isinstance(leaf, torch.Tensor):
            arr = arr.to(dtype=leaf.dtype)
            if sh is None:
                arr = arr.to(device=_device or leaf.device)
        if sh is not None:
            from repro_torch.sharding import distribute
            arr = distribute(arr, sh)
        _set_leaf(out, key_path, arr)
    return out


def _packed_key(name: str, field: str) -> str:
    return f"{name}#{field}"


def _layer_meta(art) -> dict:
    qt = art.result.qtensor
    return {"bits": qt.bits, "group_size": qt.group_size,
            "shape": list(qt.shape), "path": list(art.path),
            "layer": art.layer, "has_mask": art.result.mask is not None,
            "has_col_scale": qt.col_scale is not None}


def save_packed_checkpoint(directory: str, step: int, params: Any,
                           report: Any) -> str:
    """Save ``params`` with the report's QTensor artifacts stored packed
    (``report``: a :class:`repro_torch.core.compress.CompressionReport`)."""
    arrays: dict = {}
    meta: dict = {}
    holes: dict = {}                      # dict-key path → [stacked indices]
    for name, art in report.packed_layers().items():
        qt = art.result.qtensor
        arrays[_packed_key(name, "packed")] = _np(qt.packed)
        arrays[_packed_key(name, "scale")] = _np(qt.scale)
        arrays[_packed_key(name, "zero")] = _np(qt.zero)
        if qt.col_scale is not None:
            arrays[_packed_key(name, "col_scale")] = _np(qt.col_scale)
        if art.result.mask is not None:
            arrays[_packed_key(name, "mask")] = np.packbits(
                _np(art.result.mask).astype(bool))
        meta[name] = _layer_meta(art)
        dict_path, idx = resolve_path(art.path, art.layer)
        holes.setdefault(tuple(dict_path), []).append(idx)

    def zero_holes(node, prefix=()):
        if prefix in holes:
            arr = _np(node).copy()
            for idx in holes[prefix]:
                if idx:
                    arr[idx] = 0
                else:
                    arr[...] = 0
            return arr
        if isinstance(node, dict):
            return {k: zero_holes(v, prefix + (k,)) for k, v in node.items()}
        return node

    extra = {"packed": meta}
    if getattr(report, "policy", None) is not None:
        extra["policy"] = report.policy.to_dict()
    return _write_step_dir(directory, step, zero_holes(params),
                           extra_manifest=extra, extra_arrays=arrays,
                           compress=True)


def _leaf_at(tree: Any, dict_path) -> Any:
    node = tree
    for k in dict_path:
        node = node[k]
    return node


def _set_leaf(tree: Any, dict_path, value: Any) -> None:
    _leaf_at(tree, dict_path[:-1])[dict_path[-1]] = value


def _packable_groups(packed_meta: dict, target: Any):
    """Group packed layers by param-tree leaf and split them into leaves
    that become stacked QTensors and layers that must materialize densely.

    A leaf is packable iff every slice of it is quantized (full coverage of
    its leading stacked dims) with uniform bits / group_size / col_scale
    presence / shape, and no slice carries a sparsity mask (dequant·mask is
    not what the codes alone give). Returns ``(packable, dense_names)``
    with ``packable: dict_path -> [(idx, name, meta), ...]``."""
    groups: dict = {}
    for name, m in packed_meta.items():
        dict_path, idx = resolve_path(tuple(m["path"]), m["layer"])
        groups.setdefault(tuple(dict_path), []).append((idx, name, m))
    packable, dense_names = {}, []
    for dict_path, entries in groups.items():
        metas = [m for _, _, m in entries]
        lead = tuple(_leaf_at(target, dict_path).shape[:-2])
        full = set(itertools.product(*(range(n) for n in lead)))
        uniform = (
            not any(m["has_mask"] for m in metas)
            and len({(m["bits"], m["group_size"], m["has_col_scale"],
                      tuple(m["shape"])) for m in metas}) == 1
            and all(len(idx) == len(lead) for idx, _, _ in entries)
            and {idx for idx, _, _ in entries} == full)
        if uniform:
            packable[dict_path] = entries
        else:
            dense_names.extend(name for _, name, _ in entries)
    return packable, dense_names


def _stacked_qtensor(entries, lead, field_of) -> QTensor:
    """One QTensor whose fields stack the entries' per-layer fields on the
    leaf's leading dims; ``field_of(name, field)`` gives a tensor."""
    m0 = entries[0][2]

    def stack(field):
        first = field_of(entries[0][1], field)
        out = torch.empty(lead + tuple(first.shape), dtype=first.dtype,
                          device=first.device)
        for idx, name, _ in entries:
            out[idx] = field_of(name, field)
        return out

    return QTensor(packed=stack("packed"), scale=stack("scale"),
                   zero=stack("zero"), bits=int(m0["bits"]),
                   group_size=int(m0["group_size"]), shape=tuple(m0["shape"]),
                   col_scale=stack("col_scale") if m0["has_col_scale"] else None)


def pack_params(params: Any, report: Any) -> Any:
    """In-memory packing of ``compress_model``'s output: every leaf that
    :func:`_packable_groups` accepts becomes a stacked QTensor built from
    the report's artifacts; every other weight stays dense (it already
    holds the compressed values). Returns a new tree; leaves not packed
    are shared with ``params``."""
    packed = report.packed_layers()
    meta = {name: _layer_meta(art) for name, art in packed.items()}
    packable, _ = _packable_groups(meta, params)
    out = _copy_dicts(params)

    def field_of(name, field):
        return getattr(packed[name].result.qtensor, field)

    for dict_path, entries in packable.items():
        lead = tuple(_leaf_at(params, dict_path).shape[:-2])
        _set_leaf(out, list(dict_path), _stacked_qtensor(entries, lead,
                                                         field_of))
    return out


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def load_packed_checkpoint(path: str, target: Any, *,
                           materialize: bool = False, device="cuda"):
    """Load a packed checkpoint: ``(params, {name: QTensor}, manifest)``.

    ``target`` is a params tree giving every leaf's shape and dtype (e.g.
    ``model.init(...)``). Packable leaves come back as
    stacked QTensor leaves on ``device``; with ``materialize=True`` (or for
    masked / partially quantized leaves) layers are expanded densely with
    ``qt.dequant()`` (times the mask when one was stored). The per-layer
    QTensors in the returned dict stay on the host."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "packed" not in manifest:
        raise ValueError(f"{path} is not a packed checkpoint (no 'packed' "
                         f"manifest entry)")
    packed_meta = manifest["packed"]
    data = {}
    if packed_meta:
        with np.load(os.path.join(path, "packed.npz")) as z:
            data = {k: torch.from_numpy(z[k]) for k in z.files}

    qtensors = {}
    for name, m in packed_meta.items():
        qtensors[name] = QTensor(
            packed=data[_packed_key(name, "packed")],
            scale=data[_packed_key(name, "scale")],
            zero=data[_packed_key(name, "zero")],
            bits=int(m["bits"]), group_size=int(m["group_size"]),
            shape=tuple(m["shape"]),
            col_scale=(data[_packed_key(name, "col_scale")]
                       if m["has_col_scale"] else None))

    packable: dict = {}
    dense_names = list(packed_meta)
    if not materialize:
        packable, dense_names = _packable_groups(packed_meta, target)
    skip = {_keystr(dict_path) for dict_path in packable}

    params = restore_checkpoint(path, target, _allow_packed=True,
                                _skip_keys=frozenset(skip), _device=dev)

    def field_of(name, field):
        return getattr(qtensors[name], field).to(dev)

    for dict_path, entries in packable.items():
        lead = tuple(_leaf_at(target, dict_path).shape[:-2])
        _set_leaf(params, list(dict_path),
                  _stacked_qtensor(entries, lead, field_of))

    for name in dense_names:
        m = packed_meta[name]
        shape = tuple(m["shape"])
        w = qtensors[name].dequant()
        if m["has_mask"]:
            bits = np.unpackbits(data[_packed_key(name, "mask")].numpy(),
                                 count=shape[0] * shape[1])
            w = w * torch.from_numpy(bits.reshape(shape).astype(np.float32))
        set_linear(params, tuple(m["path"]), m["layer"], w.to(dev))
    return params, qtensors, manifest


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def latest_path(directory: str) -> Optional[str]:
    step = latest_step(directory)
    return None if step is None else os.path.join(directory, f"step_{step:08d}")


def _host_copy(tree):
    """A host snapshot of a dense tree: every tensor copied to the CPU (a
    copy even when it is there already, so later in-place updates of the
    caller's tensors do not reach the save)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class CheckpointManager:
    """Step directories under ``directory``, the newest ``keep_n`` kept."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any):
        save_checkpoint(self.directory, step, tree)
        if _writes():
            self._rotate()

    def save_async(self, step: int, tree: Any):
        """Non-blocking save: a host snapshot now, written on a worker
        thread (one save in flight; an earlier one is waited for). A
        sharded tree is gathered now on every rank and written by rank 0
        alone."""
        self.wait()
        tree, sharded = _gathered(tree)
        if sharded and not _writes():
            return
        host_tree = _host_copy(tree)
        self._thread = threading.Thread(
            target=lambda: (save_checkpoint(self.directory, step, host_tree),
                            self._rotate()))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def latest_path(self) -> Optional[str]:
        return latest_path(self.directory)

    def restore_latest(self, target, shardings=None):
        """``(tree, step)`` from the newest checkpoint, or ``(None, None)``
        when the directory holds none."""
        path = self.latest_path()
        if path is None:
            return None, None
        step = int(os.path.basename(path).split("_")[1])
        return restore_checkpoint(path, target, shardings), step

    def restore_latest_packed(self, target, *, materialize: bool = False,
                              device="cuda"):
        """``(params, {name: QTensor}, manifest)`` from the newest packed
        checkpoint, or ``(None, None, None)`` when there is none."""
        path = self.latest_path()
        if path is None:
            return None, None, None
        return load_packed_checkpoint(path, target, materialize=materialize,
                                      device=device)

    def _rotate(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))


__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "save_packed_checkpoint", "load_packed_checkpoint", "pack_params",
           "latest_step", "latest_path"]
