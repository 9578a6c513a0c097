"""Carry weights from the JAX package into the port as numpy arrays.

The JAX side hands over ``jax.tree.map(np.asarray, params)``: nested dicts
of numpy arrays, with packed layers as QTensor-shaped objects whose array
fields are numpy. Nothing here imports JAX or the JAX package; a QTensor
is recognised by its fields (``packed``, ``scale``, ``zero``, ``bits``,
``group_size``, ``shape``, ``col_scale``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant import QTensor
from repro_torch.serving.kv_cache import QuantizedKV


def _tensor(arr, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def qtensor_from_numpy(qt, device="cuda") -> QTensor:
    """The port's :class:`QTensor` for a QTensor whose array fields are
    numpy (stacked leaves keep their leading dims)."""
    dev = resolve_device(device)
    return QTensor(packed=_tensor(qt.packed, dev), scale=_tensor(qt.scale, dev),
                   zero=_tensor(qt.zero, dev), bits=int(qt.bits),
                   group_size=int(qt.group_size),
                   shape=tuple(int(s) for s in qt.shape),
                   col_scale=(None if qt.col_scale is None
                              else _tensor(qt.col_scale, dev)))


def _is_qtensor(node) -> bool:
    return all(hasattr(node, f) for f in ("packed", "scale", "zero", "bits",
                                          "group_size", "shape"))


def params_from_numpy(tree, device="cuda"):
    """The port's params dict for a JAX param tree of numpy arrays: same
    keys, same layouts (stacked blocks, ``(d_in, d_out)`` weights)."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if _is_qtensor(node):
            return qtensor_from_numpy(node, dev)
        return _tensor(node, dev)

    return rec(tree)


def quantized_kv_from_jax(codes, scale, zero, group_size: int,
                          device="cuda") -> QuantizedKV:
    """The port's :class:`QuantizedKV` for the numpy arrays of a JAX
    ``QuantizedKV`` (uint8 codes, f16 scale and zero planes)."""
    dev = resolve_device(device)
    return QuantizedKV(codes=_tensor(codes, dev), scale=_tensor(scale, dev),
                       zero=_tensor(zero, dev), group_size=int(group_size))


__all__ = ["params_from_numpy", "qtensor_from_numpy",
           "quantized_kv_from_jax"]
