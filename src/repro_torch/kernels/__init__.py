"""Hand-written CUDA kernels K1–K6 and K4x (``csrc/``), their wrappers
(:mod:`~repro_torch.kernels.ops`) and plain versions
(:mod:`~repro_torch.kernels.ref`).

The port's call sites (the PGD step and projections of ``core.awp``, the
packed matmuls of ``quant.QTensor`` (K4, and K4x over a stack of experts),
the INT8 cache expansion and the decode
attention of ``serving.kv_cache``) reach a kernel through :func:`impl`,
and one switch decides which function that is:

- ``"auto"`` (the default) and ``"kernel"``: the wrapper, which launches
  the kernel on a CUDA tensor and takes the plain version on a CPU tensor.
  For ``QTensor``, ``"auto"`` on a CPU tensor means its dequantize-then-
  multiply reference (see :func:`resolved_impl`).
- ``"reference"``: the plain version on any device.

It is the port's counterpart of the JAX package's ``use_pallas=False`` and
QTensor matmul switch (``quant.matmul_impl`` is :func:`use_impl`), and lets
one run hold the kernels' path against the plain one on the same card.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops, ref   # ops switches TF32 off

IMPLS = ("auto", "kernel", "reference")
_IMPL = "auto"


def set_impl(mode: str) -> str:
    """Set the kernel-vs-plain switch; returns the previous mode."""
    global _IMPL
    if mode not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {mode!r}")
    prev, _IMPL = _IMPL, mode
    return prev


@contextlib.contextmanager
def use_impl(mode: str):
    """Context manager scoping :func:`set_impl`."""
    prev = set_impl(mode)
    try:
        yield
    finally:
        set_impl(prev)


def resolved_impl(device: torch.device) -> str:
    """"kernel" or "reference" for a tensor on ``device``."""
    if _IMPL != "auto":
        return _IMPL
    return "kernel" if device.type == "cuda" else "reference"


def impl(name: str):
    """The function the call sites use for kernel ``name``."""
    return getattr(ref if _IMPL == "reference" else ops, name)


__all__ = ["IMPLS", "impl", "resolved_impl", "set_impl", "use_impl"]
