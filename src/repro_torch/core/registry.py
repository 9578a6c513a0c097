"""Method registry: pluggable compression methods with a uniform signature.

A *method* is any callable

    compress(w_paper, stats, spec) -> CompressResult

where ``w_paper`` is the weight in paper orientation (d_out, d_in),
``stats`` the layer's :class:`repro_torch.core.calibration.CalibStats`, and
``spec`` a :class:`repro_torch.core.specs.CompressSpec`. ``compress_model``
dispatches to it through any policy naming it. The port registers
``awp_prune``, ``awp_prune_nm``, ``awp_quant``, ``awp_joint``, ``wanda`` and
``magnitude``; each also has a batched form (:func:`register_batched`) that
the batched engine (``core/batched.py``) runs over a whole shape bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.specs import CompressSpec, JointSpec


@dataclasses.dataclass
class CompressResult:
    """What one method produced for one layer.

    ``theta`` is the dense compressed weight (paper orientation). The
    artifacts ride along: ``mask`` (pruning), ``qtensor`` (a packed
    :class:`repro_torch.quant.QTensor` whose ``dequant()`` equals
    ``theta``), ``loss`` (filled by the driver), ``iters`` (PGD iterations
    run) and ``aux`` (method-specific extras).
    """
    theta: Any
    mask: Optional[Any] = None
    qtensor: Optional[Any] = None
    loss: Optional[float] = None
    iters: Optional[int] = None
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)


Method = Callable[[Any, Any, CompressSpec], CompressResult]


@dataclasses.dataclass(frozen=True)
class _Entry:
    fn: Method
    spec_cls: type


_REGISTRY: Dict[str, _Entry] = {}
_BATCHED: Dict[str, Callable] = {}
_BUILTINS_LOADED = False


def register(name: str, *, spec_cls: type = JointSpec) -> Callable[[Method], Method]:
    """Decorator: register ``fn`` as compression method ``name``."""
    def deco(fn: Method) -> Method:
        _REGISTRY[name] = _Entry(fn=fn, spec_cls=spec_cls)
        return fn
    return deco


def register_batched(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a *batched* implementation of method ``name``,

        batched(w_b, c_b, stats_b, spec) -> List[CompressResult]   # len B

    over a bucket of B same-shape linears sharing one spec: ``w_b`` is
    (B, d_out, d_in), ``c_b`` the (B, d_in, d_in) damped covariances (built
    once by the engine and reused for the loss), ``stats_b`` the stacked
    :class:`CalibStats`. A method without one still runs in the batched
    engine, per layer."""
    def deco(fn: Callable) -> Callable:
        _BATCHED[name] = fn
        return fn
    return deco


def _load_builtins() -> None:
    """Import the modules that register the built-in methods (once)."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    import repro_torch.core.awp        # noqa: F401  (awp_*)
    import repro_torch.core.baselines  # noqa: F401  (wanda, magnitude)
    import repro_torch.core.batched    # noqa: F401  (the batched forms)
    _BUILTINS_LOADED = True            # only after every import succeeded


def _lookup(name: str) -> _Entry:
    if name not in _REGISTRY:
        _load_builtins()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown compression method {name!r}; registered methods: "
            f"{', '.join(available())}")
    return _REGISTRY[name]


def get_method(name: str) -> Method:
    return _lookup(name).fn


def get_batched(name: str) -> Optional[Callable]:
    """Batched implementation of ``name``, or None (the engine then runs
    the method per layer)."""
    _lookup(name)                      # unknown names raise
    _load_builtins()
    return _BATCHED.get(name)


def spec_cls_for(name: str) -> type:
    return _lookup(name).spec_cls


def validate_spec(spec: CompressSpec) -> None:
    """Fail fast on method/spec mismatches (duck-typed: any spec carrying
    the registered spec class's fields is accepted)."""
    cls = _lookup(spec.method).spec_cls
    missing = [f.name for f in dataclasses.fields(cls)
               if not hasattr(spec, f.name)]
    if missing:
        raise TypeError(
            f"method {spec.method!r} expects a {cls.__name__} "
            f"(got {type(spec).__name__}, missing fields: "
            f"{', '.join(missing)})")


def available() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_REGISTRY))


__all__ = ["CompressResult", "Method", "register", "register_batched",
           "get_method", "get_batched", "spec_cls_for", "validate_spec",
           "available"]
