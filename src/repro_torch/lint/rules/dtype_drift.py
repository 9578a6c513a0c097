"""dtype-drift: float64 on the card, and torch's real bf16 → f32
promotions in low-precision paths (the port of
``repro/lint/rules/dtype_drift.py``).

torch's promotion is not JAX's. A Python scalar or a numpy scalar keeps
the tensor's dtype (``bf16 * 2.0`` and ``bf16 * np.float32(2)`` stay
bf16), and so does a 0-dim tensor of the same category (``bf16 *
torch.tensor(2.0)`` stays bf16). What promotes is a bf16/f16 tensor
meeting a float32 tensor of one or more dims: ``bf16 * torch.ones(n)`` is
f32, and doubles the bytes of exactly the layers the quantized serving
path exists to shrink. ``torch.float64`` anywhere (``.double()``,
``dtype=torch.float64``) doubles every buffer and its traffic, and the
card's f64 vector rate is half its f32 rate.

The promotion check runs only in the configured dtype-sensitive files
(layers, Mamba-2, the KV cache, the kernels' wrappers), where bf16 flows;
it infers dtypes one assignment deep within a function.
"""
from __future__ import annotations

import ast
from fnmatch import fnmatch
from typing import Dict, Optional

from ..astutil import call_kwarg
from ..core import ModuleContext, register

_F64 = ("torch.float64", "torch.double")
_LOW = ("torch.bfloat16", "torch.float16", "torch.half")
_F32 = ("torch.float32", "torch.float")
# factories whose default dtype is float32 (``arange``'s is not)
_F32_FACTORIES = tuple(f"torch.{n}" for n in (
    "zeros", "ones", "empty", "rand", "randn", "full"))
_ARITH = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
          ast.Pow)


def _dtype_of(mod, expr: ast.AST, env: Dict[str, str]) -> Optional[str]:
    """'low' for a bf16/f16 tensor, 'f32' for a float32 tensor of one or
    more dims, else None (unknown, a scalar, or a 0-dim tensor)."""
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if not isinstance(expr, ast.Call):
        return None
    name = mod.dotted(expr.func)
    if isinstance(expr.func, ast.Attribute):
        attr = expr.func.attr
        if attr in ("bfloat16", "half"):
            return "low"
        if attr == "float":
            return "f32" if _dtype_of(mod, expr.func.value, env) else None
        if attr == "to":
            target = call_kwarg(expr, "dtype") or (
                expr.args[0] if expr.args else None)
            tname = mod.dotted(target) if target is not None else None
            if tname in _LOW:
                return "low"
            if tname in _F32:
                return "f32" if _dtype_of(mod, expr.func.value, env) \
                    else None
    if name is not None and name.startswith("torch."):
        dt = call_kwarg(expr, "dtype")
        dname = mod.dotted(dt) if dt is not None else None
        if dname in _LOW:
            return "low"
        shape = expr.args[0] if expr.args else call_kwarg(expr, "size")
        scalar = isinstance(shape, (ast.Tuple, ast.List)) and \
            not shape.elts
        if name in _F32_FACTORIES and not scalar and shape is not None and \
                (dname is None or dname in _F32):
            return "f32"
    return None


@register("dtype-drift", severity="error", help=(
    "torch.float64 anywhere doubles every buffer on the card; in "
    "bf16-sensitive files, a bf16/f16 tensor meeting an f32 tensor of one "
    "or more dims promotes the whole expression to f32."))
def check_dtype_drift(ctx: ModuleContext) -> None:
    mod = ctx.module
    sensitive = any(
        fnmatch(mod.relpath, g) for g in ctx.config.dtype_sensitive)

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute) and mod.dotted(node) in _F64:
            ctx.report(node, (
                "torch.float64 doubles every buffer and its traffic on the "
                "card, at half the f32 vector rate — keep f32 (or say why "
                "in an allow comment)"))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "double" and not node.args:
            ctx.report(node, (
                ".double() makes a float64 copy: twice the bytes on the "
                "card, at half the f32 vector rate"))

    if not sensitive:
        return
    for fn in mod.functions:
        env: Dict[str, str] = {}
        for node in ast.walk(fn.node):
            if mod.enclosing_function(node) is not fn:
                continue
            if isinstance(node, ast.Assign):
                dt = _dtype_of(mod, node.value, env)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        if dt is None:
                            env.pop(tgt.id, None)
                        else:
                            env[tgt.id] = dt
        for node in ast.walk(fn.node):
            if mod.enclosing_function(node) is not fn:
                continue
            if isinstance(node, ast.BinOp) and isinstance(node.op, _ARITH):
                kinds = {_dtype_of(mod, node.left, env),
                         _dtype_of(mod, node.right, env)}
                if kinds == {"low", "f32"}:
                    ctx.report(node, (
                        "a bf16/f16 tensor meets a float32 tensor of one "
                        "or more dims: torch promotes the result to f32 — "
                        "cast the f32 operand down, or make it a Python "
                        "scalar or a 0-dim tensor"))
