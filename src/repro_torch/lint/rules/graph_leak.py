"""graph-leak: side effects in bodies autograd runs twice or keeps (the
port of ``repro/lint/rules/tracer_leak.py``).

A function handed to ``torch.utils.checkpoint`` runs once in forward and
again in backward: a store to ``self.*``, a ``global`` or a ``nonlocal``,
or an append to a closed-over container happens twice, and the second
time with the recomputed tensors. Inside a ``torch.autograd.Function``'s
``forward``/``backward`` the same stores keep graph tensors alive past the
step, and ``ctx.<attr> = <tensor>`` keeps a tensor outside autograd's
saved-tensor checks (in-place modification, version counters) — that is
what ``ctx.save_for_backward`` is for. Writes into tensors that were
passed in (``out[...] = y``, ``dst.copy_(src)``) are the out-parameter
idiom and are fine, as the reference's ``o_ref[...] =`` is.

Scope: the ``checkpoint`` targets and every def they reach
(:attr:`ModuleContext.replayed`: within a module, across the package's
imports, and ``self.m()`` to the def each subclass of the receiver puts
there — the model's ``_block_out`` runs the MoE's, Mamba's and Zamba2's
``_block``), and the ``forward``/``backward`` of ``autograd.Function``
subclasses. A store under an ``if <global> is None:`` guard fills a cache
once per process and is fine.
"""
from __future__ import annotations

import ast
from typing import Set

from ..astutil import is_shapelike, once_guarded
from ..core import ModuleContext, register

_CONTAINER_METHODS = ("append", "extend", "add", "setdefault", "update")


def _tensor_params(mod, fn_node: ast.AST) -> Set[str]:
    """Parameters ``forward`` uses as tensors: a ``torch.*`` argument or
    the base of a method call that is not shape metadata."""
    args = fn_node.args
    params = {a.arg for a in list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)} - {"ctx", "self"}
    used: Set[str] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        name = mod.dotted(node.func)
        if name is not None and name.startswith("torch."):
            used |= {a.id for a in node.args if isinstance(a, ast.Name)}
        if isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                not is_shapelike(node):
            used.add(node.func.value.id)
    return params & used


def _is_tensor(mod, expr: ast.AST, tensors: Set[str]) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in tensors
    if is_shapelike(expr):
        return False
    if isinstance(expr, ast.Call):
        name = mod.dotted(expr.func)
        if name is not None and name.startswith("torch."):
            return True
        if isinstance(expr.func, ast.Attribute):
            return _is_tensor(mod, expr.func.value, tensors)
    if isinstance(expr, ast.BinOp):
        return _is_tensor(mod, expr.left, tensors) or \
            _is_tensor(mod, expr.right, tensors)
    if isinstance(expr, ast.Subscript):
        return _is_tensor(mod, expr.value, tensors)
    return False


@register("graph-leak", severity="error", help=(
    "Stores to self.*/globals/closures inside a checkpointed or "
    "autograd.Function body run twice (or keep graph tensors alive); "
    "ctx.<attr> = tensor bypasses save_for_backward. Return the value."))
def check_graph_leak(ctx: ModuleContext) -> None:
    mod = ctx.module
    for fn in mod.functions:
        recomputed = fn.qualname in ctx.replayed
        if not (recomputed or fn.autograd):
            continue
        where = ("checkpointed body (backward runs it again)"
                 if recomputed else "autograd.Function body")
        declared_global = set()
        declared_nonlocal = set()
        for node in ast.walk(fn.node):
            if mod.enclosing_function(node) is not fn:
                continue
            if isinstance(node, ast.Global):
                declared_global.update(node.names)
            elif isinstance(node, ast.Nonlocal):
                declared_nonlocal.update(node.names)
        tensors: Set[str] = set()
        if fn.autograd and fn.name == "forward":
            tensors = _tensor_params(mod, fn.node)
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Assign) and \
                        _is_tensor(mod, node.value, tensors):
                    tensors |= {t.id for t in node.targets
                                if isinstance(t, ast.Name)}
        local = {n.id for n in ast.walk(fn.node)
                 if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
                 and mod.enclosing_function(n) is fn} - declared_global \
            - declared_nonlocal
        for node in ast.walk(fn.node):
            if mod.enclosing_function(node) is not fn:
                continue
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if isinstance(tgt, ast.Attribute):
                        base = tgt.value
                        if isinstance(base, ast.Name) and base.id == "self":
                            ctx.report(node, (
                                f"assignment to self.{tgt.attr} inside a "
                                f"{where} stores graph state on the object "
                                "— return the value instead"))
                        elif isinstance(base, ast.Name) and \
                                base.id == "ctx" and fn.autograd and \
                                _is_tensor(mod, node.value, tensors):
                            ctx.report(node, (
                                f"ctx.{tgt.attr} = <tensor> keeps a tensor "
                                "outside autograd's saved-tensor checks — "
                                "use ctx.save_for_backward"))
                    elif isinstance(tgt, ast.Name):
                        if tgt.id in declared_global:
                            # under ``if <global> is None:``: a cache fill
                            if not once_guarded(mod, node, fn, attrs=False):
                                ctx.report(node, (
                                    f"assignment to global {tgt.id!r} "
                                    f"inside a {where}"))
                        elif tgt.id in declared_nonlocal:
                            ctx.report(node, (
                                f"assignment to nonlocal {tgt.id!r} inside "
                                f"a {where} leaks into the enclosing scope"))
            elif isinstance(node, ast.Call):
                # closure.append(x) smuggles graph tensors into host-side
                # containers, twice under recompute; warn (it may be a
                # static value).
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _CONTAINER_METHODS:
                    base = node.func.value
                    # only when the container is not local to this fn
                    if isinstance(base, ast.Name) and base.id not in local:
                            ctx.report(node, (
                                f"{base.id}.{node.func.attr}(...) inside a "
                                f"{where} may smuggle a graph tensor into a "
                                "host container"), severity="warning")
