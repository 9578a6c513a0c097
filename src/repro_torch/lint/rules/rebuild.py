"""rebuild-hazard: work that should happen once per process, redone per
call or per iteration (the port of ``repro/lint/rules/recompile.py``;
eager PyTorch compiles nothing per shape, so the JAX rule's cache misses
become rebuilds and fresh allocations).

Three hazards:

* a ``torch.compile`` / ``torch.jit.script`` / ``trace``, a
  ``torch.cuda.CUDAGraph()``, a ``ctypes.CDLL`` or a
  ``torch.utils.cpp_extension.load*`` constructed lexically inside a
  ``for``/``while`` body builds a fresh compiled program, graph or
  library every iteration — hoist it;
* the same constructions on a hot path (the host-sync rule's hot set)
  rebuild per step — build once and keep the handle. A construction
  under an ``if <global or self.attr> is None:`` guard, or in a
  ``functools.cache``/``lru_cache`` function, runs once per process
  (``kernels/_build.library()`` loads the kernels so) and is fine;
* device tensor shapes derived from raw ``len(...)`` on hot paths: every
  distinct request length is a fresh allocation shape, which fragments
  the caching allocator and is what a CUDA graph of the decode step
  cannot capture. Lengths go through the scheduler's bucket table first.
"""
from __future__ import annotations

import ast

from ..astutil import call_kwarg, once_guarded
from ..core import ModuleContext, register

_BUILDERS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
             "torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
             "ctypes.CDLL", "ctypes.cdll.LoadLibrary",
             "torch.utils.cpp_extension.load",
             "torch.utils.cpp_extension.load_inline")
_SHAPE_CTORS = tuple(f"torch.{n}" for n in (
    "zeros", "ones", "full", "empty", "arange", "rand", "randn", "randint"))
_BUCKET_HINTS = ("bucket", "pad", "round", "align", "tile", "chunk")
@register("rebuild-hazard", severity="error", help=(
    "torch.compile/jit, CUDAGraph, ctypes.CDLL or cpp_extension.load built "
    "inside a loop or on a hot path, or device shapes keyed on unbucketed "
    "lengths — each one rebuilds or reallocates per call."))
def check_rebuild(ctx: ModuleContext) -> None:
    mod = ctx.module
    hot = ctx.hot

    # --- builders inside a loop body or on a hot path --------------------
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = mod.dotted(node.func)
        if name not in _BUILDERS:
            continue
        # lexically inside a loop body *within the same function*: the
        # first loop ancestor appears before any enclosing def.
        in_loop = False
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.For, ast.While, ast.AsyncFor)):
                in_loop = True
                break
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break
        fn = mod.enclosing_function(node)
        if in_loop:
            ctx.report(node, (
                f"{name} constructed inside a loop builds a new program, "
                "graph or library every iteration — hoist it out of the "
                "loop"))
        elif fn is not None and fn.qualname in hot and \
                not once_guarded(mod, node, fn):
            ctx.report(node, (
                f"{name} constructed on a hot path rebuilds per step — "
                "build it once and keep the handle"))

    # --- shapes from unbucketed lengths ----------------------------------
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = mod.dotted(node.func)
        if name not in _SHAPE_CTORS:
            continue
        fn = mod.enclosing_function(node)
        if fn is None or not (fn.compiled or fn.qualname in hot):
            continue
        device = call_kwarg(node, "device")
        if device is None or (isinstance(device, ast.Constant)
                               and device.value == "cpu"):
            continue
        shape_arg = node.args[0] if node.args else call_kwarg(node, "size")
        if shape_arg is None:
            continue
        for leaf in ast.walk(shape_arg):
            if isinstance(leaf, ast.Call) and \
                    isinstance(leaf.func, ast.Name) and leaf.func.id == "len":
                # bucketed helpers in the expression launder the length
                src = ast.dump(shape_arg).lower()
                if any(h in src for h in _BUCKET_HINTS):
                    continue
                ctx.report(node, (
                    f"{name.rsplit('.', 1)[-1]} shape derived from raw "
                    "len(...) on a hot path — every distinct length is a "
                    "fresh allocation shape; round through the bucket "
                    "table"), severity="warning")
                break
