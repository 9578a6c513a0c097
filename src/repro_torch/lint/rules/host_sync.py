"""host-sync: waits of the host on the card on hot paths (the port of
``repro/lint/rules/host_sync.py``).

The serving contract is ONE device→host read per decode step (the packed
(S, 2) int32 token block), one per batched prefill, one scalar per
chunked prompt and one transfer per preemption; anything else —
``.item()``, ``.tolist()``, ``.cpu()``, ``int()`` on a device tensor, an
``if`` on a tensor, ``torch.cuda.synchronize()`` — stalls the host until
every queued kernel has run, and the card then idles while the host
queues the next step. Outputs whose shape depends on the data
(``nonzero``, ``masked_select``, ``unique``, boolean-mask indexing) wait
the same way: the host must read the count to allocate the result. A copy
up from pageable host memory (``torch.tensor(..., device=...)``, or
``torch.from_numpy(a).to(dev)`` without ``pin_memory()``) waits too: the
driver stages it synchronously. Inside a ``torch.compile``'d body the same
calls break the graph.

Scope: functions that are (a) compiled, (b) on a hot path —
:attr:`ModuleContext.hot`: the configured roots (``Engine.step``,
``Engine._decode``) and ``# lint: hotpath`` defs, closed over the call
graph within each module and across the package's own imports — or
(c) carry a ``# lint: hotpath`` marker.

Dataflow: a name is *device-tainted* when assigned from a ``torch.*``
call (a factory only with a device other than the CPU), from a method of
a tainted tensor, from a configured device producer (``self._decode()``),
or from arithmetic over tainted names; ``.cpu()``, ``.numpy()``,
``.tolist()``, ``.item()`` and ``np.asarray`` launder the result back to
the host. ``x.shape``, ``x.size()``, ``x.numel()`` and ``len(x)`` never
taint — the host holds them.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..astutil import call_kwarg, is_shapelike
from ..core import ModuleContext, register

_ALWAYS_SYNC_ATTRS = ("item", "tolist", "cpu")
_DYNAMIC_SHAPE = ("nonzero", "masked_select", "unique", "unique_consecutive",
                  "argwhere")
_LAUNDER_ATTRS = ("item", "tolist", "cpu", "numpy", "pin_memory")
_LAUNDER_CALLS = ("numpy.asarray", "numpy.array")
_CAST_BUILTINS = ("float", "int", "bool")
_SCALAR_TYPES = ("bool", "int", "float", "str")
_HOST_PREFIXES = ("numpy.", "math.")
# torch calls that build a tensor where their device argument says (the
# CPU when it is absent)
_FACTORIES = tuple(f"torch.{n}" for n in (
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
    "arange", "rand", "randn", "randint", "linspace", "eye", "frombuffer"))
_HOST_CTORS = ("torch.tensor", "torch.as_tensor", "torch.from_numpy",
               "torch.frombuffer")
# torch calls that return no tensor
_NOT_TENSOR = tuple(f"torch.{n}" for n in (
    "device", "finfo", "iinfo", "is_tensor", "Size", "get_default_dtype",
    "is_grad_enabled", "no_grad", "inference_mode", "enable_grad",
    "manual_seed", "Generator", "is_floating_point", "dtype",
    "promote_types", "result_type", "can_cast"))
# torch namespaces whose calls return streams, events, handles, process
# groups or metadata, not tensors on the card
_NOT_TENSOR_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                        "torch.utils.", "torch.profiler.")
_BOOL_CALLS = tuple(f"torch.{n}" for n in (
    "isfinite", "isnan", "isinf", "logical_and", "logical_or", "logical_not",
    "logical_xor", "eq", "ne", "lt", "le", "gt", "ge", "isin"))


def _cpu_literal(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr == "device":
        return _cpu_literal(node.args[0])
    return False


def _device_arg(mod, node: ast.AST) -> bool:
    """A ``.to(...)`` argument that names a device, not a dtype: a string
    literal, ``torch.device(...)``, or a name that says ``dev``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.Call):
        return mod.dotted(node.func) == "torch.device"
    name = mod.dotted(node)
    if name is None or name.startswith("torch."):
        return False
    return "dev" in name.rsplit(".", 1)[-1].lower()


def _to_target(mod, call: ast.Call) -> Optional[ast.AST]:
    """The device a ``.to(...)`` call moves to, else None."""
    dev = call_kwarg(call, "device")
    if dev is not None:
        return dev
    if call.args and _device_arg(mod, call.args[0]):
        return call.args[0]
    return None


class _Flow:
    """One forward pass over a function body, its bindings in source
    order: the names that hold device tensors, host values and boolean
    device masks. :meth:`seek` sets the sets to what they hold where a
    node starts, so ``x = x.cpu()`` reads a device ``x``."""

    def __init__(self, mod, fn_node: ast.AST, producers: Set[str],
                 params_tainted: bool):
        self.mod = mod
        self.producers = producers
        self.tainted: Set[str] = set()
        self.host: Set[str] = set()
        self.masks: Set[str] = set()
        # names bound to a pinned host tensor (``x.pin_memory()``)
        self.pinned: Set[str] = set()
        if params_tainted:
            self.tainted |= _tensor_params(fn_node) - {"self"}
        self._start = self._state()
        self._marks: List[Tuple[Tuple[int, int], tuple]] = []
        binds = sorted((s for s in ast.walk(fn_node)
                        if isinstance(s, (ast.Assign, ast.AugAssign))),
                       key=lambda s: (s.lineno, s.col_offset))
        for stmt in binds:
            if isinstance(stmt, ast.Assign):
                names = [n for t in stmt.targets for n in _names(t)]
                dev = self.device(stmt.value)
                host = self.host_value(stmt.value)
                mask = dev and self.is_mask(stmt.value)
                pinned = _in_chain(stmt.value, "pin_memory")
                for nm in names:
                    for group, on in ((self.tainted, dev), (self.host, host),
                                      (self.masks, mask),
                                      (self.pinned, pinned)):
                        (group.add if on else group.discard)(nm)
            elif isinstance(stmt.target, ast.Name) and \
                    self.device(stmt.value):
                self.tainted.add(stmt.target.id)
            self._marks.append(((stmt.end_lineno, stmt.end_col_offset),
                                self._state()))

    def _state(self) -> tuple:
        return tuple(set(g) for g in (self.tainted, self.host, self.masks,
                                      self.pinned))

    def seek(self, node: ast.AST) -> None:
        """The name sets as the bindings that end before ``node`` left
        them."""
        pos = (node.lineno, node.col_offset)
        state = self._start
        for end, snap in self._marks:
            if end > pos:
                break
            state = snap
        self.tainted, self.host, self.masks, self.pinned = (
            set(g) for g in state)

    def device(self, node: ast.AST) -> bool:
        """True when ``node`` evaluates to a tensor on the card."""
        mod = self.mod
        if is_shapelike(node):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            name = mod.dotted(node)
            if name is not None and name in self.producers:
                return True
            return self.device(node.value)
        if isinstance(node, ast.Subscript):
            return self.device(node.value)
        if isinstance(node, ast.Call):
            name = mod.dotted(node.func)
            if name is not None and name in self.producers:
                return True
            if name in _LAUNDER_CALLS or name in _NOT_TENSOR or (
                    name or "").startswith(_NOT_TENSOR_PREFIXES):
                return False
            if name in _FACTORIES:
                dev = call_kwarg(node, "device")
                return dev is not None and not _cpu_literal(dev)
            if name is not None and name.startswith("torch."):
                return True
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _LAUNDER_ATTRS:
                    return False
                if attr == "cuda":
                    return True
                if attr == "to":
                    dest = _to_target(mod, node)
                    if dest is not None:
                        return not _cpu_literal(dest)
                if self.device(node.func.value):
                    return True
            return any(self.device(a) for a in node.args)
        if isinstance(node, ast.BinOp):
            return self.device(node.left) or self.device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.device(node.operand)
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False            # identity: the host answers it
        if isinstance(node, (ast.Compare, ast.BoolOp)):
            kids = ([node.left] + node.comparators
                    if isinstance(node, ast.Compare) else node.values)
            return any(self.device(k) for k in kids)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.device(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.device(node.body) or self.device(node.orelse)
        return False

    def host_value(self, node: ast.AST) -> bool:
        """True when ``node`` is known to live on the host: numpy, a
        laundered read, or a tensor built without a device."""
        mod = self.mod
        if isinstance(node, ast.Name):
            return node.id in self.host
        if isinstance(node, ast.Subscript):
            return self.host_value(node.value)
        if isinstance(node, ast.Attribute):
            return node.attr in ("T", "mT") and self.host_value(node.value)
        if isinstance(node, ast.Call):
            name = mod.dotted(node.func)
            if name is not None and name.startswith(_HOST_PREFIXES):
                return True
            if name in _HOST_CTORS:
                dev = call_kwarg(node, "device")
                return dev is None or _cpu_literal(dev)
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _LAUNDER_ATTRS:
                    return True
                if attr == "to" and _to_target(mod, node) is not None:
                    return _cpu_literal(_to_target(mod, node))
                return self.host_value(node.func.value) and attr not in (
                    "cuda",)
        return False

    def is_mask(self, node: ast.AST) -> bool:
        """True for a boolean device tensor: a comparison, a predicate
        (``torch.isfinite``), a logical op over masks."""
        mod = self.mod
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.device(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Call):
            name = mod.dotted(node.func)
            if name in _BOOL_CALLS:
                return self.device(node)
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "bool":
                return self.device(node.func.value)
        return False


def _tensor_params(fn_node: ast.AST) -> Set[str]:
    """The parameters a compiled body may receive tensors in: all but
    those annotated ``bool``/``int``/``float``/``str`` or defaulting to
    such a constant — Python values ``torch.compile`` guards on, as JAX's
    ``static_argnames`` are (branching on them is fine)."""
    args = fn_node.args
    pos = list(args.posonlyargs) + list(args.args)
    defaults = dict(zip([a.arg for a in pos][len(pos) - len(args.defaults):],
                        args.defaults))
    defaults.update({a.arg: d for a, d in zip(args.kwonlyargs,
                                              args.kw_defaults) if d})
    out: Set[str] = set()
    for a in pos + list(args.kwonlyargs):
        ann = a.annotation
        default = defaults.get(a.arg)
        if isinstance(ann, ast.Name) and ann.id in _SCALAR_TYPES:
            continue
        if isinstance(default, ast.Constant) and default.value is not None:
            continue
        out.add(a.arg)
    return out


def _names(tgt: ast.AST):
    """Plain Name binding targets only — ``self.kv`` in a tuple target
    must not taint the ``self`` base name."""
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for e in tgt.elts:
            yield from _names(e)
    elif isinstance(tgt, ast.Starred):
        yield from _names(tgt.value)


def _host_base(mod, flow: _Flow, base: ast.AST) -> bool:
    name = mod.dotted(base)
    if name is not None and f"{name}.".startswith(_HOST_PREFIXES):
        return True
    return flow.host_value(base)


def _in_chain(node: ast.AST, attr: str) -> bool:
    """True when a ``.<attr>()`` call appears in ``node``'s method chain."""
    while isinstance(node, (ast.Call, ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == attr:
                return True
            node = node.func
        else:
            node = node.value
    return False


def _upload(mod, flow: _Flow, call: ast.Call) -> Optional[str]:
    """The message for a copy up from host memory that makes the host
    wait, else None."""
    name = mod.dotted(call.func)
    if name in ("torch.tensor", "torch.as_tensor"):
        dev = call_kwarg(call, "device")
        if dev is not None and not _cpu_literal(dev):
            return (f"{name}(..., device=...) copies from pageable host "
                    "memory: the host waits for the copy — stage it "
                    "through pin_memory() and .to(dev, non_blocking=True)")
        return None
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr == "to":
        dest = _to_target(mod, call)
        if dest is None or _cpu_literal(dest):
            return None
    elif attr != "cuda":
        return None
    base = call.func.value
    if not flow.host_value(base) or _cpu_base_read(base):
        return None
    if not _in_chain(base, "pin_memory") and not (
            isinstance(base, ast.Name) and base.id in flow.pinned):
        return (f".{attr}() moves a tensor from pageable host memory to "
                "the card: the driver stages the copy and the host waits — "
                "pin_memory() it and copy with non_blocking=True")
    nb = call_kwarg(call, "non_blocking")
    if not (isinstance(nb, ast.Constant) and nb.value is True):
        return (f".{attr}() of a pinned tensor without non_blocking=True "
                "is a blocking copy: the host waits for the card")
    return None


def _cpu_base_read(base: ast.AST) -> bool:
    """``x.cpu().to(...)`` — the read is the finding, not the move."""
    return _in_chain(base, "cpu") or _in_chain(base, "numpy")


@register("host-sync", severity="error", help=(
    "Host wait on the card (.item(), .tolist(), .cpu(), int()/float()/"
    "bool() or if on a device tensor, synchronize(), data-dependent "
    "shapes, pageable uploads) on a serving hot path or in a compiled "
    "body. The decode loop's contract is one packed read per step."))
def check_host_sync(ctx: ModuleContext) -> None:
    mod = ctx.module
    cfg = ctx.config
    producers = set(cfg.device_producers)
    hot = ctx.hot

    for fn in mod.functions:
        in_compiled = fn.compiled
        in_hot = fn.qualname in hot
        if not (in_compiled or in_hot):
            continue
        where = "compiled body" if in_compiled else "hot path"
        flow = _Flow(mod, fn.node, producers, in_compiled)

        for node in ast.walk(fn.node):
            if mod.enclosing_function(node) is not fn:
                continue
            if isinstance(node, (ast.Call, ast.If, ast.While, ast.Subscript)):
                flow.seek(node)
            if isinstance(node, ast.Call):
                _check_call(ctx, flow, node, where)
            elif isinstance(node, (ast.If, ast.While)):
                if flow.device(node.test):
                    ctx.report(node.test, (
                        "branching on a device tensor implicitly calls "
                        f"bool() — the host waits for the card ({where})"))
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    flow.device(node.value) and flow.is_mask(node.slice):
                ctx.report(node, (
                    "boolean-mask indexing sizes its output from the "
                    "data — the host waits for the count; use "
                    f"torch.where or a fixed-size gather ({where})"))


def _check_call(ctx: ModuleContext, flow: _Flow, node: ast.Call,
                where: str) -> None:
    mod = ctx.module
    name = mod.dotted(node.func)
    func = node.func
    if isinstance(func, ast.Attribute):
        attr = func.attr
        base = func.value
        if attr in _ALWAYS_SYNC_ATTRS or (
                attr == "to" and _cpu_literal(_to_target(mod, node))):
            if not _host_base(mod, flow, base):
                what = f".{attr}()" if attr != "to" else ".to('cpu')"
                ctx.report(node, (
                    f"{what} forces a device→host sync in a {where}"))
            return
        if attr == "numpy" and flow.device(base):
            ctx.report(node, (
                f".numpy() of a device tensor forces a device→host read "
                f"in a {where}"))
            return
        if attr == "synchronize":
            ctx.report(node, (
                f"{name or '.synchronize'}() blocks the host until the "
                f"card drains ({where})"))
            return
        if attr in _DYNAMIC_SHAPE and not (
                name is not None and name.startswith("torch.")) and \
                not _host_base(mod, flow, base):
            ctx.report(node, (
                f".{attr}() sizes its output from the data — the host "
                f"waits for the count ({where})"))
            return
    if name is not None and name.startswith("torch."):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _DYNAMIC_SHAPE or (leaf == "where" and
                                       len(node.args) == 1):
            ctx.report(node, (
                f"torch.{leaf}() sizes its output from the data — the host "
                f"waits for the count ({where})"))
            return
    msg = _upload(mod, flow, node)
    if msg is not None:
        ctx.report(node, f"{msg} ({where})")
        return
    if name in _LAUNDER_CALLS and node.args and flow.device(node.args[0]):
        ctx.report(node, (
            f"np.{name.rsplit('.', 1)[-1]} of a device tensor forces a "
            f"device→host read ({where})"))
        return
    if isinstance(func, ast.Name) and func.id in _CAST_BUILTINS and \
            node.args and flow.device(node.args[0]):
        ctx.report(node, (
            f"{func.id}() on a device tensor forces a device→host sync in "
            f"a {where}"))
