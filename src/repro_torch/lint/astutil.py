"""Shared AST machinery for the ``repro_torch.lint`` analyzer.

Everything rule modules need to reason about a source file without
re-walking it from scratch:

* a parsed module with parent links and per-function qualified names;
* an import table canonicalizing aliases (``np`` → ``numpy``, ``F`` →
  ``torch.nn.functional``) so rules match on canonical dotted names;
* detection of functions whose body autograd runs again or compiles:
  defs handed to ``torch.utils.checkpoint.checkpoint`` (a name or a
  ``self.method``; backward recomputes them), the ``forward``/``backward``
  of ``torch.autograd.Function`` subclasses, and defs wrapped by
  ``torch.compile``/``torch.jit.script``/``trace``;
* an intra-module call graph (``self.m()`` → ``Class.m``, bare ``f()`` →
  module function) plus reachability, as the reference's; and
  :func:`project_hot`, which follows calls across the package's own
  imports (``from repro_torch.device import to_host``, ``L.rmsnorm``,
  ``self.alloc.alloc()`` for an attribute assigned a package class, and
  the kernels' ``impl("name")`` dispatch, and ``v.m()`` under ``if
  isinstance(v, Cls):``) to expand the declared
  hot-path roots into the hot set of every module;
* ``# lint: ...`` control comments: ``allow[rule]`` suppressions and
  ``hotpath`` markers (see the README's "Static analysis" section).

All of it is plain ``ast`` — no third-party dependencies, by design.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ``# lint: allow[host-sync, dtype-drift] reason`` / ``# lint: hotpath``
_LINT_COMMENT = re.compile(
    r"#\s*lint:\s*(?P<verb>allow|hotpath)(?:\[(?P<rules>[^\]]*)\])?")

# Wrappers whose callee body is compiled: a host sync inside breaks the
# graph (torch.compile) or fails to script.
COMPILE_WRAPPERS = ("torch.compile", "torch.jit.script", "torch.jit.trace")
# Wrappers whose callee body backward runs a second time.
RECOMPUTE_WRAPPERS = ("torch.utils.checkpoint.checkpoint",)
AUTOGRAD_FUNCTION = "torch.autograd.Function"
AUTOGRAD_METHODS = ("forward", "backward", "setup_context")
_CACHE_DECORATORS = ("functools.cache", "functools.lru_cache")


@dataclasses.dataclass
class FunctionInfo:
    node: ast.AST                   # FunctionDef | AsyncFunctionDef
    name: str
    qualname: str                   # "Engine.step", "DenseModel._block_out"
    cls: Optional[str]              # enclosing class name, if a method
    compiled: bool = False          # wrapped by torch.compile / jit
    recomputed: bool = False        # body re-runs under checkpoint
    autograd: bool = False          # autograd.Function forward/backward
    hotpath_marker: bool = False    # ``# lint: hotpath`` on the def line
    calls: Set[str] = dataclasses.field(default_factory=set)
    # canonical dotted names of the other calls (``repro_torch.device.
    # to_host``, ``self.alloc.alloc``, ``@impl:decode_attn``), resolved
    # across modules by :func:`project_hot`
    ext_calls: Set[str] = dataclasses.field(default_factory=set)


class Module:
    """One parsed source file plus the derived tables rules consume."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        self.imports = _import_table(self.tree)
        # (class qualname, method) handed to checkpoint as ``self.method``
        # that the class does not define here: a base class's, resolved by
        # :func:`project_replayed`
        self.inherited_wrapped: List[Tuple[str, str]] = []
        self.allow: Dict[int, Set[str]] = {}     # line → suppressed rules
        self.hotpath_lines: Set[int] = set()
        self._scan_comments()
        self.functions: List[FunctionInfo] = []
        self._fn_of_node: Dict[ast.AST, FunctionInfo] = {}
        self._collect_functions()
        self._mark_wrapped()
        self._build_call_graph()

    # -- comments ----------------------------------------------------------
    def _scan_comments(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _LINT_COMMENT.search(line)
            if not m:
                continue
            if m.group("verb") == "hotpath":
                self.hotpath_lines.add(i)
                continue
            rules = m.group("rules")
            names = ({r.strip() for r in rules.split(",") if r.strip()}
                     if rules else {"*"})
            self.allow.setdefault(i, set()).update(names)

    def suppressed(self, line: int, rule: str) -> bool:
        """``# lint: allow[rule]`` on the finding line or the line above."""
        for ln in (line, line - 1):
            rules = self.allow.get(ln)
            if rules and ("*" in rules or rule in rules):
                return True
        return False

    # -- names -------------------------------------------------------------
    def dotted(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of an expression (``np.asarray`` →
        ``numpy.asarray``; ``self.foo`` stays ``self.foo``); None when the
        expression is not a plain name chain."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.imports.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[FunctionInfo]:
        for anc in self.ancestors(node):
            fn = self._fn_of_node.get(anc)
            if fn is not None:
                return fn
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for anc in self.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    # -- functions ---------------------------------------------------------
    def _collect_functions(self) -> None:
        def visit(node: ast.AST, stack: Tuple[str, ...], cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = ".".join(stack + (child.name,))
                    info = FunctionInfo(
                        node=child, name=child.name, qualname=qual, cls=cls,
                        hotpath_marker=any(
                            ln in self.hotpath_lines
                            for ln in range(child.lineno,
                                            child.body[0].lineno + 1)))
                    self.functions.append(info)
                    self._fn_of_node[child] = info
                    visit(child, stack + (child.name,), cls)
                elif isinstance(child, ast.ClassDef):
                    visit(child, stack + (child.name,), child.name)
                else:
                    visit(child, stack, cls)
        visit(self.tree, (), None)

    def by_name(self, name: str) -> List[FunctionInfo]:
        return [f for f in self.functions if f.name == name]

    def by_qualname(self, qualname: str) -> List[FunctionInfo]:
        return [f for f in self.functions if f.qualname == qualname]

    # -- compiled / recomputed detection -----------------------------------
    def wrapper_kind(self, call: ast.Call) -> Optional[str]:
        """'compile' | 'recompute' when ``call`` is a known wrapper
        (including ``functools.partial(torch.compile, ...)``)."""
        name = self.dotted(call.func)
        if name == "functools.partial" and call.args:
            name = self.dotted(call.args[0])
        if name is None:
            return None
        if name in COMPILE_WRAPPERS:
            return "compile"
        if name in RECOMPUTE_WRAPPERS:
            return "recompute"
        return None

    def _wrapped_targets(self, call: ast.Call) -> List[FunctionInfo]:
        """Functions a wrapper call receives: a bare name, or
        ``self.method`` of the enclosing class."""
        if not call.args:
            return []
        arg = call.args[0]
        if isinstance(arg, ast.Name):
            return self.by_name(arg.id)
        if isinstance(arg, ast.Attribute) and isinstance(
                arg.value, ast.Name) and arg.value.id == "self":
            cls = self.enclosing_class(call)
            if cls is not None:
                qual = self._class_qual(cls)
                found = self.by_qualname(f"{qual}.{arg.attr}")
                if not found and self.wrapper_kind(call) == "recompute":
                    self.inherited_wrapped.append((qual, arg.attr))
                return found
        return []

    def _class_qual(self, cls: ast.ClassDef) -> str:
        names = [cls.name] + [a.name for a in self.ancestors(cls)
                              if isinstance(a, (ast.ClassDef, ast.FunctionDef,
                                                ast.AsyncFunctionDef))]
        return ".".join(reversed(names))

    def _mark_wrapped(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                kind = self.wrapper_kind(node)
                for fn in self._wrapped_targets(node) if kind else ():
                    if kind == "compile":
                        fn.compiled = True
                    else:
                        fn.recomputed = True
            elif isinstance(node, ast.ClassDef) and any(
                    self.dotted(b) == AUTOGRAD_FUNCTION
                    for b in node.bases):
                for fn in self.functions:
                    if fn.node in node.body and fn.name in AUTOGRAD_METHODS:
                        fn.autograd = True
        for fn in self.functions:
            for deco in getattr(fn.node, "decorator_list", ()):
                probe = deco if isinstance(deco, ast.Call) else \
                    ast.Call(func=deco, args=[], keywords=[])
                if self.wrapper_kind(probe) == "compile":
                    fn.compiled = True
        # nested defs inside such a body run under it too
        changed = True
        while changed:
            changed = False
            for fn in self.functions:
                outer = self.enclosing_function(fn.node)
                if outer is None:
                    continue
                for flag in ("compiled", "recomputed", "autograd"):
                    if getattr(outer, flag) and not getattr(fn, flag):
                        setattr(fn, flag, True)
                        changed = True

    # -- call graph --------------------------------------------------------
    def _build_call_graph(self) -> None:
        for fn in self.functions:
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                if self.enclosing_function(node) is not fn and not any(
                        self._fn_of_node.get(a) is fn
                        for a in self.ancestors(node)):
                    continue
                target = _impl_ref(self, node)
                if target is not None:
                    fn.ext_calls.add(target)
                name = self.dotted(node.func)
                if name is None:
                    continue
                if name.startswith("self.") and fn.cls is not None:
                    fn.calls.add(f"{fn.cls}.{name[len('self.'):]}")
                    if name.count(".") >= 2:
                        fn.ext_calls.add(name)
                elif "." not in name:
                    fn.calls.add(name)
                else:
                    fn.ext_calls.add(self._narrowed(node, name))

    def _narrowed(self, call: ast.Call, name: str) -> str:
        """``v.method`` inside ``if isinstance(v, Cls):`` → ``<Cls>.method``
        (canonical), so the call resolves to the class's def; ``name``
        otherwise."""
        head, _, rest = name.partition(".")
        if "." in rest:
            return name
        prev: ast.AST = call
        for anc in self.ancestors(call):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            in_body = isinstance(anc, ast.If) and any(
                prev is b for b in anc.body)
            prev = anc
            if not in_body:
                continue
            tests = anc.test.values if isinstance(anc.test, ast.BoolOp) \
                and isinstance(anc.test.op, ast.And) else [anc.test]
            for t in tests:
                if isinstance(t, ast.Call) and isinstance(t.func, ast.Name) \
                        and t.func.id == "isinstance" and len(t.args) == 2 \
                        and isinstance(t.args[0], ast.Name) \
                        and t.args[0].id == head:
                    cls = self.dotted(t.args[1])
                    if cls is not None:
                        return f"{cls}.{rest}"
        return name

    def reachable(self, roots: Iterable[str]) -> Set[str]:
        """Qualnames reachable from ``roots`` over the intra-module call
        graph. Roots may be ``Class.method`` or bare function names; bare
        callee names resolve to any same-named function in the module."""
        by_key: Dict[str, List[FunctionInfo]] = {}
        for fn in self.functions:
            by_key.setdefault(fn.name, []).append(fn)
            key = f"{fn.cls}.{fn.name}" if fn.cls else fn.qualname
            by_key.setdefault(key, []).append(fn)
            by_key.setdefault(fn.qualname, []).append(fn)
        seen: Set[str] = set()
        stack = [r for r in roots if r in by_key]
        while stack:
            key = stack.pop()
            for fn in by_key.get(key, ()):
                if fn.qualname in seen:
                    continue
                seen.add(fn.qualname)
                stack.extend(c for c in fn.calls if c in by_key)
        return seen


def _impl_ref(mod: Module, call: ast.Call) -> Optional[str]:
    """``impl("name")`` — a call with one string literal, whose result the
    caller calls now or later — as ``@impl:<callee dotted>:<name>``,
    resolved by :func:`project_hot` through the callee's
    ``getattr(module, name)`` (nothing, for a callee without one)."""
    if not (len(call.args) == 1 and not call.keywords
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)):
        return None
    callee = mod.dotted(call.func)
    if callee is None:
        return None
    return f"@impl:{callee}:{call.args[0].value}"


def _import_table(tree: ast.Module) -> Dict[str, str]:
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                table[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                table[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}" if node.module
                    else alias.name)
    return table


# -- the package's call graph across modules ----------------------------------

def module_name(relpath: str) -> str:
    """``src/repro_torch/serving/engine.py`` → ``repro_torch.serving.engine``
    (a package's ``__init__.py`` is the package)."""
    rel = relpath[len("src/"):] if relpath.startswith("src/") else relpath
    rel = rel[:-len(".py")] if rel.endswith(".py") else rel
    parts = rel.split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ProjectGraph:
    """Every module's functions keyed by canonical dotted name, so a call
    in one module resolves to the def in another."""

    def __init__(self, modules: Sequence[Module]):
        self.modules = {module_name(m.relpath): m for m in modules}
        # class dotted name → (module, class qualname)
        self.classes: Dict[str, Tuple[Module, str]] = {}
        for name, mod in self.modules.items():
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    self.classes[f"{name}.{node.name}"] = (mod, node.name)
        self._attr_types: Dict[Tuple[str, str], Dict[str, str]] = {}
        # class dotted name → its base classes' dotted names in the tree
        self.bases: Dict[str, List[str]] = {}
        for name, (mod, qual) in self.classes.items():
            node = next(n for n in mod.tree.body
                        if isinstance(n, ast.ClassDef) and n.name == qual)
            self.bases[name] = [b for b in (
                self._class_name(mod, mod.dotted(e)) for e in node.bases)
                if b is not None]

    def resolve(self, dotted: str, depth: int = 0
                ) -> List[Tuple[Module, str]]:
        """(module, qualname) of the defs a canonical dotted call name
        denotes: a module function, a class (its ``__init__``), a class's
        method, or a name a package ``__init__`` re-exports."""
        if depth > 4:
            return []
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = self.modules.get(".".join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            qual = ".".join(rest)
            if mod.by_qualname(qual):
                return [(mod, qual)]
            if len(rest) == 1 and mod.by_qualname(f"{qual}.__init__"):
                return [(mod, f"{qual}.__init__")]
            if rest[0] in mod.imports and mod.imports[rest[0]] != dotted:
                return self.resolve(
                    ".".join([mod.imports[rest[0]]] + rest[1:]), depth + 1)
            return []
        return []

    def attr_types(self, mod: Module, cls: str) -> Dict[str, str]:
        """``self.<attr>`` → canonical class name, from ``self.<attr> =
        Class(...)`` (either arm of a conditional) in ``cls``'s methods."""
        key = (mod.relpath, cls)
        if key in self._attr_types:
            return self._attr_types[key]
        out: Dict[str, str] = {}
        for fn in mod.functions:
            if fn.cls != cls:
                continue
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Assign):
                    continue
                values = [node.value]
                if isinstance(node.value, ast.IfExp):
                    values = [node.value.body, node.value.orelse]
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    for v in values:
                        if isinstance(v, ast.Call):
                            name = mod.dotted(v.func)
                            cname = self._class_name(mod, name)
                            if cname is not None:
                                out.setdefault(tgt.attr, cname)
        self._attr_types[key] = out
        return out

    def _class_name(self, mod: Module, name: Optional[str]
                    ) -> Optional[str]:
        """The dotted name of the tree's class that ``name`` (as written
        in ``mod``) denotes, following re-exports; else None."""
        if name is None:
            return None
        local = f"{module_name(mod.relpath)}.{name}"
        if local in self.classes:
            return local
        for _ in range(4):
            if name in self.classes:
                return name
            head, _, tail = name.rpartition(".")
            target = self.modules.get(head)
            if target is None or tail not in target.imports:
                return None
            name = target.imports[tail]
        return None

    def methods(self, cls: str, name: str) -> List[Tuple[Module, str]]:
        """What ``self.<name>()`` may run on a ``cls`` receiver: the def
        its bases' order finds, and every override in a subclass."""
        out: List[Tuple[Module, str]] = []
        order, seen = [cls], set()
        while order:
            c = order.pop(0)
            if c in seen or c not in self.classes:
                continue
            seen.add(c)
            mod, qual = self.classes[c]
            if mod.by_qualname(f"{qual}.{name}"):
                out.append((mod, f"{qual}.{name}"))
                break
            order += self.bases.get(c, [])
        for sub, (mod, qual) in self.classes.items():
            if sub != cls and cls in self._ancestry(sub) and \
                    mod.by_qualname(f"{qual}.{name}"):
                out.append((mod, f"{qual}.{name}"))
        return out

    def _ancestry(self, cls: str) -> Set[str]:
        out: Set[str] = set()
        stack = list(self.bases.get(cls, []))
        while stack:
            c = stack.pop()
            if c not in out:
                out.add(c)
                stack += self.bases.get(c, [])
        return out

    def _impl_targets(self, spec: str) -> List[Tuple[Module, str]]:
        """``@impl:<callee>:<name>`` → ``<module>.<name>`` for each module
        the callee's ``getattr(<module>, <param>)`` may pick."""
        _, callee, name = spec.split(":", 2)
        out: List[Tuple[Module, str]] = []
        for mod, qual in self.resolve(callee):
            for node in ast.walk(mod.by_qualname(qual)[0].node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "getattr" and node.args):
                    continue
                first = node.args[0]
                cands = ([first.body, first.orelse]
                         if isinstance(first, ast.IfExp) else [first])
                for c in cands:
                    base = mod.dotted(c)
                    if base is not None:
                        out += self.resolve(f"{base}.{name}")
        return out

    def callees(self, mod: Module, fn: FunctionInfo
                ) -> List[Tuple[Module, str]]:
        """Defs in other modules (or this one, through an import or a
        typed attribute) that ``fn`` calls."""
        out: List[Tuple[Module, str]] = []
        for name in fn.ext_calls:
            if name.startswith("@impl:"):
                out += self._impl_targets(name)
            elif name.startswith("self.") and fn.cls is not None:
                attr, *rest = name[len("self."):].split(".")
                cname = self.attr_types(mod, fn.cls).get(attr)
                if cname is not None and rest:
                    out += self.resolve(".".join([cname] + rest))
            else:
                out += self.resolve(name)
        return out


def project_replayed(modules: Sequence[Module],
                     graph: Optional[ProjectGraph] = None
                     ) -> Dict[str, Set[str]]:
    """relpath → qualnames that backward runs again: the defs handed to
    ``torch.utils.checkpoint`` (a base class's ``self.method`` too),
    closed over the calls they make — within a module, across the
    package's imports, and ``self.m()`` to every def a subclass of the
    receiver's class may put there."""
    graph = graph or ProjectGraph(modules)
    out: Dict[str, Set[str]] = {m.relpath: set() for m in modules}
    work: List[Tuple[Module, str]] = []
    for mod in modules:
        work += [(mod, f.qualname) for f in mod.functions if f.recomputed]
        name = module_name(mod.relpath)
        for cls, meth in mod.inherited_wrapped:
            work += graph.methods(f"{name}.{cls}", meth)
    while work:
        mod, qual = work.pop()
        if qual in out[mod.relpath]:
            continue
        out[mod.relpath].add(qual)
        for fn in mod.by_qualname(qual):
            work += graph.callees(mod, fn)
            for call in fn.calls:
                cls, _, meth = call.rpartition(".")
                if cls and cls == fn.cls:
                    qcls = qual.rsplit(".", 1)[0]
                    work += graph.methods(
                        f"{module_name(mod.relpath)}.{qcls}", meth)
                elif not cls:
                    work += [(mod, f.qualname) for f in mod.by_name(call)
                             if f.cls is None]
    return out


def project_hot(modules: Sequence[Module], roots: Sequence[str],
                graph: Optional[ProjectGraph] = None
                ) -> Dict[str, Set[str]]:
    """relpath → qualnames on a hot path: each module's ``roots`` and
    ``# lint: hotpath`` defs, closed over every module's intra-module call
    graph and over calls that resolve into another module of the tree."""
    graph = graph or ProjectGraph(modules)
    hot: Dict[str, Set[str]] = {m.relpath: set() for m in modules}
    work: List[Tuple[Module, str]] = []
    for mod in modules:
        seeds = list(roots) + [f.qualname for f in mod.functions
                               if f.hotpath_marker]
        work += [(mod, q) for q in mod.reachable(seeds)]
    while work:
        mod, qual = work.pop()
        if qual in hot[mod.relpath]:
            continue
        hot[mod.relpath].add(qual)
        for fn in mod.by_qualname(qual):
            for tmod, tqual in graph.callees(mod, fn):
                work += [(tmod, q) for q in tmod.reachable([tqual])
                         if q not in hot[tmod.relpath]]
            work += [(mod, q) for q in mod.reachable([qual])
                     if q not in hot[mod.relpath]]
    return hot


def once_guarded(mod: Module, node: ast.AST, fn: Optional[FunctionInfo],
                 attrs: bool = True) -> bool:
    """True when ``node`` runs once per process: under an ``if X is
    None:`` guard on a ``global`` of ``fn`` (or, with ``attrs``, a
    ``self.`` attribute), or in a function that ``functools`` caches."""
    if fn is None:
        return False
    for deco in getattr(fn.node, "decorator_list", ()):
        target = deco.func if isinstance(deco, ast.Call) else deco
        if mod.dotted(target) in _CACHE_DECORATORS:
            return True
    declared = {n for g in ast.walk(fn.node) if isinstance(g, ast.Global)
                for n in g.names}
    for anc in mod.ancestors(node):
        if anc is fn.node:
            break
        if not isinstance(anc, ast.If):
            continue
        test = anc.test
        if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
                isinstance(test.ops[0], ast.Is) and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value is None:
            guard = mod.dotted(test.left) or ""
            if guard in declared or (attrs and guard.startswith("self.")):
                return True
    return False


def call_kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


# tensor attributes and methods that read metadata the host already holds
SHAPE_ATTRS = ("shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "names")
SHAPE_METHODS = ("size", "dim", "numel", "stride", "data_ptr",
                 "element_size", "is_contiguous", "get_device",
                 "storage_offset", "nelement", "is_floating_point")


def is_shapelike(node: ast.AST) -> bool:
    """True for expressions the host knows without waiting on the card
    even when their base is a device tensor: ``x.shape``, ``x.dtype``,
    ``x.size()``, ``x.numel()``, ``len(x)``, ``x.shape[i]``."""
    if isinstance(node, ast.Attribute) and node.attr in SHAPE_ATTRS:
        return True
    if isinstance(node, ast.Subscript):
        return is_shapelike(node.value)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name):
            return node.func.id in ("len", "getattr", "isinstance")
        if isinstance(node.func, ast.Attribute):
            return node.func.attr in SHAPE_METHODS
    return False


__all__ = ["Module", "FunctionInfo", "ProjectGraph", "project_hot",
           "project_replayed", "once_guarded", "module_name", "call_kwarg",
           "is_shapelike", "COMPILE_WRAPPERS", "RECOMPUTE_WRAPPERS",
           "SHAPE_ATTRS", "SHAPE_METHODS"]
