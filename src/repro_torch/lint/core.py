"""Rule registry, findings, config, baseline, and the lint driver (the
port of ``repro/lint/core.py``: the same registry, ``Finding``,
fingerprint, baseline and suppressions, over ``src/repro_torch``).

The registry mirrors ``repro_torch.core.registry``: rules are plain functions
behind a ``@register(rule_id, ...)`` decorator, loaded on first use by an
idempotent ``_load_builtins()``. Two rule scopes exist:

* ``module`` rules run once per parsed file and receive a
  :class:`ModuleContext`;
* ``project`` rules run once per lint invocation with a
  :class:`ProjectContext` holding every parsed module (the contract lints
  need the whole tree to cross-check metric names against the schema;
  ``kernel-abi`` reads the kernels' ctypes seam and CUDA sources).

Before the module rules run, the driver expands the hot-path roots over
the whole tree (:func:`~.astutil.project_hot`): a module rule sees the
hot set of its module in :attr:`ModuleContext.hot`, including defs that
only another module's hot code reaches. A finding a ``# lint: allow``
comment suppresses is kept apart (``run_lint(..., allowed=[])``), so a
run can say what it allowed and where.

Findings carry a content *fingerprint* — ``sha1(rule|path|symbol|message)``
— so the checked-in baseline survives unrelated line drift; moving or
editing the offending code invalidates its baseline entry, which is the
point.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import importlib
import json
import os
import re
from typing import (Callable, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)

from .astutil import Module, ProjectGraph, project_hot, project_replayed

SEVERITIES = ("error", "warning", "info")
# ``// lint: allow[kernel-abi] reason`` in a CUDA source
_TEXT_ALLOW = re.compile(r"//\s*lint:\s*allow\[([^\]]*)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str                       # repo-relative, forward slashes
    line: int
    col: int
    severity: str
    message: str
    symbol: str = ""                # enclosing function qualname, if any

    @property
    def fingerprint(self) -> str:
        blob = f"{self.rule}|{self.path}|{self.symbol}|{self.message}"
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity} {self.rule}: {self.message}{sym}")


@dataclasses.dataclass
class LintConfig:
    """What to scan and how strictly. All paths/globs are repo-relative."""
    # NB: fnmatch has no special '**' — a bare '*' already crosses '/'
    # in its regex translation, so 'src/repro_torch/*.py' alone would match
    # the whole tree; keep both spellings for readability.
    include: Tuple[str, ...] = ("src/repro_torch/*.py",
                                "src/repro_torch/**/*.py")
    exclude: Tuple[str, ...] = ()
    # Hot-path roots for host-sync: ``Class.method`` or bare function names,
    # expanded over the call graph within and across modules. ``# lint:
    # hotpath`` markers add roots without touching the config.
    hotpath_roots: Tuple[str, ...] = ("Engine.step", "Engine._decode")
    # ``self.*`` attributes that return device tensors (the engine's step
    # functions): calling them taints the result for the host-sync dataflow.
    device_producers: Tuple[str, ...] = (
        "self._prefill", "self._chunk", "self._decode")
    # Files where bf16 flows through and torch's promotion to f32 matters.
    dtype_sensitive: Tuple[str, ...] = (
        "src/repro_torch/models/layers.py", "src/repro_torch/models/mamba2.py",
        "src/repro_torch/serving/kv_cache.py", "src/repro_torch/kernels/*.py")
    # The kernels' ctypes seam (SIGNATURES, the _launch calls) and their
    # CUDA sources, which kernel-abi holds against each other.
    kernel_build: str = "src/repro_torch/kernels/_build.py"
    kernel_ops: str = "src/repro_torch/kernels/ops.py"
    kernel_sources: Tuple[str, ...] = ("src/repro_torch/kernels/csrc/*.cu",)
    metrics_schema: str = "src/repro_torch/lint/metrics_schema.json"
    # (path glob, rule id or '*') → severity override; first match wins.
    severity_overrides: Tuple[Tuple[str, str, str], ...] = ()
    disabled_rules: Tuple[str, ...] = ()

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "LintConfig":
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                v = d[f.name]
                if f.name == "severity_overrides":
                    v = tuple(tuple(row) for row in v)  # type: ignore
                elif isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown lint config keys: {sorted(unknown)}")
        return cls(**kwargs)  # type: ignore[arg-type]

    def severity_for(self, rule_id: str, path: str, default: str) -> str:
        for glob, rule, sev in self.severity_overrides:
            if rule in ("*", rule_id) and fnmatch.fnmatch(path, glob):
                if sev not in SEVERITIES + ("off",):
                    raise ValueError(f"bad severity override: {sev!r}")
                return sev
        return default


class ModuleContext:
    """Per-file context handed to ``scope='module'`` rules, with the
    module's share of the whole tree's call graph: ``hot``, its defs on a
    hot path (:func:`~.astutil.project_hot`), and ``replayed``, its defs
    that backward runs again (:func:`~.astutil.project_replayed`)."""

    def __init__(self, module: Module, config: LintConfig, hot: Set[str],
                 replayed: Set[str]):
        self.module = module
        self.config = config
        self.hot = hot
        self.replayed = replayed
        self._findings: List[Finding] = []
        self._allowed: List[Finding] = []
        self._rule: Optional["_Entry"] = None

    def report(self, node, message: str, *, severity: Optional[str] = None,
               symbol: Optional[str] = None) -> None:
        assert self._rule is not None
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            # a method call's line is its attribute's, as the interpreter
            # reports it in a traceback (``x\n    .cpu()`` is .cpu()'s line)
            line = node.func.end_lineno or line
        if symbol is None:
            fn = self.module.enclosing_function(node) if node is not None \
                else None
            symbol = fn.qualname if fn is not None else ""
        sev = self.config.severity_for(
            self._rule.rule_id, self.module.relpath,
            severity or self._rule.severity)
        if sev == "off":
            return
        finding = Finding(
            rule=self._rule.rule_id, path=self.module.relpath, line=line,
            col=col, severity=sev, message=message, symbol=symbol)
        if self.module.suppressed(line, self._rule.rule_id):
            self._allowed.append(finding)
        else:
            self._findings.append(finding)


class ProjectContext:
    """Whole-tree context handed to ``scope='project'`` rules. ``partial``
    says the run lints explicit paths, not the whole tree: what the tree
    lacks may lie outside them."""

    def __init__(self, modules: Sequence[Module], config: LintConfig,
                 root: str, partial: bool = False):
        self.modules = list(modules)
        self.config = config
        self.root = root
        self.partial = partial
        self._findings: List[Finding] = []
        self._allowed: List[Finding] = []
        self._rule: Optional["_Entry"] = None

    def module(self, relpath: str) -> Optional[Module]:
        for m in self.modules:
            if m.relpath == relpath:
                return m
        return None

    def report(self, path: str, line: int, message: str, *,
               severity: Optional[str] = None, symbol: str = "") -> None:
        assert self._rule is not None
        sev = self.config.severity_for(
            self._rule.rule_id, path, severity or self._rule.severity)
        if sev == "off":
            return
        finding = Finding(
            rule=self._rule.rule_id, path=path, line=line, col=0,
            severity=sev, message=message, symbol=symbol)
        if self.suppressed(path, line):
            self._allowed.append(finding)
        else:
            self._findings.append(finding)

    def suppressed(self, path: str, line: int) -> bool:
        """``allow[rule]`` at ``path:line``: a parsed module's ``#`` comment,
        or a ``// lint: allow[...]`` comment in another text file."""
        mod = self.module(path)
        if mod is not None:
            return mod.suppressed(line, self._rule.rule_id)
        full = os.path.join(self.root, path)
        if not os.path.exists(full):
            return False
        with open(full, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        for ln in (line, line - 1):
            if 1 <= ln <= len(lines):
                m = _TEXT_ALLOW.search(lines[ln - 1])
                names = {r.strip() for r in m.group(1).split(",")} if m \
                    else set()
                if names & {"*", self._rule.rule_id}:
                    return True
        return False


@dataclasses.dataclass
class _Entry:
    rule_id: str
    fn: Callable
    severity: str
    scope: str                      # 'module' | 'project'
    help: str


_REGISTRY: Dict[str, _Entry] = {}
_BUILTINS_LOADED = False


def register(rule_id: str, *, severity: str = "error",
             scope: str = "module", help: str = "") -> Callable:
    """Decorator registering a lint rule, mirroring
    ``repro_torch.core.registry.register``."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}")
    if scope not in ("module", "project"):
        raise ValueError("scope must be 'module' or 'project'")

    def deco(fn: Callable) -> Callable:
        if rule_id in _REGISTRY and _REGISTRY[rule_id].fn is not fn:
            raise ValueError(f"lint rule {rule_id!r} already registered")
        _REGISTRY[rule_id] = _Entry(rule_id, fn, severity, scope, help)
        return fn

    return deco


def _load_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    importlib.import_module("repro_torch.lint.rules")


def available() -> List[str]:
    _load_builtins()
    return sorted(_REGISTRY)


def rule_entries() -> List[_Entry]:
    _load_builtins()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# -- file discovery --------------------------------------------------------

def discover(root: str, config: LintConfig,
             paths: Optional[Sequence[str]] = None) -> List[str]:
    """Repo-relative paths to lint. Explicit ``paths`` bypass the include
    globs (so the CLI can lint one file) but still honor excludes."""
    rels: List[str] = []
    if paths:
        for p in paths:
            rel = os.path.relpath(os.path.abspath(p), root).replace(
                os.sep, "/")
            if os.path.isdir(os.path.join(root, rel)):
                for dirpath, _dirnames, filenames in os.walk(
                        os.path.join(root, rel)):
                    for fname in sorted(filenames):
                        if fname.endswith(".py"):
                            sub = os.path.relpath(
                                os.path.join(dirpath, fname), root)
                            rels.append(sub.replace(os.sep, "/"))
            else:
                rels.append(rel)
    else:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in (".git", "__pycache__", ".venv")]
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fname), root)
                rel = rel.replace(os.sep, "/")
                if any(fnmatch.fnmatch(rel, g) for g in config.include):
                    rels.append(rel)
    rels = [r for r in dict.fromkeys(rels)
            if not any(fnmatch.fnmatch(r, g) for g in config.exclude)]
    return rels


# -- driver ----------------------------------------------------------------

def run_lint(root: str, config: Optional[LintConfig] = None,
             paths: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[str]] = None,
             allowed: Optional[List[Finding]] = None) -> List[Finding]:
    """Parse the tree and run every enabled rule; returns all findings
    sorted by (path, line, rule). ``allowed``, when given, receives the
    findings that ``# lint: allow`` comments suppressed, in the same
    order."""
    _load_builtins()
    config = config or LintConfig()
    selected = set(rules) if rules is not None else None
    modules: List[Module] = []
    findings: List[Finding] = []
    for rel in discover(root, config, paths):
        full = os.path.join(root, rel)
        try:
            with open(full, "r", encoding="utf-8") as fh:
                text = fh.read()
            modules.append(Module(full, rel, text))
        except SyntaxError as exc:
            findings.append(Finding(
                rule="parse-error", path=rel, line=exc.lineno or 0,
                col=exc.offset or 0, severity="error",
                message=f"syntax error: {exc.msg}"))
    graph = ProjectGraph(modules)
    hot = project_hot(modules, config.hotpath_roots, graph)
    replayed = project_replayed(modules, graph)
    suppressed: List[Finding] = []
    for entry in rule_entries():
        if entry.rule_id in config.disabled_rules:
            continue
        if selected is not None and entry.rule_id not in selected:
            continue
        if entry.scope == "module":
            for mod in modules:
                ctx = ModuleContext(mod, config, hot[mod.relpath],
                                    replayed[mod.relpath])
                ctx._rule = entry
                entry.fn(ctx)
                findings.extend(ctx._findings)
                suppressed.extend(ctx._allowed)
        else:
            pctx = ProjectContext(modules, config, root, bool(paths))
            pctx._rule = entry
            entry.fn(pctx)
            findings.extend(pctx._findings)
            suppressed.extend(pctx._allowed)
    order = lambda f: (f.path, f.line, f.col, f.rule)  # noqa: E731
    findings.sort(key=order)
    if allowed is not None:
        allowed.extend(sorted(suppressed, key=order))
    return findings


# -- baseline --------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, Dict[str, object]]:
    """fingerprint → baseline entry. Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: Dict[str, Dict[str, object]] = {}
    for entry in data.get("findings", []):
        out[str(entry["fingerprint"])] = entry
    return out


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        d = f.to_dict()
        entries.append({k: d[k] for k in (
            "fingerprint", "rule", "path", "line", "severity", "message",
            "symbol")})
    payload = {
        "comment": ("Grandfathered lint findings. Entries are matched by "
                    "content fingerprint (rule|path|symbol|message), not "
                    "line number; fix the code and rerun with "
                    "--update-baseline to retire one."),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=False)
        fh.write("\n")


def partition(findings: Sequence[Finding],
              baseline: Dict[str, Dict[str, object]]
              ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new, baselined, stale-fingerprints) split of a lint run."""
    new: List[Finding] = []
    old: List[Finding] = []
    seen = set()
    for f in findings:
        if f.fingerprint in baseline:
            old.append(f)
            seen.add(f.fingerprint)
        else:
            new.append(f)
    stale = [fp for fp in baseline if fp not in seen]
    return new, old, stale
