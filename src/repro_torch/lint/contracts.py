"""Shared contract-extraction helpers: metric family names and schema
(the port of ``repro/lint/contracts.py``, the same extraction).

The ``metrics-contract`` lint rule (``repro_torch.lint.rules.contracts``)
cross-checks the names extracted from ``src/repro_torch`` against the
port's schema (``repro_torch/lint/metrics_schema.json``) bidirectionally.

Extraction is static: every ``<registry>.counter/gauge/histogram(name,
...)`` call in the tree contributes a family name. Literal first args give
exact names; f-strings give ``fnmatch`` patterns (``f"engine_{key}_total"``
→ ``engine_*_total``); and one level of local-helper indirection is
resolved — the engine's ``counter(key, help)`` wrapper and its
``{k: counter(k, h) for k, h in (…literal tuples…)}`` registration dict
both yield exact names.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from .astutil import Module

KIND_OF_METHOD = {"counter": "counters", "gauge": "gauges",
                  "histogram": "histograms"}
KINDS = tuple(sorted(set(KIND_OF_METHOD.values())))


@dataclasses.dataclass(frozen=True)
class MetricUse:
    kind: str                       # counters | gauges | histograms
    name: str                       # exact name or fnmatch pattern
    exact: bool
    path: str
    line: int


# ---- template machinery --------------------------------------------------

def _template(mod: Module, node: ast.AST) -> Optional[List[Tuple[str, str]]]:
    """First-arg expression → [('lit', s) | ('hole', varname|'')] parts,
    or None when it contributes no name (non-string)."""
    if isinstance(node, ast.Constant):
        return [("lit", node.value)] if isinstance(node.value, str) else None
    if isinstance(node, ast.JoinedStr):
        parts: List[Tuple[str, str]] = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(("lit", v.value))
            elif isinstance(v, ast.FormattedValue) and \
                    isinstance(v.value, ast.Name):
                parts.append(("hole", v.value.id))
            else:
                parts.append(("hole", ""))
        return parts
    if isinstance(node, ast.Name):
        return [("hole", node.id)]
    return None


def _render(parts: Sequence[Tuple[str, str]],
            subs: Optional[Dict[str, str]] = None) -> Tuple[str, bool]:
    """(name-or-pattern, exact) after substituting hole values."""
    out: List[str] = []
    exact = True
    for kind, val in parts:
        if kind == "lit":
            out.append(val)
        elif subs is not None and val in subs:
            out.append(subs[val])
        else:
            out.append("*")
            exact = False
    return "".join(out), exact


def _params(fn_node: ast.AST) -> List[str]:
    a = fn_node.args
    names = [p.arg for p in list(a.posonlyargs) + list(a.args)]
    return [n for n in names if n != "self"]


def _comp_substitutions(mod: Module, call: ast.Call, arg: ast.AST
                        ) -> Optional[List[str]]:
    """When ``arg`` is the target variable of an enclosing comprehension
    iterating a literal tuple-of-tuples (the engine's registration dict),
    inline or bound to a module-level name, return every literal value the
    variable takes."""
    if not isinstance(arg, ast.Name):
        return None
    for anc in mod.ancestors(call):
        if not isinstance(anc, (ast.DictComp, ast.ListComp, ast.SetComp,
                                ast.GeneratorExp)):
            continue
        for gen in anc.generators:
            tgt, it = gen.target, _module_literal(mod, gen.iter)
            if not isinstance(it, (ast.Tuple, ast.List)):
                continue
            if isinstance(tgt, ast.Name) and tgt.id == arg.id:
                vals = [e.value for e in it.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
                return vals if len(vals) == len(it.elts) else None
            if isinstance(tgt, (ast.Tuple, ast.List)):
                for i, t in enumerate(tgt.elts):
                    if isinstance(t, ast.Name) and t.id == arg.id:
                        vals = []
                        for e in it.elts:
                            if isinstance(e, (ast.Tuple, ast.List)) and \
                                    len(e.elts) > i and \
                                    isinstance(e.elts[i], ast.Constant) and \
                                    isinstance(e.elts[i].value, str):
                                vals.append(e.elts[i].value)
                            else:
                                return None
                        return vals
    return None


def _module_literal(mod: Module, node: ast.AST) -> ast.AST:
    """A name bound once at module level to a tuple or list literal (the
    port's engine keeps its counter table in ``_COUNTER_HELP``) → that
    literal; any other node as it is."""
    if not isinstance(node, ast.Name):
        return node
    bound = [n.value for n in mod.tree.body if isinstance(n, ast.Assign)
             and any(isinstance(t, ast.Name) and t.id == node.id
                     for t in n.targets)]
    if len(bound) == 1 and isinstance(bound[0], (ast.Tuple, ast.List)):
        return bound[0]
    return node


def extract_metric_uses(mod: Module) -> List[MetricUse]:
    """All metric family names (exact or pattern) a module registers."""
    uses: List[MetricUse] = []
    # helper name → (kind, template, param names, definition FunctionInfo)
    helpers: Dict[str, Tuple[str, List[Tuple[str, str]], List[str]]] = {}

    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in KIND_OF_METHOD):
            continue
        kind = KIND_OF_METHOD[node.func.attr]
        first = node.args[0] if node.args else None
        if first is None:
            for kw in node.keywords:
                if kw.arg == "name":
                    first = kw.value
        if first is None:
            continue
        parts = _template(mod, first)
        if parts is None:
            continue
        holes = [v for k, v in parts if k == "hole"]
        fn = mod.enclosing_function(node)
        if holes and fn is not None and \
                any(h in _params(fn.node) for h in holes if h):
            helpers[fn.name] = (kind, parts, _params(fn.node))
            continue
        name, exact = _render(parts)
        uses.append(MetricUse(kind, name, exact, mod.relpath, node.lineno))

    if not helpers:
        return uses

    # resolve helper call sites: bare ``counter(k, h)`` or ``self._status_
    # counter("requests", ...)``
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        hname = None
        if isinstance(node.func, ast.Name):
            hname = node.func.id
        elif isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "self":
            hname = node.func.attr
        if hname not in helpers:
            continue
        kind, parts, params = helpers[hname]
        subs: Dict[str, str] = {}
        multi: Dict[str, List[str]] = {}
        for i, p in enumerate(params):
            arg: Optional[ast.AST] = None
            if i < len(node.args):
                arg = node.args[i]
            else:
                for kw in node.keywords:
                    if kw.arg == p:
                        arg = kw.value
            if arg is None:
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                subs[p] = arg.value
            else:
                vals = _comp_substitutions(mod, node, arg)
                if vals is not None:
                    multi[p] = vals
        if multi:
            # one hole expanding over a literal tuple (engine's dict comp)
            p, vals = next(iter(multi.items()))
            for v in vals:
                name, exact = _render(parts, {**subs, p: v})
                uses.append(MetricUse(kind, name, exact, mod.relpath,
                                      node.lineno))
        else:
            name, exact = _render(parts, subs)
            uses.append(MetricUse(kind, name, exact, mod.relpath,
                                  node.lineno))
    return uses


# ---- schema --------------------------------------------------------------

def load_schema_families(path: str) -> Dict[str, List[str]]:
    """The ``families`` contract of a metrics schema file:
    ``{"counters": [names...], "gauges": [...], "histograms": [...]}``."""
    with open(path, "r", encoding="utf-8") as fh:
        schema = json.load(fh)
    fam = schema.get("families")
    if not isinstance(fam, dict):
        raise ValueError(
            f"{path} has no 'families' key — the metric-name contract "
            "the lint and snapshot checkers share")
    out: Dict[str, List[str]] = {}
    for kind in KINDS:
        names = fam.get(kind, [])
        if not isinstance(names, list) or \
                not all(isinstance(n, str) for n in names):
            raise ValueError(f"families.{kind} must be a list of strings")
        out[kind] = sorted(names)
    return out
