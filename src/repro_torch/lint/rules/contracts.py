"""Contract lints: registry adapters and the metric-name schema (the port
of ``repro/lint/rules/contracts.py``).

``register-contract`` (module scope): every function decorated with
``repro_torch.core.registry.register`` must return a ``CompressResult`` on
every return path, and every ``register_batched`` adapter a list of them
(a list comprehension or literal whose items are one) — that is the whole
integration contract, and a stray bare ``theta`` return only fails much
later inside ``compress_model``'s artifact handling. One level of
local-helper indirection is resolved (``awp.py``'s ``_prune_result``,
``batched.py``'s ``_prune_results``).

``metrics-contract`` (project scope): every metric family registered in
``src/repro_torch`` must be listed in the port's schema
(``repro_torch/lint/metrics_schema.json``) ``families`` key and vice
versa, via the shared extractor in ``repro_torch.lint.contracts``. A run
over explicit paths checks only code → schema: the families it does not
see may be registered outside them (the reference reports each of them).
"""
from __future__ import annotations

import ast
import os
from fnmatch import fnmatch
from typing import Optional

from ..contracts import KINDS, extract_metric_uses, load_schema_families
from ..core import ModuleContext, ProjectContext, register


def _registry_kind(mod, deco: ast.AST) -> Optional[str]:
    """'single' for ``@registry.register(...)``, 'batched' for
    ``@registry.register_batched(...)``, else None."""
    if not isinstance(deco, ast.Call):
        return None
    name = mod.dotted(deco.func)
    if name is None:
        return None
    parts = name.split(".")
    if len(parts) < 2 or not parts[-2].lstrip("_").endswith("registry"):
        return None
    return {"register": "single",
            "register_batched": "batched"}.get(parts[-1])


def _returns_compress_result(mod, fn_node: ast.AST, depth: int = 0,
                             batched: bool = False
                             ) -> Optional[ast.Return]:
    """The first return statement that does NOT resolve to a
    CompressResult construction (a list of them when ``batched``), or None
    when all paths comply."""

    def resolves(expr: ast.AST, many: bool) -> bool:
        if many and isinstance(expr, ast.ListComp):
            return resolves(expr.elt, False)
        if many and isinstance(expr, ast.List):
            return all(resolves(e, False) for e in expr.elts)
        if isinstance(expr, ast.Call):
            name = mod.dotted(expr.func)
            if not many and name is not None and \
                    name.rsplit(".", 1)[-1] == "CompressResult":
                return True
            # one level of local helper indirection
            if name is not None and "." not in name and depth < 2:
                for helper in mod.by_name(name):
                    if helper.cls is None and _returns_compress_result(
                            mod, helper.node, depth + 1, many) is None:
                        return True
            return False
        if isinstance(expr, ast.Name):
            # name assigned from a CompressResult call earlier in the body
            for n in ast.walk(fn_node):
                if isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in n.targets) and resolves(n.value, many):
                    return True
            return False
        if isinstance(expr, ast.IfExp):
            return resolves(expr.body, many) and resolves(expr.orelse, many)
        return False

    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        owner = mod.enclosing_function(node)
        if owner is not None and owner.node is not fn_node:
            continue
        if not resolves(node.value, batched):
            return node
    return None


@register("register-contract", severity="error", help=(
    "@registry.register adapters must return CompressResult on every "
    "path (@registry.register_batched: a list of them); anything else "
    "breaks compress_model's artifact handling."))
def check_register_contract(ctx: ModuleContext) -> None:
    mod = ctx.module
    for fn in mod.functions:
        decos = getattr(fn.node, "decorator_list", ())
        kinds = [k for k in (_registry_kind(mod, d) for d in decos) if k]
        if not kinds:
            continue
        batched = kinds[0] == "batched"
        bad = _returns_compress_result(mod, fn.node, batched=batched)
        if bad is not None:
            want = ("a list of CompressResult — build it as [registry."
                    "CompressResult(theta=...) for ...]" if batched else
                    "a CompressResult — wrap it: "
                    "registry.CompressResult(theta=...)")
            ctx.report(bad, (
                f"@register adapter {fn.name!r} has a return path that is "
                f"not {want}"), symbol=fn.qualname)


@register("metrics-contract", severity="error", scope="project", help=(
    "Metric family names in code and the port's metrics schema "
    "'families' must match bidirectionally."))
def check_metrics_contract(ctx: ProjectContext) -> None:
    schema_rel = ctx.config.metrics_schema
    schema_path = os.path.join(ctx.root, schema_rel)
    if not os.path.exists(schema_path):
        ctx.report(schema_rel, 1, f"metrics schema not found: {schema_rel}")
        return
    try:
        families = load_schema_families(schema_path)
    except ValueError as exc:
        ctx.report(schema_rel, 1, str(exc))
        return

    uses = []
    for mod in ctx.modules:
        uses.extend(extract_metric_uses(mod))

    # code → schema
    for use in uses:
        names = families.get(use.kind, [])
        if use.exact:
            ok = use.name in names
        else:
            ok = any(fnmatch(n, use.name) for n in names)
        if not ok:
            what = "name" if use.exact else "pattern"
            ctx.report(use.path, use.line, (
                f"metric {what} {use.name!r} ({use.kind}) is not listed "
                f"in {schema_rel} families.{use.kind}"))

    # schema → code (a run over explicit paths may not hold the code that
    # registers a family)
    for kind in KINDS if not ctx.partial else ():
        declared = families.get(kind, [])
        for name in declared:
            hit = any(
                u.kind == kind and (
                    u.name == name if u.exact else fnmatch(name, u.name))
                for u in uses)
            if not hit:
                ctx.report(schema_rel, 1, (
                    f"families.{kind} lists {name!r} but no code in the "
                    "scanned tree registers it"))
