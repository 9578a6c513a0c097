"""The port's static analyzer (``repro_torch.lint``) against the JAX
package's (``repro.lint``) on the CPU.

Where the two compute the same thing they get the same inputs: the
machinery (``Finding``'s fingerprint, ``render`` and ``to_dict``,
``partition``, the baseline file byte for byte, ``LintConfig``,
``Module.suppressed`` and ``Module.reachable``), ``register-contract``,
and ``metrics-contract``'s extraction and schema. Each reference fixture
of ``host-sync``, ``recompile-hazard``, ``tracer-leak`` and
``dtype-drift`` (``tests/test_lint.py``) is translated to PyTorch, and the
port's rule (``host-sync``, ``rebuild-hazard``, ``graph-leak``,
``dtype-drift``) must flag or clear the same lines as the reference's on
the original. The port's own cases (pageable uploads, data-dependent
shapes, the cross-module hot path, checkpointed side effects, ``ctx``
attributes, CUDA graphs in a loop, the kernels' ctypes seam) each get a
true positive and a true negative; every true positive of ``dtype-drift``
is also run here and the dtype torch gives is asserted. ``kernel-abi``
runs on copies of the real kernel files with one fault seeded each. The
CLI gates the whole port tree, as ``test_cli_whole_tree_clean_modulo_
baseline`` gates the reference's. Last, ``chip_smoke.py``'s capture of
the stack at each host wait, which the card run holds to the host-sync
rule's allowed sites.
"""
import ast
import io
import json
import os
import re
import shutil
import sys
import textwrap
import tokenize
import types
import warnings
from pathlib import Path

import pytest
import torch

from conftest import REPO

from repro.lint import core as jlint
from repro.lint.astutil import Module as JModule
from repro.lint.contracts import (extract_metric_uses as j_extract,
                                  load_schema_families as j_families)
from repro_torch.lint import core as lint
from repro_torch.lint.__main__ import main as cli
from repro_torch.lint.astutil import Module
from repro_torch.lint.contracts import (extract_metric_uses,
                                        load_schema_families)

PORT_RULES = ("dtype-drift", "graph-leak", "host-sync", "kernel-abi",
              "metrics-contract", "rebuild-hazard", "register-contract")
PORT_SCHEMA = "src/repro_torch/lint/metrics_schema.json"
_EMPTY_SCHEMA = {"families": {"counters": [], "gauges": [],
                              "histograms": []}}


def _write(root, files, schema_rel, schema):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    sp = root / schema_rel
    if not sp.exists():
        sp.parent.mkdir(parents=True, exist_ok=True)
        sp.write_text(json.dumps(schema or _EMPTY_SCHEMA))


def lint_tree(tmp_path, files, schema=None, rules=None, config=None,
              allowed=None):
    """Write ``files`` ({repo-relative path: source}) under a scratch root
    shaped like this repo and lint it with the port's analyzer."""
    _write(tmp_path, files, PORT_SCHEMA, schema)
    return lint.run_lint(str(tmp_path), config, rules=rules, allowed=allowed)


def ref_tree(tmp_path, files, schema=None, rules=None):
    """The same with the JAX package's analyzer."""
    _write(tmp_path, files, "scripts/metrics_schema.json", schema)
    return jlint.run_lint(str(tmp_path), None, rules=rules)


def same_lines(tmp_path, ref_src, port_src, ref_rule, port_rule,
               ref_rel="src/repro/serving/x.py", port_rel=None):
    """Each analyzer on its own translation of one fixture: the lines
    flagged must be the same. Returns (reference's, port's) findings."""
    port_rel = port_rel or ref_rel.replace("src/repro/", "src/repro_torch/")
    ref = ref_tree(tmp_path / "ref", {ref_rel: ref_src}, rules=[ref_rule])
    port = lint_tree(tmp_path / "port", {port_rel: port_src},
                     rules=[port_rule])
    assert [f.line for f in port] == [f.line for f in ref], (ref, port)
    return ref, port


def lines_of(findings):
    return [f.line for f in findings]


def run_fixture(src, name, *args):
    """Execute a fixture's source here and call its function ``name``."""
    ns = {}
    exec(compile(textwrap.dedent(src), "<fixture>", "exec"), ns)
    return ns[name](*args)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the dtype fixtures run tiny tensors, and under
    pytest-xdist more threads' spin-waits take the cores from the other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# machinery: the same inputs through both analyzers
# ---------------------------------------------------------------------------

FINDINGS = [
    dict(rule="host-sync", path="src/x/serving/engine.py", line=12, col=8,
         severity="error", message=".item() forces a sync", symbol="E.step"),
    dict(rule="dtype-drift", path="src/x/models/layers.py", line=3, col=0,
         severity="warning", message="f64 — ünïcode", symbol=""),
    dict(rule="metrics-contract", path="scripts/s.json", line=1, col=0,
         severity="info", message="families.gauges lists 'g'", symbol=""),
]


def test_finding_fingerprint_render_to_dict_equal():
    for d in FINDINGS:
        j, p = jlint.Finding(**d), lint.Finding(**d)
        assert p.fingerprint == j.fingerprint
        assert p.render() == j.render()
        assert p.to_dict() == j.to_dict()


def test_partition_same_split():
    pf = [lint.Finding(**d) for d in FINDINGS]
    jf = [jlint.Finding(**d) for d in FINDINGS]
    baseline = {pf[0].fingerprint: {}, "0123456789abcdef": {}}
    got = lint.partition(pf, baseline)
    want = jlint.partition(jf, baseline)
    assert [[f.to_dict() for f in part] for part in got[:2]] == \
        [[f.to_dict() for f in part] for part in want[:2]]
    assert got[2] == want[2] == ["0123456789abcdef"]


def test_baseline_files_byte_identical_and_read_back(tmp_path):
    pp, jp = tmp_path / "port.json", tmp_path / "ref.json"
    lint.save_baseline(str(pp), [lint.Finding(**d) for d in FINDINGS])
    jlint.save_baseline(str(jp), [jlint.Finding(**d) for d in FINDINGS])
    assert pp.read_bytes() == jp.read_bytes()
    assert lint.load_baseline(str(pp)) == jlint.load_baseline(str(jp))
    assert len(lint.load_baseline(str(pp))) == len(FINDINGS)
    assert lint.load_baseline(str(tmp_path / "missing.json")) == {}


def test_config_from_dict_and_severity_for_agree():
    d = {"exclude": ["src/x/vendor/*"], "disabled_rules": ["dtype-drift"],
         "severity_overrides": [["src/x/legacy/*", "host-sync", "warning"],
                                ["src/x/vendor/*", "*", "off"],
                                ["src/x/info/*", "*", "info"]]}
    p, j = lint.LintConfig.from_dict(d), jlint.LintConfig.from_dict(d)
    for field in ("exclude", "disabled_rules", "severity_overrides"):
        assert getattr(p, field) == getattr(j, field)
    for rule in ("host-sync", "dtype-drift", "graph-leak"):
        for path in ("src/x/legacy/a.py", "src/x/vendor/b.py",
                     "src/x/info/c.py", "src/x/serving/d.py"):
            for default in ("error", "warning"):
                want = j.severity_for(rule, path, default)
                assert p.severity_for(rule, path, default) == want
    assert p.severity_for("x", "src/x/vendor/b.py", "error") == "off"
    for bad in ({"nope": 1}, {"include": 3, "nope": 2}):
        with pytest.raises(ValueError):
            jlint.LintConfig.from_dict(bad)
        with pytest.raises(ValueError):
            lint.LintConfig.from_dict(bad)
    for mod in (lint, jlint):
        cfg = mod.LintConfig(severity_overrides=(("*", "*", "fatal"),))
        with pytest.raises(ValueError):
            cfg.severity_for("host-sync", "a.py", "error")


MODULE_SOURCES = [
    """
    import numpy as np

    class Engine:
        def step(self):
            self._admit()
            return self._decode()  # lint: allow[host-sync] one per step

        def _admit(self):
            # lint: allow[host-sync, dtype-drift] both, with a reason
            return helper(1)

        def _decode(self):
            return np.zeros(3)  # lint: allow

        def idle(self):  # lint: hotpath
            return other()

    def helper(x):
        def inner(y):
            return deep(y)
        return inner(x)

    def deep(y):
        return y

    def other():
        return deep(2)

    def unreached():
        return helper(3)
    """,
    """
    def a():
        b()
        self_free()

    def b():  # lint: hotpath
        c()

    def c():
        pass

    def self_free():  # lint:allow[x]
        a()

    class K:
        def m(self):
            self.n()

        def n(
            self,
            x=1,
        ):  # lint: hotpath
            return a()
    """,
]


@pytest.mark.parametrize("src", MODULE_SOURCES)
def test_module_suppressed_and_reachable_agree(src):
    src = textwrap.dedent(src)
    p, j = Module("x.py", "x.py", src), JModule("x.py", "x.py", src)
    assert p.allow == j.allow and p.hotpath_lines == j.hotpath_lines
    n = len(src.splitlines())
    for line in range(0, n + 2):
        for rule in ("host-sync", "dtype-drift", "x", "tracer-leak"):
            assert p.suppressed(line, rule) == j.suppressed(line, rule)
    assert [(f.qualname, f.hotpath_marker) for f in p.functions] == \
        [(f.qualname, f.hotpath_marker) for f in j.functions]
    assert [f.calls for f in p.functions] == [f.calls for f in j.functions]
    roots = [f.qualname for f in j.functions] + [
        "Engine.step", "Engine._decode", "Engine._run_decode", "missing"]
    for k in range(len(roots)):
        assert p.reachable(roots[k:k + 2]) == j.reachable(roots[k:k + 2])
    markers = [f.qualname for f in j.functions if f.hotpath_marker]
    assert p.reachable(markers) == j.reachable(markers)


def test_registry_rejects_duplicates_and_lists_rules():
    assert tuple(lint.available()) == PORT_RULES
    with pytest.raises(ValueError):
        lint.register("host-sync")(lambda ctx: None)
    with pytest.raises(ValueError):
        lint.register("x", severity="fatal")
    with pytest.raises(ValueError):
        lint.register("x", scope="tree")


# ---------------------------------------------------------------------------
# host-sync: the reference's fixtures, translated
# ---------------------------------------------------------------------------

def test_host_sync_item_in_compiled_flagged(tmp_path):
    _, fs = same_lines(tmp_path, """
        import jax, jax.numpy as jnp

        @jax.jit
        def step(x):
            return jnp.sum(x).item()
        """, """
        import torch

        @torch.compile
        def step(x):
            return torch.sum(x).item()
        """, "host-sync", "host-sync")
    assert [f.rule for f in fs] == ["host-sync"]
    assert ".item()" in fs[0].message and fs[0].symbol == "step"
    assert "compiled body" in fs[0].message


def test_host_sync_clean_outside_hot_paths(tmp_path):
    same_lines(tmp_path, """
        import numpy as np

        def summarize(arr):
            return float(np.asarray(arr).mean())
        """, """
        import torch

        def summarize(t):
            return float(t.cpu().mean())
        """, "host-sync", "host-sync")


def test_host_sync_python_scalar_branch_ok(tmp_path):
    # a bool parameter of a compiled body is a Python value torch.compile
    # guards on, as a JAX static_argnames parameter: branching is fine
    _, fs = same_lines(tmp_path, """
        import functools, jax

        @functools.partial(jax.jit, static_argnames=("fast",))
        def f(x, fast=True):
            if fast:
                return x * 2
            return x + 1
        """, """
        import functools, torch

        @functools.partial(torch.compile, dynamic=False)
        def f(x, fast: bool = True):
            if fast:
                return x * 2
            return x + 1
        """, "host-sync", "host-sync", ref_rel="src/repro/kernels/x.py")
    assert fs == []


def test_host_sync_branch_on_tensor_flagged(tmp_path):
    ref, fs = same_lines(tmp_path, """
        import jax, jax.numpy as jnp

        @jax.jit
        def f(x):
            if x:
                return x * 2
            return x
        """, """
        import torch

        @torch.compile
        def f(x):
            if x:
                return x * 2
            return x
        """, "host-sync", "host-sync", ref_rel="src/repro/kernels/x.py")
    assert "branching on a traced value" in ref[0].message
    assert "branching on a device tensor" in fs[0].message


def test_host_sync_hotpath_marker_and_producer_taint(tmp_path):
    src = """
        import numpy as np

        class Engine:
            def step(self):  # lint: hotpath
                out = self._decode(1)
                toks = np.asarray(out)
                return toks
        """
    _, fs = same_lines(tmp_path, src, src, "host-sync", "host-sync")
    assert len(fs) == 1 and "np.asarray" in fs[0].message


def test_host_sync_allow_comment_suppresses(tmp_path):
    src = """
        import numpy as np

        class Engine:
            def step(self):  # lint: hotpath
                out = self._decode(1)
                toks = np.asarray(out)  # lint: allow[host-sync] one per step
                return toks
        """
    _, fs = same_lines(tmp_path, src, src, "host-sync", "host-sync")
    assert fs == []
    allowed = []
    fs = lint_tree(tmp_path / "a", {"src/repro_torch/serving/x.py": src},
                   rules=["host-sync"], allowed=allowed)
    assert fs == [] and lines_of(allowed) == [7]


# ---------------------------------------------------------------------------
# host-sync: the port's own cases
# ---------------------------------------------------------------------------

SYNCS = """
    import torch

    class Engine:
        def step(self, x, ev):  # lint: hotpath
            out = self._decode()
            a = out.item()
            b = out.tolist()
            c = out.cpu()
            d = int(out[0])
            if out.sum() > 0:
                pass
            torch.cuda.synchronize()
            ev.synchronize()
            e = out.to("cpu")
            f = self._decode().numpy()
            return a, b, c, d, e, f
    """


def test_host_sync_waits_flagged_at_their_lines(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": SYNCS},
                   rules=["host-sync"])
    assert lines_of(fs) == [7, 8, 9, 10, 11, 13, 14, 15, 16]
    assert all(f.symbol == "Engine.step" for f in fs)


def test_host_sync_host_metadata_and_laundered_values_clean(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import numpy as np
        import torch

        class Engine:
            def step(self, x):  # lint: hotpath
                out = self._decode()
                n, d = out.shape[0], out.size(1)
                k = len(out) + out.numel() + out.dim()
                if out is None or out.dtype == torch.int32:
                    pass
                s = torch.cuda.current_stream().cuda_stream
                if s:
                    pass
                h = out.cpu().numpy()  # lint: allow[host-sync] the one read
                if h[0] > 0:
                    k += int(h[1])
                return n, d, k, np.asarray(h)
        """}, rules=["host-sync"])
    assert fs == []


def test_host_sync_reassigned_name_read_before_its_rebinding(tmp_path):
    # ``toks = toks.cpu()`` reads the device tensor bound the line before
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        class Engine:
            def step(self):  # lint: hotpath
                toks = self._prefill()
                toks = toks.cpu().numpy()
                return int(toks[0])
        """}, rules=["host-sync"])
    assert lines_of(fs) == [5]


def test_host_sync_method_call_reported_at_its_attribute_line(tmp_path):
    # as the interpreter attributes the wait (a sync-debug warning's frame)
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        class Engine:
            def step(self, a, b):  # lint: hotpath
                toks = self._prefill(a,
                                     b).cpu()
                return toks
        """}, rules=["host-sync"])
    assert lines_of(fs) == [5]


def test_host_sync_pageable_upload_flagged(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import numpy as np
        import torch

        class Engine:
            def step(self, toks):  # lint: hotpath
                dev = self.device
                t = torch.from_numpy(toks).to(dev)
                u = torch.tensor(toks, device=dev)
                v = torch.as_tensor(np.ones(3), device="cuda")
                w = torch.from_numpy(toks).cuda()
                x = torch.from_numpy(toks).pin_memory().to(dev)
                return t, u, v, w, x
        """}, rules=["host-sync"])
    assert lines_of(fs) == [8, 9, 10, 11, 12]
    assert "pageable" in fs[0].message and "pageable" in fs[1].message
    assert "non_blocking" in fs[4].message


def test_host_sync_pinned_upload_clean(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import torch

        class Engine:
            def step(self, toks):  # lint: hotpath
                dev = self.device
                t = torch.from_numpy(toks).pin_memory().to(
                    dev, non_blocking=True)
                pinned = torch.from_numpy(toks).pin_memory()
                u = pinned.to(dev, non_blocking=True)
                c = torch.tensor(toks)
                z = torch.zeros(3, device=dev).to(torch.float32)
                return t, u, c, z
        """}, rules=["host-sync"])
    assert fs == []


def test_host_sync_data_dependent_shape_flagged(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import torch

        class Engine:
            def step(self):  # lint: hotpath
                x = self._decode()
                a = torch.nonzero(x)
                b = x[x > 0]
                c = x.unique()
                d = torch.where(x > 0)
                m = torch.isfinite(x)
                e = x[m]
                f = x.masked_select(m)
                return a, b, c, d, e, f
        """}, rules=["host-sync"])
    assert lines_of(fs) == [7, 8, 9, 10, 12, 13]
    assert all("from the data" in f.message for f in fs)


def test_host_sync_fixed_shape_ops_clean(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import torch

        class Engine:
            def step(self, idx):  # lint: hotpath
                x = self._decode()
                a = torch.where(x > 0, x, 0)
                b = x.masked_fill(x < 0, 0)
                c = x[idx]
                d = torch.gather(x, 0, idx)
                return a, b, c, d
        """}, rules=["host-sync"])
    assert fs == []


ENGINE_CALLING_HELPER = """
    from repro_torch.serving.util import helper, Packed

    class Engine:
        def step(self, w, x):
            y = helper(x)
            if isinstance(w, Packed):
                y = w.mm(y)
            return y
    """
UTIL = """
    class Packed:
        def mm(self, x):
            return x * x.sum().item()

    def helper(x):
        return x + x.max().item()

    def unrelated(x):
        return x.max().item()
    """


def test_host_sync_follows_calls_across_modules(tmp_path):
    fs = lint_tree(tmp_path, {
        "src/repro_torch/serving/engine.py": ENGINE_CALLING_HELPER,
        "src/repro_torch/serving/util.py": UTIL}, rules=["host-sync"])
    assert [(f.path, f.line, f.symbol) for f in fs] == [
        ("src/repro_torch/serving/util.py", 4, "Packed.mm"),
        ("src/repro_torch/serving/util.py", 7, "helper")]


def test_host_sync_no_root_no_cross_module_reach(tmp_path):
    # the same helper module beside an engine whose hot path never calls it
    fs = lint_tree(tmp_path, {
        "src/repro_torch/serving/engine.py": """
            class Engine:
                def step(self, x):
                    return x
            """,
        "src/repro_torch/serving/util.py": UTIL}, rules=["host-sync"])
    assert fs == []


def test_host_sync_kernel_dispatch_followed(tmp_path):
    # ``impl("name")`` returns ``getattr(ops, name)``: the wrapper is hot
    fs = lint_tree(tmp_path, {
        "src/repro_torch/kernels/__init__.py": """
            from repro_torch.kernels import ops

            def impl(name):
                return getattr(ops, name)
            """,
        "src/repro_torch/kernels/ops.py": """
            import torch

            def attn(q):
                return q * int(torch.amax(q))

            def unused(q):
                return int(torch.amax(q))
            """,
        "src/repro_torch/serving/engine.py": """
            from repro_torch.kernels import impl

            class Engine:
                def step(self, q):
                    return impl("attn")(q)
            """}, rules=["host-sync"])
    assert [(f.path, f.line) for f in fs] == [
        ("src/repro_torch/kernels/ops.py", 5)]


# ---------------------------------------------------------------------------
# rebuild-hazard (the reference's recompile-hazard)
# ---------------------------------------------------------------------------

def test_rebuild_compile_in_loop_flagged(tmp_path):
    _, fs = same_lines(tmp_path, """
        import jax

        def run(fns, x):
            out = []
            for f in fns:
                out.append(jax.jit(f)(x))
            return out
        """, """
        import torch

        def run(fns, x):
            out = []
            for f in fns:
                out.append(torch.compile(f)(x))
            return out
        """, "recompile-hazard", "rebuild-hazard",
        ref_rel="src/repro/core/x.py")
    assert [f.rule for f in fs] == ["rebuild-hazard"]
    assert "inside a loop" in fs[0].message


def test_rebuild_module_level_compile_ok(tmp_path):
    _, fs = same_lines(tmp_path, """
        import functools, jax

        @functools.partial(jax.jit, static_argnames=("k",))
        def f(x, k):
            return x[:k]

        def run(xs):
            return [f(x, k=4) for x in xs]
        """, """
        import functools, torch

        @functools.partial(torch.compile, dynamic=False)
        def f(x, k):
            return x[:k]

        def run(xs):
            return [f(x, k=4) for x in xs]
        """, "recompile-hazard", "rebuild-hazard",
        ref_rel="src/repro/core/x.py")
    assert fs == []


def test_rebuild_per_call_construction_flagged(tmp_path):
    # torch.compile has no static arguments; what keys a fresh program per
    # call in PyTorch is a construction on the hot path itself
    _, fs = same_lines(tmp_path, """
        import functools, jax

        @functools.partial(jax.jit, static_argnames=("shape",))
        def f(x, shape):
            return x.reshape(shape)

        def run(x):
            return f(x, shape=[4, 4])
        """, """
        import torch

        class Engine:
            def step(self, x):  # lint: hotpath
                return self.capture(x)

            def capture(self, x):
                return torch.cuda.CUDAGraph(), x
        """, "recompile-hazard", "rebuild-hazard",
        ref_rel="src/repro/core/x.py")
    assert "on a hot path" in fs[0].message


def test_rebuild_cuda_graph_in_loop_flagged_and_hoisted_clean(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import torch

        def replay_all(steps):
            for s in steps:
                g = torch.cuda.CUDAGraph()
                g.replay()

        def replay_hoisted(steps):
            g = torch.cuda.CUDAGraph()
            for s in steps:
                g.replay()
        """}, rules=["rebuild-hazard"])
    assert lines_of(fs) == [6] and "inside a loop" in fs[0].message


def test_rebuild_library_load_once_clean_per_step_flagged(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import ctypes
        import functools

        _LIB = None

        def library():
            global _LIB
            if _LIB is None:
                _LIB = ctypes.CDLL("k.so")
            return _LIB

        @functools.lru_cache(None)
        def cached():
            return ctypes.CDLL("k.so")

        class Engine:
            def step(self):  # lint: hotpath
                library(), cached()
                return ctypes.CDLL("k.so")
        """}, rules=["rebuild-hazard"])
    assert lines_of(fs) == [20] and "hot path" in fs[0].message


def test_rebuild_unbucketed_length_shape_warns(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/serving/x.py": """
        import torch

        class Engine:
            def step(self, reqs):  # lint: hotpath
                a = torch.zeros((len(reqs), 8), device=self.device)
                b = torch.zeros((self.bucket_for(len(reqs)), 8),
                                device=self.device)
                c = torch.zeros((len(reqs), 8))
                return a, b, c
        """}, rules=["rebuild-hazard"])
    assert lines_of(fs) == [6] and fs[0].severity == "warning"


# ---------------------------------------------------------------------------
# graph-leak (the reference's tracer-leak)
# ---------------------------------------------------------------------------

def test_graph_leak_self_assignment_flagged(tmp_path):
    _, fs = same_lines(tmp_path, """
        import jax, jax.numpy as jnp

        class M:
            def go(self, x):
                @jax.jit
                def inner(x):
                    z = jnp.exp(x)
                    self.cache = z
                    return z
                return inner(x)
        """, """
        import torch
        from torch.utils.checkpoint import checkpoint
        class M:
            def go(self, x):
                # backward runs inner again
                def inner(x):
                    z = torch.exp(x)
                    self.cache = z
                    return z
                return checkpoint(inner, x, use_reentrant=False)
        """, "tracer-leak", "graph-leak")
    assert [f.rule for f in fs] == ["graph-leak"]
    assert "self.cache" in fs[0].message


def test_graph_leak_out_parameter_store_is_fine(tmp_path):
    # the reference's Pallas write idiom; in torch, writes into a tensor
    # that was passed in
    _, fs = same_lines(tmp_path, """
        import jax.numpy as jnp
        from jax.experimental import pallas as pl

        def kern(x_ref, o_ref):
            acc = x_ref[...] * 2
            o_ref[...] = acc

        def call(x, spec):
            return pl.pallas_call(kern, out_shape=spec)(x)
        """, """
        import torch

        class Double(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, out):
                acc = x * 2
                out[...] = acc
                out.copy_(acc)
                return out
        """, "tracer-leak", "graph-leak", ref_rel="src/repro/kernels/x.py")
    assert fs == []


def test_graph_leak_checkpointed_side_effects(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/models/x.py": """
        import torch
        from torch.utils.checkpoint import checkpoint

        SEEN = []
        COUNT = 0

        def body(h, acts):
            global COUNT
            COUNT += 1
            acts.append(h)
            SEEN.append(h)
            local = []
            local.append(h)
            return torch.tanh(h)

        def run(h, acts):
            return checkpoint(body, h, acts, use_reentrant=False)
        """}, rules=["graph-leak"])
    assert lines_of(fs) == [10, 11, 12]
    assert [f.severity for f in fs] == ["error", "warning", "warning"]
    assert "COUNT" in fs[0].message


def test_graph_leak_clean_checkpoint_and_cache_fill(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/models/x.py": """
        import torch
        from torch.utils.checkpoint import checkpoint

        _TABLE = None

        def table():
            global _TABLE
            if _TABLE is None:
                _TABLE = torch.arange(4)
            return _TABLE

        def body(h):
            ys = []
            for i in range(2):
                ys.append(h * table()[i])
            return torch.stack(ys)

        def run(h):
            return checkpoint(body, h, use_reentrant=False)
        """}, rules=["graph-leak"])
    assert fs == []


def test_graph_leak_reaches_subclass_block_through_self(tmp_path):
    # checkpoint(self._block_out) in the base class runs every subclass's
    # _block, in another module
    files = {
        "src/repro_torch/models/base.py": """
            from torch.utils.checkpoint import checkpoint

            class Model:
                def _block_out(self, h):
                    return self._block(h)

                def run(self, h):
                    return checkpoint(self._block_out, h,
                                      use_reentrant=False)
            """,
        "src/repro_torch/models/sub.py": """
            from repro_torch.models import base as B

            class Sub(B.Model):
                def _block(self, h):
                    self.last = h
                    return h
            """,
        "src/repro_torch/models/other.py": """
            from repro_torch.models import base as B

            class Other(B.Model):
                def _block(self, h):
                    return h

                def summary(self, h):
                    self.last = h
            """}
    fs = lint_tree(tmp_path, files, rules=["graph-leak"])
    assert [(f.path, f.line) for f in fs] == [
        ("src/repro_torch/models/sub.py", 6)]


def test_graph_leak_ctx_attribute_flagged_save_for_backward_clean(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/kernels/x.py": """
        import torch

        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, w):
                y = x * w
                ctx.y = y
                ctx.w2 = torch.exp(w)
                ctx.save_for_backward(x, w)
                ctx.scale = 2.0
                ctx.shape = x.shape
                return y

            @staticmethod
            def backward(ctx, g):
                x, w = ctx.saved_tensors
                return g * w, g * x
        """}, rules=["graph-leak"])
    assert lines_of(fs) == [8, 9]
    assert all("save_for_backward" in f.message for f in fs)


# ---------------------------------------------------------------------------
# dtype-drift
# ---------------------------------------------------------------------------

F64_ZEROS = """
    import torch

    def make(n):
        return torch.zeros((n,), dtype=torch.float64)
    """


def test_dtype_drift_f64_flagged(tmp_path):
    _, fs = same_lines(tmp_path, """
        import jax.numpy as jnp

        def make(n):
            return jnp.zeros((n,), dtype=jnp.float64)
        """, F64_ZEROS, "dtype-drift", "dtype-drift",
        ref_rel="src/repro/models/layers.py")
    assert len(fs) == 1 and "float64" in fs[0].message
    assert run_fixture(F64_ZEROS, "make", 3).dtype == torch.float64


DOUBLE = """
    def widen(x):
        return x.double()
    """


def test_dtype_drift_double_flagged_anywhere(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/core/x.py": DOUBLE},
                   rules=["dtype-drift"])
    assert lines_of(fs) == [3] and ".double()" in fs[0].message
    assert run_fixture(DOUBLE, "widen", torch.ones(2)).dtype == torch.float64


def test_dtype_drift_host_numpy_f64_ok(tmp_path):
    src = """
        import numpy as np

        def hinv(c):
            h = np.array(c, dtype=np.float64, copy=True)
            return np.linalg.inv(h)
        """
    _, fs = same_lines(tmp_path, src, src, "dtype-drift", "dtype-drift",
                       ref_rel="src/repro/core/baselines/x.py")
    assert fs == []


NP_SCALAR = """
    import numpy as np

    def scale(x):
        return x * np.float32(2.0)
    """
PROMOTES = """
    import torch

    def scale(x):
        y = x.bfloat16()
        return y * torch.ones(y.shape[-1])
    """


def test_dtype_drift_promotion_is_torchs_not_jaxs(tmp_path):
    # JAX promotes bf16 * np.float32(2.0) to f32; torch keeps bf16, so the
    # port clears the reference's true positive and flags what torch
    # promotes: a bf16 tensor meeting an f32 tensor of one or more dims
    ref = ref_tree(tmp_path / "ref", {"src/repro/models/layers.py":
                                      NP_SCALAR}, rules=["dtype-drift"])
    assert lines_of(ref) == [5] and "strong-typed" in ref[0].message
    fs = lint_tree(tmp_path / "a", {"src/repro_torch/models/layers.py":
                                    NP_SCALAR}, rules=["dtype-drift"])
    assert fs == []
    x = torch.ones(4, dtype=torch.bfloat16)
    assert run_fixture(NP_SCALAR, "scale", x).dtype == torch.bfloat16
    fs = lint_tree(tmp_path / "b", {"src/repro_torch/models/layers.py":
                                    PROMOTES}, rules=["dtype-drift"])
    assert lines_of(fs) == [6] and "promotes" in fs[0].message
    assert run_fixture(PROMOTES, "scale", torch.ones(4)).dtype == \
        torch.float32


@pytest.mark.parametrize("expr", [
    "y * 2.0", "y * torch.tensor(2.0)", "y * torch.ones(())",
    "y * torch.ones(4, dtype=torch.bfloat16)", "y + y"])
def test_dtype_drift_bf16_kept_clean(tmp_path, expr):
    src = f"""
        import torch

        def scale(x):
            y = x.bfloat16()
            return {expr}
        """
    fs = lint_tree(tmp_path, {"src/repro_torch/models/layers.py": src},
                   rules=["dtype-drift"])
    assert fs == []
    assert run_fixture(src, "scale", torch.ones(4)).dtype == torch.bfloat16


def test_dtype_drift_promotion_checked_only_in_sensitive_files(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/core/x.py": PROMOTES},
                   rules=["dtype-drift"])
    assert fs == []


# ---------------------------------------------------------------------------
# register-contract: the reference's fixtures with the port's imports
# ---------------------------------------------------------------------------

def test_register_contract_bad_return_flagged(tmp_path):
    _, fs = same_lines(tmp_path, """
        from repro.core import registry as _registry

        @_registry.register("bad", spec_cls=None)
        def bad(w, stats, spec):
            return w * 2
        """, """
        from repro_torch.core import registry as _registry

        @_registry.register("bad", spec_cls=None)
        def bad(w, stats, spec):
            return w * 2
        """, "register-contract", "register-contract",
        ref_rel="src/repro/core/x.py")
    assert len(fs) == 1 and "not a CompressResult" in fs[0].message


def test_register_contract_helper_indirection_ok(tmp_path):
    src = """
        from {pkg}.core import registry as _registry

        def _wrap(res):
            return _registry.CompressResult(theta=res)

        @_registry.register("direct", spec_cls=None)
        def direct(w, stats, spec):
            return _registry.CompressResult(theta=w)

        @_registry.register("via_helper", spec_cls=None)
        def via_helper(w, stats, spec):
            return _wrap(w)
        """
    _, fs = same_lines(tmp_path, src.format(pkg="repro"),
                       src.format(pkg="repro_torch"), "register-contract",
                       "register-contract", ref_rel="src/repro/core/x.py")
    assert fs == []


def test_register_contract_batched_returns_a_list(tmp_path):
    fs = lint_tree(tmp_path, {"src/repro_torch/core/x.py": """
        from repro_torch.core import registry as _registry

        @_registry.register_batched("good")
        def good(w_b, c_b, stats_b, spec):
            return [_registry.CompressResult(theta=w) for w in w_b]

        @_registry.register_batched("bad")
        def bad(w_b, c_b, stats_b, spec):
            return _registry.CompressResult(theta=w_b)
        """}, rules=["register-contract"])
    assert lines_of(fs) == [10] and "a list of CompressResult" in \
        fs[0].message


def test_register_contract_each_package_core_clean():
    ref = jlint.run_lint(REPO, None, paths=[os.path.join(REPO, "src",
                                                         "repro", "core")],
                         rules=["register-contract"])
    port = lint.run_lint(REPO, None, paths=[os.path.join(
        REPO, "src", "repro_torch", "core")], rules=["register-contract"])
    assert ref == [] and port == []
    n = sum(1 for f in lint.discover(REPO, lint.LintConfig(), [os.path.join(
        REPO, "src", "repro_torch", "core")])
        if "@registry.register" in Path(REPO, f).read_text()
        or "@_registry.register" in Path(REPO, f).read_text())
    assert n >= 5          # the adapters the rule checked


# ---------------------------------------------------------------------------
# metrics-contract
# ---------------------------------------------------------------------------

def _uses(extract, module_cls, path):
    rel = os.path.relpath(path, REPO).replace(os.sep, "/")
    mod = module_cls(path, rel, Path(path).read_text())
    return {(u.kind, u.name, u.exact) for u in extract(mod)}


def test_metric_extraction_of_the_reference_engine_equal():
    path = os.path.join(REPO, "src", "repro", "serving", "engine.py")
    got = _uses(extract_metric_uses, Module, path)
    assert got == _uses(j_extract, JModule, path) and len(got) >= 20


# families the port registers and the reference does not, and the other
# way round, each with the reason (none today: the port registers the same
# families under the same names)
PORT_ONLY: dict = {}
REF_ONLY: dict = {}
DRIVERS = (("serving", "engine.py"), ("core", "compress.py"),
           ("core", "batched.py"))


def test_metric_families_of_port_drivers_equal_references():
    port, ref = set(), set()
    for sub, name in DRIVERS:
        port |= _uses(extract_metric_uses, Module,
                      os.path.join(REPO, "src", "repro_torch", sub, name))
        ref |= _uses(j_extract, JModule,
                     os.path.join(REPO, "src", "repro", sub, name))
    assert port - ref == set(PORT_ONLY) and ref - port == set(REF_ONLY)
    assert all(exact for _, _, exact in port)


def test_port_schema_families_equal_references():
    port = load_schema_families(os.path.join(REPO, PORT_SCHEMA))
    ref = j_families(os.path.join(REPO, "scripts", "metrics_schema.json"))
    for kind in ("counters", "gauges", "histograms"):
        only_port = {n for k, n, _ in PORT_ONLY if k == kind}
        only_ref = {n for k, n, _ in REF_ONLY if k == kind}
        assert set(port[kind]) - only_port == set(ref[kind]) - only_ref


def test_metrics_contract_bidirectional(tmp_path):
    schema = {"families": {"counters": ["good_total", "ghost_total"],
                           "gauges": [], "histograms": []}}
    fs = lint_tree(tmp_path, {"src/repro_torch/obs/x.py": """
        def setup(m):
            m.counter("good_total", "declared")
            m.counter("rogue_total", "not declared")
        """}, schema=schema, rules=["metrics-contract"])
    msgs = " | ".join(f.message for f in fs)
    assert "rogue_total" in msgs                   # code -> schema
    assert "ghost_total" in msgs                   # schema -> code
    assert "good_total" not in msgs


def test_metrics_contract_partial_run_checks_code_to_schema_only(tmp_path):
    # a run over explicit paths cannot see every registration: the schema's
    # other families are not reported (the reference reports them)
    schema = {"families": {"counters": ["a_total", "b_total"],
                           "gauges": [], "histograms": []}}
    files = {"src/repro_torch/obs/a.py": """
                 def setup(m):
                     m.counter("a_total", "a")
                 """,
             "src/repro_torch/obs/b.py": """
                 def setup(m):
                     m.counter("b_total", "b")
                     m.counter("rogue_total", "not declared")
                 """}
    _write(tmp_path, files, PORT_SCHEMA, schema)
    a = str(tmp_path / "src/repro_torch/obs/a.py")
    assert lint.run_lint(str(tmp_path), paths=[a],
                         rules=["metrics-contract"]) == []
    b = str(tmp_path / "src/repro_torch/obs/b.py")
    fs = lint.run_lint(str(tmp_path), paths=[b], rules=["metrics-contract"])
    assert [f.message.split("'")[1] for f in fs] == ["rogue_total"]
    ref_a = tmp_path / "src/repro/obs/a.py"
    _write(tmp_path, {"src/repro/obs/a.py": files["src/repro_torch/obs/a.py"]},
           "scripts/metrics_schema.json", schema)
    ref = jlint.run_lint(str(tmp_path), paths=[str(ref_a)],
                         rules=["metrics-contract"])
    assert ["b_total" in f.message for f in ref] == [True]


IDIOMS = """
    _HELP = (("gamma", "g"), ("delta", "d"))

    def setup(m):
        def counter(key, help):
            return m.counter(f"engine_{key}_total", help)
        c = {k: counter(k, h) for k, h in (
            ("alpha", "a"), ("beta", "b"))}
        d = {k: counter(k, h) for k, h in _HELP}
        m.histogram("lat_seconds", "latency")
        m.gauge(f"pool_{m.name}_pages", "pattern")
        return c, d
    """


def test_metric_extraction_resolves_engine_idioms():
    src = textwrap.dedent(IDIOMS)
    uses = {(u.kind, u.name, u.exact) for u in
            extract_metric_uses(Module("x.py", "x.py", src))}
    ref = {(u.kind, u.name, u.exact) for u in
           j_extract(JModule("x.py", "x.py", src))}
    shared = {("counters", "engine_alpha_total", True),
              ("counters", "engine_beta_total", True),
              ("histograms", "lat_seconds", True),
              ("gauges", "pool_*_pages", False)}
    assert shared <= uses and shared <= ref
    # the port's engine keeps its counter table in a module-level tuple
    assert {("counters", "engine_gamma_total", True),
            ("counters", "engine_delta_total", True)} <= uses - ref


# ---------------------------------------------------------------------------
# kernel-abi: the real seam, and seeded faults on copies of it
# ---------------------------------------------------------------------------

KERNEL_FILES = ["src/repro_torch/kernels/_build.py",
                "src/repro_torch/kernels/ops.py"] + sorted(
    p.relative_to(REPO).as_posix() for p in
    Path(REPO, "src", "repro_torch", "kernels", "csrc").glob("*.cu"))


def _kernel_copy(tmp_path, rel=None, old=None, new=None):
    """Copy the real kernel seam under ``tmp_path``, with ``old`` replaced
    by ``new`` once in ``rel``; returns the 1-based line of the edit."""
    for f in KERNEL_FILES:
        dst = tmp_path / f
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(REPO, f), dst)
    if rel is None:
        return None
    text = (tmp_path / rel).read_text()
    assert text.count(old) == 1, (rel, old)
    (tmp_path / rel).write_text(text.replace(old, new))
    return text[:text.index(old)].count("\n") + 1


def _abi(tmp_path):
    return lint.run_lint(str(tmp_path), None, rules=["kernel-abi"])


def test_kernel_abi_real_tree_clean(tmp_path):
    assert lint.run_lint(REPO, None, rules=["kernel-abi"]) == []
    _kernel_copy(tmp_path)
    assert _abi(tmp_path) == []


SEEDED = {
    "argtype dropped": (
        "src/repro_torch/kernels/_build.py",
        '"quant_project_f32": ([_P, _P, _I, _I, _I, _I, _P], _I)',
        '"quant_project_f32": ([_P, _P, _I, _I, _I, _P], _I)',
        "declares 6 argtypes"),
    "int turned into long long": (
        "src/repro_torch/kernels/csrc/quant_proj.cu",
        'extern "C" int quant_project_f32(const float* z, float* out, '
        'int rows',
        'extern "C" int quant_project_f32(const float* z, float* out, '
        'long long rows', "'long long' here but 'int'"),
    "launch on stream 0": (
        "src/repro_torch/kernels/csrc/kv_dequant.cu",
        "<<<blocks, THREADS, 0, (cudaStream_t)stream>>>",
        "<<<blocks, THREADS, 0, 0>>>", "legacy default stream"),
    "launched with twice its bound": (
        "src/repro_torch/kernels/csrc/quant_proj.cu",
        "<<<blocks, THREADS, 0, (cudaStream_t)stream>>>",
        "<<<blocks, 2 * THREADS, 0, (cudaStream_t)stream>>>",
        "__launch_bounds__(256) but is launched with 512"),
    "64 KB dynamic without the attribute": (
        "src/repro_torch/kernels/csrc/kv_dequant.cu",
        "<<<blocks, THREADS, 0, (cudaStream_t)stream>>>",
        "<<<blocks, THREADS, 64 * 1024, (cudaStream_t)stream>>>",
        "65536 bytes of dynamic shared memory"),
    "entry returns 0": (
        "src/repro_torch/kernels/csrc/kv_dequant.cu",
        "  return (int)cudaGetLastError();", "  return 0;",
        "returns 0"),
}


@pytest.mark.parametrize("fault", sorted(SEEDED))
def test_kernel_abi_seeded_fault_flagged_at_its_line(tmp_path, fault):
    rel, old, new, says = SEEDED[fault]
    line = _kernel_copy(tmp_path, rel, old, new)
    hits = [f for f in _abi(tmp_path) if f.path == rel and f.line == line]
    assert len(hits) == 1 and says in hits[0].message, _abi(tmp_path)


def test_kernel_abi_text_allow_comment(tmp_path):
    # ``// lint: allow[kernel-abi] reason`` accepts a finding in a source
    rel, old, new, _ = SEEDED["launch on stream 0"]
    line = _kernel_copy(tmp_path, rel, old, new + "  // lint: "
                        "allow[kernel-abi] a test's seeded launch")
    allowed = []
    assert lint.run_lint(str(tmp_path), None, rules=["kernel-abi"],
                         allowed=allowed) == []
    assert [(f.path, f.line) for f in allowed] == [(rel, line)]


def test_kernel_abi_launch_count_and_orphan_entry(tmp_path):
    # a _launch passing one argument too few, and an extern "C" entry
    # that SIGNATURES does not declare
    rel = "src/repro_torch/kernels/ops.py"
    _kernel_copy(tmp_path)
    text = (tmp_path / rel).read_text()
    m = re.search(r'_launch\("quant_project", "quant_project_f32", ', text)
    assert m is not None
    call_line = text[:m.start()].count("\n") + 1
    (tmp_path / rel).write_text(text[:m.end()] + text[m.end():].replace(
        "z.data_ptr(),", "", 1))
    cu = tmp_path / "src/repro_torch/kernels/csrc/kv_dequant.cu"
    cu.write_text(cu.read_text() + '\nextern "C" int orphan(int n) '
                  '{ return n; }\n')
    fs = _abi(tmp_path)
    assert [(f.path, f.line) for f in fs] == sorted([
        (rel, call_line),
        ("src/repro_torch/kernels/csrc/kv_dequant.cu",
         len(cu.read_text().splitlines()))])
    msgs = {f.path: f.message for f in fs}
    assert "passes 5 arguments; SIGNATURES declares 6" in msgs[rel]
    assert "orphan has no SIGNATURES row" in msgs[
        "src/repro_torch/kernels/csrc/kv_dequant.cu"]


# ---------------------------------------------------------------------------
# the port's tree: allow comments, and the CLI gate
# ---------------------------------------------------------------------------

def _allow_comments():
    """(path, line, text) of every ``# lint: allow`` comment token in the
    port (comments only: the analyzer's docstrings quote the syntax)."""
    out = []
    for rel in lint.discover(REPO, lint.LintConfig()):
        text = Path(REPO, rel).read_text()
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT and re.search(
                    r"#\s*lint:\s*allow", tok.string):
                out.append((rel, tok.start[0], tok.string))
    return out


def test_every_allow_comment_names_its_rules_and_a_reason():
    comments = _allow_comments()
    assert len(comments) >= 11
    for rel, line, text in comments:
        m = re.search(r"allow\[([^\]]+)\]\s*(.*)$", text)
        assert m is not None, (rel, line, text)
        assert set(r.strip() for r in m.group(1).split(",")) <= \
            set(PORT_RULES), (rel, line)
        assert len(m.group(2).split()) >= 3, (rel, line, text)


def test_port_tree_allowed_host_syncs_are_the_designed_transfers():
    allowed = []
    assert lint.run_lint(REPO, None, allowed=allowed) == []
    sync = {(f.path, f.symbol) for f in allowed if f.rule == "host-sync"}
    assert sync == {
        ("src/repro_torch/serving/engine.py", "Engine.step"),
        ("src/repro_torch/serving/engine.py", "Engine._run_prefill_batch"),
        ("src/repro_torch/serving/engine.py", "Engine._run_chunked"),
        ("src/repro_torch/serving/engine.py", "Engine._dispatch_pending"),
        ("src/repro_torch/serving/engine.py", "Engine._admit_stream"),
        ("src/repro_torch/device.py", "to_host")}
    by_rule = {}
    for f in allowed:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    assert by_rule == {"host-sync": 6, "dtype-drift": 4, "graph-leak": 1}


def test_cli_whole_tree_clean_modulo_baseline(capsys):
    """The gate: linting the port with its empty baseline is clean — a new
    hazard anywhere in src/repro_torch fails here first."""
    assert cli(["--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["new"] == 0 and report["counts"]["stale"] == 0
    assert report["counts"]["baselined"] == 0 and report["baselined"] == []
    assert report["counts"]["files"] >= 80
    assert json.loads(Path(REPO, "src", "repro_torch", "lint",
                           "baseline.json").read_text())["findings"] == []


def test_cli_seeded_violation_exits_nonzero(tmp_path):
    bad = tmp_path / "seeded.py"
    bad.write_text(textwrap.dedent("""
        import torch

        @torch.compile
        def step(x):
            return torch.sum(x).item()
        """))
    assert cli([str(bad)]) == 1


def test_cli_update_baseline_then_clean(tmp_path, capsys):
    root = tmp_path
    (root / "src/repro_torch").mkdir(parents=True)
    _write(root, {}, PORT_SCHEMA, None)
    (root / "src/repro_torch/x.py").write_text(textwrap.dedent("""
        import torch

        @torch.compile
        def step(x):
            return torch.sum(x).item()
        """))
    args = ["--root", str(root), "--baseline", "lint_baseline.json"]
    assert cli(args) == 1                       # new finding
    assert cli(args + ["--update-baseline"]) == 0
    assert cli(args) == 0                       # baselined now
    report = root / "report.json"
    assert cli(args + ["--no-baseline", "--format", "json",
                       "--output", "report.json"]) == 1
    data = json.loads(report.read_text())
    assert data["counts"]["new"] == 1
    assert data["new"][0]["rule"] == "host-sync"
    # the code is fixed: the baseline entry goes stale, and a full run fails
    (root / "src/repro_torch/x.py").write_text("def step(x):\n    return x\n")
    assert cli(args) == 1
    assert "stale" in capsys.readouterr().out
    assert cli(args + ["--update-baseline"]) == 0 and cli(args) == 0


def test_cli_list_rules(capsys):
    assert cli(["--list-rules"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == list(PORT_RULES)
    assert all("[module]" in line or "[project]" in line for line in out)


def test_analyzer_imports_nothing_of_jax_or_the_reference():
    # the standard library only: not jax, not repro, not even torch
    for path in Path(REPO, "src", "repro_torch", "lint").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro", "torch",
                                               "numpy"), (path, n)


# ---------------------------------------------------------------------------
# chip_smoke.py: each host wait's site, from the stack when it warns
# ---------------------------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_host_waits_capture_the_innermost_port_frame():
    cs = _chip_smoke()
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        set_sync_debug_mode=lambda mode: None))
    code = ("import warnings\n"
            "def outer(msg):\n"
            "    return inner(msg)\n"
            "def inner(msg):\n"
            "    warnings.warn(msg)\n")
    ns = {}
    exec(compile(code, str(cs.SRC / "repro_torch" / "probe.py"), "exec"), ns)
    shown = warnings.showwarning
    with cs.host_waits(fake, True) as w:
        ns["outer"]("x " + cs.SYNC_WARNING)
        warnings.warn("not a wait")
        warnings.warn(cs.SYNC_WARNING)
    assert warnings.showwarning is shown
    assert w["sites"] == [("src/repro_torch/probe.py", 5), None]
    assert len(w["syncs"]) == 2 and w["other"] == 1
    with cs.host_waits(fake, False) as off:
        pass
    assert off["sites"] == [] and off["syncs"] == []


def test_wait_sites_held_to_the_rule():
    cs = _chip_smoke()
    saved = cs.LINT_SITES
    try:
        cs.LINT_SITES = None
        sites = _sync_sites()
        cs.check_wait_sites(sorted(sites), "probe")
        assert cs.LINT_SITES == sites
        with pytest.raises(SystemExit):
            cs.check_wait_sites([("src/repro_torch/serving/engine.py", 1)],
                                "probe")
        with pytest.raises(SystemExit):
            cs.check_wait_sites([None], "probe")
    finally:
        cs.LINT_SITES = saved


def _sync_sites():
    allowed = []
    lint.run_lint(REPO, None, rules=["host-sync"], allowed=allowed)
    return {(f.path, f.line) for f in allowed}
