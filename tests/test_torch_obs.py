"""The port's telemetry (``repro_torch.obs``) against the JAX package's
(``repro.obs``) on the CPU.

- The same counter, gauge and histogram operations through both registries
  give equal ``snapshot()`` dicts, identical Prometheus text and equal
  quantile estimates; the same event lists give the same spans and the
  same ``TraceError`` cases.
- Under ``FaultPlan(slow_step_s=1.0)`` (one virtual second a step) the JAX
  engines and the port's, on the bridged tiny llama32 and the same numpy
  prompts, give equal ``Trace.events`` for every request and equal
  registry snapshots (counters, gauges, histogram buckets, sums and
  counts): the slot and paged layouts, a preemption and resume, prefix
  hits, and the ok, cancelled, rejected, deadline and error statuses.
- A disabled registry changes no token and no dispatch counter.
- ``compress_model(metrics=...)`` records the same layer, iteration,
  residual and bucket counts in both packages.
- The port's serve and compress CLIs write ``--metrics-json`` files that
  pass ``scripts/check_metrics_schema.py`` with the require lists of CI's
  metrics step, and their profiler windows write Chrome traces with one
  ``ProfilerStep`` span an engine step.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as obs
from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.models import build_model as jbuild
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import GenerationRequest as JRequest
from repro.serving import SamplingParams as JSampling
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import specs
from repro_torch.core.compress import compress_model
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.launch import compress as compress_cli, serve as serve_cli
from repro_torch.models import build_model
from repro_torch.serving import (Engine, EngineConfig, FaultPlan,
                                 GenerationRequest, SamplingParams)

ARCH = "llama32-1b"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

# one sequence of observations a histogram family, across its buckets, the
# overflow slot and a bound hit exactly
HISTS = (
    ("request_ttft_seconds", None, "seconds",
     (1e-5, 1e-4, 3e-4, 0.02, 0.5, 7.0, 1e4)),
    ("compress_pgd_iters", "ITER_BUCKETS", "", (1, 3, 200, 1024, 5000)),
    ("compress_residual", "RESIDUAL_BUCKETS", "",
     (1e-7, 3e-3, 0.09, 0.1, 200.0)),
    ("lat", (0.1, 1.0, 10.0), "", (0.05, 0.5, 0.5, 5.0, 50.0)),
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive_registry(mod, enabled):
    """The same operations through one package's registry."""
    reg = mod.MetricsRegistry(enabled=enabled)
    c = reg.counter("engine_requests_total", "terminal results by status",
                    labelnames=("layout", "status"))
    c.labels(layout="slots", status="ok").inc()
    c.labels(layout="slots", status="ok").inc(2.5)
    c.labels(layout='pa"g\\ed', status="err\nor").inc(4)  # escaping
    reg.counter("plain_total", "no labels").inc(3)
    g = reg.gauge("engine_queue_depth", "backlog", labelnames=("kv",),
                  trace_capacity=3)
    for v in (1, 5, 2, 4, 0):
        g.labels(kv="int8").set(v)
    g.labels(kv="int8").set_value(9)
    reg.gauge("engine_slots_active", "slots").set(1.5)
    for name, buckets, unit, values in HISTS:
        if buckets is None:
            b = mod.LATENCY_BUCKETS
        elif isinstance(buckets, str):
            b = getattr(mod, buckets)
        else:
            b = buckets
        h = reg.histogram(name, f"help of {name}", labelnames=("method",),
                          unit=unit, buckets=b)
        for v in values:
            h.labels(method="awp_quant").observe(v)
    reg.histogram("never_observed", "zero count").labels()
    return reg


@pytest.mark.parametrize("enabled", [True, False])
def test_registry_snapshot_and_exposition_equal_the_reference(enabled,
                                                              tmp_path):
    reg, jreg = _drive_registry(obs, enabled), _drive_registry(jobs, enabled)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert snap == jsnap
    text = reg.to_prometheus()
    assert text == jreg.to_prometheus()
    assert obs.parse_exposition(text) == jobs.parse_exposition(text)
    for name, *_ in HISTS:
        e = obs.snapshot_series(snap, "histograms", name,
                                {"method": "awp_quant"})
        assert e == jobs.snapshot_series(jsnap, "histograms", name,
                                         {"method": "awp_quant"})
        child = reg.get(name).labels(method="awp_quant")
        jchild = jreg.get(name).labels(method="awp_quant")
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert obs.hist_quantile(e, q) == jobs.hist_quantile(e, q)
            assert child.quantile(q) == jchild.quantile(q)
    for side, r in (("port", reg), ("jax", jreg)):
        r.dump_json(str(tmp_path / f"{side}.json"), meta={"source": "t"})
        r.append_jsonl(str(tmp_path / f"{side}.jsonl"), extra={"step": 1})
    for ext in ("json", "jsonl"):
        assert (tmp_path / f"port.{ext}").read_text() == \
            (tmp_path / f"jax.{ext}").read_text()
    reg.reset()
    jreg.reset()
    assert reg.snapshot() == jreg.snapshot()


def test_registry_constants_ring_and_errors_match_the_reference():
    for name in ("LATENCY_BUCKETS", "ITER_BUCKETS", "RESIDUAL_BUCKETS"):
        assert getattr(obs, name) == getattr(jobs, name)
    assert obs.__all__ == jobs.__all__
    rb, jrb = obs.RingBuffer(2), jobs.RingBuffer(2)
    for v in range(5):
        rb.append(v)
        jrb.append(v)
    assert rb.values() == jrb.values() == [3, 4]
    assert rb.dropped == jrb.dropped == 3 and len(rb) == len(jrb)
    assert obs.default_registry() is obs.default_registry()
    assert not isinstance(obs.default_registry(), jobs.MetricsRegistry)
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        fam = reg.counter("c_total", "c", labelnames=("kind",))
        with pytest.raises(ValueError):
            reg.gauge("c_total")
        with pytest.raises(ValueError):
            fam.labels(wrong="a")
        with pytest.raises(ValueError):
            fam.labels(kind="a").inc(-1)
        with pytest.raises(ValueError):
            reg.histogram("h", buckets=(1.0, 1.0))
        with pytest.raises(ValueError):
            mod.RingBuffer(0)


# ---------------------------------------------------------------------------
# traces (the event lists of tests/test_obs.py)
# ---------------------------------------------------------------------------

VALID = {
    "ok": [("submit", 0), ("admitted", 1), ("first_token", 1), ("end:ok", 3)],
    "length": [("submit", 0), ("admitted", 1), ("first_token", 2),
               ("end:length", 4)],
    "eos": [("submit", 0), ("admitted", 1), ("first_token", 1),
            ("end:eos", 2)],
    "cancelled": [("submit", 0), ("end:cancelled", 1)],
    "deadline": [("submit", 0), ("admitted", 1), ("end:deadline", 3)],
    "rejected": [("submit", 0), ("end:rejected", 0)],
    "error": [("submit", 0), ("admitted", 1), ("first_token", 1),
              ("preempt", 2), ("resume", 3), ("end:error", 4)],
    "preempt_at_end": [("submit", 0), ("admitted", 1), ("first_token", 1),
                       ("preempt", 2), ("end:cancelled", 5)],
    "open": [("submit", 0), ("admitted", 2)],
}
INVALID = {
    "no_submit": [("admitted", 0), ("end:ok", 1)],
    "no_admitted": [("submit", 0), ("first_token", 1), ("end:ok", 2)],
    "not_monotone": [("submit", 0), ("admitted", 2), ("first_token", 1),
                     ("end:ok", 3)],
    "ok_without_token": [("submit", 0), ("admitted", 1), ("end:ok", 2)],
    "rejected_after_admission": [("submit", 0), ("admitted", 1),
                                 ("end:rejected", 2)],
    "preempt_before_admitted": [("submit", 0), ("preempt", 1),
                                ("end:cancelled", 2)],
    "nested_preempt": [("submit", 0), ("admitted", 1), ("first_token", 1),
                       ("preempt", 2), ("preempt", 3), ("end:error", 4)],
    "dangling_resume": [("submit", 0), ("admitted", 1), ("first_token", 1),
                        ("resume", 2), ("end:error", 3)],
    "two_terminals": [("submit", 0), ("end:ok", 1), ("end:ok", 2)],
    "two_submits": [("submit", 0), ("submit", 1), ("end:cancelled", 2)],
    "unknown_status": [("submit", 0), ("end:wat", 1)],
    "never_terminal": [("submit", 0)],
}


def _trace(mod, events):
    tr = mod.Trace(7, events[0][1])
    tr.events[0] = (events[0][0], float(events[0][1]))
    for name, t in events[1:]:
        tr.stamp(name, t)
    return tr


def _spans(tr):
    return [(s.name, s.start, s.end, s.duration) for s in tr.spans()]


@pytest.mark.parametrize("case", sorted(VALID))
def test_trace_spans_equal_the_reference(case):
    tr, jtr = _trace(obs, VALID[case]), _trace(jobs, VALID[case])
    assert _spans(tr) == _spans(jtr)
    assert (tr.status, tr.done, tr.asdict()) == \
        (jtr.status, jtr.done, jtr.asdict())
    for ev in ("admitted", "first_token", "preempt", "resume"):
        assert tr.first(ev) == jtr.first(ev)
    if tr.done:
        assert tr.validate() and jtr.validate()
    assert obs.TERMINAL_STATUSES == jobs.TERMINAL_STATUSES


@pytest.mark.parametrize("case", sorted(INVALID))
def test_trace_errors_equal_the_reference(case):
    with pytest.raises(jobs.TraceError):
        _trace(jobs, INVALID[case]).validate()
    with pytest.raises(obs.TraceError):
        _trace(obs, INVALID[case]).validate()


# ---------------------------------------------------------------------------
# the engines under the virtual clock
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel = jbuild(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, build_model(cfg), params, jmodel, jparams


def _requests(jax_side, lens, gens, seed=0, base=0, prompts=None, **kw):
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = [rng.integers(1, 512, size=n).astype(np.int32)
                   for n in lens]
    req, sp = (JRequest, JSampling) if jax_side else (GenerationRequest,
                                                      SamplingParams)
    return [req(rid=base + i, prompt=p, max_new_tokens=g,
                sampling=sp(seed=100 + i), **kw)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _shared_prefix_prompts():
    rng = np.random.default_rng(4)
    shared = rng.integers(1, 512, size=16).astype(np.int32)
    tails = [rng.integers(1, 512, size=n).astype(np.int32)
             for n in (3, 5, 2)]
    return [np.concatenate([shared, t]) for t in tails] + [
        rng.integers(1, 512, size=9).astype(np.int32)]


def _slot_queue(eng, jax_side):
    for r in _requests(jax_side, [6, 6, 9], [4, 3, 5]):
        eng.submit(r)
    return eng.run()


def _cancel_reject(eng, jax_side):
    ok, queued, shed = _requests(jax_side, [6, 6, 6], [4, 8, 4])
    eng.submit(ok)
    eng.submit(queued)
    assert eng.try_submit(shed) is False        # queue full -> rejected
    eng.step()
    assert eng.cancel(1)                        # still queued
    return eng.run()


def _deadline_error(eng, jax_side):
    late = _requests(jax_side, [6], [20], base=60, deadline_s=5.0)
    poisoned = _requests(jax_side, [7], [20], seed=2, base=61)
    for r in late + poisoned:
        eng.submit(r)
    return eng.run()


def _paged_preempt(eng, jax_side):
    for r in _requests(jax_side, [28, 29, 30, 31, 28, 29], [12] * 6,
                       seed=1):
        eng.submit(r)
    return eng.run()


def _paged_prefix(eng, jax_side):
    for r in _requests(jax_side, None, [6, 5, 7, 4],
                       prompts=_shared_prefix_prompts()):
        eng.submit(r)
    return eng.run()


PAGED = dict(kv_layout="paged", page_size=8, prompt_buckets=(8, 16))
CASES = {   # name -> (engine config, fault script, driver)
    "slot_queue": (dict(num_slots=1, max_len=32), (), _slot_queue),
    "slot_cancel_reject": (dict(num_slots=1, max_len=32, max_queue=2), (),
                           _cancel_reject),
    "slot_deadline_error": (dict(num_slots=2, max_len=32),
                            ((3, "nan_logits", 61),), _deadline_error),
    "paged_preempt_resume": (dict(PAGED, num_slots=3, max_len=48,
                                  num_pages=9, prefix_caching=False,
                                  prompt_buckets=()), (), _paged_preempt),
    "paged_prefix_int8": (dict(PAGED, num_slots=2, max_len=40, num_pages=10,
                               kv_quantized=True), (), _paged_prefix),
}


def _run_case(tiny, name, jax_side, registry=None):
    cfg, model, params, jmodel, jparams = tiny
    ecfg, script, drive = CASES[name]
    if jax_side:
        eng = JEngine(jmodel, jparams, JEngineConfig(**ecfg),
                      faults=JFaultPlan(slow_step_s=1.0, script=script))
    else:
        eng = Engine(model, params, EngineConfig(**ecfg),
                     faults=FaultPlan(slow_step_s=1.0, script=script),
                     registry=registry)
    t0 = eng._now()
    out = {r.rid: r for r in drive(eng, jax_side)}
    return eng, out, t0


@pytest.fixture(scope="module")
def jax_runs(tiny):
    return {name: _run_case(tiny, name, True) for name in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_traces_and_snapshot_equal_the_jax_engine(tiny, jax_runs,
                                                         case):
    jeng, jout, jt0 = jax_runs[case]
    eng, out, t0 = _run_case(tiny, case, False)
    assert sorted(out) == sorted(jout)
    for rid, res in out.items():
        jres = jout[rid]
        assert (res.status, res.tokens) == (jres.status, jres.tokens), rid
        events = [(n, t - t0) for n, t in res.trace.events]
        assert events == [(n, t - jt0) for n, t in jres.trace.events], rid
        assert res.trace.validate() and res.trace.status == res.status
    assert eng.metrics_snapshot() == jeng.metrics_snapshot()
    assert eng.queue_stats() == jeng.queue_stats()
    assert eng.page_stats() == jeng.page_stats()
    statuses = {r.status for r in out.values()}
    want = {"slot_queue": {"ok"},
            "slot_cancel_reject": {"ok", "cancelled", "rejected"},
            "slot_deadline_error": {"deadline", "error"},
            "paged_preempt_resume": {"ok"},
            "paged_prefix_int8": {"ok"}}[case]
    assert statuses == want
    if case == "paged_preempt_resume":
        assert eng.preemptions > 0 and eng.resumes > 0
        assert any("resume" in [n for n, _ in r.trace.events]
                   for r in out.values())
    if case == "paged_prefix_int8":
        assert eng.prefix_hits > 0


def test_disabled_registry_keeps_tokens_and_counters(tiny):
    runs = {}
    for enabled in (True, False):
        reg = obs.MetricsRegistry(enabled=enabled)
        eng, out, _ = _run_case(tiny, "paged_preempt_resume", False,
                                registry=reg)
        runs[enabled] = (eng, out)
    (on, out_on), (off, out_off) = runs[True], runs[False]
    assert {r: o.tokens for r, o in out_on.items()} == \
        {r: o.tokens for r, o in out_off.items()}
    snap_on, snap_off = on.metrics_snapshot(), off.metrics_snapshot()
    assert snap_on["counters"] == snap_off["counters"]
    assert on.page_stats() == off.page_stats()
    assert all(r.trace is None for r in out_off.values())
    ttft = obs.snapshot_series(snap_off, "histograms", "request_ttft_seconds")
    assert ttft["count"] == 0
    assert obs.snapshot_series(snap_on, "histograms",
                               "request_ttft_seconds")["count"] == len(out_on)
    ok = obs.snapshot_series(snap_off, "counters", "engine_requests_total",
                             {"status": "ok"})
    assert ok["value"] == len(out_off)
    assert on.decode_steps == obs.snapshot_series(
        snap_on, "counters", "engine_decode_steps_total")["value"]
    with pytest.raises(AttributeError):
        on.decode_steps = 0                     # a read-only view


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _block0_policy(mod):
    """Block 0 only (the rest stays dense): wo pruned, the other six int4,
    so both the batched buckets and the single-layer path run."""
    return mod.Policy({"blocks.0.attn.wo": mod.PruneSpec(ratio=0.5),
                       "blocks.0.*": mod.QuantSpec(bits=4, group_size=128)},
                      default=None)


def test_compress_metrics_equal_the_reference(tiny, tmp_path):
    cfg, model, params, jmodel, jparams = tiny
    dc = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    jcal = [{"tokens": jnp.asarray(t)}
            for t, _ in jcalibration_batches(JDataConfig(**dc), 1)]
    cal = [{"tokens": torch.from_numpy(t)}
           for t, _ in calibration_batches(DataConfig(**dc), 1)]
    jreg, reg = jobs.MetricsRegistry(), obs.MetricsRegistry()
    jcompress_model(jmodel, jparams, jcal, _block0_policy(jspecs),
                    metrics=jreg)
    _, report = compress_model(model, params, cal, _block0_policy(specs),
                               metrics=reg, profile_dir=str(tmp_path),
                               profile_block=0)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert obs.snapshot_series(snap, "counters", "compress_layers_total",
                               {"method": "awp_quant"})["value"] == 6
    assert sorted(snap["counters"]) == [
        "compress_bucket_layers_total", "compress_buckets_total",
        "compress_layers_total"]
    assert sorted(snap["histograms"]) == sorted(jsnap["histograms"])
    for name, fam in snap["histograms"].items():
        jfam = jsnap["histograms"][name]
        keys = (("labels", "le", "count") if name.endswith("_seconds")
                else ("labels", "le", "counts", "count"))
        assert [{k: s[k] for k in keys} for s in fam["series"]] == \
            [{k: s[k] for k in keys} for s in jfam["series"]], name
    # the profiled block's window: a Chrome trace of the block's CPU ops
    (path,) = [p for p in tmp_path.iterdir()]
    assert path.name == "block-0.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert len(report) == 7


# ---------------------------------------------------------------------------
# the CLIs and the profiler windows
# ---------------------------------------------------------------------------

SCHEMA_ARGS = {   # CI's metrics step (.github/workflows/ci.yml)
    "serve": (["counters:engine_requests_total",
               "counters:engine_decode_steps_total",
               "gauges:engine_queue_depth", "gauges:engine_slots_active",
               "histograms:request_queue_seconds",
               "histograms:request_ttft_seconds",
               "histograms:request_latency_seconds"],
              ["engine_requests_total", "request_ttft_seconds"]),
    "compress": (["counters:compress_layers_total",
                  "histograms:compress_residual",
                  "histograms:compress_layer_seconds",
                  "histograms:compress_block_seconds",
                  "histograms:compress_pgd_iters"],
                 ["compress_layers_total"]),
}


@pytest.mark.parametrize("cli", ["serve", "compress"])
def test_cli_metrics_json_passes_the_schema_check(cli, tmp_path, capsys):
    path = str(tmp_path / f"{cli}_metrics.json")
    prof = str(tmp_path / "prof")
    if cli == "serve":
        serve_cli.main(["--tiny", "--device", "cpu", "--engine",
                        "continuous", "--requests", "8", "--gen", "8",
                        "--prompt-len", "16", "--slots", "4", "--verify",
                        "--metrics-json", path, "--metrics-interval", "4",
                        "--profile-steps", "3", "--profile-dir", prof])
        out = capsys.readouterr().out
        assert "[serve]   rid=0 status=ok queue" in out
        assert "[serve] step 4: active" in out
        assert os.listdir(prof) == ["steps-0.trace.json"]
    else:
        policy = ('{"rules": [["blocks.0.*", {"kind": "QuantSpec", '
                  '"bits": 4}]], "default": null}')
        compress_cli.main(["--tiny", "--device", "cpu", "--calib-batches",
                           "1", "--seq", "16", "--policy", policy,
                           "--out", str(tmp_path / "ck"),
                           "--metrics-json", path, "--profile-dir", prof,
                           "--profile-block", "0"])
        assert os.listdir(prof) == ["block-0.trace.json"]
    meta = json.load(open(path))["meta"]
    assert meta["source"] == cli
    require, prom_require = SCHEMA_ARGS[cli]
    cmd = [sys.executable, os.path.join(REPO, "scripts",
                                        "check_metrics_schema.py"), path,
           "--schema", os.path.join(REPO, "scripts", "metrics_schema.json"),
           "--check-families", "--prom", path + ".prom"]
    for r in require:
        cmd += ["--require", r]
    for r in prom_require:
        cmd += ["--prom-require", r]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[metrics-schema] OK" in res.stdout


def test_profiler_windows_write_chrome_traces(tiny, tmp_path):
    cfg, model, params, _, _ = tiny
    with obs.trace_window("") as started:
        pass
    assert started is False
    assert not os.listdir(tmp_path)
    with obs.trace_window(str(tmp_path)) as started:
        torch.ones(8).sum()
    assert started
    with obs.trace_window(str(tmp_path)):
        pass
    assert sorted(os.listdir(tmp_path)) == ["block-0.trace.json",
                                            "block-1.trace.json"]
    eng = Engine(model, params, EngineConfig(num_slots=2, max_len=32))
    for r in _requests(False, [6, 9, 7], [6, 4, 8]):
        eng.submit(r)
    win = obs.StepTraceWindow(str(tmp_path), 3)
    assert win.enabled and not win.active
    win.start()
    assert win.active
    eng.run(step_hook=win.on_step)
    assert not win.active and eng.decode_steps > 3
    assert win.path == str(tmp_path / "steps-0.trace.json")
    events = json.load(open(win.path))["traceEvents"]
    steps = sorted(e["name"] for e in events
                   if e.get("name", "").startswith("ProfilerStep#"))
    assert steps == ["ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]
    assert not obs.StepTraceWindow("", 3).enabled
    assert not obs.StepTraceWindow(str(tmp_path), 0).enabled


def test_profile_analysis_of_a_synthetic_trace():
    """``chip_smoke.py``'s reading of a Chrome trace: per step window, the
    union of its device intervals clipped to the window, the idle share,
    the longest gaps with the innermost host op open at each gap's start,
    and kernel counts by name."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#0",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1",
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5,
         "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 30,
         "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 40,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void dequant_gemv_kernel<8>",
         "ts": 10, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "decode_split_kernel",
         "ts": 15, "dur": 10},                   # overlaps the one above
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 95,
         "dur": 10},                             # crosses the boundary
        {"ph": "X", "cat": "kernel", "name": "decode_merge_kernel",
         "ts": 150, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 101,
         "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 8, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "ts": 20, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 102, "dur": 28},
    ]
    prof = chip_smoke.read_profile(ev)
    w0, w1 = prof["windows"]
    assert (w0["step"], w0["ms"], w0["busy_ms"], w0["host_ms"],
            w0["kernels"]) == (0, 0.1, 0.02, 0.08, 2)
    assert math.isclose(w0["idle"], 0.8)
    # launches at 8 and 20 (ending at 21): 8 us before, 13 between, 79 after
    assert (w0["lead_ms"], w0["dispatch_ms"], w0["tail_ms"]) == \
        (0.008, 0.013, 0.079)
    assert (w1["lead_ms"], w1["dispatch_ms"], w1["tail_ms"]) == (0.1, 0, 0)
    assert (w1["busy_ms"], w1["idle"], w1["host_ms"], w1["kernels"]) == \
        (0.025, 0.75, 0.03, 1)
    assert prof["kernels"] == {"void dequant_gemv_kernel<8>": 1,
                               "decode_split_kernel": 1,
                               "decode_merge_kernel": 1}
    # window 0 idles 0-10 and 25-95 us, window 1 105-150 and 170-200 us;
    # at 105 the host is inside aten::item's copy
    gaps = chip_smoke.idle_gaps(prof, prof["windows"], 3)
    assert [(g["step"], g["at_us"], g["ms"], g["host_op"]) for g in gaps] \
        == [(0, 25, 0.07, ""), (1, 5, 0.045, "cudaMemcpyAsync"),
            (1, 70, 0.03, "")]
    assert chip_smoke.host_ops(prof, [w0], 2) == [("aten::copy_", 0.055, 1),
                                                  ("aten::mm", 0.018, 1)]
    assert chip_smoke.device_ops(prof, [w1], 5) == [
        ("decode_merge_kernel", 0.02, 1)]
    (whole,) = chip_smoke.read_profile(ev[2:])["windows"]   # no steps
    assert (whole["step"], whole["start"], whole["end"]) == (-1, 5, 170)
