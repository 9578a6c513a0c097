"""The port's continuous-batching engine against the JAX engine on the CPU:
scheduler invariants, per-request sampling, greedy parity on the
reference's own traces (dense f32 and INT8 slot caches, slot reuse,
chunked long prompts), fused against unfused decode, and the failure
semantics (non-finite logits, deadlines on the virtual clock, cancel,
``check_invariants`` after every step).

The JAX tiny llama32's random init is carried into the port through
``repro_torch.bridge``, and both engines see the same numpy prompts. On
the CPU the port's K4, K5 and K6 wrappers run their plain versions.
"""
import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationRequest as JRequest
from repro.serving import SamplingParams as JSampling
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.launch.serve import make_step_fns, static_greedy_reference
from repro_torch.models import build_model
from repro_torch.serving import (Engine, EngineConfig, FaultPlan,
                                 GenerationRequest, InvalidRequestError,
                                 SamplingParams, Scheduler, cache_is_finite,
                                 sample_tokens)
from repro_torch.serving.scheduler import default_buckets

ARCH = "llama32-1b"


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel = jbuild(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, build_model(cfg), params, jmodel, jparams


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=l).astype(np.int32) for l in lens]


def _requests(lens, gens, seed=0, base=0, **kw):
    return [GenerationRequest(rid=base + i, prompt=p, max_new_tokens=g,
                              sampling=SamplingParams(seed=100 + i), **kw)
            for i, (p, g) in enumerate(zip(_prompts(lens, seed), gens))]


def _jax_requests(lens, gens, seed=0):
    return [JRequest(rid=i, prompt=p, max_new_tokens=g,
                     sampling=JSampling(seed=100 + i))
            for i, (p, g) in enumerate(zip(_prompts(lens, seed), gens))]


def _drive(eng, reqs, max_steps=500):
    """Submit, step with invariant checks after every step → {rid: result}."""
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        if eng.scheduler.idle:
            break
        eng.step()
        assert eng.check_invariants()
    assert eng.scheduler.idle
    out, eng._done = eng._done, []
    return {r.rid: r for r in out}


# ---------------------------------------------------------------------------
# scheduler (the cases of tests/test_engine.py)
# ---------------------------------------------------------------------------

def _req(rid, n, gen=4):
    return GenerationRequest(rid=rid, prompt=np.ones(n, np.int32),
                             max_new_tokens=gen)


def test_scheduler_fifo_admission_and_slot_reuse():
    s = Scheduler(num_slots=2, max_len=64)
    for i in range(5):
        s.submit(_req(i, 4))
    a0, a1 = s.admit(), s.admit()
    assert a0[1].rid == 0 and a1[1].rid == 1 and {a0[0], a1[0]} == {0, 1}
    assert s.admit() is None and s.num_active == 2 and not s.idle
    assert s.retire(a0[0]).rid == 0
    a2 = s.admit()
    assert a2[0] == a0[0] and a2[1].rid == 2
    for slot in list(s.active_slots()):
        s.retire(slot)
    assert s.admit()[1].rid == 3 and s.admit()[1].rid == 4
    assert s.admit() is None and len(s.queue) == 0


def test_scheduler_rejects_oversized_empty_and_zero_budget_requests():
    s = Scheduler(num_slots=1, max_len=16)
    for r in (_req(0, 10, 7), _req(1, 0), _req(2, 4, 0)):
        with pytest.raises(InvalidRequestError):
            s.submit(r)


def test_prompt_bucketing_and_chunked_admission():
    assert default_buckets(64) == (8, 16, 32, 64)
    assert default_buckets(48) == (8, 16, 32, 48)
    s = Scheduler(num_slots=1, max_len=48)
    assert s.bucket_for(1) == 8 and s.bucket_for(9) == 16
    assert s.bucket_for(33) == 48
    s2 = Scheduler(num_slots=1, max_len=64, prompt_buckets=(12, 24))
    assert s2.bucket_for(5) == 12 and s2.bucket_for(13) == 24
    s2.submit(_req(9, 30))
    batch = s2.admit_batch()
    assert batch.chunked and batch.bucket == 24
    assert [r.rid for _, r in batch.items] == [9]
    with pytest.raises(ValueError):
        Scheduler(num_slots=1, max_len=16, prompt_buckets=(8, 32))


def test_scheduler_admit_batch_groups_fifo_head_run():
    s = Scheduler(num_slots=4, max_len=64)
    for i, l in enumerate([5, 8, 13, 7, 6]):          # buckets 8,8,16,8,8
        s.submit(_req(i, l, 2))
    b0 = s.admit_batch()
    assert b0.bucket == 8 and [r.rid for _, r in b0.items] == [0, 1]
    b1 = s.admit_batch()
    assert b1.bucket == 16 and [r.rid for _, r in b1.items] == [2]
    b2 = s.admit_batch()
    assert b2.bucket == 8 and [r.rid for _, r in b2.items] == [3]
    assert s.admit_batch() is None and len(s.queue) == 1
    for slot, _ in b0.items:
        s.retire(slot)
    assert [r.rid for _, r in s.admit_batch().items] == [4]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _sample(logits, temps, topks, seeds, steps):
    return sample_tokens(torch.as_tensor(logits), torch.tensor(temps),
                         torch.tensor(topks), torch.tensor(seeds),
                         torch.tensor(steps))


def test_sample_tokens_semantics():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    args = ([0.0, 1.0, 1.0, 0.7], [0, 0, 5, 1], [0, 7, 7, 9], [0, 3, 3, 1])
    a = _sample(logits, *args)
    assert torch.equal(a, _sample(logits, *args))         # deterministic
    assert int(a[0]) == int(np.argmax(logits[0]))          # temp 0: argmax
    assert int(a[3]) == int(np.argmax(logits[3]))          # top_k 1: argmax
    # the key is (seed, step), never the slot or the batch size
    perm = [2, 0, 3, 1]
    c = _sample(logits[perm], *([x[i] for i in perm] for x in args))
    assert torch.equal(c, a[perm])
    for i in range(4):
        one = _sample(logits[i:i + 1], *([x[i]] for x in args))
        assert int(one[0]) == int(a[i])
    # top-k truncates: k = 5 samples land in the top 5
    many = _sample(np.tile(logits[2], (64, 1)), [1.5] * 64, [5] * 64,
                   list(range(64)), [0] * 64)
    top5 = set(np.argsort(-logits[2])[:5].tolist())
    assert set(many.tolist()) <= top5 and len(set(many.tolist())) > 1
    # the greedy rows are exactly argmax on a wide vocab too
    wide = rng.standard_normal((3, 5000)).astype(np.float32)
    g = _sample(wide, [0.0] * 3, [0, 1, 64], [1, 2, 3], [4, 5, 6])
    assert g.tolist() == np.argmax(wide, -1).tolist()


def test_engine_sampling_deterministic_across_runs_and_slots(tiny):
    cfg, model, params, _, _ = tiny
    outs = []
    for slots in (2, 4):
        eng = Engine(model, params, EngineConfig(num_slots=slots, max_len=48))
        reqs = [GenerationRequest(rid=r.rid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens,
                                  sampling=SamplingParams(temperature=1.0,
                                                          top_k=8, seed=7))
                for r in _requests([5, 9, 3, 12], [6, 4, 5, 3])]
        outs.append({rid: r.tokens for rid, r in _drive(eng, reqs).items()})
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# engine: greedy parity with the JAX engine and the static path
# ---------------------------------------------------------------------------

TRACES = {   # tests/test_engine.py:253 and :343
    "slot_reuse": dict(lens=[5, 13, 8, 21, 3, 16, 9, 30],
                       gens=[6, 3, 9, 4, 8, 5, 2, 7],
                       ecfg=dict(num_slots=4, max_len=64)),
    "chunked": dict(lens=[20, 40, 9, 33], gens=[4, 3, 5, 2],
                    ecfg=dict(num_slots=2, max_len=64,
                              prompt_buckets=(8, 16))),
}


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """The JAX engine's greedy tokens per request for each trace and cache."""
    _, _, _, jmodel, jparams = tiny
    out = {}
    for name, tr in TRACES.items():
        for quant in (False, True):
            eng = JEngine(jmodel, jparams,
                          JEngineConfig(kv_quantized=quant, **tr["ecfg"]))
            for r in _jax_requests(tr["lens"], tr["gens"]):
                eng.submit(r)
            out[name, quant] = {r.rid: r.tokens for r in eng.run()}
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("trace", list(TRACES))
def test_engine_greedy_matches_jax_engine(tiny, jax_tokens, trace, quant):
    cfg, model, params, _, _ = tiny
    tr = TRACES[trace]
    eng = Engine(model, params, EngineConfig(kv_quantized=quant,
                                             **tr["ecfg"]))
    reqs = _requests(tr["lens"], tr["gens"])
    eng.warmup(reqs)
    got = _drive(eng, reqs)
    assert all(r.status == "ok" for r in got.values())
    assert {rid: r.tokens for rid, r in got.items()} == jax_tokens[trace,
                                                                   quant]
    if trace == "chunked":
        assert eng.chunk_dispatches == 2 + 3 + 3 and eng.chunked_admitted == 3
    else:
        assert 0.0 < eng.utilization() <= 1.0
    if not quant:                       # the port's own static path
        step_fns = make_step_fns(model)
        for req in reqs:
            assert got[req.rid].tokens == static_greedy_reference(
                model, params, req, tr["ecfg"]["max_len"], step_fns), req.rid


def test_engine_burst_admits_in_one_prefill(tiny):
    cfg, model, params, _, _ = tiny
    eng = Engine(model, params, EngineConfig(num_slots=4, max_len=64))
    got = _drive(eng, _requests([20, 22, 19, 24], [4, 6, 3, 5]))
    assert eng.prefill_dispatches == 1 and eng.prefill_admitted == 4
    assert sorted(len(r.tokens) for r in got.values()) == [3, 4, 5, 6]


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_fused_and_unfused_decode_give_equal_tokens(tiny, quant):
    """tests/test_decode_attn.py:218, slot storages."""
    cfg, model, params, _, _ = tiny
    runs = []
    for fused in (True, False):
        eng = Engine(model, params, EngineConfig(
            num_slots=3, max_len=24, kv_quantized=quant,
            use_fused_decode=fused))
        got = _drive(eng, _requests([5, 11, 3, 8], [6, 4, 8, 5]))
        runs.append({rid: r.tokens for rid, r in got.items()})
    assert runs[0] == runs[1]
    assert model.use_fused_decode is False          # the caller's model


def test_step_inputs_upload_in_one_copy_with_exact_values(tiny):
    """The step functions' packed upload gives back every array with its
    shape and exact values: ints as int64, float32 bit for bit."""
    cfg, model, params, _, _ = tiny
    eng = Engine(model, params, EngineConfig(num_slots=4, max_len=32))
    ints = np.array([[0, -7], [2**31 - 1, 2**40]], np.int64)
    temps = np.float32([0.0, -0.0, 0.7, 1e-38, np.inf, np.nan])
    toks = np.arange(6, dtype=np.int32)[:, None]
    got = eng._upload(ints, temps, toks, [3])
    assert [tuple(t.shape) for t in got] == [(2, 2), (6,), (6, 1), (1,)]
    assert [t.dtype for t in got] == [torch.int64, torch.float32,
                                      torch.int64, torch.int64]
    assert_array_equal(got[0].numpy(), ints)
    assert_array_equal(got[1].numpy().view(np.int32), temps.view(np.int32))
    assert_array_equal(got[2].numpy(), toks)
    assert int(got[3]) == 3


def test_int8_cache_is_about_half_of_bf16(tiny):
    cfg, model, params, _, _ = tiny
    dense = Engine(model, params, EngineConfig(num_slots=4, max_len=64,
                                               kv_dtype=torch.bfloat16))
    int8 = Engine(model, params, EngineConfig(num_slots=4, max_len=64,
                                              kv_quantized=True))
    assert 1.5 <= dense.kv_cache_bytes() / int8.kv_cache_bytes() <= 2.0


def test_paged_layout_is_not_ported(tiny):
    cfg, model, params, _, _ = tiny
    with pytest.raises(NotImplementedError, match="paging slice"):
        Engine(model, params, EngineConfig(kv_layout="paged"))


# ---------------------------------------------------------------------------
# failure semantics (tests/test_faults.py, slot layout)
# ---------------------------------------------------------------------------

def test_nan_in_cache_and_scripted_poison_fail_only_their_slot(tiny):
    cfg, model, params, _, _ = tiny
    eng = Engine(model, params, EngineConfig(num_slots=2, max_len=32))
    eng.warmup(_requests([6], [4]))
    for r in _requests([6, 6], [8, 8]):
        eng.submit(r)
    eng.step()                          # both prefilled + one decode
    clean = {r.rid: list(r.tokens) for r in eng._results.values()}
    slot = next(s for s in eng.scheduler.active_slots()
                if eng.scheduler.slots[s].request.rid == 0)
    eng.kv["k"][:, slot] = float("nan")  # genuine corruption, not a flag
    assert not cache_is_finite(eng.kv)
    out = {r.rid: r for r in eng.run()}
    assert out[0].status == "error" and "non-finite" in out[0].error
    assert out[0].tokens == clean[0]
    assert out[1].status == "ok" and len(out[1].tokens) == 8
    assert eng.check_invariants()

    eng = Engine(model, params, EngineConfig(num_slots=2, max_len=32,
                                             kv_quantized=True))
    eng.set_faults(FaultPlan(script=((3, "nan_logits", 11),)))
    out = _drive(eng, _requests([6, 7], [6, 6], base=10))
    # steps 1 and 2 emitted the prefill token and two decodes
    assert out[11].status == "error" and len(out[11].tokens) == 3
    assert out[10].status == "ok" and len(out[10].tokens) == 6


def test_deadlines_on_the_virtual_clock(tiny):
    cfg, model, params, _, _ = tiny
    eng = Engine(model, params, EngineConfig(num_slots=1, max_len=32))
    eng.warmup(_requests([6], [4]))
    eng.set_faults(FaultPlan(slow_step_s=1.0))
    running = _requests([6], [20], base=30, deadline_s=5.0)[0]
    queued = _requests([6], [4], base=40, deadline_s=3.0)[0]
    out = _drive(eng, [running, queued])
    assert out[30].status == "deadline" and 0 < len(out[30].tokens) < 20
    assert out[40].status == "deadline" and out[40].tokens == []


def test_cancel_shedding_and_stall(tiny):
    cfg, model, params, _, _ = tiny
    eng = Engine(model, params, EngineConfig(num_slots=1, max_len=32,
                                             max_queue=2))
    running, queued, shed = _requests([6, 6, 6], [8, 8, 8], base=10)
    eng.submit(running)
    eng.submit(queued)
    assert eng.try_submit(shed) is False            # queue at max_queue
    eng.step()
    eng.step()
    assert eng.check_invariants()
    assert eng.cancel(10) and eng.cancel(11)
    assert not eng.cancel(10) and not eng.cancel(424242)
    out = {r.rid: r for r in eng.run()}
    assert out[10].status == "cancelled" and len(out[10].tokens) >= 2
    assert out[11].status == "cancelled" and out[11].tokens == []
    assert out[12].status == "rejected" and "max_queue" in out[12].error
    assert eng.queue_stats()["rejected"] == 1
    eng.submit(_requests([6], [20], base=50)[0])
    with pytest.raises(Exception, match="rid=50"):
        eng.run(max_steps=3)
    assert {r.rid: r.status for r in eng.run()} == {50: "ok"}


@pytest.mark.parametrize("flags", [["--kv-quant"], ["--verify"]])
def test_serve_engine_cli_runs_on_cpu(flags):
    from repro_torch.launch import serve
    results = serve.main(["--tiny", "--device", "cpu", "--engine",
                          "continuous", "--requests", "6", "--slots", "2",
                          "--gen", "4", "--prompt-len", "24", "--buckets",
                          "8,16", *flags])
    assert len(results) == 6 and all(r.ok for r in results)
    with pytest.raises(SystemExit):
        serve.main(["--tiny", "--device", "cpu", "--engine", "continuous",
                    "--kv", "paged"])
