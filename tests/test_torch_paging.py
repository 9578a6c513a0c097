"""The port's paged KV engine against the JAX package's on the CPU: the
page allocator and its refcounts, the prefix cache's chain hashes and
match/insert/evict semantics, resume-ticket ordering, and the paged
engine's greedy tokens and ``page_stats()`` counters on the traces of
tests/test_paging.py and the paged fault cases of tests/test_faults.py
(dense and INT8 pools, chunked long prompts, copy-free prefix hits,
preempt and resume under a small pool, sole-active preemption, a resume
that waits, cancel while spilled, a pool that cannot fit one request,
allocation-fault chaos, spill failures, an exact NaN victim).

The JAX tiny llama32's random init is carried into the port through
``repro_torch.bridge`` and both engines see the same numpy prompts; both
run without warmup (the JAX engine would compile its whole prefill grid),
so their counters compare one for one. On the CPU the port's K4, K5 and
K6p wrappers run their plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import GenerationRequest as JRequest
from repro.serving import PageAllocator as JPageAllocator
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import SamplingParams as JSampling
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.models import build_model
from repro_torch.serving import (Engine, EngineConfig, FaultPlan,
                                 GenerationRequest, InvalidRequestError,
                                 PageAllocator, PrefixCache, ResumeTicket,
                                 SamplingParams, Scheduler, pow2_at_least)

ARCH = "llama32-1b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel = jbuild(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, build_model(cfg), params, jmodel, jparams


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=l).astype(np.int32)
            for l in lens]


def _requests(cfg, lens, gens, seed=0, jax_side=False, prompts=None):
    req, sp = (JRequest, JSampling) if jax_side else (GenerationRequest,
                                                      SamplingParams)
    prompts = prompts if prompts is not None else _prompts(cfg, lens, seed)
    return [req(rid=i, prompt=p, max_new_tokens=g,
                sampling=sp(seed=100 + i))
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _engine(tiny, jax_side, faults=None, **ecfg):
    cfg, model, params, jmodel, jparams = tiny
    if jax_side:
        eng = JEngine(jmodel, jparams, JEngineConfig(**ecfg))
    else:
        eng = Engine(model, params, EngineConfig(**ecfg))
    if faults is not None:
        eng.set_faults(faults)
    return eng


def _drive(eng, reqs, max_steps=2000):
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


def _outcome(out):
    return {rid: (r.status, list(r.tokens)) for rid, r in out.items()}


# ---------------------------------------------------------------------------
# allocator and prefix cache (the cases of tests/test_paging.py)
# ---------------------------------------------------------------------------

def test_pow2_at_least():
    assert [pow2_at_least(n) for n in (1, 2, 3, 4, 5, 9)] == [1, 2, 4, 4, 8, 16]


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_page_allocator_refcounts_oom_and_double_free(impl):
    cls = PageAllocator if impl == "port" else JPageAllocator
    a = cls(4)
    assert a.num_free == 4 and a.pages_in_use == 0
    pages = a.alloc(3)
    assert pages == [0, 1, 2] and a.peak_in_use == 3
    assert a.alloc(2) is None and a.pages_in_use == 3   # all or nothing
    a.incref([pages[0]])
    assert a.refcount(pages[0]) == 2
    assert a.decref([pages[0]]) == 0
    assert a.decref(pages) == 3
    assert a.pages_in_use == 0 and a.peak_in_use == 3
    assert a.free_pages() == [3, 0, 1, 2]               # freed pages append
    assert (a.alloc_calls, a.alloc_failures) == (2, 1)
    (p,) = a.alloc(1)
    a.decref([p])
    with pytest.raises(ValueError):
        a.decref([p])                                   # double free
    with pytest.raises(ValueError):
        a.incref([p])                                   # freed page


def test_page_allocator_injected_failure():
    a = PageAllocator(4, faults=FaultPlan(script=((0, "alloc_fail"),)))
    assert a.alloc(1) is None and a.pages_in_use == 0
    assert (a.alloc_calls, a.alloc_failures) == (1, 1)


def test_prefix_cache_hashes_equal_the_reference():
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 2**31 - 1, size=70).astype(np.int64)
    mine = PrefixCache(8, PageAllocator(4))
    theirs = JPrefixCache(8, JPageAllocator(4))
    assert list(mine._hashes(toks, 8)) == list(theirs._hashes(toks, 8))
    assert list(mine._hashes(list(toks[:20]), 2)) == \
        list(theirs._hashes(np.asarray(toks[:20], np.int32), 2))


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_prefix_cache_match_insert_and_lru_evict(impl):
    alloc_cls, cache_cls = ((PageAllocator, PrefixCache) if impl == "port"
                            else (JPageAllocator, JPrefixCache))
    a = alloc_cls(8)
    pc = cache_cls(page_size=4, allocator=a)
    toks = np.arange(12, dtype=np.int32)
    assert pc.match(toks) == ([], 0)
    pages = a.alloc(3)
    assert pc.insert(toks, pages) == 3
    assert a.refcount(pages[0]) == 2
    a.decref(pages)
    hit, n = pc.match(toks)                    # capped at (len - 1) // page
    assert hit == pages[:2] and n == 8
    assert pc.insert(toks, hit + pages[2:]) == 0   # idempotent, no creep
    assert a.refcount(pages[0]) == 2
    a.decref(hit)
    fork = toks.copy()
    fork[5] = 99
    hit, n = pc.match(fork)
    assert hit == pages[:1] and n == 4
    a.decref(hit)
    held = pc.match(toks)[0]                   # pin pages 0, 1
    assert pc.evict(need=3) >= 1 and a.refcount(pages[2]) == 0
    assert a.refcount(pages[0]) == 2
    a.decref(held)
    assert (pc.inserted_pages, pc.evicted_pages) == (3, 1)
    pc.clear()
    assert a.pages_in_use == 0


def test_resume_ticket_ordering_and_admission():
    s = Scheduler(num_slots=1, max_len=64)
    reqs = [GenerationRequest(rid=i, prompt=np.ones(4, np.int32),
                              max_new_tokens=4) for i in range(3)]
    for r in reqs:
        s.submit(r)
    slot, r0 = s.admit()
    s.slots[slot].generated = 2
    t0 = ResumeTicket(request=r0, generated=2, last_token=7, pos=5, n_pages=1)
    s.preempt(slot, t0)
    assert s.peek() is t0 and s.admit_batch() is None
    slot, head = s.admit_head()
    assert head is t0 and s.slots[slot].generated == 2
    t1 = ResumeTicket(request=reqs[1], generated=1, last_token=3, pos=5,
                      n_pages=1)
    s.preempt(slot, t0)
    s.requeue(t1)
    assert s.peek() is t0 and s.queue[1] is t1
    assert isinstance(s.queue[2], GenerationRequest)


# ---------------------------------------------------------------------------
# engine: the port's paged engine against JAX's and the slot engine
# ---------------------------------------------------------------------------

TRACES = {   # tests/test_paging.py:176, :197, :249; a chunked trace
    "dense": dict(lens=[5, 13, 8, 21, 3, 16], gens=[6, 3, 9, 4, 8, 5],
                  ecfg=dict(num_slots=4, max_len=64, page_size=8)),
    "int8": dict(lens=[6, 11, 9], gens=[5, 4, 6],
                 ecfg=dict(num_slots=2, max_len=32, kv_quantized=True,
                           page_size=8)),
    "preempt": dict(lens=[30, 29, 31, 28], gens=[12, 12, 12, 12],
                    ecfg=dict(num_slots=3, max_len=48, page_size=8,
                              num_pages=9, prefix_caching=False)),
    "chunked_int8": dict(lens=[20, 40, 9, 33], gens=[4, 3, 5, 2],
                         ecfg=dict(num_slots=2, max_len=64,
                                   prompt_buckets=(8, 16), page_size=8,
                                   kv_quantized=True)),
}


@pytest.mark.parametrize("trace", list(TRACES))
def test_paged_engine_matches_jax_and_slot_engine(tiny, trace):
    cfg = tiny[0]
    tr = TRACES[trace]
    runs = {}
    for side in ("jax", "port"):
        eng = _engine(tiny, side == "jax", kv_layout="paged", **tr["ecfg"])
        out = _drive(eng, _requests(cfg, tr["lens"], tr["gens"],
                                    jax_side=side == "jax"))
        runs[side] = (_outcome(out), eng.page_stats())
    assert runs["port"] == runs["jax"]
    stats = runs["port"][1]
    assert all(st == "ok" for st, _ in runs["port"][0].values())
    slot_cfg = {k: v for k, v in tr["ecfg"].items()
                if k not in ("page_size", "num_pages", "prefix_caching")}
    slot = _drive(_engine(tiny, False, **slot_cfg),
                  _requests(cfg, tr["lens"], tr["gens"]))
    assert {rid: r.tokens for rid, r in slot.items()} == \
        {rid: toks for rid, (_, toks) in runs["port"][0].items()}
    if trace == "preempt":
        assert stats["preemptions"] > 0 and stats["resumes"] > 0
        assert stats["pages_spilled"] > 0 and stats["peak_pages_in_use"] <= 9
        assert stats["pages_in_use"] == 0
    else:
        assert stats["pages_in_use"] == stats["prefix_cached_pages"]


def test_paged_prefix_hit_reuses_pages_copy_free(tiny):
    """Requests sharing a 24-token prefix reuse its cached pages: hits
    counted, the shared pages' bytes untouched by the diverging requests,
    tokens equal to the slot engine's, counters equal to JAX's."""
    cfg = tiny[0]
    pg = 8
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        1, cfg.vocab_size, size=6).astype(np.int32)]) for _ in range(4)]
    gens = [5] * 4
    ecfg = dict(num_slots=2, max_len=64, kv_layout="paged", page_size=pg)
    runs = {}
    for side in ("jax", "port"):
        reqs = _requests(cfg, None, gens, jax_side=side == "jax",
                         prompts=prompts)
        eng = _engine(tiny, side == "jax", **ecfg)
        first = _drive(eng, reqs[:1])
        shared, n_tok = eng.prefix.match(reqs[1].prompt)
        assert n_tok >= len(prefix) - pg
        snap = np.array(eng.kv["k"][:, shared])
        eng.alloc.decref(shared)
        rest = _drive(eng, reqs[1:])
        np.testing.assert_array_equal(np.array(eng.kv["k"][:, shared]), snap)
        runs[side] = (_outcome({**first, **rest}), eng.page_stats())
    assert runs["port"] == runs["jax"]
    stats = runs["port"][1]
    assert stats["prefix_hits"] == 3 and stats["prefix_misses"] == 1
    assert stats["prefix_hit_tokens"] >= 3 * (len(prefix) - pg)
    slot = _drive(_engine(tiny, False, num_slots=2, max_len=64),
                  _requests(cfg, None, gens, prompts=prompts))
    assert {rid: r.tokens for rid, r in slot.items()} == \
        {rid: toks for rid, (_, toks) in runs["port"][0].items()}


def test_paged_counters_match_jax_when_the_cache_empties(tiny):
    """A pool of 7 four-token pages for 3 slots: evictions empty the
    prefix cache, two preemptions, one prefix hit; every counter equal to
    JAX's (an empty cache still reports its inserted and evicted pages)."""
    cfg = tiny[0]
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, 9).astype(np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 7, 3)]
    prompts += [np.concatenate([shared, [7, 8]]).astype(np.int32),
                np.concatenate([shared, [9]]).astype(np.int32)]
    gens = [9, 8, 10, 4, 4]
    runs = {}
    for side in ("jax", "port"):
        eng = _engine(tiny, side == "jax", num_slots=3, max_len=24,
                      prompt_buckets=(4, 8), kv_quantized=True,
                      kv_layout="paged", page_size=4, num_pages=7)
        out = _drive(eng, _requests(cfg, None, gens, jax_side=side == "jax",
                                    prompts=prompts))
        runs[side] = (_outcome(out), eng.page_stats())
    assert runs["port"] == runs["jax"]
    stats = runs["port"][1]
    assert stats["prefix_cached_pages"] == 0 < stats["prefix_evicted_pages"]
    assert stats["preemptions"] == stats["resumes"] >= 1
    assert stats["prefix_hits"] >= 1 and stats["pages_in_use"] == 0


def test_paged_warmup_leaves_no_page_and_clean_counters(tiny):
    cfg = tiny[0]
    eng = _engine(tiny, False, num_slots=2, max_len=64, kv_layout="paged",
                  page_size=8, prompt_buckets=(8, 16))
    reqs = _requests(cfg, [5, 13, 30], [3, 3, 3])
    eng.warmup(reqs)
    stats = eng.page_stats()
    assert stats["pages_in_use"] == 0 and stats["prefix_cached_pages"] == 0
    assert stats["prefix_hits"] == stats["prefix_misses"] == 0
    assert eng.decode_steps == 0 and eng.check_invariants()


def test_paged_pool_must_fit_one_request(tiny):
    cfg = tiny[0]
    with pytest.raises(ValueError):
        _engine(tiny, False, num_slots=2, max_len=64, kv_layout="paged",
                page_size=8, num_pages=7)          # < pages_per_slot (8)
    with pytest.raises(ValueError):
        _engine(tiny, False, kv_layout="paged", page_size=0)
    eng = _engine(tiny, False, num_slots=1, max_len=64, kv_layout="paged",
                  page_size=8)
    assert eng.alloc.num_pages == 8 and eng.pages_per_slot == 8
    big = _requests(cfg, [60], [2])[0]
    eng.alloc.num_pages = 7                  # a prompt beyond the whole pool
    with pytest.raises(InvalidRequestError, match="pages"):
        eng.submit(big)
    assert eng.try_submit(big) is False
    assert eng.run()[0].status == "rejected"


# ---------------------------------------------------------------------------
# preemption edge cases (white-box, on both engines)
# ---------------------------------------------------------------------------

def _sole_active(eng, reqs):
    eng.submit(reqs[0])
    eng.step()
    eng.step()                               # prefill + a decode step
    (live,) = eng.scheduler.active_slots()
    eng._preempt(live)                       # the sole survivor
    assert eng.alloc.pages_in_use == 0 and eng.scheduler.num_active == 0
    eng.check_invariants()
    return {r.rid: r for r in eng.run()}


def _resume_waits(eng, reqs):
    for r in reqs:
        eng.submit(r)
    waited = 0
    for _ in range(200):
        if eng.scheduler.idle:
            break
        eng.step()
        eng.check_invariants()
        head = eng.scheduler.peek()
        if (head is not None and type(head).__name__ == "ResumeTicket"
                and eng.scheduler.num_active):
            waited += 1
    assert eng.scheduler.idle and waited >= 1
    out, eng._done = eng._done, []
    return {r.rid: r for r in out}


def _cancel_spilled(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    victim = eng.scheduler.active_slots()[-1]
    rid = eng.scheduler.slots[victim].request.rid
    pre = list(eng._results[rid].tokens)
    eng._preempt(victim)
    assert type(eng.scheduler.peek()).__name__ == "ResumeTicket"
    assert eng.cancel(rid)
    eng.check_invariants()
    out = {r.rid: r for r in eng.run()}
    assert out[rid].status == "cancelled" and out[rid].tokens == pre
    return out


EDGES = {   # tests/test_paging.py:338, :368, :408
    "sole_active": (_sole_active, [13], [10],
                    dict(num_slots=2, max_len=32, page_size=8,
                         prefix_caching=False)),
    "resume_waits": (_resume_waits, [7, 7], [9, 9],
                     dict(num_slots=2, max_len=16, page_size=4, num_pages=6,
                          prefix_caching=False)),
    "cancel_spilled": (_cancel_spilled, [13, 13], [8, 8],
                       dict(num_slots=2, max_len=32, page_size=8,
                            prefix_caching=False)),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_preemption_edge_cases_match_jax(tiny, case):
    cfg = tiny[0]
    flow, lens, gens, ecfg = EDGES[case]
    runs = {}
    for side in ("jax", "port"):
        eng = _engine(tiny, side == "jax", kv_layout="paged", **ecfg)
        out = flow(eng, _requests(cfg, lens, gens, jax_side=side == "jax"))
        assert eng.alloc.pages_in_use == 0
        runs[side] = (_outcome(out), eng.page_stats())
    assert runs["port"] == runs["jax"]
    stats = runs["port"][1]
    assert stats["preemptions"] >= 1
    assert stats["resumes"] == (0 if case == "cancel_spilled" else
                                stats["preemptions"])
    if case != "cancel_spilled":             # resumed tokens: the slot path's
        slot_cfg = dict(num_slots=ecfg["num_slots"], max_len=ecfg["max_len"])
        slot = _drive(_engine(tiny, False, **slot_cfg),
                      _requests(cfg, lens, gens))
        assert {rid: r.tokens for rid, r in slot.items()} == \
            {rid: toks for rid, (_, toks) in runs["port"][0].items()}


# ---------------------------------------------------------------------------
# paged faults (tests/test_faults.py:236-315)
# ---------------------------------------------------------------------------

PAGED = dict(num_slots=3, max_len=48, kv_layout="paged", page_size=8,
             num_pages=9, prefix_caching=False)
CHAOS = ([7, 9, 11, 7, 9, 13, 7, 9], [10, 12, 9, 11, 8, 10, 12, 9])


@pytest.fixture(scope="module")
def paged_baseline(tiny):
    """The fault-free run of the chaos trace on both engines."""
    cfg = tiny[0]
    runs = {}
    for side in ("jax", "port"):
        eng = _engine(tiny, side == "jax", **PAGED)
        out = _drive(eng, _requests(cfg, *CHAOS, seed=1,
                                    jax_side=side == "jax"))
        assert eng.alloc.pages_in_use == 0
        runs[side] = _outcome(out)
    assert runs["port"] == runs["jax"]
    assert all(st == "ok" for st, _ in runs["port"].values())
    return runs["port"]


PLANS = {
    "alloc_chaos": dict(seed=7, alloc_fail=0.3),
    "spill_fail": dict(seed=3, alloc_fail=0.3, spill_fail=0.5),
    "nan_victim": dict(seed=5, script=((4, "nan_logits", 2),)),
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_paged_faults_match_jax(tiny, paged_baseline, plan):
    cfg = tiny[0]
    runs = {}
    for side in ("jax", "port"):
        fp = (JFaultPlan if side == "jax" else FaultPlan)(**PLANS[plan])
        eng = _engine(tiny, side == "jax", faults=fp, **PAGED)
        out = _drive(eng, _requests(cfg, *CHAOS, seed=1,
                                    jax_side=side == "jax"))
        assert eng.alloc.pages_in_use == 0        # victims leaked nothing
        runs[side] = (_outcome(out), eng.page_stats(), dict(fp.fired),
                      {rid: r.error for rid, r in out.items()})
    assert runs["port"] == runs["jax"]
    outcome, stats, fired, errors = runs["port"]
    for rid, (status, toks) in outcome.items():
        if status == "ok":
            assert toks == paged_baseline[rid][1], rid
    bad = sorted(rid for rid, (st, _) in outcome.items() if st != "ok")
    if plan == "alloc_chaos":
        assert bad == [] and fired["alloc_fail"] > 0
        assert stats["preemptions"] > 0
    elif plan == "spill_fail":
        assert bad and fired["spill_fail"] > 0
        assert all("spill" in errors[r] or "restore" in errors[r]
                   for r in bad)
    else:
        assert bad == [2] and outcome[2][0] == "error"


def test_alloc_failure_forever_stalls_early(tiny):
    cfg = tiny[0]
    eng = _engine(tiny, False, faults=FaultPlan(seed=1, alloc_fail=1.0),
                  **PAGED)
    eng.submit(_requests(cfg, [7], [4])[0])
    with pytest.raises(Exception, match="no progress"):
        eng.run()
    assert eng.check_invariants()
