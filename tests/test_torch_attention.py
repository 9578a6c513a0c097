"""The port's chunked flash attention and the cache modes of its attention
block against the JAX package on the CPU.

``flash_attention`` is the reference's double-chunked online softmax in
the same order of operations, so it agrees with JAX to float rounding of
the einsums (1e-5 here). At the model level the bar is the repo's 1e-4 on
logits, with the tiny llama32 at ``attn_chunk = 8`` so that prompts of 21
and 40 tokens span several query and KV chunks, and the chunked prefill
(``prefill_chunk``: write the chunk, attend the cache with ``q_offset``)
is held to JAX's on dense and INT8 caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro.serving import kv_cache as JKV
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.data import DataConfig, ZipfMarkov
from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseModel
from repro_torch.serving import kv_cache as PKV

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
def tiny8():
    """Tiny llama32 with 8-token attention chunks, JAX and port."""
    jmodel = dataclasses.replace(jbuild(jget_tiny(ARCH), remat=False),
                                 attn_chunk=8)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return DenseModel(get_tiny_config(ARCH), attn_chunk=8), params, jmodel, \
        jparams


@pytest.mark.parametrize("sq,skv,q_offset,chunk,causal", [
    (21, 21, 0, 8, True), (40, 40, 0, 8, True), (40, 40, 0, 1024, True),
    (16, 40, 24, 8, True),            # a final chunk at its absolute offset
    (16, 48, 10, 8, True),            # keys past every query: masked
    (5, 13, 0, 4, False)])
def test_flash_attention_matches_jax(sq, skv, q_offset, chunk, causal):
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=q_offset,
                              q_chunk=chunk, kv_chunk=chunk)
    got = L.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            q_offset=q_offset, q_chunk=chunk, kv_chunk=chunk)
    assert got.shape == (2, sq, 4, 16)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [21, 40])
def test_chunked_prefill_logits_match_jax(tiny8, s):
    model, params, jmodel, jparams = tiny8
    toks = ZipfMarkov(DataConfig(512, s, 2)).batch(3)[0]
    got = model.logits(params, {"tokens": torch.from_numpy(toks)})
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    cache = model.init_cache(2, s + 4, device="cpu")
    jcache = jmodel.init_cache(2, s + 4, jnp.float32)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               cache)
    want, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                  jcache)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                    rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_prefill_chunk_matches_jax(tiny8, quantized):
    """A 40-token prompt in chunks of 16 against one slot's cache rows of
    T = 44 (the last chunk's padded tail falls past the edge and is
    dropped), then one decode step at a per-slot position."""
    model, params, jmodel, jparams = tiny8
    cfg, jcfg = model.cfg, jmodel.cfg
    prompt = ZipfMarkov(DataConfig(512, 40, 1)).batch(5)[0]
    t, w = 44, 16
    jc = JKV.init_slot_cache(jcfg, JKV.KVCacheConfig(num_slots=1, max_len=t,
                                                     quantized=quantized))
    pc = PKV.init_slot_cache(cfg, PKV.KVCacheConfig(num_slots=1, max_len=t,
                                                    quantized=quantized),
                             device="cpu")
    jstep = jax.jit(jmodel.prefill_chunk)
    for start in range(0, 48, w):
        clen = min(w, 40 - start)
        chunk = np.zeros((1, w), np.int32)
        chunk[0, :clen] = prompt[0, start:start + clen]
        jc = dict(jc, pos=jnp.int32(start))
        want, jc = jstep(jparams, {"tokens": jnp.asarray(chunk)}, jc,
                         jnp.asarray([clen]))
        pc = dict(pc, pos=start)
        got, pc = model.prefill_chunk(params,
                                      {"tokens": torch.from_numpy(chunk)},
                                      pc, torch.tensor([clen]))
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if quantized:                      # the same codes, bar a rounding flip
        same = (pc["k"].codes.numpy() == np.asarray(jc["k"].codes)).mean()
        assert same > 0.999
    tok = np.array(jnp.argmax(want[:, 0], -1))[:, None]
    jc = dict(jc, pos=jnp.asarray([40], jnp.int32))
    pc = dict(pc, pos=torch.tensor([40], dtype=torch.int32))
    for fused in (False, True):
        jm = dataclasses.replace(jmodel, use_fused_decode=fused)
        pm = DenseModel(cfg, attn_chunk=8, use_fused_decode=fused)
        want, _ = jax.jit(jm.decode_step)(jparams, jnp.asarray(tok), dict(jc))
        got, _ = pm.decode_step(params, torch.from_numpy(tok), dict(pc))
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_paged_block_table_is_not_ported(tiny8):
    """What the paged layout still refuses, as the reference does: a plain
    prefill (s > 1 without the chunked-prefill contract) through a block
    table — the engine's batched prefill fills a dense mini-cache and
    splices it with ``write_pages``."""
    model, params, _, _ = tiny8
    cfg = model.cfg
    cache = PKV.init_paged_storage(cfg, 2, 4, device="cpu")
    cache.update(pos=0, table=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="chunked-prefill contract"):
        model.prefill(params, {"tokens": torch.ones((1, 4), dtype=torch.int64)},
                      cache)


# ---------------------------------------------------------------------------
# paged layout: writes through the table, the in-tile paged flash attention
# ---------------------------------------------------------------------------

def _jq(a, group):
    return jax.jit(JKV.kv_quantize, static_argnums=1)(jnp.asarray(a), group)


def _pq(jq):
    return PKV.QuantizedKV(*(torch.from_numpy(np.array(x)) for x in
                             (jq.codes, jq.scale, jq.zero)), jq.group_size)


def _same(port, jax_entry):
    if isinstance(port, PKV.QuantizedKV):
        for mine, theirs in zip(port[:3], jax_entry[:3]):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    else:
        np.testing.assert_array_equal(port.numpy(), np.asarray(jax_entry))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_paged_write_matches_jax(quantized):
    """Per-slot one-token writes (parked rows and positions past the table
    dropped) and chunk writes (the tail past the request's pages dropped)
    through a block table, exactly as the reference's scatter."""
    rng = np.random.default_rng(11)
    p_num, page, hk, d = 7, 4, 2, 16
    pool = rng.standard_normal((p_num, page, hk, d)).astype(np.float32)
    table = np.array([[3, 0, 7], [7, 7, 7], [5, 6, 1]], np.int32)
    cases = [(np.array([5, 0, 11], np.int32), 1),    # row 1 parked: dropped
             (np.array([12, 2, 3], np.int32), 1),    # 12 past the table
             (6, 5)]                                 # cols 6..10: 8+ drop
    for pos, s in cases:
        new = rng.standard_normal((3, s, hk, d)).astype(np.float32)
        if quantized:
            jentry, pentry = _jq(pool, 8), _pq(_jq(pool, 8))
        else:
            jentry, pentry = jnp.asarray(pool), torch.from_numpy(pool.copy())
        jpos = jnp.asarray(pos) if np.ndim(pos) else pos
        want = jax.jit(JL.paged_write, static_argnums=4)(
            jentry, jnp.asarray(table), jpos, jnp.asarray(new), page)
        ppos = torch.from_numpy(pos) if np.ndim(pos) else pos
        got = L.paged_write(pentry, torch.from_numpy(table), ppos,
                            torch.from_numpy(new), page)
        _same(got, want)
    # every write dropped: the pool is untouched
    pentry = torch.from_numpy(pool.copy())
    L.paged_write(pentry, torch.full((2, 2), p_num, dtype=torch.int32),
                  torch.tensor([1, 5]), torch.ones((2, 1, hk, d)), page)
    assert torch.equal(pentry, torch.from_numpy(pool))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("q_offset,sq,chunk", [(0, 13, 8), (16, 16, 8),
                                               (10, 5, 1024)])
def test_flash_attention_paged_matches_jax(quantized, q_offset, sq, chunk):
    """``flash_attention(kv_pages=(table, page))`` over shuffled pools with
    a sentinel-padded table, against the reference's in-tile paged flash
    attention, within 1e-5; INT8 pools expand each gathered tile."""
    rng = np.random.default_rng(q_offset + sq)
    p_num, page, hk, g, d = 9, 4, 2, 2, 16
    k = rng.standard_normal((p_num, page, hk, d)).astype(np.float32)
    v = rng.standard_normal((p_num, page, hk, d)).astype(np.float32)
    q = rng.standard_normal((2, sq, hk * g, d)).astype(np.float32)
    table = np.array([[6, 2, 8, 0, 4, 9, 9], [1, 3, 5, 7, 9, 9, 9]],
                     np.int32)
    if quantized:
        jk, jv = _jq(k, 8), _jq(v, 8)
        pk, pv = _pq(jk), _pq(jv)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        pk, pv = torch.from_numpy(k), torch.from_numpy(v)
    want = JL.flash_attention(jnp.asarray(q), jk, jv, causal=True,
                              q_offset=q_offset, q_chunk=chunk,
                              kv_chunk=chunk,
                              kv_pages=(jnp.asarray(table), page))
    got = L.flash_attention(torch.from_numpy(q), pk, pv, causal=True,
                            q_offset=q_offset, q_chunk=chunk, kv_chunk=chunk,
                            kv_pages=(torch.from_numpy(table), page))
    assert got.shape == (2, sq, hk * g, d)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_paged_prefill_chunk_and_decode_match_jax(tiny8, quantized):
    """A 21-token prompt in chunks of 8 through one table row (pages
    shuffled, tail sentinel), then one decode step at a per-slot position
    through the same row and a parked row, fused (K6p) and not, against
    the JAX model on the same pools."""
    model, params, jmodel, jparams = tiny8
    cfg, jcfg = model.cfg, jmodel.cfg
    prompt = ZipfMarkov(DataConfig(512, 21, 1)).batch(7)[0]
    p_num, page, w = 10, 4, 8
    jkv = JKV.init_paged_storage(jcfg, p_num, page, quantized=quantized)
    pkv = PKV.init_paged_storage(cfg, p_num, page, quantized=quantized,
                                 device="cpu")
    row = np.array([[7, 2, 9, 4, 0, 5, 10, 10]], np.int32)
    jstep = jax.jit(jmodel.prefill_chunk)
    for start in range(0, 24, w):
        clen = min(w, 21 - start)
        chunk = np.zeros((1, w), np.int32)
        chunk[0, :clen] = prompt[0, start:start + clen]
        jc = dict(jkv, pos=jnp.int32(start), table=jnp.asarray(row))
        want, jc = jstep(jparams, {"tokens": jnp.asarray(chunk)}, jc,
                         jnp.asarray([clen]))
        jkv = {"k": jc["k"], "v": jc["v"]}
        pc = dict(pkv, pos=start, table=torch.from_numpy(row))
        got, pc = model.prefill_chunk(params,
                                      {"tokens": torch.from_numpy(chunk)},
                                      pc, torch.tensor([clen]))
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if quantized:                      # the same codes, bar a rounding flip
        same = (pkv["k"].codes.numpy() == np.asarray(jkv["k"].codes)).mean()
        assert same > 0.999
    tok = np.array([[int(jnp.argmax(want[0, 0]))], [0]])
    tables = np.concatenate([row, np.full_like(row, p_num)])
    for fused in (False, True):
        jm = dataclasses.replace(jmodel, use_fused_decode=fused)
        pm = DenseModel(cfg, attn_chunk=8, use_fused_decode=fused)
        jc = dict(jkv, pos=jnp.asarray([21, 0], jnp.int32),
                  table=jnp.asarray(tables))
        want, _ = jax.jit(jm.decode_step)(jparams, jnp.asarray(tok), jc)
        pc = {n: (PKV.QuantizedKV(*(t.clone() for t in e[:3]), e.group_size)
                  if quantized else e.clone()) for n, e in pkv.items()}
        pc.update(table=torch.from_numpy(tables),
                  pos=torch.tensor([21, 0], dtype=torch.int32))
        got, _ = pm.decode_step(params, torch.from_numpy(tok), pc)
        assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4,
                        atol=1e-4)
