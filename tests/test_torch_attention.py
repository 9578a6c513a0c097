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
    model, params, _, _ = tiny8
    cache = model.init_cache(1, 8, device="cpu")
    cache["table"] = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paging slice"):
        model.prefill(params, {"tokens": torch.ones((1, 4), dtype=torch.int64)},
                      cache)
