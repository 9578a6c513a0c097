"""The port's configs, calibration data, layers and dense model against the
JAX package on the CPU, on the tiny llama32 config.

The JAX model's random init is carried into the port through
``repro_torch.bridge``, so both compute on identical weights. Logits agree
to 1e-4: the two frameworks sum matmuls and attention in another order.
Tokens, configs and greedy decodes agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.data import DataConfig as JDataConfig
from repro.data import ZipfMarkov as JZipfMarkov
from repro.data import calibration_batches as jcalibration_batches
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.data import DataConfig, ZipfMarkov, calibration_batches
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as L

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
    return build_model(cfg), params, jmodel, jparams


def test_configs_match_jax():
    for mine, theirs in ((get_config(ARCH), jget_config(ARCH)),
                         (get_tiny_config(ARCH), jget_tiny(ARCH))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.padded_vocab == theirs.padded_vocab
        assert mine.resolved_head_dim == theirs.resolved_head_dim
        assert mine.param_count() == theirs.param_count()
    assert get_config(ARCH).padded_vocab == 129024


def test_calibration_tokens_equal_jax():
    for kw in ({"vocab_size": 512, "seq_len": 32, "global_batch": 8},
               {"vocab_size": 128256, "seq_len": 64, "global_batch": 4,
                "seed": 3}):
        mine = calibration_batches(DataConfig(**kw), 3)
        theirs = jcalibration_batches(JDataConfig(**kw), 3)
        for (t, l), (jt, jl) in zip(mine, theirs):
            assert_array_equal(t, jt)
            assert_array_equal(l, jl)
    assert_array_equal(ZipfMarkov(DataConfig(512, 16, 2)).batch(7, 1, 2)[0],
                       JZipfMarkov(JDataConfig(512, 16, 2)).batch(7, 1, 2)[0])


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8)[None], (2, 5)).astype(np.int32)
    assert_allclose(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5).numpy(),
                    np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
                    rtol=1e-5, atol=1e-5)
    g = rng.standard_normal(32).astype(np.float32)
    assert_allclose(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                    np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
                    rtol=1e-5, atol=1e-6)
    for kind in ("silu", "gelu", "relu2"):
        assert_allclose(L.mlp_act(torch.from_numpy(x), kind).numpy(),
                        np.asarray(JL.mlp_act(jnp.asarray(x), kind)),
                        rtol=1e-5, atol=1e-6)


def test_logits_match_jax(tiny):
    model, params, jmodel, jparams = tiny
    toks = ZipfMarkov(DataConfig(512, 24, 3)).batch(0)[0]
    got = model.logits(params, {"tokens": torch.from_numpy(toks)})
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_block_capture_matches_jax(tiny):
    model, params, jmodel, jparams = tiny
    toks = ZipfMarkov(DataConfig(512, 16, 2)).batch(1)[0]
    h = model.embed(params, {"tokens": torch.from_numpy(toks)})
    jh = jmodel.embed(jparams, {"tokens": jnp.asarray(toks)})
    out, caps = model.block_apply_one(params, 2, h, capture=True)
    jout, jcaps = jmodel.block_apply_one(jparams, 2, jh, capture=True)
    assert set(caps) == set(jcaps) == {"attn_in", "attn_out_in", "mlp_in",
                                       "mlp_down_in"}
    for key in caps:
        assert_allclose(caps[key].numpy(), np.asarray(jcaps[key]),
                        rtol=1e-4, atol=1e-5)
    assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    assert model.block_linears(0) == jmodel.block_linears(0)


def test_prefill_decode_and_greedy_match_jax(tiny):
    model, params, jmodel, jparams = tiny
    toks = ZipfMarkov(DataConfig(512, 12, 2)).batch(2)[0]
    cache = model.init_cache(2, 20, torch.float32, device="cpu")
    jcache = jmodel.init_cache(2, 20, jnp.float32)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  cache)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     jcache)
    assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    nxt = np.array(jnp.argmax(jlogits[:, -1], -1))[:, None]
    logits, cache = model.decode_step(params, torch.from_numpy(nxt), cache)
    jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache)
    assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert cache["pos"] == int(jcache["pos"]) == 13
    assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                    rtol=1e-4, atol=1e-5)

    class Req:
        prompt = toks[0]
        max_new_tokens = 6
    assert (serve.static_greedy_reference(model, params, Req, 24)
            == jserve.static_greedy_reference(jmodel, jparams, Req, 24))


def test_serve_cli_runs_on_cpu():
    seqs = serve.main(["--tiny", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"])
    assert seqs.shape == (2, 4)
