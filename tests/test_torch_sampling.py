"""The port's per-request sampler against the JAX package's: Threefry-2x32
(``fold_in(PRNGKey(seed), step)``) and ``jax.random.categorical``'s
uniform-to-Gumbel map, token for token; then the slot and paged engines'
sampled streams against the JAX engines' on the tiny llama32. About 40 s
on one process (the JAX engines' compiles).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenerationRequest as JRequest
from repro.serving import SamplingParams as JSampling
from repro.serving.sampling import sample_tokens as jsample
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.models import build_model
from repro_torch.serving import (Engine, EngineConfig, GenerationRequest,
                                 SamplingParams, sample_tokens)

ARCH = "llama32-1b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(logits, temps, top_ks, seeds, steps, max_top_k=64):
    args = [np.asarray(a) for a in (temps, top_ks, seeds, steps)]
    want = np.asarray(jsample(jnp.asarray(logits), jnp.asarray(args[0]),
                              jnp.asarray(args[1]),
                              jnp.asarray(args[2].astype(np.uint32)),
                              jnp.asarray(args[3].astype(np.uint32)),
                              max_top_k=max_top_k))
    got = sample_tokens(torch.from_numpy(logits),
                        torch.from_numpy(args[0].astype(np.float32)),
                        torch.from_numpy(args[1].astype(np.int64)),
                        torch.from_numpy(args[2].astype(np.int64)),
                        torch.from_numpy(args[3].astype(np.int64)),
                        max_top_k=max_top_k).numpy()
    return want, got


def test_probe_matches_the_reference():
    """Logits default_rng(0) (8, 1000) × 3, temperature 1, no top-k, seeds
    and steps 0–7: the reference's tokens."""
    logits = (np.random.default_rng(0).standard_normal((8, 1000)) * 3
              ).astype(np.float32)
    want, got = _both(logits, np.ones(8), np.zeros(8), np.arange(8),
                      np.arange(8))
    assert want.tolist() == [403, 615, 175, 801, 251, 427, 83, 543]
    assert got.tolist() == want.tolist()


CASES = {
    "top_k": dict(temps=[1.0] * 8, top_ks=[1, 2, 5, 8, 16, 40, 64, 0]),
    "temperature": dict(temps=[0.0, 0.25, 0.5, 0.7, 1.0, 1.3, 2.0, 5.0],
                        top_ks=[0] * 8),
    "high_seeds": dict(temps=[1.0] * 8, top_ks=[0, 3] * 4,
                       seeds=[2**32 - 1, 2**32 - 2, 2**31, 2**31 - 1,
                              2**32 - 7, 123456789, 2**32 - 100, 3],
                       steps=[2**32 - 1, 0, 2**31, 7, 2**32 - 2, 1, 99,
                              2**31 - 1]),
    "wide_vocab": dict(temps=[1.0, 0.8, 0.0, 1.5], top_ks=[0, 10, 0, 64],
                       v=129024),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_matches_jax(case):
    c = CASES[case]
    n = len(c["temps"])
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((n, c.get("v", 1000))) * 3
              ).astype(np.float32)
    seeds = c.get("seeds", rng.integers(0, 2**32, n, dtype=np.uint64))
    steps = c.get("steps", rng.integers(0, 2**32, n, dtype=np.uint64))
    want, got = _both(logits, c["temps"], c["top_ks"],
                      np.asarray(seeds, np.uint64),
                      np.asarray(steps, np.uint64))
    assert got.tolist() == want.tolist()


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel = jbuild(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return build_model(cfg), params, jmodel, jparams


LENS, GENS = [5, 13, 8, 21, 3, 16, 9, 30], [6, 3, 9, 4, 8, 5, 2, 7]
SAMPLING = [(1.0, 0), (0.8, 8), (0.0, 0), (1.3, 4), (1.0, 16), (0.6, 0),
            (2.0, 2), (1.0, 1)]


def _reqs(req_cls, sp_cls):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, size=n).astype(np.int32) for n in LENS]
    return [req_cls(rid=i, prompt=p, max_new_tokens=g,
                    sampling=sp_cls(temperature=t, top_k=k, seed=100 + i))
            for i, (p, g, (t, k)) in enumerate(zip(prompts, GENS, SAMPLING))]


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_engine_sampled_streams_match_jax(tiny, layout):
    """Seven of eight requests sample (temperatures 0.6–2, top-k 0–16):
    the port's engine gives the JAX engine's stream, token for token."""
    model, params, jmodel, jparams = tiny
    ecfg = dict(num_slots=4, max_len=64)
    if layout == "paged":
        ecfg.update(kv_layout="paged", page_size=8)
    jeng = JEngine(jmodel, jparams, JEngineConfig(**ecfg))
    for r in _reqs(JRequest, JSampling):
        jeng.submit(r)
    want = {r.rid: r.tokens for r in jeng.run()}
    eng = Engine(model, params, EngineConfig(**ecfg))
    for r in _reqs(GenerationRequest, SamplingParams):
        eng.submit(r)
    got = {r.rid: r.tokens for r in eng.run()}
    assert got == want
