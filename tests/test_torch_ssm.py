"""The port's SSM and hybrid families (``repro_torch.models.mamba``: Mamba-1,
falcon-mamba-7b; ``repro_torch.models.mamba2``: Mamba-2 blocks and
Zamba2's shared attention block, zamba2-1.2b) on the CPU, held to the JAX
package on the same numpy inputs and, for the models, on JAX's random init
carried into the port.

Bars: the configs field for field and their parameter counts; the causal
conv, the SSM coefficients and the softplus within 1e-6 (the softplus at
25 and 40, where ``torch.nn.functional.softplus`` would return x); both
scans at chunk 8 over 20 and 24 tokens (the state carried across chunks,
a padded last chunk) within rtol 1e-5, atol 1e-6 (the port advances the
Mamba-1 state token by token where the reference runs an associative
scan: the same recurrence, other f32 rounding); the blocks with their
captures and states within 1e-5; whole-model logits, prefill and each
decode step against JAX's cached path within 1e-4
(``tests/test_torch_model.py``); the port's decode against its own full
forward within 6e-4 (``tests/test_models_smoke.py``); Zamba2's shared
block invoked before every group, in the forward and the cached pass.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.models import mamba as jmamba
from repro.models import mamba2 as jmamba2
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (DenseModel, MambaModel, Zamba2Model,
                                build_model)
from repro_torch.models import mamba, mamba2
from repro_torch.models import transformer as T

ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny shapes: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Each arch's tiny model in both packages, on JAX's init."""
    out = {}
    for arch in ARCHS:
        jmodel = jbuild(jget_tiny(arch), remat=False)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        out[arch] = (build_model(get_tiny_config(arch)),
                     params_from_numpy(_np(jparams), device="cpu"),
                     jmodel, jparams)
    return out


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "tiny"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_agree_field_for_field(arch, which):
    cfg = (get_config if which == "full" else get_tiny_config)(arch)
    jcfg = (jget_config if which == "full" else jget_tiny)(arch)
    mine = {f.name for f in dataclasses.fields(ModelConfig)}
    for f in dataclasses.fields(jcfg):
        if f.name in mine:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        else:
            assert getattr(jcfg, f.name) == f.default, f.name
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.d_inner == jcfg.d_inner
    assert cfg.padded_vocab == jcfg.padded_vocab


def test_build_model_picks_the_family():
    falcon, zamba = (get_tiny_config(a) for a in ARCHS)
    assert type(build_model(falcon)) is MambaModel
    assert type(build_model(zamba)) is Zamba2Model
    with pytest.raises(ValueError, match="ssm"):
        DenseModel(falcon)
    with pytest.raises(ValueError, match="hybrid"):
        MambaModel(zamba)


def test_init_keeps_the_reference_structure():
    """The port's own init (the card's weights) has the reference's leaves
    and shapes, A_log = log(1..N), softplus(dt_bias) in [1e-3, 1e-1], and
    Zamba2's shared block unstacked."""
    for arch in ARCHS:
        cfg = get_tiny_config(arch)
        params = build_model(cfg).init(0, device="cpu")
        jparams = jax.eval_shape(jbuild(jget_tiny(arch)).init,
                                 jax.random.PRNGKey(0))
        shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
        assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
        dt = mamba.softplus(params["blocks"]["dt_bias"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
        assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    a_log = build_model(get_tiny_config(ARCHS[0])).init(
        0, device="cpu")["blocks"]["A_log"]
    assert torch.allclose(a_log[1, 5], torch.log(torch.arange(1.0, 9.0)))


# ---------------------------------------------------------------------------
# pieces of the Mamba-1 block
# ---------------------------------------------------------------------------

def test_softplus_is_jaxs_above_torchs_threshold():
    x = np.array([-40.0, -3.0, 0.0, 0.5, 19.9, 20.1, 25.0, 40.0],
                 np.float32)
    got = mamba.softplus(_t(x)).numpy()
    assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))),
                    rtol=1e-6, atol=1e-7)
    assert_allclose(got[-2:], [25.0, 40.0], rtol=1e-7)


_BLOCK_PARAMS = {}


def _block_params(arch):
    """Block 0's params of a JAX init (seed 1), as numpy; made once an
    arch."""
    if arch not in _BLOCK_PARAMS:
        jmodel = jbuild(jget_tiny(arch), remat=False)
        _BLOCK_PARAMS[arch] = jax.tree.map(
            lambda a: np.asarray(a[0]),
            jax.jit(jmodel.init)(jax.random.PRNGKey(1))["blocks"])
    return _BLOCK_PARAMS[arch]


def test_causal_conv_and_coeffs_match_jax():
    cfg = get_tiny_config(ARCHS[0])
    p = _block_params(ARCHS[0])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 13, cfg.d_inner)).astype(np.float32)
    assert_allclose(
        mamba._causal_conv(_t(x), _t(p["conv_w"]), _t(p["conv_b"])).numpy(),
        np.asarray(jmamba._causal_conv(x, p["conv_w"], p["conv_b"])),
        rtol=1e-6, atol=1e-6)
    got = mamba._ssm_coeffs({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    want = jmamba._ssm_coeffs(p, jnp.asarray(x), jget_tiny(ARCHS[0]))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("length", [20, 24])
def test_mamba_scan_matches_jax(length):
    """Chunk 8 over 20 tokens (two whole chunks and a padded third) and
    24 (three whole), from a nonzero state."""
    cfg, jcfg = get_tiny_config(ARCHS[0]), jget_tiny(ARCHS[0])
    p = _block_params(ARCHS[0])
    rng = np.random.default_rng(3)
    xc = rng.normal(size=(2, length, cfg.d_inner)).astype(np.float32)
    h0 = rng.normal(size=(2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    y, h = mamba._mamba_scan_y({k: _t(v) for k, v in p.items()}, _t(xc),
                               cfg, _t(h0), 8)
    jy, jh = jmamba._mamba_scan_y(p, jnp.asarray(xc), jcfg, jnp.asarray(h0),
                                  8)
    assert y.shape == (2, length, cfg.d_inner)
    assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


@pytest.mark.parametrize("length", [20, 24])
def test_ssd_chunked_matches_jax(length):
    cfg = get_tiny_config(ARCHS[1])
    nh, hd, n = (cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim,
                 cfg.ssm_state)
    rng = np.random.default_rng(4)
    xh = rng.normal(size=(2, length, nh, hd)).astype(np.float32)
    dtv = rng.uniform(1e-3, 0.3, size=(2, length, nh)).astype(np.float32)
    a_log = -dtv * rng.uniform(0.5, 2.0, size=(nh,)).astype(np.float32)
    bc, cc = (rng.normal(size=(2, length, n)).astype(np.float32)
              for _ in range(2))
    h0 = rng.normal(size=(2, nh, hd, n)).astype(np.float32)
    args = (xh, dtv, a_log, bc, cc, h0)
    y, h = mamba2._ssd_chunked(*map(_t, args), 8)
    jy, jh = jmamba2._ssd_chunked(*map(jnp.asarray, args), 8)
    assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


_APPLY = {ARCHS[0]: (mamba.mamba_apply, jmamba.mamba_apply,
                     ("mamba_in", "mamba_out_in")),
          ARCHS[1]: (mamba2.mamba2_apply, jmamba2.mamba2_apply,
                     ("mamba2_in", "mamba2_out_in"))}


@pytest.mark.parametrize("with_state", [False, True], ids=["fwd", "state"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_apply_matches_jax(arch, with_state):
    """Either block at chunk 8 over 20 tokens: its output, captures and,
    from a nonzero state, the new conv and SSM state."""
    cfg, jcfg = get_tiny_config(arch), jget_tiny(arch)
    apply, japply, keys = _APPLY[arch]
    p = _block_params(arch)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    state = jstate = None
    if with_state:
        ssm = (cfg.d_inner, cfg.ssm_state) if arch == ARCHS[0] else (
            cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state)
        st = {"conv": rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner)),
              "ssm": rng.normal(size=(2,) + ssm)}
        st = {k: v.astype(np.float32) for k, v in st.items()}
        state = {k: _t(v) for k, v in st.items()}
        jstate = {k: jnp.asarray(v) for k, v in st.items()}
    cap, jcap = {}, {}
    out, new = apply({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                     capture=cap, state=state, chunk=8)
    jout, jnew = japply(p, jnp.asarray(x), jcfg, capture=jcap, state=jstate,
                        chunk=8)
    assert set(cap) == set(jcap) == set(keys)
    for k in keys:
        assert_allclose(cap[k].numpy(), np.asarray(jcap[k]), rtol=1e-5,
                        atol=1e-5)
    assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    if with_state:
        for k in ("conv", "ssm"):
            assert_allclose(new[k].numpy(), np.asarray(jnew[k]), rtol=1e-5,
                            atol=1e-5)
    else:
        assert new is None and jnew is None


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 8], ids=["chunk-default", "chunk8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(models, arch, chunk):
    model, params, jmodel, jparams = models[arch]
    if chunk:
        model = build_model(model.cfg)
        model.scan_chunk = chunk
        jmodel = dataclasses.replace(jmodel, scan_chunk=chunk)
    toks = _tokens(model.cfg.vocab_size, 2, 20)
    got = model.logits(params, {"tokens": _t(toks)})
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_apply_one_and_linears_match_jax(models, arch):
    """The compression protocol: every block (Zamba2's shared block as
    block L) with its captures, and the linears of each."""
    model, params, jmodel, jparams = models[arch]
    toks = _tokens(model.cfg.vocab_size, 2, 12, seed=1)
    h = model.embed(params, {"tokens": _t(toks)})
    jh = jmodel.embed(jparams, {"tokens": jnp.asarray(toks)})
    n = model.cfg.num_layers + (arch == ARCHS[1])
    assert model.num_blocks() == jmodel.num_blocks() == n
    for i in range(n):
        assert model.block_linears(i) == jmodel.block_linears(i)
        out, caps = model.block_apply_one(params, i, h, capture=True)
        jout, jcaps = jmodel.block_apply_one(jparams, i, jh, capture=True)
        assert set(caps) == set(jcaps)
        for k in caps:
            assert_allclose(caps[k].numpy(), np.asarray(jcaps[k]),
                            rtol=1e-4, atol=1e-5)
        assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
        h, jh = out, jout


@pytest.mark.parametrize("chunk", [None, 8], ids=["chunk-default", "chunk8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch, chunk):
    """Prefill of 20 tokens, then four decode steps, each against JAX's
    cached path: logits and every cache entry. At chunk 8 the Mamba-1
    prefill pads its last chunk, whose padded tokens decay the state in
    the reference; the port carries the same state on."""
    model, params, jmodel, jparams = models[arch]
    if chunk:
        model = build_model(model.cfg)
        model.scan_chunk = chunk
        jmodel = dataclasses.replace(jmodel, scan_chunk=chunk)
    toks = _tokens(model.cfg.vocab_size, 2, 20, seed=2)
    cache = model.init_cache(2, 26, device="cpu")
    jcache = jmodel.init_cache(2, 26, jnp.float32)
    logits, cache = model.prefill(params, {"tokens": _t(toks)}, cache)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     jcache)
    for step in range(5):
        assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
        assert set(cache) == set(jcache)
        for k in cache:
            if k != "pos":
                assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                rtol=1e-4, atol=1e-5, err_msg=k)
        assert cache["pos"] == int(jcache["pos"]) == 20 + step
        if step == 4:
            break
        nxt = np.array(jnp.argmax(jlogits[:, -1], -1))[:, None]
        logits, cache = model.decode_step(params, _t(nxt), cache)
        jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt),
                                             jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_full_forward(models, arch):
    """``tests/test_models_smoke.py``'s check on the port alone: prefill,
    one greedy decode step, and the full forward over prompt and token
    agree at the last position within 6e-4."""
    model, params, _, _ = models[arch]
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, 2, 16, seed=3))
    cache = model.init_cache(2, 20, device="cpu")
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    logits2, _ = model.decode_step(params, tok, cache)
    full = model.logits(params, {"tokens": torch.cat([toks, tok], 1)})
    assert_allclose(logits2[:, 0].numpy(), full[:, -1].numpy(), rtol=6e-4,
                    atol=6e-4)


def test_zamba2_shared_block_runs_before_every_group(models, monkeypatch):
    """The tiny Zamba2 (4 blocks, attn_every 2) has two groups: the shared
    block must run twice in the forward, the prefill and each decode step
    (once at the end, as the dense model's loops would, is wrong), each
    decode invocation against its own K/V."""
    model, params, _, _ = models[ARCHS[1]]
    assert model._groups() == [(0, 2), (2, 4)]
    calls = []
    block_apply = T.block_apply

    def counted(p, x, cfg, **kw):
        calls.append(kw.get("kv_cache"))
        return block_apply(p, x, cfg, **kw)
    monkeypatch.setattr(T, "block_apply", counted)
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, 2, 8))
    model.logits(params, {"tokens": toks})
    assert len(calls) == 2
    cache = model.init_cache(2, 10, device="cpu")
    assert cache["k"].shape[0] == 2
    _, cache = model.prefill(params, {"tokens": toks}, cache)
    model.decode_step(params, toks[:, :1], cache)
    assert len(calls) == 6
    assert [kv[0].data_ptr() for kv in calls[2:]] == [
        cache["k"][g].data_ptr() for g in (0, 1, 0, 1)]
    # the second invocation moved the result: its K/V rows are written
    assert bool(cache["k"][1].abs().sum() > 0)
