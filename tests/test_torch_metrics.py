"""The port's model loss (``chunked_xent``, ``DenseModel.loss``, inherited by
``MoEModel``), ``core/metrics.py`` and the paper's dense configs against the
JAX package on the CPU; and the decode-attention guard over every config.

JAX's random init is carried into the port (``repro_torch.bridge``), tokens
and labels are made with numpy from a seed. Bars: the loss and the NLL sum
within 1e-5 relative (f32 sums in another order), token counts equal,
perplexity within 1e-4 relative, ``recon_loss``, ``condition_number``,
``certified_eta`` and ``sparsity`` within 1e-6; configs equal field for
field.
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
from repro.core import metrics as jmetrics
from repro.models import build_model as jbuild
from repro.models.transformer import chunked_xent as jchunked_xent
from repro.quant import QTensor as JQTensor
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.core import metrics
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.transformer import chunked_xent

NEW_DENSE = ("llama2-7b", "llama2-13b", "llama31-8b", "granite-8b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_dense_configs_match_jax(arch):
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_tiny_config(arch), jget_tiny(arch))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.padded_vocab == theirs.padded_vocab
        assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    assert get_config("llama2-7b").padded_vocab == 32768
    assert arch in list_archs()


def test_every_config_passes_the_decode_attention_guard():
    """K6/K6p take every ported config's head shape, full and tiny, and
    nemotron-4-340b's (g = 12 at D = 192; not ported yet), which the
    32-accumulator generic form takes since the kernel's repair."""
    for arch in list_archs():
        for cfg in (get_config(arch), get_tiny_config(arch)):
            if cfg.num_heads == 0:                  # attention-free (SSM)
                continue
            g = cfg.num_heads // cfg.num_kv_heads
            assert ops.decode_attn_supported(g, cfg.resolved_head_dim), \
                (arch, cfg.name, g, cfg.resolved_head_dim)
    assert {(get_config(a).num_heads // get_config(a).num_kv_heads,
             get_config(a).resolved_head_dim) for a in NEW_DENSE} == \
        {(1, 128), (4, 128)}
    nemotron = jget_config("nemotron-4-340b")
    assert "nemotron-4-340b" not in list_archs()
    assert ops.decode_attn_supported(
        nemotron.num_heads // nemotron.num_kv_heads,
        nemotron.resolved_head_dim)


def _models(arch):
    cfg, jcfg = get_tiny_config(arch), jget_tiny(arch)
    jmodel, model = jbuild(jcfg, remat=False), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, model, jparams, params


def _batch(cfg, seed, b, s, pad_labels=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    if pad_labels:
        labels[:, -pad_labels:] = -1
        labels[0, 1] = -1
    return tokens, labels


def _both_losses(jmodel, model, jparams, params, tokens, labels):
    jloss, jm = jax.jit(jmodel.loss)(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    loss, m = model.loss(params, {"tokens": torch.from_numpy(tokens),
                                  "labels": torch.from_numpy(labels)})
    return (float(jloss), float(jm["sum_nll"]), int(jm["tokens"])), \
        (float(loss), float(m["sum_nll"]), int(m["tokens"]))


@pytest.mark.parametrize("arch,seq,pad", [
    ("llama2-7b", 40, 3),             # one chunk, padding labels
    ("granite-8b", 24, 0),
    ("qwen3-moe-235b-a22b", 20, 2)])  # the MoE inherits the dense loss
def test_loss_matches_jax(arch, seq, pad):
    cfg, jmodel, model, jparams, params = _models(arch)
    tokens, labels = _batch(cfg, 1, 2, seq, pad)
    (jl, jn, jc), (l, n, c) = _both_losses(jmodel, model, jparams, params,
                                           tokens, labels)
    assert c == jc == labels.size - (labels < 0).sum()
    assert abs(n - jn) <= 1e-5 * abs(jn)
    assert abs(l - jl) <= 1e-5 * abs(jl)


@pytest.mark.parametrize("s,chunk", [(37, 16), (48, 16), (5, 512)])
def test_chunked_xent_matches_jax(s, chunk):
    """A sequence that is not a multiple of the chunk, one that is, and one
    shorter than the chunk; padded vocab columns, −1 labels."""
    rng = np.random.default_rng(s)
    h = rng.normal(size=(2, s, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 256)) / 6).astype(np.float32)
    labels = rng.integers(0, 200, (2, s), dtype=np.int32)
    labels[1, ::3] = -1
    jn, jc = jchunked_xent(jnp.asarray(h), jnp.asarray(w),
                           jnp.asarray(labels), chunk=chunk, vocab=200)
    n, c = chunked_xent(torch.from_numpy(h), torch.from_numpy(w),
                        torch.from_numpy(labels), chunk=chunk, vocab=200)
    assert int(c) == int(jc) and c.dtype == torch.int32
    assert_allclose(float(n), float(jn), rtol=1e-5)


def test_loss_with_packed_head_matches_jax():
    cfg, jmodel, model, jparams, _ = _models("llama2-7b")
    jparams = dict(jparams)
    jparams["lm_head"] = JQTensor.from_dense(jparams["lm_head"].T, 4, 32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    assert params["lm_head"].shape == (cfg.padded_vocab, cfg.d_model)
    tokens, labels = _batch(cfg, 2, 2, 24, 1)
    (jl, jn, jc), (l, n, c) = _both_losses(jmodel, model, jparams, params,
                                           tokens, labels)
    assert c == jc
    assert abs(n - jn) <= 1e-5 * abs(jn)
    assert abs(l - jl) <= 1e-5 * abs(jl)


def test_perplexity_matches_jax():
    cfg, jmodel, model, jparams, params = _models("llama2-7b")
    batches = [_batch(cfg, 10 + i, 2, 16, i) for i in range(3)]

    def jloss_fn(p, t, lab):
        _, m = jax.jit(jmodel.loss)(p, {"tokens": t, "labels": lab})
        return m["sum_nll"], m["tokens"]

    def loss_fn(p, t, lab):
        _, m = model.loss(p, {"tokens": t, "labels": lab})
        return m["sum_nll"], m["tokens"]

    jppl = jmetrics.perplexity(jloss_fn, jparams, [
        (jnp.asarray(t), jnp.asarray(lab)) for t, lab in batches])
    ppl = metrics.perplexity(loss_fn, params, [
        (torch.from_numpy(t), torch.from_numpy(lab)) for t, lab in batches])
    assert abs(ppl - jppl) <= 1e-4 * jppl


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 48)).astype(np.float32) * np.exp(
        rng.normal(size=48)).astype(np.float32)
    c = (x.T @ x / 256).astype(np.float32)
    w = rng.normal(size=(24, 48)).astype(np.float32)
    theta = np.where(rng.random((24, 48)) < 0.4, 0.0, w).astype(np.float32)
    jr = float(jmetrics.recon_loss(w, theta, c))
    r = float(metrics.recon_loss(torch.from_numpy(w), torch.from_numpy(theta),
                                 torch.from_numpy(c)))
    assert abs(r - jr) <= 1e-6 * jr
    for fn in ("condition_number", "certified_eta"):
        a, b = getattr(metrics, fn)(torch.from_numpy(c)), \
            getattr(jmetrics, fn)(c)
        assert abs(a - b) <= 1e-6 * abs(b), fn
    assert metrics.sparsity(torch.from_numpy(theta)) == \
        jmetrics.sparsity(theta)
    cd = np.diag([1.0, 4.0]).astype(np.float32)
    assert abs(metrics.condition_number(torch.from_numpy(cd)) - 4.0) < 1e-6
    assert abs(metrics.certified_eta(torch.from_numpy(cd)) - 1 / 8.0) < 1e-9
    jal = float(jmetrics.activation_loss(w, theta, c))
    al = float(metrics.activation_loss(torch.from_numpy(w),
                                       torch.from_numpy(theta),
                                       torch.from_numpy(c)))
    assert abs(al - jal) <= 1e-6 * jal
