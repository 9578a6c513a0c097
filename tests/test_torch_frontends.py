"""The port's audio and vlm families (musicgen-medium's frame stub,
internvl2-1b's patch stub) on the CPU, held to the JAX package on the
tiny presets; the configs and batches of the last dense configs
(starcoder2-7b, starcoder2-15b, nemotron-4-340b) too, whose compression
and CLIs ``tests/test_torch_dense_configs.py`` holds.

JAX's random init is carried into the port (``repro_torch.bridge``), and
each batch comes from the reference's ``make_batch``: frames and patches
drawn in f32 and rounded to bf16, carried across as those bf16 values.
Bars: configs and ``param_count`` equal field for field; ``embed`` equal
bit for bit; logits within 1e-4; the loss (a vlm batch's on its text
positions only) within 1e-5 relative with equal token counts; the cached
prefill and four decode steps within 1e-4, cache entries within 1e-5;
compression with both of the port's engines against JAX's batched engine
at the chip's mixed policy (per-layer loss within 1e-5, masks and codes
equal on at least 99.9% of entries, equal iteration counts); packed
checkpoints both ways with prefill logits within 2e-5; the continuous
engine's and the CLIs' refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.checkpoint import load_packed_checkpoint as jload_packed
from repro.checkpoint import save_packed_checkpoint as jsave_packed
from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.models import batch_specs as jbatch_specs
from repro.models import build_model as jbuild
from repro.models import make_batch as jmake_batch
from repro.serving import Engine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (load_packed_checkpoint, pack_params,
                                    save_packed_checkpoint)
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.core import specs
from repro_torch.core.compress import compress_model
from repro_torch.launch import compress as compress_cli
from repro_torch.launch import serve, train
from repro_torch.models import (DenseModel, MoEModel, batch_specs,
                                build_model, make_batch)
from repro_torch.serving import Engine

AUDIO, VLM = "musicgen-medium", "internvl2-1b"
FRONTEND_ARCHS = [AUDIO, VLM]
DENSE_ARCHS = ["starcoder2-7b", "starcoder2-15b", "nemotron-4-340b"]
NEW_ARCHS = FRONTEND_ARCHS + DENSE_ARCHS
KEY = {AUDIO: "frames", VLM: "patches"}
# chip_smoke.py's main path at the tiny widths' group: every wo AWP-pruned
# to 50%, every other linear AWP-int4
POLICIES = {
    "mixed": lambda m: m.Policy({"*.attn.wo": m.PruneSpec(ratio=0.5)},
                                default=m.QuantSpec(bits=4, group_size=32)),
}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(batch):
    """A JAX batch as the port's: int arrays as int64, bf16 embeddings as
    the same bf16 values."""
    out = {}
    for k, v in batch.items():
        if v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(
                np.array(v.astype(jnp.float32))).to(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v, dtype=np.int64))
    return out


class _Tiny(dict):
    """Each arch's tiny model in both packages on JAX's init, one
    calibration batch of 2 x 24 positions from the reference's
    ``make_batch`` on both sides, and a cache of JAX's compressions; made
    when a test first asks for the arch."""

    def __missing__(self, arch):
        cfg, jcfg = get_tiny_config(arch), jget_tiny(arch)
        jmodel = jbuild(jcfg, remat=False)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        jcal = [jmake_batch(jcfg, jax.random.PRNGKey(1), 2, 24)]
        self[arch] = dict(
            cfg=cfg, model=build_model(cfg), jmodel=jmodel, jparams=jparams,
            params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu"),
            jcal=jcal, cal=[_to_port(b) for b in jcal], jax_runs={})
        return self[arch]


@pytest.fixture(scope="module")
def tiny():
    return _Tiny()


def _jax_run(t, policy):
    """(params, report) of JAX's batched engine at ``policy``, once."""
    if policy not in t["jax_runs"]:
        t["jax_runs"][policy] = jcompress_model(
            t["jmodel"], t["jparams"], t["jcal"], POLICIES[policy](jspecs),
            engine="batched")
    return t["jax_runs"][policy]


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


# ---------------------------------------------------------------------------
# configs, the registry and batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_jax(arch):
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_tiny_config(arch), jget_tiny(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.padded_vocab == theirs.padded_vocab
        assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    assert arch in list_archs()
    assert get_config(VLM).padded_vocab == 153600


def test_build_model_takes_the_frontend_families():
    """Both frontend families build the dense model; any other pairing of
    family and frontend is refused, and the MoE model keeps its own."""
    for arch in FRONTEND_ARCHS:
        assert type(build_model(get_tiny_config(arch))) is DenseModel
    audio, vlm = get_tiny_config(AUDIO), get_tiny_config(VLM)
    dense = get_tiny_config("starcoder2-7b")
    for cfg in (dataclasses.replace(audio, frontend=None),
                dataclasses.replace(audio, frontend="vision_patches"),
                dataclasses.replace(vlm, frontend="audio_frames"),
                dataclasses.replace(dense, frontend="vision_patches")):
        with pytest.raises(ValueError, match="audio/audio_frames"):
            DenseModel(cfg)
    with pytest.raises(ValueError, match="moe"):
        MoEModel(vlm)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_batch_specs_and_make_batch(arch):
    """The reference's shapes; tokens and labels in the port's pipeline
    dtype, frames and patches bf16; ``make_batch`` the same numbers from
    the same seed, tokens within the vocabulary."""
    cfg = get_tiny_config(arch)
    want = jbatch_specs(jget_tiny(arch), 2, 24)
    got = batch_specs(cfg, 2, 24)
    assert list(got) == list(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape, name
        assert dtype == (torch.bfloat16 if want[name].dtype == jnp.bfloat16
                         else torch.int64), name
    a, b = (make_batch(cfg, torch.Generator().manual_seed(3), 2, 24,
                       device="cpu") for _ in range(2))
    for name, (shape, dtype) in got.items():
        assert a[name].shape == shape and a[name].dtype == dtype
        assert torch.equal(a[name], b[name])
        if dtype == torch.int64:
            assert 0 <= int(a[name].min()) and \
                int(a[name].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# the forward: embed, logits, loss, the cached paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_embed_matches_jax(tiny, arch):
    """Frames cast to the params' dtype; patches ahead of the token
    embeddings: bit for bit."""
    t = tiny[arch]
    got = t["model"].embed(t["params"], t["cal"][0])
    want = t["jmodel"].embed(t["jparams"], t["jcal"][0])
    assert got.dtype == torch.float32
    assert_array_equal(got.numpy(), np.asarray(want))
    if arch == VLM:
        p = t["cfg"].num_patches
        assert_array_equal(got[:, :p].numpy(),
                           t["cal"][0]["patches"].float().numpy())
    with pytest.raises(ValueError, match=KEY[arch]):
        t["model"].embed(t["params"], {"tokens": torch.zeros(
            (2, 4), dtype=torch.int64)})


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_logits_match_jax(tiny, arch):
    t = tiny[arch]
    got = t["model"].logits(t["params"], t["cal"][0])
    want = t["jmodel"].logits(t["jparams"], t["jcal"][0])
    assert got.shape == (2, 24, t["cfg"].padded_vocab)
    assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_loss_matches_jax(tiny, arch):
    """The chunked loss; a vlm batch's only on its text positions (its
    labels cover the tokens, not the patches)."""
    t = tiny[arch]
    loss, m = t["model"].loss(t["params"], t["cal"][0])
    jloss, jm = t["jmodel"].loss(t["jparams"], t["jcal"][0])
    text = 24 - t["cfg"].num_patches
    assert int(m["tokens"]) == int(jm["tokens"]) == 2 * text
    assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_allclose(float(m["sum_nll"]), float(jm["sum_nll"]), rtol=1e-5)


def _assert_cache(cache, jcache):
    assert set(cache) == set(jcache)
    for k in ("k", "v"):
        assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=1e-4,
                        atol=1e-5, err_msg=k)
    assert cache["pos"] == int(jcache["pos"])


def test_vlm_prefill_and_decode_match_jax(tiny):
    """internvl2-1b's prefill over 16 patches and 8 tokens, then four
    decode steps, each against JAX's cached path: logits and every cache
    entry; rope positions run over patches and text together. The port's
    static greedy decode with the patches gives JAX's tokens."""
    t = tiny[VLM]
    model, jmodel = t["model"], t["jmodel"]
    batch, jbatch = _inputs(t["cal"][0]), _inputs(t["jcal"][0])
    cache = model.init_cache(2, 30, device="cpu")
    jcache = jmodel.init_cache(2, 30, jnp.float32)
    logits, cache = model.prefill(t["params"], batch, cache)
    jlogits, jcache = jmodel.prefill(t["jparams"], jbatch, jcache)
    want = []
    for step in range(5):
        assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
        _assert_cache(cache, jcache)
        assert cache["pos"] == 24 + step
        nxt = np.array(jnp.argmax(jlogits[:, -1], -1))[:, None]
        want.append(nxt)
        if step == 4:
            break
        logits, cache = model.decode_step(t["params"], torch.from_numpy(nxt),
                                          cache)
        jlogits, jcache = jmodel.decode_step(t["jparams"], jnp.asarray(nxt),
                                             jcache)
    toks, _ = serve.greedy_decode(model, t["params"], batch["tokens"], 5,
                                  inputs={"patches": batch["patches"]})
    assert_array_equal(toks, np.concatenate(want, axis=1))


def test_audio_frames_prefill_matches_jax(tiny):
    """musicgen-medium's prefill over 24 frames against JAX's: the last
    position's logits and the cache (the reference has no token decode
    for the frame stub)."""
    t = tiny[AUDIO]
    model, jmodel = t["model"], t["jmodel"]
    cache = model.init_cache(2, 28, device="cpu")
    jcache = jmodel.init_cache(2, 28, jnp.float32)
    logits, cache = model.prefill(t["params"], _inputs(t["cal"][0]), cache)
    jlogits, jcache = jmodel.prefill(t["jparams"], _inputs(t["jcal"][0]),
                                     jcache)
    assert logits.shape == (2, 1, t["cfg"].padded_vocab)
    assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    _assert_cache(cache, jcache)
    assert cache["pos"] == 24


# ---------------------------------------------------------------------------
# compression against JAX's batched engine
# ---------------------------------------------------------------------------

def _assert_reports(rep, jrep):
    assert [(r.qualname, r.method) for r in rep] == \
        [(r.qualname, r.method) for r in jrep]
    for r, jr in zip(rep, jrep):
        assert abs(r.loss_after - jr.loss_after) <= 1e-5, r.qualname
        art, jart = rep.artifacts[r.qualname], jrep.artifacts[r.qualname]
        assert art.result.iters == jart.result.iters, r.qualname
        if jart.result.mask is not None:
            agree = (art.result.mask == np.asarray(jart.result.mask)).mean()
            assert agree >= 0.999, (r.qualname, agree)
        if jart.result.qtensor is not None:
            agree = (art.result.qtensor.codes().numpy()
                     == np.asarray(jart.result.qtensor.codes())).mean()
            assert agree >= 0.999, (r.qualname, agree)


@pytest.mark.parametrize("engine", ["batched", "sequential"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_engines_match_jax(tiny, arch, engine):
    """The reference's ``FAMILY_ARCHS`` frontends through both of the
    port's engines at the mixed policy (pruned wo, int4 elsewhere):
    calibration reaches the frontends only through ``embed``; the result's
    loss is finite, as the reference's family sweep asks."""
    t = tiny[arch]
    _, jrep = _jax_run(t, "mixed")
    cp, rep = compress_model(t["model"], t["params"], t["cal"],
                             POLICIES["mixed"](specs), engine=engine)
    _assert_reports(rep, jrep)
    assert len(rep) == t["cfg"].num_layers * len(t["model"].block_linears(0))
    assert {r.method for r in rep} == {"awp_prune", "awp_quant"}
    loss, _ = t["model"].loss(cp, t["cal"][0])
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# packed checkpoints both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_jax_packed_checkpoint_serves_as_in_jax(tiny, arch, tmp_path):
    """JAX's mixed-policy compression saved packed by JAX and read by both
    packages: the same codes, and the port's prefill logits from frames or
    patches are JAX's within 2e-5."""
    t = tiny[arch]
    jcp, jrep = _jax_run(t, "mixed")
    path = jsave_packed(str(tmp_path), 0, jcp, jrep)
    jloaded, _, _ = jload_packed(path, t["jparams"])
    loaded, qts, _ = load_packed_checkpoint(path, t["params"], device="cpu")
    assert len(qts) == len(jrep.packed_layers())
    assert_array_equal(loaded["blocks"]["mlp"]["wd"].packed.numpy(),
                       np.asarray(jloaded["blocks"]["mlp"]["wd"].packed))
    want, _ = t["jmodel"].prefill(jloaded, _inputs(t["jcal"][0]),
                                  t["jmodel"].init_cache(2, 26, jnp.float32))
    got, _ = t["model"].prefill(loaded, _inputs(t["cal"][0]),
                                t["model"].init_cache(2, 26, device="cpu"))
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_port_packed_checkpoint_reads_in_jax(tiny, arch, tmp_path):
    """The port's mixed-policy compression saved packed by the port and
    read by JAX: every packed leaf holds the port's codes, and JAX's
    prefill logits from it are the port's within 2e-5."""
    t = tiny[arch]
    cp, rep = compress_model(t["model"], t["params"], t["cal"],
                             POLICIES["mixed"](specs))
    path = save_packed_checkpoint(str(tmp_path), 0, cp, rep)
    jloaded, jqts, _ = jload_packed(path, t["jparams"])
    packed = pack_params(cp, rep)
    assert len(jqts) == len(rep.packed_layers())
    for g, n in (("attn", "wq"), ("mlp", "wd")):
        qt, jqt = packed["blocks"][g][n], jloaded["blocks"][g][n]
        for f in ("packed", "scale", "zero"):
            assert_array_equal(getattr(qt, f).numpy(),
                               np.asarray(getattr(jqt, f)))
    want, _ = t["jmodel"].prefill(jloaded, _inputs(t["jcal"][0]),
                                  t["jmodel"].init_cache(2, 26, jnp.float32))
    got, _ = t["model"].prefill(packed, _inputs(t["cal"][0]),
                                t["model"].init_cache(2, 26, device="cpu"))
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# refusals and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_engine_refuses_frontends(tiny, arch):
    """The continuous engine serves token LMs only, as the reference's."""
    t = tiny[arch]
    with pytest.raises(ValueError, match="token-LM"):
        JEngine(t["jmodel"], t["jparams"])
    with pytest.raises(ValueError, match=f"{t['cfg'].family}/"
                                         f"{t['cfg'].frontend}"):
        Engine(t["model"], t["params"])


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_clis_name_the_missing_frontend_input(arch, tmp_path):
    """The CLIs feed tokens only, as the reference's do; on a frontend
    arch they raise a ValueError naming the frames or patches the stub
    needs (the reference's ``KeyError``), and never make them up."""
    base = ["--arch", arch, "--tiny", "--device", "cpu"]
    calls = [
        lambda: compress_cli.main(base + ["--calib-batches", "1", "--seq",
                                          "16", "--ckpt", str(tmp_path / "n"),
                                          "--out", str(tmp_path / "c")]),
        lambda: serve.main(base + ["--batch", "2", "--prompt-len", "8",
                                   "--gen", "2"]),
        lambda: train.main(base + ["--steps", "1", "--seq", "16",
                                   "--ckpt-dir", str(tmp_path / "t")])]
    for call in calls:
        with pytest.raises(ValueError, match=KEY[arch]):
            call()
    with pytest.raises(ValueError, match="dense/moe"):
        serve.main(base + ["--engine", "continuous", "--requests", "2",
                           "--gen", "2"])
