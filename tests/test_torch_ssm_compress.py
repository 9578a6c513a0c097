"""Compression, packing and static serving of the port's SSM and hybrid
families on the CPU (falcon-mamba-7b's and zamba2-1.2b's tiny configs),
held to the JAX package with JAX's random init carried into the port and
the same calibration tokens on both sides (one batch of 2 x 24).

Bars: the reference's family sweep (``tests/test_compress_model.py``:
AWP prune at 0.5, mean sparsity above 0.4, a finite loss after) and the
chip's mixed policy, each with both of the port's engines against JAX's
batched engine (per-layer loss within 1e-5, masks and codes equal on at
least 99.9% of entries, equal iteration counts); Zamba2's shared block
compressed once, as block L, with at least 6 reports; the batched engine
buckets Zamba2's {wz, wx}; packing keeps the shared block's 2-D leaves as
QTensors; a packed checkpoint of JAX's read by the port gives JAX's
prefill logits within 2e-5 (``tests/test_packed_serving.py``) and its
greedy static tokens; the port's packed checkpoint read by JAX gives the
same codes; the CLIs, and the continuous engine's and the train CLI's
refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.checkpoint import load_packed_checkpoint as jload_packed
from repro.checkpoint import save_packed_checkpoint as jsave_packed
from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import compress_model as jcompress_model
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (load_packed_checkpoint, pack_params,
                                    save_packed_checkpoint)
from repro_torch.configs import get_tiny_config
from repro_torch.core import batched, specs
from repro_torch.core.compress import _block_works, _fold_captures
from repro_torch.core.compress import compress_model, get_linear
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.launch import compress as compress_cli
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.quant import QTensor

ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
FALCON, ZAMBA = ARCHS
POLICIES = {
    # tests/test_compress_model.py::test_compress_every_family
    "awp_prune": lambda m: m.PruneSpec(ratio=0.5),
    # chip_smoke.py's main path, at the tiny widths' group
    "mixed": lambda m: m.Policy({"*.attn.wo": m.PruneSpec(ratio=0.5)},
                                default=m.QuantSpec(bits=4, group_size=32)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches():
    """Clear JAX's compilation caches when the module ends: an executable
    that JAX's compression of the tiny Zamba2 compiled with
    ``jax_debug_nans`` off would otherwise serve the probe of
    ``tests/test_sanitizers.py::test_debug_nans_actually_armed`` if that
    file ran later in the same process (a fault of the reference, recorded
    in ``ROADMAP.md``)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def tiny():
    """Each arch's tiny model in both packages on JAX's init, the same
    calibration batch on both sides, and a cache of JAX's compressions
    (the slow part: each is shared by every test that needs it)."""
    out = {}
    for arch in ARCHS:
        cfg, jcfg = get_tiny_config(arch), jget_tiny(arch)
        jmodel = jbuild(jcfg, remat=False)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        dc = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=2)
        out[arch] = dict(
            cfg=cfg, model=build_model(cfg), jmodel=jmodel, jparams=jparams,
            params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu"),
            cal=[{"tokens": torch.from_numpy(t)}
                 for t, _ in calibration_batches(DataConfig(**dc), 1)],
            jcal=[{"tokens": jnp.asarray(t)}
                  for t, _ in jcalibration_batches(JDataConfig(**dc), 1)],
            jax_runs={})
    return out


def _jax_run(t, policy):
    """(params, report) of JAX's batched engine at ``policy``, once."""
    if policy not in t["jax_runs"]:
        t["jax_runs"][policy] = jcompress_model(
            t["jmodel"], t["jparams"], t["jcal"], POLICIES[policy](jspecs),
            engine="batched")
    return t["jax_runs"][policy]


def _n_layers(cfg):
    if cfg.family == "ssm":
        return 2 * cfg.num_layers
    return 3 * cfg.num_layers + 6          # + the shared block's (no wg)


# ---------------------------------------------------------------------------
# both engines against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["batched", "sequential"])
@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_jax(tiny, arch, policy, engine):
    t = tiny[arch]
    _, jrep = _jax_run(t, policy)
    cp, rep = compress_model(t["model"], t["params"], t["cal"],
                             POLICIES[policy](specs), engine=engine)
    assert [(r.qualname, r.method) for r in rep] == \
        [(r.qualname, r.method) for r in jrep]
    assert len(rep) == _n_layers(t["cfg"])
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
    if policy == "awp_prune":                # the reference's sweep's bars
        assert np.mean([r.sparsity for r in rep]) > 0.4
        toks = t["cal"][0]["tokens"]
        loss, _ = t["model"].loss(cp, {"tokens": toks, "labels": toks})
        assert bool(torch.isfinite(loss))
    else:
        methods = {r.method for r in rep}
        assert methods == ({"awp_quant"} if arch == FALCON
                           else {"awp_quant", "awp_prune"})


def test_zamba2_shared_block_compressed_once(tiny):
    """The reference's ``test_zamba2_shared_block_compressed_once``
    (``tests/test_compress_model.py``) through the port: block L holds the
    shared block's linears, each compressed once, and they land in the
    unstacked leaves."""
    t = tiny[ZAMBA]
    cfg = t["cfg"]
    cp, rep = compress_model(t["model"], t["params"], t["cal"],
                             specs.PruneSpec(method="magnitude", ratio=0.5))
    shared = [r for r in rep if r.block == cfg.num_layers]
    assert len(shared) >= 6
    assert [r.qualname for r in shared] == [
        f"shared.{g}.{n}" for g, n in (("attn", "wq"), ("attn", "wk"),
                                       ("attn", "wv"), ("attn", "wo"),
                                       ("mlp", "wu"), ("mlp", "wd"))]
    for r in shared:
        path = tuple(r.qualname.split("."))
        w = get_linear(cp, path, None)
        assert w.shape == get_linear(t["params"], path, None).shape
        assert float((w == 0).float().mean()) == 0.5
    assert t["params"]["shared"]["attn"]["wq"].ne(0).all()   # untouched


def test_zamba2_buckets_wz_with_wx(tiny):
    """The batched engine stacks Zamba2's {wz, wx} (both d → d_inner) into
    one bucket for K1b; out_proj runs alone."""
    t = tiny[ZAMBA]
    _, caps = t["model"].block_apply_one(
        t["params"], 0, t["model"].embed(t["params"], t["cal"][0]),
        capture=True)
    stats = {}
    _fold_captures(stats, caps, 0)
    works = _block_works(t["model"], t["params"], 0, stats,
                         specs.Policy(default=specs.QuantSpec(bits=4)))
    buckets = batched.bucket_works(works).values()
    assert sorted([works[j].name for j in b] for b in buckets) == [
        ["out_proj"], ["wz", "wx"]]


# ---------------------------------------------------------------------------
# packing, checkpoints and the static decode
# ---------------------------------------------------------------------------

def test_port_pack_keeps_stacked_and_shared_leaves(tiny, tmp_path):
    """The port's mixed-policy compression packed in memory and through a
    checkpoint: Mamba leaves as stacked (L, …) QTensors, the shared
    block's as 2-D ones; the pruned shared wo dense; the same prefill
    logits as the dense Θ."""
    t = tiny[ZAMBA]
    cfg = t["cfg"]
    cp, rep = compress_model(t["model"], t["params"], t["cal"],
                             POLICIES["mixed"](specs))
    packed = pack_params(cp, rep)
    path = save_packed_checkpoint(str(tmp_path), 0, cp, rep)
    loaded, qts, _ = load_packed_checkpoint(path, t["params"], device="cpu")
    assert len(qts) == _n_layers(cfg) - 1
    for tree in (packed, loaded):
        for name in ("wz", "wx", "out_proj"):
            qt = tree["blocks"][name]
            assert isinstance(qt, QTensor)
            assert qt.packed.shape[0] == cfg.num_layers
        for g, n in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                     ("mlp", "wu"), ("mlp", "wd")):
            qt = tree["shared"][g][n]
            assert isinstance(qt, QTensor) and qt.packed.dim() == 2
        assert not isinstance(tree["shared"]["attn"]["wo"], QTensor)
    for name in ("wq", "wd"):
        g = "attn" if name == "wq" else "mlp"
        a, b = packed["shared"][g][name], loaded["shared"][g][name]
        for f in ("packed", "scale", "zero"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        assert torch.equal(a.dequant(), get_linear(cp, ("shared", g, name),
                                                   None))
    toks = {"tokens": t["cal"][0]["tokens"][:, :8]}
    model = t["model"]
    want, _ = model.prefill(cp, toks, model.init_cache(2, 10, device="cpu"))
    for tree in (packed, loaded):
        got, _ = model.prefill(tree, toks, model.init_cache(2, 10,
                                                            device="cpu"))
        assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


class _Req:
    def __init__(self, prompt, n):
        self.prompt, self.max_new_tokens = prompt, n


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_packed_checkpoint_serves_as_in_jax(tiny, arch, tmp_path):
    """JAX's mixed-policy compression, saved packed by JAX and loaded by
    both packages: the port holds the same codes, its prefill logits are
    JAX's within 2e-5 and its greedy static tokens JAX's."""
    t = tiny[arch]
    jcp, jrep = _jax_run(t, "mixed")
    path = jsave_packed(str(tmp_path), 0, jcp, jrep)
    jloaded, _, _ = jload_packed(path, t["jparams"])
    loaded, _, _ = load_packed_checkpoint(path, t["params"], device="cpu")
    name = "in_proj" if arch == FALCON else "wx"
    np.testing.assert_array_equal(
        loaded["blocks"][name].packed.numpy(),
        np.asarray(jloaded["blocks"][name].packed))
    toks = np.array(t["jcal"][0]["tokens"])[:, :16]
    model, jmodel = t["model"], t["jmodel"]
    want, _ = jmodel.prefill(jloaded, {"tokens": jnp.asarray(toks)},
                             jmodel.init_cache(2, 24, jnp.float32))
    got, _ = model.prefill(loaded, {"tokens": torch.from_numpy(toks)},
                           model.init_cache(2, 24, device="cpu"))
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    for row in range(2):
        req = _Req(toks[row, :12], 6)
        assert serve.static_greedy_reference(model, loaded, req, 24) == \
            jserve.static_greedy_reference(jmodel, jloaded, req, 24)


def test_port_packed_zamba2_checkpoint_reads_in_jax(tiny, tmp_path):
    """A packed Zamba2 checkpoint written by the port, read by JAX's
    ``load_packed_checkpoint``: every QTensor leaf, stacked and shared,
    holds the port's codes, and JAX's prefill logits from it are the
    port's within 2e-5."""
    t = tiny[ZAMBA]
    pol = specs.Policy({"*": specs.QuantSpec(bits=4, group_size=32)})
    cp, rep = compress_model(t["model"], t["params"], t["cal"], pol)
    path = save_packed_checkpoint(str(tmp_path), 0, cp, rep)
    jloaded, jqts, _ = jload_packed(path, t["jparams"])
    packed = pack_params(cp, rep)
    assert len(jqts) == _n_layers(t["cfg"])
    for key, qt in (("blocks", packed["blocks"]["out_proj"]),
                    ("shared", packed["shared"]["mlp"]["wd"])):
        jqt = (jloaded["blocks"]["out_proj"] if key == "blocks"
               else jloaded["shared"]["mlp"]["wd"])
        for f in ("packed", "scale", "zero"):
            np.testing.assert_array_equal(getattr(qt, f).numpy(),
                                          np.asarray(getattr(jqt, f)))
    toks = np.array(t["jcal"][0]["tokens"])[:, :8]
    want, _ = t["jmodel"].prefill(jloaded, {"tokens": jnp.asarray(toks)},
                                  t["jmodel"].init_cache(2, 10, jnp.float32))
    got, _ = t["model"].prefill(packed, {"tokens": torch.from_numpy(toks)},
                                t["model"].init_cache(2, 10, device="cpu"))
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_clis_on_cpu(arch, tmp_path):
    """compress (batched engine, AWP int4) then serve the packed checkpoint
    statically; the continuous engine refuses the family, as the
    reference's does."""
    out = str(tmp_path / "ck")
    _, report = compress_cli.main(
        ["--arch", arch, "--tiny", "--device", "cpu", "--calib-batches", "1",
         "--seq", "16", "--method", "awp_quant", "--bits", "4",
         "--group-size", "32", "--out", out, "--save-packed"])
    assert len(report.packed_layers()) == _n_layers(get_tiny_config(arch))
    seqs = serve.main(["--arch", arch, "--tiny", "--device", "cpu", "--ckpt",
                       out, "--packed", "--batch", "2", "--prompt-len", "8",
                       "--gen", "4"])
    assert seqs.shape == (2, 4)
    with pytest.raises(ValueError, match="dense/moe"):
        serve.main(["--arch", arch, "--tiny", "--device", "cpu", "--engine",
                    "continuous", "--requests", "2", "--gen", "2"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_refuses_the_family(arch, tmp_path):
    with pytest.raises(SystemExit, match="later slice"):
        train.main(["--arch", arch, "--tiny", "--device", "cpu", "--steps",
                    "1", "--ckpt-dir", str(tmp_path)])
