"""Compression of the port's MoE family on the CPU, held to the JAX package
at the tiny qwen3-moe config (8 experts, top-2), with JAX's random init
carried into the port and the same calibration tokens on both sides (one
batch of 4 x 24). Packing and serving are in
``tests/test_torch_moe_serve.py``.

Bars: the stacked per-expert statistics of ``_fold_captures`` within 1e-5
of JAX's (relative to their largest entry); the reference's buckets
[2, 2, E, 2E]; both of the port's engines against JAX's batched engine at
``awp_prune``, ``awp_quant`` and the mixed policy of
``tests/test_batched.py`` (per-layer loss within 1e-5, masks and codes
equal on at least 99.9% of entries, equal iteration counts); a bucket run
in sub-stacks bit-equal to the same bucket whole; a never-routed expert
compressed to JAX's Θ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_tiny_config as jget_tiny
from repro.core import specs as jspecs
from repro.core.compress import _fold_captures as jfold
from repro.core.compress import compress_model as jcompress_model
from repro.data import DataConfig as JDataConfig
from repro.data import calibration_batches as jcalibration_batches
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import batched, specs
from repro_torch.core.compress import (_block_works, _fold_captures,
                                       compress_model, get_linear)
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.models import build_model
from repro_torch.quant import QTensor

ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny model: more gain it
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel, model = jbuild(jcfg, remat=False), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    dc = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4)
    jcal = [{"tokens": jnp.asarray(t)}
            for t, _ in jcalibration_batches(JDataConfig(**dc), 1)]
    cal = [{"tokens": torch.from_numpy(t)}
           for t, _ in calibration_batches(DataConfig(**dc), 1)]
    return dict(cfg=cfg, model=model, params=params, cal=cal, jmodel=jmodel,
                jparams=jparams, jcal=jcal)


def _block0_stats(tiny):
    """Block 0's captures folded by the port."""
    model = tiny["model"]
    _, caps = model.block_apply_one(
        tiny["params"], 0, model.embed(tiny["params"], tiny["cal"][0]),
        capture=True)
    stats = {}
    _fold_captures(stats, caps, tiny["cfg"].num_experts)
    return stats


def test_fold_captures_stacked_stats_match_jax(tiny):
    stats = _block0_stats(tiny)
    jmodel = tiny["jmodel"]
    capture = jax.jit(lambda p, h: jmodel.block_apply_one(p, 0, h,
                                                          capture=True)[1])
    jcaps = capture(tiny["jparams"],
                    jmodel.embed(tiny["jparams"], tiny["jcal"][0]))
    jstats = {}
    jfold(jstats, jcaps, tiny["cfg"].num_experts)
    assert set(stats) == set(jstats) == {"attn_in", "attn_out_in", ("moe",),
                                         ("moe_down",)}
    e, d, f = (tiny["cfg"].num_experts, tiny["cfg"].d_model,
               tiny["cfg"].d_ff)
    assert stats[("moe",)].c_sum.shape == (e, d, d)
    assert stats[("moe_down",)].c_sum.shape == (e, f, f)
    for key in stats:
        for field in ("n", "c_sum", "abs_sum"):
            got = getattr(stats[key], field).numpy()
            want = np.asarray(getattr(jstats[key], field))
            scale = max(1.0, float(np.abs(want).max()))
            assert_allclose(got, want, atol=1e-5 * scale, rtol=0,
                            err_msg=f"{key} {field}")
    # every expert counts every token, routed or not (the reference's n)
    assert (stats[("moe",)].n == 96).all()


def test_moe_experts_land_in_one_bucket(tiny):
    """All E experts' wg and wu share one bucket, all wd another; q/k/v
    bucket by their shapes (the reference's sizes [2, 2, E, 2E])."""
    stats = _block0_stats(tiny)
    works = _block_works(tiny["model"], tiny["params"], 0, stats,
                         specs.Policy(default=specs.PruneSpec(
                             method="wanda", ratio=0.5)))
    e = tiny["cfg"].num_experts
    assert sorted(len(v) for v in batched.bucket_works(works).values()) \
        == [2, 2, e, 2 * e]


# ---------------------------------------------------------------------------
# both engines against JAX's
# ---------------------------------------------------------------------------

POLICIES = {
    "awp_prune": lambda m: m.PruneSpec(ratio=0.5),
    "awp_quant": lambda m: m.QuantSpec(bits=4, group_size=32),
    # tests/test_batched.py::test_parity_mixed_policy_on_moe
    "mixed": lambda m: m.Policy({"*.attn.*": m.QuantSpec(bits=8,
                                                         group_size=32)},
                                default=m.PruneSpec(ratio=0.5)),
}


@pytest.fixture(scope="module")
def jax_reports(tiny):
    return {}


def _jax_report(tiny, jax_reports, policy):
    if policy not in jax_reports:
        jax_reports[policy] = jcompress_model(
            tiny["jmodel"], tiny["jparams"], tiny["jcal"],
            POLICIES[policy](jspecs), engine="batched")[1]
    return jax_reports[policy]


@pytest.mark.parametrize("engine", ["batched", "sequential"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_engines_match_jax(tiny, jax_reports, policy, engine):
    jrep = _jax_report(tiny, jax_reports, policy)
    cp, rep = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                             POLICIES[policy](specs), engine=engine)
    assert [(r.qualname, r.method) for r in rep] == \
        [(r.qualname, r.method) for r in jrep]
    assert len(rep) == 2 * (4 + 3 * tiny["cfg"].num_experts)
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
    if policy == "mixed":
        methods = {r.qualname: r.method for r in rep}
        assert methods["blocks.0.attn.wq"] == "awp_quant"
        assert methods["blocks.0.moe.wu.0"] == "awp_prune"


@pytest.mark.parametrize("policy", ["awp_prune", "awp_quant"])
def test_bucket_in_substacks_is_bit_equal(tiny, policy, monkeypatch):
    """The first five experts' {wg, wu} bucket (10 items) and wd bucket
    (5) cut into sub-stacks of 2 or 3 give every item the bits of one
    whole stack."""
    stats = _block0_stats(tiny)
    works = _block_works(tiny["model"], tiny["params"], 0, stats,
                         specs.Policy(default=POLICIES[policy](specs)))
    experts = [wk for wk in works if wk.name.startswith("moe_")][:15]
    small = 3 * batched.item_bytes(experts[0])
    parts = batched.substacks(experts[:10], small)
    assert [len(p) for p in parts] == [3, 3, 2, 2]
    whole = batched.compress_block(experts)
    monkeypatch.setattr(batched, "BUCKET_BYTES", small)
    cut = batched.compress_block(experts)
    for wk, (res_w, loss_w), (res_c, loss_c) in zip(experts, whole, cut):
        assert torch.equal(res_w.theta, res_c.theta), wk.name
        assert torch.equal(loss_w, loss_c), wk.name
        assert torch.equal(torch.as_tensor(res_w.iters),
                           torch.as_tensor(res_c.iters)), wk.name


def test_never_routed_expert_is_compressed_as_jax_does(tiny):
    """An expert no token is routed to has Σxᵀx = 0 but n = T (the
    reference counts every token), so the ``n >= 1`` guard keeps it and it
    is compressed: with C = 0 the PGD step moves nothing and Θ stays the
    round-to-nearest start (regridded once more by the projection). The
    port gives JAX's Θ on it."""
    jparams = jax.tree.map(lambda a: a, tiny["jparams"])
    router = np.asarray(jparams["blocks"]["moe"]["router"]).copy()
    # experts 3, 4 and 5 route alike, and a tie goes to the lower index,
    # so expert 5 never makes a token's top 2
    router[:, :, 4] = router[:, :, 5] = router[:, :, 3]
    jparams["blocks"]["moe"]["router"] = jnp.asarray(router)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    pol = POLICIES["awp_quant"]
    jcp, jrep = jcompress_model(tiny["jmodel"], jparams, tiny["jcal"],
                                pol(jspecs), engine="batched")
    cp, rep = compress_model(tiny["model"], params, tiny["cal"], pol(specs))
    names = {r.qualname for r in rep}
    assert names == {r.qualname for r in jrep}
    _, caps = tiny["model"].block_apply_one(
        params, 0, tiny["model"].embed(params, tiny["cal"][0]), capture=True)
    assert not caps["moe_mask"][:, 5].any() and caps["moe_mask"][:, 4].any()
    for name in ("wg", "wu", "wd"):
        assert f"blocks.0.moe.{name}.5" in names
        got = get_linear(cp, ("blocks", "moe", name, 5), 0)
        want = np.asarray(jcp["blocks"]["moe"][name][0, 5]).T
        assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        w = get_linear(params, ("blocks", "moe", name, 5), 0)
        start = QTensor.from_dense(w, 4, 32).dequant()
        assert_allclose(got.numpy(), start.numpy(), atol=1e-6, rtol=0)
