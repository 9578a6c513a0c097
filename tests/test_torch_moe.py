"""The port's MoE family (``repro_torch.models.moe``) and K4x's wrapper on
the CPU, held to the JAX package on the same numpy inputs at the tiny
qwen3-moe config.

Bars: the configs field for field; the router's indices equal (ties
included: both rank a tie to the lower index) and its gates within 1e-6;
``expert_apply`` (dense and packed, shared and per-expert inputs) and
``moe_apply_dense`` with its captures within 1e-5. The JAX side of a
packed product runs as the JAX package's own tests run it: through
``repro.quant.matmul_impl("kernel")`` (the Pallas kernel in interpret
mode) and through its reference. On the CPU the port's K4x wrapper runs
its plain version; the kernel itself is held to that on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import repro.quant as jquant
from repro.configs import get_config as jget_config
from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.quant import QTensor as JQTensor
from repro_torch import kernels
from repro_torch.bridge import params_from_numpy, qtensor_from_numpy
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import DenseModel, MoEModel, build_model
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.quant import QTensor, matmul_impl

ARCH = "qwen3-moe-235b-a22b"


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
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "tiny"])
def test_config_copies_agree_field_for_field(which):
    """The port keeps its own copy of the configs; every field it has
    equals the JAX package's, and the JAX fields it lacks (SSM, hybrid,
    frontend patches) are at their defaults."""
    cfg = (get_config if which == "full" else get_tiny_config)(ARCH)
    jcfg = (jget_config if which == "full" else jget_tiny)(ARCH)
    mine = {f.name for f in dataclasses.fields(ModelConfig)}
    for f in dataclasses.fields(jcfg):
        if f.name in mine:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        else:
            assert getattr(jcfg, f.name) == f.default, f.name
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.padded_vocab == jcfg.padded_vocab


def test_families_are_checked_where_they_belong():
    """``build_model`` picks the family's class, and each class refuses a
    config of the other family."""
    moe_cfg, dense_cfg = get_tiny_config(ARCH), get_tiny_config("llama32-1b")
    assert type(build_model(moe_cfg)) is MoEModel
    assert type(build_model(dense_cfg)) is DenseModel
    with pytest.raises(ValueError, match="dense"):
        DenseModel(moe_cfg)
    with pytest.raises(ValueError, match="moe"):
        MoEModel(dense_cfg)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def _router_inputs(ties: bool, seed=0):
    rng = np.random.default_rng(seed)
    cfg = get_tiny_config(ARCH)
    x = rng.normal(size=(40, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(cfg.d_model, cfg.num_experts)).astype(np.float32)
    if ties:
        # columns 1, 4 and 6 equal, 2 and 5 equal: tied logits, so tied
        # probabilities, in every row
        w[:, 4] = w[:, 6] = w[:, 1]
        w[:, 5] = w[:, 2]
        x[:8] = 0.0                     # all experts tied on these rows
    return cfg, x, w


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_gates_match_jax(ties):
    cfg, x, w = _router_inputs(ties)
    k = cfg.experts_per_token
    jg, ji = jmoe._gates(jnp.asarray(x), jnp.asarray(w), k)
    g, i = moe._gates(_t(x), _t(w), k)
    assert_array_equal(i.numpy(), np.asarray(ji))
    assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    if ties:
        assert_array_equal(i[:8].numpy(), np.tile(np.arange(k), (8, 1)))


# ---------------------------------------------------------------------------
# expert_apply: dense and packed stacks
# ---------------------------------------------------------------------------

def _stack_inputs(seed=1, e=8, t=6, d=64, f=96):
    rng = np.random.default_rng(seed)
    w_up = rng.normal(size=(e, d, f)).astype(np.float32) / 8
    w_dn = rng.normal(size=(e, f, d)).astype(np.float32) / 8
    x = rng.normal(size=(t, d)).astype(np.float32)
    h = rng.normal(size=(t, e, f)).astype(np.float32)
    return w_up, w_dn, x, h


def test_expert_apply_dense_matches_jax():
    w_up, w_dn, x, h = _stack_inputs()
    want = jlayers.expert_apply(jnp.asarray(w_up), jnp.asarray(x))
    got = L.expert_apply(_t(w_up), _t(x))
    assert got.shape == (6, 8, 96)
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    hx = np.ascontiguousarray(h.transpose(1, 0, 2))
    want = jlayers.expert_apply(jnp.asarray(w_dn), jnp.asarray(hx),
                                per_expert=True)
    got = L.expert_apply(_t(w_dn), _t(h).transpose(0, 1), per_expert=True)
    assert got.shape == (8, 6, 64)
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _jax_stack(w_paper, group, col_scale=None):
    """A stacked JAX QTensor: each expert's (d_out, d_in) weight quantized
    on its own, the fields stacked on a leading expert axis."""
    qts = [JQTensor.from_dense(jnp.asarray(w), 4, group,
                               None if col_scale is None
                               else jnp.asarray(col_scale[i]))
           for i, w in enumerate(w_paper)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qts)


@pytest.mark.parametrize("col_scale", [False, True], ids=["plain", "awq"])
@pytest.mark.parametrize("jax_impl", ["kernel", "reference"])
@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_expert_apply_packed_matches_jax(impl, jax_impl, col_scale):
    """Both forms of a stacked QTensor leaf (the shared gate/up input and
    the down projection's per-expert input, handed over as the strided
    (E, T, f) view of (T, E, f) activations), the port's K4x path (its
    plain version here) and its dequantize-then-multiply path against the
    JAX package's kernel (interpret mode) and reference paths."""
    w_up, w_dn, x, h = _stack_inputs()
    rng = np.random.default_rng(2)
    cs_up = (rng.uniform(0.5, 2.0, size=(8, 64)).astype(np.float32)
             if col_scale else None)
    cs_dn = (rng.uniform(0.5, 2.0, size=(8, 96)).astype(np.float32)
             if col_scale else None)
    jq_up = _jax_stack(w_up.transpose(0, 2, 1), 32, cs_up)
    jq_dn = _jax_stack(w_dn.transpose(0, 2, 1), 32, cs_dn)
    q_up = qtensor_from_numpy(jax.tree.map(np.asarray, jq_up), "cpu")
    q_dn = qtensor_from_numpy(jax.tree.map(np.asarray, jq_dn), "cpu")
    assert q_up.shape == (96, 64) and q_up.packed.shape == (8, 96, 32)
    hx = np.ascontiguousarray(h.transpose(1, 0, 2))
    with jquant.matmul_impl(jax_impl):
        want_up = jlayers.expert_apply(jq_up, jnp.asarray(x))
        want_dn = jlayers.expert_apply(jq_dn, jnp.asarray(hx),
                                       per_expert=True)
    with matmul_impl(impl):
        got_up = L.expert_apply(q_up, _t(x))
        got_dn = L.expert_apply(q_dn, _t(h).transpose(0, 1),
                                per_expert=True)
    assert got_up.shape == (6, 8, 96) and got_dn.shape == (8, 6, 64)
    assert_allclose(got_up.numpy(), np.asarray(want_up), atol=1e-5,
                    rtol=1e-5)
    assert_allclose(got_dn.numpy(), np.asarray(want_dn), atol=1e-5,
                    rtol=1e-5)


# ---------------------------------------------------------------------------
# moe_apply_dense with its captures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_moe():
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel, model = jbuild(jcfg, remat=False), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, model, params, jmodel, jparams


def _packed_moe(jp_moe, group=32):
    """The block's MoE dict with wg, wu and wd as stacked QTensors."""
    out = dict(jp_moe)
    for name in ("wg", "wu", "wd"):
        out[name] = _jax_stack(np.asarray(jp_moe[name]).transpose(0, 2, 1),
                               group)
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_moe_apply_dense_and_captures_match_jax(tiny_moe, packed):
    cfg, _, _, _, jparams = tiny_moe
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    if packed:
        jp = _packed_moe(jp)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(3).normal(size=(2, 7, cfg.d_model)) \
        .astype(np.float32)
    jcap, cap = {}, {}
    want = jmoe.moe_apply_dense(jp, jnp.asarray(x), jget_tiny(ARCH),
                                capture=jcap)
    got = moe.moe_apply_dense(p, _t(x), cfg, capture=cap)
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert set(cap) == set(jcap) == {"moe_in", "moe_mask", "moe_up"}
    assert_array_equal(cap["moe_mask"].numpy(), np.asarray(jcap["moe_mask"]))
    assert int(cap["moe_mask"].sum()) == 14 * cfg.experts_per_token
    for key in ("moe_in", "moe_up"):
        assert_allclose(cap[key].numpy(), np.asarray(jcap[key]), atol=1e-5,
                        rtol=1e-5)


def test_moe_model_logits_and_blocks_match_jax(tiny_moe):
    cfg, model, params, jmodel, jparams = tiny_moe
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)) \
        .astype(np.int32)
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    got = model.logits(params, {"tokens": _t(toks)})
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    names = [n for n, _, _ in model.block_linears(0)]
    assert names == [n for n, _, _ in jmodel.block_linears(0)]
    assert names[:4] == ["wq", "wk", "wv", "wo"]
    assert names[4:7] == ["moe_wg_0", "moe_wu_0", "moe_wd_0"]
    assert len(names) == 4 + 3 * cfg.num_experts


# ---------------------------------------------------------------------------
# K4x's wrapper on the CPU, its picker and its plain version
# ---------------------------------------------------------------------------

def _k4x_stack(e=4, n=64, k=128, group=32, seed=5):
    g = torch.Generator().manual_seed(seed)
    packed = torch.randint(0, 256, (e, n, k // 2), generator=g,
                           dtype=torch.uint8)
    scale = torch.rand((e, n, k // group), generator=g) * 0.02
    zero = torch.randint(0, 16, (e, n, k // group), generator=g).float()
    return packed, scale, zero


@pytest.mark.parametrize("per_expert", [False, True],
                         ids=["shared", "per_expert"])
def test_k4x_plain_version_is_k4_per_expert(per_expert):
    """K4x's wrapper on CPU tensors is its plain version (no launch, no
    census), which is K4's plain version expert by expert, in the
    reference's layouts; a strided per-expert view gives the same y."""
    packed, scale, zero = _k4x_stack()
    g = torch.Generator().manual_seed(6)
    x = (torch.randn((5, 4, 128), generator=g).transpose(0, 1) if per_expert
         else torch.randn((5, 128), generator=g))
    before, census = dict(ops.LAUNCHES), dict(ops.K4X_CENSUS)
    y = ops.dequant_matmul_experts(x, packed, scale, zero, 32, per_expert)
    assert ops.LAUNCHES == before and ops.K4X_CENSUS == census
    assert y.shape == ((4, 5, 64) if per_expert else (5, 4, 64))
    for e in range(4):
        want = ref.dequant_matmul(x[e] if per_expert else x, packed[e],
                                  scale[e], zero[e], 32)
        got = y[e] if per_expert else y[:, e]
        assert torch.equal(got, want)
    y2 = ops.dequant_matmul_experts(x.contiguous(), packed, scale, zero, 32,
                                    per_expert)
    assert torch.equal(y, y2)
    with kernels.use_impl("reference"):
        assert kernels.impl("dequant_matmul_experts") is \
            ref.dequant_matmul_experts


def test_k4x_rejects_operands_on_two_devices():
    packed, scale, zero = _k4x_stack()
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(ValueError, match="dequant_matmul_experts"):
        ops.dequant_matmul_experts(x, packed, scale, zero, 32)


def test_k4x_picker_counts_every_expert():
    """K4x's picker reckons the work of all E experts: at qwen3-moe's
    decode (E = 128, M = 4 and 8) the expert GEMV runs at both wg/wu (N =
    1536) and wd (N = 4096), where one expert alone (K4) splits K over a
    cluster; the tile's busiest-SM count grows with E."""
    gemv = len(ops.DEQUANT_TILES)
    for n, k in ((1536, 4096), (4096, 1536)):
        assert ops.dequant_matmul_tiles(8, n, k, experts=128) == ops.GEMVX
        assert gemv < ops.dequant_matmul_tiles(8, n, k, experts=1) < ops.GEMVX
        assert ops.dequant_matmul_tiles(4, n, k, experts=128) == ops.GEMVX
    # a prefill of 64 or 128 tokens: one expert's grid fills no card and
    # takes the 32 x 32 tile, 128 experts' grids take larger tiles
    for m in (64, 128):
        assert ops.dequant_matmul_tiles(m, 1536, 4096, experts=1) == 3
        assert ops.dequant_matmul_tiles(m, 1536, 4096, experts=128) < 3
    assert ops.dequant_matmul_tiles(512, 1536, 4096, experts=128) == 0
    assert ops.dequant_matmul_grid(8, 1536, gemv) == (24, 1)
