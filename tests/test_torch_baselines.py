"""The port's RTN, AWQ, Wanda+AWQ / AWQ+Wanda, SparseGPT and GPTQ against the
JAX package on the CPU, at the sizes of ``tests/test_baselines.py``, and the
ordering tests of that file on the port.

Inputs are made with numpy from a seed and fed to both packages. Bars:
masks equal; AWQ's winning α (its index on the grid) equal and s within
1e-6 relative (the reference's f32 power is XLA's, which differs from the
correctly rounded power the port takes by an ulp on some channels); codes
equal on at least 99.99% of entries, each differing code one step from the
reference's; per-layer loss within 1e-5 relative. SparseGPT's final keep-set
sorts |w| in an order that is not stable, so it is compared by θ and by each
row's count of kept entries, not by index lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.core import awp as jawp, calibration as jcalib
from repro.core import registry as jreg, specs as jspecs
from repro.core.baselines import awq as jawq, gptq as jgptq, rtn as jrtn
from repro.core.baselines import sequential as jseq, sparsegpt as jsgpt
from repro.quant import QTensor as JQTensor
from repro_torch.core import awp, calibration as calib, registry, specs
from repro_torch.core.baselines import (awq, gptq, magnitude, rtn, sequential,
                                        sparsegpt, wanda)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the problems are small, and under pytest-xdist
    more threads' spin-waits take the cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, d_in=128, d_out=64, n=1024):
    """``tests/test_baselines.py``'s problem: lognormal channel scales."""
    rng = np.random.default_rng(seed)
    scales = np.exp(rng.normal(0, 0.7, size=d_in))
    x = (rng.normal(size=(n, d_in)) * scales).astype(np.float32)
    w = rng.normal(size=(d_out, d_in)).astype(np.float32)
    jst = jcalib.update(jcalib.init(d_in), jnp.asarray(x))
    st = calib.update(calib.init(d_in, device=CPU), torch.from_numpy(x))
    return w, jst, st


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jloss(w, theta, jst):
    return float(jawp.activation_loss(jnp.asarray(w), jnp.asarray(theta),
                                      jcalib.covariance(jst)))


def _loss(w, theta, st):
    return float(awp.activation_loss(_t(w), torch.as_tensor(theta),
                                     calib.covariance(st)))


def _close_codes(codes, jcodes):
    """>= 99.99% equal, each differing code one step off."""
    codes, jcodes = np.asarray(codes, np.int64), np.asarray(jcodes, np.int64)
    assert (codes == jcodes).mean() >= 0.9999
    assert np.abs(codes - jcodes).max() <= 1


def _codes_of(theta, bits, group):
    """Codes of a dequantized RTN/AWQ weight on its own min/max grid."""
    return JQTensor.from_dense(jnp.asarray(theta), bits, group).codes()


@pytest.mark.parametrize("bits,group", [(4, 64), (3, 128), (8, 32)])
def test_rtn_matches_jax(bits, group):
    w, jst, st = _problem()
    theta = rtn.quantize_weight(_t(w), bits, group).numpy()
    jtheta = np.asarray(jrtn.quantize_weight(jnp.asarray(w), bits, group))
    _close_codes(_codes_of(theta, bits, group), _codes_of(jtheta, bits, group))
    assert abs(_loss(w, theta, st) - _jloss(w, jtheta, jst)) <= \
        1e-5 * _jloss(w, jtheta, jst)


@pytest.mark.parametrize("seed,bits,group", [(0, 4, 64), (1, 4, 128),
                                             (2, 3, 32)])
def test_awq_matches_jax(seed, bits, group):
    w, jst, st = _problem(seed)
    jwq, js = jawq.quantize_weight_with_scale(
        jnp.asarray(w), jcalib.covariance(jst), jcalib.act_mean_abs(jst),
        bits, group)
    wq, s = awq.quantize_weight_with_scale(
        _t(w), calib.covariance(st), calib.act_mean_abs(st), bits, group)
    a = np.maximum(np.asarray(jcalib.act_mean_abs(jst)), 1e-8)
    # the winning alpha: the grid point whose scale is nearest the winner's
    dist = [np.abs(np.log(s.numpy()) - np.log(np.asarray(
        awp.channel_scale(torch.from_numpy(a), al)))).max()
        for al in awq._ALPHA_GRID]
    jdist = [np.abs(np.log(np.asarray(js)) - np.log(np.asarray(
        awp.channel_scale(torch.from_numpy(a), al)))).max()
        for al in awq._ALPHA_GRID]
    assert int(np.argmin(dist)) == int(np.argmin(jdist))
    assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    # the codes on the scaled grid, as the adapter packs them
    q = JQTensor.from_dense(jnp.asarray(wq.numpy()), bits, group,
                            col_scale=jnp.asarray(s.numpy())).codes()
    jq = JQTensor.from_dense(jwq, bits, group, col_scale=js).codes()
    _close_codes(q, jq)
    assert abs(_loss(w, wq, st) - _jloss(w, jwq, jst)) <= \
        1e-5 * _jloss(w, jwq, jst)


def test_awq_grid_points_and_argmin_rule():
    assert awq._ALPHA_GRID == jawq._ALPHA_GRID
    a = torch.tensor([1.0, 2.0])
    best = awp.select_min(None, (torch.tensor(2.0), a))
    best = awp.select_min(best, (torch.tensor(2.0), a + 1))   # tie: first
    assert torch.equal(best[1], a)
    best = awp.select_min(best, (torch.tensor(float("nan")), a + 2))
    assert torch.equal(best[1], a + 2)                         # NaN: taken
    best = awp.select_min(best, (torch.tensor(0.0), a + 3))
    assert torch.equal(best[1], a + 2)                         # and kept
    assert int(jnp.argmin(jnp.asarray([2.0, 2.0, np.nan, 0.0]))) == 2


@pytest.mark.parametrize("pipeline", ["wanda_then_awq", "awq_then_wanda"])
@pytest.mark.parametrize("k", [64, 40])
def test_sequential_pipelines_match_jax(pipeline, k):
    w, jst, st = _problem()
    jout = np.asarray(getattr(jseq, pipeline)(
        jnp.asarray(w), jcalib.covariance(jst), jcalib.act_mean_abs(jst),
        k, 4, 64))
    out = getattr(sequential, pipeline)(
        _t(w), calib.covariance(st), calib.act_mean_abs(st), k, 4, 64).numpy()
    assert_array_equal(out != 0, jout != 0)
    assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    assert abs(_loss(w, out, st) - _jloss(w, jout, jst)) <= \
        1e-5 * _jloss(w, jout, jst)


@pytest.mark.parametrize("seed,k,d_in", [(0, 64, 128), (1, 32, 128),
                                         (2, 70, 200)])
def test_sparsegpt_matches_jax(seed, k, d_in):
    w, jst, st = _problem(seed, d_in=d_in)
    jc = np.asarray(jcalib.covariance(jst), np.float64)
    jout = jsgpt.prune_weight(w, jc, k, blocksize=128)
    out = sparsegpt.prune_weight(_t(w), calib.covariance(st).double(), k)
    out = out.numpy()
    assert_array_equal((out != 0).sum(1), (jout != 0).sum(1))
    assert_array_equal(out != 0, jout != 0)
    assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
    assert abs(_loss(w, out, st) - _jloss(w, jout, jst)) <= \
        1e-5 * _jloss(w, jout, jst)


def test_sparsegpt_dead_columns_match_jax():
    w, jst, st = _problem(3)
    c = np.array(jcalib.covariance(jst), np.float64)
    c[:, [5, 77]] = 0.0
    c[[5, 77], :] = 0.0
    jout = jsgpt.prune_weight(w, c, 64)
    out = sparsegpt.prune_weight(_t(w), torch.from_numpy(c), 64).numpy()
    assert (out[:, [5, 77]] == 0).all()
    assert_array_equal(out != 0, jout != 0)
    assert_allclose(out, jout, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,bits,group,d_in", [(0, 4, 64, 128),
                                                  (1, 3, 128, 256),
                                                  (2, 4, 32, 96)])
def test_gptq_matches_jax(seed, bits, group, d_in):
    w, jst, st = _problem(seed, d_in=d_in)
    jc = np.asarray(jcalib.covariance(jst), np.float64)
    jout, jcodes, jscale, jzero = jgptq.quantize_weight(
        w, jc, bits, group, return_qparams=True)
    out, codes, scale, zero = gptq.quantize_weight(
        _t(w), calib.covariance(st).double(), bits, group,
        return_qparams=True)
    _close_codes(codes.numpy(), jcodes)
    assert_allclose(scale.numpy(), jscale, rtol=1e-6)
    assert_allclose(zero.numpy(), jzero, atol=1.0)
    assert (zero.numpy() == jzero).mean() >= 0.9999
    assert abs(_loss(w, out, st) - _jloss(w, jout, jst)) <= \
        1e-5 * _jloss(w, jout, jst)


ADAPTERS = [("rtn", specs.QuantSpec, jspecs.QuantSpec, dict(bits=4, group_size=64)),
            ("awq", specs.QuantSpec, jspecs.QuantSpec, dict(bits=4, group_size=64)),
            ("gptq", specs.QuantSpec, jspecs.QuantSpec, dict(bits=4, group_size=64)),
            ("sparsegpt", specs.PruneSpec, jspecs.PruneSpec, dict(ratio=0.5)),
            ("wanda_awq", specs.JointSpec, jspecs.JointSpec,
             dict(ratio=0.5, bits=4, group_size=64)),
            ("awq_wanda", specs.JointSpec, jspecs.JointSpec,
             dict(ratio=0.5, bits=4, group_size=64))]


@pytest.mark.parametrize("method,cls,jcls,kw", ADAPTERS,
                         ids=[a[0] for a in ADAPTERS])
def test_registry_adapters_match_jax(method, cls, jcls, kw):
    w, jst, st = _problem()
    jres = jreg.get_method(method)(jnp.asarray(w), jst,
                                   jcls(method=method, **kw))
    res = registry.get_method(method)(_t(w), st, cls(method=method, **kw))
    theta, jtheta = res.theta.numpy(), np.asarray(jres.theta)
    assert abs(_loss(w, theta, st) - _jloss(w, jtheta, jst)) <= \
        1e-5 * _jloss(w, jtheta, jst)
    assert (res.mask is None) == (jres.mask is None)
    if jres.mask is not None:
        assert_array_equal(res.mask.numpy(), np.asarray(jres.mask))
    assert (res.qtensor is None) == (jres.qtensor is None)
    if jres.qtensor is not None:
        _close_codes(res.qtensor.codes().numpy(), jres.qtensor.codes())
        assert (res.qtensor.col_scale is None) == \
            (jres.qtensor.col_scale is None)
        assert torch.equal(res.qtensor.dequant(), res.theta)
    assert res.aux.get("col_scaled") == jres.aux.get("col_scaled")


def test_registry_holds_the_reference_methods():
    assert registry.available() == jreg.available()
    for name in registry.available():
        assert registry.spec_cls_for(name).__name__ == \
            jreg.spec_cls_for(name).__name__


# ---- the ordering tests of tests/test_baselines.py, on the port ----------

def _cov(st):
    return calib.covariance(st)


def test_sparsegpt_beats_magnitude():
    w, _, st = _problem()
    c, k = _cov(st), 64
    out = sparsegpt.prune_weight(_t(w), c.double(), k)
    assert _loss(w, out, st) < _loss(w, magnitude.prune_weight(_t(w), k), st)
    assert ((out != 0).sum(dim=1) <= k).all()


def test_gptq_beats_rtn():
    w, _, st = _problem()
    c = _cov(st)
    l_gptq = _loss(w, gptq.quantize_weight(_t(w), c.double(), 4, 64), st)
    assert l_gptq < _loss(w, rtn.quantize_weight(_t(w), 4, 64), st)


def test_awq_beats_rtn():
    w, _, st = _problem()
    l_awq = _loss(w, awq.quantize_weight(_t(w), _cov(st),
                                         calib.act_mean_abs(st), 4, 64), st)
    assert l_awq <= _loss(w, rtn.quantize_weight(_t(w), 4, 64), st) + 1e-7


def test_sequential_pipelines_shapes():
    w, _, st = _problem()
    c, am, k = _cov(st), calib.act_mean_abs(st), 64
    wa = sequential.wanda_then_awq(_t(w), c, am, k, 4, 64)
    aw = sequential.awq_then_wanda(_t(w), c, am, k, 4, 64)
    assert ((wa != 0).sum(dim=1) <= k).all()
    assert ((aw != 0).sum(dim=1) <= k).all()


def test_paper_ordering_table1_style():
    w, _, st = _problem(d_in=96, d_out=48)
    c = _cov(st)
    for ratio in (0.5, 0.7):
        k = int(96 * (1 - ratio))
        l_mag = _loss(w, magnitude.prune_weight(_t(w), k), st)
        l_wanda = _loss(w, wanda.prune_weight(_t(w), c, k), st)
        l_awp = _loss(w, awp.prune(_t(w), c, k).theta, st)
        assert l_awp <= l_wanda <= l_mag + 1e-6
