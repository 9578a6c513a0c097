"""AWP-S (``awp.quantize_scaled``, the ``awp_quant_scaled`` method) and the
Fig.-1 ``trace_loss`` mode of the port against the JAX package on the CPU,
and the two tests of ``tests/test_awp.py`` that use them, on the port.

Inputs are made with numpy from a seed. Bars: θ within 2e-4 (the
reference's bar for PGD loops) and the loss within 1e-5 relative; the loss
traces within 2e-4 with ``iters == max_iters``. d_in stays at 128 or below:
AWP-S runs 21 PGD loops a layer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.core import awp as jawp, calibration as jcalib
from repro.core import projections as jproj
from repro.core import registry as jreg, specs as jspecs
from repro_torch.core import awp, calibration as calib, registry, specs
from repro_torch.core import projections as proj

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, d_in=96, d_out=48, n=512, outliers=True):
    """``tests/test_awp.py``'s problem: a tenth of the channels 8x larger."""
    rng = np.random.default_rng(seed)
    scales = np.ones(d_in)
    if outliers:
        scales[rng.choice(d_in, d_in // 10, replace=False)] = 8.0
    x = (rng.normal(size=(n, d_in)) * scales).astype(np.float32)
    w = rng.normal(size=(d_out, d_in)).astype(np.float32)
    jst = jcalib.update(jcalib.init(d_in), jnp.asarray(x))
    st = calib.update(calib.init(d_in, device=CPU), torch.from_numpy(x))
    return w, jst, st


def _loss(w, theta, c):
    theta = theta if torch.is_tensor(theta) else torch.from_numpy(
        np.array(theta, copy=True))
    return float(awp.activation_loss(torch.from_numpy(w), theta, c))


def test_alpha_grid_is_jnp_linspace():
    for n in (2, 5, 21, 33):
        assert_array_equal(awp.alpha_grid(n),
                           np.asarray(jnp.linspace(0.0, 1.0, n)))


@pytest.mark.parametrize("seed,bits,group", [(0, 4, 64), (1, 3, 32),
                                             (2, 4, 128)])
def test_quantize_scaled_matches_jax(seed, bits, group):
    w, jst, st = _problem(seed, d_in=128)
    jres = jawp.quantize_scaled(jnp.asarray(w), jcalib.covariance(jst),
                                jcalib.act_mean_abs(jst), bits,
                                group_size=group)
    res = awp.quantize_scaled(torch.from_numpy(w), calib.covariance(st),
                              calib.act_mean_abs(st), bits, group_size=group)
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    # grad_norm carries the winning candidate's normalized loss
    assert abs(float(res.grad_norm) - float(jres.grad_norm)) <= \
        1e-5 * float(jres.grad_norm)
    assert int(res.iters) == int(jres.iters) == 10
    assert res.loss_trace is None and jres.loss_trace is None


def test_awp_quant_scaled_adapter_matches_jax():
    w, jst, st = _problem(3, d_in=128)
    kw = dict(bits=4, group_size=64)
    jres = jreg.get_method("awp_quant_scaled")(
        jnp.asarray(w), jst, jspecs.QuantSpec(method="awp_quant_scaled", **kw))
    res = registry.get_method("awp_quant_scaled")(
        torch.from_numpy(w), st,
        specs.QuantSpec(method="awp_quant_scaled", **kw))
    c = calib.covariance(st)
    jl = _loss(w, np.asarray(jres.theta), c)
    assert abs(_loss(w, res.theta, c) - jl) <= 1e-5 * jl
    codes, jcodes = res.qtensor.codes().numpy(), np.asarray(
        jres.qtensor.codes())
    assert (codes == jcodes).mean() >= 0.9999
    assert np.abs(codes.astype(int) - jcodes.astype(int)).max() <= 1
    assert_allclose(res.qtensor.col_scale.numpy(),
                    np.asarray(jres.qtensor.col_scale), rtol=1e-6)
    assert res.iters == jres.iters == 10
    assert res.aux["col_scaled"] and jres.aux["col_scaled"]
    assert torch.equal(res.qtensor.dequant(), res.theta)


def _trace_case(recipe, w, jst, st):
    jw, jc = jnp.asarray(w), jcalib.covariance(jst)
    tw, tc = torch.from_numpy(w), calib.covariance(st)
    if recipe == "prune":
        return (jawp.prune(jw, jc, 48, trace_loss=True, max_iters=60),
                awp.prune(tw, tc, 48, trace_loss=True, max_iters=60), 60)
    if recipe == "quantize":
        return (jawp.quantize(jw, jc, 4, group_size=32, trace_loss=True),
                awp.quantize(tw, tc, 4, group_size=32, trace_loss=True), 10)
    return (jawp.joint(jw, jc, 48, 4, group_size=32, total_iters=60,
                       ramp_iters=10, prune_only_iters=30, trace_loss=True),
            awp.joint(tw, tc, 48, 4, group_size=32, total_iters=60,
                      ramp_iters=10, prune_only_iters=30, trace_loss=True),
            60)


@pytest.mark.parametrize("recipe", ["prune", "quantize", "joint"])
def test_trace_loss_matches_jax(recipe):
    w, jst, st = _problem(4)
    jres, res, n = _trace_case(recipe, w, jst, st)
    assert res.loss_trace.shape == (n,)
    assert int(res.iters) == int(jres.iters) == n
    assert_allclose(res.loss_trace.numpy(), np.asarray(jres.loss_trace),
                    rtol=2e-4, atol=2e-4)
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    assert_allclose(float(res.grad_norm), float(jres.grad_norm), rtol=2e-4,
                    atol=1e-6)


def test_trace_loss_batched_matches_jax():
    rows = [_problem(s, d_in=64, d_out=32) for s in (5, 6, 7)]
    w_b = np.stack([r[0] for r in rows])
    jc = jnp.stack([jcalib.covariance(r[1]) for r in rows])
    c = torch.stack([calib.covariance(r[2]) for r in rows])
    k = 32
    jtheta0 = jnp.stack([jproj.topk_row(jnp.asarray(w), k) for w in w_b])
    theta0 = proj.topk_row(torch.from_numpy(w_b), k)
    jres = jawp.pgd_batched(jnp.asarray(w_b), jc,
                            lambda z, t: jproj.topk_row(z, k), jtheta0,
                            jawp.PGDConfig(max_iters=40, trace_loss=True))
    res = awp.pgd_batched(torch.from_numpy(w_b), c,
                          awp.prune_projection(k), theta0,
                          awp.PGDConfig(max_iters=40, trace_loss=True))
    assert res.loss_trace.shape == (3, 40)
    assert res.iters.tolist() == np.asarray(jres.iters).tolist() == [40] * 3
    assert_allclose(res.loss_trace.numpy(), np.asarray(jres.loss_trace),
                    rtol=2e-4, atol=2e-4)
    # each item's trace is the unbatched loop's
    one = awp.pgd(torch.from_numpy(w_b[1]), c[1], awp.prune_projection(k),
                  theta0[1], awp.PGDConfig(max_iters=40, trace_loss=True))
    assert_allclose(one.loss_trace.numpy(), res.loss_trace[1].numpy(),
                    rtol=1e-6, atol=1e-7)


# ---- tests/test_awp.py's AWP-S and Fig.-1 tests, on the port -------------

def test_quantize_scaled_beats_plain():
    w, _, st = _problem(0, d_in=128)
    c, am, tw = calib.covariance(st), calib.act_mean_abs(st), \
        torch.from_numpy(w)
    l_plain = _loss(w, awp.quantize(tw, c, 4, group_size=64).theta, c)
    l_scaled = _loss(w, awp.quantize_scaled(tw, c, am, 4,
                                            group_size=64).theta, c)
    assert l_scaled <= l_plain + 1e-6


def test_fig1_loss_trace_decreases():
    w, _, st = _problem(0)
    res = awp.prune(torch.from_numpy(w), calib.covariance(st), 48,
                    trace_loss=True, max_iters=60)
    tr = res.loss_trace.numpy()
    assert tr[-1] <= tr[0]
    assert (np.diff(tr) <= 1e-4).all()          # monotone within tolerance
