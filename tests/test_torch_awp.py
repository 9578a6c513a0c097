"""The port's calibration statistics, plain K1 step, Wanda init, PGD loop and
AWP recipes against the JAX package on the CPU.

Inputs are made with numpy from a seed. Tolerances: statistics and losses
1e-5 relative (f32 sums in another order); the PGD step and loops 2e-4
(the reference's own bar for PGD loops); iteration counts, Wanda masks and
specs exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.core import awp as jawp, calibration as jcalib, registry as jreg
from repro.core import specs as jspecs
from repro.core.baselines import wanda as jwanda
from repro.kernels import awp_pgd as jpgd_kernel, ops as jops
from repro_torch.core import awp, calibration as calib, registry, specs
from repro_torch.core.baselines import wanda
from repro_torch.kernels import ops

CPU = "cpu"


def _problem(d_out, d_in, n=512, seed=0):
    """A weight and calibration activations with correlated, outlier-heavy
    channels (the regime activation-aware methods are built for)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_out, d_in)).astype(np.float32)
    mix = rng.standard_normal((d_in, d_in)).astype(np.float32) / np.sqrt(d_in)
    x = rng.standard_normal((n, d_in)).astype(np.float32) @ mix
    x *= np.exp(rng.standard_normal(d_in)).astype(np.float32)
    return w, x.astype(np.float32)


def _both_stats(x, chunks=2):
    st_j, st_t = jcalib.init(x.shape[-1]), calib.init(x.shape[-1], device=CPU)
    for part in np.array_split(x, chunks):
        st_j = jcalib.update(st_j, jnp.asarray(part))
        st_t = calib.update(st_t, torch.from_numpy(part))
    return st_j, st_t


def test_calibration_stats_match_jax():
    _, x = _problem(4, 96)
    st_j, st_t = _both_stats(x.reshape(4, 128, 96), chunks=3)
    assert float(st_t.n) == float(st_j.n) == 512
    for damp in (0.0, 0.01):
        assert_allclose(calib.covariance(st_t, damp).numpy(),
                        np.asarray(jcalib.covariance(st_j, damp)),
                        rtol=1e-5, atol=1e-6)
    assert_allclose(calib.act_mean_abs(st_t).numpy(),
                    np.asarray(jcalib.act_mean_abs(st_j)), rtol=1e-5)
    assert_allclose(calib.col_l2(st_t).numpy(),
                    np.asarray(jcalib.col_l2(st_j)), rtol=1e-5)


@pytest.mark.parametrize("shape", [(48, 128), (3, 40, 64)])
def test_plain_pgd_step_matches_jax(shape):
    rng = np.random.default_rng(1)
    k = shape[-1]
    w = rng.standard_normal(shape).astype(np.float32)
    theta = rng.standard_normal(shape).astype(np.float32)
    c = (rng.standard_normal(shape[:-2] + (k, k)) / np.sqrt(k)).astype(np.float32)
    eta = (np.float32(0.3) if len(shape) == 2
           else np.array([0.2, 0.4, 0.6], np.float32))
    want = np.asarray(jops.awp_pgd_step(jnp.asarray(w), jnp.asarray(theta),
                                        jnp.asarray(c), jnp.asarray(eta),
                                        use_pallas=False))
    z, nrm = ops.awp_pgd_step(torch.from_numpy(w), torch.from_numpy(theta),
                              torch.from_numpy(c), torch.from_numpy(np.asarray(eta)))
    assert_allclose(z.numpy(), want, rtol=2e-4, atol=2e-4)
    # the norm is the Pallas kernel's f32-accumulator reduction
    _, jnrm = jpgd_kernel.awp_pgd_step(
        jnp.asarray(w), jnp.asarray(theta), jnp.asarray(c), jnp.asarray(eta),
        bm=16, bn=32, bk=32, interpret=True, with_resid_norm=True)
    assert_allclose(nrm.numpy(), np.asarray(jnrm), rtol=2e-4)


def test_wanda_matches_jax():
    w, x = _problem(32, 128, seed=2)
    c = x.T @ x / x.shape[0]
    for k in (1, 40, 64, 127):
        want = np.asarray(jwanda.prune_weight(jnp.asarray(w), jnp.asarray(c), k))
        got = wanda.prune_weight(torch.from_numpy(w), torch.from_numpy(c), k)
        assert_array_equal(got.numpy(), want)
    assert_allclose(wanda.scores(torch.from_numpy(w), torch.from_numpy(c)).numpy(),
                    np.asarray(jwanda.scores(jnp.asarray(w), jnp.asarray(c))),
                    rtol=1e-6)


@pytest.mark.parametrize("k", [32, 64, 100])
def test_prune_matches_jax(k):
    w, x = _problem(32, 128, seed=3)
    c = (x.T @ x / x.shape[0]).astype(np.float32)
    jres = jawp.prune(jnp.asarray(w), jnp.asarray(c), k)
    res = awp.prune(torch.from_numpy(w), torch.from_numpy(c), k)
    assert res.iters == int(jres.iters)
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    assert_allclose(float(res.grad_norm), float(jres.grad_norm), rtol=2e-4)
    assert ((res.theta != 0).sum(-1) == k).all()


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_quantize_matches_jax(bits):
    w, x = _problem(32, 256, seed=4)
    c = (x.T @ x / x.shape[0]).astype(np.float32)
    jres = jawp.quantize(jnp.asarray(w), jnp.asarray(c), bits, group_size=128)
    res = awp.quantize(torch.from_numpy(w), torch.from_numpy(c), bits,
                       group_size=128)
    assert res.iters == int(jres.iters) == 10
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    assert_allclose(float(res.grad_norm), float(jres.grad_norm), rtol=2e-4)
    for theta, jtheta in ((res.theta, jres.theta),
                          (torch.from_numpy(w), jnp.asarray(w))):
        assert_allclose(float(awp.activation_loss(torch.from_numpy(w), theta,
                                                  torch.from_numpy(c))),
                        float(jawp.activation_loss(jnp.asarray(w), jtheta,
                                                   jnp.asarray(c))),
                        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("scale,k,iters", [
    (6e-4, 90, 21), (1e-3, 100, 25), (7e-4, 90, 40), (1.0, 64, 200)])
def test_prune_iteration_counts_match_jax_across_chunks(scale, k, iters):
    """The port's loop reads the norm on the host once per chunk of
    ``PGD_CHUNK_ITERS`` masked steps: a layer that converges inside the
    first chunk, at its last step, inside the second, or never (the cap)
    stops at JAX's ``while_loop`` count with its θ and norm."""
    assert awp.PGD_CHUNK_ITERS == 25
    w, x = _problem(32, 128, seed=3)
    c = (x.T @ x / x.shape[0] * scale).astype(np.float32)
    jres = jawp.prune(jnp.asarray(w), jnp.asarray(c), k)
    res = awp.prune(torch.from_numpy(w), torch.from_numpy(c), k)
    assert int(res.iters) == int(jres.iters) == iters
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    assert_allclose(float(res.grad_norm), float(jres.grad_norm), rtol=2e-4)


@pytest.mark.parametrize("nm", [(2, 4), (1, 8)])
def test_prune_n_m_matches_jax(nm):
    w, x = _problem(32, 128, seed=6)
    c = (x.T @ x / x.shape[0]).astype(np.float32)
    jres = jawp.prune(jnp.asarray(w), jnp.asarray(c), 64, nm=nm)
    res = awp.prune(torch.from_numpy(w), torch.from_numpy(c), 64, nm=nm)
    assert int(res.iters) == int(jres.iters)
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    assert_array_equal(res.theta.numpy() != 0, np.asarray(jres.theta) != 0)
    n, m = nm
    assert ((res.theta.reshape(32, -1, m) != 0).sum(-1) <= n).all()


@pytest.mark.parametrize("k,bits", [(64, 4), (40, 3)])
def test_joint_matches_jax(k, bits):
    w, x = _problem(32, 256, seed=7)
    c = (x.T @ x / x.shape[0]).astype(np.float32)
    jres = jawp.joint(jnp.asarray(w), jnp.asarray(c), k, bits, group_size=64)
    res = awp.joint(torch.from_numpy(w), torch.from_numpy(c), k, bits,
                    group_size=64)
    assert int(res.iters) == int(jres.iters) == 100
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    assert_array_equal(res.theta.numpy() != 0, np.asarray(jres.theta) != 0)
    assert ((res.theta != 0).sum(-1) <= k).all()


def test_baselines_n_m_and_magnitude_match_jax():
    from repro.core.baselines import magnitude as jmagnitude
    from repro_torch.core.baselines import magnitude
    w, x = _problem(16, 64, seed=8)
    c = x.T @ x / x.shape[0]
    for n, m in ((2, 4), (1, 4), (3, 8)):
        want = np.asarray(jwanda.prune_weight_n_m(jnp.asarray(w),
                                                  jnp.asarray(c), n, m))
        got = wanda.prune_weight_n_m(torch.from_numpy(w), torch.from_numpy(c),
                                     n, m).numpy()
        assert_array_equal(got, want)
        assert_array_equal(np.signbit(got), np.signbit(want))
    for k, per_row in ((1, True), (20, True), (20, False)):
        want = np.asarray(jmagnitude.prune_weight(jnp.asarray(w), k,
                                                  per_row=per_row))
        got = magnitude.prune_weight(torch.from_numpy(w), k, per_row=per_row)
        assert_array_equal(got.numpy(), want)


def test_pgd_stops_on_nan_like_while_loop():
    """A NaN gradient norm ends the loop after that step, as in
    ``lax.while_loop`` (``nan >= tol`` is false)."""
    w = torch.ones(4, 8)
    c = torch.full((8, 8), float("nan"))
    res = awp.pgd(w, c, lambda z, t: z, torch.zeros(4, 8),
                  awp.PGDConfig(max_iters=50, tol=1e-4))
    jres = jawp.pgd(jnp.ones((4, 8)), jnp.full((8, 8), jnp.nan),
                    lambda z, t: z, jnp.zeros((4, 8)),
                    jawp.PGDConfig(max_iters=50, tol=1e-4))
    assert res.iters == int(jres.iters) == 1


@pytest.mark.parametrize("method,spec_kw", [
    ("awp_prune", {"ratio": 0.5}), ("wanda", {"ratio": 0.7}),
    ("awp_quant", {"bits": 4, "group_size": 64}),
    ("awp_prune_nm", {"nm": (2, 4)}),
    ("awp_joint", {"ratio": 0.5, "bits": 4, "group_size": 64}),
    ("wanda", {"nm": (2, 4)}), ("magnitude", {"ratio": 0.6})])
def test_registry_adapters_match_jax(method, spec_kw):
    w, x = _problem(32, 128, seed=5)
    st_j, st_t = _both_stats(x)
    kind = ("JointSpec" if {"bits", "ratio"} <= set(spec_kw) else
            "QuantSpec" if "bits" in spec_kw else "PruneSpec")
    cls, jcls = getattr(specs, kind), getattr(jspecs, kind)
    res = registry.get_method(method)(torch.from_numpy(w), st_t,
                                      cls(method=method, **spec_kw))
    jres = jreg.get_method(method)(jnp.asarray(w), st_j,
                                   jcls(method=method, **spec_kw))
    assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                    rtol=2e-4, atol=2e-4)
    if jres.mask is not None:
        assert_array_equal(res.mask.numpy(), np.asarray(jres.mask))
    if jres.qtensor is not None:
        agree = (res.qtensor.codes().numpy()
                 == np.asarray(jres.qtensor.codes())).mean()
        assert agree >= 0.999
    if jres.iters is not None:
        assert int(res.iters) == int(jres.iters)


def test_policy_and_specs_match_jax():
    rules = [("blocks.0.*", None), ("*.attn.wo", "prune"), ("*.mlp.*", "q8")]

    def build(mod):
        sp = {"prune": mod.PruneSpec(ratio=0.6), "q8": mod.QuantSpec(bits=8),
              None: None}
        return mod.Policy([(p, sp[s]) for p, s in rules],
                          default=mod.QuantSpec(bits=4, group_size=64))

    pol, jpol = build(specs), build(jspecs)
    assert pol.to_dict() == jpol.to_dict()
    assert specs.Policy.from_dict(jpol.to_dict()).to_dict() == jpol.to_dict()
    for name in ("blocks.0.attn.wq", "blocks.3.attn.wo", "blocks.2.mlp.wd",
                 "blocks.5.attn.wk"):
        short = name.rsplit(".", 1)[1]
        mine, theirs = pol.spec_for(name, short), jpol.spec_for(name, short)
        assert (mine is None and theirs is None) or mine.to_dict() == theirs.to_dict()
    for d_in in (7, 96, 128, 200, 2048):
        assert specs.effective_group(d_in, 128) == jspecs.effective_group(d_in, 128)
    assert specs.PruneSpec(ratio=0.3).k_for(77) == jspecs.PruneSpec(ratio=0.3).k_for(77)
    assert specs.qualified_name(("blocks", "mlp", "wu"), 3) == "blocks.3.mlp.wu"
    registry.validate_spec(specs.QuantSpec())
    with pytest.raises(ValueError):
        registry.validate_spec(specs.QuantSpec(method="no_such_method"))
    assert set(registry.available()) == {"awp_prune", "awp_prune_nm",
                                         "awp_quant", "awp_joint", "wanda",
                                         "magnitude"}
