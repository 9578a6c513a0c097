"""Whole-model compression with the methods this port added (RTN, AWQ, AWP-S,
Wanda+AWQ, AWQ+Wanda, SparseGPT, GPTQ) against the JAX package's, and
``tests/test_compress_model.py``'s method sweep on the port: tiny
granite-8b, JAX's random init carried across, one batch of 2 × 24 tokens.

Bars, layer by layer: the same layers in the same order; masks equal;
codes equal on at least 99.99% of entries with each differing code one
step off; Θ within 1e-5 of JAX's on all entries but at most 0.01% of them
(or one entry in a layer of fewer than 10,000), each such entry within one
step of a 4-bit grid over the layer's range; block 0's losses within 1e-5 relative. The loss
of the compressed model: the port's loss of JAX's compressed params within
1e-5 relative of JAX's, and the port's own compressed model within 1e-5 of
JAX's wherever no entry of Θ differs beyond 1e-5.

Why not every layer's loss and the model's at 1e-5: from block 1 on, each
package's inputs carry the earlier block's last-ulp differences (f32 sums
in other orders), and a rounding near-tie turns them into one code a
grid step off. At this seed Wanda+AWQ's ``blocks.1.attn.wv`` differs from
JAX's in one entry of 2,048 by one step (0.037), which moves that layer's
loss by 3.1e-5 relative and the model's loss by 3.6e-4; with JAX's Θ for
that one layer the port's model loss is JAX's. The per-layer bar on
identical inputs is ``tests/test_torch_baselines.py``'s.

The methods the port had before (AWP prune, N:M, quant, joint, Wanda,
magnitude) are held to JAX at the whole-model level by
``tests/test_torch_compress.py`` and ``tests/test_torch_batched.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.core.compress import CompressionConfig
from repro.core.compress import compress_model as jcompress_model
from repro.models import build_model as jbuild, make_batch
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import registry
from repro_torch.core.compress import compress_model
from repro_torch.models import build_model

ARCH = "granite-8b"
NEW = ["rtn", "awq", "awp_quant_scaled", "wanda_awq", "awq_wanda",
       "sparsegpt", "gptq"]
# tests/test_compress_model.py's sweeps: test_all_methods_on_dense and,
# on the MLP only, test_obs_baselines_on_dense
ALL_ON_DENSE = ["magnitude", "wanda", "awp_prune", "rtn", "awq", "awp_quant",
                "awp_quant_scaled", "awp_joint", "wanda_awq", "awq_wanda",
                "awp_prune_nm"]
OBS = ["sparsegpt", "gptq"]
OBS_SKIP = ("wq", "wk", "wv", "wo")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jget_tiny(ARCH)
    jmodel = jbuild(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = make_batch(jcfg, jax.random.PRNGKey(0), 2, 24)
    model = build_model(get_tiny_config(ARCH))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return dict(jmodel=jmodel, jparams=jparams, batch=batch,
                jloss=jax.jit(jmodel.loss), model=model, params=params,
                tbatch=tbatch, port_runs={})


def _spec(method, skip=()):
    """The port's spec (with a skip policy) for the reference's flat
    ``CompressionConfig(ratio=0.5, bits=4, group_size=32)``."""
    from repro_torch.core.specs import Policy
    cls = registry.spec_cls_for(method)
    kw = {f: v for f, v in dict(ratio=0.5, bits=4, group_size=32).items()
          if hasattr(cls, f)}
    spec = cls(method=method, **kw)
    return Policy({f"*.{s}": None for s in skip}, default=spec)


def _codes_close(codes, jcodes):
    codes = np.asarray(codes, np.int64)
    jcodes = np.asarray(jcodes, np.int64)
    assert (codes == jcodes).mean() >= 0.9999
    assert np.abs(codes - jcodes).max() <= 1


def _theta_close(theta, jtheta, name):
    """All entries within 1e-5 but at most max(1, 0.01%), each of those
    within one step of a 4-bit grid of the layer's range; returns how many
    differ."""
    diff = np.abs(theta - jtheta)
    off = diff > 1e-5
    n = int(off.sum())
    assert n <= max(1, theta.size // 10000), (name, n)
    if n:
        step = (jtheta.max() - jtheta.min()) / 15
        assert diff[off].max() <= step, (name, diff[off].max(), step)
    return n


def _port_run(tiny, method, skip):
    """The port's compression of the tiny model with ``method`` (once a
    module: both tests below read it)."""
    runs = tiny["port_runs"]
    if method not in runs:
        runs[method] = compress_model(tiny["model"], tiny["params"],
                                      [tiny["tbatch"]], _spec(method, skip))
    return runs[method]


def _thetas(params, rep, qualname):
    """A report's layer's Θ in ``params``, paper orientation."""
    art = rep.artifacts[qualname]
    group = art.path[1]
    return params["blocks"][group][art.path[2]][art.layer].T


@pytest.mark.parametrize("method", NEW)
def test_new_methods_match_jax_on_the_model(tiny, method):
    skip = OBS_SKIP if method in OBS else ()
    jcp, jrep = jcompress_model(
        tiny["jmodel"], tiny["jparams"], [tiny["batch"]],
        CompressionConfig(method=method, ratio=0.5, bits=4, group_size=32,
                          skip=skip), engine="sequential")
    cp, rep = _port_run(tiny, method, skip)
    assert [r.qualname for r in rep] == [r.qualname for r in jrep]
    assert len(rep) == 2 * (3 if skip else 7)
    differing = 0
    for r, jr in zip(rep, jrep):
        res = rep.artifacts[r.qualname].result
        jres = jrep.artifacts[r.qualname].result
        assert (res.mask is None) == (jres.mask is None)
        if jres.mask is not None:
            assert np.array_equal(np.asarray(res.mask),
                                  np.asarray(jres.mask)), r.qualname
        assert (res.qtensor is None) == (jres.qtensor is None)
        if jres.qtensor is not None:
            _codes_close(res.qtensor.codes().numpy(), jres.qtensor.codes())
        differing += _theta_close(
            _thetas(cp, rep, r.qualname).numpy(),
            np.asarray(_thetas(jcp, jrep, r.qualname)), r.qualname)
        assert np.isfinite(r.loss_after)
        if r.block == 0:
            assert abs(r.loss_after - jr.loss_after) <= \
                1e-5 * jr.loss_after, r.qualname
    jl = float(tiny["jloss"](jcp, tiny["batch"])[0])
    on_jax = params_from_numpy(jax.tree.map(np.asarray, jcp), device="cpu")
    assert abs(float(tiny["model"].loss(on_jax, tiny["tbatch"])[0]) - jl) \
        <= 1e-5 * jl
    if not differing:
        loss = float(tiny["model"].loss(cp, tiny["tbatch"])[0])
        assert abs(loss - jl) <= 1e-5 * jl


@pytest.mark.parametrize("method", ALL_ON_DENSE + OBS)
def test_every_method_on_dense(tiny, method):
    """``test_all_methods_on_dense`` and ``test_obs_baselines_on_dense``
    on the port: a finite loss of the compressed model, finite per-layer
    losses."""
    skip = OBS_SKIP if method in OBS else ()
    cp, rep = _port_run(tiny, method, skip)
    loss, _ = tiny["model"].loss(cp, tiny["tbatch"])
    assert not bool(torch.isnan(loss)), method
    assert all(np.isfinite(r.loss_after) for r in rep)
    assert len(rep) == 2 * (3 if skip else 7)
