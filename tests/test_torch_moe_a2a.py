"""The port's expert-parallel MoE FFN (``moe_apply_a2a``, ``_slot_factor``,
``_slot_weights``, ``moe_apply``'s path choice) held to the masked dense
path and to the JAX package's all-to-all path on tiny qwen3-moe with
``capacity_factor=8.0`` (no token dropped), dense and packed experts, at
(2, 2); two experts on four model ranks (r = 2 slots) at (1, 4); and the
a2a gradient (the autograd-aware all-to-all) against the masked dense
gradient; and the same on DTensor experts, each rank receiving only its
own experts. JAX runs once (one ``run_multidevice`` subprocess, four fake
devices), the port once (one spawn of four gloo ranks). Bar 2e-4, the
reference's. About 30 s on one process.
"""
import numpy as np
import pytest

from conftest import run_multidevice
from torch_dist_util import run_ranks

JAX_CODE = r"""
import sys, dataclasses, numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.configs import get_tiny_config
from repro.launch.mesh import make_mesh
from repro.models.moe import moe_params, moe_apply_dense, moe_apply_a2a, moe_apply
from repro.quant import QTensor
from repro.sharding import ShardingRules
def flat(tree, prefix):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(flat(v, prefix + k + "/"))
        return o
    if isinstance(tree, QTensor):
        return {prefix + "packed": np.asarray(tree.packed),
                prefix + "scale": np.asarray(tree.scale),
                prefix + "zero": np.asarray(tree.zero),
                prefix + "bits": np.asarray(tree.bits),
                prefix + "group_size": np.asarray(tree.group_size),
                prefix + "shape": np.asarray(tree.shape)}
    return {prefix[:-1]: np.asarray(tree)}
cfg = dataclasses.replace(get_tiny_config("qwen3-moe-235b-a22b"), capacity_factor=8.0)
p = moe_params(jax.random.PRNGKey(0), cfg)
def pack(w):
    qts = [QTensor.from_dense(w[e].T, bits=4, group_size=16) for e in range(w.shape[0])]
    return jax.tree.map(lambda *a: jnp.stack(a), *qts)
pq = dict(p, wu=pack(p["wu"]), wd=pack(p["wd"]), wg=pack(p["wg"]))
x = jax.random.normal(jax.random.PRNGKey(1), (8, 64, cfg.d_model))
out = dict(flat(p, "p/"))
for k in ("wu", "wd", "wg"):
    out.update(flat(pq[k], "pq/" + k + "/"))
out["x"] = np.asarray(x)
out["g_out"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2), x.shape))
mesh = make_mesh((2, 2), ("data", "model"))
rules = ShardingRules.for_mesh(mesh)
out["dense"] = moe_apply_dense(p, x, cfg)
out["packed_dense"] = moe_apply_dense(pq, x, cfg)
with compat.set_mesh(mesh):
    out["a2a"] = jax.jit(lambda p, x: moe_apply_a2a(p, x, cfg, rules))(p, x)
    out["packed_a2a"] = jax.jit(lambda p, x: moe_apply_a2a(p, x, cfg, rules))(pq, x)
cfg2 = dataclasses.replace(cfg, num_experts=2)
p2 = moe_params(jax.random.PRNGKey(3), cfg2)
out.update(flat(p2, "p2/"))
mesh14 = make_mesh((1, 4), ("data", "model"))
rules14 = ShardingRules.for_mesh(mesh14)
out["r2_dense"] = moe_apply_dense(p2, x, cfg2)
with compat.set_mesh(mesh14):
    out["r2_a2a"] = jax.jit(lambda p, x: moe_apply_a2a(p, x, cfg2, rules14))(p2, x)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print("ok")
"""

BAR = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("a2a")
    run_multidevice(f"import sys; sys.argv = ['x', {str(d / 'jax.npz')!r}]\n"
                    + JAX_CODE, n_devices=4, timeout=900)
    jax_out = dict(np.load(d / "jax.npz"))
    inp = {k: v for k, v in jax_out.items()
           if k.startswith(("p/", "pq/", "p2/")) or k in ("x", "g_out")}
    return jax_out, [r["moe_a2a"] for r in run_ranks(["moe_a2a"], inp)]


@pytest.mark.parametrize("experts", ["", "packed_"])
def test_a2a_equals_dense_and_jax(results, experts):
    """Every rank's whole output: a2a equals the masked dense path and
    JAX's a2a at 2e-4; moe_apply on the mesh takes the a2a path (equal
    bits); dense experts' dense path equals JAX's."""
    jax_out, ranks = results
    for r in ranks:
        a2a = r[experts + "a2a"]
        np.testing.assert_allclose(a2a, r[experts + "dense"], **BAR)
        np.testing.assert_allclose(a2a, jax_out[experts + "a2a"], **BAR)
        np.testing.assert_allclose(r[experts + "dense"],
                                   jax_out[experts + "dense"], **BAR)
        np.testing.assert_array_equal(r[experts + "auto"], a2a)
        assert r["dropped"] == 0


def test_a2a_gradient_equals_dense(results):
    """The gradient through both all-to-alls (summed over the ranks that
    each hold a part) equals the masked dense path's: x, the router and
    every expert stack."""
    _, ranks = results
    for r in ranks:
        g = r["grads"]
        assert set(g["a2a"]) == {"x", "router", "wu", "wd", "wg", "norm"}
        for k in g["a2a"]:
            np.testing.assert_allclose(g["a2a"][k], g["dense"][k],
                                       rtol=2e-4, atol=2e-5, err_msg=k)


def test_slot_split_r2(results):
    """Two experts on four model ranks: each expert splits into r = 2
    slots along d_ff whose partial sums the combine adds; equal to the
    dense path and to JAX's a2a."""
    jax_out, ranks = results
    for r in ranks:
        assert r["r2_slot"] == 2
        np.testing.assert_allclose(r["r2_a2a"], r["r2_dense"], **BAR)
        np.testing.assert_allclose(r["r2_a2a"], jax_out["r2_a2a"], **BAR)
        np.testing.assert_allclose(r["r2_dense"], jax_out["r2_dense"], **BAR)
        np.testing.assert_array_equal(r["r2_auto"], r["r2_a2a"])


@pytest.mark.parametrize("case", ["dt", "dt_ep", "dt_r2"])
def test_a2a_dtensor_experts(results, case):
    """DTensor experts as the sharded train state lays them out (d_ff on
    "model" for tiny qwen3-moe's 8 experts; the experts on "model" as for
    the full config's 128; r = 2 slots at (1, 4)) with x batch-sharded:
    the output and the gradient of x and of every leaf (no manual
    reduce) equal the masked dense path's. At r = 1 no expert stack is
    gathered whole and each rank keeps E / 2 experts; the r = 2 re-layout
    gathers the three stacks."""
    _, ranks = results
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}_a2a"], r[f"{case}_dense"],
                                   **BAR)
        g, gd = r[f"{case}_grads"], r[f"{case}_dense_grads"]
        assert set(g) == set(gd) == {"x", "router", "wu", "wd", "wg", "norm"}
        for k in g:
            np.testing.assert_allclose(g[k], gd[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
        if case == "dt_r2":
            assert r[f"{case}_gathered"] == 3
            assert r[f"{case}_local_experts"] == 1
        else:
            assert r[f"{case}_gathered"] == 0
            assert r[f"{case}_local_experts"] == 4
