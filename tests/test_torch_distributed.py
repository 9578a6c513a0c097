"""The port's distributed AWP (``repro_torch.core.distributed``),
``calibration.cross_replica``, ``grad_compress.int8_psum`` and the sharded
checkpoint restore, held to the JAX package's on the same numpy inputs and
the same mesh shapes.

JAX runs once for the file, in one ``run_multidevice`` subprocess with
four fake CPU devices; the port runs once, in one spawn of four gloo ranks
(``torch_dist_util``). Bars are the reference's (``tests/test_distribution.py``):
2e-4 for the PGD loops, 1e-4/1e-5 for C. About 25 s on one process.
"""

import numpy as np
import pytest

from conftest import run_multidevice
from torch_dist_util import run_ranks

K, ITERS = 32, 10


def _inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 64)).astype(np.float32)
    x = rng.normal(size=(256, 64)).astype(np.float32)
    c = (x.T @ x / 256).astype(np.float32)
    eta = np.float32(2.0 / np.linalg.norm(c))
    return {"w": w, "c": c, "w6": rng.normal(size=(6, 64)).astype(np.float32),
            "k": K, "eta": eta, "iters": ITERS,
            "acts": rng.normal(size=(64, 16)).astype(np.float32),
            "g": (rng.normal(size=(32, 6)) * 1e-3).astype(np.float32),
            "tree_w": rng.normal(size=(16, 8)).astype(np.float32)}


JAX_CODE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.core import distributed as dist, calibration as calib
from repro.optim.grad_compress import int8_psum
from repro.sharding import ShardingRules
from repro.launch.mesh import make_mesh
from repro.checkpoint import save_checkpoint
inp = dict(np.load(sys.argv[1]))
w, c, w6 = (jnp.asarray(inp[k]) for k in ("w", "c", "w6"))
k, eta, iters = int(inp["k"]), float(inp["eta"]), int(inp["iters"])
out = {"ref": dist.awp_prune_rowsharded_fn(k, eta, iters)(w, c)}
for name, shape in (("22", (2, 2)), ("41", (4, 1)), ("14", (1, 4))):
    mesh = make_mesh(shape, ("data", "model"))
    rules = ShardingRules.for_mesh(mesh)
    out["row" + name] = dist.awp_prune_rowsharded(w, c, k, eta, iters, rules)
    out["row6_" + name] = dist.awp_prune_rowsharded(w6, c, k, eta, iters, rules)
    with compat.set_mesh(mesh):
        out["col" + name] = jax.jit(dist.awp_prune_colsharded_fn(
            k, eta, iters, rules))(w, c)
acts = jnp.asarray(inp["acts"])
mesh4 = make_mesh((4,), ("data",))
rules4 = ShardingRules.for_mesh(mesh4)
with compat.set_mesh(mesh4):
    out["calib4"] = jax.jit(lambda a: dist.calib_c_distributed(a, rules4))(acts)
mesh22 = make_mesh((2, 2), ("data", "model"))
rules22 = ShardingRules.for_mesh(mesh22)
with compat.set_mesh(mesh22):
    out["calib22"] = jax.jit(lambda a: dist.calib_c_distributed(a, rules22))(acts)
def local_stats(a):
    st = calib.update(calib.init(a.shape[-1]), a)
    return tuple(calib.cross_replica(st, "data"))
st = compat.shard_map(local_stats, mesh=mesh4, in_specs=P("data", None),
                      out_specs=(P(), P(), P()), check_vma=False)(acts)
out["n"], out["c_sum"], out["abs_sum"] = st
out["int8_psum"] = compat.shard_map(
    lambda g: int8_psum(g, "data"), mesh=mesh4, in_specs=P("data", None),
    out_specs=P(), check_vma=False)(jnp.asarray(inp["g"]))
t = {"w": jax.device_put(jnp.asarray(inp["tree_w"]),
                         NamedSharding(mesh22, P("data", "model")))}
out["jax_path"] = np.array(save_checkpoint(sys.argv[3], 7, t))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("ok")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    run_multidevice(
        f"import sys; sys.argv = ['x', {str(d / 'inp.npz')!r}, "
        f"{str(d / 'jax.npz')!r}, {str(d / 'jck')!r}]\n" + JAX_CODE,
        n_devices=4)
    jax_out = dict(np.load(d / "jax.npz"))
    ranks = run_ranks(["awp_distributed", "elastic_restore"],
                      dict(inp, dir=str(d / "ck"),
                           jax_path=str(jax_out["jax_path"])))
    return inp, jax_out, ranks


@pytest.mark.parametrize("mesh", ["22", "41", "14"])
@pytest.mark.parametrize("schedule", ["row", "col", "row6_"])
def test_sharded_awp_matches_jax(results, schedule, mesh):
    """Row- and column-sharded PGD (and the row loop's graded fallback at
    6 rows) at (2, 2), (4, 1) and (1, 4): each rank's whole Θ equals JAX's
    sharded result and the unsharded loop at 2e-4."""
    _, jax_out, ranks = results
    key = schedule + mesh
    for r in ranks:
        got = r["awp_distributed"][key]
        np.testing.assert_allclose(got, jax_out[key], rtol=2e-4, atol=2e-4)
        if schedule != "row6_":
            np.testing.assert_allclose(got, jax_out["ref"], rtol=2e-4,
                                       atol=2e-4)
        assert (np.count_nonzero(got, axis=1) == K).all()


@pytest.mark.parametrize("mesh", ["22", "41", "14"])
@pytest.mark.parametrize("schedule", ["row", "col"])
def test_sharded_awp_dtensor_inputs(results, schedule, mesh):
    """W and C given as DTensors laid out as each schedule reads them:
    each rank takes only its own block (the one whole tensor of W's or
    C's shape gathered is Θ, at the end), and Θ has the same bits as from
    plain tensors."""
    inp, _, ranks = results
    for r in ranks:
        got = r["awp_distributed"]
        np.testing.assert_array_equal(got[f"dt_{schedule}{mesh}"],
                                      got[f"{schedule}{mesh}"])
        assert got[f"dt_{schedule}{mesh}_gathered"] == [inp["w"].shape]


def test_calib_c_dtensor_acts(results):
    """Token-sharded DTensor activations: the same C, no gather."""
    _, _, ranks = results
    for r in ranks:
        got = r["awp_distributed"]
        np.testing.assert_array_equal(got["dt_calib22"], got["calib22"])
        assert got["dt_calib22_gathered"] == 0


def test_unsharded_loop_matches_jax(results):
    _, jax_out, ranks = results
    np.testing.assert_allclose(ranks[0]["awp_distributed"]["ref"],
                               jax_out["ref"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mesh", ["22", "41", "14"])
@pytest.mark.parametrize("schedule", ["row", "col"])
def test_sharded_awp_matches_compression_loop(results, schedule, mesh):
    """Both schedules against the compression path's own unsharded loop
    (``core.awp.pgd`` with the prune projection, tol 0) at 2e-4, with the
    same kept entries."""
    _, _, ranks = results
    for r in ranks:
        got = r["awp_distributed"]
        np.testing.assert_allclose(got[schedule + mesh], got["pgd"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(got[schedule + mesh] != 0,
                                      got["pgd"] != 0)


def test_rowsharded_graded_fallback(results):
    """6 rows do not divide four ranks: trailing mesh dims are dropped
    until the rows divide — (2, 2) splits them over "data", (4, 1) over
    none, (1, 4) over its one-rank "data"."""
    _, _, ranks = results
    got = ranks[0]["awp_distributed"]
    assert got["rowaxes6_22"] == ["data"]
    assert got["rowaxes6_41"] == []
    assert got["rowaxes6_14"] == ["data"]


@pytest.mark.parametrize("mesh", ["calib4", "calib22"])
def test_calib_c_distributed(results, mesh):
    inp, jax_out, ranks = results
    a = inp["acts"]
    for r in ranks:
        c = r["awp_distributed"][mesh]
        np.testing.assert_allclose(c, a.T @ a / 64, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(c, jax_out[mesh], rtol=1e-5, atol=1e-6)


def test_cross_replica_matches_jax(results):
    """Each of four ranks folds its 16 tokens; the all-reduced stats equal
    JAX's psum inside shard_map."""
    _, jax_out, ranks = results
    for r in ranks:
        st = r["awp_distributed"]["stats"]
        for f in ("n", "c_sum", "abs_sum"):
            np.testing.assert_allclose(st[f], jax_out[f], rtol=1e-6,
                                       atol=1e-6)


def test_int8_psum_matches_jax(results):
    _, jax_out, ranks = results
    for r in ranks:
        got = r["awp_distributed"]
        assert got["world"] == 4
        np.testing.assert_allclose(got["int8_psum"], jax_out["int8_psum"],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(got["int8_psum_default"],
                                      got["int8_psum"])


def test_elastic_restore_across_meshes(results):
    """Saved from a (2, 2) mesh, restored onto (4,) with rows sharded:
    every rank has the whole tree and its quarter of the rows; a
    checkpoint JAX wrote from its (2, 2) mesh restores the same way."""
    inp, _, ranks = results
    w = inp["tree_w"]
    for rank, r in enumerate(ranks):
        got = r["elastic_restore"]
        np.testing.assert_array_equal(got["w"], w)
        np.testing.assert_array_equal(got["mgr"], w)
        assert got["step"] == 1
        assert got["placements"] == ["Shard(0)"]
        np.testing.assert_array_equal(got["local"], w[rank * 4:rank * 4 + 4])
        np.testing.assert_array_equal(got["jax"], w)
        np.testing.assert_array_equal(got["jax_local"],
                                      w[rank * 4:rank * 4 + 4])
