"""The port's sharding rules (``repro_torch.sharding``), device meshes
(``repro_torch.launch.mesh``) and the models' logical axes, held to the
JAX package's.

The specs of ``tests/test_distribution.py`` run at four gloo ranks on a
(2, 2) mesh (one spawn, ``torch_dist_util``) against JAX's at the same
mesh (one ``run_multidevice`` subprocess with four fake devices); the
logical-axes trees of all 14 archs compare in this process. About 20 s on
one process.
"""
import numpy as np
import pytest

from conftest import run_multidevice
from torch_dist_util import run_ranks

import jax

from repro.configs import get_tiny_config as jget_tiny, list_archs
from repro.models import build_model as jbuild
from repro.sharding import (ShardingRules as JRules,
                            opt_logical_axes as jopt_axes)
from repro_torch.configs import get_tiny_config
from repro_torch.models import build_model
from repro_torch.sharding import (NO_RULES, P, ShardingRules,
                                  opt_logical_axes, rules_for_cell)

JAX_CODE = r"""
import sys, pickle, numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.configs import get_tiny_config
from repro.models import build_model
from repro.quant import QTensor
from repro.sharding import ShardingRules, adapt_logical_axes, tree_specs
inp = dict(np.load(sys.argv[1]))
mesh = make_mesh((2, 2), ("data", "model"))
r = ShardingRules.for_mesh(mesh)
t = lambda s: tuple(s)
out = {"spec37": t(r.spec((None, "tp"), (8, 37))),
       "spec36": t(r.spec((None, "tp"), (8, 36))),
       "dup": t(r.spec(("batch", "fsdp"), (8, 8))),
       "rows": t(r.spec(("rows", None), (16, 5)))}
w = jnp.asarray(inp["qt_w"])
qt = QTensor.from_dense(w, bits=4, group_size=32,
                        col_scale=jnp.ones((64,), jnp.float32))
stacked = jax.tree.map(lambda a: jnp.stack([a] * 3), qt)
params = {"blocks": {"attn": {"wq": stacked, "norm": jnp.ones((3, 8))}}}
axes = {"blocks": {"attn": {"wq": (None, "fsdp", "tp"), "norm": (None, None)}}}
adapted = adapt_logical_axes(axes, params)
specs = tree_specs(r, adapted, jax.eval_shape(lambda: params))
wq = specs["blocks"]["attn"]["wq"]
out["qt"] = {"packed": t(wq.packed), "scale": t(wq.scale), "zero": t(wq.zero),
             "col_scale": t(wq.col_scale),
             "norm": t(specs["blocks"]["attn"]["norm"]),
             "axes_packed": adapted["blocks"]["attn"]["wq"].packed}
model = build_model(get_tiny_config("granite-8b"), r)
shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
def flat(tree, prefix=""):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(flat(v, prefix + k + "/"))
        return o
    return {prefix[:-1]: tuple(tree)}
out["granite"] = flat(tree_specs(r, model.param_logical_axes(), shapes))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("ok")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import pickle
    d = tmp_path_factory.mktemp("shard")
    inp = {"qt_w": np.random.default_rng(0).normal(size=(16, 64))
           .astype(np.float32)}
    np.savez(d / "inp.npz", **inp)
    run_multidevice(f"import sys; sys.argv = ['x', {str(d / 'inp.npz')!r}, "
                    f"{str(d / 'jax.pkl')!r}]\n" + JAX_CODE, n_devices=4)
    with open(d / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return jax_out, run_ranks(["sharding_specs"], inp)


def test_rules_without_mesh():
    r = ShardingRules(mesh=None)
    assert r.spec(("batch", None, "tp"), (8, 4, 16)) == P(None, None, None)
    assert rules_for_cell(None, "ssm", "train").mesh is None
    assert NO_RULES.spec(("batch",), (8,)) == P(None)


@pytest.mark.parametrize("case", ["spec37", "spec36", "dup", "rows"])
def test_spec_cases_match_jax(results, case):
    """tests/test_distribution.py's spec cases at (2, 2): 37 does not
    divide "model" and replicates; a mesh axis appears once in a spec;
    "rows" spans the whole mesh."""
    jax_out, ranks = results
    want = {"spec37": (None, None), "spec36": (None, "model"),
            "dup": ("data", None), "rows": (("data", "model"), None)}
    assert jax_out[case] == want[case]
    for r in ranks:
        assert r["sharding_specs"][case] == want[case]


def test_qtensor_specs_match_jax(results):
    """Packed QTensor leaves shard per child (packed/scale/zero over TP and
    FSDP, col_scale over FSDP) as JAX's do, and place as DTensors."""
    jax_out, ranks = results
    for r in ranks:
        got = r["sharding_specs"]
        assert got["qt"] == jax_out["qt"]
        # packed (3, 16, 32): dim 1 over "model", dim 2 over "data"
        assert got["qt_placed"] == ["Shard(2)", "Shard(1)"]


def test_model_param_specs_match_jax(results):
    jax_out, ranks = results
    for r in ranks:
        assert r["sharding_specs"]["granite"] == jax_out["granite"]


def test_mesh_errors_and_hint(results):
    """make_production_mesh and a mismatched make_mesh raise with the
    world size found; hint is the identity on a plain tensor and
    redistributes a DTensor to the spec's placements."""
    _, ranks = results
    for rank, r in enumerate(ranks):
        got = r["sharding_specs"]
        assert "(16, 16) needs 256 ranks" in got["errors"][0]
        assert "the launch has 4" in got["errors"][0]
        assert "(2, 4) needs 8 ranks" in got["errors"][1]
        assert got["hint_plain_same"]
        assert got["hint_placements"] == ["Shard(0)", "Shard(1)"]
        x = np.arange(32.0).reshape(4, 8)
        i, j = divmod(rank, 2)
        np.testing.assert_array_equal(got["hint_local"],
                                      x[i * 2:i * 2 + 2, j * 4:j * 4 + 4])


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", list_archs())
def test_logical_axes_trees_match_jax(arch):
    """param_logical_axes, cache_logical_axes and the optimizer states'
    axes (AdamW and Adafactor) of every arch equal the reference's."""
    jm = jbuild(jget_tiny(arch), JRules(mesh=None))
    pm = build_model(get_tiny_config(arch))
    assert pm.param_logical_axes() == jm.param_logical_axes()
    assert pm.cache_logical_axes() == jm.cache_logical_axes()
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    pshapes = _shapes(pm.init(0, device="cpu"))
    assert pshapes == _shapes(jshapes)
    for opt in ("adamw", "adafactor"):
        assert (opt_logical_axes(opt, pm.param_logical_axes(), pshapes)
                == jopt_axes(opt, jm.param_logical_axes(), jshapes))
