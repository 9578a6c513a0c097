"""The port's data-parallel train step (``make_train_step_ddp``, int8 and
plain gradient sync) and its DTensor-sharded step, held to the JAX
package's ``make_train_step_ddp`` and pjit-sharded step on tiny
granite-8b, from JAX's init, at the same mesh shapes: (4,) for the DDP
steps, (2, 2) for the sharded step.

JAX runs once for the file (one ``run_multidevice`` subprocess, four fake
devices), the port once (one spawn of four gloo ranks). Bars: the step
losses at 2e-4 and the sharded step's params at rtol 2e-3 / atol 2e-4
(``tests/test_distribution.py``), the int8 run's convergence as the
reference checks it. About 80 s on one process.
"""
import numpy as np
import pytest

from conftest import run_multidevice
from torch_dist_util import flatten, run_ranks

DDP_STEPS = 25

JAX_CODE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_tiny_config
from repro.data import DataConfig, ZipfMarkov
from repro.launch.mesh import make_mesh
from repro.models import build_model, make_batch
from repro.optim import OptimizerConfig
from repro.sharding import ShardingRules, tree_shardings
from repro.training.train_loop import (TrainConfig, make_train_step,
                                       make_train_step_ddp)
def flat(tree, prefix=""):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(flat(v, prefix + k + "/"))
        return o
    return {prefix[:-1]: np.asarray(tree)}
steps = int(sys.argv[2])
cfg = get_tiny_config("granite-8b")
model = build_model(cfg, remat=False)
key = jax.random.PRNGKey(0)
params = model.init(key)
out = flat(params, "params0/")
mesh = make_mesh((4,), ("data",))
rules = ShardingRules.for_mesh(mesh)
gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=16))
tcfg = TrainConfig(optimizer=OptimizerConfig(lr=2e-3, warmup_steps=5, total_steps=100))
for compress, n in (("int8", steps), (None, 3)):
    step_fn, opt_init = make_train_step_ddp(model, tcfg, rules, compress=compress)
    state = {"params": params, "opt": opt_init(params), "step": jnp.zeros((), jnp.int32)}
    with compat.set_mesh(mesh):
        jstep = jax.jit(step_fn)
        losses = []
        for i in range(n):
            t, l = gen.batch(i)
            state, m = jstep(state, {"tokens": jnp.asarray(t), "labels": jnp.asarray(l)})
            losses.append(float(m["loss"]))
            if i == 0:
                out.update(flat(state["params"], f"ddp_{compress}_params1/"))
    out[f"ddp_{compress}_losses"] = np.array(losses)
# tests/test_distribution.py's sharded step at (2, 2)
mesh = make_mesh((2, 2), ("data", "model"))
rules = ShardingRules.for_mesh(mesh)
m_sharded = build_model(cfg, rules, remat=False)
batch = make_batch(cfg, key, 4, 16)
out.update(flat(batch, "batch/"))
tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
step_s, opt_init = make_train_step(m_sharded, tcfg)
with compat.set_mesh(mesh):
    p_sh = tree_shardings(rules, m_sharded.param_logical_axes(),
                          jax.eval_shape(m_sharded.init, key))
    sp = jax.device_put(params, p_sh)
    state_s = {"params": sp, "opt": opt_init(sp), "step": jnp.zeros((), jnp.int32)}
    bs = jax.device_put(batch, {k: NamedSharding(mesh, P(rules.batch_axes)) for k in batch})
    s_shard, ms = jax.jit(step_s)(state_s, bs)
out["sharded_loss"] = np.asarray(ms["loss"])
out.update(flat(s_shard["params"], "sharded_params/"))
np.savez(sys.argv[1], **out)
print("ok")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp")
    run_multidevice(f"import sys; sys.argv = ['x', {str(d / 'jax.npz')!r}, "
                    f"'{DDP_STEPS}']\n" + JAX_CODE, n_devices=4, timeout=900)
    jax_out = dict(np.load(d / "jax.npz"))
    inp = {k: v for k, v in jax_out.items()
           if k.startswith(("params0/", "batch/"))}
    inp["ddp_steps"] = DDP_STEPS
    return jax_out, run_ranks(["train_steps"], inp)[0]["train_steps"]


@pytest.mark.parametrize("compress", ["int8", None])
def test_ddp_losses_match_jax(results, compress):
    """Each step's loss (the mean over four ranks) equals JAX's DDP step's
    at 2e-4, with int8-compressed and plain gradient sync; the params
    after one step within the sharded-step bars."""
    jax_out, got = results
    want = jax_out[f"ddp_{compress}_losses"]
    np.testing.assert_allclose(got[f"ddp_{compress}_losses"], want,
                               rtol=0, atol=2e-4)
    params = flatten(got[f"ddp_{compress}_params1"])
    for k, v in params.items():
        np.testing.assert_allclose(
            v, jax_out[f"ddp_{compress}_params1/{k}"], rtol=2e-3, atol=2e-4,
            err_msg=k)


def test_ddp_batch_over_two_mesh_dims(results):
    """Batch axes ("pod", "data") on a (2, 2) mesh: the flattened group
    has the (4,) mesh's ranks in its order, so the int8 steps' losses
    are the same bits."""
    _, got = results
    np.testing.assert_array_equal(got["ddp_pod_data_losses"],
                                  got["ddp_int8_losses"][:3])


def test_ddp_int8_training_converges(results):
    """tests/test_distribution.py's check: 25 int8-synced steps lower the
    loss by more than 0.5."""
    _, got = results
    losses = got["ddp_int8_losses"]
    assert len(losses) == DDP_STEPS
    assert losses[-1] < losses[0] - 0.5, losses


def test_sharded_step_matches_jax(results):
    """The DTensor step at (2, 2) against JAX's pjit step: loss within
    2e-4, every param within rtol 2e-3 / atol 2e-4; wq stays sharded (its
    d_in on "data", d_out on "model")."""
    jax_out, got = results
    assert abs(float(got["sharded_loss"]) - float(jax_out["sharded_loss"])) \
        < 2e-4
    params = flatten(got["sharded_params"])
    assert len(params) == sum(k.startswith("sharded_params/")
                              for k in jax_out)
    for k, v in params.items():
        np.testing.assert_allclose(v, jax_out[f"sharded_params/{k}"],
                                   rtol=2e-3, atol=2e-4, err_msg=k)
    assert got["sharded_wq_placements"] == ["Shard(1)", "Shard(2)"]


@pytest.mark.parametrize("compress", ["topk_ef", "int4"])
def test_ddp_refuses_other_compression(compress):
    """Gradient sync is a mean or int8: any other ``compress`` raises
    before a step is built, rather than quietly taking the mean."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model
    from repro_torch.sharding import NO_RULES
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step_ddp)
    model = build_model(get_tiny_config("granite-8b"))
    with pytest.raises(ValueError, match="int8"):
        make_train_step_ddp(model, TrainConfig(), NO_RULES,
                            compress=compress)
