"""Train steps of the port's other families against the JAX package on the
CPU (the MoE: qwen3-moe-235b-a22b and grok-1-314b; the SSM, hybrid, audio
and vlm families: falcon-mamba-7b, zamba2-1.2b, musicgen-medium,
internvl2-1b), at their tiny presets with JAX's random init carried into
the port and the reference's ``make_batch`` batches of 2 x 24 on both
sides; and the port of ``tests/test_models_smoke.py``'s forward and train
step over every arch the reference lists.

Bars (``tests/test_torch_train.py``'s): the loss and grad_norm within
1e-5 relative, the lr within 2 f32 ulps, AdamW's m and v within 1e-5 of
the leaf's max|·|; the parameters within 1e-5 except where a near-zero
gradient's sign differs between the frameworks (at most 1 entry in 1,000,
each within 2·lr a step); after five steps the loss within 1e-4
relative. About 70 s on one process (JAX compiles a train step per arch
and form).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.configs import list_archs as jlist_archs
from repro.models import build_model as jbuild
from repro.models import make_batch as jmake_batch
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import optimizers as jopt
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config, list_archs
from repro_torch.models import build_model, make_batch
from repro_torch.optim import OptimizerConfig
from repro_torch.optim import optimizers as opt
from repro_torch.training.train_loop import TrainConfig, make_train_step

ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b", "falcon-mamba-7b",
         "zamba2-1.2b", "musicgen-medium", "internvl2-1b"]
OPT = dict(lr=1e-3, warmup_steps=20, total_steps=200)
LR = OPT["lr"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _np_tree(tree):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in _leaves(tree)}


def _to_port(batch):
    out = {}
    for k, v in batch.items():
        if v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(
                np.array(v.astype(jnp.float32))).to(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v, dtype=np.int64))
    return out


class _Tiny(dict):
    """Each arch's tiny model in both packages on JAX's init, five 2 x 24
    batches of the reference's ``make_batch``, and JAX's train step jitted
    once a form (single batch, two microbatches)."""

    def __missing__(self, arch):
        jcfg = jget_tiny(arch)
        jmodel = jbuild(jcfg, remat=False)
        jbatches = [jmake_batch(jcfg, jax.random.PRNGKey(10 + i), 2, 24)
                    for i in range(5)]
        self[arch] = dict(
            model=build_model(get_tiny_config(arch), remat=False),
            jmodel=jmodel, jparams=jax.jit(jmodel.init)(jax.random.PRNGKey(0)),
            jbatches=jbatches, batches=[_to_port(b) for b in jbatches],
            jsteps={})
        return self[arch]


@pytest.fixture(scope="module")
def tiny():
    return _Tiny()


def _jstep(t, n):
    if n not in t["jsteps"]:
        fn, _ = jmake_train_step(t["jmodel"], JTrainConfig(
            optimizer=JOptimizerConfig(**OPT), microbatches=n))
        t["jsteps"][n] = jax.jit(fn)
    return t["jsteps"][n]


def _run(t, n, steps):
    """(JAX's state, metrics), (the port's) after ``steps`` steps from the
    same params and batches."""
    init, _ = jopt.make_optimizer(JOptimizerConfig(**OPT))
    jstate = {"params": t["jparams"], "opt": init(t["jparams"]),
              "step": jnp.zeros((), jnp.int32)}
    jstep = _jstep(t, n)
    for b in t["jbatches"][:steps]:
        jstate, jm = jstep(jstate, b)
    step, opt_init = make_train_step(t["model"], TrainConfig(
        optimizer=OptimizerConfig(**OPT), microbatches=n))
    params = params_from_numpy(jax.tree.map(np.asarray, t["jparams"]),
                               device="cpu")
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    for b in t["batches"][:steps]:
        state, m = step(state, b)
    return (jstate, jm), (state, m)


def _hold_params(want, got, steps):
    """Within 1e-5, except entries whose near-zero gradient changed sign
    (at most 1 in 1,000, each within 2·lr a step)."""
    flips, total = 0, 0
    for k, a in want.items():
        d = np.abs(a - got[k])
        flips += int((d > 1e-5).sum())
        total += d.size
        assert d.max() <= 2 * LR * steps + 1e-5, (k, d.max())
    assert flips <= total // 1000, (flips, total)


@pytest.mark.parametrize("n", [1, 2], ids=["single", "microbatched"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_jax(tiny, arch, n):
    """One AdamW step, single-batch and as two interleaved microbatches:
    the loss, lr and grad_norm, the step counter, params, m and v."""
    (jstate, jm), (state, m) = _run(tiny[arch], n, 1)
    assert int(state["step"]) == int(jstate["step"]) == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    np.testing.assert_array_max_ulp(np.asarray(jm["lr"]), m["lr"].numpy(),
                                    maxulp=2)
    _hold_params(_np_tree(jstate["params"]), _np_tree(state["params"]), 1)
    for part in ("m", "v"):
        want, got = _np_tree(jstate["opt"][part]), _np_tree(state["opt"][part])
        assert want.keys() == got.keys()
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= \
                1e-5 * np.abs(want[k]).max() + 1e-12, (part, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_five_steps_match_jax(tiny, arch):
    (jstate, jm), (state, m) = _run(tiny[arch], 1, 5)
    assert int(state["step"]) == 5
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-4 * abs(float(jm["loss"]))
    _hold_params(_np_tree(jstate["params"]), _np_tree(state["params"]), 5)


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py::test_smoke_forward_and_train_step, ported
# ---------------------------------------------------------------------------

def test_the_port_lists_every_arch_of_the_reference():
    assert sorted(list_archs()) == sorted(jlist_archs(include_paper=True))


@pytest.mark.parametrize("arch", jlist_archs(include_paper=True))
def test_smoke_forward_and_train_step(arch):
    """Every arch's tiny preset in the port alone: its own init and
    ``make_batch`` batch of 2 x 24, a finite loss over counted tokens, and
    one AdamW step that counts and moves the params."""
    cfg = get_tiny_config(arch)
    model = build_model(cfg, remat=False)
    params = model.init(0, device="cpu")
    batch = make_batch(cfg, torch.Generator().manual_seed(0), 2, 24,
                       device="cpu")
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
    assert loss.shape == ()
    assert not bool(torch.isnan(loss)), f"{arch}: NaN loss"
    assert int(metrics["tokens"]) > 0
    before = opt.tree_map(torch.clone, params)
    step_fn, opt_init = make_train_step(model, TrainConfig(
        optimizer=OptimizerConfig(lr=1e-3)))
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m2 = step_fn(state, batch)
    assert not bool(torch.isnan(m2["loss"])), f"{arch}: NaN after train step"
    assert int(state["step"]) == 1
    moved = sum(float((a - b).abs().sum())
                for (_, a), (_, b) in zip(_leaves(state["params"]),
                                          _leaves(before)))
    assert moved > 0
