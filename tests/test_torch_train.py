"""The port's training stack against the JAX package on the CPU, on the
tiny llama32-1b config (tied embeddings, GQA): the schedule, the norm and
its clip, AdamW and Adafactor on a layer-stacked tree, the gradient
compressors, loss and gradients of one batch, single and microbatched train
steps, resume, and train-state checkpoints across the two packages.

The JAX model's init is carried into the port with ``repro_torch.bridge``
and the batches are the same numpy arrays. Bars:
- the schedule: within 2 f32 ulps (XLA's and PyTorch's cosines); the norm
  and clip within 1e-6 relative (sums in another order);
- one optimizer update on the same numpy inputs: within 1e-6 of the
  leaf's max|·| (AdamW elementwise; Adafactor's per-layer means in another
  order);
- int8 compression bit-equal; top-k with ties: the same kept indices;
- loss within 1e-5 relative, each leaf's gradient within 1e-5 of its
  max|g|; remat on and off the same bits in the port;
- after train steps the parameters agree within 1e-5 except where a
  near-zero gradient's sign differs between the frameworks: AdamW's first
  steps move such an entry by up to ±lr a step the other way, so those
  entries are counted (at most 1 in 1,000) and bounded by 2·lr a step.

JAX compiles its train steps once per module (module-scoped jitted
fixtures). Torch runs on one intra-op thread, as the port's other CPU
test files do under the suite's workers.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import grad_compress as jgc
from repro.optim import optimizers as jopt
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_tiny_config
from repro_torch.data import DataConfig, ZipfMarkov
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.optim import grad_compress as gc
from repro_torch.optim import optimizers as opt
from repro_torch.optim import OptimizerConfig
from repro_torch.training.train_loop import (TrainConfig, compute_grads,
                                             make_train_step,
                                             split_microbatches)

ARCH = "llama32-1b"
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
    """A JAX or torch tree as {path: numpy array}."""
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in _leaves(tree)}


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jmodel = jbuild(jget_tiny(ARCH), remat=False)
    model = build_model(get_tiny_config(ARCH), remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    gen = ZipfMarkov(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=64,
                                global_batch=16))
    return jmodel, model, jparams, gen


@pytest.fixture(scope="module")
def jsteps(tiny):
    """The JAX train step, jitted once a form: single batch and n = 2."""
    jmodel = tiny[0]
    out = {}
    for n in (1, 2):
        fn, _ = jmake_train_step(jmodel, JTrainConfig(
            optimizer=JOptimizerConfig(**OPT), microbatches=n))
        out[n] = jax.jit(fn)
    return out


def _jstate(jparams):
    init, _ = jopt.make_optimizer(JOptimizerConfig(**OPT))
    return {"params": jparams, "opt": init(jparams),
            "step": jnp.zeros((), jnp.int32)}


def _batches(gen, start, n):
    return [gen.batch(i) for i in range(start, start + n)]


def _run_jax(jstep, state, batches):
    for t, l in batches:
        state, m = jstep(state, {"tokens": jnp.asarray(t),
                                 "labels": jnp.asarray(l)})
    return state, m


def _run_port(step, state, batches):
    for t, l in batches:
        state, m = step(state, {"tokens": torch.from_numpy(t),
                                "labels": torch.from_numpy(l)})
    return state, m


def _hold_params(want, got, steps):
    """Parameters after ``steps`` steps: within 1e-5, except entries whose
    near-zero gradient changed sign (at most 1 in 1,000, each within
    2·lr a step)."""
    flips, total = 0, 0
    for k, a in want.items():
        d = np.abs(a - got[k])
        flips += int((d > 1e-5).sum())
        total += d.size
        assert d.max() <= 2 * LR * steps + 1e-5, (k, d.max())
    assert flips <= total // 1000, (flips, total)
    return flips


# ---------------------------------------------------------------------------
# schedule, norm, clip
# ---------------------------------------------------------------------------

def test_lr_schedule_within_two_ulps():
    for cfg in (OPT, dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
                dict(lr=1e-3, warmup_steps=1, total_steps=1)):
        steps = np.array([0, 1, 2, 5, 19, 20, 21, 99, 100, 101, 199, 200,
                          201, 5000, 9999, 10_000, 20_000], np.int32)
        want = np.asarray(jax.vmap(lambda s: jopt.lr_schedule(
            JOptimizerConfig(**cfg), s))(jnp.asarray(steps)))
        got = opt.lr_schedule(OptimizerConfig(**cfg),
                              torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(want, got, maxulp=2)


def _stacked_tree(rng, scale=1.0):
    """A layer-stacked tree: a (L, d) norm stack, an ndim-3 weight stack,
    a plain matrix and a vector."""
    f = np.float32
    return {"blocks": {"norm": (rng.standard_normal((3, 16)) * scale).astype(f),
                       "w": (rng.standard_normal((3, 8, 12)) * scale).astype(f)},
            "head": (rng.standard_normal((12, 20)) * scale).astype(f),
            "final_norm": (rng.standard_normal(16) * scale).astype(f)}


def test_global_norm_and_clip():
    rng = np.random.default_rng(1)
    tree = _stacked_tree(rng, 3.0)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_numpy(tree, device="cpu")
    jn = float(jopt.global_norm(jtree))
    n = float(opt.global_norm(ttree))
    assert abs(jn - n) <= 1e-6 * jn
    for max_norm in (1.0, 1e3):                  # clipping, and none
        jc, _ = jopt.clip_by_global_norm(jtree, max_norm)
        tc, _ = opt.clip_by_global_norm(ttree, max_norm)
        want, got = _np_tree(jc), _np_tree(tc)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# AdamW and Adafactor on a layer-stacked tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match(name):
    """Three updates from the same numpy params and gradients. One layer
    of the ndim-3 stack gets gradients 100× the others, so its Adafactor
    statistics and relative-step RMS differ from its neighbours' — a
    stack-wide reduction would not match the reference's per-layer map."""
    rng = np.random.default_rng(2)
    params = _stacked_tree(rng)
    grads = [_stacked_tree(rng, 0.05) for _ in range(3)]
    for g in grads:
        g["blocks"]["w"][1] *= 100.0
    cfg = dict(name=name, lr=1e-2, warmup_steps=1, total_steps=10,
               weight_decay=0.1)
    jinit, jupd = jopt.make_optimizer(JOptimizerConfig(**cfg))
    init, upd = opt.make_optimizer(OptimizerConfig(**cfg))
    jp, p = jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")
    js, s = jinit(jp), init(p)
    jupd = jax.jit(jupd)
    for g in grads:
        jp, js, jm = jupd(jax.tree.map(jnp.asarray, g), js, jp)
        p, s, m = upd(params_from_numpy(g, "cpu"), s, p)
    for want, got in ((_np_tree(jp), _np_tree(p)), (_np_tree(js), _np_tree(s))):
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == \
                want[k].shape, k
            bar = 1e-6 * max(float(np.abs(want[k]).max()), 1e-30)
            assert np.abs(got[k] - want[k]).max() <= bar, k
    assert int(s["step"]) == int(js["step"]) == 3
    for k in ("lr", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))


def test_optimizer_state_key_paths_match_jax(tiny):
    """AdamW's m and v and Adafactor's vr, vc and v sit under the
    reference's key paths, with its shapes and dtypes."""
    _, model, jparams, _ = tiny
    params = _to_torch(jparams)
    for name in ("adamw", "adafactor"):
        jinit, _ = jopt.make_optimizer(JOptimizerConfig(name=name))
        init, _ = opt.make_optimizer(OptimizerConfig(name=name))
        want, got = _np_tree(jinit(jparams)), _np_tree(init(params))
        assert want.keys() == got.keys()
        for k in want:
            assert (want[k].shape, want[k].dtype) == \
                (got[k].shape, got[k].dtype), k


# ---------------------------------------------------------------------------
# gradient compressors
# ---------------------------------------------------------------------------

def test_int8_compress_bit_equal():
    rng = np.random.default_rng(3)
    for g in (rng.standard_normal((64, 33)).astype(np.float32),
              (rng.standard_normal(1000) * 1e-3).astype(np.float32),
              np.zeros((4, 4), np.float32),
              np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0], np.float32)):
        jq, js = jgc.int8_compress(jnp.asarray(g))
        q, s = gc.int8_compress(torch.from_numpy(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            gc.int8_decompress(q, s).numpy(),
            np.asarray(jgc.int8_decompress(jq, js)))


@pytest.mark.parametrize("k", [1, 5, 17, 64])
def test_topk_error_feedback_ties(k):
    """Rows of repeated magnitudes (±) tie everywhere: the kept indices are
    ``jax.lax.top_k``'s (lower index first), and the residual carries the
    rest."""
    rng = np.random.default_rng(4)
    g = (rng.integers(-3, 4, (8, 8)) * 0.5).astype(np.float32)
    err = (rng.integers(-2, 3, (8, 8)) * 0.25).astype(np.float32)
    js, je = jgc.topk_error_feedback(jnp.asarray(g), jnp.asarray(err), k)
    s, e = gc.topk_error_feedback(torch.from_numpy(g), torch.from_numpy(err),
                                  k)
    np.testing.assert_array_equal(s.numpy() != 0, np.asarray(js) != 0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


# ---------------------------------------------------------------------------
# loss and gradients, remat
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_jax(tiny):
    jmodel, model, jparams, gen = tiny
    t, l = gen.batch(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)[0]))(
        jparams, {"tokens": jnp.asarray(t), "labels": jnp.asarray(l)})
    loss, grads = compute_grads(model, TrainConfig(), _to_torch(jparams),
                                {"tokens": torch.from_numpy(t),
                                 "labels": torch.from_numpy(l)})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want, got = _np_tree(jgrads), _np_tree(grads)
    assert want.keys() == got.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            1e-5 * np.abs(want[k]).max(), k


def test_remat_gives_the_same_bits(tiny):
    """Blocks under torch.utils.checkpoint and recomputed logit chunks:
    the same loss and gradient bits as without recompute; and the
    inference forward (params without grad) the same loss bits."""
    _, model, jparams, gen = tiny
    params = _to_torch(jparams)
    t, l = gen.batch(1)
    batch = {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(l)}
    remat = build_model(model.cfg, remat=True)
    assert remat.remat and not model.remat
    out = [compute_grads(m, TrainConfig(), params, batch)
           for m in (model, remat)]
    assert torch.equal(out[0][0], out[1][0])
    for (k, a), (_, b) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        assert torch.equal(a, b), k
    with torch.no_grad():
        infer, _ = remat.loss(params, batch)
    assert torch.equal(infer, out[0][0])
    assert not any(p.requires_grad for _, p in _leaves(params))


def test_split_microbatches_is_interleaved():
    x = torch.arange(12).reshape(6, 2)
    parts = split_microbatches({"tokens": x}, 3)
    for i, mb in enumerate(parts):
        assert torch.equal(mb["tokens"], x[i::3])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2], ids=["single", "microbatched"])
def test_one_step_matches_jax(tiny, jsteps, n):
    """One step, single-batch and with 2 interleaved microbatches: the
    loss, lr and grad_norm, the step counter, and params, m and v."""
    _, model, jparams, gen = tiny
    step, opt_init = make_train_step(model, TrainConfig(
        optimizer=OptimizerConfig(**OPT), microbatches=n))
    params = _to_torch(jparams)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batches = _batches(gen, 0, 1)
    jstate, jm = _run_jax(jsteps[n], _jstate(jparams), batches)
    state, m = _run_port(step, state, batches)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert int(state["step"]) == int(jstate["step"]) == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    np.testing.assert_array_max_ulp(np.asarray(jm["lr"]), m["lr"].numpy(),
                                    maxulp=2)
    _hold_params(_np_tree(jstate["params"]), _np_tree(state["params"]), 1)
    for part in ("m", "v"):
        want, got = _np_tree(jstate["opt"][part]), _np_tree(state["opt"][part])
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= \
                1e-5 * np.abs(want[k]).max() + 1e-12, (part, k)


def test_microbatched_grads_match_single(tiny):
    """The same batch as one and as two interleaved microbatches: the loss
    within 1e-6 relative, each leaf's gradient within 1e-5 of its max|g|
    (sums in another order)."""
    _, model, jparams, gen = tiny
    params = _to_torch(jparams)
    t, l = gen.batch(2)
    batch = {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(l)}
    l1, g1 = compute_grads(model, TrainConfig(), params, batch)
    l2, g2 = compute_grads(model, TrainConfig(microbatches=2), params, batch)
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    for (k, a), (_, b) in zip(_leaves(g1), _leaves(g2)):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max(), k


def test_five_steps_match_jax(tiny, jsteps):
    _, model, jparams, gen = tiny
    step, opt_init = make_train_step(model, TrainConfig(
        optimizer=OptimizerConfig(**OPT)))
    params = _to_torch(jparams)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batches = _batches(gen, 0, 5)
    jstate, jm = _run_jax(jsteps[1], _jstate(jparams), batches)
    state, m = _run_port(step, state, batches)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * float(jm["loss"])
    _hold_params(_np_tree(jstate["params"]), _np_tree(state["params"]), 5)


def test_resume_bitwise(tiny, tmp_path):
    """Kill and restore: 4 steps, save, restore in a fresh manager, 4 more
    steps — the same bits as 8 uninterrupted steps (params, m, v, step)."""
    _, model, jparams, gen = tiny
    step, opt_init = make_train_step(model, TrainConfig(
        optimizer=OptimizerConfig(**OPT)))

    def fresh():
        p = _to_torch(jparams)
        return {"params": p, "opt": opt_init(p),
                "step": torch.zeros((), dtype=torch.int32)}

    ref, _ = _run_port(step, fresh(), _batches(gen, 0, 8))
    half, _ = _run_port(step, fresh(), _batches(gen, 0, 4))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(4, half)
    mgr.wait()
    restored, at = CheckpointManager(str(tmp_path)).restore_latest(fresh())
    assert at == 4 and int(restored["step"]) == 4
    resumed, _ = _run_port(step, restored, _batches(gen, 4, 4))
    for (k, a), (_, b) in zip(_leaves(ref), _leaves(resumed)):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# train-state checkpoints across the packages, and the CLI
# ---------------------------------------------------------------------------

def test_jax_checkpoint_continues_in_the_port(tiny, jsteps, tmp_path):
    """The JAX trainer's state after 3 steps, saved by the JAX
    CheckpointManager, restores into the port's train state (the same key
    paths, bit for bit) and 2 more port steps match 2 more JAX steps."""
    _, model, jparams, gen = tiny
    jstate, _ = _run_jax(jsteps[1], _jstate(jparams), _batches(gen, 0, 3))
    JCheckpointManager(str(tmp_path)).save(3, jstate)
    step, opt_init = make_train_step(model, TrainConfig(
        optimizer=OptimizerConfig(**OPT)))
    p = _to_torch(jparams)
    target = {"params": p, "opt": opt_init(p),
              "step": torch.zeros((), dtype=torch.int32)}
    state, at = CheckpointManager(str(tmp_path)).restore_latest(target)
    assert at == 3
    want, got = _np_tree(jstate), _np_tree(state)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jstate, _ = _run_jax(jsteps[1], jstate, _batches(gen, 3, 2))
    state, _ = _run_port(step, state, _batches(gen, 3, 2))
    assert int(state["step"]) == 5
    _hold_params(_np_tree(jstate["params"]), _np_tree(state["params"]), 2)


def test_port_checkpoint_continues_in_jax(tiny, jsteps, tmp_path):
    """The reverse: the port's state after 3 steps, saved by its
    CheckpointManager, restores bit for bit into the JAX train state."""
    _, model, jparams, gen = tiny
    step, opt_init = make_train_step(model, TrainConfig(
        optimizer=OptimizerConfig(**OPT)))
    p = _to_torch(jparams)
    state, _ = _run_port(step, {"params": p, "opt": opt_init(p),
                                "step": torch.zeros((), dtype=torch.int32)},
                         _batches(gen, 0, 3))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(3, state)
    mgr.wait()
    jstate, at = JCheckpointManager(str(tmp_path)).restore_latest(
        _jstate(jparams))
    assert at == 3
    want, got = _np_tree(state), _np_tree(jstate)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jstate, jm = _run_jax(jsteps[1], jstate, _batches(gen, 3, 1))
    assert int(jstate["step"]) == 4 and np.isfinite(float(jm["loss"]))


def test_train_cli_resumes_and_beats(tmp_path, capsys):
    """The port's CLI on the CPU: 6 steps with a checkpoint every 3 and a
    heartbeat file; run again to 9 steps, it resumes from step 6, writes
    the step-9 checkpoint and keeps the newest three."""
    ck, hb = str(tmp_path / "ck"), str(tmp_path / "hb")
    args = ["--tiny", "--arch", ARCH, "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt-every", "3", "--heartbeat", hb]
    train_cli.main(args + ["--steps", "6", "--ckpt-dir", ck])
    assert open(hb).read() == "5"
    first = capsys.readouterr().out
    assert "resumed" not in first and "[train] done: final loss" in first
    resumed, _ = train_cli.main(args + ["--steps", "9", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "[train] resumed from step 6" in out
    assert re.search(r"step 8: loss=\d", out) and open(hb).read() == "8"
    assert int(resumed["step"]) == 9
    assert sorted(os.listdir(ck)) == ["step_00000003", "step_00000006",
                                      "step_00000009"]


def test_train_cli_refuses_a_mesh():
    """A mesh the launch cannot hold is refused before any process group
    is joined: the reference's 16 x 16 needs 256 ranks, this launch is one
    process (meshes that fit run under torchrun:
    tests/test_torch_train_mesh.py)."""
    with pytest.raises(ValueError, match=r"\(16, 16\) needs 256 ranks; "
                                         r"the launch has 1"):
        train_cli.main(["--tiny", "--device", "cpu", "--mesh", "single",
                        "--steps", "1"])


def test_train_cli_adafactor_and_microbatches(tmp_path, capsys):
    """The CLI's other optimizer and accumulation flags run and learn."""
    state, m = train_cli.main(
        ["--tiny", "--arch", ARCH, "--device", "cpu", "--batch", "4",
         "--seq", "16", "--steps", "3", "--optimizer", "adafactor",
         "--microbatches", "2", "--ckpt-dir", str(tmp_path)])
    assert set(state["opt"]) == {"v", "step"} and int(state["step"]) == 3
    assert np.isfinite(float(m["loss"]))
    assert dataclasses.is_dataclass(train_cli.train_config(
        type("A", (), dict(optimizer="adamw", lr=1e-3, steps=10,
                           microbatches=1))()))


def test_train_clis_continue_each_other(tmp_path, capsys, monkeypatch):
    """The JAX CLI trains 2 steps and checkpoints; the port's CLI resumes
    from step 2 and trains to 4; the JAX CLI resumes the port's step-4
    state and trains to 5 (tiny llama2-7b, the CLIs' defaults)."""
    from repro.launch import train as jtrain_cli
    ck = str(tmp_path)
    common = ["--tiny", "--batch", "4", "--seq", "16", "--ckpt-every", "1",
              "--ckpt-dir", ck]

    def jax_cli(steps):
        monkeypatch.setattr("sys.argv", ["train"] + common
                            + ["--steps", str(steps)])
        jtrain_cli.main()
        return capsys.readouterr().out

    assert "resumed" not in jax_cli(2)
    state, _ = train_cli.main(common + ["--steps", "4", "--device", "cpu"])
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert int(state["step"]) == 4
    out = jax_cli(5)
    assert "[train] resumed from step 4" in out and "step 4: loss=" in out
