"""Gradients of the port's other families against the JAX package on the
CPU: the MoE (qwen3-moe-235b-a22b's and grok-1-314b's tiny presets), the
SSM (falcon-mamba-7b), the hybrid (zamba2-1.2b), the audio
(musicgen-medium) and the vlm (internvl2-1b) families, with JAX's random
init carried into the port (``repro_torch.bridge``) and one 2 x 24 batch
of the reference's ``make_batch`` on both sides. The train steps are in
``tests/test_torch_train_families_steps.py``.

Bars (``tests/test_torch_train.py``'s): the loss within 1e-5 relative of
``jax.value_and_grad(model.loss)``'s, each gradient leaf within 1e-5 of
that leaf's max|g|; remat on and off the same bits in the port, and the
inference forward the same loss bits; two interleaved microbatches the
mean of the halves' own gradients bit for bit and within 1e-5 of the
single batch's; Adafactor's update of the MoE's ndim-4 expert stacks
within 1e-6 of the leaf's max|·| of JAX's, and its per-layer form
bit-equal to the whole-stack form it replaced. About 60 s on one process
(JAX's six gradient compiles are most of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.models import build_model as jbuild
from repro.models import make_batch as jmake_batch
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import optimizers as jopt
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.models import build_model
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.optim import OptimizerConfig
from repro_torch.optim import optimizers as opt
from repro_torch.training.train_loop import (TrainConfig, compute_grads,
                                             loss_and_grads,
                                             split_microbatches)

MOE = ["qwen3-moe-235b-a22b", "grok-1-314b"]
ARCHS = MOE + ["falcon-mamba-7b", "zamba2-1.2b", "musicgen-medium",
               "internvl2-1b"]


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


def to_port_batch(batch):
    """A JAX batch as the port's: ints as int64, bf16 embeddings as the
    same bf16 values."""
    out = {}
    for k, v in batch.items():
        if v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(
                np.array(v.astype(jnp.float32))).to(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v, dtype=np.int64))
    return out


class _Tiny(dict):
    """Each arch's tiny model in both packages on JAX's init and one 2 x 24
    batch of the reference's ``make_batch``; made when a test first asks
    for the arch."""

    def __missing__(self, arch):
        cfg, jcfg = get_tiny_config(arch), jget_tiny(arch)
        jmodel = jbuild(jcfg, remat=False)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        jbatch = jmake_batch(jcfg, jax.random.PRNGKey(1), 2, 24)
        self[arch] = dict(
            cfg=cfg, model=build_model(cfg, remat=False), jmodel=jmodel,
            jparams=jparams, jbatch=jbatch, batch=to_port_batch(jbatch),
            params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu"))
        return self[arch]


@pytest.fixture(scope="module")
def tiny():
    return _Tiny()


def hold_grads(want, got, tag=""):
    """Every leaf of ``got`` within 1e-5 of the leaf's max|g| of
    ``want``; returns the worst ratio."""
    want, got = _np_tree(want), _np_tree(got)
    assert want.keys() == got.keys()
    worst = 0.0
    for k in want:
        gap = float(np.abs(got[k] - want[k]).max())
        top = float(np.abs(want[k]).max())
        assert gap <= 1e-5 * top, (tag, k, gap, top)
        worst = max(worst, gap / top if top else 0.0)
    return worst


# ---------------------------------------------------------------------------
# loss and gradient, remat, microbatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(tiny, arch):
    t = tiny[arch]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: t["jmodel"].loss(p, b)[0]))(t["jparams"], t["jbatch"])
    loss, grads = compute_grads(t["model"], TrainConfig(), t["params"],
                                t["batch"])
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    worst = hold_grads(jgrads, grads, arch)
    print(f"{arch}: loss {float(loss):.6f} (JAX {float(jloss):.6f}), "
          f"worst leaf {worst:.2e} of its max|g|")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits(tiny, arch):
    """Blocks (the Mamba-2 bodies only for the hybrid) under
    torch.utils.checkpoint, the Mamba-1 scan's chunks under it in both,
    and the logit chunks recomputed: the same loss and gradient bits as
    without block remat; the inference forward the same loss bits."""
    t = tiny[arch]
    remat = build_model(t["cfg"], remat=True)
    assert remat.remat and not t["model"].remat
    out = [compute_grads(m, TrainConfig(), t["params"], t["batch"])
           for m in (t["model"], remat)]
    assert torch.equal(out[0][0], out[1][0])
    for (k, a), (_, b) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        assert torch.equal(a, b), k
    with torch.no_grad():
        infer, _ = remat.loss(t["params"], t["batch"])
    assert torch.equal(infer, out[0][0])
    assert not any(p.requires_grad for _, p in _leaves(t["params"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_grads_match_single(tiny, arch):
    """Two interleaved microbatches (frames and patches split with the
    tokens and labels): the accumulated gradient is the mean of the two
    halves' own, bit for bit, and within 1e-5 of the single batch's; the
    loss within 1e-6 relative."""
    t = tiny[arch]
    parts = split_microbatches(t["batch"], 2)
    for i, mb in enumerate(parts):
        assert mb.keys() == t["batch"].keys()
        for k, v in mb.items():
            assert torch.equal(v, t["batch"][k][i::2]), k
    l1, g1 = compute_grads(t["model"], TrainConfig(), t["params"], t["batch"])
    l2, g2 = compute_grads(t["model"], TrainConfig(microbatches=2),
                           t["params"], t["batch"])
    halves = [compute_grads(t["model"], TrainConfig(), t["params"], mb)[1]
              for mb in parts]
    mean = opt.tree_map(lambda a, b: a / 2 + b / 2, *halves)
    for (k, a), (_, b) in zip(_leaves(mean), _leaves(g2)):
        assert torch.equal(a, b), k
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    hold_grads(g1, g2, arch)


def test_moe_remat_is_per_block(tiny, monkeypatch):
    """The MoE model inherits the dense model's remat: one
    ``torch.utils.checkpoint`` a block around the whole block (the
    reference's ``jax.checkpoint`` around its scan body), and none
    without remat or without a graph."""
    t = tiny["qwen3-moe-235b-a22b"]
    calls = []
    real = transformer_mod.checkpoint

    def counting(fn, *args, **kw):
        calls.append(getattr(fn, "__name__", ""))
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer_mod, "checkpoint", counting)
    remat = build_model(t["cfg"], remat=True)
    loss_and_grads(remat, t["params"], t["batch"])
    blocks = [c for c in calls if c == "_block_out"]
    assert len(blocks) == t["cfg"].num_layers
    calls.clear()
    loss_and_grads(t["model"], t["params"], t["batch"])
    with torch.no_grad():
        remat.loss(t["params"], t["batch"])
    assert "_block_out" not in calls


def test_mamba_scan_chunks_run_under_checkpoint(tiny, monkeypatch):
    """Under a graph each chunk of the Mamba-1 scan runs under
    ``torch.utils.checkpoint`` (the reference's ``@jax.checkpoint`` on the
    scan body): 24 tokens at chunk 8 are 3 chunks a layer; without a
    graph none does."""
    t = tiny["falcon-mamba-7b"]
    calls = []
    real = mamba_mod.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(mamba_mod, "checkpoint", counting)
    model = build_model(t["cfg"], remat=False)
    model.scan_chunk = 8
    loss_and_grads(model, t["params"], t["batch"])
    assert calls == ["_scan_chunk"] * (3 * t["cfg"].num_layers)
    calls.clear()
    with torch.no_grad():
        model.loss(t["params"], t["batch"])
    assert calls == []


def test_moe_inference_form_is_unchanged(tiny):
    """Without a graph the MoE keeps its in-place inference form: the
    logits are the same bits with and without autograd switched on when
    no param requires grad, and the graph form (the same products out of
    place) gives the same bits."""
    t = tiny["qwen3-moe-235b-a22b"]
    batch = {"tokens": t["batch"]["tokens"]}
    with torch.no_grad():
        want = t["model"].logits(t["params"], batch)
    got = t["model"].logits(t["params"], batch)
    assert not got.requires_grad and torch.equal(got, want)
    leaves = opt.tree_map(lambda p: p.detach().requires_grad_(True),
                          t["params"])
    graph = t["model"].logits(leaves, batch)
    assert graph.requires_grad and torch.equal(graph.detach(), want)


def test_ssd_gradient_is_finite_where_the_reference_overflows(tiny):
    """With every dt_bias raised by 8 a chunk's decays sum past 88, where
    the reference's where(causal, exp(seg), 0) puts inf above the
    diagonal and its gradient is NaN in every leaf (a fault of the
    reference); the port masks seg before the exp: the same loss, every
    gradient leaf finite. At the init's dt the gradient is JAX's
    (``test_loss_and_grads_match_jax[zamba2-1.2b]``)."""
    t = tiny["zamba2-1.2b"]
    jparams = dict(t["jparams"], blocks=dict(
        t["jparams"]["blocks"],
        dt_bias=t["jparams"]["blocks"]["dt_bias"] + 8.0))
    jloss, jgrads = jax.value_and_grad(
        lambda p: t["jmodel"].loss(p, t["jbatch"])[0])(jparams)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrads))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    loss, grads = compute_grads(t["model"], TrainConfig(), params,
                                t["batch"])
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k, g in _leaves(grads):
        assert torch.isfinite(g).all(), k


# ---------------------------------------------------------------------------
# the audio frontend's embed: no gradient, the optimizer's decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_unused_embed_gets_zero_gradient_and_decay(tiny, name):
    """musicgen-medium's frames stand in for tokens, so its loss never
    reads ``embed``: the gradient is zero there, as JAX's, and one step
    moves the embedding by the weight decay alone (AdamW: lr·wd·p;
    Adafactor: lr·wd·p with a zero update), held to JAX's step."""
    t = tiny["musicgen-medium"]
    _, grads = compute_grads(t["model"], TrainConfig(), t["params"],
                             t["batch"])
    assert torch.equal(grads["embed"], torch.zeros_like(grads["embed"]))
    cfg = dict(name=name, lr=1e-2, warmup_steps=1, total_steps=10,
               weight_decay=0.1)
    jinit, jupd = jopt.make_optimizer(JOptimizerConfig(**cfg))
    init, upd = opt.make_optimizer(OptimizerConfig(**cfg))
    jgrads = jax.grad(lambda p: t["jmodel"].loss(p, t["jbatch"])[0])(
        t["jparams"])
    assert not np.asarray(jgrads["embed"]).any()
    jp, _, _ = jax.jit(jupd)(jgrads, jinit(t["jparams"]), t["jparams"])
    params = opt.tree_map(torch.clone, t["params"])
    before = params["embed"].clone()
    p, _, m = upd(grads, init(params), params)
    lr = float(m["lr"])
    np.testing.assert_allclose(p["embed"].numpy(),
                               (before * (1 - lr * 0.1)).numpy(),
                               rtol=1e-6, atol=1e-9)
    want = np.asarray(jp["embed"])
    assert np.abs(p["embed"].numpy() - want).max() <= \
        1e-6 * np.abs(want).max()
    assert not torch.equal(p["embed"], before)


# ---------------------------------------------------------------------------
# Adafactor on the MoE's stacks: against JAX, and one layer at a time
# ---------------------------------------------------------------------------

def _moe_grads(t, rng, scale=0.05):
    """Random gradients of the MoE tree's shapes; layer 1 of each expert
    stack 100x the others, so a stack-wide statistic would not match the
    reference's per-layer map."""
    g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
         for k, v in _np_tree(t["params"]).items()}
    for k in g:
        if k[-1] in ("wg", "wu", "wd"):
            g[k][1] *= 100.0
    return g


def _tree_from_paths(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


@pytest.mark.parametrize("arch", MOE)
def test_adafactor_on_moe_stacks_matches_jax(tiny, arch):
    """Three Adafactor updates of the tiny MoE's params, whose expert
    stacks are ndim 4 (L, E, d, f): params and the factored statistics
    within 1e-6 of the leaf's max|·| of JAX's (its ``lax.map`` over L)."""
    t = tiny[arch]
    rng = np.random.default_rng(5)
    grads = [_tree_from_paths(_moe_grads(t, rng)) for _ in range(3)]
    assert np.asarray(t["jparams"]["blocks"]["moe"]["wu"]).ndim == 4
    cfg = dict(name="adafactor", lr=1e-2, warmup_steps=1, total_steps=10,
               weight_decay=0.1)
    jinit, jupd = jopt.make_optimizer(JOptimizerConfig(**cfg))
    init, upd = opt.make_optimizer(OptimizerConfig(**cfg))
    jp, p = t["jparams"], opt.tree_map(torch.clone, t["params"])
    js, s = jinit(jp), init(p)
    jupd = jax.jit(jupd)
    for g in grads:
        jp, js, _ = jupd(jax.tree.map(jnp.asarray, g), js, jp)
        p, s, _ = upd(params_from_numpy(g, "cpu"), s, p)
    for want, got in ((_np_tree(jp), _np_tree(p)),
                      (_np_tree(js), _np_tree(s))):
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            bar = 1e-6 * max(float(np.abs(want[k]).max()), 1e-30)
            assert np.abs(got[k] - want[k]).max() <= bar, k


def _whole_stack_adafactor(grads, state, params, cfg):
    """The update the per-layer form replaced: every stacked leaf at once,
    its reductions keeping the layer axis (the f32 temporaries are the
    whole stack's)."""
    step = state["step"] + 1
    lr = opt.lr_schedule(cfg, step)
    scale = opt.clip_scale(opt.global_norm(grads), cfg.clip_norm)
    decay = 1.0 - torch.pow(step.to(torch.float32), -0.8)

    def upd(g, v, p):
        g = g.to(torch.float32) * scale
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            vr = v["vr"].mul_(decay).add_((1 - decay) * g2.mean(dim=-1))
            vc = v["vc"].mul_(decay).add_((1 - decay) * g2.mean(dim=-2))
            denom = vr.mean(dim=-1, keepdim=True)[..., None]
            vhat = torch.mul(vr[..., None], vc[..., None, :], out=g2)
            vhat.div_(torch.clamp(denom, min=1e-30))
        else:
            vhat = v["v"].mul_(decay).add_((1 - decay) * g2)
        update = g.div_(torch.sqrt(vhat + cfg.eps))
        sq = update * update
        if p.dim() >= 3:
            rms = torch.sqrt(sq.mean(dim=tuple(range(1, sq.dim())),
                                     keepdim=True))
        else:
            rms = torch.sqrt(sq.mean())
        update.div_(torch.clamp(rms, min=1.0))
        decayed = (lr * cfg.weight_decay) * p
        p.sub_(update.mul_(lr)).sub_(decayed)
        return p

    opt.tree_map(upd, grads, state["v"], params)
    state["step"] = step
    return params, state


@pytest.mark.parametrize("arch", MOE)
def test_adafactor_per_layer_is_bit_equal_to_whole_stack(tiny, arch):
    """The per-layer update (one layer's f32 temporaries at a time) gives
    the bits of the whole-stack form on the MoE's ndim-4 and ndim-3
    stacks, its norms and its unstacked leaves, over three steps."""
    t = tiny[arch]
    rng = np.random.default_rng(6)
    grads = [_tree_from_paths(_moe_grads(t, rng)) for _ in range(3)]
    cfg = OptimizerConfig(name="adafactor", lr=1e-2, warmup_steps=1,
                          total_steps=10, weight_decay=0.1)
    init, upd = opt.make_optimizer(cfg)
    p1 = opt.tree_map(torch.clone, t["params"])
    p2 = opt.tree_map(torch.clone, t["params"])
    s1, s2 = init(p1), init(p2)
    for g in grads:
        p1, s1, _ = upd(params_from_numpy(g, "cpu"), s1, p1)
        p2, s2 = _whole_stack_adafactor(params_from_numpy(g, "cpu"), s2,
                                        p2, cfg)
    for (k, a), (_, b) in zip(_leaves({"p": p1, "v": s1["v"]}),
                              _leaves({"p": p2, "v": s2["v"]})):
        assert torch.equal(a, b), k
