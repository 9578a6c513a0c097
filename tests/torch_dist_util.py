"""Multi-rank harness for the port's tests: four gloo ranks on the CPU.

``run_ranks(cases, inputs)`` writes ``inputs`` (a flat dict of numpy
arrays) to a temporary directory and starts this file in a subprocess,
which spawns ``world`` processes joined by a ``FileStore`` rendezvous (no
network), each on one torch thread. Every rank runs each named case of
``CASES`` in order on the same inputs and returns a dict of tensors,
arrays and plain values (nested dicts allowed; tensors come back whole as
numpy); the caller gets one dict of the cases' results per rank. The
subprocess imports neither JAX nor the JAX package (this module imports
only torch and the port), so the ranks start in seconds. Param trees
travel as flat dicts with "/"-joined keys (:func:`flatten`,
:func:`unflatten`).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def flatten(tree, prefix="") -> dict:
    """Nested dicts → {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: dict, prefix: str = "") -> dict:
    """The nested dicts under ``prefix`` of a flat dict."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def run_ranks(cases, inputs: dict, world: int = 4, timeout: int = 600):
    """Per-rank result dicts of ``cases`` (names in ``CASES``) on four
    gloo ranks."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(inputs), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        r = subprocess.run([sys.executable, os.path.abspath(__file__), d,
                            str(world), *cases], env=env, timeout=timeout,
                           capture_output=True, text=True)
        assert r.returncode == 0, f"ranks failed:\n{r.stdout}\n{r.stderr}"
        out = []
        for rank in range(world):
            with open(os.path.join(d, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _host(x):
    import torch
    from repro_torch.sharding import full_tensor
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return full_tensor(x).detach().cpu().numpy()
    if type(x).__name__ == "P":
        return tuple(x)
    return x


# ---------------------------------------------------------------------------
# cases: fn(inp) -> dict of numpy / nested dicts; every rank runs each
# ---------------------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _pl(placements) -> list:
    """Placements as "Shard(d)" / "Replicate" (their repr varies by torch
    version)."""
    return [f"Shard({p.dim})" if hasattr(p, "dim") else type(p).__name__
            for p in placements]


def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, device="cpu")


@case
def sharding_specs(inp):
    """ShardingRules.spec at (2, 2), hint, the mesh checks, and the
    QTensor / granite-8b param trees' specs and placements."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import get_tiny_config
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.quant import QTensor
    from repro_torch.sharding import (ShardingRules, adapt_logical_axes,
                                      distribute_tree, hint, tree_shardings,
                                      tree_specs)
    mesh = _mesh((2, 2), ("data", "model"))
    r = ShardingRules.for_mesh(mesh)
    out = {"spec37": r.spec((None, "tp"), (8, 37)),
           "spec36": r.spec((None, "tp"), (8, 36)),
           "dup": r.spec(("batch", "fsdp"), (8, 8)),
           "rows": r.spec(("rows", None), (16, 5))}
    errs = []
    for fn in (lambda: make_production_mesh(device="cpu"),
               lambda: make_mesh((2, 4), ("data", "model"), device="cpu")):
        try:
            fn()
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    x = torch.arange(32.0).reshape(4, 8)
    out["hint_plain_same"] = hint(x, r, ("batch", "tp")) is x
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    hx = hint(dx, r, ("batch", "tp"))
    out["hint_placements"] = _pl(hx.placements)
    out["hint_local"] = hx.to_local().numpy()
    # QTensor leaves (tests/test_distribution.py's packed-leaf case)
    w = torch.from_numpy(inp["qt_w"])
    qt = QTensor.from_dense(w, bits=4, group_size=32,
                            col_scale=torch.ones((64,)))
    stacked = qt.map(lambda a: torch.stack([a] * 3))
    params = {"blocks": {"attn": {"wq": stacked, "norm": torch.ones((3, 8))}}}
    axes = {"blocks": {"attn": {"wq": (None, "fsdp", "tp"),
                                "norm": (None, None)}}}
    adapted = adapt_logical_axes(axes, params)
    specs = tree_specs(r, adapted, params)
    wq = specs["blocks"]["attn"]["wq"]
    out["qt"] = {"packed": wq.packed, "scale": wq.scale, "zero": wq.zero,
                 "col_scale": wq.col_scale,
                 "norm": specs["blocks"]["attn"]["norm"],
                 "axes_packed": adapted["blocks"]["attn"]["wq"].packed}
    placed = distribute_tree(params, tree_shardings(r, adapted, params))
    out["qt_placed"] = _pl(placed["blocks"]["attn"]["wq"].packed.placements)
    # a whole model's param tree (tiny granite-8b)
    model = build_model(get_tiny_config("granite-8b"), r)
    gp = model.init(0, device="cpu")
    out["granite"] = flat_specs(tree_specs(r, model.param_logical_axes(),
                                           gp))
    return out


def flat_specs(tree) -> dict:
    """{"a/b": spec as a plain tuple} of a tree of specs."""
    return {k: tuple(v) for k, v in flatten(tree).items()}


@case
def awp_distributed(inp):
    """Row- and column-sharded AWP and calib_c at (2, 2), (4, 1), (1, 4)
    and (4,); cross_replica and int8_psum at (4,)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import calibration as calib
    from repro_torch.core import distributed as D
    from repro_torch.optim.grad_compress import int8_psum
    from repro_torch.sharding import (NamedSharding, P, ShardingRules,
                                      axes_group, distribute, mesh_coord)
    w, c = torch.from_numpy(inp["w"]), torch.from_numpy(inp["c"])
    w6 = torch.from_numpy(inp["w6"])
    k, eta, iters = int(inp["k"]), float(inp["eta"]), int(inp["iters"])
    out = {"ref": D.awp_prune_rowsharded_fn(k, eta, iters)(w, c)}
    # the compression path's own unsharded loop (tol 0: every iteration)
    from repro_torch.core import awp
    from repro_torch.kernels import impl
    out["pgd"] = awp.pgd(w, c, awp.prune_projection(k),
                         impl("topk_row")(w, k),
                         awp.PGDConfig(max_iters=iters, tol=0.0)).theta
    for name, shape, axes in (("22", (2, 2), ("data", "model")),
                              ("41", (4, 1), ("data", "model")),
                              ("14", (1, 4), ("data", "model"))):
        rules = ShardingRules.for_mesh(_mesh(shape, axes))
        out[f"row{name}"] = D.awp_prune_rowsharded(w, c, k, eta, iters, rules)
        out[f"col{name}"] = D.awp_prune_colsharded_fn(k, eta, iters,
                                                      rules)(w, c)
        out[f"row6_{name}"] = D.awp_prune_rowsharded(w6, c, k, eta, iters,
                                                     rules)
        out[f"rowaxes6_{name}"] = list(D.rowsharded_axes(rules, 6))
        out.update(_awp_dtensor(name, w, c, k, eta, iters, rules))
    acts = torch.from_numpy(inp["acts"])
    rules4 = ShardingRules.for_mesh(_mesh((4,), ("data",)))
    out["calib4"] = D.calib_c_distributed(acts, rules4)
    rules22 = ShardingRules.for_mesh(_mesh((2, 2), ("data", "model")))
    out["calib22"] = D.calib_c_distributed(acts, rules22)
    with _counting_gathers() as gathered:
        out["dt_calib22"] = D.calib_c_distributed(
            distribute(acts, NamedSharding(rules22.mesh, P("data", None))),
            rules22)
    out["dt_calib22_gathered"] = len(gathered)
    mesh4 = rules4.mesh
    i = mesh_coord(mesh4, ("data",))
    mine = acts[i * 16:(i + 1) * 16]
    st = calib.update(calib.init(acts.shape[-1], device="cpu"), mine)
    out["stats"] = calib.cross_replica(st, mesh4, "data")._asdict()
    g = torch.from_numpy(inp["g"])[i * 8:(i + 1) * 8]
    out["int8_psum"] = int8_psum(g, axes_group(mesh4, ("data",)))
    out["int8_psum_default"] = int8_psum(g)
    out["world"] = dist.get_world_size()
    return out


class _counting_gathers:
    """Records the shape of every ``DTensor.full_tensor`` call inside."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        self.full, self.shapes = DTensor.full_tensor, []
        full, shapes = self.full, self.shapes

        def counting(t, *a, **kw):
            shapes.append(tuple(t.shape))
            return full(t, *a, **kw)
        DTensor.full_tensor = counting
        return self.shapes

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        DTensor.full_tensor = self.full


def _awp_dtensor(name, w, c, k, eta, iters, rules):
    """Both schedules on DTensor inputs already laid out as they read
    them (row: W's rows over the row axes, C replicated; col: W over
    (batch, "model"), C's rows over "model"): the results, and the whole
    tensors gathered on the way in (none may be W or C)."""
    from repro_torch.core import distributed as D
    from repro_torch.sharding import NamedSharding, P, distribute
    mesh, tp, dp = rules.mesh, rules.tp_axis, tuple(rules.batch_axes)
    axes = D.rowsharded_axes(rules, w.shape[0])
    out = {}
    for sched, w_spec, c_spec in (("row", P(axes, None), P(None, None)),
                                  ("col", P(dp, tp), P(tp, None))):
        wd = distribute(w, NamedSharding(mesh, w_spec))
        cd = distribute(c, NamedSharding(mesh, c_spec))
        with _counting_gathers() as gathered:
            if sched == "row":
                out[f"dt_row{name}"] = D.awp_prune_rowsharded(
                    wd, cd, k, eta, iters, rules)
            else:
                out[f"dt_col{name}"] = D.awp_prune_colsharded_fn(
                    k, eta, iters, rules)(wd, cd)
        out[f"dt_{sched}{name}_gathered"] = [
            s for s in gathered if s in (tuple(w.shape), tuple(c.shape))]
    return out


@case
def elastic_restore(inp):
    """A (2, 2)-sharded tree saved whole and restored onto (4,); a JAX
    checkpoint restored onto (4,) too."""
    from torch.distributed.tensor import distribute_tensor, Shard
    import torch
    from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.sharding import NamedSharding, P
    w = torch.from_numpy(inp["tree_w"])
    mesh1 = _mesh((2, 2), ("data", "model"))
    t1 = {"w": distribute_tensor(w, mesh1, [Shard(0), Shard(1)])}
    path = save_checkpoint(str(inp["dir"]), 1, t1)
    mesh2 = _mesh((4,), ("data",))
    sh2 = {"w": NamedSharding(mesh2, P("data", None))}
    t2 = restore_checkpoint(path, {"w": torch.zeros_like(w)}, sh2)
    mgr = CheckpointManager(str(inp["dir"]))
    t3, step = mgr.restore_latest({"w": torch.zeros_like(w)}, sh2)
    tj = restore_checkpoint(str(inp["jax_path"]),
                            {"w": torch.zeros_like(w)}, sh2)
    return {"w": t2["w"], "local": t2["w"].to_local(),
            "placements": _pl(t2["w"].placements),
            "mgr": t3["w"], "step": step, "jax": tj["w"],
            "jax_local": tj["w"].to_local()}


def _params(inp, prefix):
    from repro_torch.bridge import params_from_numpy
    return params_from_numpy(unflatten(inp, prefix), device="cpu")


@case
def train_steps(inp):
    """granite-8b (tiny): the DDP step with int8 and plain gradient sync
    at (4,), and the DTensor-sharded step at (2, 2), from JAX's init."""
    import torch
    from repro_torch.configs import get_tiny_config
    from repro_torch.data import DataConfig, ZipfMarkov
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.sharding import NamedSharding, P, ShardingRules, distribute
    from repro_torch.training.train_loop import (
        TrainConfig, make_train_step, make_train_step_ddp, shard_train_state,
        sharded_step)
    cfg = get_tiny_config("granite-8b")
    model = build_model(cfg, remat=False)
    out = {}
    rules4 = ShardingRules.for_mesh(_mesh((4,), ("data",)))
    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=16))
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=2e-3, warmup_steps=5,
                                                 total_steps=100))
    for compress, steps in (("int8", int(inp["ddp_steps"])), (None, 3)):
        step_fn, opt_init = make_train_step_ddp(model, tcfg, rules4,
                                                compress=compress)
        params = _params(inp, "params0/")
        state = {"params": params, "opt": opt_init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        losses = []
        for i in range(steps):
            t, lab = gen.batch(i)
            state, m = step_fn(state, {"tokens": torch.from_numpy(t),
                                       "labels": torch.from_numpy(lab)})
            losses.append(float(m["loss"]))
            if i == 0:
                out[f"ddp_{compress}_params1"] = {
                    k: v.clone() for k, v in flatten(state["params"]).items()}
        out[f"ddp_{compress}_losses"] = np.array(losses)
    # the batch over two mesh dims ("pod", "data"): the same ranks in the
    # same order as (4,), so the same int8 sync
    rules_pd = ShardingRules.for_mesh(_mesh((2, 2), ("pod", "data")))
    step_fn, opt_init = make_train_step_ddp(model, tcfg, rules_pd,
                                            compress="int8")
    params = _params(inp, "params0/")
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for i in range(3):
        t, lab = gen.batch(i)
        state, m = step_fn(state, {"tokens": torch.from_numpy(t),
                                   "labels": torch.from_numpy(lab)})
        losses.append(float(m["loss"]))
    out["ddp_pod_data_losses"] = np.array(losses)
    # the sharded (DTensor) step at (2, 2) and the plain step
    rules = ShardingRules.for_mesh(_mesh((2, 2), ("data", "model")))
    m_sh = build_model(cfg, rules, remat=False)
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
    step_s, opt_init = make_train_step(m_sh, tcfg)
    params = _params(inp, "params0/")
    state = shard_train_state({"params": params, "opt": opt_init(params),
                               "step": torch.zeros((), dtype=torch.int32)},
                              m_sh, rules)
    batch = {k: distribute(torch.from_numpy(inp[f"batch/{k}"]),
                           NamedSharding(rules.mesh, P("data", None)))
             for k in ("tokens", "labels")}
    state, m = sharded_step(step_s)(state, batch)
    out["sharded_loss"] = m["loss"]
    out["sharded_params"] = flatten(state["params"])
    out["sharded_wq_placements"] = _pl(
        state["params"]["blocks"]["attn"]["wq"].placements)
    return out


@case
def moe_a2a(inp):
    """The all-to-all MoE FFN on tiny qwen3-moe (capacity factor 8): dense
    and packed experts at (2, 2), two experts on four model ranks (r = 2
    slots) at (1, 4), the auto path, and the gradient against the masked
    dense path's."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import moe
    from repro_torch.sharding import ShardingRules
    cfg = dataclasses.replace(get_tiny_config("qwen3-moe-235b-a22b"),
                              capacity_factor=8.0)
    x = torch.from_numpy(inp["x"])
    p = _params(inp, "p/")
    pq = dict(p, **{k: _qt(inp, f"pq/{k}/") for k in ("wu", "wd", "wg")})
    rules = ShardingRules.for_mesh(_mesh((2, 2), ("data", "model")))
    out = {"dense": moe.moe_apply_dense(p, x, cfg),
           "a2a": moe.moe_apply_a2a(p, x, cfg, rules),
           "auto": moe.moe_apply(p, x, cfg, rules),
           "packed_dense": moe.moe_apply_dense(pq, x, cfg),
           "packed_a2a": moe.moe_apply_a2a(pq, x, cfg, rules),
           "packed_auto": moe.moe_apply(pq, x, cfg, rules),
           "dropped": moe.a2a_dropped(p, x, cfg, rules)}
    # gradient: a2a (summed over ranks) against the masked dense path
    g_out = torch.from_numpy(inp["g_out"])
    grads = {}
    for name, fn in (("dense", lambda q, xx: moe.moe_apply_dense(q, xx, cfg)),
                     ("a2a", lambda q, xx: moe.moe_apply_a2a(q, xx, cfg,
                                                             rules))):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        (fn(leaves, xx) * g_out).sum().backward()
        gs = {k: v.grad for k, v in leaves.items()}
        gs["x"] = xx.grad
        if name == "a2a":
            for g in gs.values():
                dist.all_reduce(g)
        grads[name] = gs
    out["grads"] = grads
    # r = 2: two experts on four model ranks
    cfg2 = dataclasses.replace(cfg, num_experts=2)
    rules14 = ShardingRules.for_mesh(_mesh((1, 4), ("data", "model")))
    p2 = _params(inp, "p2/")
    out["r2_dense"] = moe.moe_apply_dense(p2, x, cfg2)
    out["r2_a2a"] = moe.moe_apply_a2a(p2, x, cfg2, rules14)
    out["r2_auto"] = moe.moe_apply(p2, x, cfg2, rules14)
    out["r2_slot"] = moe._slot_factor(cfg2, 4)
    out.update(_a2a_dtensor(p, x, g_out, cfg, rules, p2, cfg2, rules14))
    return out


def _a2a_dtensor(p, x, g_out, cfg, rules, p2, cfg2, rules14):
    """a2a on DTensor experts placed as the sharded train state places
    them (x batch-sharded): the output and every leaf's gradient against
    the masked dense path, and the expert stacks gathered whole (only
    where r > 1) with each rank's local share at r = 1."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.sharding import (NamedSharding, P, distribute,
                                      distribute_tree, full_tensor,
                                      tree_shardings)

    def layer_axes(c):
        return {k: v[1:] for k, v in moe.moe_logical_axes(c).items()}
    # tiny qwen3-moe's 8 experts put "model" on d_ff; >= 16 experts (the
    # full config's 128) put it on the experts
    ep_axes = layer_axes(dataclasses.replace(cfg, num_experts=16))
    cases = (("dt", p, cfg, rules, layer_axes(cfg)),
             ("dt_ep", p, cfg, rules, ep_axes),
             ("dt_r2", p2, cfg2, rules14, layer_axes(cfg2)))
    out = {}
    for name, pp, c, rl, axes in cases:
        rep = NamedSharding(rl.mesh, P())
        leaves = distribute_tree({k: v.detach().clone()
                                  for k, v in pp.items()},
                                 tree_shardings(rl, axes, pp))
        for v in leaves.values():
            v.requires_grad_(True)
        xx = distribute(x.clone(), NamedSharding(rl.mesh,
                                                 P("data", None, None)))
        xx.requires_grad_(True)
        with _counting_gathers() as gathered:
            y = moe.moe_apply_a2a(leaves, xx, c, rl)
        out[f"{name}_gathered"] = sum(len(g) == 3 and g[0] == c.num_experts
                                      for g in gathered)
        slots = moe._slot_weights(
            leaves, c, moe._slot_factor(c, rl.axis_size(rl.tp_axis)), rl)
        out[f"{name}_local_experts"] = int(
            moe._local_slots(slots[1], rl).shape[0])
        (y * distribute(g_out, rep)).sum().full_tensor().backward()
        out[f"{name}_a2a"] = y
        out[f"{name}_grads"] = {k: full_tensor(v.grad)
                                for k, v in leaves.items()}
        out[f"{name}_grads"]["x"] = full_tensor(xx.grad)
        # the masked dense path's output and gradient, plain tensors
        dl = {k: v.detach().clone().requires_grad_(True)
              for k, v in pp.items()}
        xd = x.clone().requires_grad_(True)
        yd = moe.moe_apply_dense(dl, xd, c)
        (yd * g_out).sum().backward()
        out[f"{name}_dense"] = yd
        out[f"{name}_dense_grads"] = {k: v.grad for k, v in dl.items()}
        out[f"{name}_dense_grads"]["x"] = xd.grad
    return out


@case
def shard_heads(inp):
    """The tiny granite-8b (4 query heads over 2 KV heads) and
    starcoder2-7b (3 over 1) on a (1, 4) mesh, whose model axis is wider
    than their KV heads (and starcoder2-7b's query heads): the logits, the
    loss and every leaf's gradient, and a prefill then a decode step
    against a cache sharded as ``cache_logical_axes`` places it."""
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = _mesh((1, 4), ("data", "model"))
    # the plain tensors the model makes itself (positions, masks) count as
    # replicated, as sharded_step has them count
    with implicit_replication():
        return {arch: _shard_heads_arch(inp, arch, mesh)
                for arch in ("granite-8b", "starcoder2-7b")}


def _shard_heads_arch(inp, arch, mesh):
    import torch
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model
    from repro_torch.sharding import (NamedSharding, P, ShardingRules,
                                      distribute, distribute_tree,
                                      tree_shardings)
    from repro_torch.training.train_loop import loss_and_grads
    rules = ShardingRules.for_mesh(mesh)
    model = build_model(get_tiny_config(arch), rules, remat=False)
    params = _params(inp, f"{arch}/params/")
    params = distribute_tree(params, tree_shardings(
        rules, model.param_logical_axes(), params))

    def placed(x):
        spec = P("data", *[None] * (x.dim() - 1))
        return distribute(x, NamedSharding(rules.mesh, spec))
    batch = {k: placed(torch.from_numpy(inp[f"{arch}/batch/{k}"]))
             for k in ("tokens", "labels")}
    res = {"logits": model.logits(params, batch)}
    loss, grads, _ = loss_and_grads(model, params, batch)
    res["loss"], res["grads"] = loss, grads
    prompt = placed(torch.from_numpy(inp[f"{arch}/prompt"]))
    cache = model.init_cache(prompt.shape[0], int(inp["max_len"]),
                             device="cpu")
    axes = model.cache_logical_axes()
    cache = {k: (distribute_tree(v, tree_shardings(rules, axes[k], v))
                 if torch.is_tensor(v) else v) for k, v in cache.items()}
    res["cache_k_placements"] = _pl(cache["k"].placements)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    res["prefill"] = logits
    tok = placed(torch.from_numpy(inp[f"{arch}/next"]))
    logits, cache = model.decode_step(params, tok, cache)
    res["decode"], res["cache_k"] = logits, cache["k"]
    return res


def _qt(inp, prefix):
    from repro_torch.bridge import qtensor_from_numpy
    import types
    f = unflatten(inp, prefix)
    return qtensor_from_numpy(types.SimpleNamespace(
        packed=f["packed"], scale=f["scale"], zero=f["zero"],
        bits=int(f["bits"]), group_size=int(f["group_size"]),
        shape=tuple(int(v) for v in f["shape"]), col_scale=None),
        device="cpu")


def _entry(rank, world, d, cases):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world), rank=rank, world_size=world)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {}
    for name in cases:
        res[name] = _host(CASES[name](inp))
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    sys.path.insert(0, HERE)
    d, world, names = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
    mp.spawn(_entry, args=(world, d, names), nprocs=world, join=True)
