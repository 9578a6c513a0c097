"""Multi-pod dry run of the port (the port of ``repro/launch/dryrun.py``):
every (arch × shape × mesh) cell's step on meta tensors under a fake
process group, with its per-device memory, operations, bytes and
collectives, and the roofline they bound on H100 cards.

No device is touched and nothing is allocated:

- one process joins ``torch.distributed``'s ``"fake"`` backend with
  ``FakeStore`` (from ``torch.testing._internal.distributed.fake_pg``, a
  private module of PyTorch's test suite) at the mesh's world size, 256
  ranks (``single``, data 16 × model 16) or 512 (``multi``, pod 2 × data
  16 × model 16), and plays rank 0. Its collectives return at once;
- the mesh is a CPU :class:`DeviceMesh` of ``launch/mesh.py``'s shapes and
  names, and every param, optimizer state, batch and cache tensor is a
  DTensor over a ``meta`` local shard (``sharding.distribute``);
- the port's own step runs eagerly on them: ``make_train_step`` under
  ``sharded_step`` for ``train`` cells, ``prefill`` and ``decode_step``
  against ``init_cache`` for the serving cells. No kernel runs on meta,
  so the cell runs under ``kernels.use_impl("reference")`` (the plain
  versions); this is shape arithmetic, and the JSON says so
  (``"impl": "reference"``).

What a cell records, all per device (rank 0's local shards):

- ``memory``: ``argument_size_in_bytes``, the local bytes of params,
  optimizer state, step, batch and cache, exact at full depth;
  ``temp_size_in_bytes``, the step's transient peak: the most bytes of
  live tensors the step made at any point, over and above its arguments
  (:class:`StepCounter`); ``donated_size_in_bytes``, the state (train) or
  cache (serving) that the step updates in place, the reference's donated
  arguments: the port writes them in place, so no second copy is made
  and none is subtracted; ``total_per_device_bytes`` = arguments +
  transient, against the card's 80 GB;
- ``cost_fit``: ``flops`` from ``torch.utils.flop_counter``'s formulas
  (FlopCounterMode's registry) on every local op; ``bytes`` as every local
  op's input and output bytes, unfused and so an upper bound (XLA's count
  in the reference is after fusion); ``collectives`` by kind
  (``analysis.roofline.collective_bytes``), counted at the call the port
  makes: DTensor's shard-to-shard all-to-all counts as ``all-to-all`` on
  this CPU mesh too, where PyTorch runs it as an all-gather and a chunk;
- ``roofline``: :class:`~repro_torch.analysis.roofline.Roofline` at the
  H100 peaks, with ``model_flops`` = 6·N_active·D (train) or 2·N_active·D
  (serve). Its times are bounds from published peaks, not measurements.

An eager meta step still runs every op in Python, so a full-depth SSM
cell would take hours. As the reference fits its costs, each cell runs at
reduced depths, [1, 2] layers or [p, p + 2, 2p] for the hybrid (p its
shared-block period), and every count is the least-squares fit
f(L) = fixed + L·per_layer (+ ceil(L/p)·per_shared) at full depth, never
below the deepest sample (:func:`_predict`). The arguments' bytes need no
fit. Cell choices are the reference's: Adafactor above 20e9 parameters,
16 microbatches above 100e9 and 8 above 20e9 (capped so each still spans
every batch shard), a bf16 accumulator above 100e9 with microbatches,
remat on, bf16 params. The compress cell runs AWP's PGD loop on the
arch's largest linear through ``core/distributed.py``: row-sharded over
``"data"`` only (the reference's ``v2``), or column-sharded with an
all-reduce and an all-gather an iteration when d_in > 46,000.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--compress] [--timeout N]
  python -m repro_torch.launch.dryrun --summary      # the written cells

``--mesh`` also takes a shape (``1x1``, ``2x2``) and ``--batch``/``--seq``
cut a named shape, for a cell that one card or a test can check.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

COMPRESS_ITERS = 20
COMPRESS_ETA = 1e-3
COLSHARD_D_IN = 46_000


def _out_path(mesh_name, arch, shape, results_dir=None):
    d = os.path.abspath(os.path.join(results_dir or RESULTS_DIR, mesh_name))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}.json")


# ---------------------------------------------------------------------------
# the mesh, without a machine
# ---------------------------------------------------------------------------

def mesh_shape(mesh_name: str):
    """``(shape, axis names)`` of ``single``, ``multi`` or a shape spec."""
    from repro_torch.launch.mesh import parse_mesh
    if mesh_name == "single":
        return (16, 16), ("data", "model")
    if mesh_name == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    return parse_mesh(mesh_name)


def fake_mesh(mesh_name: str):
    """The mesh of ``mesh_name`` over a fake process group of its world
    size, joined as rank 0 (a fake group of another size is left first)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = mesh_shape(mesh_name)
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        if dist.get_backend() != "fake":
            raise ValueError(f"mesh {mesh_name} needs {world} ranks; this "
                             f"process joined {dist.get_world_size()}")
        dist.destroy_process_group()         # another fake mesh's group
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


# ---------------------------------------------------------------------------
# counting a step's local ops
# ---------------------------------------------------------------------------

_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                  "_dtensor")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _shapes_of(tensors) -> list:
    """Meta tensors of ``tensors``' shapes and dtypes: a record that holds
    none of their storage (a collective's output would otherwise stay
    live, and count, for the rest of the step)."""
    with _disable_current_modes():
        return [torch.empty(t.shape, dtype=t.dtype, device="meta")
                for t in tensors]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts every local op of a step: its flops (FlopCounterMode's
    formulas), its input and output bytes, the collectives it issues
    (``records``, for ``roofline.collective_bytes``), and the bytes of
    live tensors it made (``live``, with the most at any point in
    ``peak``).

    Ops on DTensors are passed down (``NotImplemented``), so the counter
    sees the local ops that DTensor runs on each rank's shards, with their
    local shapes; the fake tensors of DTensor's sharding propagation are
    skipped. An output whose storage is none of its inputs' is a new
    allocation; it is held (its storage object) until its storage has no
    other owner left, checked before every op, and then taken off
    ``live``. Tensors made before the counter was entered (the step's
    arguments) and views and in-place results of them are never counted.
    A weakref finalizer on the tensor would fire too early: PyTorch frees
    a tensor's Python object while autograd still holds it for backward.
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.records = []
        self.live = 0
        self.peak = 0
        self._held = {}
        self._quiet = 0            # inside a collective counted as one

    def _sweep(self):
        use = torch._C._storage_Use_Count
        for key in [k for k in self._held if use(k) <= 1]:
            self.live -= self._held.pop(key)[1]

    def _allocated(self, ins, outs):
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._held:
                continue
            seen.add(key)
            self._held[key] = (st, st.nbytes())
            self.live += st.nbytes()
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = list(_tensors((args, kwargs)))
        if any(isinstance(t, FakeTensor) for t in ins):
            return func(*args, **kwargs)
        self._sweep()
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if self._quiet or any(isinstance(t, FakeTensor) for t in outs):
            return out
        if func.namespace in _COLLECTIVE_NS:
            self.records.append((func.name(), _shapes_of(outs)))
        elif not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        packet = func.overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        self._allocated(ins, outs)
        return out

    def __enter__(self):
        self._patch_alltoall()
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch_alltoall()
        return super().__exit__(*exc)

    def _patch_alltoall(self):
        """DTensor's shard-to-shard all-to-all runs as an all-gather and a
        chunk on a CPU mesh: count it as the one all-to-all it is on the
        cards (its output bytes), and nothing inside it."""
        import torch.distributed.tensor.placement_types as pt
        self._orig_a2a = getattr(pt, "shard_dim_alltoall", None)
        if self._orig_a2a is None:
            return
        orig, counter = self._orig_a2a, self

        def shard_dim_alltoall(input, *a, **kw):
            counter._quiet += 1
            try:
                out = orig(input, *a, **kw)
            finally:
                counter._quiet -= 1
            counter.records.append(("shard_dim_alltoall", _shapes_of([out])))
            counter._allocated([input], [out])
            return out
        pt.shard_dim_alltoall = shard_dim_alltoall

    def _unpatch_alltoall(self):
        if self._orig_a2a is not None:
            import torch.distributed.tensor.placement_types as pt
            pt.shard_dim_alltoall = self._orig_a2a

    def counts(self) -> dict:
        from repro_torch.analysis import roofline as rl
        coll = rl.collective_bytes(self.records)
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": coll,
                "collective_total": float(sum(coll.values())),
                "temp_bytes": float(self.peak)}


def local_bytes(tree) -> int:
    """Bytes of ``tree``'s tensors on this rank (a DTensor's local shard;
    ints, such as a cache's position, count nothing)."""
    from repro_torch.sharding import is_dtensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if is_dtensor(tree):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 0


# ---------------------------------------------------------------------------
# one step of a cell, on meta
# ---------------------------------------------------------------------------

def cell_choices(cfg, shape, rules) -> dict:
    """The reference's choices for a cell: the optimizer, the microbatch
    count and the accumulator's dtype (train cells)."""
    n = cfg.param_count()
    default = 16 if n > 100e9 else (8 if n > 20e9 else 1)
    n_micro = int(os.environ.get("DRYRUN_MICRO", default))
    out = {"optimizer": "adafactor" if n > 20e9 else "adamw"}
    if shape.kind == "train":
        batch_shards = rules.axis_size(rules.batch_axes)
        n_micro = max(1, min(n_micro, shape.global_batch // batch_shards))
        out["microbatches"] = n_micro
        out["accum_dtype"] = (torch.bfloat16 if (n > 100e9 and n_micro > 1)
                              else torch.float32)
    return out


def _meta_batch(cfg, shape, rules, kind):
    from repro_torch.models.model import batch_specs
    from repro_torch.sharding import NamedSharding, distribute
    if kind == "decode":
        specs = {"tokens": ((shape.global_batch, 1), torch.int64)}
    else:
        specs = batch_specs(cfg, shape.global_batch, shape.seq_len)
        if kind == "prefill":
            specs.pop("labels", None)
    out = {}
    for k, (shp, dtype) in specs.items():
        spec = rules.spec(("batch",) + (None,) * (len(shp) - 1), shp)
        out[k] = distribute(torch.empty(shp, dtype=dtype, device="meta"),
                            NamedSharding(rules.mesh, spec))
    return out


def model_flops(cfg, shape) -> float:
    """The useful work of a step: 6·N_active·D to train, 2·N_active·D to
    serve (D the step's tokens)."""
    if shape.kind == "train":
        return 6.0 * cfg.active_param_count() * shape.global_batch \
            * shape.seq_len
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                   else 1)
    return 2.0 * cfg.active_param_count() * tokens


def build_cell(cfg, mesh, shape, choice):
    """Everything one cell's step needs, on meta DTensors: ``(run, args,
    donated)`` where ``run()`` takes one step. ``choice`` is
    :func:`cell_choices`' for the full config, so a reduced-depth sample
    keeps the full model's optimizer and microbatches."""
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.sharding import (distribute_tree, rules_for_cell,
                                      tree_shardings)
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step,
                                                 shard_train_state,
                                                 sharded_step)
    kind = shape.kind
    rules = rules_for_cell(mesh, cfg.family, kind,
                           global_batch=shape.global_batch)
    model = build_model(cfg, rules, remat=True)
    params = model.init(0, device="meta", dtype=torch.bfloat16)
    batch = _meta_batch(cfg, shape, rules, kind)
    if kind == "train":
        tcfg = TrainConfig(optimizer=OptimizerConfig(name=choice["optimizer"]),
                           microbatches=choice["microbatches"],
                           accum_dtype=choice["accum_dtype"])
        step_fn, opt_init = make_train_step(model, tcfg)
        state = shard_train_state(
            {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")},
            model, rules, choice["optimizer"])
        del params
        step = sharded_step(step_fn)

        def run():
            return step(state, batch)
        return run, (state, batch), state

    params = distribute_tree(params, tree_shardings(
        rules, model.param_logical_axes(), params))
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             torch.bfloat16, device="meta")
    axes = model.cache_logical_axes()
    cache = {k: (distribute_tree(v, tree_shardings(rules, axes[k], v))
                 if torch.is_tensor(v) else v) for k, v in cache.items()}
    if kind == "prefill":
        def run():
            return model.prefill(params, batch, cache)
    else:
        def run():
            return model.decode_step(params, batch["tokens"], cache)
    return run, (params, batch, cache), cache


def count_step(cfg, mesh, shape, choice) -> dict:
    """One step of ``cfg``'s cell at ``shape`` on ``mesh``, counted
    (:class:`StepCounter`); the plain versions stand in for the kernels.
    Returns the counts and the arguments' and donated bytes."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels import use_impl
    run, args, donated = build_cell(cfg, mesh, shape, choice)
    counter = StepCounter()
    with use_impl("reference"), implicit_replication(), counter:
        out = run()
        del out
    counts = counter.counts()
    counts["argument_bytes"] = float(local_bytes(args))
    counts["donated_bytes"] = float(local_bytes(donated))
    del args, donated, run
    return counts


# ---------------------------------------------------------------------------
# the depth fit
# ---------------------------------------------------------------------------

def fit_depths(cfg) -> list:
    p = cfg.attn_every if cfg.family == "hybrid" else 0
    return [p, p + 2, 2 * p] if p else [1, 2]


def _feats(cfg, depth: int) -> list:
    p = cfg.attn_every if cfg.family == "hybrid" else 0
    row = [1.0, float(depth)]
    if p:
        row.append(float(-(-depth // p)))
    return row


def _predict(cfg, depths, vals) -> float:
    """The reference's least-squares fit of ``vals`` at ``depths``,
    evaluated at ``cfg.num_layers``: never below the deepest sample (nor
    0)."""
    import numpy as np
    a = np.array([_feats(cfg, d) for d in depths])
    coef, *_ = np.linalg.lstsq(a, np.array(vals, dtype=np.float64),
                               rcond=None)
    return float(max(np.dot(_feats(cfg, cfg.num_layers), coef), max(vals),
                     0.0))


def fit_costs(cfg, mesh, shape, choice) -> dict:
    """Counts at the reduced depths and their fit at full depth."""
    depths = fit_depths(cfg)
    samples = [count_step(dataclasses.replace(cfg, num_layers=d), mesh,
                          shape, choice) for d in depths]
    out = {k: _predict(cfg, depths, [s[k] for s in samples])
           for k in ("flops", "bytes", "collective_total", "temp_bytes")}
    out["collectives"] = {
        k: _predict(cfg, depths, [s["collectives"][k] for s in samples])
        for k in samples[0]["collectives"]}
    out["fit_depths"] = depths
    out["fit_samples"] = samples
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _memory(argument: float, temp: float, donated: float) -> dict:
    from repro_torch.analysis import roofline as rl
    total = argument + temp
    return {"argument_size_in_bytes": int(argument),
            "temp_size_in_bytes": int(temp),
            "donated_size_in_bytes": int(donated),
            "total_per_device_bytes": int(total),
            "device_bytes": int(rl.DEVICE_BYTES),
            "fits": bool(total <= rl.DEVICE_BYTES)}


def _full_depth_args(cfg, mesh, shape, choice):
    """(argument bytes, donated bytes) of the full-depth cell: its params,
    optimizer state, batch and cache built on meta and placed, without a
    step."""
    _, args, donated = build_cell(cfg, mesh, shape, choice)
    return float(local_bytes(args)), float(local_bytes(donated))


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             batch: int = 0, seq: int = 0) -> dict:
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(arch)
    mesh = fake_mesh(mesh_name)
    chips = mesh.size()
    t0 = time.time()
    if shape_name == "compress":
        return _compress_cell(cfg, mesh, mesh_name, chips)
    shape = SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(shape, global_batch=batch or
                                    shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    from repro_torch.sharding import rules_for_cell
    choice = cell_choices(cfg, shape, rules_for_cell(mesh, cfg.family,
                                                     shape.kind))
    fit = fit_costs(cfg, mesh, shape, choice)
    argument, donated = _full_depth_args(cfg, mesh, shape, choice)
    mem = _memory(argument, fit["temp_bytes"], donated)
    print(f"memory: {mem}")
    print(f"cost (depth fit): flops={fit['flops']:.3e} "
          f"bytes={fit['bytes']:.3e} coll={fit['collective_total']:.3e}")
    roof = rl.from_counts(fit["flops"], fit["bytes"], fit["collectives"],
                          chips, model_flops(cfg, shape))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "kind": shape.kind,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "param_dtype": "bfloat16", "impl": "reference",
        "choices": {k: str(v).replace("torch.", "")
                    for k, v in choice.items()},
        "memory": mem,
        "cost_fit": {k: fit[k] for k in
                     ("flops", "bytes", "collective_total", "collectives",
                      "fit_depths")},
        "fit_samples": fit["fit_samples"],
        "bytes_are": "unfused: every local op's input and output bytes "
                     "(an upper bound)",
        "roofline": roof.to_dict(),
        "roofline_is": "bounds from published H100 SXM peaks, not "
                       "measurements",
        "compile_seconds": time.time() - t0,
    }


def compress_layer(cfg):
    """(d_out, d_in) of the arch's largest linear, the reference's pick."""
    if cfg.family == "moe":
        return cfg.d_ff, cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return 2 * cfg.d_inner, cfg.d_model
    return cfg.d_model, cfg.d_ff or cfg.d_model   # down-proj: largest fan-in


def _compress_cell(cfg, mesh, mesh_name, chips) -> dict:
    """AWP's PGD loop (top-k projection, 20 iterations, η = 1e-3, k =
    d_in // 2) on the arch's largest linear, through
    ``core/distributed.py``: rows over ``"data"`` only, no collective
    (the reference's v2 schedule, Θ left row-sharded as its out-sharding
    leaves it), or, when d_in > 46,000 and a replicated C would not fit,
    C's rows over ``"model"`` with an all-reduce and an all-gather an
    iteration. The loop is unrolled (eager), so the counts are exact."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.analysis import roofline as rl
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import use_impl
    from repro_torch.sharding import (NamedSharding, P, ShardingRules,
                                      distribute, local_block,
                                      rules_for_cell)
    d_out, d_in = compress_layer(cfg)
    rules = rules_for_cell(mesh, "dense", "compress")
    iters, k, eta = COMPRESS_ITERS, d_in // 2, COMPRESS_ETA
    t0 = time.time()
    w = torch.empty((d_out, d_in), dtype=torch.float32, device="meta")
    c = torch.empty((d_in, d_in), dtype=torch.float32, device="meta")
    if d_in <= COLSHARD_D_IN:
        v2 = ShardingRules(mesh=mesh, batch_axes=rules.batch_axes,
                           tp_axis=rules.tp_axis, fsdp_axes=rules.fsdp_axes,
                           rows_axes=("data",))
        axes = dist.rowsharded_axes(v2, d_out)
        wd = distribute(w, NamedSharding(mesh, P(axes or None, None)))
        cd = distribute(c, NamedSharding(mesh, P(None, None)))

        def run():
            loop = dist.awp_prune_rowsharded_fn(k, eta, iters)
            return loop(local_block(wd, mesh, P(axes or None, None)),
                        local_block(cd, mesh, P(None, None)))
        schedule = "row-sharded (zero-collective, v2)"
        chips = mesh.size(mesh.mesh_dim_names.index("data"))
    else:
        wd = distribute(w, NamedSharding(
            mesh, P(tuple(rules.batch_axes), rules.tp_axis)))
        cd = distribute(c, NamedSharding(mesh, P(rules.tp_axis, None)))

        def run():
            return dist.awp_prune_colsharded_fn(k, eta, iters, rules)(wd, cd)
        schedule = "column-sharded C (all-reduce per iteration)"
    counter = StepCounter()
    with use_impl("reference"), implicit_replication(), counter:
        out = run()
        del out
    costs = counter.counts()
    argument = float(local_bytes((wd, cd)))
    model_flops = iters * 2.0 * d_out * d_in * d_in
    roof = rl.from_counts(costs["flops"], costs["bytes"],
                          costs["collectives"], chips, model_flops)
    return {
        "arch": cfg.name, "shape": "compress", "mesh": mesh_name,
        "chips": chips, "kind": "compress", "schedule": schedule,
        "layer": {"d_out": d_out, "d_in": d_in, "iters": iters},
        "impl": "reference",
        "memory": _memory(argument, costs["temp_bytes"], 0.0),
        "cost_fit": {k: costs[k] for k in
                     ("flops", "bytes", "collective_total", "collectives")},
        "bytes_are": "unfused: every local op's input and output bytes "
                     "(an upper bound)",
        "roofline": roof.to_dict(),
        "roofline_is": "bounds from published H100 SXM peaks, not "
                       "measurements",
        "compile_seconds": time.time() - t0,
    }


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def all_cells(include_compress: bool):
    from repro_torch.configs import get_config, list_archs, shapes_for
    cells = []
    for arch in list_archs(include_paper=False):
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            cells.append((arch, shape.name))
        if include_compress:
            cells.append((arch, "compress"))
    return cells


def orchestrate(meshes, include_compress: bool, timeout: int,
                results_dir=None):
    """Every cell in its own process (a fresh fake process group each),
    skipping cells whose JSON is already written."""
    done, failed = [], []
    cells = all_cells(include_compress)
    for mesh_name in meshes:
        for arch, shape in cells:
            if shape == "compress" and mesh_name == "multi":
                continue                       # compress rooflined single-pod
            path = _out_path(mesh_name, arch, shape, results_dir)
            if os.path.exists(path):
                done.append((mesh_name, arch, shape, "cached"))
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_name]
            if results_dir:
                cmd += ["--results-dir", results_dir]
            print(f"[dryrun] {mesh_name} {arch} {shape} ...", flush=True)
            try:
                r = subprocess.run(cmd, timeout=timeout, capture_output=True,
                                   text=True)
                if r.returncode == 0:
                    done.append((mesh_name, arch, shape, "ok"))
                else:
                    failed.append((mesh_name, arch, shape,
                                   r.stderr.strip().splitlines()[-1]
                                   if r.stderr.strip() else "nonzero exit"))
                    print(r.stderr[-2000:], flush=True)
            except subprocess.TimeoutExpired:
                failed.append((mesh_name, arch, shape, f"timeout {timeout}s"))
    print(f"\n=== dry-run summary: {len(done)} ok, {len(failed)} failed ===")
    for f in failed:
        print("FAILED:", f)
    return 0 if not failed else 1


def summary(results_dir=None) -> list:
    """One line a written cell, every mesh: per-device GB against the
    card's, and the three roofline times (bounds) with the largest."""
    root = os.path.abspath(results_dir or RESULTS_DIR)
    lines = []
    for mesh_name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        for name in sorted(os.listdir(os.path.join(root, mesh_name))):
            with open(os.path.join(root, mesh_name, name)) as f:
                r = json.load(f)
            m, t = r["memory"], r["roofline"]
            lines.append(
                f"{mesh_name} {r['arch']} {r['shape']}: "
                f"{m['total_per_device_bytes'] / 1e9:.2f} GB "
                f"(arguments {m['argument_size_in_bytes'] / 1e9:.2f}, "
                f"transient {m['temp_size_in_bytes'] / 1e9:.2f}) of "
                f"{m['device_bytes'] / 1e9:.0f}; compute "
                f"{t['t_compute_s']:.4g} s, memory {t['t_memory_s']:.4g} s, "
                f"collective {t['t_collective_s']:.4g} s -> "
                f"{t['bottleneck']}")
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    help="single, multi, both (with --all) or a shape "
                         "such as 2x2")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="include AWP compress-step cells")
    ap.add_argument("--timeout", type=int, default=5400)
    ap.add_argument("--batch", type=int, default=0,
                    help="cut the shape's global batch to this")
    ap.add_argument("--seq", type=int, default=0,
                    help="cut the shape's sequence length to this")
    ap.add_argument("--results-dir", default=None,
                    help=f"default {os.path.abspath(RESULTS_DIR)}")
    ap.add_argument("--summary", action="store_true",
                    help="print one line a written cell and exit")
    args = ap.parse_args()

    if args.summary:
        print("\n".join(summary(args.results_dir)))
        return

    if args.all:
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        sys.exit(orchestrate(meshes, args.compress, args.timeout,
                             args.results_dir))

    assert args.arch and args.shape and args.mesh != "both"
    try:
        result = run_cell(args.arch, args.shape, args.mesh,
                          batch=args.batch, seq=args.seq)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    path = _out_path(args.mesh, args.arch, args.shape, args.results_dir)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[dryrun] wrote {path}")
    r, m = result["roofline"], result["memory"]
    print(f"[dryrun] {args.arch} {args.shape} {args.mesh}: "
          f"{m['total_per_device_bytes'] / 1e9:.2f} GB/device of "
          f"{m['device_bytes'] / 1e9:.0f}; bounds compute="
          f"{r['t_compute_s']:.4f}s memory={r['t_memory_s']:.4f}s "
          f"collective={r['t_collective_s']:.4f}s -> {r['bottleneck']}")


if __name__ == "__main__":
    main()
