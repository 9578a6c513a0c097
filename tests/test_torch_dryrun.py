"""The port's dry run (``repro_torch.launch.dryrun``), its roofline
(``repro_torch.analysis.roofline``), the shapes of ``configs/base.py`` and
the reference helpers added beside them, held to the JAX package.

The fake-process-group cells run in one subprocess of the port (no JAX
there): a tiny granite-8b train cell on a fake (2, 2) mesh and on one
rank, the depth fit against full-depth runs, and the collectives
recorded from DTensor redistributions of known shapes. JAX runs once on
four fake devices for the reference's argument bytes and model flops of
the same cell. Exact where the docstrings say so. About 45 s on one
process.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, SRC, run_multidevice

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config, list_archs
from repro_torch.analysis import roofline as rl
from repro_torch.configs import (SHAPES, ShapeConfig, get_config, shapes_for)

B, S = 8, 16

PORT_CODE = r"""
import dataclasses, json, sys, torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
sys.path.insert(0, sys.argv[2])
import chip_smoke
from repro_torch.launch import dryrun as D
from repro_torch.configs import get_tiny_config, SHAPES
from repro_torch.models import build_model, make_batch
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import (NamedSharding, P, distribute,
                                  rules_for_cell)
from repro_torch.training.train_loop import TrainConfig, make_train_step
torch.set_num_threads(1)
B, S = int(sys.argv[3]), int(sys.argv[4])
out = {}
shape = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)

def cell(cfg, mesh):
    choice = D.cell_choices(cfg, shape, rules_for_cell(mesh, cfg.family,
                                                       "train"))
    return choice, D.count_step(cfg, mesh, shape, choice)

# the tiny granite-8b train cell on a fake (2, 2) mesh
cfg = get_tiny_config("granite-8b")
mesh = D.fake_mesh("2x2")
choice, c = cell(cfg, mesh)
out["cell22"] = {k: v for k, v in c.items()}
out["model_flops"] = D.model_flops(cfg, shape)
tf = chip_smoke.train_flops(cfg, B, S)
out["train_flops"] = tf["forward"] + tf["backward"] + tf["recompute"]

# the depth fit against full-depth runs: dense at 5 layers, the hybrid at
# 9 with the shared block every 3 (fit depths 3, 5, 6)
for name, deep in (("dense", dataclasses.replace(cfg, num_layers=5)),
                   ("hybrid", dataclasses.replace(
                       get_tiny_config("zamba2-1.2b"), num_layers=9,
                       attn_every=3))):
    ch = D.cell_choices(deep, shape, rules_for_cell(mesh, deep.family,
                                                    "train"))
    fit = D.fit_costs(deep, mesh, shape, ch)
    full = D.count_step(deep, mesh, shape, ch)
    out["fit_" + name] = {"fit": {k: fit[k] for k in
                                 ("flops", "collectives", "temp_bytes",
                                  "fit_depths")},
                          "full": {k: full[k] for k in
                                   ("flops", "collectives", "temp_bytes")}}

# collectives of known shapes, recorded as the dry run records them
counter = D.StepCounter()
x = torch.empty((8, 16), device="meta")
with counter:
    a = distribute(x, NamedSharding(mesh, P("data", None)))
    a.redistribute(mesh, [Replicate(), Replicate()])         # all-gather
    p = DTensor.from_local(x, mesh, [Partial(), Replicate()],
                           run_check=False)
    p.redistribute(mesh, [Replicate(), Replicate()])         # all-reduce
    p.redistribute(mesh, [Shard(0), Replicate()])            # reduce-scatter
    s0 = distribute(x, NamedSharding(mesh, P("model", None)))
    s0.redistribute(mesh, [Replicate(), Shard(1)])           # all-to-all
    dist.all_reduce(torch.empty((4, 4), device="meta"))     # c10d call
from repro_torch.analysis.roofline import collective_bytes
out["collectives"] = collective_bytes(counter.records)

# one rank: the counted flops against the shapes' count and the plain
# step's FlopCounterMode count; the live-bytes peak on meta (a DTensor
# step) against the same tracker around the plain step on CPU tensors
mesh1 = D.fake_mesh("1x1")
tiny = get_tiny_config("llama32-1b")
choice1, c1 = cell(tiny, mesh1)
model = build_model(tiny, remat=True)
step, opt_init = make_train_step(model, TrainConfig(
    optimizer=OptimizerConfig(name=choice1["optimizer"])))
params = model.init(0, device="cpu", dtype=torch.bfloat16)
state = {"params": params, "opt": opt_init(params),
         "step": torch.zeros((), dtype=torch.int32)}
batch = make_batch(tiny, torch.Generator().manual_seed(0), B, S,
                   device="cpu")
real = D.StepCounter()
with FlopCounterMode(display=False) as fc, real:
    step(state, batch)
tf1 = chip_smoke.train_flops(tiny, B, S)
out["one"] = {"flops": c1["flops"], "temp_bytes": c1["temp_bytes"],
              "real_flops": fc.get_total_flops(), "real_peak": real.peak,
              "train_flops": tf1["forward"] + tf1["backward"]
              + tf1["recompute"]}
print(json.dumps(out))
"""

JAX_CODE = r"""
import dataclasses, json, sys, jax
from repro.configs import get_tiny_config, SHAPES
from repro.launch import dryrun as D
from repro.launch.mesh import make_mesh
B, S = int(sys.argv[1]), int(sys.argv[2])
cfg = get_tiny_config("granite-8b")
mesh = make_mesh((2, 2), ("data", "model"))
shape = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
lowered, model_flops = D._build_lowered(cfg, mesh, shape, "train",
                                        unroll=False, n_micro=1)
mem = lowered.compile().memory_analysis()
print("RESULT " + json.dumps({"argument": int(mem.argument_size_in_bytes),
                              "model_flops": model_flops}))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", PORT_CODE, "x", REPO,
                        str(B), str(S)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_cell():
    out = run_multidevice(f"import sys; sys.argv = ['x', '{B}', '{S}']\n"
                          + JAX_CODE, n_devices=4, timeout=600)
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _jax_dryrun():
    """The reference's dry-run module; its import sets XLA_FLAGS for 512
    devices, which this process (one device, already initialized) must
    not pass on to later subprocesses."""
    held = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if held is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = held
    return dryrun


@pytest.mark.parametrize("arch", list_archs())
def test_shapes_match_jax(arch):
    from repro.configs import SHAPES as JSHAPES, shapes_for as jshapes_for
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JSHAPES.items()}
    assert isinstance(SHAPES["train_4k"], ShapeConfig)
    assert [tuple(vars(s).values()) for s in shapes_for(get_config(arch))] \
        == [tuple(vars(s).values()) for s in jshapes_for(jget_config(arch))]


@pytest.mark.parametrize("compress", [False, True])
def test_all_cells_match_jax(compress):
    from repro_torch.launch.dryrun import all_cells
    assert all_cells(compress) == _jax_dryrun().all_cells(compress)


def test_roofline_at_h100_peaks():
    """Each term is one second at the published peak; the bound, the
    bottleneck and the fractions as the reference computes them."""
    r = rl.from_counts(989e12, 3.35e12, {"all-gather": 30e9,
                                         "all-reduce": 20e9}, 256,
                       989e12 * 256)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)
    assert r.collective_per_device == 50e9 and r.t_bound == 1.0
    assert abs(r.roofline_frac - 1.0) < 1e-12
    assert abs(r.useful_flops_frac - 1.0) < 1e-12
    r = rl.Roofline(flops_per_device=989e12, bytes_per_device=2 * 3.35e12,
                    collective_per_device=25e9, chips=4,
                    model_flops=989e12)
    assert r.bottleneck == "memory" and r.t_bound == 2.0
    assert abs(r.useful_flops_frac - 0.25) < 1e-12
    assert abs(r.roofline_frac - 0.125) < 1e-12
    d = r.to_dict()
    assert set(d) == {"flops_per_device", "bytes_per_device",
                      "collective_per_device", "chips", "model_flops",
                      "t_compute_s", "t_memory_s", "t_collective_s",
                      "bottleneck", "useful_flops_frac", "roofline_frac"}
    assert rl.COLLECTIVES == ("all-gather", "all-reduce", "reduce-scatter",
                              "all-to-all", "collective-permute")


def test_collective_bytes_of_recorded_ops(port):
    """DTensor redistributions of an (8, 16) f32 tensor on the fake (2, 2)
    mesh, and one ``dist.all_reduce`` of a (4, 4): each rank's output
    bytes by kind. The shard-to-shard all-to-all counts as one even where
    the CPU mesh runs it as an all-gather and a chunk."""
    assert port["collectives"] == {"all-gather": 8 * 16 * 4,
                                   "all-reduce": 8 * 16 * 4 + 4 * 4 * 4,
                                   "reduce-scatter": 4 * 16 * 4,
                                   "all-to-all": 8 * 8 * 4,
                                   "collective-permute": 0}
    assert rl.collective_bytes([("c10d::allgather_", ([np.zeros(3)],)),
                                ("_c10d_functional::wait_tensor", [])]) \
        == dict.fromkeys(rl.COLLECTIVES, 0)


def test_tiny_cell_matches_jax(port, jax_cell):
    """The tiny granite-8b train cell (batch 8 × 16, bf16 params, AdamW)
    on a (2, 2) mesh. Params and optimizer state per device, exactly the
    reference's ``argument_size_in_bytes`` less its batch (int32 tokens
    and labels, 4 × 16 a device) and step (int32). The port's batch is
    int64 tokens and labels (its data pipeline's dtype): 8 bytes an
    entry. Its state also holds the step, int32."""
    c = port["cell22"]
    jax_batch = 2 * (B // 2) * S * 4
    assert c["donated_bytes"] - 4 == jax_cell["argument"] - jax_batch - 4
    assert c["argument_bytes"] - c["donated_bytes"] == 2 * (B // 2) * S * 8
    assert port["model_flops"] == jax_cell["model_flops"]


def test_counted_flops_equal_the_shapes_count(port):
    """The matmul operations counted on each rank's shards against an
    independent count from the shapes: ``chip_smoke.train_flops``
    (forward, backward, remat recompute) less each block's last product
    (``wd``, 2·T·d_ff·d_model a layer), which PyTorch's non-reentrant
    checkpoint does not recompute: it stops once the tensors backward
    saved are rebuilt. On one rank equal, and equal to FlopCounterMode
    around the plain step on CPU tensors. Summed over the four ranks of
    the (2, 2) mesh, equal to it plus one product a layer that DTensor's
    sharding propagation runs on both "model" ranks: one of the two
    backward products of ``wo`` (2·T·H·D·d_model), whose incoming
    gradient arrives sequence-sharded."""
    from repro_torch.configs import get_tiny_config
    tokens = B * S
    for name, arch, flops, shapes in (
            ("cell22", "granite-8b", port["cell22"]["flops"] * 4,
             port["train_flops"]),
            ("one", "llama32-1b", port["one"]["flops"],
             port["one"]["train_flops"])):
        cfg = get_tiny_config(arch)
        want = shapes - cfg.num_layers * 2 * tokens * cfg.d_ff * cfg.d_model
        if name == "cell22":
            want += (cfg.num_layers * 2 * tokens * cfg.num_heads
                     * cfg.resolved_head_dim * cfg.d_model)
        assert flops == want, name
    assert port["one"]["flops"] == port["one"]["real_flops"]


def test_live_bytes_same_on_meta_and_cpu(port):
    """The tracker's peak over one tiny step: the dry run's, on meta
    DTensors, equals the same tracker's around the plain step on real CPU
    tensors."""
    assert port["one"]["temp_bytes"] == port["one"]["real_peak"] > 0


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_depth_fit_equals_full_depth(port, family):
    """The fit from reduced depths ([1, 2]; the hybrid's [3, 5, 6]) at the
    full depth, against a run at the full depth: flops exact (linear in
    the depth, so up to the float64 least squares: 1e-9 relative); each
    collective's bytes within 5e-3 (the shallowest sample is not quite
    on the line: the dense model's all-reduce grows 8,832 bytes from one
    layer to two and 8,704 a layer after, so the fit over [1, 2]
    overshoots 5 layers by 384 of 191,244 bytes; the hybrid's all-gather
    by 256 of 2.6e6); the transient peak within 5% (a fit of a maximum
    over the step, not a sum)."""
    f = port[f"fit_{family}"]
    assert f["fit"]["fit_depths"] == ([1, 2] if family == "dense"
                                      else [3, 5, 6])
    assert f["fit"]["flops"] == pytest.approx(f["full"]["flops"], rel=1e-9)
    for k, v in f["full"]["collectives"].items():
        assert f["fit"]["collectives"][k] == pytest.approx(v, rel=5e-3,
                                                           abs=1e-6), k
    assert f["fit"]["temp_bytes"] == pytest.approx(f["full"]["temp_bytes"],
                                                   rel=0.05)


def test_packed_weight_bytes_match_jax():
    import torch
    from repro.quant import QTensor as JQ
    from repro.launch.serve import (dense_itemsize as jitemsize,
                                    packed_weight_bytes as jpacked,
                                    qtensor_leaves as jleaves)
    from repro_torch.bridge import qtensor_from_numpy
    from repro_torch.launch.serve import (dense_itemsize,
                                          packed_weight_bytes,
                                          qtensor_leaves)
    rng = np.random.default_rng(0)
    w4 = rng.normal(size=(3, 32, 64)).astype(np.float32)
    w8 = rng.normal(size=(16, 64)).astype(np.float32)
    q4 = jax.tree.map(lambda *a: jnp.stack(a),
                      *[JQ.from_dense(jnp.asarray(w), bits=4, group_size=32)
                        for w in w4])
    q8 = JQ.from_dense(jnp.asarray(w8), bits=8, group_size=32)
    emb = rng.normal(size=(10, 8)).astype(np.float32)
    jtree = {"embed": jnp.asarray(emb, jnp.bfloat16),
             "blocks": {"wq": q4, "wo": q8}}
    ptree = {"embed": torch.from_numpy(emb).to(torch.bfloat16),
             "blocks": {"wq": qtensor_from_numpy(q4, device="cpu"),
                        "wo": qtensor_from_numpy(q8, device="cpu")}}
    assert packed_weight_bytes(ptree) == jpacked(jtree)
    assert dense_itemsize(ptree) == jitemsize(jtree) == 2
    assert len(qtensor_leaves(ptree)) == len(jleaves(jtree)) == 2
    f32 = dict(ptree, embed=ptree["embed"].float())
    assert packed_weight_bytes(f32) == jpacked(
        dict(jtree, embed=jtree["embed"].astype(jnp.float32)))


def test_awp_prune_fused_matches_jax():
    """The port's fused loop on CPU tensors (its plain versions) against
    the reference's through its plain path, 15 iterations, at the
    reference's 2e-4 (tests/test_kernels.py)."""
    import torch
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    rng = np.random.default_rng(1)
    w = rng.normal(size=(24, 64)).astype(np.float32)
    x = rng.normal(size=(128, 64)).astype(np.float32)
    c = (x.T @ x / 128).astype(np.float32)
    k, eta = 20, 2.0 / float(np.linalg.norm(c))
    want = jops.awp_prune_fused(jnp.asarray(w), jnp.asarray(c), k, eta, 15,
                                theta0=jops.topk_row(jnp.asarray(w), k,
                                                     use_pallas=False),
                                use_pallas=False)
    tw, tc = torch.from_numpy(w), torch.from_numpy(c)
    got = ops.awp_prune_fused(tw, tc, k, eta, 15,
                              theta0=ops.topk_row(tw, k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    plain = ops.awp_prune_fused(tw, tc, k, eta, 15, use_pallas=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(
        jops.awp_prune_fused(jnp.asarray(w), jnp.asarray(c), k, eta, 15,
                             use_pallas=False)), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ratio,bits", [(0.5, 4), (0.3, 8)])
def test_joint_project_matches_jax(ratio, bits):
    """Prune, quantize, re-mask: the reference's quant bar (1e-5,
    tests/test_kernels.py) and the same support."""
    import torch
    from repro.core.projections import joint_project as jjoint
    from repro_torch.core.projections import joint_project
    z = np.random.default_rng(2).normal(size=(16, 256)).astype(np.float32)
    want = np.asarray(jjoint(jnp.asarray(z), jnp.float32(ratio), bits, 64))
    got = joint_project(torch.from_numpy(z), ratio, bits, 64).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_activation_loss_batched_matches_jax():
    """Per item at the reference's per-layer loss bar (1e-5)."""
    import torch
    from repro.core.awp import activation_loss_batched as jloss
    from repro_torch.core.awp import activation_loss_batched
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 12, 32)).astype(np.float32)
    th = w * (rng.random(size=w.shape) > 0.5)
    x = rng.normal(size=(3, 64, 32)).astype(np.float32)
    c = np.einsum("bti,btj->bij", x, x) / 64
    want = np.asarray(jloss(jnp.asarray(w), jnp.asarray(th), jnp.asarray(c)))
    got = activation_loss_batched(*(torch.from_numpy(a.astype(np.float32))
                                    for a in (w, th, c))).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
