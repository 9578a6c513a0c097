"""The port's batched compression engine (``repro_torch.core.batched``) on
the CPU: the cases of ``tests/test_batched.py`` on the tiny llama32 config,
and the port's PGD cores against the JAX package's on the same inputs
(``tests/test_torch_batched_jax.py`` holds the port's engine to JAX's).

Bars: batched against sequential in the port at the reference's own
``_assert_parity`` bar (per-layer losses and every compressed weight
within 1e-5); compacted against monolithic prune bit for bit. MoE cases
wait for the MoE model. No host read inside a chunk of the PGD loops:
with ``Tensor.__bool__``, ``.item`` and ``.tolist`` made to raise, a chunk
still runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.configs import get_tiny_config as jget_tiny
from repro.core import awp as jawp, batched as jbatched
from repro.models import build_model as jbuild
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import awp, batched, calibration as calib, registry
from repro_torch.core import specs
from repro_torch.core.compress import compress_model, get_linear
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.models import build_model

ARCH = "llama32-1b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(mod):
    """``chip_smoke.py``'s policy: prune every wo, int4 the other six."""
    return mod.Policy({"*.attn.wo": mod.PruneSpec(ratio=0.5)},
                      default=mod.QuantSpec(bits=4, group_size=128))


def _table1(mod):
    """The Table-1 prune policy on blocks 0 and 1; the rest stays dense."""
    return mod.Policy({"blocks.0.*": mod.PruneSpec(ratio=0.5),
                       "blocks.1.*": mod.PruneSpec(ratio=0.5)}, default=None)


@pytest.fixture(scope="module")
def tiny():
    """Tiny llama32 with JAX's random init carried into the port, and its
    calibration tokens."""
    cfg, jcfg = get_tiny_config(ARCH), jget_tiny(ARCH)
    jmodel, model = jbuild(jcfg, remat=False), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    dc = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4)
    cal = [{"tokens": torch.from_numpy(t)}
           for t, _ in calibration_batches(DataConfig(**dc), 2)]
    return dict(model=model, params=params, cal=cal)


def _both_engines(tiny, policy):
    return tuple(compress_model(tiny["model"], tiny["params"], tiny["cal"],
                                policy, engine=engine)
                 for engine in ("sequential", "batched"))


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def _assert_parity(seq, bat, atol=1e-5):
    (cp_s, rep_s), (cp_b, rep_b) = seq, bat
    ls = {r.qualname: r.loss_after for r in rep_s}
    lb = {r.qualname: r.loss_after for r in rep_b}
    assert set(ls) == set(lb) and ls
    for k in ls:
        assert abs(ls[k] - lb[k]) <= atol, (k, ls[k], lb[k])
    for a, b in zip(_leaves(cp_s), _leaves(cp_b)):
        assert_allclose(a.numpy(), b.numpy(), atol=atol)


# ---------------------------------------------------------------------------
# bucketing rules
# ---------------------------------------------------------------------------

def _work(name, w, spec):
    return batched.LayerWork(name, name, ("blocks", name), 0, spec,
                             calib.init(w.shape[1], device="cpu"), w)


def test_bucket_key_groups_same_shape_same_spec():
    rng = np.random.default_rng(0)
    spec = specs.PruneSpec(ratio=0.5)
    w1, w2, w3 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((16, 32), (16, 32), (8, 32)))
    works = [_work("a", w1, spec), _work("b", w3, spec), _work("c", w2, spec),
             _work("d", w1, specs.PruneSpec(ratio=0.25)),
             _work("e", w2, spec)]
    assert list(batched.bucket_works(works).values()) == [[0, 2, 4], [1], [3]]


def test_block_buckets_of_the_policies(tiny):
    """The buckets ``chip_smoke.py`` relies on: {wk, wv} and {wg, wu} at
    B = 2 under the mixed policy (wq, wo, wd alone), and {wq, wo}, {wk, wv},
    {wg, wu} under the Table-1 policy (wd alone)."""
    from repro_torch.core.compress import _block_works
    model, params = tiny["model"], tiny["params"]
    h = model.embed(params, tiny["cal"][0])
    _, caps = model.block_apply_one(params, 0, h, capture=True)
    stats = {k: calib.update(calib.init(v.shape[-1], device="cpu"), v)
             for k, v in caps.items()}
    for policy, want in ((_mixed(specs), [["wq"], ["wk", "wv"], ["wo"],
                                          ["wg", "wu"], ["wd"]]),
                         (_table1(specs), [["wq", "wo"], ["wk", "wv"],
                                           ["wg", "wu"], ["wd"]])):
        works = _block_works(model, params, 0, stats, policy)
        got = [[works[j].name for j in idxs]
               for idxs in batched.bucket_works(works).values()]
        assert sorted(got) == sorted(want)


# ---------------------------------------------------------------------------
# engine parity in the port (the reference's bar: 1e-5 on losses and params)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [
    "awp_prune", "awp_quant", "awp_joint", "awp_prune_nm", "magnitude",
    "wanda", "mixed"])
def test_batched_matches_sequential(tiny, policy):
    pol = {"awp_prune": _table1(specs),       # 200 steps a layer: 2 blocks
           "awp_quant": specs.QuantSpec(bits=4, group_size=32),
           "awp_joint": specs.JointSpec(ratio=0.5, bits=4, group_size=32),
           "awp_prune_nm": specs.PruneSpec(method="awp_prune_nm", nm=(2, 4)),
           "magnitude": specs.PruneSpec(method="magnitude", ratio=0.5),
           "wanda": specs.PruneSpec(method="wanda", ratio=0.5),
           "mixed": _mixed(specs)}[policy]
    seq, bat = _both_engines(tiny, pol)
    blocks = 2 if policy == "awp_prune" else 4
    assert len(seq[1]) == len(bat[1]) == blocks * 7
    _assert_parity(seq, bat)
    for r_s, r_b in zip(seq[1], bat[1]):
        a_s = seq[1].artifacts[r_s.qualname].result
        a_b = bat[1].artifacts[r_b.qualname].result
        assert a_s.iters == a_b.iters, r_s.qualname
        if a_s.mask is not None:
            assert_array_equal(a_s.mask, a_b.mask)


@pytest.fixture
def negate_method():
    """A method with no batched form, registered for one test only."""
    @registry.register("test_negate", spec_cls=specs.QuantSpec)
    def _negate(w, stats, spec):
        return registry.CompressResult(theta=-w)
    try:
        yield "test_negate"
    finally:
        registry._REGISTRY.pop("test_negate", None)


def test_batched_fallback_for_unbatched_method(tiny, negate_method):
    assert registry.get_batched(negate_method) is None
    cp, report = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                                specs.QuantSpec(method=negate_method),
                                engine="batched")
    assert len(report) == 4 * 7
    assert torch.equal(cp["blocks"]["attn"]["wq"][0],
                       -tiny["params"]["blocks"]["attn"]["wq"][0])


def test_batched_packed_artifacts_bit_exact(tiny):
    """The bucket's packing keeps dequant(codes) == the written weight."""
    cp, report = compress_model(tiny["model"], tiny["params"], tiny["cal"],
                                specs.QuantSpec(bits=4, group_size=32),
                                engine="batched")
    for art in report.artifacts.values():
        qt = art.result.qtensor
        assert qt is not None
        assert torch.equal(qt.dequant(), get_linear(cp, art.path, art.layer))


# ---------------------------------------------------------------------------
# batched PGD core against the per-layer loop
# ---------------------------------------------------------------------------

def _mixed_stack(b, d_out, d_in, seed=0):
    """A stack with mixed conditioning: a near-zero covariance and a
    low-rank one converge in a few iterations, the rest run to the cap."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(b, d_out, d_in)).astype(np.float32)
    x = rng.normal(size=(b, 128, d_in)).astype(np.float32)
    x[1] *= 1e-4
    x[3][:, 6:] = 0.0
    c = (np.einsum("bti,btj->bij", x, x) / 128).astype(np.float32)
    return w, c


def test_pgd_batched_matches_sequential_per_item():
    """Per-item masking: every item stops at its own count with the
    sequential trajectory, and the counts are JAX's."""
    k = 8
    w, c = _mixed_stack(5, 12, 16)
    res_b = batched.prune_batched(torch.from_numpy(w), torch.from_numpy(c), k)
    iters = res_b.iters.numpy()
    jres_b = jbatched.prune_batched(jnp.asarray(w), jnp.asarray(c), k,
                                    use_pallas=False)
    assert_array_equal(iters, np.asarray(jres_b.iters))
    for i in range(5):
        res_i = awp.prune(torch.from_numpy(w[i]), torch.from_numpy(c[i]), k)
        assert int(res_i.iters) == iters[i]
        assert_allclose(res_b.theta[i].numpy(), res_i.theta.numpy(),
                        rtol=1e-5, atol=1e-5)
    assert len(set(iters.tolist())) > 1, "want distinct convergence counts"


@pytest.mark.parametrize("nm", [None, (2, 4)])
def test_prune_batched_compacted_matches_monolithic(nm):
    """Chunks with converged items compacted out give the monolithic run's
    bits: the projection does not depend on the step index."""
    w, c = (torch.from_numpy(a) for a in _mixed_stack(5, 12, 16))
    ref = batched.prune_batched(w, c, 8, nm=nm)
    got = batched.prune_batched_compacted(w, c, 8, nm=nm)
    assert torch.equal(got.theta, ref.theta)
    assert torch.equal(got.iters, ref.iters)
    assert torch.equal(got.grad_norm, ref.grad_norm)
    assert len(set(got.iters.tolist())) > 1


def test_quantize_batched_matches_sequential():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 8, 32)).astype(np.float32)
    x = rng.normal(size=(4, 64, 32)).astype(np.float32)
    c = (np.einsum("bti,btj->bij", x, x) / 64).astype(np.float32)
    res_b = batched.quantize_batched(torch.from_numpy(w), torch.from_numpy(c),
                                     4, group_size=16)
    for i in range(4):
        res_i = awp.quantize(torch.from_numpy(w[i]), torch.from_numpy(c[i]), 4,
                             group_size=16)
        assert_allclose(res_b.theta[i].numpy(), res_i.theta.numpy(),
                        rtol=1e-5, atol=1e-5)
        want = jawp.quantize(jnp.asarray(w[i]), jnp.asarray(c[i]), 4,
                             group_size=16)
        assert_allclose(res_b.theta[i].numpy(), np.asarray(want.theta),
                        rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------

def _forbid_host_reads(monkeypatch):
    def read(self, *a, **k):
        raise AssertionError("host read of a tensor inside a PGD chunk")
    for name in ("__bool__", "item", "tolist", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, read)


def test_no_host_read_inside_a_pgd_chunk(monkeypatch):
    """One chunk of the sequential loop and whole batched loops complete
    with every tensor-to-host read raising."""
    w, c = (torch.from_numpy(a) for a in _mixed_stack(4, 16, 32))
    theta0 = torch.zeros_like(w)
    proj_fn = awp.prune_projection(8)
    _forbid_host_reads(monkeypatch)
    one = awp.pgd(w[0], c[0], proj_fn, theta0[0], awp.PGDConfig(
        max_iters=awp.PGD_CHUNK_ITERS, tol=1e-4))
    many = awp.pgd_batched(w, c, proj_fn, theta0, awp.PGDConfig(
        max_iters=awp.PGD_CHUNK_ITERS, tol=1e-4))
    quant = batched.quantize_batched(w, c, 4, group_size=16)
    joint = batched.joint_batched(w, c, 16, 4, group_size=16, total_iters=60)
    monkeypatch.undo()
    assert torch.equal(one.theta, many.theta[0])
    assert int(one.iters) == int(many.iters[0])
    assert quant.theta.shape == joint.theta.shape == w.shape


def test_pgd_reads_the_norm_once_a_chunk(monkeypatch):
    """200 prune steps that never converge: the sequential loop reads the
    norm on the host after each of the first 7 chunks of 25 (none after
    the last), the compacting batched driver once a chunk (8)."""
    w, c = _mixed_stack(4, 16, 32)
    w, c = torch.from_numpy(w[[0, 2]]), torch.from_numpy(c[[0, 2]])
    counts = {"bool": 0, "cpu": 0}
    real_bool, real_cpu = torch.Tensor.__bool__, torch.Tensor.cpu

    def counted_bool(self):
        counts["bool"] += 1
        return real_bool(self)

    def counted_cpu(self, *a, **k):
        counts["cpu"] += 1
        return real_cpu(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    res = awp.prune(w[0], c[0], 8)
    assert int(res.iters) == 200 and counts["bool"] == 7
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    counts["bool"] = 0
    res_b = batched.prune_batched_compacted(w, c, 8)
    assert res_b.iters.tolist() == [200, 200]
    assert counts == {"bool": 0, "cpu": 8}
