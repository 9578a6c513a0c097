"""The hand-written CUDA kernels K1–K6 against their plain PyTorch versions
on the card, at small shapes and edge cases.

Needs a CUDA card: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is false (decided inside the fixture, never
at import, so every pytest-xdist worker collects the same tests). On the
card: ``python -m pytest -m gpu tests/test_torch_gpu.py``. No JAX here.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

# PyTorch's sync-debug warning at each wait of the host on the card
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def _launched(name, fn):
    before = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    return out


# K1: f32 FMA accumulation in another order than cuBLAS's — agreement to a
# few ulps of the K-term sums, hence 1e-5 relative / 1e-4 absolute.
@pytest.mark.parametrize("shape", [(128, 128), (200, 136), (64, 300),
                                   (3, 96, 160)])
def test_awp_pgd_step_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    k = shape[-1]
    w, theta = _randn(rng, shape, cuda), _randn(rng, shape, cuda)
    c = _randn(rng, shape[:-2] + (k, k), cuda) / np.sqrt(k)
    if len(shape) == 3:
        eta = torch.tensor([0.3, 0.5, 0.7], device=cuda)
    else:
        eta = torch.tensor(0.4, device=cuda)
    # a 3-D call is K1b and counts under its own key
    key = "awp_pgd_step_batched" if len(shape) == 3 else "awp_pgd_step"
    z, nrm = _launched(key, lambda: ops.awp_pgd_step(w, theta, c, eta))
    z_ref, nrm_ref = ref.awp_pgd_step(w, theta, c, eta)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(nrm, nrm_ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("m,k", [(96, 160), (200, 136)])
def test_awp_pgd_step_batched_distinct_eta(cuda, m, k):
    """K1b at B = 2 with a different η per item (an indexing fault in the
    batch dimension shows), each item against its own 2-D plain step."""
    rng = np.random.default_rng(8)
    w, theta = _randn(rng, (2, m, k), cuda), _randn(rng, (2, m, k), cuda)
    c = _randn(rng, (2, k, k), cuda) / np.sqrt(k)
    eta = 2.0 / torch.linalg.matrix_norm(c)                # (2,), distinct
    assert float(eta[0]) != float(eta[1])
    before = ops.LAUNCHES["awp_pgd_step"]
    z, nrm = _launched("awp_pgd_step_batched",
                       lambda: ops.awp_pgd_step(w, theta, c, eta))
    assert ops.LAUNCHES["awp_pgd_step"] == before
    for i in range(2):
        z_i, nrm_i = ref.awp_pgd_step(w[i], theta[i], c[i], eta[i])
        torch.testing.assert_close(z[i], z_i, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(nrm[i], nrm_i, rtol=1e-5, atol=0)


def test_prune_batched_compacted_on_the_card(cuda):
    """The compacting batched prune on the card (K1b and K2) against the
    same run through the plain versions: equal iteration counts (items that
    converge in a few steps and items that run to the cap), masks equal on
    ≥ 99.9% of entries, losses within 1e-5 (the repo's compression bars:
    the two sum the step's products in other orders)."""
    from repro_torch import kernels
    from repro_torch.core import awp, batched
    rng = np.random.default_rng(9)
    b, d_out, d_in, k = 4, 96, 256, 128
    w = rng.standard_normal((b, d_out, d_in)).astype(np.float32)
    x = rng.standard_normal((b, 512, d_in)).astype(np.float32)
    x[1] *= 1e-4                          # converges in the first chunk
    c = np.einsum("bti,btj->bij", x, x) / 512
    w, c = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (w, c))
    ops.reset_launches()
    got = batched.prune_batched_compacted(w, c, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["awp_pgd_step_batched"] > 0
    assert ops.LAUNCHES["topk_row"] > 0
    ops.reset_launches()
    with kernels.use_impl("reference"):
        want = batched.prune_batched_compacted(w, c, k)
    assert not any(ops.LAUNCHES.values())
    assert torch.equal(got.iters, want.iters)
    assert got.iters.tolist()[1] < 25 and max(got.iters.tolist()) == 200
    agree = ((got.theta != 0) == (want.theta != 0)).float().mean()
    assert float(agree) >= 0.999
    loss = awp.activation_loss(w, got.theta, c)
    loss_ref = awp.activation_loss(w, want.theta, c)
    assert float((loss - loss_ref).abs().max()) <= 1e-5


# K2 and K3 are exact: same keep-set, same bits as the plain versions.
@pytest.mark.parametrize("d,k", [(1000, 1), (1000, 500), (1000, 999),
                                 (73728, 36864)])
def test_topk_row_exact(cuda, d, k):
    rng = np.random.default_rng(1)
    z = _randn(rng, (8, d), cuda)
    out = _launched("topk_row", lambda: ops.topk_row(z, k))
    assert torch.equal(out, ref.topk_row(z, k))
    assert int((out != 0).sum(-1).min()) == k


def test_topk_row_ties_and_edges(cuda):
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.integers(-3, 4, (64, 512)).astype(np.float32)
                         ).to(cuda)
    z[0] = -0.0                                     # all-zero row of -0.0
    for k in (1, 100, 255, 511):
        out = _launched("topk_row", lambda: ops.topk_row(z, k))
        assert torch.equal(out, ref.topk_row(z, k))
    before = ops.LAUNCHES["topk_row"]
    assert torch.equal(ops.topk_row(z, 0), torch.zeros_like(z))
    assert torch.equal(ops.topk_row(z, 512), z)
    assert ops.LAUNCHES["topk_row"] == before        # no launch for k ∉ (0, d)


@pytest.mark.parametrize("bits,group", [(2, 128), (3, 128), (4, 128),
                                        (8, 128), (4, 64)])
def test_quant_project_exact(cuda, bits, group):
    rng = np.random.default_rng(3)
    z = _randn(rng, (96, 512), cuda)
    z[1, :group] = 0.75                             # constant group: scale floor
    z[2] = torch.round(z[2] * 4) / 4                # values on a coarse grid
    out = _launched("quant_project",
                    lambda: ops.quant_project(z, bits, group))
    assert torch.equal(out, ref.quant_project(z, bits, group))


# K4: the dequantized weight is bit-equal; only the order of the f32 sum
# over K = 512 products of size ~0.5 differs (~1e-5 absolute), hence 1e-4.
@pytest.mark.parametrize("m", [1, 4, 8, 9, 64])
def test_dequant_matmul_matches_plain(cuda, m):
    rng = np.random.default_rng(4)
    n, k, group = 96, 512, 128
    x = _randn(rng, (m, k), cuda)
    packed = torch.from_numpy(rng.integers(0, 256, (n, k // 2), np.uint8)
                              ).to(cuda)
    scale = torch.from_numpy(rng.uniform(0.01, 0.1, (n, k // group))
                             .astype(np.float32)).to(cuda)
    zero = torch.from_numpy(rng.integers(0, 16, (n, k // group))
                            .astype(np.float32)).to(cuda)
    y = _launched("dequant_matmul", lambda: ops.dequant_matmul(
        x, packed, scale, zero, group))
    y_ref = ref.dequant_matmul(x, packed, scale, zero, group)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-4)


# K5 is exact: the same two roundings (subtract, multiply) per element.
@pytest.mark.parametrize("r,k,group", [(2048, 512, 64), (37, 64, 16),
                                       (5, 96, 32)])
def test_kv_dequant_exact(cuda, r, k, group):
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 256, (r, k), np.uint8)).to(cuda)
    scale = torch.from_numpy(rng.uniform(1e-4, 0.1, (r, k // group))
                             .astype(np.float16)).to(cuda)
    zero = torch.from_numpy(rng.integers(0, 256, (r, k // group))
                            .astype(np.float16)).to(cuda)
    out = _launched("kv_dequant", lambda: ops.kv_dequant(
        codes, scale, zero, group))
    assert torch.equal(out, ref.kv_dequant(codes, scale, zero, group))


def _kv_case(rng, dev, b, t, hk, g, d, quant, group):
    q = _randn(rng, (b, hk * g, d), dev)
    k = _randn(rng, (b, t, hk, d), dev)
    v = _randn(rng, (b, t, hk, d), dev)
    if not quant:
        return q, (k, v), {}
    from repro_torch.serving.kv_cache import kv_quantize
    qk, qv = kv_quantize(k, group), kv_quantize(v, group)
    return q, (qk.codes, qv.codes), dict(
        k_scale=qk.scale, k_zero=qk.zero, v_scale=qv.scale, v_zero=qv.zero,
        group_size=group)


# K6: online softmax over tiles against one softmax over the row: f32 sums
# in another order, the reference's bar (tests/test_decode_attn.py) 1e-5.
@pytest.mark.parametrize("hk,g,d,quant,group,block_t", [
    (1, 1, 16, False, 0, 16), (2, 4, 16, False, 0, 7),
    (2, 3, 16, True, 8, 16), (8, 4, 64, True, 64, 256),
    (8, 4, 64, False, 0, 256), (2, 2, 32, True, 32, 64)])
def test_decode_attn_matches_plain(cuda, hk, g, d, quant, group, block_t):
    rng = np.random.default_rng(6)
    t = 300 if d == 64 else 40
    lens = [0, 1, 17, t // 2, t - 1, t]
    q, (k, v), kw = _kv_case(rng, cuda, len(lens), t, hk, g, d, quant, group)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = _launched("decode_attn", lambda: ops.decode_attn(
        q, k, v, lengths, block_t=block_t, **kw))
    want = ref.decode_attn(q, k, v, lengths, **kw)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out[0], torch.zeros_like(out[0]))  # length 0: zeros


def test_decode_attn_bf16_and_nan_row(cuda):
    rng = np.random.default_rng(7)
    q, (k, v), _ = _kv_case(rng, cuda, 4, 64, 2, 2, 32, False, 0)
    lengths = torch.tensor([64, 0, 33, 5], dtype=torch.int32, device=cuda)
    kb, vb = k.bfloat16(), v.bfloat16()
    out = _launched("decode_attn", lambda: ops.decode_attn(
        q, kb, vb, lengths, block_t=16))
    torch.testing.assert_close(out, ref.decode_attn(q, kb, vb, lengths),
                               rtol=1e-5, atol=1e-5)
    for quant in (False, True):
        q, (k, v), kw = _kv_case(rng, cuda, 4, 64, 2, 2, 32, quant, 16)
        if quant:
            kw["k_scale"][2, 3] = float("nan")       # one poisoned token
        else:
            k[2, 3] = float("nan")
        out = _launched("decode_attn", lambda: ops.decode_attn(
            q, k, v, lengths, block_t=16, **kw))
        assert torch.isnan(out[2]).all()              # the NaN row propagates
        assert torch.isfinite(out[[0, 3]]).all()
        assert torch.equal(out[1], torch.zeros_like(out[1]))
        torch.testing.assert_close(out, ref.decode_attn(q, k, v, lengths,
                                                        **kw),
                                   rtol=1e-5, atol=1e-5, equal_nan=True)


def test_wrappers_refuse_mixed_devices(cuda):
    z = torch.zeros(4, 256, device=cuda)
    with pytest.raises(ValueError):
        ops.awp_pgd_step(z, z.cpu(), torch.zeros(256, 256, device=cuda), 0.1)
    with pytest.raises(TypeError):
        ops.topk_row(z.double(), 3)
    codes = torch.zeros(4, 64, dtype=torch.uint8, device=cuda)
    planes = torch.ones(4, 4, dtype=torch.float16)
    with pytest.raises(ValueError):
        ops.kv_dequant(codes, planes, planes.to(cuda), 16)
    q = torch.zeros(2, 4, 16, device=cuda)
    kv = torch.zeros(2, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        ops.decode_attn(q, kv, kv, torch.ones(2, dtype=torch.int32))


def test_engine_waits_on_the_card_once_a_step(cuda):
    """The engine reads one tensor on the host a decode step, a batched
    prefill and a chunked prompt, and waits on the card nowhere else:
    PyTorch's sync-debug mode warns at every wait. INT8 cache, so K5
    (the chunked prompt) and K6 (every decode step) run."""
    import warnings

    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, EngineConfig, GenerationRequest

    cfg = get_tiny_config("llama32-1b")
    model = build_model(cfg)
    eng = Engine(model, model.init(0, device=cuda), EngineConfig(
        num_slots=4, max_len=64, prompt_buckets=(8, 16), kv_quantized=True))
    rng = np.random.default_rng(0)
    reqs = [GenerationRequest(rid=i, prompt=rng.integers(
                1, cfg.vocab_size, n).astype(np.int32), max_new_tokens=g)
            for i, (n, g) in enumerate([(5, 6), (12, 4), (40, 5), (7, 8),
                                        (3, 3)])]
    eng.warmup(reqs)
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r in reqs:
                eng.submit(r)
            got = eng.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in caught if SYNC_WARNING in str(w.message)]
    assert len(waits) == (eng.decode_steps + eng.prefill_dispatches
                          + eng.chunked_admitted)
    assert eng.chunked_admitted == 1
    assert sorted(len(r.tokens) for r in got if r.status == "ok") == \
        [3, 4, 5, 6, 8]
    assert ops.LAUNCHES["kv_dequant"] > 0 and ops.LAUNCHES["decode_attn"] > 0
