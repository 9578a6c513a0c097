"""The hand-written CUDA kernels K1–K6, K4x and K6p against their plain PyTorch
versions on the card, at small shapes and edge cases, and the engines'
host waits and the paged engine's spill/restore round trip there.

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


# every tile variant at ragged M, N and K (none a multiple of the tiles),
# and a B = 3 stack with a different η per item
@pytest.mark.parametrize("variant", range(len(ops.AWP_PGD_TILES)))
@pytest.mark.parametrize("shape", [(200, 136), (64, 300), (130, 260),
                                   (3, 96, 160)])
def test_awp_pgd_step_tile_variants(cuda, variant, shape):
    rng = np.random.default_rng(11)
    k = shape[-1]
    w, theta = _randn(rng, shape, cuda), _randn(rng, shape, cuda)
    c = _randn(rng, shape[:-2] + (k, k), cuda) / np.sqrt(k)
    eta = (torch.tensor([0.3, 0.5, 0.7], device=cuda) if len(shape) == 3
           else torch.tensor(0.4, device=cuda))
    key = "awp_pgd_step_batched" if len(shape) == 3 else "awp_pgd_step"
    z, nrm = _launched(key, lambda: ops.awp_pgd_step(w, theta, c, eta,
                                                     variant=variant))
    z_ref, nrm_ref = ref.awp_pgd_step(w, theta, c, eta)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(nrm, nrm_ref, rtol=1e-5, atol=0)


# the scalar-copy instantiation: K % 4 != 0, and a contiguous stack slice
# whose base lies 4 bytes past a 16-byte boundary
@pytest.mark.parametrize("variant", range(len(ops.AWP_PGD_TILES)))
@pytest.mark.parametrize("case", ["k_not_multiple_of_4", "misaligned_base"])
def test_awp_pgd_step_scalar_copies(cuda, variant, case):
    rng = np.random.default_rng(12)
    b, m, k = (2, 70, 150) if case == "k_not_multiple_of_4" else (2, 96, 160)
    off = 0 if case == "k_not_multiple_of_4" else 1
    n = b * m * k
    w = _randn(rng, (n + off,), cuda)[off:].view(b, m, k)
    theta = _randn(rng, (n + off,), cuda)[off:].view(b, m, k)
    c = (_randn(rng, (b * k * k + off,), cuda) / np.sqrt(k))[off:].view(
        b, k, k)
    assert not ops.awp_pgd_vector_copies(k, w, theta, c)
    eta = torch.tensor([0.25, 0.6], device=cuda)
    z, nrm = _launched("awp_pgd_step_batched", lambda: ops.awp_pgd_step(
        w, theta, c, eta, variant=variant))
    z_ref, nrm_ref = ref.awp_pgd_step(w, theta, c, eta)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(nrm, nrm_ref, rtol=1e-5, atol=0)
    z1, _ = _launched("awp_pgd_step", lambda: ops.awp_pgd_step(
        w[1], theta[1], c[1], eta[1], variant=variant))
    torch.testing.assert_close(z1, z_ref[1], rtol=1e-5, atol=1e-4)


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


def _k2_variants(z, k, want):
    """Every variant K2 can run on ``z`` gives the plain version's output."""
    d = z.shape[-1]
    variants = ops.topk_row_variants(d)
    assert variants
    for v in variants:
        out = _launched("topk_row", lambda: ops.topk_row(z, k, variant=v))
        assert torch.equal(out, want), (ops.topk_row_variant_name(v), k)
        key = (z.numel() // d, d, k, v)
        assert ops.K2_CENSUS[key] >= 1


K2_RAGGED = [(d, k) for d in (1, 3, 31, 33, 1000, 2047, 2048, 2049, 8192,
                              8193, 73728)
             for k in sorted({1, d // 2, d - 1}) if 0 < k < d]


@pytest.mark.parametrize("d,k", K2_RAGGED)
def test_topk_row_every_variant_ragged(cuda, d, k):
    rng = np.random.default_rng(d + k)
    z = _randn(rng, (3 if d > 10000 else 9, d), cuda)
    _k2_variants(z, k, ref.topk_row(z, k))


def test_topk_row_every_variant_ties_and_equal_rows(cuda):
    """Few distinct magnitudes, all-equal rows and rows of ±equal values:
    the leftmost ties are kept, at every variant."""
    rng = np.random.default_rng(3)
    for d in (100, 2048, 8192):
        z = torch.from_numpy(rng.integers(-8, 9, (12, d)).astype(np.float32)
                             ).to(cuda)
        z[1] = 3.0                                  # all equal
        z[2] = torch.where(torch.arange(d, device=cuda) % 3 == 0, -2.5, 2.5)
        z[3, : d // 2] = 7.0                        # two plateaus
        z[3, d // 2:] = -1.0
        for k in (1, d // 4, d // 2, d - 1):
            _k2_variants(z, k, ref.topk_row(z, k))


def test_topk_row_every_variant_negative_zero(cuda):
    """Rows of -0.0 and of mixed ±0.0 tie with one another (|−0| = |+0|):
    the leftmost k are kept with their signs."""
    d = 2048
    z = torch.zeros(4, d, device=cuda)
    z[0] = -0.0
    z[1, ::2] = -0.0
    z[2, : d // 2] = 1.5
    z[2, d // 2:: 2] = -0.0
    z[3, 7] = -0.0
    for k in (1, 3, d // 2, d // 2 + 5, d - 1):
        want = ref.topk_row(z, k)
        _k2_variants(z, k, want)
        out = ops.topk_row(z, k)
        assert torch.equal(torch.signbit(out), torch.signbit(want))


def _nan_rows(d, cuda):
    """Row r (r < 12) holds min(r, d / 2) NaNs of either sign and several
    payloads at scattered columns; rows 1, 4 and 7 also hold ±inf; row 12
    is the reference's example [1, NaN, -2, 0.5, inf, -inf, 3, -0.0]
    repeated."""
    rng = np.random.default_rng(11)
    z = rng.standard_normal((13, d)).astype(np.float32)
    payloads = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF,
                         0xFF800123, 0x7FC01234], dtype=np.uint32).view(
                             np.float32)
    for r in range(12):
        n = min(r, d // 2)
        cols = rng.choice(d, size=n, replace=False)
        z[r, cols] = payloads[np.arange(n) % len(payloads)]
        if r in (1, 4, 7):
            free = np.setdiff1d(np.arange(d), cols)[:2]
            z[r, free] = [np.inf, -np.inf]
    ex = np.array([1, np.nan, -2, 0.5, np.inf, -np.inf, 3, -0.0], np.float32)
    z[12] = np.resize(ex, d)
    return torch.from_numpy(z).to(cuda)


@pytest.mark.parametrize("d", [8, 40, 2048, 8192])
def test_topk_row_every_variant_nan_rows(cuda, d):
    """The reference's keep-set on rows that hold NaN: NaN ranks above
    +inf and counts toward k but is never kept, so k at or below a row's
    NaN count (a NaN threshold) keeps nothing; ±inf tie with each other."""
    z = _nan_rows(d, cuda)
    for k in sorted({1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, d // 2, d - 1}):
        if 0 < k < d:
            want = ref.topk_row(z, k)
            assert not bool(torch.isnan(want).any())
            _k2_variants(z, k, want)


def test_topk_row_nan_example_row(cuda):
    """[1, NaN, -2, 0.5, inf, -inf, 3, -0.0]: k = 1 keeps nothing, k = 2
    keeps inf and -inf (the reference's jnp path, checked on the CPU by
    tests/test_torch_projections.py)."""
    z = torch.tensor([[1, float("nan"), -2, 0.5, float("inf"),
                       -float("inf"), 3, -0.0]], device=cuda)
    assert torch.equal(ops.topk_row(z, 1), torch.zeros_like(z))
    inf = float("inf")
    assert torch.equal(ops.topk_row(z, 2),
                       torch.tensor([[0, 0, 0, 0, inf, -inf, 0, 0.0]],
                                    device=cuda))


@pytest.mark.parametrize("d", [2048, 8192, 1000])
def test_topk_row_misaligned_view(cuda, d):
    """A contiguous view 4 bytes past a 16-byte boundary takes the
    scalar-copy instantiation, with the same output."""
    rng = np.random.default_rng(d)
    buf = torch.empty(6 * d + 1, device=cuda)
    z = buf[1:].view(6, d)
    z.copy_(_randn(rng, (6, d), cuda))
    assert z.is_contiguous() and z.data_ptr() % 16 == 4
    assert not ops.topk_row_vector_copies(d, z)
    _k2_variants(z, d // 2, ref.topk_row(z, d // 2))


def test_topk_row_stack(cuda):
    """A (B, M, d) stack runs as B·M rows in one launch, each row its own."""
    rng = np.random.default_rng(5)
    z = _randn(rng, (3, 40, 2048), cuda)
    z[1, 3, :5] = float("nan")
    for k in (1, 1024):
        want = ref.topk_row(z, k)
        _k2_variants(z, k, want)
        for b in range(3):
            assert torch.equal(want[b], ref.topk_row(z[b], k))


def test_prune_with_nan_in_c_matches_plain(cuda):
    """``awp.prune`` with a NaN in C: η and Z are NaN, the gradient norm is
    NaN and the loop stops after one step; the kernel path's θ equals the
    plain path's (zeros: a NaN threshold keeps nothing), not NaN."""
    from repro_torch import kernels
    from repro_torch.core import awp
    rng = np.random.default_rng(12)
    w = _randn(rng, (64, 256), cuda)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    c = torch.from_numpy(x.T @ x / 512).to(cuda)
    c[3, 7] = float("nan")
    ops.reset_launches()
    got = awp.prune(w, c, 128)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_row"] > 0
    with kernels.use_impl("reference"):
        want = awp.prune(w, c, 128)
    assert int(got.iters) == int(want.iters) == 1
    assert not bool(torch.isnan(want.theta).any())
    assert torch.equal(got.theta, want.theta)


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


def _k4_operands(rng, m, n, k, group, dev):
    x = _randn(rng, (m, k), dev)
    packed = torch.from_numpy(rng.integers(0, 256, (n, k // 2), np.uint8)
                              ).to(dev)
    scale = torch.from_numpy(rng.uniform(0.01, 0.1, (n, k // group))
                             .astype(np.float32)).to(dev)
    zero = torch.from_numpy(rng.integers(0, 16, (n, k // group))
                            .astype(np.float32)).to(dev)
    return x, packed, scale, zero


def _k4_close(y, y_ref):
    """K4's bar: within 1e-5 of max|y| (the dequantized weight is
    bit-equal; the f32 sum may run in another order than cuBLAS's)."""
    err = float((y - y_ref).abs().max())
    assert err <= 1e-5 * float(y_ref.abs().max()), err


# every variant the wrapper can run at ragged M, N and K, groups 64 and
# 128, and K = 8192 (wd's K), each against the plain version
@pytest.mark.parametrize("m,n,k,group", [(1, 68, 256, 64), (5, 200, 512, 128),
                                         (8, 132, 8192, 128),
                                         (9, 132, 320, 64),
                                         (70, 200, 384, 128),
                                         (130, 68, 8192, 128),
                                         (257, 516, 256, 64)])
def test_dequant_matmul_every_variant(cuda, m, n, k, group):
    rng = np.random.default_rng(40)
    x, packed, scale, zero = _k4_operands(rng, m, n, k, group, cuda)
    y_ref = ref.dequant_matmul(x, packed, scale, zero, group)
    assert ops.dequant_matmul_vector_copies(k, n, group, x, packed)
    variants = ops.dequant_matmul_variants(m, k)
    assert len(variants) > len(ops.DEQUANT_TILES) or m > ops.GEMV_MAX_M
    for v in variants:
        y = _launched("dequant_matmul", lambda: ops.dequant_matmul(
            x, packed, scale, zero, group, variant=v))
        _k4_close(y, y_ref)


# the GEMV at every M it takes, with the wrapper's pick
@pytest.mark.parametrize("m", range(1, ops.GEMV_MAX_M + 1))
def test_dequant_matmul_gemv_rows(cuda, m):
    rng = np.random.default_rng(41)
    x, packed, scale, zero = _k4_operands(rng, m, 512, 2048, 128, cuda)
    ops.reset_launches()
    y = _launched("dequant_matmul", lambda: ops.dequant_matmul(
        x, packed, scale, zero, 128))
    ((key, count),) = ops.K4_CENSUS.items()
    assert key[:3] == (m, 512, 2048) and count == 1
    assert key[3] >= len(ops.DEQUANT_TILES)               # the GEMV ran
    _k4_close(y, ref.dequant_matmul(x, packed, scale, zero, 128))


# a stored operand 4 bytes past a 16-byte boundary takes the tile's
# scalar-copy instantiation at every tile variant, also at M <= 8
@pytest.mark.parametrize("variant", range(len(ops.DEQUANT_TILES)))
@pytest.mark.parametrize("m", [4, 70])
def test_dequant_matmul_scalar_copies(cuda, variant, m):
    rng = np.random.default_rng(42)
    n, k, group = 132, 512, 128
    x, packed, scale, zero = _k4_operands(rng, m, n, k, group, cuda)
    shifted = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)
    shifted.copy_(x)
    assert not ops.dequant_matmul_vector_copies(k, n, group, shifted, packed)
    assert ops.dequant_matmul_variants(m, k, vec=False) == tuple(
        range(len(ops.DEQUANT_TILES)))
    y = _launched("dequant_matmul", lambda: ops.dequant_matmul(
        shifted, packed, scale, zero, group, variant=variant))
    y_ref = ref.dequant_matmul(x, packed, scale, zero, group)
    _k4_close(y, y_ref)
    if m > ops.GEMV_MAX_M:
        # the tile sums in the vector instantiation's order
        assert torch.equal(y, ops.dequant_matmul(x, packed, scale, zero,
                                                 group, variant=variant))


# the same inputs give the same bits from launch to launch, every variant
def test_dequant_matmul_same_bits(cuda):
    rng = np.random.default_rng(43)
    for m in (4, 8, 64):
        x, packed, scale, zero = _k4_operands(rng, m, 2048, 2048, 128, cuda)
        for v in ops.dequant_matmul_variants(m, 2048):
            a = ops.dequant_matmul(x, packed, scale, zero, 128, variant=v)
            b = ops.dequant_matmul(x, packed, scale, zero, 128, variant=v)
            assert torch.equal(a, b), (m, v)


# K4x: K4 over a stack of experts in one launch, x shared or per expert
def _k4x_operands(rng, e, m, n, k, group, dev, per_expert):
    x = _randn(rng, (e, m, k) if per_expert else (m, k), dev)
    packed = torch.from_numpy(rng.integers(0, 256, (e, n, k // 2), np.uint8)
                              ).to(dev)
    scale = torch.from_numpy(rng.uniform(0.01, 0.1, (e, n, k // group))
                             .astype(np.float32)).to(dev)
    zero = torch.from_numpy(rng.integers(0, 16, (e, n, k // group))
                            .astype(np.float32)).to(dev)
    return x, packed, scale, zero


def _k4x_close(y, y_ref):
    """K4x's bar, K4's: within 1e-5 of max|y|."""
    assert y.shape == y_ref.shape
    err = float((y - y_ref).abs().max())
    assert err <= 1e-5 * float(y_ref.abs().max()), err


# every variant at ragged shapes, both forms, groups 64 and 128: one
# launch a call, each expert K4's own product, two launches the same bits
@pytest.mark.parametrize("per_expert", [False, True],
                         ids=["shared", "per_expert"])
@pytest.mark.parametrize("e,m,n,k,group", [(3, 1, 68, 256, 64),
                                           (5, 8, 132, 512, 128),
                                           (4, 9, 200, 384, 128),
                                           (2, 70, 132, 256, 64)])
def test_dequant_matmul_experts_every_variant(cuda, per_expert, e, m, n, k,
                                              group):
    rng = np.random.default_rng(44)
    x, packed, scale, zero = _k4x_operands(rng, e, m, n, k, group, cuda,
                                           per_expert)
    y_ref = ref.dequant_matmul_experts(x, packed, scale, zero, group,
                                       per_expert)
    for v in ops.dequant_matmul_variants(m, k):
        y = _launched("dequant_matmul_experts",
                      lambda: ops.dequant_matmul_experts(
                          x, packed, scale, zero, group, per_expert,
                          variant=v))
        _k4x_close(y, y_ref)
        again = ops.dequant_matmul_experts(x, packed, scale, zero, group,
                                           per_expert, variant=v)
        assert torch.equal(y, again), v
        # expert 1 alone through K4 gives its slice's bits
        one = ops.dequant_matmul(x[1] if per_expert else x, packed[1],
                                 scale[1], zero[1], group, variant=v)
        assert torch.equal(y[1] if per_expert else y[:, 1], one), v


# the down projection's input: the (E, T, f) view of (T, E, f)
# activations, read at its strides, and a view off a 16-byte boundary
# (the tile's scalar-copy instantiation)
@pytest.mark.parametrize("m", [4, 70])
def test_dequant_matmul_experts_strided_and_misaligned(cuda, m):
    rng = np.random.default_rng(45)
    e, n, k, group = 4, 132, 256, 128
    _, packed, scale, zero = _k4x_operands(rng, e, m, n, k, group, cuda,
                                           True)
    up = _randn(rng, (m, e, k), cuda)
    view = up.transpose(0, 1)
    y_ref = ref.dequant_matmul_experts(view.contiguous(), packed, scale, zero,
                                       group, True)
    ops.reset_launches()
    y = _launched("dequant_matmul_experts", lambda: ops.dequant_matmul_experts(
        view, packed, scale, zero, group, True))
    _k4x_close(y, y_ref)
    ((key, count),) = ops.K4X_CENSUS.items()
    assert key[:4] == (e, m, n, k) and key[5] is True and count == 1
    shifted = torch.empty(up.numel() + 1, device=cuda)[1:].view(m, e, k)
    shifted.copy_(up)
    for v in range(len(ops.DEQUANT_TILES)):
        y = ops.dequant_matmul_experts(shifted.transpose(0, 1), packed, scale,
                                       zero, group, True, variant=v)
        _k4x_close(y, y_ref)
    with pytest.raises(ValueError):
        ops.dequant_matmul_experts(shifted.transpose(0, 1), packed, scale,
                                   zero, group, True,
                                   variant=len(ops.DEQUANT_TILES))


# an MoE forward on the card through packed experts: K4x launches three
# times a layer and the output is the plain path's
def test_moe_forward_launches_k4x_three_times_a_layer(cuda):
    from repro_torch import kernels
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model
    from repro_torch.quant import QTensor
    cfg = get_tiny_config("qwen3-moe-235b-a22b")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    moe_p = params["blocks"]["moe"]
    for name in ("wg", "wu", "wd"):
        w = moe_p[name]                              # (L, E, d_in, d_out)
        qts = [QTensor.from_dense(w[i, j].T.contiguous(), 4, 32)
               for i in range(w.shape[0]) for j in range(w.shape[1])]
        moe_p[name] = QTensor(
            *(torch.stack([getattr(q, f) for q in qts]).reshape(
                w.shape[:2] + getattr(qts[0], f).shape)
              for f in ("packed", "scale", "zero")),
            bits=4, group_size=32, shape=qts[0].shape)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    ops.reset_launches()
    logits = model.logits(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_matmul_experts"] == 3 * cfg.num_layers
    with kernels.use_impl("reference"):
        want = model.logits(params, {"tokens": toks})
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


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
    (8, 4, 64, False, 0, 256), (2, 2, 32, True, 32, 64),
    (2, 12, 192, True, 64, 16), (2, 12, 192, False, 0, 16)])
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


def _paged_case(rng, dev, lens, page, hk, g, d, quant, group, pool=None):
    """Shuffled pools of ``pool`` pages and tables covering ``lens``: each
    row's live pages distinct, the first page of rows 1 and 2 shared when
    both have one, sentinel (== pool) tails."""
    npg = -(-max(lens) // page) + 1
    pool = pool or sum(-(-n // page) for n in lens) + 3
    q = _randn(rng, (len(lens), hk * g, d), dev)
    k = _randn(rng, (pool, page, hk, d), dev)
    v = _randn(rng, (pool, page, hk, d), dev)
    table = np.full((len(lens), npg), pool, np.int32)
    perm, used = rng.permutation(pool), 0
    for i, n in enumerate(lens):
        live = -(-n // page)
        table[i, :live] = perm[used:used + live]
        used += live
    if lens[1] and lens[2]:
        table[2, 0] = table[1, 0]
    table = torch.from_numpy(table).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = {}
    if quant:
        from repro_torch.serving.kv_cache import kv_quantize
        qk, qv = kv_quantize(k, group), kv_quantize(v, group)
        k, v = qk.codes, qv.codes
        kw = dict(k_scale=qk.scale, k_zero=qk.zero, v_scale=qv.scale,
                  v_zero=qv.zero, group_size=group)
    return q, k, v, table, lengths, kw


# K6p: K6's arithmetic with page addressing — the same bar against the
# plain version, and the same bits as K6 on the gathered rows.
@pytest.mark.parametrize("page,hk,g,d,quant,group,block_t", [
    (8, 1, 1, 16, False, 0, 16), (4, 2, 4, 16, False, 0, 7),
    (8, 2, 3, 16, True, 8, 16), (16, 8, 4, 64, True, 64, 256),
    (16, 8, 4, 64, False, 0, 256), (5, 2, 2, 32, True, 32, 64),
    (8, 2, 12, 192, True, 64, 16), (8, 2, 12, 192, False, 0, 16)])
def test_decode_attn_paged_matches_plain(cuda, page, hk, g, d, quant, group,
                                         block_t):
    rng = np.random.default_rng(8)
    t = 300 if d == 64 else 40
    lens = [0, 1, 17, t // 2, t - 1, t]
    q, k, v, table, lengths, kw = _paged_case(rng, cuda, lens, page, hk, g,
                                              d, quant, group)
    out = _launched("decode_attn_paged", lambda: ops.decode_attn_paged(
        q, k, v, table, lengths, block_t=block_t, **kw))
    want = ref.decode_attn_paged(q, k, v, table, lengths, **kw)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out[0], torch.zeros_like(out[0]))  # length 0: zeros
    rows = {n: ref.gather_pages(x, table) for n, x in kw.items()
            if torch.is_tensor(x)}
    slot = ops.decode_attn(q, ref.gather_pages(k, table),
                           ref.gather_pages(v, table), lengths,
                           block_t=block_t, **dict(kw, **rows))
    assert torch.equal(out, slot)


def test_every_arch_head_shape_is_supported():
    """K6/K6p take the head shape of every arch config of the JAX package
    (full and tiny), nemotron-4-340b's g = 12 at D = 192 included. Runs on
    the CPU: it asks the wrapper's plan, not the card; the configs module
    imports no JAX."""
    from repro.configs import get_config, get_tiny_config, list_archs
    shapes = set()
    for arch in list_archs():
        for cfg in (get_config(arch), get_tiny_config(arch)):
            if cfg.num_heads == 0:                  # attention-free (SSM)
                continue
            g = cfg.num_heads // cfg.num_kv_heads
            shapes.add((g, cfg.resolved_head_dim))
            assert ops.decode_attn_supported(g, cfg.resolved_head_dim), \
                (arch, cfg.name, g, cfg.resolved_head_dim)
    assert (12, 192) in shapes and (16, 128) in shapes


def _head_shape_case(dev, seed, hk, g, d, quant, paged):
    """K6 (or K6p) at one arch's decode head shape, rows of 0-700 tokens
    split over 256-token chunks, against the plain version at K6's bar;
    K6p's bits equal K6's on the gathered rows; the length-0 row zero."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 17, 256, 300, 700]
    group = 64 if quant else 0
    if paged:
        q, k, v, table, lengths, kw = _paged_case(rng, dev, lens, 16, hk, g,
                                                  d, quant, group)
        out = _launched("decode_attn_paged", lambda: ops.decode_attn_paged(
            q, k, v, table, lengths, **kw))
        want = ref.decode_attn_paged(q, k, v, table, lengths, **kw)
        rows = {n: ref.gather_pages(x, table) for n, x in kw.items()
                if torch.is_tensor(x)}
        slot = ops.decode_attn(q, ref.gather_pages(k, table),
                               ref.gather_pages(v, table), lengths,
                               **dict(kw, **rows))
        assert torch.equal(out, slot)
    else:
        q, (k, v), kw = _kv_case(rng, dev, len(lens), 700, hk, g, d, quant,
                                 group)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = _launched("decode_attn", lambda: ops.decode_attn(
            q, k, v, lengths, **kw))
        want = ref.decode_attn(q, k, v, lengths, **kw)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_decode_attn_nemotron_head_shape(cuda, quant, paged):
    """K6 and K6p at nemotron-4-340b's decode shape (96 query heads over 8
    KV heads: g = 12, D = 192; the generic form's 32-accumulator
    instantiation), rows of 0-700 tokens split over 256-token chunks,
    against the plain version at K6's bar; K6p's bits equal K6's on the
    gathered rows."""
    _head_shape_case(cuda, 70, 8, 12, 192, quant, paged)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_decode_attn_starcoder2_head_shape(cuda, quant, paged):
    """K6 and K6p at starcoder2-7b's decode shape (36 query heads over 4
    KV heads: g = 9, D = 128; the generic form, which the slot engine runs
    on it), as the nemotron case above."""
    _head_shape_case(cuda, 71, 4, 9, 128, quant, paged)


def test_decode_attn_paged_bf16_nan_and_lengths_past_the_table(cuda):
    rng = np.random.default_rng(9)
    lens = [64, 0, 33, 5]
    q, k, v, table, lengths, _ = _paged_case(rng, cuda, lens, 8, 2, 2, 32,
                                             False, 0)
    kb, vb = k.bfloat16(), v.bfloat16()
    out = _launched("decode_attn_paged", lambda: ops.decode_attn_paged(
        q, kb, vb, table, lengths, block_t=16))
    torch.testing.assert_close(
        out, ref.decode_attn_paged(q, kb, vb, table, lengths),
        rtol=1e-5, atol=1e-5)
    # a length beyond the table's reach reads only the table's positions
    long = torch.tensor([10**6, 0, 33, 5], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        ops.decode_attn_paged(q, k, v, table, long),
        ops.decode_attn_paged(q, k, v, table, torch.clamp(
            long, max=table.shape[1] * 8)), rtol=0, atol=0)
    for quant in (False, True):
        q, k, v, table, lengths, kw = _paged_case(rng, cuda, lens, 8, 2, 2,
                                                  32, quant, 16)
        pg = int(table[2, 0])                    # row 2's token 3
        if quant:
            kw["k_scale"][pg, 3] = float("nan")
        else:
            k[pg, 3] = float("nan")
        out = _launched("decode_attn_paged", lambda: ops.decode_attn_paged(
            q, k, v, table, lengths, block_t=16, **kw))
        assert torch.isnan(out[2]).all()          # the NaN row propagates
        assert torch.isfinite(out[[0, 3]]).all()
        assert torch.equal(out[1], torch.zeros_like(out[1]))
        torch.testing.assert_close(
            out, ref.decode_attn_paged(q, k, v, table, lengths, **kw),
            rtol=1e-5, atol=1e-5, equal_nan=True)


# K6 and K6p split each row over its tokens (ops.decode_attn_splits) and
# merge the splits in split order. block_t values that give 1, 2, 3, 5, 9,
# 19, 34 and 38 splits (the cap for 7 rows of 2 KV heads on 132 SMs) at
# T = 300, not a multiple of any chunk but 300
K6_SPLIT_BLOCKS = (300, 256, 100, 64, 37, 16, 9, 1)
# INT8 group by D; D = 20 rows are 80, 40 and 20 bytes, so f32, bf16 and
# INT8 take the 16-, 8- and 4-byte copies, and group 4 gives odd plane rows
K6_GROUPS = {16: 8, 20: 4, 32: 32, 64: 64, 128: 32, 256: 64}


def _k6_case(rng, dev, lens, t, hk, g, d, kind):
    q, (k, v), kw = _kv_case(rng, dev, len(lens), t, hk, g, d, kind == "u8",
                             K6_GROUPS[d])
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, lengths, kw


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _as_pages(x, perm, page):
    """Slot rows (B, T, ...) cut into pages of ``page`` positions, row b's
    page j at pool page perm[b·T/page + j]."""
    b, t = x.shape[:2]
    pool = torch.empty((b * t // page, page) + tuple(x.shape[2:]),
                       dtype=x.dtype, device=x.device)
    pool[perm] = x.reshape(pool.shape)
    return pool


def _off_by_2(x):
    """A contiguous copy of the f16 plane ``x`` whose data lies 2 bytes
    past a 4-byte boundary (the planes' element-wise copies)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 4 == 2
    return y


@pytest.mark.parametrize("kind", ["f32", "bf16", "u8"])
@pytest.mark.parametrize("g,d", [(1, 16), (3, 32), (4, 64), (8, 128),
                                 (16, 64), (32, 32), (4, 256), (12, 64),
                                 (2, 20), (16, 128), (32, 64)])
def test_decode_attn_every_split_count(cuda, kind, g, d):
    """Every split count of K6_SPLIT_BLOCKS, rows ending at, beside and
    past the split boundaries: within 1e-5 of the plain version, two
    launches the same bits, the length-0 row exact zeros, and K6p the same
    bits as K6 on the same rows cut into shuffled pages of 5 positions.
    The (g, D) cover the fast form (g ≤ 4, D ≤ 128) and the generic one
    (g > 4 or D > 128, up to g = 32 and g·D = 2048: qwen3-moe's g = 16 at
    D = 128 among them); INT8 rows also run
    with plane views 2 bytes off a 4-byte boundary, which must give the
    same bits."""
    rng = np.random.default_rng(20 + g)
    t, hk, b, page = 300, 2, 7, 5
    seen = []
    for block_t in K6_SPLIT_BLOCKS:
        chunk, splits = ops.decode_attn_splits(b, hk, t, block_t,
                                               ops._sms(cuda))
        lens = [0, 1, min(chunk - 1, t), min(chunk + 1, t),
                min(2 * chunk, t), t - 1, t]
        q, k, v, lengths, kw = _k6_case(rng, cuda, lens, t, hk, g, d, kind)
        out = _launched("decode_attn", lambda: ops.decode_attn(
            q, k, v, lengths, block_t=block_t, **kw))
        want = ref.decode_attn(q, k, v, lengths, **kw)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        assert _same_bits(out, ops.decode_attn(q, k, v, lengths,
                                               block_t=block_t, **kw))
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        perm = torch.from_numpy(rng.permutation(b * t // page)).to(cuda)
        table = perm.to(torch.int32).reshape(b, t // page).contiguous()
        pkw = {n: _as_pages(x, perm, page) if torch.is_tensor(x) else x
               for n, x in kw.items()}
        paged = _launched("decode_attn_paged", lambda: ops.decode_attn_paged(
            q, _as_pages(k, perm, page), _as_pages(v, perm, page), table,
            lengths, block_t=block_t, **pkw))
        assert _same_bits(paged, out), (block_t, g, d, kind)
        if kind == "u8":
            off = {n: _off_by_2(x) if torch.is_tensor(x) else x
                   for n, x in kw.items()}
            assert _same_bits(ops.decode_attn(
                q, k, v, lengths, block_t=block_t, **off), out)
        seen.append(splits)
    assert seen == [1, 2, 3, 5, 9, 19, 34, 38]


@pytest.mark.parametrize("kind", ["f32", "bf16", "u8"])
def test_decode_attn_one_long_row(cuda, kind):
    """B = 1 with one 2,048-token row (8 splits of 256 tokens a KV head),
    and the same row cut one token short."""
    rng = np.random.default_rng(30)
    for n in (2048, 2047):
        q, k, v, lengths, kw = _k6_case(rng, cuda, [n], 2048, 8, 4, 64, kind)
        out = _launched("decode_attn", lambda: ops.decode_attn(
            q, k, v, lengths, **kw))
        torch.testing.assert_close(out, ref.decode_attn(q, k, v, lengths,
                                                        **kw),
                                   rtol=1e-5, atol=1e-5)
        assert _same_bits(out, ops.decode_attn(q, k, v, lengths, **kw))


@pytest.mark.parametrize("kind", ["f32", "bf16", "u8"])
@pytest.mark.parametrize("page", [4, 5, 8, 16])
def test_decode_attn_paged_equals_slot_every_page(cuda, page, kind):
    """K6p on shuffled, shared pages with sentinel tails, split as K6 splits
    rows of n_pages·page positions: the same bits as K6 on the gathered
    rows, within 1e-5 of the plain version, two launches the same bits."""
    rng = np.random.default_rng(40 + page)
    lens = [0, 1, 17, 150, 299, 300]
    q, k, v, table, lengths, kw = _paged_case(
        rng, cuda, lens, page, 2, 4, 64, kind == "u8", 64)
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    for block_t in (256, 64, 9):
        out = _launched("decode_attn_paged", lambda: ops.decode_attn_paged(
            q, k, v, table, lengths, block_t=block_t, **kw))
        torch.testing.assert_close(
            out, ref.decode_attn_paged(q, k, v, table, lengths, **kw),
            rtol=1e-5, atol=1e-5)
        rows = {n: ref.gather_pages(x, table) for n, x in kw.items()
                if torch.is_tensor(x)}
        slot = ops.decode_attn(q, ref.gather_pages(k, table),
                               ref.gather_pages(v, table), lengths,
                               block_t=block_t, **dict(kw, **rows))
        assert torch.equal(out, slot), (block_t, page, kind)
        assert _same_bits(out, ops.decode_attn_paged(
            q, k, v, table, lengths, block_t=block_t, **kw))
        assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("kind", ["f32", "bf16", "u8"])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_attn_nan_token_in_a_later_split(cuda, kind, paged):
    """A NaN token in the third split of one row, at KV head 1: that row's
    query heads of KV head 1 are NaN and nothing else moves; lengths past
    T (K6) or past the table (K6p) read only the positions there are."""
    rng = np.random.default_rng(50)
    hk, g, d, block_t = 2, 3, 32, 16
    lens = [40, 0, 37, 5]
    if paged:
        q, k, v, table, lengths, kw = _paged_case(
            rng, cuda, lens, 8, hk, g, d, kind == "u8", 32)
        if kind == "bf16":
            k, v = k.bfloat16(), v.bfloat16()
        pos = (int(table[2, 35 // 8]), 35 % 8)
        run = lambda kk, kw_, n: ops.decode_attn_paged(     # noqa: E731
            q, kk, v, table, n, block_t=block_t, **kw_)
        reach = table.shape[1] * 8
    else:
        q, k, v, lengths, kw = _k6_case(rng, cuda, lens, 40, hk, g, d, kind)
        pos = (2, 35)
        run = lambda kk, kw_, n: ops.decode_attn(           # noqa: E731
            q, kk, v, n, block_t=block_t, **kw_)
        reach = 40
    clean = run(k, kw, lengths)
    if kind == "u8":
        bad_kw = dict(kw, k_scale=kw["k_scale"].clone())
        bad_kw["k_scale"][pos[0], pos[1], 1] = float("nan")
        bad = run(k, bad_kw, lengths)
    else:
        bad_k = k.clone()
        bad_k[pos[0], pos[1], 1] = float("nan")
        bad = run(bad_k, kw, lengths)
    keep = torch.ones(bad.shape[:2], dtype=torch.bool, device=cuda)
    keep[2, g:2 * g] = False
    assert torch.isnan(bad[2, g:2 * g]).all()
    assert torch.equal(bad[keep], clean[keep])
    long = torch.tensor([10**6, 0, 37, 5], dtype=torch.int32, device=cuda)
    assert torch.equal(run(k, kw, long), run(k, kw, torch.clamp(
        long, max=reach)))


def test_spill_restore_round_trip_on_the_card(cuda):
    """Pages of INT8 pools spilled to the host in one transfer and restored
    into other pages in one upload hold the same bytes."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.serving.kv_cache import (init_paged_storage,
                                              take_pages, write_pages)
    from repro_torch.serving.paging import restore_pages, spill_pages
    cfg = get_tiny_config("llama32-1b")
    kv = init_paged_storage(cfg, 12, 8, quantized=True, device=cuda)
    rng = np.random.default_rng(10)
    x = _randn(rng, (cfg.num_layers, 2, 24, cfg.num_kv_heads,
                     cfg.resolved_head_dim), cuda)
    write_pages(kv, np.array([[3, 9, 1], [0, 12, 12]]), x, x * 2, 8)
    src, dst = [9, 3, 0, 1], [5, 11, 2, 7]
    before = [t.clone() for n in ("k", "v") for t in take_pages(kv[n], src)]
    restore_pages(kv, dst, spill_pages(kv, src))
    after = [t for n in ("k", "v") for t in take_pages(kv[n], dst)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


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
    table = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.decode_attn_paged(q, kv, kv, table.cpu(), lengths)
    with pytest.raises(TypeError):
        ops.decode_attn_paged(q, kv, kv, table.long(), lengths)


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


def test_paged_engine_waits_on_the_card_once_a_step(cuda):
    """The paged engine waits on the card once a decode step, batched
    prefill, chunked prompt and preemption (a spill's one transfer); a
    resume's upload does not wait. A pool of 7 four-token pages for 3
    slots preempts; a shared prefix hits the cache; INT8 pools, so K5 (the
    chunked prompts) and K6p (every decode step) run."""
    import warnings

    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, EngineConfig, GenerationRequest

    cfg = get_tiny_config("llama32-1b")
    model = build_model(cfg)
    eng = Engine(model, model.init(0, device=cuda), EngineConfig(
        num_slots=3, max_len=24, prompt_buckets=(4, 8), kv_quantized=True,
        kv_layout="paged", page_size=4, num_pages=7))
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, 9).astype(np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 7, 3)]
    prompts += [np.concatenate([shared, [7, 8]]).astype(np.int32),
                np.concatenate([shared, [9]]).astype(np.int32)]
    reqs = [GenerationRequest(rid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, [9, 8, 10, 4, 4]))]
    eng.warmup(reqs)
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r in reqs:
                eng.submit(r)
            got = []
            while not eng.scheduler.idle:
                eng.step()
                eng.check_invariants()
            got, eng._done = eng._done, []
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in caught if SYNC_WARNING in str(w.message)]
    stats = eng.page_stats()
    assert len(waits) == (eng.decode_steps + eng.prefill_dispatches
                          + eng.chunked_admitted + eng.preemptions), \
        sorted({f"{w.filename}:{w.lineno}" for w in waits})
    assert stats["preemptions"] >= 1 and stats["resumes"] == \
        stats["preemptions"]
    assert stats["prefix_hits"] >= 1
    assert all(r.status == "ok" for r in got) and len(got) == 5
    assert ops.LAUNCHES["decode_attn_paged"] == \
        cfg.num_layers * eng.decode_steps
    assert ops.LAUNCHES["kv_dequant"] > 0 and ops.LAUNCHES["decode_attn"] == 0


def _obs_engine(cuda, layout, registry=None):
    """A tiny INT8 engine of either layout on packed weights (wo pruned,
    the other linears int4, so K4 runs) and its requests: the slot
    engine's trace has a chunked prompt; the paged engine's pool of 7
    four-token pages for 3 slots preempts, and a shared prefix hits."""
    from repro_torch.checkpoint import pack_params
    from repro_torch.configs import get_tiny_config
    from repro_torch.core.compress import compress_model
    from repro_torch.core.specs import Policy, PruneSpec, QuantSpec
    from repro_torch.data import DataConfig, calibration_batches
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, EngineConfig, GenerationRequest

    cfg = get_tiny_config("llama32-1b")
    model = build_model(cfg)
    calib = [{"tokens": torch.as_tensor(t, device=cuda)}
             for t, _ in calibration_batches(DataConfig(
                 vocab_size=cfg.vocab_size, seq_len=16, global_batch=4), 1)]
    params = pack_params(*compress_model(
        model, model.init(0, device=cuda), calib,
        Policy({"*.attn.wo": PruneSpec(ratio=0.5)},
               default=QuantSpec(bits=4, group_size=64))))
    rng = np.random.default_rng(0)
    if layout == "slots":
        ecfg = EngineConfig(num_slots=4, max_len=64, prompt_buckets=(8, 16),
                            kv_quantized=True)
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 12, 40, 7, 3)]
        gens = [6, 4, 5, 8, 3]
    else:
        ecfg = EngineConfig(num_slots=3, max_len=24, prompt_buckets=(4, 8),
                            kv_quantized=True, kv_layout="paged",
                            page_size=4, num_pages=7)
        shared = rng.integers(1, cfg.vocab_size, 9).astype(np.int32)
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 7, 3)]
        prompts += [np.concatenate([shared, [7, 8]]).astype(np.int32),
                    np.concatenate([shared, [9]]).astype(np.int32)]
        gens = [9, 8, 10, 4, 4]
    reqs = [GenerationRequest(rid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    eng = Engine(model, params, ecfg, registry=registry)
    eng.warmup(reqs)
    return eng, reqs


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_profiled_engine_trace_holds_the_kernel_events(cuda, layout,
                                                       tmp_path):
    """A ``StepTraceWindow`` around a whole engine run records CUDA
    activity: its trace holds K4's GEMV and tile kernels as often as
    ``dequant_matmul`` launched, and K6's or K6p's split kernel as often
    as ``decode_attn`` or ``decode_attn_paged`` did."""
    import json

    from repro_torch.obs import StepTraceWindow

    eng, reqs = _obs_engine(cuda, layout)
    win = StepTraceWindow(str(tmp_path), 10**6)
    ops.reset_launches()
    win.start()
    assert win.active
    for r in reqs:
        eng.submit(r)
    got = eng.run(step_hook=win.on_step)
    torch.cuda.synchronize()
    win.stop()
    assert win.path and all(r.status == "ok" for r in got)
    events = json.load(open(win.path))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k6 = "decode_attn" if layout == "slots" else "decode_attn_paged"
    assert sum("dequant_gemv_kernel" in k or "dequant_gemm_kernel" in k
               for k in kernels) == ops.LAUNCHES["dequant_matmul"] > 0
    assert sum("decode_split_kernel" in k for k in kernels) == \
        ops.LAUNCHES[k6] > 0
    steps = {e["name"] for e in events
             if e.get("name", "").startswith("ProfilerStep#")}
    assert len(steps) >= eng.decode_steps


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_engine_with_registry_waits_once_a_step(cuda, layout):
    """With the registry on (traces, histograms, counters) the engine still
    waits on the card once a decode step, batched prefill, chunked prompt
    and preemption, and its snapshot agrees with its counters."""
    import warnings

    from repro_torch.obs import MetricsRegistry, snapshot_series

    reg = MetricsRegistry()
    eng, reqs = _obs_engine(cuda, layout, registry=reg)
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
                          + eng.chunked_admitted + eng.preemptions), \
        sorted({f"{w.filename}:{w.lineno}" for w in waits})
    assert all(r.status == "ok" and r.trace.validate() for r in got)
    snap = eng.metrics_snapshot()
    assert snapshot_series(snap, "counters", "engine_decode_steps_total"
                           )["value"] == eng.decode_steps
    assert snapshot_series(snap, "histograms", "request_ttft_seconds"
                           )["count"] == len(reqs)
    if layout == "paged":
        assert eng.preemptions >= 1 and eng.prefix_hits >= 1


# ---- the evaluation slice: the OBS baselines in f64 on the card, the
# ---- scale searches on the kernels, llama2-7b's new kernel shapes

def _obs_problem(rng, d_out, d_in):
    x = rng.standard_normal((2 * d_in, d_in)) * np.exp(
        rng.normal(0, 0.7, d_in))
    w = torch.from_numpy(rng.standard_normal((d_out, d_in)).astype(
        np.float32))
    c = torch.from_numpy((x.T @ x / x.shape[0]).astype(np.float32))
    return w, c


@pytest.mark.parametrize("d_in", [384, 600])
def test_sparsegpt_on_the_card_matches_the_cpu(cuda, d_in):
    """The same f64 algorithm on CUDA and on the CPU: masks equal, θ
    within 1e-5 (cuSOLVER's inverse and Cholesky differ from LAPACK's in
    the last bits)."""
    from repro_torch.core.baselines import sparsegpt
    w, c = _obs_problem(np.random.default_rng(60), 96, d_in)
    k = d_in // 2
    got = sparsegpt.prune_weight(w.to(cuda), c.double().to(cuda), k).cpu()
    want = sparsegpt.prune_weight(w, c.double(), k)
    assert torch.equal(got != 0, want != 0)
    assert int((got != 0).sum(1).max()) <= k
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d_in,group", [(384, 128), (600, 40)])
def test_gptq_on_the_card_matches_the_cpu(cuda, d_in, group):
    """Codes on ≥ 99.99% of entries, each differing code one step; grids
    within 1e-6 relative."""
    from repro_torch.core.baselines import gptq
    w, c = _obs_problem(np.random.default_rng(61), 96, d_in)
    got = gptq.quantize_weight(w.to(cuda), c.double().to(cuda), 4, group,
                               return_qparams=True)
    want = gptq.quantize_weight(w, c.double(), 4, group, return_qparams=True)
    codes, wcodes = got[1].cpu(), want[1]
    assert float((codes == wcodes).double().mean()) >= 0.9999
    assert float((codes - wcodes).abs().max()) <= 1
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-6, atol=0)


def test_scale_searches_on_the_kernels_match_plain(cuda):
    """AWQ (K3 for each α) and AWP-S (K1 and K3 inside each α's PGD) on
    the kernels against the same calls through the plain versions: AWQ's
    output and scale the same bits (K3 is exact), AWP-S's loss within
    1e-5 and θ within 2e-4 (K1 sums in its own order)."""
    from repro_torch import kernels
    from repro_torch.core import awp
    from repro_torch.core.baselines import awq
    rng = np.random.default_rng(62)
    w, c = (t.to(cuda) for t in _obs_problem(rng, 256, 512))
    am = torch.diagonal(c).sqrt()
    ops.reset_launches()
    wq, s = awq.quantize_weight_with_scale(w, c, am, 4, 128)
    res = awp.quantize_scaled(w, c, am, 4, group_size=128)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["quant_project"] == 21 + 21 * 11
    assert ops.LAUNCHES["awp_pgd_step"] == 21 * 10
    with kernels.use_impl("reference"):
        wq_p, s_p = awq.quantize_weight_with_scale(w, c, am, 4, 128)
        res_p = awp.quantize_scaled(w, c, am, 4, group_size=128)
    assert torch.equal(wq, wq_p) and torch.equal(s, s_p)
    assert abs(float(res.grad_norm) - float(res_p.grad_norm)) <= \
        1e-5 * float(res_p.grad_norm)
    torch.testing.assert_close(res.theta, res_p.theta, rtol=2e-4, atol=2e-4)


def test_topk_row_at_llama2_d_ff(cuda):
    """K2 on rows of 11,008 (llama2-7b's wd, 86 groups of 128): the
    streaming form, every form, against the plain version."""
    rng = np.random.default_rng(63)
    z = _randn(rng, (64, 11008), cuda)
    for k in (1, 5504, 11007):
        _k2_variants(z, k, ref.topk_row(z, k))


@pytest.mark.parametrize("n,k", [(11008, 4096), (4096, 11008)])
@pytest.mark.parametrize("m", [8, 512])
def test_dequant_matmul_at_llama2_shapes(cuda, m, n, k):
    """K4 at llama2-7b's {wg, wu} and wd: N or K = 11008 = 86 × 128, not
    a multiple of 256; every variant against the plain version."""
    rng = np.random.default_rng(64)
    x, packed, scale, zero = _k4_operands(rng, m, n, k, 128, cuda)
    y_ref = ref.dequant_matmul(x, packed, scale, zero, 128)
    for v in ops.dequant_matmul_variants(m, k):
        y = _launched("dequant_matmul", lambda: ops.dequant_matmul(
            x, packed, scale, zero, 128, variant=v))
        _k4_close(y, y_ref)


def _tiny_setup(dev, remat):
    """The tiny llama32 model's AdamW step, its train state (made on the
    CPU from seed 0 and moved to ``dev``) and its batch generator."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.data import DataConfig, ZipfMarkov
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    model = build_model(get_tiny_config("llama32-1b"), remat=remat)
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=20))
    state = _tree_to(init_train_state(model, 0, device="cpu", tcfg=tcfg),
                     dev)
    step, _ = make_train_step(model, tcfg)
    gen = ZipfMarkov(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32,
                                global_batch=8))
    return step, state, gen


def _tiny_run(step, state, gen, dev, start, n):
    from repro_torch.launch.train import device_batch
    metrics = None
    for i in range(start, start + n):
        state, metrics = step(state, device_batch(gen, i, dev))
    return state, metrics


def _tiny_train(dev, steps, remat):
    step, state, gen = _tiny_setup(dev, remat)
    return _tiny_run(step, state, gen, dev, 0, steps)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_tiny_train_step_on_the_card_matches_the_cpu(cuda):
    """One AdamW step of the tiny config with remat on the card against the
    same step on the CPU: loss and grad_norm within 1e-5 relative, every
    parameter within 1e-5 but the near-zero gradients whose sign the two
    devices' sums part (at most 1 in 1,000 entries, within 2·lr)."""
    got, gm = _tiny_train(cuda, 1, remat=True)
    want, wm = _tiny_train(torch.device("cpu"), 1, remat=True)
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-5 * abs(float(wm[k]))
    flips, total = 0, 0
    for (key, a), (_, b) in zip(_flat(want["params"]), _flat(got["params"])):
        d = (a - b.cpu()).abs()
        assert float(d.max()) <= 2e-3 + 1e-5, key
        flips += int((d > 1e-5).sum())
        total += d.numel()
    assert flips <= total // 1000
    assert int(got["step"]) == 1 and got["step"].device.type == "cuda"


def test_train_step_never_waits_on_the_card(cuda):
    """Train steps on the card read nothing on the host: in sync-debug mode
    the steps after the first raise no synchronizing-operation warning."""
    import warnings
    step, state, gen = _tiny_setup(cuda, remat=True)
    state, _ = _tiny_run(step, state, gen, cuda, 0, 1)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _tiny_run(step, state, gen, cuda, 1, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in caught if SYNC_WARNING in str(w.message)]
    assert not waits, [f"{w.filename}:{w.lineno}" for w in waits]


# ---------------------------------------------------------------------------
# the SSM and hybrid families: both blocks and the packed tiny models
# ---------------------------------------------------------------------------

SSM_ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]


def _to(tree, dev):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t.to(dev), tree)


# f32 on both devices with TF32 off: the products sum in other orders, so
# agreement to a few ulps of each sum, hence 1e-4 relative / 1e-5 absolute
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_block_on_the_card_matches_the_cpu(cuda, arch):
    """A Mamba-1 or Mamba-2 block at chunk 8 over 20 tokens (a padded last
    chunk) from a random state: output, new conv and SSM state on the card
    against the CPU."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model
    cfg = get_tiny_config(arch)
    model = build_model(cfg)
    model.scan_chunk = 8
    params = model.block_slice(model.init(0, device="cpu"), 1)
    rng = np.random.default_rng(40)
    x = _randn(rng, (2, 20, cfg.d_model), "cpu")
    cache = model.init_cache(2, 1, device="cpu")
    state = {k: _randn(rng, cache[k][0].shape, "cpu") for k in ("conv", "ssm")}
    for st in (None, state):
        want = model._block(params, x, state=st)
        got = model._block(_to(params, cuda), x.to(cuda),
                           state=None if st is None else _to(st, cuda))
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4,
                                   atol=1e-5)
        if st is not None:
            for k in ("conv", "ssm"):
                torch.testing.assert_close(got[1][k].cpu(), want[1][k],
                                           rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_packed_ssm_model_on_the_kernels_matches_plain(cuda, arch):
    """The tiny model compressed on the card (AWP int4, group 32) and
    packed: its logits, prefill and a decode step through K4 against the
    same through the plain versions, within 1e-4; K4 at every packed
    linear."""
    from repro_torch import kernels
    from repro_torch.checkpoint import pack_params
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import specs
    from repro_torch.core.compress import compress_model
    from repro_torch.models import build_model
    cfg = get_tiny_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab_size, (2, 12))).to(cuda)
    cp, rep = compress_model(model, params, [{"tokens": toks}],
                             specs.QuantSpec(bits=4, group_size=32))
    packed = pack_params(cp, rep)

    def run():
        cache = model.init_cache(2, 14, device=cuda)
        logits, cache = model.prefill(packed, {"tokens": toks}, cache)
        step, _ = model.decode_step(packed, toks[:, :1], cache)
        return model.logits(packed, {"tokens": toks}), logits, step
    ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    per_forward = len(rep.packed_layers())
    if cfg.family == "hybrid":      # the shared block's 6 at each invocation
        per_forward += 6 * (len(model._groups()) - 1)
    assert ops.LAUNCHES["dequant_matmul"] == 3 * per_forward
    with kernels.use_impl("reference"):
        want = run()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the audio and vlm frontends: the packed tiny models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-1b"])
def test_packed_frontend_model_on_the_kernels_matches_plain(cuda, arch):
    """The tiny model compressed on the card from the port's ``make_batch``
    (mixed policy at group 32: wo AWP-pruned, the rest AWP-int4) and
    packed: its logits, loss and prefill from frames or patches (and, for
    the vlm, a decode step) through K4 against the same through the plain
    versions, within 1e-4; K4 at every packed linear of every forward."""
    from repro_torch import kernels
    from repro_torch.checkpoint import pack_params
    from repro_torch.configs import get_tiny_config
    from repro_torch.core import specs
    from repro_torch.core.compress import compress_model
    from repro_torch.models import build_model, make_batch
    cfg = get_tiny_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(42)
    batch = make_batch(cfg, gen, 2, 12 + cfg.num_patches, device=cuda)
    policy = specs.Policy({"*.attn.wo": specs.PruneSpec(ratio=0.5)},
                          default=specs.QuantSpec(bits=4, group_size=32))
    cp, rep = compress_model(model, params, [batch], policy)
    packed = pack_params(cp, rep)
    inputs = {k: v for k, v in batch.items() if k != "labels"}

    def run():
        out = [model.logits(packed, inputs), model.loss(packed, batch)[0]]
        cache = model.init_cache(2, 14 + cfg.num_patches, device=cuda)
        logits, cache = model.prefill(packed, inputs, cache)
        out.append(logits)
        if cfg.frontend == "vision_patches":
            out.append(model.decode_step(packed, batch["tokens"][:, :1],
                                         cache)[0])
        return out
    ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_matmul"] == len(got) * len(
        rep.packed_layers())
    with kernels.use_impl("reference"):
        want = run()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the multi-device slice on one card: a one-rank NCCL group (NCCL refuses
# two ranks on one device, so every collective is the identity)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl(cuda, tmp_path):
    """A one-rank NCCL group and a (1, 1) ("data", "model") mesh on card
    0; destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ShardingRules
    if not dist.is_nccl_available():
        pytest.skip("torch.distributed has no NCCL")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield ShardingRules.for_mesh(make_mesh((1, 1), ("data", "model"),
                                               device=cuda))
    finally:
        dist.destroy_process_group()


def test_sharded_awp_on_one_rank_matches_unsharded(cuda, nccl):
    """Row-sharded AWP (K1, K2) gives the bits of the compression path's
    own unsharded loop (``core.awp.pgd``); the column-sharded loop (K2)
    that loop's through the plain versions."""
    from repro_torch import kernels
    from repro_torch.core import awp
    from repro_torch.core import distributed as D
    rng = np.random.default_rng(0)
    w = _randn(rng, (64, 256), cuda)
    x = _randn(rng, (512, 256), cuda)
    c = D.calib_c_distributed(x, nccl)
    torch.testing.assert_close(c, x.T @ x / 512, rtol=1e-6, atol=1e-6)
    eta = float(awp._eta(c, 2.0))

    def unsharded():
        theta0 = kernels.impl("topk_row")(w, 128)
        return awp.pgd(w, c, awp.prune_projection(128), theta0,
                       awp.PGDConfig(max_iters=5, tol=0.0)).theta
    before = dict(ops.LAUNCHES)
    row = D.awp_prune_rowsharded(w, c, 128, eta, 5, nccl)
    assert ops.LAUNCHES["awp_pgd_step"] == before["awp_pgd_step"] + 5
    assert ops.LAUNCHES["topk_row"] == before["topk_row"] + 6
    assert torch.equal(row, unsharded())
    col = D.awp_prune_colsharded_fn(128, eta, 5, nccl)(w, c)
    with kernels.use_impl("reference"):
        plain = unsharded()
    assert torch.equal(col, plain)


def test_ddp_and_sharded_steps_on_one_rank(cuda, nccl):
    """On the tiny llama32: the DDP step (plain sync) is the plain step's
    bits, and the DTensor step is within the reference's bars."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.sharding import NamedSharding, distribute, full_tensor
    from repro_torch.training.train_loop import (
        TrainConfig, init_train_state, make_train_step, make_train_step_ddp,
        shard_train_state, sharded_step)
    cfg = get_tiny_config("llama32-1b")
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3))
    model = build_model(cfg, remat=False)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                              device=cuda) for k in ("tokens", "labels")}
    outs = []
    for make in (lambda: make_train_step(model, tcfg)[0],
                 lambda: make_train_step_ddp(model, tcfg, nccl)[0]):
        state = init_train_state(model, 0, device=cuda, tcfg=tcfg)
        outs.append(make()(state, batch))
    (s1, m1), (s2, m2) = outs
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(s1["params"]["blocks"]["attn"].values(),
                    s2["params"]["blocks"]["attn"].values()):
        assert torch.equal(a, b)
    m_sh = build_model(cfg, nccl, remat=False)
    step, _ = make_train_step(m_sh, tcfg)
    st = shard_train_state(init_train_state(model, 0, device=cuda, tcfg=tcfg),
                           m_sh, nccl)
    sb = {k: distribute(v, NamedSharding(nccl.mesh, nccl.spec(
        ("batch", None), v.shape))) for k, v in batch.items()}
    s3, m3 = sharded_step(step)(st, sb)
    assert abs(float(full_tensor(m3["loss"])) - float(m1["loss"])) < 2e-4
    torch.testing.assert_close(full_tensor(s3["params"]["embed"]),
                               s1["params"]["embed"], rtol=2e-3, atol=2e-4)


def test_moe_a2a_packed_experts_on_one_rank(cuda, nccl):
    """The a2a MoE FFN on packed experts launches K4x three times and
    equals the masked dense path within 2e-4 (tiny qwen3-moe, capacity 8)."""
    import dataclasses
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import moe
    from repro_torch.quant import QTensor
    cfg = dataclasses.replace(get_tiny_config("qwen3-moe-235b-a22b"),
                              capacity_factor=8.0)
    g = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_params(g, cfg, device=cuda)

    def pack(w):
        qts = [QTensor.from_dense(w[e].T.contiguous(), bits=4, group_size=32)
               for e in range(w.shape[0])]
        return qts[0]._replace(**{f: torch.stack([getattr(q, f) for q in qts])
                                  for f in ("packed", "scale", "zero")})
    pq = dict(p, **{k: pack(p[k]) for k in ("wg", "wu", "wd")})
    x = torch.randn((2, 64, cfg.d_model), generator=g, device=cuda)
    before = ops.LAUNCHES["dequant_matmul_experts"]
    y = moe.moe_apply_a2a(pq, x, cfg, nccl)
    assert ops.LAUNCHES["dequant_matmul_experts"] == before + 3
    torch.testing.assert_close(y, moe.moe_apply_dense(pq, x, cfg),
                               rtol=2e-4, atol=2e-4)
    assert moe.a2a_dropped(pq, x, cfg, nccl) == 0


def test_sampler_on_the_card_matches_the_probe(cuda):
    """The reference's probe tokens from the card's Threefry and Gumbel
    map (logits default_rng(0) (8, 1000) × 3, seeds and steps 0–7)."""
    from repro_torch.serving import sample_tokens
    logits = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (8, 1000)) * 3).astype(np.float32)).to(cuda)
    got = sample_tokens(logits, torch.ones(8, device=cuda),
                        torch.zeros(8, dtype=torch.int64, device=cuda),
                        torch.arange(8, device=cuda),
                        torch.arange(8, device=cuda))
    assert got.tolist() == [403, 615, 175, 801, 251, 427, 83, 543]
