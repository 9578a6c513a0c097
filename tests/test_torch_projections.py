"""The port's projections and the plain versions of kernels K2 (top-k) and
K3 (quantize-dequantize) against the JAX package, bit for bit.

Inputs are made with numpy from a seed and go through both packages on the
CPU. The JAX side runs the projections as its compiled code runs them
(``repro.kernels.ops`` with ``use_pallas=False`` is jitted), which is where
XLA turns the division by the constant qmax into a multiplication by its
f32 reciprocal — the semantics the port reproduces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import projections as jproj
from repro.kernels import ops as jops
from repro_torch.core import projections as proj
from repro_torch.kernels import ops


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":                       # few distinct magnitudes
        z = rng.integers(-3, 4, shape).astype(np.float32) * 0.5
        z[0] = 0.0                           # an all-zero row
        return z
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("k", [0, 1, 2, 63, 127, 128])
def test_topk_row_matches_jax(kind, k):
    z = _inputs(kind, (16, 128))
    want = np.asarray(jops.topk_row(jnp.asarray(z), k, use_pallas=False))
    t = torch.from_numpy(z)
    assert_array_equal(proj.topk_row(t, k).numpy(), want)
    assert_array_equal(ops.topk_row(t, k).numpy(), want)   # plain K2
    assert_array_equal(proj.topk_row_mask(t, k).numpy(),
                       np.asarray(jproj.topk_row_mask(jnp.asarray(z), k)))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("keep", [0.0, 0.004, 0.3, 0.5, 0.999, 1.0])
def test_topk_row_dynamic_matches_jax(kind, keep):
    z = _inputs(kind, (8, 256), seed=1)
    want = np.asarray(jax.jit(jproj.topk_row_dynamic)(jnp.asarray(z),
                                                       jnp.float32(keep)))
    assert_array_equal(proj.topk_row_dynamic(torch.from_numpy(z), keep).numpy(),
                       want)


@pytest.mark.parametrize("t", [0, 3, 24, 25, 80])
def test_ramp_ratio_matches_jax(t):
    want = np.asarray(jproj.ramp_ratio(jnp.int32(t), 0.6, 25))
    assert_array_equal(proj.ramp_ratio(t, 0.6, 25).numpy(), want)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quant_project_matches_jax(kind, bits):
    z = _inputs(kind, (24, 512), seed=2)
    z[3, :128] = 0.625                       # constant group: scale floor
    want = np.asarray(jops.quant_project(jnp.asarray(z), bits, 128,
                                         use_pallas=False))
    t = torch.from_numpy(z)
    assert_array_equal(proj.quant_project(t, bits, 128).numpy(), want)
    assert_array_equal(ops.quant_project(t, bits, 128).numpy(), want)  # K3


@pytest.mark.parametrize("bits,group", [(4, 128), (3, 64), (8, 32)])
def test_quant_params_matches_jax(bits, group):
    z = _inputs("random", (16, 256), seed=3)
    jq = jax.jit(jproj.quant_params, static_argnums=(1, 2))(
        jnp.asarray(z), bits, group)
    q = proj.quant_params(torch.from_numpy(z), bits, group)
    for mine, theirs in zip(q, jq):
        assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert_array_equal(proj.dequant(q).numpy(),
                       np.asarray(jproj.dequant(jq)))


def test_inv_qmax_is_f32_reciprocal():
    for bits in (2, 3, 4, 8):
        assert proj.inv_qmax(bits) == float(np.float32(1) /
                                             np.float32(2 ** bits - 1))


def _nan_rows(d, seed=4):
    """Rows that hold NaN (either sign, several payloads), ±inf and ±0.0.
    At d = 8 the reference's example row [1, NaN, -2, 0.5, inf, -inf, 3,
    -0.0] and five more; at other d, normal rows with those values strewn
    in."""
    nan_bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF,
                         0xFF800123], dtype=np.uint32).view(np.float32)
    n, inf = nan_bits[0], np.inf
    if d == 8:
        return np.array([
            [1, n, -2, 0.5, inf, -inf, 3, -0.0],
            nan_bits[[0, 1, 2, 3, 4, 0, 1, 2]],
            [nan_bits[1], nan_bits[3], inf, -inf, 1, -0.0, 0.0, 2],
            [-0.0] * 8,
            [0.0, -0.0, 0.0, -0.0, 1, -1, nan_bits[4], 0.0],
            [inf, -inf, inf, nan_bits[2], -n, 5, -5, 0.0]], np.float32)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((12, d)).astype(np.float32)
    for r in range(12):
        cols = rng.choice(d, size=r + 4, replace=False)
        z[r, cols[:r]] = nan_bits[np.arange(r) % len(nan_bits)]
        z[r, cols[r:]] = [inf, -inf, 0.0, -0.0]
    return z


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("k", [1, 2, 3, 4, -1])
def test_topk_row_nan_inf_zero_rows_match_jax(d, k):
    """The keep-set on rows that hold NaN, ±inf and ±0.0, against the JAX
    package's jnp path: NaN ranks above +inf and counts toward k but is
    never kept, a NaN k-th value keeps nothing, -0.0 ties with +0.0; the
    port's projection and the plain K2 give the same bits."""
    k = d - 1 if k < 0 else k
    z = _nan_rows(d)
    want = np.asarray(jops.topk_row(jnp.asarray(z), k, use_pallas=False))
    assert not np.isnan(want).any()
    t = torch.from_numpy(z)
    for got in (proj.topk_row(t, k), ops.topk_row(t, k)):
        assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert_array_equal(proj.topk_row_mask(t, k).numpy(),
                       np.asarray(jproj.topk_row_mask(jnp.asarray(z), k)))
