"""The hand-written CUDA kernels K1–K4 against their plain PyTorch versions
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
    z, nrm = _launched("awp_pgd_step", lambda: ops.awp_pgd_step(
        w, theta, c, eta))
    z_ref, nrm_ref = ref.awp_pgd_step(w, theta, c, eta)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(nrm, nrm_ref, rtol=1e-5, atol=0)


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


def test_wrappers_refuse_mixed_devices(cuda):
    z = torch.zeros(4, 256, device=cuda)
    with pytest.raises(ValueError):
        ops.awp_pgd_step(z, z.cpu(), torch.zeros(256, 256, device=cuda), 0.1)
    with pytest.raises(TypeError):
        ops.topk_row(z.double(), 3)
