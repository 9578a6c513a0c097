"""The port's packed int4 QTensor and the plain version of kernel K4
against the JAX package on the CPU.

Packed bytes and codes must be identical (the checkpoint format is shared);
the dequant-matmul agrees to 2e-4 (f32 sums in another order). The JAX
``from_dense`` is compiled here, as every caller of it on the reference's
compression path compiles the quantizer (see ``inv_qmax``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.kernels import dequant_matmul as jdq_kernel, ops as jops
from repro.quant import QTensor as JQTensor, pack_int4 as jpack
from repro.quant import unpack_int4 as junpack
from repro_torch.bridge import qtensor_from_numpy
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.quant import QTensor, matmul_impl, pack_int4, unpack_int4


def _qt_pair(d_out=48, d_in=256, bits=4, group=128, col_scale=False, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_out, d_in)).astype(np.float32)
    s = (np.exp(rng.standard_normal(d_in)).astype(np.float32)
         if col_scale else None)
    jqt = jax.jit(JQTensor.from_dense, static_argnums=(1, 2))(
        jnp.asarray(w), bits, group,
        None if s is None else jnp.asarray(s))
    qt = QTensor.from_dense(torch.from_numpy(w), bits, group,
                            None if s is None else torch.from_numpy(s))
    return w, qt, jqt


def test_pack_int4_bytes_match_jax():
    codes = np.random.default_rng(1).integers(0, 16, (3, 8, 64), np.uint8)
    packed = pack_int4(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8
    assert_array_equal(packed.numpy(), np.asarray(jpack(jnp.asarray(codes))))
    assert_array_equal(unpack_int4(packed).numpy(), codes)
    assert_array_equal(unpack_int4(packed).numpy(),
                       np.asarray(junpack(jpack(jnp.asarray(codes)))))
    assert int(packed[0, 0, 0]) == int(codes[0, 0, 0]) | int(codes[0, 0, 1]) << 4


@pytest.mark.parametrize("bits,group,col_scale", [
    (4, 128, False), (4, 64, True), (3, 128, False), (8, 128, False)])
def test_from_dense_codes_match_jax(bits, group, col_scale):
    _, qt, jqt = _qt_pair(bits=bits, group=group, col_scale=col_scale)
    assert qt.shape == tuple(jqt.shape) and qt.bits == jqt.bits
    assert_array_equal(qt.packed.numpy(), np.asarray(jqt.packed))
    assert_array_equal(qt.codes().numpy(), np.asarray(jqt.codes()))
    assert_array_equal(qt.scale.numpy(), np.asarray(jqt.scale))
    assert_array_equal(qt.zero.numpy(), np.asarray(jqt.zero))
    assert_array_equal(qt.dequant().numpy(), np.asarray(jqt.dequant()))
    assert qt.nbytes() == jqt.nbytes()


def test_bridge_qtensor_matches():
    _, qt, jqt = _qt_pair(col_scale=True)
    mine = qtensor_from_numpy(jax.tree.map(np.asarray, jqt), device="cpu")
    for f in ("packed", "scale", "zero", "col_scale"):
        assert torch.equal(getattr(mine, f), getattr(qt, f))
    assert (mine.bits, mine.group_size, mine.shape) == (4, 128, qt.shape)


@pytest.mark.parametrize("m", [1, 4, 9, 40])
def test_plain_dequant_matmul_matches_jax(m):
    rng = np.random.default_rng(2)
    _, qt, jqt = _qt_pair(d_out=64, d_in=512)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    want = np.asarray(jops.dequant_matmul(jnp.asarray(x), jqt.packed,
                                          jqt.scale, jqt.zero, 128,
                                          use_pallas=False))
    y = ops.dequant_matmul(torch.from_numpy(x), qt.packed, qt.scale, qt.zero,
                           128)                                  # plain K4
    assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)
    # ... and the Pallas kernel itself, in interpret mode
    pallas = np.asarray(jdq_kernel.dequant_matmul(
        jnp.asarray(x), jqt.packed, jqt.scale, jqt.zero, group_size=128,
        bn=32, bk=256, interpret=True))
    assert_allclose(y.numpy(), pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("col_scale", [False, True])
def test_matmul_dispatch_matches_jax(col_scale):
    rng = np.random.default_rng(3)
    _, qt, jqt = _qt_pair(d_out=32, d_in=256, col_scale=col_scale, seed=4)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    want = np.asarray(jqt.matmul(jnp.asarray(x)))
    t = torch.from_numpy(x)
    for impl in ("auto", "kernel", "reference"):
        with matmul_impl(impl):
            assert_allclose(qt.matmul_dispatch(t).numpy(), want,
                            rtol=2e-4, atol=2e-4)
    assert_allclose(qt.kernel_matmul(t).numpy(),
                    np.asarray(jqt.kernel_matmul(jnp.asarray(x))),
                    rtol=2e-4, atol=2e-4)


def test_auto_impl_counts_no_launch_on_cpu():
    _, qt, _ = _qt_pair(d_out=16, d_in=128)
    before = dict(ops.LAUNCHES)
    with matmul_impl("kernel"):
        qt.matmul_dispatch(torch.ones(2, 128))
    assert ops.LAUNCHES == before          # CPU tensors take the plain version
    with pytest.raises(ValueError):
        with matmul_impl("bogus"):
            pass
    assert ref.unpack_int4 is unpack_int4


def test_matmul_impl_is_the_one_kernel_switch():
    _, qt, _ = _qt_pair(d_out=16, d_in=256, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 256)).astype(np.float32))
    assert all(kernels.impl(n) is getattr(ops, n) for n in ops.KERNELS)
    with matmul_impl("reference"):
        assert all(kernels.impl(n) is getattr(ref, n) for n in ops.KERNELS)
        # the reference matmul and K4's plain version share one body
        assert_array_equal(qt.matmul_dispatch(x).numpy(),
                           ref.dequant_matmul(x, qt.packed, qt.scale, qt.zero,
                                              qt.group_size).numpy())
    assert kernels.impl("dequant_matmul") is ops.dequant_matmul
