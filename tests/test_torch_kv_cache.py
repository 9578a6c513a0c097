"""The port's serving KV cache and the plain versions of K5 and K6 against
the JAX package on the CPU.

The same numpy inputs go through ``repro.serving.kv_cache`` and
``repro_torch.serving.kv_cache``. INT8 quantization is held bit for bit
against the reference's compiled (``jax.jit``) form, which multiplies by
the f32 reciprocal of 255 where its source divides. K5's plain version is
exact against the JAX kernel run in interpret mode; K6's is held to the
reference's own bar, 1e-5 (``tests/test_decode_attn.py``), against the
interpreted Pallas flash-decode, dense and INT8 (JAX's ``QuantizedKV``
carried over by the bridge).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.configs import get_tiny_config as jget_tiny
from repro.kernels import ops as jops
from repro.serving import kv_cache as J
from repro_torch.bridge import quantized_kv_from_jax
from repro_torch.configs import get_tiny_config
from repro_torch.kernels import ref
from repro_torch.serving import kv_cache as P

jit_quantize = jax.jit(J.kv_quantize, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_q(jq):
    """A JAX QuantizedKV as the port's."""
    return quantized_kv_from_jax(np.asarray(jq.codes), np.asarray(jq.scale),
                                 np.asarray(jq.zero), jq.group_size,
                                 device="cpu")


def _assert_same_q(port, jq):
    for mine, theirs in zip(port[:3], (jq.codes, jq.scale, jq.zero)):
        assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert port.group_size == jq.group_size


@pytest.mark.parametrize("group", [16, 32, 64])
def test_kv_quantize_exact_against_jitted_jax(group):
    rng = np.random.default_rng(group)
    x = (rng.standard_normal((6, 40, 2, 64))
         * rng.uniform(0.05, 20.0, (6, 40, 2, 1))).astype(np.float32)
    x[0, 0, 0, :group] = np.abs(x[0, 0, 0, :group]) + 1.0   # one-sided > 0
    x[0, 1, 0, :group] = -np.abs(x[0, 1, 0, :group]) - 1.0  # one-sided < 0
    x[0, 2, 0, :group] = 3.25                               # constant group
    x[1] = 0.0                                              # zero rows
    port = P.kv_quantize(_t(x), group)
    _assert_same_q(port, jit_quantize(jnp.asarray(x), group))
    deq = P._reference_dequant(port)
    assert float(deq[1].abs().max()) == 0.0                 # zeros stay zero
    assert_allclose(deq[0, 2, 0, :group].numpy(), 3.25, atol=0.02)
    assert float((deq - _t(x)).abs().max()) < float(port.scale.max()) * 0.51


def test_kv_update_scalar_and_vector_pos():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    base = np.zeros((2, 8, 2, 16), np.float32)
    for pos in (2, 6):                   # 6: the last column falls off the edge
        want = jax.jit(J.kv_update)(jit_quantize(jnp.asarray(base), 16),
                                    jnp.asarray(x), jnp.int32(pos))
        got = P.kv_update(P.kv_quantize(_t(base), 16), _t(x), pos)
        _assert_same_q(got, want)
    tok = x[:, :1]
    pos = np.array([1, 7], np.int32)
    want = jax.jit(J.kv_update)(jit_quantize(jnp.asarray(base), 16),
                                jnp.asarray(tok), jnp.asarray(pos))
    got = P.kv_update(P.kv_quantize(_t(base), 16), _t(tok), _t(pos))
    _assert_same_q(got, want)
    assert float(P._reference_dequant(got)[0, 2:].abs().max()) == 0.0


@pytest.mark.parametrize("quantized", [False, True])
def test_write_slot_drops_padding_rows_and_past_edge_columns(quantized):
    cfg, jcfg = get_tiny_config("llama32-1b"), jget_tiny("llama32-1b")
    rng = np.random.default_rng(2)
    t = 8
    shape = (cfg.num_layers, 3, t + 4, cfg.num_kv_heads,
             cfg.resolved_head_dim)     # W = 12 > T = 8: 4 columns dropped
    k_new = rng.standard_normal(shape).astype(np.float32)
    v_new = rng.standard_normal(shape).astype(np.float32)
    slots = np.array([2, 0, 4])         # 4 == num_slots: a padding row
    jc = J.init_slot_cache(jcfg, J.KVCacheConfig(num_slots=4, max_len=t,
                                                 quantized=quantized))
    want = jax.jit(J.write_slot)(jc, jnp.asarray(slots), jnp.asarray(k_new),
                                 jnp.asarray(v_new))
    pc = P.init_slot_cache(cfg, P.KVCacheConfig(num_slots=4, max_len=t,
                                                quantized=quantized),
                           device="cpu")
    got = P.write_slot(pc, slots, _t(k_new), _t(v_new))
    for name in ("k", "v"):
        if quantized:
            _assert_same_q(got[name], want[name])
        else:
            assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    # slot 1 and slot 3 stay untouched
    store = got["k"].codes if quantized else got["k"]
    assert not store[:, [1, 3]].any()


@pytest.mark.parametrize("quantized", [False, True])
def test_slot_rows_roundtrip(quantized):
    cfg = get_tiny_config("llama32-1b")
    cache = P.init_slot_cache(cfg, P.KVCacheConfig(num_slots=3, max_len=16,
                                                   quantized=quantized),
                              device="cpu")
    entry = cache["k"]
    before0 = [t.clone() for t in (entry[:3] if quantized else [entry])]
    row = P.slot_rows(entry, 1)
    leaves = list(row[:3]) if quantized else [row]
    assert all(l.shape[1] == 1 for l in leaves)
    bumped = ([l + 1 for l in leaves])
    rows = P.QuantizedKV(*bumped, entry.group_size) if quantized else bumped[0]
    back = P.set_slot_rows(entry, 1, rows)
    got = P.slot_rows(back, 1)
    for a, b in zip(list(got[:3]) if quantized else [got], bumped):
        assert torch.equal(a, b)
    for a, b in zip(list(P.slot_rows(back, 0)[:3]) if quantized
                    else [P.slot_rows(back, 0)],
                    [t[:, 0:1] for t in before0]):
        assert torch.equal(a, b)
    # a view written in place needs no copy back
    view = P.slot_rows(back, 2)
    (view.codes if quantized else view).fill_(7)
    assert bool(((back.codes if quantized else back)[:, 2] == 7).all())


def test_int8_cache_bytes_about_half_of_bf16():
    cfg = get_tiny_config("llama32-1b")
    kw = dict(num_slots=4, max_len=32)
    dense = P.init_slot_cache(cfg, P.KVCacheConfig(dtype=torch.bfloat16, **kw),
                              device="cpu")
    int8 = P.init_slot_cache(cfg, P.KVCacheConfig(quantized=True, **kw),
                             device="cpu")
    ratio = P.cache_bytes(dense) / P.cache_bytes(int8)
    assert 1.5 <= ratio <= 2.0
    assert P.cache_is_finite(dense) and P.cache_is_finite(int8)
    int8["v"].scale[0, 1, 2, 0, 0] = float("nan")
    assert not P.cache_is_finite(int8)


@pytest.mark.parametrize("r,k,group", [(40, 64, 16), (9, 128, 64),
                                       (3, 96, 32)])
def test_plain_kv_dequant_exact_against_pallas(r, k, group):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 256, (r, k), np.uint8)
    scale = rng.uniform(1e-4, 0.2, (r, k // group)).astype(np.float16)
    zero = rng.integers(0, 256, (r, k // group)).astype(np.float16)
    want = jops.kv_dequant(jnp.asarray(codes), jnp.asarray(scale),
                           jnp.asarray(zero), group)      # interpret mode
    got = ref.kv_dequant(_t(codes), _t(scale), _t(zero), group)
    assert_array_equal(got.numpy(), np.asarray(want))
    # the cache-level entry point (K5 through kernels.impl) on the CPU
    q = jit_quantize(jnp.asarray(rng.standard_normal((2, 5, 2, 32)),
                                 jnp.float32), 16)
    assert_array_equal(P.kv_dequantize(_port_q(q)).numpy(),
                       np.asarray(J._reference_dequant(q, jnp.float32)))


T, LENS = 40, [0, 1, 17, 23, 40]      # parked, single-token, ragged, full


@pytest.mark.parametrize("hk,g,quant,group", [(1, 1, False, 0),
                                              (2, 4, False, 0),
                                              (1, 2, True, 16),
                                              (2, 3, True, 8)])
def test_plain_decode_attn_against_pallas(hk, g, quant, group):
    rng = np.random.default_rng(4)
    b, d = len(LENS), 16
    q = rng.standard_normal((b, hk * g, d)).astype(np.float32)
    k = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    if quant:
        qk, qv = (jit_quantize(jnp.asarray(a), group) for a in (k, v))
        jargs = (qk.codes, qv.codes, jnp.asarray(lens), qk.scale, qk.zero,
                 qv.scale, qv.zero)
        pk, pv = _port_q(qk), _port_q(qv)
        pargs = (pk.codes, pv.codes, _t(lens), pk.scale, pk.zero, pv.scale,
                 pv.zero)
    else:
        jargs = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
        pargs = (_t(k), _t(v), _t(lens))
    want = jops.decode_attn(jnp.asarray(q), *jargs, group_size=group,
                            block_t=16)                  # 3 tiles, interpret
    got = ref.decode_attn(_t(q), *pargs, group_size=group, block_t=16)
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert np.all(got[0].numpy() == 0.0)                 # length 0: zeros


def test_plain_decode_attn_nan_row_propagates():
    rng = np.random.default_rng(5)
    b, hk, g, d = 3, 2, 2, 16
    q = rng.standard_normal((b, hk * g, d)).astype(np.float32)
    k = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    k[1, 5] = np.nan
    lens = np.asarray([T, 12, 0], np.int32)
    want = np.asarray(jops.decode_attn(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       block_t=16))
    got = ref.decode_attn(_t(q), _t(k), _t(v), _t(lens)).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    assert np.isfinite(got[0]).all() and np.all(got[2] == 0.0)
    assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)


def test_fused_decode_attn_reads_the_cache_layer():
    """The cache-level K6 entry point against the JAX one: (B, 1, H, D)
    queries at per-row positions against an INT8 layer."""
    rng = np.random.default_rng(6)
    b, hk, g, d = 3, 2, 2, 32
    q = rng.standard_normal((b, 1, hk * g, d)).astype(np.float32)
    k = jit_quantize(jnp.asarray(rng.standard_normal((b, 24, hk, d)),
                                 jnp.float32), 32)
    v = jit_quantize(jnp.asarray(rng.standard_normal((b, 24, hk, d)),
                                 jnp.float32), 32)
    pos = np.array([[0], [11], [23]], np.int32)
    want = J.fused_decode_attn(jnp.asarray(q), k, v, jnp.asarray(pos))
    got = P.fused_decode_attn(_t(q), _port_q(k), _port_q(v), _t(pos))
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
