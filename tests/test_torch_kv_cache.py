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
from repro_torch.kernels import ops, ref
from repro_torch.serving import kv_cache as P

jit_quantize = jax.jit(J.kv_quantize, static_argnums=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# K6's split-then-merge arithmetic (csrc/decode_attn.cu), emulated in f32
# numpy: each row's [0, T) cut by ops.decode_attn_splits; in a split, 8
# warps take pieces of ``piece`` tokens in turn, each warp an online
# softmax from m = −1e30 (fmax drops a NaN score, which poisons p, l and
# acc); the warps' carries, then the live splits', merged in order by
#   m = max m_s;  l = Σ l_s·exp(m_s − m);  acc = Σ acc_s·exp(m_s − m)
# and out = l == 0 ? 0 : acc / l.
def _merge(parts, g, d):
    m = np.full(g, -np.inf, np.float32)
    for mp, _, _ in parts:
        m = np.fmax(m, mp)
    l, acc = np.zeros(g, np.float32), np.zeros((g, d), np.float32)
    for mp, lp, ap in parts:
        e = np.exp(mp - m)
        l = l + lp * e
        acc = acc + ap * e[:, None]
    return m, l, acc


def _split_merge_emulation(q, k, v, lens, block_t, piece, warps=8):
    b, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    chunk, _ = ops.decode_attn_splits(b, hk, t, block_t)
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros((b, h, d), np.float32)
    for bi in range(b):
        n = min(max(int(lens[bi]), 0), t)
        for kh in range(hk):
            qh = q[bi, kh * g:(kh + 1) * g]
            splits = []
            for c0 in range(0, n, chunk):
                c1 = min(c0 + chunk, n)
                carries = []
                for w in range(warps):
                    m = np.full(g, -1e30, np.float32)
                    l, acc = np.zeros(g, np.float32), np.zeros((g, d),
                                                               np.float32)
                    for p0 in range(c0 + w * piece, c1, warps * piece):
                        kk = k[bi, p0:min(p0 + piece, c1), kh]
                        vv = v[bi, p0:min(p0 + piece, c1), kh]
                        s = (qh @ kk.T) * scale
                        m_new = np.fmax(m, np.fmax.reduce(s, axis=1))
                        p = np.exp(s - m_new[:, None])
                        corr = np.exp(m - m_new)
                        l = l * corr + p.sum(axis=1)
                        acc = acc * corr[:, None] + p @ vv
                        m = m_new
                    carries.append((m, l, acc))
                splits.append(_merge(carries, g, d))
            _, l, acc = _merge(splits, g, d)
            with np.errstate(invalid="ignore", divide="ignore"):
                out[bi, kh * g:(kh + 1) * g] = np.where(
                    (l == 0)[:, None], np.float32(0), acc / l[:, None])
    return out


# lengths 0 and 1, at and beside the split boundaries of chunk 16, and rows
# whose later splits are all empty (T = 40: three splits of 16)
SPLIT_LENS = [0, 1, 5, 15, 16, 17, 32, 33, 40]


@pytest.mark.parametrize("block_t", [16, 7, 40])
@pytest.mark.parametrize("piece", [32, 4])
@pytest.mark.parametrize("hk,g,quant,group", [(2, 4, False, 0),
                                              (1, 3, True, 8),
                                              (2, 2, True, 16)])
def test_split_merge_emulation_against_pallas(block_t, piece, hk, g, quant,
                                              group):
    """The kernel's split-then-merge arithmetic against the reference's
    interpreted Pallas flash-decode (one tile carry over the whole row), at
    its bar of 1e-5, dense and INT8 (dequantized as K5 does); a length-0
    row gives exact zeros."""
    rng = np.random.default_rng(11)
    b, d = len(SPLIT_LENS), 16
    q = rng.standard_normal((b, hk * g, d)).astype(np.float32)
    k = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    lens = np.asarray(SPLIT_LENS, np.int32)
    if quant:
        qk, qv = (jit_quantize(jnp.asarray(a), group) for a in (k, v))
        want = jops.decode_attn(jnp.asarray(q), qk.codes, qv.codes,
                                jnp.asarray(lens), qk.scale, qk.zero,
                                qv.scale, qv.zero, group_size=group,
                                block_t=16)
        k, v = (P.kv_dequantize(_port_q(x)).numpy() for x in (qk, qv))
    else:
        want = jops.decode_attn(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens),
                                block_t=16)
    got = _split_merge_emulation(q, k, v, lens, block_t, piece)
    assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("quant", [False, True])
def test_split_merge_emulation_nan_poisons_one_head_group(quant):
    """A NaN in a later split of one row, at KV head 1: the emulated merge
    makes exactly that row's query heads of KV head 1 NaN, as the
    interpreted Pallas kernel does, and the rest agrees within 1e-5."""
    rng = np.random.default_rng(12)
    b, hk, g, d = 4, 2, 3, 16
    q = rng.standard_normal((b, hk * g, d)).astype(np.float32)
    k = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, T, hk, d)).astype(np.float32)
    lens = np.asarray([40, 0, 37, 5], np.int32)
    if quant:
        qk, qv = (jit_quantize(jnp.asarray(a), 8) for a in (k, v))
        ks = np.array(qk.scale)
        ks[2, 35, 1] = np.nan
        want = np.asarray(jops.decode_attn(
            jnp.asarray(q), qk.codes, qv.codes, jnp.asarray(lens),
            jnp.asarray(ks), qk.zero, qv.scale, qv.zero, group_size=8,
            block_t=16))
        bad = _port_q(qk)
        k = P.kv_dequantize(P.QuantizedKV(bad.codes, _t(ks), bad.zero,
                                          8)).numpy()
        v = P.kv_dequantize(_port_q(qv)).numpy()
    else:
        k[2, 35, 1] = np.nan
        want = np.asarray(jops.decode_attn(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens),
                                           block_t=16))
    got = _split_merge_emulation(q, k, v, lens, 16, 4)
    poisoned = np.zeros((b, hk * g), bool)
    poisoned[2, g:2 * g] = True
    assert np.array_equal(np.isnan(got).all(axis=-1), poisoned)
    assert np.array_equal(np.isnan(want).all(axis=-1), poisoned)
    assert not np.isnan(got[~poisoned]).any()
    assert_allclose(got[~poisoned], want[~poisoned], atol=1e-5, rtol=1e-5)
    assert np.all(got[1] == 0.0)


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


# ---------------------------------------------------------------------------
# paged layout: K6p's plain version, the page scatters and gathers
# ---------------------------------------------------------------------------

PAGE = 8


def _paged_case(rng, hk, g, d, quant, group, num_pages=16):
    """Shuffled pools and tables holding LENS rows of T tokens: each row's
    pages are distinct random pool pages (two rows share one page of the
    parked row 0), tails are sentinel entries (== P). Returns the JAX
    args, the port's args and the contiguous (B, T, Hk, D) rows."""
    b, npg = len(LENS), T // PAGE
    k = rng.standard_normal((num_pages, PAGE, hk, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, PAGE, hk, d)).astype(np.float32)
    table = np.full((b, npg), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, n in enumerate(LENS):
        live = -(-n // PAGE)
        table[i, :live] = perm[used:used + live]
        used += live
    table[0, 0] = table[3, 0]          # a page of row 3 in the parked row
    q = rng.standard_normal((b, hk * g, d)).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    if quant:
        qk, qv = (jit_quantize(jnp.asarray(a), group) for a in (k, v))
        pk, pv = _port_q(qk), _port_q(qv)
        jargs = (jnp.asarray(q), qk.codes, qv.codes, jnp.asarray(table),
                 jnp.asarray(lens))
        jkw = dict(k_scale=qk.scale, k_zero=qk.zero, v_scale=qv.scale,
                   v_zero=qv.zero, group_size=group)
        pargs = (_t(q), pk.codes, pv.codes, _t(table), _t(lens))
        pkw = dict(k_scale=pk.scale, k_zero=pk.zero, v_scale=pv.scale,
                   v_zero=pv.zero, group_size=group)
    else:
        jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(table), jnp.asarray(lens))
        jkw, pkw = {}, {}
        pargs = (_t(q), _t(k), _t(v), _t(table), _t(lens))
    return jargs, jkw, pargs, pkw


@pytest.mark.parametrize("hk,g,quant,group", [(1, 1, False, 0),
                                              (2, 4, False, 0),
                                              (1, 2, True, 16),
                                              (2, 3, True, 8)])
def test_plain_decode_attn_paged_against_pallas(hk, g, quant, group):
    """K6p's plain version against the reference's interpreted Pallas
    kernel (one page a tile) and its jnp oracle, within 1e-5 (the bar of
    tests/test_decode_attn.py)."""
    rng = np.random.default_rng(7)
    jargs, jkw, pargs, pkw = _paged_case(rng, hk, g, 16, quant, group)
    got = ref.decode_attn_paged(*pargs, **pkw)
    for use_pallas in (True, False):
        want = jops.decode_attn_paged(*jargs, use_pallas=use_pallas, **jkw)
        assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert np.all(got[0].numpy() == 0.0)                 # length 0: zeros
    # the same tokens in slot rows give the slot version's output
    q, k, v, table, lens = pargs
    rows = [ref.gather_pages(x, table) for x in
            (k, v, *(pkw[n] for n in ("k_scale", "k_zero", "v_scale",
                                      "v_zero") if quant))]
    slot_kw = (dict(zip(("k_scale", "k_zero", "v_scale", "v_zero"),
                        rows[2:]), group_size=group) if quant else {})
    assert torch.equal(got, ref.decode_attn(q, rows[0], rows[1], lens,
                                            **slot_kw))


def test_fused_decode_attn_paged_reads_the_pool():
    """The cache-level entry point through a table against the JAX one."""
    rng = np.random.default_rng(8)
    jargs, jkw, pargs, pkw = _paged_case(rng, 2, 2, 32, True, 32)
    jq = J.QuantizedKV(jargs[1], jkw["k_scale"], jkw["k_zero"], 32)
    jv = J.QuantizedKV(jargs[2], jkw["v_scale"], jkw["v_zero"], 32)
    pq = P.QuantizedKV(pargs[1], pkw["k_scale"], pkw["k_zero"], 32)
    pv = P.QuantizedKV(pargs[2], pkw["v_scale"], pkw["v_zero"], 32)
    pos = (np.maximum(np.asarray(LENS), 1) - 1)[:, None].astype(np.int32)
    want = J.fused_decode_attn(jargs[0][:, None], jq, jv, jnp.asarray(pos),
                               table=jargs[3])
    got = P.fused_decode_attn(pargs[0][:, None], pq, pv, _t(pos),
                              table=pargs[3])
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _pools(quantized, num_pages=6):
    cfg, jcfg = get_tiny_config("llama32-1b"), jget_tiny("llama32-1b")
    jkv = J.init_paged_storage(jcfg, num_pages, PAGE, quantized=quantized)
    pkv = P.init_paged_storage(cfg, num_pages, PAGE, quantized=quantized,
                               device="cpu")
    return cfg, jkv, pkv


def _same_pool(port, jax_entry):
    if isinstance(port, P.QuantizedKV):
        _assert_same_q(port, jax_entry)
    else:
        assert_array_equal(port.numpy(), np.asarray(jax_entry))


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_storage_init_write_view_take_put_exact(quantized):
    """init_paged_storage, write_pages (sentinel columns and padding rows
    dropped), paged_view, take_pages and put_pages give exactly the JAX
    package's storage."""
    cfg, jkv, pkv = _pools(quantized)
    for name in ("k", "v"):
        _same_pool(pkv[name], jkv[name])
    rng = np.random.default_rng(9)
    shape = (cfg.num_layers, 3, 20, cfg.num_kv_heads, cfg.resolved_head_dim)
    k_new = rng.standard_normal(shape).astype(np.float32)
    v_new = rng.standard_normal(shape).astype(np.float32)
    maps = np.array([[4, 1, 6], [0, 6, 6], [6, 6, 6]], np.int32)  # 6 == P
    jkv = jax.jit(J.write_pages, static_argnums=4)(
        jkv, jnp.asarray(maps), jnp.asarray(k_new), jnp.asarray(v_new), PAGE)
    pkv = P.write_pages(pkv, maps, _t(k_new), _t(v_new), PAGE)
    for name in ("k", "v"):
        _same_pool(pkv[name], jkv[name])
    store = pkv["k"].codes if quantized else pkv["k"]
    assert not store[:, [2, 3, 5]].any()               # never written
    table = np.array([[4, 1, 6], [0, 6, 6]], np.int32)
    for layer in (0, cfg.num_layers - 1):
        jl = jax.tree.map(lambda a: a[layer], jkv["k"])
        pl = (P.QuantizedKV(*(t[layer] for t in pkv["k"][:3]), 
                            pkv["k"].group_size) if quantized
              else pkv["k"][layer])
        _same_pool(P.paged_view(pl, _t(table)),
                   J.paged_view(jl, jnp.asarray(table)))
    pages = [4, 0, 1]
    rows = P.take_pages(pkv["v"], pages)
    jrows = J.take_pages(jkv["v"], jnp.asarray(pages))
    for mine, theirs in zip(rows, jax.tree.leaves(jrows)):
        assert_array_equal(mine.numpy(), np.asarray(theirs))
    dst = [2, 3, 5]
    jkv["v"] = J.put_pages(jkv["v"], jnp.asarray(dst), jrows)
    P.put_pages(pkv["v"], dst, rows)
    _same_pool(pkv["v"], jkv["v"])


def test_spill_restore_round_trip_is_byte_exact():
    """A spilled payload (one host transfer) restored into other pages
    (one upload) puts back the same bytes, codes and planes."""
    from repro_torch.serving.paging import restore_pages, spill_pages
    cfg = get_tiny_config("llama32-1b")
    pkv = P.init_paged_storage(cfg, 8, PAGE, quantized=True, device="cpu")
    rng = np.random.default_rng(10)
    x = _t(rng.standard_normal((cfg.num_layers, 3, 2 * PAGE,
                                cfg.num_kv_heads, cfg.resolved_head_dim)
                               ).astype(np.float32))
    P.write_pages(pkv, np.array([[1, 5], [2, 8], [8, 8]]), x, -x, PAGE)
    before = {n: [t.clone() for t in pkv[n][:3]] for n in ("k", "v")}
    payload = spill_pages(pkv, [5, 1, 2])
    assert all(isinstance(a, np.ndarray) for a in payload["k"])
    restore_pages(pkv, [7, 3, 0], payload)
    for n in ("k", "v"):
        for old, new in zip(before[n], pkv[n][:3]):
            assert torch.equal(new[:, [7, 3, 0]], old[:, [5, 1, 2]])
            assert torch.equal(new[:, [1, 2, 5]], old[:, [1, 2, 5]])
    with pytest.raises(ValueError):
        restore_pages(pkv, [7, 3], payload)
