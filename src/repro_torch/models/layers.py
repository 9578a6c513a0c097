"""Model building blocks of the dense and MoE families.

Conventions (as ``repro/models/layers.py``):
- Linear weights are stored ``(d_in, d_out)`` (activation @ weight); the
  compression library works in paper orientation ``(d_out, d_in)``.
- ``capture`` dicts collect pre-matmul activations for calibration.
- Prefill attention is the reference's double-chunked online softmax
  (:func:`flash_attention`), f32 throughout, in the same order of
  operations; it is arithmetic, not a kernel. Decode reads of the serving
  cache go through K6, or K6p through a block table
  (:func:`~repro_torch.serving.kv_cache.fused_decode_attn`), and INT8
  cache rows are expanded by K5 (``kv_cache.kv_dequantize``), on the paged
  chunk path one gathered tile at a time.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.quant import QTensor
from repro_torch.sharding import NO_RULES, ShardingRules, hint
from repro_torch.serving.kv_cache import (QuantizedKV, fused_decode_attn,
                                          kv_dequantize, kv_quantize,
                                          kv_update, paged_view)


# ---------------------------------------------------------------------------
# linear dispatch: dense tensor or packed QTensor, one entry point
# ---------------------------------------------------------------------------

def linear_apply(w, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w for a dense ``(d_in, d_out)`` weight, or the same product
    read from a packed :class:`QTensor` (paper orientation) through
    ``QTensor.matmul_dispatch`` — K4 on the card."""
    if isinstance(w, QTensor):
        lead = x.shape[:-1]
        y = w.matmul_dispatch(x.reshape(-1, x.shape[-1]))
        return y.reshape(*lead, y.shape[-1]).to(x.dtype)
    return x @ w


def expert_apply(w, x: torch.Tensor, *, per_expert: bool = False
                 ) -> torch.Tensor:
    """Batched per-expert linear: x (T, d) → (T, E, f), or per-expert
    inputs x (E, T, d) → (E, T, f) with ``per_expert``. ``w`` is a stacked
    dense (E, d, f) weight or a stacked :class:`QTensor` leaf (children
    lead with E, ``shape`` the per-expert (f, d)), whose product is one
    K4x launch on the card (``QTensor.expert_matmul``). The reference's
    ``repro/models/layers.py::expert_apply``. The dense shared form runs
    one (T, d) × (d, f) product an expert into (E, T, f) storage and
    returns its (T, E, f) view: no copy of the stack or of x is made.
    When a graph is being built (x or w requires grad) the same products
    are stacked out of place, which autograd differentiates (``out=``
    products it cannot), with the stack unbound once (its backward is
    one stack, not a full-size write an expert)."""
    if isinstance(w, QTensor):
        return w.expert_matmul(x, per_expert).to(x.dtype)
    if per_expert:
        return torch.bmm(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return torch.stack([x @ we for we in w.unbind(0)]).transpose(0, 1)
    y = x.new_empty((w.shape[0], x.shape[0], w.shape[2]))
    for e in range(w.shape[0]):
        torch.mm(x, w[e], out=y[e])
    return y.transpose(0, 1)


# ---------------------------------------------------------------------------
# init helpers (torch.Generator streams; not the JAX package's numbers)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, lead=(),
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D) with even D; positions: (B, S)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs        # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return x * torch.sigmoid(x)
    if kind == "gelu":                       # jax.nn.gelu's default form
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# chunked causal flash attention (online softmax; never materializes S×S)
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, mult: int, dim: int):
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), n


def flash_attention(q: torch.Tensor, k, v, *, causal: bool = True,
                    q_offset=0, q_chunk: int = 1024, kv_chunk: int = 1024,
                    kv_pages=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hk, D) with H % Hk == 0.

    The reference's double-chunked online-softmax attention
    (``repro/models/layers.py::flash_attention``) in the same arithmetic:
    the sequence dims are zero-padded to whole chunks, an outer loop runs
    over query chunks and an inner loop over KV chunks carrying (m, l, acc)
    in f32, rows with no valid key yet are guarded (``m_safe``, ``corr``),
    and the output is ``acc / max(l, 1e-30)``. ``q_offset`` is the absolute
    position of q[0] (the chunked prefill attends the cache under the
    offset causal mask).

    ``kv_pages=(table, page_size)`` reads K/V through the paged layout: k
    and v are one layer's page pools (P, page, Hk, D), dense or
    :class:`QuantizedKV`, and ``table`` (B, n_pages) int32 maps each row's
    positions to pages. KV chunks are page-aligned (``kv_chunk // page``
    pages, the table padded with the sentinel P to whole chunks), and each
    inner step gathers only its own pages (sentinel entries clip to page
    P − 1, past every live query's causal mask); a quantized pool expands
    each gathered tile through :func:`kv_dequantize` (K5 on the card).
    """
    b, sq, h, d = q.shape
    if kv_pages is not None:
        table, page_size = kv_pages
        store = k.codes if isinstance(k, QuantizedKV) else k
        hk = store.shape[-2]
        skv = table.shape[1] * page_size
    else:
        _, skv, hk, _ = k.shape
    if h % hk:
        raise ValueError(f"flash_attention: {h} heads over {hk} KV heads")
    g = h // hk
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    q, sq0 = _pad_to(q, q_chunk, 1)
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    if kv_pages is not None:
        ppc = max(kv_chunk // page_size, 1)
        kv_chunk = ppc * page_size
        npg = table.shape[1]
        npg_p = -(-npg // ppc) * ppc
        if npg_p != npg:                     # sentinel-pad the table itself
            table = torch.cat([table, table.new_full(
                (b, npg_p - npg), store.shape[0])], dim=1)
        skv0, skv_p = skv, npg_p * page_size
        idx = table.to(torch.int64).clamp(0, store.shape[0] - 1)

        def fetch(k0):
            pages = idx[:, k0 // page_size:k0 // page_size + ppc]

            def grab(pool):                  # (B, ppc, page, ...) → chunk
                return pool[pages].reshape(b, kv_chunk, *pool.shape[2:])
            if isinstance(k, QuantizedKV):
                return tuple(kv_dequantize(QuantizedKV(
                    grab(e.codes), grab(e.scale), grab(e.zero), e.group_size),
                    q.dtype) for e in (k, v))
            return grab(k), grab(v)
    else:
        k, skv0 = _pad_to(k, kv_chunk, 1)
        v, _ = _pad_to(v, kv_chunk, 1)
        skv_p = k.shape[1]

        def fetch(k0):
            return k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]

    sq_p = q.shape[1]
    q_pos = torch.arange(sq_p, device=dev) + q_offset
    k_pos = torch.arange(skv_p, device=dev)
    kv_valid = k_pos < skv0
    zero = torch.zeros((), device=dev)
    chunks = []
    for q0 in range(0, sq_p, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        qpos = q_pos[q0:q0 + q_chunk]
        m = torch.full((b, h, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((b, h, q_chunk), device=dev)
        acc = torch.zeros((b, h, q_chunk, d), device=dev)
        for k0 in range(0, skv_p, kv_chunk):
            kc, vc = fetch(k0)
            s = _scores(qc, kc, g) * scale                  # (B, H, qc, kc)
            mask = kv_valid[k0:k0 + kv_chunk][None, None, None, :]
            if causal:
                mask = mask & (k_pos[k0:k0 + kv_chunk][None, None, None, :]
                               <= qpos[None, None, :, None])
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard rows with no valid keys yet
            m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), zero)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _pv(p, vc, g)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        chunks.append(out.permute(0, 2, 1, 3))           # (B, qc, H, D)
    return torch.cat(chunks, dim=1)[:, :sq0].to(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, g: int) -> torch.Tensor:
    """(B, Sq, H, D) × (B, Skv, Hk, D) → (B, H, Sq, Skv), GQA groups."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qh = q.reshape(b, sq, hk, g, d).to(torch.float32)
    s = torch.einsum("bqkgd,bnkd->bkgqn", qh, k.to(torch.float32))
    return s.reshape(b, h, sq, k.shape[1])


def _pv(p: torch.Tensor, v: torch.Tensor, g: int) -> torch.Tensor:
    """(B, H, Sq, Skv) × (B, Skv, Hk, D) → (B, H, Sq, D), f32."""
    b, h, sq, skv = p.shape
    hk = h // g
    out = torch.einsum("bkgqn,bnkd->bkgqd", p.reshape(b, hk, g, sq, skv),
                       v.to(torch.float32))
    return out.reshape(b, h, sq, v.shape[-1])


def decode_attention(q, k_cache, v_cache, q_positions) -> torch.Tensor:
    """New tokens against a slot cache (B, Smax, Hk, D): key index ≤ each
    query's absolute position (the new K/V are already written). The
    unfused reference read (``use_fused_decode=False``)."""
    b, sq, h, d = q.shape
    g = h // k_cache.shape[2]
    sc = _scores(q, k_cache, g) / math.sqrt(d)
    k_idx = torch.arange(k_cache.shape[1], device=q.device)
    valid = k_idx[None, None, :] <= q_positions[:, :, None]     # (B, Sq, Smax)
    sc = sc.masked_fill(~valid[:, None], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return _pv(p, v_cache, g).permute(0, 2, 1, 3).to(q.dtype)


def paged_write(entry, table: torch.Tensor, pos, new: torch.Tensor,
                page_size: int):
    """Scatter ``new`` (B, s, Hk, D) tokens into one layer's page pool
    (P, page, Hk, D), dense or :class:`QuantizedKV`, through the block
    table (B, n_pages), in place.

    ``pos`` a (B,) tensor with s == 1 (the engine's decode: each row writes
    at its own position) or a host int with s >= 1 (the chunked prefill: s
    consecutive positions from ``pos``). A position past the table or on a
    sentinel entry (a parked slot's row, a final chunk's padded tail past
    the request's pages) is dropped, never written, as the reference's
    scatter drops it. The drop is made without reading anything on the
    host: a dropped write is redirected onto the target of the first kept
    one, with that write's own values (duplicate writes of equal values
    leave one result), or, when every write drops, onto page 0 offset 0
    with the values it already holds."""
    b, s = new.shape[0], new.shape[1]
    leaves = (entry[:3] if isinstance(entry, QuantizedKV) else (entry,))
    num_pages = leaves[0].shape[0]
    npg = table.shape[1]
    dev = leaves[0].device
    if torch.is_tensor(pos) and pos.dim() == 1:
        if s != 1:
            raise ValueError("per-slot paged writes are one token per step")
        cols = pos.to(device=dev, dtype=torch.int64)[:, None]      # (B, 1)
    else:
        cols = (int(pos) + torch.arange(s, device=dev))[None, :].expand(b, s)
    pidx = torch.clamp(cols // page_size, 0, npg - 1)
    pages = torch.gather(table.to(torch.int64), 1, pidx)             # (B, s)
    keep = ((cols < npg * page_size) & (pages >= 0)
            & (pages < num_pages)).reshape(-1)
    pages, offs = pages.reshape(-1), (cols % page_size).reshape(-1)
    # (1,) index of the first kept write; a 0-dim index would be read on
    # the host
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    some = keep.any()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    pages = torch.where(keep, pages, torch.where(
        some, pages.index_select(0, first), zero))
    offs = torch.where(keep, offs, torch.where(
        some, offs.index_select(0, first), zero))
    src = torch.where(keep, torch.arange(b * s, device=dev), first)
    flat = new.reshape(b * s, *new.shape[2:])
    vals = (kv_quantize(flat, entry.group_size)[:3]
            if isinstance(entry, QuantizedKV) else (flat,))
    for dst, val in zip(leaves, vals):
        val = val[src].to(dst.dtype)
        held = dst[0, 0].expand_as(val)             # page 0 offset 0 as is
        dst[pages, offs] = torch.where(some, val, held)
    return entry


# ---------------------------------------------------------------------------
# attention + MLP blocks (dense family)
# ---------------------------------------------------------------------------

def attn_params(gen, cfg, *, lead=(), dtype=torch.float32, device="cpu"):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d, cfg.num_heads * hd, **kw),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, **kw),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, **kw),
        "wo": dense_init(gen, cfg.num_heads * hd, d, **kw),
        "norm": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device),
    }


def mlp_params(gen, cfg, *, lead=(), dtype=torch.float32, device="cpu",
               d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {"wu": dense_init(gen, d, f, **kw),
         "wd": dense_init(gen, f, d, **kw),
         "norm": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}
    if cfg.mlp_act == "silu":                        # gated
        p["wg"] = dense_init(gen, d, f, **kw)
    return p


def _write_dense(cache: torch.Tensor, new: torch.Tensor, cache_pos,
                 attend_cache: bool) -> None:
    """Write ``new`` (B, s, Hk, D) into a dense (B, T, Hk, D) cache in place:
    one token per row at a per-row position (``cache_pos`` a (B,) tensor,
    s == 1), or s columns from a host-int position. The chunked prefill
    (``attend_cache``) drops columns past the cache edge, as the
    reference's per-column scatter does; the plain splice clamps its start
    so the block fits, as ``dynamic_update_slice`` does."""
    b, s = new.shape[0], new.shape[1]
    t = cache.shape[1]
    if torch.is_tensor(cache_pos) and cache_pos.dim() == 1:
        if s != 1:
            raise ValueError("per-slot cache writes are one token per step")
        rows = torch.arange(b, device=cache.device)
        cache[rows, cache_pos.to(torch.int64)] = new[:, 0].to(cache.dtype)
        return
    pos = int(cache_pos)
    if attend_cache:
        n = max(0, min(s, t - pos))
        cache[:, pos:pos + n] = new[:, :n].to(cache.dtype)
    else:
        pos = max(0, min(pos, t - s))
        cache[:, pos:pos + s] = new.to(cache.dtype)


def attn_apply(p, x, cfg, rules: ShardingRules = NO_RULES, *,
               positions=None, capture=None, kv_cache=None,
               cache_pos=0, attend_cache: bool = False, block_table=None,
               fused_decode: bool = False, attn_chunk: int = 1024):
    """Pre-norm attention block (residual added by the caller).

    Returns ``(out, new_kv)``: the ``(k, v)`` of this call without a cache,
    else the updated ``(k_cache, v_cache)``. Cache entries are dense
    (B, T, Hk, D) tensors or INT8 :class:`QuantizedKV` storage (quantized
    on write, expanded by K5 on the chunked-prefill read); either is
    written IN PLACE (the reference's functional update with donation).
    ``cache_pos`` is the write position: a host int (uniform over the
    batch: the static path and the chunked prefill) or a (B,) tensor (the
    engine's per-slot decode positions; needs s == 1).

    - no cache: causal :func:`flash_attention` over x;
    - s > 1 with a cache: prefill. The fresh K/V are written at
      ``cache_pos`` and attended by :func:`flash_attention` (the serving
      convention ``cache_pos`` == 0), or with ``attend_cache=True`` (the
      chunked-prefill contract) the chunk's columns
      [cache_pos, cache_pos + s) are written first — those past the cache
      edge are dropped — and the queries attend the CACHE rows under the
      offset causal mask (``flash_attention(q_offset=cache_pos)``);
    - s == 1: decode. ``fused_decode=True`` reads the cache through K6
      (:func:`~repro_torch.serving.kv_cache.fused_decode_attn`); False
      keeps the expand-then-attend reference (:func:`decode_attention`).

    ``block_table`` (B, n_pages) int32 switches the cache to the paged
    layout: the entries are one layer's page pools (P, page, Hk, D), the
    page size read off the pool, and every position routes through the
    table — writes through :func:`paged_write`, the decode read through
    K6p (``fused_decode``) or :func:`~repro_torch.serving.kv_cache.paged_view`
    then expand then :func:`decode_attention`, and s > 1 only as the
    chunked-prefill contract (``attend_cache``), read by the paged
    :func:`flash_attention`. The views hold the same written values at the
    same positions as a slot row, so greedy tokens equal the slot
    layout's, dense and INT8 alike.
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    h, hk = cfg.num_heads, cfg.num_kv_heads
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if capture is not None:
        capture["attn_in"] = xn
    q = linear_apply(p["wq"], xn).reshape(b, s, h, hd)
    k = linear_apply(p["wk"], xn).reshape(b, s, hk, hd)
    v = linear_apply(p["wv"], xn).reshape(b, s, hk, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = hint(q, rules, ("batch", None, "tp", None))
    k = hint(k, rules, ("batch", None, None, None))

    if kv_cache is None:
        out = flash_attention(q, k, v, causal=True, q_chunk=attn_chunk,
                              kv_chunk=attn_chunk)
        new_kv = (k, v)
    elif block_table is not None:
        if s > 1 and not attend_cache:
            raise ValueError(
                "paged s > 1 is the chunked-prefill contract (attend_cache);"
                " the batched prefill fills a dense mini-cache, then "
                "write_pages")
        k_cache, v_cache = kv_cache                  # pools (P, page, Hk, D)
        page = (k_cache.codes if isinstance(k_cache, QuantizedKV)
                else k_cache).shape[1]
        paged_write(k_cache, block_table, cache_pos, k, page)
        paged_write(v_cache, block_table, cache_pos, v, page)
        if s > 1:
            out = flash_attention(q, k_cache, v_cache, causal=True,
                                  q_offset=cache_pos, q_chunk=attn_chunk,
                                  kv_chunk=attn_chunk,
                                  kv_pages=(block_table, page))
        elif fused_decode:
            out = fused_decode_attn(q, k_cache, v_cache, positions,
                                    table=block_table)
        else:
            k_r = paged_view(k_cache, block_table)
            v_r = paged_view(v_cache, block_table)
            if isinstance(k_r, QuantizedKV):
                k_r = kv_dequantize(k_r, q.dtype)
                v_r = kv_dequantize(v_r, q.dtype)
            out = decode_attention(q, k_r, v_r, positions)
        new_kv = (k_cache, v_cache)
    else:
        k_cache, v_cache = kv_cache
        if isinstance(k_cache, QuantizedKV):
            k_cache = kv_update(k_cache, k, cache_pos)
            v_cache = kv_update(v_cache, v, cache_pos)
        else:
            _write_dense(k_cache, k, cache_pos, attend_cache)
            _write_dense(v_cache, v, cache_pos, attend_cache)
        if s > 1 and attend_cache:
            if isinstance(k_cache, QuantizedKV):
                k_r = kv_dequantize(k_cache, q.dtype)
                v_r = kv_dequantize(v_cache, q.dtype)
            else:
                k_r, v_r = k_cache, v_cache
            out = flash_attention(q, k_r, v_r, causal=True,
                                  q_offset=cache_pos, q_chunk=attn_chunk,
                                  kv_chunk=attn_chunk)
        elif s > 1:
            out = flash_attention(q, k, v, causal=True, q_chunk=attn_chunk,
                                  kv_chunk=attn_chunk)
        elif fused_decode:
            out = fused_decode_attn(q, k_cache, v_cache, positions)
        else:
            if isinstance(k_cache, QuantizedKV):
                k_r = kv_dequantize(k_cache, q.dtype)
                v_r = kv_dequantize(v_cache, q.dtype)
            else:
                k_r, v_r = k_cache, v_cache
            out = decode_attention(q, k_r, v_r, positions)
        new_kv = (k_cache, v_cache)

    out = hint(out, rules, ("batch", None, "tp", None))
    out = out.reshape(b, s, h * hd)
    if capture is not None:
        capture["attn_out_in"] = out
    return linear_apply(p["wo"], out).to(x.dtype), new_kv


def mlp_apply(p, x, cfg, rules: ShardingRules = NO_RULES, *, capture=None):
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if capture is not None:
        capture["mlp_in"] = xn
    if cfg.mlp_act == "silu":
        hdn = mlp_act(linear_apply(p["wg"], xn), "silu") * linear_apply(p["wu"], xn)
    else:
        hdn = mlp_act(linear_apply(p["wu"], xn), cfg.mlp_act)
    hdn = hint(hdn, rules, ("batch", None, "tp"))
    if capture is not None:
        capture["mlp_down_in"] = hdn
    return linear_apply(p["wd"], hdn).to(x.dtype)


__all__ = ["linear_apply", "expert_apply", "dense_init", "embed_init", "rmsnorm", "rope",
           "mlp_act", "flash_attention", "decode_attention", "paged_write",
           "attn_params", "mlp_params", "attn_apply", "mlp_apply"]
