"""Slot-indexed or paged, optionally INT8-quantized KV cache for the
serving engine (the port of ``repro/serving/kv_cache.py``).

The cache is a plain dict ``{"k": <storage>, "v": <storage>, "pos": ...}``
where ``<storage>`` is a dense ``(L, S, T, Hk, D)`` tensor (``L`` layers,
``S`` slots, ``T`` max_len) or a :class:`QuantizedKV`: INT8 codes plus
per-(token, head, group) float16 scale and zero, groups tiling the head
dim. INT8 storage costs ``1 + 4/group`` bytes per element against 4 for
f32.

The paged layout keeps per-layer page pools ``(L, P, page, Hk, D)`` (dense
or :class:`QuantizedKV` with per-(page, token, head, group) planes) that
requests reach through block tables; ``serving/paging.py`` owns the
allocator, this module the storage and its scatters and gathers
(:func:`init_paged_storage`, :func:`write_pages`, :func:`paged_view`,
:func:`take_pages`, :func:`put_pages`). The page index P is the sentinel:
writes through it are dropped and reads clip to page P − 1, whose
positions lie past every row's length.

Reads expand INT8 rows at the attention boundary through K5
(``kernels.impl("kv_dequant")``), and the decode read is K6, or K6p
through a block table (:func:`fused_decode_attn`). Writes quantize the incoming K/V. Unlike the
reference, whose arrays are immutable, every write here updates the
storage IN PLACE and returns it: the cache of full-width llama32-1b is
hundreds of MB, and the reference's jitted steps donate it for the same
reason. Out-of-range writes are dropped explicitly, as JAX's scatters drop
them: batch-padding rows of :func:`write_slot` and the columns of a final
prefill chunk past the cache edge, and the sentinel page columns of a
paged write.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import impl

# the reference divides by the constant 255 in its source; compiled (it
# always runs under jit) that division is a multiply by the f32 reciprocal
INV_255 = float(np.float32(1.0) / np.float32(255.0))


class QuantizedKV(NamedTuple):
    """INT8 cache storage: ``codes`` (..., T, Hk, D) uint8 and ``scale`` /
    ``zero`` (..., T, Hk, D/g) float16, with the static ``group_size``."""
    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    group_size: int

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.scale, self.zero))


# ---------------------------------------------------------------------------
# quantize / dequantize (per-head-group asymmetric INT8)
# ---------------------------------------------------------------------------

def kv_quantize(x: torch.Tensor, group_size: int) -> QuantizedKV:
    """x: (..., D) float → codes (..., D) uint8 + scale/zero (..., D/g) f16.

    Asymmetric min/max over each head-dim group, the grid stretched to
    include 0 so zero-initialized rows stay exactly zero, the scale clamped
    to 1e-4; the same arithmetic as the reference's compiled code (see
    ``INV_255``; the two divisions by the scale are true divisions, and
    ``torch.round`` rounds half to even as ``jnp.round`` does)."""
    d = x.shape[-1]
    if d % group_size:
        raise ValueError(f"kv_quantize: D={d} not a multiple of {group_size}")
    g = x.reshape(*x.shape[:-1], d // group_size, group_size).to(torch.float32)
    gmax = torch.clamp(g.amax(dim=-1), min=0.0)
    gmin = torch.clamp(g.amin(dim=-1), max=0.0)
    scale = torch.clamp((gmax - gmin) * INV_255, min=1e-4)
    zero = torch.clamp(torch.round(-gmin / scale), 0.0, 255.0)
    codes = torch.clamp(torch.round(g / scale[..., None]) + zero[..., None],
                        0.0, 255.0).to(torch.uint8)
    return QuantizedKV(codes=codes.reshape(x.shape),
                       scale=scale.to(torch.float16),
                       zero=zero.to(torch.float16), group_size=group_size)


def _reference_dequant(q: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    """Dense (..., D) values by the plain expression (K5's plain version)."""
    from repro_torch.kernels import ref
    return _rows_apply(ref.kv_dequant, q).to(dtype)


def _rows_apply(fn, q: QuantizedKV) -> torch.Tensor:
    """Run a (R, Hk·D) dequant ``fn`` over (..., Hk, D) storage."""
    hk, d = q.codes.shape[-2:]
    lead = q.codes.shape[:-2]
    rows = int(np.prod(lead)) if lead else 1
    flat = fn(q.codes.reshape(rows, hk * d), q.scale.reshape(rows, -1),
              q.zero.reshape(rows, -1), q.group_size)
    return flat.reshape(*lead, hk, d)


def kv_dequantize(q: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    """Dense (..., T, Hk, D) values through K5 (its plain version under
    ``kernels.use_impl("reference")`` or on a CPU tensor)."""
    return _rows_apply(impl("kv_dequant"), q).to(dtype)


def fused_decode_attn(q: torch.Tensor, k_entry, v_entry,
                      positions: torch.Tensor, *, table=None,
                      block_t: int = 256) -> torch.Tensor:
    """K6 (K6p with ``table``): one query token per row attends its own
    cache history.

    q: (B, 1, H, D) (RoPE applied); positions: (B, 1) absolute decode
    positions — row b attends ``positions[b] + 1`` live tokens (the current
    token's K/V is already written). ``k_entry``/``v_entry``: one layer's
    (B, T, Hk, D) slot storage, or with ``table`` (B, n_pages) int32 one
    layer's (P, page, Hk, D) page pools; dense or :class:`QuantizedKV`
    either way (dequantized inside the kernel's tile). The lengths and the
    table stay on the device. Returns (B, 1, H, D)."""
    lengths = positions[:, 0].to(torch.int32) + 1
    kw = {}
    if isinstance(k_entry, QuantizedKV):
        kw = dict(k_scale=k_entry.scale, k_zero=k_entry.zero,
                  v_scale=v_entry.scale, v_zero=v_entry.zero,
                  group_size=k_entry.group_size)
        k_entry, v_entry = k_entry.codes, v_entry.codes
    if table is not None:
        out = impl("decode_attn_paged")(q[:, 0].contiguous(), k_entry,
                                        v_entry, table, lengths,
                                        block_t=block_t, **kw)
    else:
        out = impl("decode_attn")(q[:, 0].contiguous(), k_entry, v_entry,
                                  lengths, block_t=block_t, **kw)
    return out[:, None].to(q.dtype)


def kv_update(q: QuantizedKV, x: torch.Tensor, pos) -> QuantizedKV:
    """Write new tokens x (B, s, Hk, D) into (B, T, Hk, D) INT8 storage,
    in place. ``pos`` a (B,) tensor: one token per row at that row's own
    position (the engine's decode, s == 1); a host int: s columns from
    ``pos``, those past the cache edge dropped (a final prefill chunk's
    padded tail)."""
    new = kv_quantize(x, q.group_size)
    if torch.is_tensor(pos) and pos.dim() == 1:
        if x.shape[1] != 1:
            raise ValueError("per-slot writes are one token per step")
        rows = torch.arange(x.shape[0], device=x.device)
        cols = pos.to(torch.int64)
        for dst, src in zip(q[:3], new[:3]):
            dst[rows, cols] = src[:, 0]
        return q
    pos = int(pos)
    n = max(0, min(x.shape[1], q.codes.shape[1] - pos))
    for dst, src in zip(q[:3], new[:3]):
        dst[:, pos:pos + n] = src[:, :n]
    return q


# ---------------------------------------------------------------------------
# slot-cache construction / bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Shape/storage policy for the engine's slot cache."""
    num_slots: int
    max_len: int
    dtype: torch.dtype = torch.float32   # dense storage dtype
    quantized: bool = False              # INT8 per-head-group storage
    group_size: int = 0                  # 0 → head_dim (one group per head)


def init_slot_cache(model_cfg, cfg: KVCacheConfig, *, device="cuda") -> dict:
    """Fresh ``{"k", "v", "pos"}`` cache: (L, S, T, Hk, D) storage and a
    (S,) int32 per-slot position vector."""
    dev = resolve_device(device)
    hd = model_cfg.resolved_head_dim
    shape = (model_cfg.num_layers, cfg.num_slots, cfg.max_len,
             model_cfg.num_kv_heads, hd)

    def store():
        if not cfg.quantized:
            return torch.zeros(shape, dtype=cfg.dtype, device=dev)
        g = cfg.group_size or hd
        if hd % g:
            raise ValueError(f"KV group {g} does not divide head_dim {hd}")
        planes = shape[:-1] + (hd // g,)
        return QuantizedKV(
            codes=torch.zeros(shape, dtype=torch.uint8, device=dev),
            scale=torch.full(planes, 1e-4, dtype=torch.float16, device=dev),
            zero=torch.zeros(planes, dtype=torch.float16, device=dev),
            group_size=g)

    return {"k": store(), "v": store(),
            "pos": torch.zeros((cfg.num_slots,), dtype=torch.int32,
                               device=dev)}


def write_slot(cache: dict, slots, k_new: torch.Tensor,
               v_new: torch.Tensor) -> dict:
    """Splice B freshly prefilled slot rows into the cache, in place.

    ``slots``: B host slot indices (ints or a CPU tensor; a scalar is
    B == 1) — the engine's own bookkeeping. ``k_new``/``v_new``:
    (L, B, W, Hk, D) dense floats (the batched prefill's mini-caches),
    written at [:, slots[b], :W]. Rows whose slot is out of range (the
    batch-bucket padding carries slot == num_slots) and token columns past
    the cache edge are dropped, as the reference's scatter drops them."""
    slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
    entry0 = cache["k"]
    store = entry0.codes if isinstance(entry0, QuantizedKV) else entry0
    num_slots, t = store.shape[1], store.shape[2]
    keep = np.nonzero((slots >= 0) & (slots < num_slots))[0]
    w = min(k_new.shape[2], t)
    if keep.size == 0 or w == 0:
        return cache
    dev = store.device
    rows, idx = to_device(np.stack([keep, slots[keep]]), dev)
    for name, new in (("k", k_new), ("v", v_new)):
        new = new.index_select(1, rows)[:, :, :w]
        entry = cache[name]
        if isinstance(entry, QuantizedKV):
            qn = kv_quantize(new, entry.group_size)
            for dst, src in zip(entry[:3], qn[:3]):
                dst[:, idx, :w] = src.to(dev)
        else:
            entry[:, idx, :w] = new.to(device=dev, dtype=entry.dtype)
    return cache


def slot_rows(entry, slot: int):
    """One slot's (L, 1, T, Hk, D) rows of the (L, S, T, Hk, D) storage — a
    VIEW, so the chunked prefill writes straight into the cache."""
    slot = int(slot)
    if isinstance(entry, QuantizedKV):
        return QuantizedKV(entry.codes[:, slot:slot + 1],
                           entry.scale[:, slot:slot + 1],
                           entry.zero[:, slot:slot + 1], entry.group_size)
    return entry[:, slot:slot + 1]


def set_slot_rows(entry, slot: int, rows):
    """Write (L, 1, T, Hk, D) slot rows back into the storage, in place;
    nothing is copied when ``rows`` is already that slot's view (from
    :func:`slot_rows`)."""
    slot = int(slot)
    pairs = (zip(entry[:3], rows[:3]) if isinstance(entry, QuantizedKV)
             else [(entry, rows)])
    for dst, src in pairs:
        view = dst[:, slot:slot + 1]
        if src.data_ptr() != view.data_ptr() or src.stride() != view.stride():
            view.copy_(src)
    return entry


# ---------------------------------------------------------------------------
# paged storage (the block-table layout; serving/paging.py owns the
# allocator and refcounts, this layer the device tensors and the scatters)
# ---------------------------------------------------------------------------

def _leaves(entry):
    """The tensors of one storage entry: (codes, scale, zero) or (dense,)."""
    return tuple(entry[:3]) if isinstance(entry, QuantizedKV) else (entry,)


def _rebuild(entry, leaves):
    """An entry of ``entry``'s kind around ``leaves``."""
    if isinstance(entry, QuantizedKV):
        return QuantizedKV(*leaves, entry.group_size)
    return leaves[0]


def init_paged_storage(model_cfg, num_pages: int, page_size: int,
                       dtype=torch.float32, quantized: bool = False,
                       group_size: int = 0, *, device="cuda") -> dict:
    """Fresh ``{"k", "v"}`` page pools: (L, P, page_size, Hk, D) storage.

    Every page is allocatable; ``num_pages`` (P itself) is the sentinel
    page index (writes through it are dropped, reads clip to page P − 1).
    Quantized pools carry per-(page, token, head, group) scale and zero
    (initialized to 1e-4 and 0, as the reference's), so pages move
    (spill and restore, prefix sharing) without re-quantization."""
    dev = resolve_device(device)
    hd = model_cfg.resolved_head_dim
    shape = (model_cfg.num_layers, num_pages, page_size,
             model_cfg.num_kv_heads, hd)

    def store():
        if not quantized:
            return torch.zeros(shape, dtype=dtype, device=dev)
        g = group_size or hd
        if hd % g:
            raise ValueError(f"KV group {g} does not divide head_dim {hd}")
        planes = shape[:-1] + (hd // g,)
        return QuantizedKV(
            codes=torch.zeros(shape, dtype=torch.uint8, device=dev),
            scale=torch.full(planes, 1e-4, dtype=torch.float16, device=dev),
            zero=torch.zeros(planes, dtype=torch.float16, device=dev),
            group_size=g)

    return {"k": store(), "v": store()}


def write_pages(kv: dict, page_map, k_new: torch.Tensor,
                v_new: torch.Tensor, page_size: int) -> dict:
    """Splice B freshly prefilled (L, B, W, Hk, D) mini-caches into the
    page pools through per-row page maps, in place — the paged mirror of
    :func:`write_slot`.

    ``page_map``: (B, ceil(W / page_size)) host ints (the engine's own
    bookkeeping), the physical page of each page column of each row.
    Columns whose page is the sentinel (>= P) are dropped: batch-padding
    rows carry all-sentinel maps, and a row's map holds exactly
    ceil(prompt_len / page_size) live pages, so the bucket-padded tail past
    the last allocated page is dropped (the garbage inside the last live
    page is overwritten by decode writes in position order before it is
    ever attended)."""
    page_map = np.asarray(page_map, dtype=np.int64)
    if page_map.ndim == 1:
        page_map = page_map[None]
    store = _leaves(kv["k"])[0]
    num_pages = store.shape[1]
    w = k_new.shape[2]
    cols = np.arange(w)
    pages = page_map[:, cols // page_size]                      # (B, W)
    rows, wi = np.nonzero((pages >= 0) & (pages < num_pages))
    if rows.size == 0:
        return kv
    idx = to_device(np.stack([rows, wi, pages[rows, wi],
                              wi % page_size]), store.device)
    b_i, w_i, p_i, o_i = idx
    for name, new in (("k", k_new), ("v", v_new)):
        entry = kv[name]
        sel = new[:, b_i, w_i]                                  # (L, N, Hk, D)
        if isinstance(entry, QuantizedKV):
            src = _leaves(kv_quantize(sel, entry.group_size))
        else:
            src = (sel,)
        for dst, val in zip(_leaves(entry), src):
            dst[:, p_i, o_i] = val.to(device=dst.device, dtype=dst.dtype)
    return kv


def paged_view(entry, table: torch.Tensor):
    """Each block-table row's pages gathered into a contiguous view: one
    layer's pool (P, page, Hk, D) + table (B, n_pages) → (B, n_pages·page,
    Hk, D), planes alike. Sentinel entries clip to page P − 1; those
    positions lie past every live query's causal mask."""
    from repro_torch.kernels.ref import gather_pages
    return _rebuild(entry, [gather_pages(t, table) for t in _leaves(entry)])


def take_pages(entry, pages) -> tuple:
    """Whole pages across all layers: (L, P, page, …) storage and N page
    indices → a tuple of (L, N, page, …) tensors, one per leaf (codes,
    scale, zero; or the dense values). The spill reads through this."""
    leaves = _leaves(entry)
    idx = to_device(np.asarray(pages, dtype=np.int64), leaves[0].device)
    return tuple(t.index_select(1, idx) for t in leaves)


def put_pages(entry, pages, rows) -> object:
    """Scatter whole-page payloads (the leaves of :func:`take_pages`, on
    the storage's device) back into the pools at ``pages``, in place:
    host ints, or an int64 tensor on the storage's device (the restore's,
    uploaded with its payload). Every index must be a page of the pool —
    the reference drops sentinel indices because it pads the page count
    to a power of two; the port moves exactly the request's pages."""
    leaves = _leaves(entry)
    if not torch.is_tensor(pages):
        pages = to_device(np.asarray(pages, dtype=np.int64),
                          leaves[0].device)
    for dst, src in zip(leaves, rows):
        dst[:, pages] = src.to(dst.dtype)
    return entry


def cache_bytes(cache: dict) -> int:
    """Resident bytes of the K/V storage (excludes the tiny pos vector)."""
    total = 0
    for name in ("k", "v"):
        entry = cache[name]
        total += (entry.nbytes() if isinstance(entry, QuantizedKV)
                  else entry.numel() * entry.element_size())
    return total


def cache_is_finite(cache: dict) -> bool:
    """Diagnostic for the engine's non-finite-logit guard: True when every
    float plane of the K/V storage (dense values, INT8 scales and zeros)
    is finite. One device reduction per plane — not a per-step check."""
    for name in ("k", "v"):
        entry = cache[name]
        leaves = ([entry.scale, entry.zero] if isinstance(entry, QuantizedKV)
                  else [entry])
        for leaf in leaves:
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                return False
    return True


__all__ = ["INV_255", "KVCacheConfig", "QuantizedKV", "cache_bytes",
           "cache_is_finite", "fused_decode_attn", "init_paged_storage",
           "init_slot_cache", "kv_dequantize", "kv_quantize", "kv_update",
           "paged_view", "put_pages", "set_slot_rows", "slot_rows",
           "take_pages", "write_pages", "write_slot"]
