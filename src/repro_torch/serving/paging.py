"""Page-pool bookkeeping for the paged KV cache (the port of
``repro/serving/paging.py``).

The paged engine replaces per-slot contiguous cache rows with a fixed pool
of ``num_pages`` pages of ``page_size`` tokens each (storage in
:mod:`.kv_cache`: ``(L, P, page, Hk, D)`` dense or INT8
:class:`~.kv_cache.QuantizedKV` with per-page planes). Each live request
owns a block table — a host-side list of physical page indices covering
its token positions — and the device sees those tables only as int32
data that goes up with each step's inputs.

This module is the host side of that design:

- :class:`PageAllocator` — a free-list allocator with per-page refcounts.
  A page is held by the request(s) whose block tables contain it and, for
  full prompt pages, by the prefix cache (:class:`~.prefix_cache.
  PrefixCache`); it returns to the free list when the last reference
  drops. Double-free and incref-after-free raise.
- :func:`spill_pages` / :func:`restore_pages` — preemption support: copy
  a victim's pages of both pools to host memory in ONE device-to-host
  transfer, and on resume upload them in ONE non-blocking copy from pinned
  memory and scatter them into freshly allocated pages. Payloads carry raw
  storage (INT8 codes and f16 planes move as they are), so a resumed
  request's cache holds the same bytes as before the spill. The reference
  pads the page count to a power of two to bound its compiled gather
  shapes; eager PyTorch compiles nothing per shape, so the port moves
  exactly the request's pages.

Sentinel convention (shared with kv_cache and the engine): page index
``num_pages`` marks an unallocated block-table entry. Writes through it
are dropped; reads clip to the last physical page and are always masked
or discarded.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import to_device, to_host
from repro_torch.serving.kv_cache import put_pages, take_pages


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class PageAllocator:
    """Free-list page allocator with refcounts. Pure host bookkeeping —
    the device pool itself lives in the engine's kv dict.

    ``faults`` (a :class:`~.faults.FaultPlan`) lets tests inject allocation
    failures: a faulted :meth:`alloc` reports pool-dry without touching
    state, driving callers through their real escalation paths (prefix
    eviction → preemption → wait)."""

    def __init__(self, num_pages: int, faults=None):
        if num_pages < 1:
            raise ValueError(f"page pool needs >= 1 page, got {num_pages}")
        self.num_pages = num_pages          # also the sentinel index
        self.faults = faults
        self._free: deque = deque(range(num_pages))
        self._refs: Dict[int, int] = {}     # page -> refcount (live pages)
        self.peak_in_use = 0
        self.alloc_calls = 0                # alloc() attempts (incl. failed)
        self.alloc_failures = 0             # pool-dry / injected failures

    # -- queries -----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        """0 for free pages."""
        return self._refs.get(page, 0)

    def refs(self) -> Dict[int, int]:
        """Snapshot of live page -> refcount (the engine's invariant
        checker reconciles it against block tables + prefix cache)."""
        return dict(self._refs)

    def free_pages(self) -> List[int]:
        """Snapshot of the free list, in pop order."""
        return list(self._free)

    # -- alloc/free --------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages (refcount 1 each), or None if the pool is short —
        the caller escalates (evict prefix entries, preempt a request)."""
        self.alloc_calls += 1
        if self.faults is not None and self.faults.fail_alloc():
            self.alloc_failures += 1
            return None                     # injected: pretend pool-dry
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return pages

    def incref(self, pages) -> None:
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"incref on free page {p}")
            self._refs[p] += 1

    def decref(self, pages) -> int:
        """Drop one reference per page; pages reaching zero return to the
        free list. Returns the number of pages actually freed."""
        freed = 0
        for p in pages:
            rc = self._refs.get(p)
            if rc is None:
                raise ValueError(f"double free of page {p}")
            if rc == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = rc - 1
        return freed


# ---------------------------------------------------------------------------
# preemption spill/restore
# ---------------------------------------------------------------------------

def spill_pages(kv: dict, pages: List[int]) -> dict:
    """``pages`` of both pools in host memory → payload ``{"k": leaves,
    "v": leaves}``, each leaf a numpy (L, n, page, …) array (codes, scale
    and zero, or the dense values). One device-to-host transfer
    (:func:`~repro_torch.device.to_host`): the one wait of the host on the
    card a preemption costs."""
    k, v = take_pages(kv["k"], pages), take_pages(kv["v"], pages)
    host = to_host(list(k) + list(v))
    return {"k": tuple(host[:len(k)]), "v": tuple(host[len(k):])}


def restore_pages(kv: dict, pages: List[int], payload: dict) -> dict:
    """Scatter a spilled payload into freshly allocated ``pages`` (as many
    as at spill time), in place. The payload's bytes and the page indices
    go up in ONE non-blocking copy from pinned memory
    (:func:`~repro_torch.device.to_device`), cut apart on the device, so
    the host does not wait."""
    leaves = list(payload["k"]) + list(payload["v"])
    n = leaves[0].shape[1]
    if n != len(pages):
        raise ValueError(f"payload of {n} pages restored into {len(pages)}")
    parts, offs, off = [], [], 0
    for a in [np.asarray(pages, dtype=np.int64)] + leaves:
        raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        pad = (-raw.size) % 16                  # keep every part aligned
        parts += [raw, np.zeros(pad, np.uint8)]
        offs.append(off)
        off += raw.size + pad
    store = kv["k"].codes if hasattr(kv["k"], "codes") else kv["k"]
    buf = to_device(np.concatenate(parts), store.device)
    dev = []
    for a, o in zip([np.asarray(pages, dtype=np.int64)] + leaves, offs):
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        dev.append(buf[o:o + a.nbytes].view(dtype).reshape(a.shape))
    idx, rows = dev[0], dev[1:]
    nk = len(payload["k"])
    put_pages(kv["k"], idx, rows[:nk])
    put_pages(kv["v"], idx, rows[nk:])
    return kv


__all__ = ["PageAllocator", "pow2_at_least", "restore_pages", "spill_pages"]
