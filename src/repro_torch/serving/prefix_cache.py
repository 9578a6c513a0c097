"""Token-prefix → page-sequence cache for the paged KV engine (a copy of
``repro/serving/prefix_cache.py``; pure host code).

Shared system prompts and few-shot headers dominate production traffic;
with the page pool, their K/V only needs to exist once. This cache maps
page-aligned token prefixes to the physical pages already holding their
K/V, so a request whose prompt starts with a cached prefix is admitted
*copy-free*: its block table points at the shared pages, and only the
suffix (everything past the matched pages) runs through prefill.

Prefix-hash contract
--------------------
Entries are keyed by a rolling chain hash: ``h_i = blake2b(h_{i-1} ||
tokens[i·page : (i+1)·page])`` over the int32 bytes of the tokens, 16-byte
digests — the reference's hashes, byte for byte. Matching walks pages left
to right and stops at the first miss, so a hit is always a *prefix* of
pages and two prompts sharing i pages share exactly the first i entries.
Only FULL pages are ever cached (a partial page's contents depend on what
decode appends later), and a match is capped at ``(prompt_len - 1) //
page`` pages so every admitted request still prefills at least one real
token (the engine needs a last-token logit to sample from).

Copy-on-write, by construction: shared pages are never written after
insertion. A request diverging at page i gets page i freshly allocated
(the "copy"), writes only there, and the shared pages 0..i-1 stay
byte-stable.

Refcounts: the cache holds one reference per cached page (on top of the
owning request's), so cached pages survive their creator's retirement.
Eviction walks LRU-first and only drops entries whose page would actually
free (refcount 1 — no live request uses it); an interior eviction makes
deeper entries unreachable for matching, but they stay refcounted and age
out of the LRU themselves, so no page leaks.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Tuple

import numpy as np

from repro_torch.serving.paging import PageAllocator


class PrefixCache:
    """Page-granularity prefix reuse over a :class:`PageAllocator`."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = page_size
        self.alloc = allocator
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  # hash->page
        self.evicted_pages = 0
        self.inserted_pages = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_pages(self) -> int:
        return len(self._entries)

    def pages(self) -> List[int]:
        """Every page the cache currently holds a reference on (including
        entries made unreachable by an interior eviction) — the engine's
        invariant checker reconciles refcounts against this."""
        return list(self._entries.values())

    def _hashes(self, tokens, n_pages: int):
        pg = self.page_size
        toks = np.asarray(tokens, np.int32)
        h = b""
        for i in range(n_pages):
            h = hashlib.blake2b(h + toks[i * pg:(i + 1) * pg].tobytes(),
                                digest_size=16).digest()
            yield h

    # -- lookup ------------------------------------------------------------
    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest cached page-prefix of ``tokens`` → (pages, n_tokens).

        Takes one reference on every matched page (the caller's block table
        owns them from here; roll back with ``allocator.decref`` if the
        admission is abandoned). Capped below the full prompt so at least
        one token remains to prefill."""
        limit = (len(tokens) - 1) // self.page_size
        pages: List[int] = []
        for h in self._hashes(tokens, limit):
            page = self._entries.get(h)
            if page is None:
                break
            self._entries.move_to_end(h)
            pages.append(page)
        if pages:
            self.alloc.incref(pages)
        return pages, len(pages) * self.page_size

    # -- insert ------------------------------------------------------------
    def insert(self, tokens, pages: List[int]) -> int:
        """Cache the full prompt pages of a just-prefilled request.

        ``pages`` is the request's block-table page run; only the first
        ``len(tokens) // page_size`` (full) pages are cached. Pages already
        cached (the matched prefix, or a concurrent twin's insert) are
        touched, not re-inserted — the twin keeps its private copy. Returns
        the number of newly cached pages (each gains a cache reference)."""
        n = min(len(tokens) // self.page_size, len(pages))
        added = 0
        for i, h in enumerate(self._hashes(tokens, n)):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            self._entries[h] = pages[i]
            self.alloc.incref([pages[i]])
            added += 1
        self.inserted_pages += added
        return added

    # -- eviction ----------------------------------------------------------
    def evict(self, need: int = 1) -> int:
        """Free up to ``need`` pages by dropping LRU entries whose page is
        only held by the cache (refcount 1). Returns pages actually freed."""
        freed = 0
        for h in list(self._entries):
            if freed >= need:
                break
            page = self._entries[h]
            if self.alloc.refcount(page) == 1:
                del self._entries[h]
                freed += self.alloc.decref([page])
        self.evicted_pages += freed
        return freed

    def clear(self) -> None:
        """Release every cached page (warmup teardown)."""
        for page in self._entries.values():
            self.alloc.decref([page])
        self._entries.clear()


__all__ = ["PrefixCache"]
