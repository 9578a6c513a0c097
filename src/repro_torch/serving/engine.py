"""Continuous-batching serving engine over a slot or paged KV cache (the
port of ``repro/serving/engine.py``).

The engine owns the KV cache (:mod:`.kv_cache`; dense or INT8
per-head-group) and three step functions:

- **prefill**: the model over a whole same-bucket admission batch of
  right-padded prompts against a fresh dense (L, B, W) mini-cache, logits
  at each row's last real token, first tokens sampled on the device, and
  the B mini-caches spliced into the cache in one call —
  :func:`~.kv_cache.write_slot` into the admitted slots' rows, or
  :func:`~.kv_cache.write_pages` through per-row page maps (batch sizes
  round up to power-of-two batch buckets; padding rows carry slot ==
  num_slots, or all-sentinel page maps, and are dropped);
- **chunk**: one bucket-width chunk of a prompt against the cache: the
  chunk's K/V is written at [start, start + W) and attention reads the
  cache under the offset causal mask (``model.prefill_chunk``; on the INT8
  cache the rows are expanded by K5). The slot layout runs it for prompts
  beyond the largest bucket against the slot's own rows; the paged layout
  also for the suffix of a prefix-cache hit, reading the pools through the
  slot's table row;
- **decode**: one token for all slots at once. Each slot reads and writes
  the cache at its own position; the cache read is K6 (slots) or K6p
  through the (S, n_pages) block tables (pages), with
  ``use_fused_decode``; per-slot sampling parameters ride along as
  tensors, and one (S, 2) int32 tensor — token and finite-logit flag —
  crosses to the host per step. Each step function's inputs (the tables
  included) go up in one non-blocking copy from pinned memory, so the host
  never waits on the card mid-step.

The host-side :class:`~.scheduler.Scheduler` feeds it: FIFO admission onto
the slot free-list, prompt-length buckets, retire on completion. Retired
slots keep decoding at position 0 until reused; on the slot layout their
writes land below the next request's prefill splice and are never
attended, on the paged layout their all-sentinel table rows drop them.

``kv_layout="paged"`` (:mod:`.paging`, :mod:`.prefix_cache`) swaps the slot
rows for a fixed pool of fixed-size pages routed through per-slot block
tables. On top of the indirection ride copy-free shared-prefix admission
(a prefix cache maps page-aligned token prefixes to live pages; only the
suffix prefills) and preempt-and-resume (under page pressure the youngest
request's pages spill to host memory in one transfer and its
:class:`~.scheduler.ResumeTicket` re-enters the queue by seq; a resume
uploads them in one non-blocking copy). Greedy outputs equal the slot
layout's when the page size divides max_len.

Telemetry (:mod:`repro_torch.obs`, as in the reference): every dispatch
and utilization counter is a child of the engine's
:class:`~repro_torch.obs.MetricsRegistry` under the ``layout`` and ``kv``
labels, and the legacy integer attributes (``engine.decode_steps`` …) are
read-only views over them; ``queue_stats`` is a view over the
``engine_queue_depth`` gauge's ring. Each request carries a
:class:`~repro_torch.obs.Trace` stamped on the engine's clock at submit,
admission, first token, preemption, resume and its terminal status, and
terminal results feed the queue, TTFT, TPOT and latency histograms. Every
observation is a host float or integer the engine already holds: no
telemetry waits on the card. ``metrics_snapshot`` exports it all.

What the reference has and this port leaves out: ``compile_counts``, which
has no counterpart in eager PyTorch: nothing is compiled per shape.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.obs import MetricsRegistry, Trace
from repro_torch.serving.kv_cache import (KVCacheConfig, cache_bytes,
                                          init_paged_storage,
                                          init_slot_cache, set_slot_rows,
                                          slot_rows, write_pages, write_slot)
from repro_torch.serving.paging import (PageAllocator, restore_pages,
                                        spill_pages)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.scheduler import (AdmittedBatch,
                                           DuplicateRequestError,
                                           EngineInvariantError,
                                           EngineStalledError,
                                           GenerationRequest,
                                           GenerationResult,
                                           InvalidRequestError,
                                           QueueFullError, RequestStatus,
                                           ResumeTicket, Scheduler)

# the dispatch and utilization counters: engine_<name>_total families
_COUNTER_HELP = (
    ("decode_steps", "decode dispatches"),
    ("active_slot_steps", "slot-steps that carried a live request"),
    ("prefill_dispatches", "batched-prefill device calls"),
    ("prefill_admitted", "requests admitted via batched prefill"),
    ("chunk_dispatches", "chunked-prefill device calls"),
    ("chunked_admitted", "requests admitted via chunking"),
    ("prefix_hits", "admissions with a cached prefix"),
    ("prefix_misses", "admissions without one (paged only)"),
    ("prefix_hit_tokens", "prompt tokens skipped via prefix reuse"),
    ("preemptions", "requests spilled under page pressure"),
    ("resumes", "tickets restored onto a slot"),
    ("pages_spilled", "pages round-tripped through host memory"),
    ("rejected", "try_submit load-shed rejections"),
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape/storage policy. ``kv_quantized`` switches the cache to
    INT8 per-head-group storage (``kv_group_size=0`` → one group per
    head); ``prompt_buckets=()`` → power-of-two buckets covering max_len,
    and prompts beyond the largest bucket stream through the chunked
    prefill. ``mixed_admission`` lets one prefill admit a FIFO head-run
    that crosses prompt buckets. ``max_queue`` bounds the backlog (0 →
    unbounded; a submit past it raises :class:`QueueFullError`).
    ``stall_patience`` is how many consecutive no-progress steps
    :meth:`Engine.run` tolerates with work outstanding.
    ``use_fused_decode`` (default on) reads the decode cache through K6
    (K6p on the paged layout); False is the expand-then-attend reference.

    ``kv_layout="paged"`` switches the cache from per-slot contiguous rows
    to a fixed pool of ``page_size``-token pages routed through per-slot
    block tables (``num_pages=0`` → num_slots · ceil(max_len / page_size),
    the slot layout's token capacity). It enables copy-free shared-prefix
    admission (``prefix_caching``) and preempt-and-resume under page
    pressure. Greedy output equals the slot layout's when ``page_size``
    divides ``max_len``."""
    num_slots: int = 8
    max_len: int = 256
    prompt_buckets: tuple = ()
    kv_dtype: Any = torch.float32
    kv_quantized: bool = False
    kv_group_size: int = 0
    max_top_k: int = 64
    kv_layout: str = "slots"           # "slots" | "paged"
    page_size: int = 16
    num_pages: int = 0                 # 0 → auto (slot-equivalent capacity)
    prefix_caching: bool = True        # paged only
    mixed_admission: bool = False
    max_queue: int = 0
    stall_patience: int = 8
    use_fused_decode: bool = True
    queue_trace_samples: int = 4096


def batch_buckets(num_slots: int) -> tuple:
    """Power-of-two prefill batch buckets 1, 2, … covering num_slots."""
    out, b = [], 1
    while b < num_slots:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


def _counter_view(key: str):
    """Legacy integer counter attribute backed by a registry child."""
    return property(lambda self: int(self._c[key].value))


class Engine:
    """Continuous batching over one decode program, on a slot or paged
    KV cache. ``registry`` receives the engine's telemetry (None: a
    registry of its own; ``MetricsRegistry(enabled=False)`` keeps the
    counters and drops the traces and histograms)."""

    def __init__(self, model, params, cfg: EngineConfig = EngineConfig(),
                 faults=None, registry: Optional[MetricsRegistry] = None):
        mcfg = model.cfg
        if mcfg.family not in ("dense", "moe") or mcfg.frontend:
            raise ValueError(f"the port's engine serves token-LM families "
                             f"(dense/moe), got {mcfg.family}/{mcfg.frontend}")
        if cfg.kv_layout not in ("slots", "paged"):
            raise ValueError(f"kv_layout must be 'slots' or 'paged', got "
                             f"{cfg.kv_layout!r}")
        if model.use_fused_decode != cfg.use_fused_decode:
            # a per-engine copy: never mutate the caller's model
            model = copy.copy(model)
            model.use_fused_decode = cfg.use_fused_decode
        self.model, self.params, self.cfg = model, params, cfg
        self.device = params["embed"].device
        self.faults = faults
        self.scheduler = Scheduler(cfg.num_slots, cfg.max_len,
                                   cfg.prompt_buckets)
        self.batch_buckets = batch_buckets(cfg.num_slots)
        s = cfg.num_slots
        self._paged = cfg.kv_layout == "paged"
        self.alloc: Optional[PageAllocator] = None
        self.prefix: Optional[PrefixCache] = None
        if self._paged:
            pg = cfg.page_size
            if pg < 1:
                raise ValueError(f"page_size must be >= 1, got {pg}")
            self.pages_per_slot = -(-cfg.max_len // pg)
            num_pages = cfg.num_pages or s * self.pages_per_slot
            if num_pages < self.pages_per_slot:
                # the oldest request is never preempted; it must always be
                # able to grow to max_len or admission can deadlock
                raise ValueError(
                    f"num_pages {num_pages} < pages_per_slot "
                    f"{self.pages_per_slot}: one max_len request must fit")
            self.kv = init_paged_storage(
                mcfg, num_pages, pg, dtype=cfg.kv_dtype,
                quantized=cfg.kv_quantized, group_size=cfg.kv_group_size,
                device=self.device)
            self.alloc = PageAllocator(num_pages, faults=faults)
            self.prefix = (PrefixCache(pg, self.alloc)
                           if cfg.prefix_caching else None)
            # block tables are host state; they go up with each step's
            # inputs (sentinel == num_pages wherever a slot has no page:
            # parked slots' decode writes are dropped)
            self._table = np.full((s, self.pages_per_slot), num_pages,
                                  np.int64)
            self._slot_pages: List[List[int]] = [[] for _ in range(s)]
        else:
            cache = init_slot_cache(mcfg, KVCacheConfig(
                num_slots=s, max_len=cfg.max_len, dtype=cfg.kv_dtype,
                quantized=cfg.kv_quantized, group_size=cfg.kv_group_size),
                device=self.device)
            self.kv = {"k": cache["k"], "v": cache["v"]}  # pos is host-side
        self._pos = np.zeros(s, np.int32)
        self._tok = np.zeros(s, np.int32)
        self._temps = np.zeros(s, np.float32)
        self._topks = np.zeros(s, np.int32)
        self._seeds = np.zeros(s, np.int64)
        self._steps = np.zeros(s, np.int64)
        self._results: Dict[int, GenerationResult] = {}
        self._done: List[GenerationResult] = []
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._init_metrics()
        self._reset_counters()

    # -- telemetry ---------------------------------------------------------
    def _init_metrics(self) -> None:
        """Register the engine's metric families (the reference's names,
        help strings, labels and buckets) and bind one child a family under
        this engine's constant labels."""
        m = self.metrics
        cfg = self.cfg
        self._mlabels = {"layout": cfg.kv_layout,
                         "kv": "int8" if cfg.kv_quantized else "dense"}
        names = tuple(sorted(self._mlabels))
        self._metric_children: List[Any] = []

        def counter(key: str, help: str):
            fam = m.counter(f"engine_{key}_total", help, labelnames=names)
            child = fam.labels(**self._mlabels)
            self._metric_children.append(child)
            return child

        self._c = {k: counter(k, h) for k, h in _COUNTER_HELP}
        self._g_queue = m.gauge(
            "engine_queue_depth", "scheduler backlog, sampled per step",
            labelnames=names,
            trace_capacity=cfg.queue_trace_samples).labels(**self._mlabels)
        self._g_slots = m.gauge(
            "engine_slots_active", "slots holding a live request",
            labelnames=names).labels(**self._mlabels)
        self._g_pages = m.gauge(
            "engine_pages_in_use", "allocated KV pages (paged layout)",
            labelnames=names).labels(**self._mlabels)
        self._g_prefix_pages = m.gauge(
            "engine_prefix_cached_pages", "pages held by the prefix cache",
            labelnames=names).labels(**self._mlabels)
        self._metric_children += [self._g_queue, self._g_slots,
                                  self._g_pages, self._g_prefix_pages]

        def hist(key: str, help: str):
            fam = m.histogram(key, help, labelnames=names, unit="seconds")
            child = fam.labels(**self._mlabels)
            self._metric_children.append(child)
            return child

        self._h_queue = hist("request_queue_seconds",
                             "submit to first admission")
        self._h_ttft = hist("request_ttft_seconds",
                            "submit to first generated token")
        self._h_tpot = hist("request_tpot_seconds",
                            "mean seconds per generated token after the first")
        self._h_latency = hist("request_latency_seconds",
                               "submit to terminal status")
        # the per-status counters bind their children lazily (statuses
        # appear as results do); the families are registered up front
        m.counter("engine_requests_total", "terminal results by status",
                  labelnames=names + ("status",))
        m.counter("engine_tokens_generated_total",
                  "generated tokens in terminal results by status",
                  labelnames=names + ("status",))
        self._status_children: Dict[tuple, Any] = {}

    def _status_counter(self, name: str, status: str):
        child = self._status_children.get((name, status))
        if child is None:
            fam = self.metrics.counter(f"engine_{name}_total")
            child = fam.labels(status=status, **self._mlabels)
            self._status_children[(name, status)] = child
            self._metric_children.append(child)
        return child

    def _reset_counters(self) -> None:
        for child in self._metric_children:
            child.reset()
        if self.alloc is not None:
            self.alloc.peak_in_use = self.alloc.pages_in_use
            self.alloc.alloc_calls = 0
            self.alloc.alloc_failures = 0

    # legacy counter attributes: read-only views over the registry
    decode_steps = _counter_view("decode_steps")
    active_slot_steps = _counter_view("active_slot_steps")
    prefill_dispatches = _counter_view("prefill_dispatches")
    prefill_admitted = _counter_view("prefill_admitted")
    chunk_dispatches = _counter_view("chunk_dispatches")
    chunked_admitted = _counter_view("chunked_admitted")
    prefix_hits = _counter_view("prefix_hits")
    prefix_misses = _counter_view("prefix_misses")
    prefix_hit_tokens = _counter_view("prefix_hit_tokens")
    preemptions = _counter_view("preemptions")
    resumes = _counter_view("resumes")
    pages_spilled = _counter_view("pages_spilled")
    rejected = _counter_view("rejected")

    def _observe_terminal(self, res: GenerationResult) -> None:
        """Terminal observations: close the trace, count the result by
        status, feed the latency histograms (host floats only)."""
        if res.trace is not None:
            res.trace.finish(res.status, res.t_finish)
        self._status_counter("requests", res.status).inc()
        if res.tokens:
            self._status_counter("tokens_generated",
                                 res.status).inc(len(res.tokens))
        if not self.metrics.enabled:
            return
        if res.status != RequestStatus.REJECTED.value:
            # rejected requests never entered the queue; everyone else gets
            # a queue-time sample (the whole lifetime when never admitted)
            self._h_queue.observe(res.queue_time)
        if res.t_first_token > 0.0:
            self._h_ttft.observe(res.ttft)
            if len(res.tokens) > 1:
                self._h_tpot.observe(res.tpot)
        self._h_latency.observe(res.latency)

    def set_faults(self, plan) -> None:
        """Attach or replace the :class:`~.faults.FaultPlan` (engine hooks
        and the page allocator). Attach after :meth:`warmup` so scripted
        steps count from the first real step."""
        self.faults = plan
        if self.alloc is not None:
            self.alloc.faults = plan

    def _now(self) -> float:
        """The fault plan's virtual clock when one is attached, else the
        wall clock."""
        return (self.faults.now() if self.faults is not None
                else time.perf_counter())

    # -- device helpers ----------------------------------------------------
    def _upload(self, *arrays) -> List[torch.Tensor]:
        """A step's host inputs on the device in ONE non-blocking copy,
        issued before the forward (:func:`~repro_torch.device.to_device`:
        a pageable copy would make the host wait for the queued forward
        before it could queue the sampler). Integer arrays come back as
        int64, float32 arrays travel as their bits and come back as
        float32; each in its own shape."""
        flat = [np.asarray(a) for a in arrays]
        buf = np.concatenate([
            (a.view(np.int32) if a.dtype == np.float32 else a)
            .astype(np.int64).ravel() for a in flat])
        dev = to_device(buf, self.device)
        out, off = [], 0
        for a in flat:
            part = dev[off:off + a.size].view(a.shape)
            off += a.size
            if a.dtype == np.float32:
                part = part.to(torch.int32).view(torch.float32)
            out.append(part)
        return out

    def _prefill(self, tokens, lengths, route, temps, topks, seeds):
        """Batched prefill of right-padded prompts into a dense mini-cache,
        first tokens sampled, spliced into the cache: ``route`` is the
        rows' slots (host ints) on the slot layout, their (B, n) page maps
        on the paged one. The same math on both layouts; only the splice
        differs."""
        mcfg = self.model.cfg
        b, w = tokens.shape
        tokens_d, lengths_d, temps_d, topks_d, seeds_d, steps_d = \
            self._upload(tokens, lengths, temps, topks, seeds,
                         np.zeros(b, np.int64))
        mini_dtype = torch.float32 if self.cfg.kv_quantized \
            else self.cfg.kv_dtype
        shape = (mcfg.num_layers, b, w, mcfg.num_kv_heads,
                 mcfg.resolved_head_dim)
        mini = {"k": torch.zeros(shape, dtype=mini_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=mini_dtype, device=self.device),
                "pos": 0}
        logits, mini = self.model.prefill_at(
            self.params, {"tokens": tokens_d}, mini, lengths=lengths_d)
        toks = sample_tokens(logits[:, 0, :], temps_d, topks_d, seeds_d,
                             steps_d, max_top_k=self.cfg.max_top_k)
        if self._paged:
            write_pages(self.kv, route, mini["k"], mini["v"],
                        self.cfg.page_size)
        else:
            write_slot(self.kv, route, mini["k"], mini["v"])
        return toks

    def _chunk(self, tokens, start: int, length: int, slot: int,
               temp: float, topk: int, seed: int):
        """One chunk of a prompt against slot ``slot``'s own rows, or on
        the paged layout against the pools through its table row."""
        extra = [self._table[slot:slot + 1]] if self._paged else []
        tokens_d, length_d, temp_d, topk_d, seed_d, step_d, *table_d = \
            self._upload(tokens, [length], np.float32([temp]), [topk],
                         [seed], [0], *extra)
        if self._paged:
            cache = {"k": self.kv["k"], "v": self.kv["v"], "pos": start,
                     "table": table_d[0].to(torch.int32)}
        else:
            cache = {"k": slot_rows(self.kv["k"], slot),
                     "v": slot_rows(self.kv["v"], slot), "pos": start}
        logits, cache = self.model.prefill_chunk(
            self.params, {"tokens": tokens_d}, cache, lengths=length_d)
        tok = sample_tokens(logits[:, 0, :], temp_d, topk_d, seed_d, step_d,
                            max_top_k=self.cfg.max_top_k)
        if not self._paged:
            set_slot_rows(self.kv["k"], slot, cache["k"])
            set_slot_rows(self.kv["v"], slot, cache["v"])
        return tok[0]

    def _decode(self) -> torch.Tensor:
        """One token for every slot → (S, 2) int32 [token, finite] on the
        device."""
        extra = [self._table] if self._paged else []
        pos, tok, temps, topks, seeds, steps, *tables = self._upload(
            self._pos, self._tok[:, None], self._temps, self._topks,
            self._seeds, self._steps, *extra)
        cache = {"k": self.kv["k"], "v": self.kv["v"], "pos": pos}
        if self._paged:
            cache["table"] = tables[0].to(torch.int32)
        logits, _ = self.model.decode_step(self.params, tok, cache)
        lg = logits[:, 0, :]
        tok = sample_tokens(lg, temps, topks, seeds, steps,
                            max_top_k=self.cfg.max_top_k)
        ok = torch.isfinite(lg).all(dim=-1)
        return torch.stack([tok.to(torch.int32), ok.to(torch.int32)], dim=-1)

    # -- request API -------------------------------------------------------
    def submit(self, req: GenerationRequest) -> None:
        """Enqueue a request. Raises :class:`DuplicateRequestError` for an
        rid already in flight, :class:`InvalidRequestError` for a request
        that can never be admitted (bad shape, or a prompt needing more
        pages than the whole pool), :class:`QueueFullError` past
        ``max_queue``."""
        if req.rid in self._results:
            raise DuplicateRequestError(
                f"request rid={req.rid} is already in flight")
        if self._paged:
            need = -(-req.prompt_len // self.cfg.page_size)
            if need > self.alloc.num_pages:
                raise InvalidRequestError(
                    f"request rid={req.rid}: prompt needs {need} pages but "
                    f"the pool has {self.alloc.num_pages} — can never be "
                    f"admitted")
        if (self.cfg.max_queue > 0 and req.rid >= 0
                and len(self.scheduler.queue) >= self.cfg.max_queue):
            # negative rids are warmup clones — internal, never shed
            raise QueueFullError(
                f"request rid={req.rid} rejected: queue at "
                f"max_queue={self.cfg.max_queue}")
        self.scheduler.submit(req)
        now = self._now()
        res = GenerationResult(rid=req.rid, prompt_len=req.prompt_len,
                               tokens=[], t_enqueue=now)
        if self.metrics.enabled:
            res.trace = Trace(req.rid, now)
        self._results[req.rid] = res

    def try_submit(self, req: GenerationRequest) -> bool:
        """Load-shedding submit: capacity and validity rejections become a
        terminal ``rejected`` result (surfaced by :meth:`run`); duplicate
        rids still raise."""
        try:
            self.submit(req)
            return True
        except DuplicateRequestError:
            raise
        except (QueueFullError, InvalidRequestError) as e:
            now = self._now()
            res = GenerationResult(
                rid=req.rid, prompt_len=req.prompt_len, tokens=[],
                t_enqueue=now, t_finish=now,
                status=RequestStatus.REJECTED.value,
                finish_reason=RequestStatus.REJECTED.value, error=str(e))
            if self.metrics.enabled:
                res.trace = Trace(req.rid, now)
            self._c["rejected"].inc()
            self._observe_terminal(res)
            self._done.append(res)
            return False

    def cancel(self, rid: int) -> bool:
        """Cancel an in-flight request: a queued one leaves the queue (a
        preempted one's ticket too: its spilled host payload dies with
        it), a running one is failed out of its slot with its pages
        reclaimed; either way its partial tokens are emitted in a terminal
        ``cancelled`` result. False when the rid is unknown or already
        finished."""
        if rid not in self._results:
            return False
        item = self.scheduler.remove(rid)
        if item is not None:
            self._finish_queued(item, RequestStatus.CANCELLED.value)
            return True
        for slot in self.scheduler.active_slots():
            if self.scheduler.slots[slot].request.rid == rid:
                self._fail_slot(slot, RequestStatus.CANCELLED.value)
                return True
        return False

    def _expire_deadlines(self) -> None:
        """Terminal-fail every request whose ``deadline_s`` has elapsed
        since submit (queued or running), at each step boundary."""
        now = self._now()
        sched = self.scheduler
        expired = []
        for item in sched.queue:
            req = item.request if isinstance(item, ResumeTicket) else item
            if (req.deadline_s > 0 and req.rid in self._results
                    and now - self._results[req.rid].t_enqueue
                    >= req.deadline_s):
                expired.append(req.rid)
        for rid in expired:
            self._finish_queued(sched.remove(rid),
                                RequestStatus.DEADLINE.value)
        for slot in list(sched.active_slots()):
            req = sched.slots[slot].request
            if (req.deadline_s > 0
                    and now - self._results[req.rid].t_enqueue
                    >= req.deadline_s):
                self._fail_slot(slot, RequestStatus.DEADLINE.value)

    def warmup(self, reqs) -> None:
        """Run, fault-free and uncounted, one short clone of a request per
        distinct prompt bucket in ``reqs`` (and of the first prompt beyond
        the largest bucket, through the chunked prefill), so that the
        kernels are built and loaded and the allocator and cuBLAS are warm
        before timing starts. Nothing is compiled per shape in eager
        PyTorch, so the reference's all-padding prefill grid is not
        replayed. Requires an idle engine (it drains the scheduler);
        clones carry negative rids and their results are dropped. On the
        paged layout it empties the prefix cache after the clones and
        leaves no page in use."""
        if not self.scheduler.idle:
            raise RuntimeError(
                "Engine.warmup on a non-idle engine: warmup drains the "
                "scheduler, which would silently execute and discard "
                "already-submitted requests — warm up first, then submit")
        plan = self.faults
        self.set_faults(None)
        wmax = self.scheduler.buckets[-1]
        seen: Dict[int, GenerationRequest] = {}
        long_req = None
        for r in reqs:
            if r.prompt_len > wmax:
                long_req = long_req or r
            else:
                seen.setdefault(self.scheduler.bucket_for(r.prompt_len), r)
        clones = list(seen.values()) + ([long_req] if long_req else [])
        wid = -1
        for r in clones:
            plen = min(r.prompt_len, self.cfg.max_len - 1)
            nnew = min(2, self.cfg.max_len - plen)
            self.submit(GenerationRequest(rid=wid, prompt=r.prompt[:plen],
                                          max_new_tokens=nnew,
                                          sampling=r.sampling))
            wid -= 1
        real = [r for r in self.run() if r.rid >= 0]
        self._done.extend(real)
        if self.prefix is not None:
            # the clones seeded the prefix cache with warmup prompts: drop
            # them so hit/miss counts start clean
            self.prefix.clear()
        if self.alloc is not None and self.alloc.pages_in_use:
            raise EngineInvariantError(
                f"warmup leaked {self.alloc.pages_in_use} pages")
        self._reset_counters()
        self.set_faults(plan)

    def step(self) -> None:
        """Admit every admissible request (one batched prefill per FIFO
        head-run, the chunked prefill for prompts beyond the largest
        bucket and, paged, for prefix-hit suffixes; page restoration for
        resume tickets), back every live slot's next position with a page
        (paged), then one decode step for all slots. Failure-atomic: a
        fault in the step (a failed spill or restore, an injected
        allocation failure, non-finite decode logits, a prefill raising)
        fails only the culpable request(s), rolls back their page and slot
        acquisitions, and keeps the rest serving;
        :meth:`check_invariants` holds at every step boundary."""
        sched = self.scheduler
        if self.faults is not None:
            self.faults.tick()
        self._expire_deadlines()
        # the backlog at each step boundary: peak, mean and samples in the
        # gauge child, the most recent queue_trace_samples in its ring
        self._g_queue.set(len(sched.queue))
        if self._paged:
            self._admit_paged()
        else:
            while (batch := sched.admit_batch(
                    mixed=self.cfg.mixed_admission)) is not None:
                try:
                    if batch.chunked:
                        self._run_chunked(*batch.items[0])
                    else:
                        self._run_prefill_batch(batch)
                except Exception as e:      # noqa: BLE001 — fault isolation
                    self._abort_admission(batch.items, e)

        if sched.num_active == 0:
            return
        if self._paged:
            self._extend_for_decode()
            if sched.num_active == 0:      # extension self-preempted all
                return
        # lint: allow[host-sync] THE one transfer per decode step (S, 2): token + finite flag
        out = self._decode().cpu().numpy()
        toks, finite = out[:, 0], out[:, 1]
        now = self._now()
        self._c["decode_steps"].inc()
        self._c["active_slot_steps"].inc(sched.num_active)
        for slot in list(sched.active_slots()):
            state = sched.slots[slot]
            rid = state.request.rid
            bad = not finite[slot]
            if self.faults is not None and self.faults.poison_logits(rid):
                bad = True
            if bad:
                # the sampled token is garbage: fail this slot alone
                self._fail_slot(slot, RequestStatus.ERROR.value,
                                "non-finite decode logits")
                continue
            tok = int(toks[slot])
            state.generated += 1
            self._results[rid].tokens.append(tok)
            self._pos[slot] += 1
            self._tok[slot] = tok
            self._steps[slot] += 1
            if state.done or tok == state.request.eos_id:
                self._finish(slot, now)

    def _abort_admission(self, items, exc: Exception) -> None:
        """A prefill raised mid-admission: fail exactly the requests it was
        admitting and keep serving everyone else."""
        for slot, req in items:
            state = self.scheduler.slots[slot]
            if state is not None and state.request.rid == req.rid:
                self._fail_slot(slot, RequestStatus.ERROR.value,
                                f"prefill failed: {exc}")

    def _run_prefill_batch(self, batch: AdmittedBatch) -> None:
        """One batched prefill for a whole same-bucket admission batch."""
        t_admit = self._now()
        b, w = len(batch.items), batch.bucket
        bb = next(x for x in self.batch_buckets if b <= x)
        tokens = np.zeros((bb, w), np.int64)
        lengths = np.ones((bb,), np.int64)
        slots = np.full((bb,), self.cfg.num_slots, np.int64)  # pad: dropped
        temps = np.zeros((bb,), np.float32)
        topks = np.zeros((bb,), np.int64)
        seeds = np.zeros((bb,), np.int64)
        for i, (slot, req) in enumerate(batch.items):
            tokens[i, :req.prompt_len] = req.prompt
            lengths[i] = req.prompt_len
            slots[i] = slot
            sp = req.sampling
            temps[i], topks[i] = sp.temperature, sp.top_k
            seeds[i] = np.uint32(sp.seed)
        toks = self._prefill(tokens, lengths, slots, temps, topks,
                             seeds)
        # lint: allow[host-sync] B first tokens, one transfer per batched prefill
        toks = toks.cpu().numpy()
        self._c["prefill_dispatches"].inc()
        self._c["prefill_admitted"].inc(b)
        now = self._now()
        for i, (slot, req) in enumerate(batch.items):
            self._record_first_token(slot, req, int(toks[i]), now, t_admit)

    def _run_chunked(self, slot: int, req: GenerationRequest) -> None:
        """Stream a beyond-largest-bucket prompt through the bucket-width
        chunk step against the slot's own cache rows. Only the final
        chunk's token is real and read on the host."""
        t_admit = self._now()
        w = self.scheduler.buckets[-1]
        p, sp = req.prompt_len, req.sampling
        tok = None
        for start in range(0, p, w):
            clen = min(w, p - start)
            chunk = np.zeros((1, w), np.int64)
            chunk[0, :clen] = req.prompt[start:start + clen]
            tok = self._chunk(chunk, start, clen, slot, sp.temperature,
                              sp.top_k, int(np.uint32(sp.seed)))
            self._c["chunk_dispatches"].inc()
        self._c["chunked_admitted"].inc()
        # lint: allow[host-sync] one scalar per chunked prefill, by design
        self._record_first_token(slot, req, int(tok), self._now(), t_admit)

    # -- paged admission ---------------------------------------------------
    def _set_table_row(self, slot: int, pages: List[int]) -> None:
        row = self._table[slot]
        row[:] = self.alloc.num_pages                # sentinel tail
        row[:len(pages)] = pages

    def _acquire_pages(self, n: int, seq: int,
                       allow_preempt: bool) -> Optional[List[int]]:
        """n pages, escalating when the pool is dry: evict unreferenced
        prefix-cache entries first, then (tickets and decode extension
        only) preempt the youngest request no older than ``seq``. None
        when neither escalation can free enough — the caller waits."""
        if n == 0:
            return []
        while True:
            pages = self.alloc.alloc(n)
            if pages is not None:
                return pages
            deficit = n - self.alloc.num_free
            if self.prefix is not None and self.prefix.evict(deficit) > 0:
                continue
            if allow_preempt and self._preempt_youngest(seq):
                continue
            return None

    def _preempt_youngest(self, seq: int) -> bool:
        """Spill the youngest live request with seq >= ``seq`` (a decode
        extension may preempt the requester itself, which then resumes by
        its ticket). False when every live request is strictly older — the
        oldest is never preempted, so it always runs to completion and
        admission cannot livelock."""
        victim, vseq = -1, -1
        for slot in self.scheduler.active_slots():
            s = self.scheduler.slots[slot].request.seq
            if s >= seq and s > vseq:
                victim, vseq = slot, s
        if victim < 0:
            return False
        self._preempt(victim)
        return True

    def _preempt(self, slot: int) -> None:
        """Spill a live slot's pages to host memory (one transfer, one
        wait), requeue its ticket (ordered by seq — ahead of every
        never-admitted request), release its pages and park the slot.
        Prefix-cached pages keep the cache's reference: only the request's
        own references drop."""
        sched = self.scheduler
        state = sched.slots[slot]
        pages = self._slot_pages[slot]
        try:
            if self.faults is not None:
                self.faults.check_spill("spill")
            payload = spill_pages(self.kv, pages)
        except Exception as e:             # noqa: BLE001 — fault isolation
            # no payload: the victim's cache state is lost, so fail it (its
            # tokens so far survive on the host) and reclaim its pages —
            # the pool still frees, so the caller's escalation progresses
            self._fail_slot(slot, RequestStatus.ERROR.value,
                            f"preemption spill failed: {e}")
            return
        ticket = ResumeTicket(request=state.request,
                              generated=state.generated,
                              last_token=int(self._tok[slot]),
                              pos=int(self._pos[slot]),
                              n_pages=len(pages), payload=payload)
        sched.preempt(slot, ticket)
        self._c["preemptions"].inc()
        self._c["pages_spilled"].inc(len(pages))
        res = self._results[state.request.rid]
        if res.trace is not None:
            res.trace.stamp("preempt", self._now())
        self.alloc.decref(pages)
        self._slot_pages[slot] = []
        self._set_table_row(slot, [])
        self._park(slot)

    def _try_resume(self) -> bool:
        """Head-of-queue ResumeTicket → fresh pages and its restored
        payload (the spilled bytes scatter back as they were, so decoding
        continues with the same cache contents). False when blocked: no
        free slot, or pages unobtainable without preempting a strictly
        older request."""
        sched = self.scheduler
        ticket = sched.peek()
        if not sched.free:
            return False
        pages = self._acquire_pages(ticket.n_pages, ticket.seq,
                                    allow_preempt=True)
        if pages is None:
            return False
        slot, ticket = sched.admit_head()
        try:
            if self.faults is not None:
                self.faults.check_spill("restore")
            restore_pages(self.kv, pages, ticket.payload)
        except Exception as e:             # noqa: BLE001 — fault isolation
            # the spilled bytes never reached the device: hand the fresh
            # pages back and fail the ticket's request (its tokens before
            # the preemption survive). True: the queue moved.
            self.alloc.decref(pages)
            self._fail_slot(slot, RequestStatus.ERROR.value,
                            f"resume restore failed: {e}")
            return True
        ticket.payload = None
        self._slot_pages[slot] = pages
        self._set_table_row(slot, pages)
        sp = ticket.request.sampling
        self._pos[slot] = ticket.pos
        self._tok[slot] = ticket.last_token
        self._temps[slot] = sp.temperature
        self._topks[slot] = sp.top_k
        self._seeds[slot] = np.uint32(sp.seed)
        self._steps[slot] = ticket.generated   # the sampler's token index
        self._c["resumes"].inc()
        res = self._results[ticket.request.rid]
        if res.trace is not None:
            res.trace.stamp("resume", self._now())
        return True

    def _extend_for_decode(self) -> None:
        """Back every live slot's next write position with a page before
        the decode (a write through a sentinel entry would drop the new
        token's K/V). Oldest first, preempting the youngest (possibly the
        requester itself) when the pool is dry."""
        sched = self.scheduler
        pg = self.cfg.page_size
        order = sorted(sched.active_slots(),
                       key=lambda i: sched.slots[i].request.seq)
        for slot in order:
            state = sched.slots[slot]
            if state is None:            # preempted by an older extension
                continue
            need = int(self._pos[slot]) // pg + 1
            have = self._slot_pages[slot]
            if need <= len(have):
                continue
            pages = self._acquire_pages(need - len(have), state.request.seq,
                                        allow_preempt=True)
            if pages is None or sched.slots[slot] is not state:
                # the slot preempted itself while escalating (its ticket
                # resumes later): hand back anything grabbed after that
                if pages is not None:
                    self.alloc.decref(pages)
                continue
            have.extend(pages)
            self._set_table_row(slot, have)

    def _admit_paged(self) -> None:
        """Paged admission, strictly FIFO. Plain bucket-size requests
        accumulate into one right-padded prefill (``pending``); prefix hits
        and prompts beyond the largest bucket stream their unmatched suffix
        through the chunk step; resume tickets restore spilled pages,
        preempting strictly younger live requests when the pool is short.
        ``pending`` is always flushed before a resume can preempt, so
        preemption victims are fully prefilled."""
        sched = self.scheduler
        pg = self.cfg.page_size
        wmax = sched.buckets[-1]
        pending: List[tuple] = []            # [(slot, req)], one prefill
        while sched.free:
            head = sched.peek()
            if head is None:
                break
            if isinstance(head, ResumeTicket):
                self._flush_pending(pending)
                if not self._try_resume():
                    break
                continue
            req = head
            matched, mtok = [], 0
            if self.prefix is not None:
                matched, mtok = self.prefix.match(req.prompt)
            fresh = self._acquire_pages(-(-req.prompt_len // pg)
                                        - len(matched),
                                        req.seq, allow_preempt=False)
            if fresh is None:
                # the head waits for pages (never preempts: everything live
                # is older); roll back the prefix references
                if matched:
                    self.alloc.decref(matched)
                break
            if mtok:
                self._c["prefix_hits"].inc()
                self._c["prefix_hit_tokens"].inc(mtok)
            elif self.prefix is not None:
                self._c["prefix_misses"].inc()
            slot, _ = sched.admit_head()
            pages = matched + fresh
            self._slot_pages[slot] = pages
            self._set_table_row(slot, pages)
            if mtok or req.prompt_len > wmax:
                # the flush writes any pending twin's pages before the chunk
                # step reads the matched ones (in-order execution)
                self._flush_pending(pending)
                try:
                    self._admit_stream(slot, req, mtok)
                except Exception as e:  # noqa: BLE001 — fault isolation
                    # fail this admission alone; skip the prefix insert
                    # (its pages hold a partly written prompt)
                    self._abort_admission([(slot, req)], e)
                    continue
            else:
                if (pending and not self.cfg.mixed_admission
                        and sched.bucket_for(req.prompt_len)
                        != sched.bucket_for(pending[0][1].prompt_len)):
                    self._flush_pending(pending)
                pending.append((slot, req))
            if self.prefix is not None:
                self.prefix.insert(req.prompt, pages)
        self._flush_pending(pending)

    def _flush_pending(self, pending: List[tuple]) -> None:
        """One right-padded prefill for the accumulated admission run (the
        paged mirror of :meth:`_run_prefill_batch`; padding rows carry
        all-sentinel page maps)."""
        if not pending:
            return
        try:
            self._dispatch_pending(pending)
        except Exception as e:             # noqa: BLE001 — fault isolation
            self._abort_admission(pending, e)
        del pending[:]

    def _dispatch_pending(self, pending: List[tuple]) -> None:
        t_admit = self._now()
        b = len(pending)
        w = max(self.scheduler.bucket_for(r.prompt_len) for _, r in pending)
        bb = next(x for x in self.batch_buckets if b <= x)
        pg = self.cfg.page_size
        tokens = np.zeros((bb, w), np.int64)
        lengths = np.ones((bb,), np.int64)
        maps = np.full((bb, -(-w // pg)), self.alloc.num_pages, np.int64)
        temps = np.zeros((bb,), np.float32)
        topks = np.zeros((bb,), np.int64)
        seeds = np.zeros((bb,), np.int64)
        for i, (slot, req) in enumerate(pending):
            tokens[i, :req.prompt_len] = req.prompt
            lengths[i] = req.prompt_len
            maps[i, :len(self._slot_pages[slot])] = self._slot_pages[slot]
            sp = req.sampling
            temps[i], topks[i] = sp.temperature, sp.top_k
            seeds[i] = np.uint32(sp.seed)
        toks = self._prefill(tokens, lengths, maps, temps, topks,
                             seeds)
        # lint: allow[host-sync] B first tokens, one transfer per paged prefill dispatch
        toks = toks.cpu().numpy()
        self._c["prefill_dispatches"].inc()
        self._c["prefill_admitted"].inc(b)
        now = self._now()
        for i, (slot, req) in enumerate(pending):
            self._record_first_token(slot, req, int(toks[i]), now, t_admit)

    def _admit_stream(self, slot: int, req: GenerationRequest,
                      start_tok: int) -> None:
        """Stream a prompt's unmatched suffix through the chunk step against
        the pools, from the prefix-matched offset (0 for a plain prompt
        beyond the largest bucket). Only the final chunk's token is real
        and read on the host."""
        t_admit = self._now()
        w = self.scheduler.buckets[-1]
        p, sp = req.prompt_len, req.sampling
        tok = None
        for start in range(start_tok, p, w):
            clen = min(w, p - start)
            chunk = np.zeros((1, w), np.int64)
            chunk[0, :clen] = req.prompt[start:start + clen]
            tok = self._chunk(chunk, start, clen, slot, sp.temperature,
                              sp.top_k, int(np.uint32(sp.seed)))
            self._c["chunk_dispatches"].inc()
        self._c["chunked_admitted"].inc()
        # lint: allow[host-sync] one scalar per chunked prefill, by design
        self._record_first_token(slot, req, int(tok), self._now(), t_admit)

    def _record_first_token(self, slot: int, req: GenerationRequest,
                            tok: int, now: float,
                            t_admit: Optional[float] = None) -> None:
        res = self._results[req.rid]
        res.t_admit = now if t_admit is None else t_admit
        res.t_first_token = now
        if res.trace is not None:
            res.trace.stamp("admitted", res.t_admit)
            res.trace.stamp("first_token", now)
        res.tokens.append(tok)
        state = self.scheduler.slots[slot]
        state.generated = 1
        sp = req.sampling
        self._pos[slot] = req.prompt_len
        self._tok[slot] = tok
        self._temps[slot] = sp.temperature
        self._topks[slot] = sp.top_k
        self._seeds[slot] = np.uint32(sp.seed)
        self._steps[slot] = 1
        if state.done or tok == req.eos_id:
            self._finish(slot, now)

    def _finish(self, slot: int, now: float) -> None:
        req = self.scheduler.retire(slot)
        res = self._results.pop(req.rid)
        res.t_finish = now
        res.status = RequestStatus.OK.value
        res.finish_reason = (RequestStatus.EOS.value
                             if res.tokens and res.tokens[-1] == req.eos_id
                             else RequestStatus.LENGTH.value)
        self._observe_terminal(res)
        self._done.append(res)
        self._release_slot(slot)

    def _fail_slot(self, slot: int, status: str, msg: str = "") -> None:
        """Terminal-fail a live slot: retire it, reclaim its pages, park
        it, and emit the partial-token result with ``status`` (cancel,
        deadline expiry and step-level fault isolation all land here, so a
        failing request never leaks pages or wedges its slot)."""
        req = self.scheduler.retire(slot)
        res = self._results.pop(req.rid)
        res.t_finish = self._now()
        res.status = status
        res.finish_reason = status
        res.error = msg
        self._observe_terminal(res)
        self._done.append(res)
        self._release_slot(slot)

    def _release_slot(self, slot: int) -> None:
        if self._paged:
            # the request's page references drop; prefix-cached pages keep
            # the cache's reference and survive for later matches
            self.alloc.decref(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self._set_table_row(slot, [])
        self._park(slot)

    def _finish_queued(self, item, status: str, msg: str = "") -> None:
        """Terminal a request that never reached a slot, or a preempted
        one's ticket (its pages were released at preemption; its spilled
        payload dies with it; its tokens before the preemption are
        emitted)."""
        req = item.request if isinstance(item, ResumeTicket) else item
        res = self._results.pop(req.rid)
        res.t_finish = self._now()
        res.status = status
        res.finish_reason = status
        res.error = msg
        self._observe_terminal(res)
        self._done.append(res)

    def _park(self, slot: int) -> None:
        # the freed slot decodes greedy token 0 at position 0 until reused;
        # the next admission's prefill overwrites that row before it is
        # ever attended (paged: its all-sentinel table row drops the write)
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._seeds[slot] = 0
        self._steps[slot] = 0

    def run(self, max_steps: int = 1_000_000,
            step_hook=None) -> List[GenerationResult]:
        """Drive until every submitted request is terminal; results in
        completion order. ``step_hook(engine)`` runs after every step
        (host-side only). Raises :class:`EngineStalledError` when
        ``max_steps`` runs out or ``stall_patience`` consecutive steps make
        no progress with work outstanding."""
        sched = self.scheduler
        stalled = 0
        for _ in range(max_steps):
            if sched.idle:
                break
            before = (self.decode_steps, self.prefill_admitted,
                      self.chunked_admitted, self.resumes, len(self._done))
            self.step()
            if step_hook is not None:
                step_hook(self)
            if (self.decode_steps, self.prefill_admitted,
                    self.chunked_admitted, self.resumes,
                    len(self._done)) == before:
                stalled += 1
                if stalled >= self.cfg.stall_patience and not sched.idle:
                    raise EngineStalledError(
                        f"engine deadlocked: no progress for {stalled} "
                        f"consecutive steps with work outstanding",
                        sched.stuck_state())
            else:
                stalled = 0
        if not sched.idle:
            raise EngineStalledError(
                f"engine stopped after max_steps={max_steps} with work "
                f"outstanding", sched.stuck_state())
        out, self._done = self._done, []
        return out

    # -- invariants and introspection --------------------------------------
    def check_invariants(self) -> bool:
        """Reconcile the host bookkeeping: the slot partition, result-table
        coverage of every active and queued request, parked slots at
        position 0 and, paged, the block tables, refcounts and free list
        (:meth:`_check_pages`). Raises :class:`EngineInvariantError` naming
        the first mismatch; pure host arithmetic, no device sync."""
        sched = self.scheduler
        n = self.cfg.num_slots
        free, active = list(sched.free), list(sched.active_slots())
        if sorted(free + active) != list(range(n)):
            raise EngineInvariantError(
                f"slot partition broken: free={sorted(free)} "
                f"active={sorted(active)}")
        for slot in active:
            state = sched.slots[slot]
            rid = state.request.rid
            if rid not in self._results:
                raise EngineInvariantError(
                    f"active rid={rid} (slot {slot}) has no result entry")
            want = state.request.prompt_len + state.generated - 1
            if int(self._pos[slot]) != want:
                raise EngineInvariantError(
                    f"slot {slot} pos {int(self._pos[slot])} != prompt + "
                    f"generated - 1 = {want}")
        for slot in free:
            if self._pos[slot] != 0 or self._steps[slot] != 0:
                raise EngineInvariantError(
                    f"free slot {slot} is not parked (pos "
                    f"{int(self._pos[slot])})")
        for item in sched.queue:
            req = item.request if isinstance(item, ResumeTicket) else item
            if req.rid not in self._results:
                raise EngineInvariantError(
                    f"queued rid={req.rid} has no result entry")
        if self._paged:
            self._check_pages(set(active))
        return True

    def _check_pages(self, active: set) -> None:
        """Block tables against per-slot page lists, the allocator's
        refcounts against the live tables plus the prefix cache, and the
        free list against the rest of the pool."""
        pg, sentinel = self.cfg.page_size, self.alloc.num_pages
        want: Dict[int, int] = {}
        for slot in range(self.cfg.num_slots):
            pages = self._slot_pages[slot]
            row = self._table[slot]
            if list(row[:len(pages)]) != pages or not np.all(
                    row[len(pages):] == sentinel):
                raise EngineInvariantError(
                    f"slot {slot} block table {row.tolist()} does not "
                    f"match page list {pages}")
            if slot in active:
                if len(pages) * pg < int(self._pos[slot]):
                    raise EngineInvariantError(
                        f"slot {slot} holds {len(pages)} pages "
                        f"({len(pages) * pg} tokens) but pos="
                        f"{int(self._pos[slot])}: cache rows unbacked")
            elif pages:
                raise EngineInvariantError(
                    f"parked slot {slot} still holds pages {pages}")
            for p in pages:
                want[p] = want.get(p, 0) + 1
        if self.prefix is not None:
            for p in self.prefix.pages():
                want[p] = want.get(p, 0) + 1
        refs = self.alloc.refs()
        if want != refs:
            diff = {p: (want.get(p, 0), refs.get(p, 0))
                    for p in set(want) | set(refs)
                    if want.get(p, 0) != refs.get(p, 0)}
            raise EngineInvariantError(
                f"page refcounts out of sync (page: want/have): {diff}")
        free_pages = self.alloc.free_pages()
        free_set = set(free_pages)
        if len(free_set) != len(free_pages):
            raise EngineInvariantError("free list holds duplicate pages")
        if free_set & set(refs):
            raise EngineInvariantError(
                f"pages both free and referenced: {free_set & set(refs)}")
        if len(free_set) + len(refs) != self.alloc.num_pages:
            orphans = set(range(self.alloc.num_pages)) - free_set - set(refs)
            raise EngineInvariantError(
                f"pages leaked (neither free nor referenced): {orphans}")

    def kv_cache_bytes(self) -> int:
        return cache_bytes(self.kv)

    def page_stats(self) -> Dict[str, int]:
        """Page-pool, prefix-reuse and preemption counters (paged layout
        only; an empty dict on the slot layout), as the reference's.
        Counters reset with :meth:`warmup`."""
        if not self._paged:
            return {}
        pc = self.prefix
        on = pc is not None
        return {
            "num_pages": self.alloc.num_pages,
            "page_size": self.cfg.page_size,
            "pages_in_use": self.alloc.pages_in_use,
            "peak_pages_in_use": self.alloc.peak_in_use,
            "alloc_calls": self.alloc.alloc_calls,
            "alloc_failures": self.alloc.alloc_failures,
            "prefix_cached_pages": pc.cached_pages if on else 0,
            "prefix_inserted_pages": pc.inserted_pages if on else 0,
            "prefix_evicted_pages": pc.evicted_pages if on else 0,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "pages_spilled": self.pages_spilled,
        }

    def utilization(self) -> float:
        if self.decode_steps == 0:
            return 0.0
        return self.active_slot_steps / (self.decode_steps
                                         * self.cfg.num_slots)

    def queue_stats(self) -> Dict[str, Any]:
        """Backlog, a view over the ``engine_queue_depth`` gauge: the depth
        sampled at each step boundary (peak and mean over all samples, the
        most recent ``queue_trace_samples`` values in a ring with overwrites
        counted in ``dropped``), and the ``try_submit`` shed count. Reset
        by :meth:`warmup`."""
        g = self._g_queue
        return {"peak": int(g.peak),
                "mean": g.mean,
                "samples": g.samples,
                "rejected": self.rejected,
                "trace": [int(v) for v in g.trace_values()],
                "dropped": g.trace_dropped}

    def metrics_snapshot(self) -> dict:
        """The registry's snapshot (counters, gauges, histograms) with the
        state gauges (active slots, pages in use, prefix-cached pages)
        refreshed: everything ``page_stats``, ``queue_stats`` and the
        legacy counter attributes show, for ``serve.py --metrics-json``."""
        self._g_slots.set_value(self.scheduler.num_active)
        if self._paged:
            self._g_pages.set_value(self.alloc.pages_in_use)
            if self.prefix is not None:
                self._g_prefix_pages.set_value(self.prefix.cached_pages)
        return self.metrics.snapshot()


__all__ = ["Engine", "EngineConfig", "GenerationRequest",
           "GenerationResult", "batch_buckets"]
