"""Continuous-batching serving engine over a slot KV cache (the port of
``repro/serving/engine.py``, slot layout).

The engine owns a slot-indexed KV cache (:mod:`.kv_cache`; S slots ×
max_len tokens, dense or INT8 per-head-group) and three step functions:

- **prefill**: the model over a whole same-bucket admission batch of
  right-padded prompts against a fresh dense (L, B, W) mini-cache, logits
  at each row's last real token, first tokens sampled on the device, and
  the B mini-caches spliced into the admitted slots' rows in one
  :func:`~.kv_cache.write_slot` (batch sizes round up to power-of-two
  batch buckets; padding rows carry slot == num_slots and are dropped);
- **chunk**: one bucket-width chunk of a prompt longer than the largest
  bucket, against the slot's own cache rows: the chunk's K/V is written at
  [start, start + W) and attention reads the cache under the offset causal
  mask (``model.prefill_chunk``; on the INT8 cache the rows are expanded
  by K5);
- **decode**: one token for all slots at once. Each slot reads and writes
  the cache at its own position, the cache read is K6 (with
  ``use_fused_decode``), per-slot sampling parameters ride along as
  tensors, and one (S, 2) int32 tensor — token and finite-logit flag —
  crosses to the host per step. No other value of the step is read on the
  host, and each step function's inputs go up in one non-blocking copy
  from pinned memory, so the host never waits on the card mid-step.

The host-side :class:`~.scheduler.Scheduler` feeds it: FIFO admission onto
the slot free-list, prompt-length buckets, retire on completion. Retired
slots keep decoding at position 0 (K6 length 1) until reused; their writes
land below the next request's prefill splice and are never attended.

What the reference has and this port leaves out: the paged layout
(``kv_layout="paged"`` raises; paging, the prefix cache and preemption are
the next slice of the port), the metrics registry (``repro.obs``; the
engine keeps plain integer counters and ``metrics_snapshot`` waits for
it), and ``compile_counts``, which has no counterpart in eager PyTorch:
nothing is compiled per shape.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.serving.kv_cache import (KVCacheConfig, cache_bytes,
                                          init_slot_cache, set_slot_rows,
                                          slot_rows, write_slot)
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

COUNTERS = ("decode_steps", "active_slot_steps", "prefill_dispatches",
            "prefill_admitted", "chunk_dispatches", "chunked_admitted",
            "rejected")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape/storage policy. ``kv_quantized`` switches the slot
    cache to INT8 per-head-group storage (``kv_group_size=0`` → one group
    per head); ``prompt_buckets=()`` → power-of-two buckets covering
    max_len, and prompts beyond the largest bucket stream through the
    chunked prefill. ``mixed_admission`` lets one prefill admit a FIFO
    head-run that crosses prompt buckets. ``max_queue`` bounds the backlog
    (0 → unbounded; a submit past it raises :class:`QueueFullError`).
    ``stall_patience`` is how many consecutive no-progress steps
    :meth:`Engine.run` tolerates with work outstanding.
    ``use_fused_decode`` (default on) reads the decode cache through K6;
    False is the expand-then-attend reference. ``kv_layout="paged"``
    raises: the paged layout and its fields (page size, pool size, prefix
    caching) come with the paging slice."""
    num_slots: int = 8
    max_len: int = 256
    prompt_buckets: tuple = ()
    kv_dtype: Any = torch.float32
    kv_quantized: bool = False
    kv_group_size: int = 0
    max_top_k: int = 64
    kv_layout: str = "slots"
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


class Engine:
    """Slot-based continuous batching over one decode program."""

    def __init__(self, model, params, cfg: EngineConfig = EngineConfig(),
                 faults=None):
        mcfg = model.cfg
        if mcfg.family != "dense" or mcfg.frontend:
            raise ValueError(f"the port's engine serves the dense family, "
                             f"got {mcfg.family}/{mcfg.frontend}")
        if cfg.kv_layout == "paged":
            raise NotImplementedError(
                "kv_layout='paged' belongs to the paging slice of the port "
                "and is not ported yet; use kv_layout='slots'")
        if cfg.kv_layout != "slots":
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
        cache = init_slot_cache(mcfg, KVCacheConfig(
            num_slots=s, max_len=cfg.max_len, dtype=cfg.kv_dtype,
            quantized=cfg.kv_quantized, group_size=cfg.kv_group_size),
            device=self.device)
        self.kv = {"k": cache["k"], "v": cache["v"]}   # pos is host-side
        self._pos = np.zeros(s, np.int32)
        self._tok = np.zeros(s, np.int32)
        self._temps = np.zeros(s, np.float32)
        self._topks = np.zeros(s, np.int32)
        self._seeds = np.zeros(s, np.int64)
        self._steps = np.zeros(s, np.int64)
        self._results: Dict[int, GenerationResult] = {}
        self._done: List[GenerationResult] = []
        self._reset_counters()

    # -- counters ----------------------------------------------------------
    def _reset_counters(self) -> None:
        for name in COUNTERS:
            setattr(self, name, 0)
        self._queue_trace: deque = deque(maxlen=self.cfg.queue_trace_samples)
        self._queue_samples = 0
        self._queue_sum = 0
        self._queue_peak = 0

    def _sample_queue(self) -> None:
        depth = len(self.scheduler.queue)
        self._queue_trace.append(depth)
        self._queue_samples += 1
        self._queue_sum += depth
        self._queue_peak = max(self._queue_peak, depth)

    def set_faults(self, plan) -> None:
        """Attach or replace the :class:`~.faults.FaultPlan`. Attach after
        :meth:`warmup` so scripted steps count from the first real step."""
        self.faults = plan

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

    def _prefill(self, tokens, lengths, slots, temps, topks, seeds):
        """Batched prefill of right-padded prompts into a dense mini-cache,
        first tokens sampled, spliced into ``slots`` (host ints)."""
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
        write_slot(self.kv, slots, mini["k"], mini["v"])
        return toks

    def _chunk(self, tokens, start: int, length: int, slot: int,
               temp: float, topk: int, seed: int):
        """One chunk of a long prompt against slot ``slot``'s own rows."""
        tokens_d, length_d, temp_d, topk_d, seed_d, step_d = self._upload(
            tokens, [length], np.float32([temp]), [topk], [seed], [0])
        row = {"k": slot_rows(self.kv["k"], slot),
               "v": slot_rows(self.kv["v"], slot), "pos": start}
        logits, row = self.model.prefill_chunk(
            self.params, {"tokens": tokens_d}, row, lengths=length_d)
        tok = sample_tokens(logits[:, 0, :], temp_d, topk_d, seed_d, step_d,
                            max_top_k=self.cfg.max_top_k)
        set_slot_rows(self.kv["k"], slot, row["k"])
        set_slot_rows(self.kv["v"], slot, row["v"])
        return tok[0]

    def _decode(self) -> torch.Tensor:
        """One token for every slot → (S, 2) int32 [token, finite] on the
        device."""
        pos, tok, temps, topks, seeds, steps = self._upload(
            self._pos, self._tok[:, None], self._temps, self._topks,
            self._seeds, self._steps)
        cache = {"k": self.kv["k"], "v": self.kv["v"], "pos": pos}
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
        that can never be admitted, :class:`QueueFullError` past
        ``max_queue``."""
        if req.rid in self._results:
            raise DuplicateRequestError(
                f"request rid={req.rid} is already in flight")
        if (self.cfg.max_queue > 0 and req.rid >= 0
                and len(self.scheduler.queue) >= self.cfg.max_queue):
            # negative rids are warmup clones — internal, never shed
            raise QueueFullError(
                f"request rid={req.rid} rejected: queue at "
                f"max_queue={self.cfg.max_queue}")
        self.scheduler.submit(req)
        self._results[req.rid] = GenerationResult(
            rid=req.rid, prompt_len=req.prompt_len, tokens=[],
            t_enqueue=self._now())

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
            self.rejected += 1
            self._done.append(GenerationResult(
                rid=req.rid, prompt_len=req.prompt_len, tokens=[],
                t_enqueue=now, t_finish=now,
                status=RequestStatus.REJECTED.value,
                finish_reason=RequestStatus.REJECTED.value, error=str(e)))
            return False

    def cancel(self, rid: int) -> bool:
        """Cancel an in-flight request: a queued one leaves the queue, a
        running one is failed out of its slot; either way its partial
        tokens are emitted in a terminal ``cancelled`` result. False when
        the rid is unknown or already finished."""
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
        clones carry negative rids and their results are dropped."""
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
        self._reset_counters()
        self.set_faults(plan)

    def step(self) -> None:
        """Admit every admissible request (one batched prefill per FIFO
        head-run, the chunked prefill for prompts beyond the largest
        bucket), then one decode step for all slots. Failure-atomic: a
        fault in the step fails only the culpable request(s);
        :meth:`check_invariants` holds at every step boundary."""
        sched = self.scheduler
        if self.faults is not None:
            self.faults.tick()
        self._expire_deadlines()
        self._sample_queue()
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
        # THE one host transfer of a decode step: (S, 2) token + finite flag
        out = self._decode().cpu().numpy()
        toks, finite = out[:, 0], out[:, 1]
        now = self._now()
        self.decode_steps += 1
        self.active_slot_steps += sched.num_active
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
        # one transfer per batched prefill: the B first tokens
        toks = self._prefill(tokens, lengths, slots, temps, topks,
                             seeds).cpu().numpy()
        self.prefill_dispatches += 1
        self.prefill_admitted += b
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
            self.chunk_dispatches += 1
        self.chunked_admitted += 1
        # one scalar per chunked prefill
        self._record_first_token(slot, req, int(tok), self._now(), t_admit)

    def _record_first_token(self, slot: int, req: GenerationRequest,
                            tok: int, now: float,
                            t_admit: Optional[float] = None) -> None:
        res = self._results[req.rid]
        res.t_admit = now if t_admit is None else t_admit
        res.t_first_token = now
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
        self._done.append(res)
        self._park(slot)

    def _fail_slot(self, slot: int, status: str, msg: str = "") -> None:
        """Terminal-fail a live slot: retire and park it, and emit the
        partial-token result with ``status`` (cancel, deadline expiry and
        step-level fault isolation all land here)."""
        req = self.scheduler.retire(slot)
        res = self._results.pop(req.rid)
        res.t_finish = self._now()
        res.status = status
        res.finish_reason = status
        res.error = msg
        self._done.append(res)
        self._park(slot)

    def _finish_queued(self, item, status: str, msg: str = "") -> None:
        """Terminal a request that never reached a slot."""
        req = item.request if isinstance(item, ResumeTicket) else item
        res = self._results.pop(req.rid)
        res.t_finish = self._now()
        res.status = status
        res.finish_reason = status
        res.error = msg
        self._done.append(res)

    def _park(self, slot: int) -> None:
        # the freed slot decodes greedy token 0 at position 0 until reused;
        # the next admission's prefill overwrites that row before it is
        # ever attended
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
                      self.chunked_admitted, len(self._done))
            self.step()
            if step_hook is not None:
                step_hook(self)
            if (self.decode_steps, self.prefill_admitted,
                    self.chunked_admitted, len(self._done)) == before:
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
        coverage of every active and queued request, and parked slots at
        position 0. Raises :class:`EngineInvariantError` naming the first
        mismatch; pure host arithmetic, no device sync."""
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
        return True

    def kv_cache_bytes(self) -> int:
        return cache_bytes(self.kv)

    def utilization(self) -> float:
        if self.decode_steps == 0:
            return 0.0
        return self.active_slot_steps / (self.decode_steps
                                         * self.cfg.num_slots)

    def queue_stats(self) -> Dict[str, Any]:
        """Backlog sampled at each step boundary: peak and mean over all
        samples, the most recent ``queue_trace_samples`` values (older
        ones counted in ``dropped``), and the ``try_submit`` shed count.
        Reset by :meth:`warmup`."""
        n = self._queue_samples
        return {"peak": self._queue_peak,
                "mean": self._queue_sum / n if n else 0.0,
                "samples": n,
                "rejected": self.rejected,
                "trace": list(self._queue_trace),
                "dropped": n - len(self._queue_trace)}


__all__ = ["COUNTERS", "Engine", "EngineConfig", "GenerationRequest",
           "GenerationResult", "batch_buckets"]
