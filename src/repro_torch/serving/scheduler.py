"""Host-side request scheduler for the continuous-batching engine (a copy
of ``repro/serving/scheduler.py`` with the port's ``SamplingParams``).

Pure bookkeeping, no torch: a FIFO admission queue, a slot free-list, and
per-slot (request, generated-count) state. The engine asks the
scheduler *what* to run; every device-facing decision that would change
shapes goes through :func:`Scheduler.bucket_for` (prompt-length
bucketing), so the step functions see a small fixed set of shapes.

Invariants (tested in tests/test_engine.py and tests/test_paging.py):
- admission is FIFO: requests start in submit order (``admit_batch`` pops
  the FIFO head-run — by default the longest run sharing one prompt
  bucket; ``mixed=True`` crosses buckets and right-pads the run to its
  largest member's bucket — it never skips over a queued request);
- a slot is EXCLUSIVE: never two live requests on one slot;
- retire frees the slot for reuse within the same run;
- a request is admitted only if prompt_len + max_new_tokens fits max_len
  and it decodes at least one token (max_new_tokens >= 1);
- a prompt longer than the largest bucket admits alone (chunked prefill);
- priority is submission order (``seq``): preemption (the paged engine)
  always victimizes the YOUNGEST live request, and a preempted request's
  :class:`ResumeTicket` re-enters the queue ordered by seq — ahead of
  every never-admitted request, behind older tickets — so the oldest
  request can never be starved.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from repro_torch.serving.sampling import SamplingParams


class RequestStatus(str, enum.Enum):
    """Terminal request states. Every request the engine ever accepted ends
    in exactly one of these; ``ok`` is the umbrella success status (its
    ``finish_reason`` refines it to ``length`` or ``eos``)."""
    OK = "ok"                  # completed normally (length / eos)
    LENGTH = "length"          # finish_reason: decode budget exhausted
    EOS = "eos"                # finish_reason: sampled the eos token
    CANCELLED = "cancelled"    # Engine.cancel(rid) — partial tokens kept
    DEADLINE = "deadline"      # deadline_s expired (queued or running)
    REJECTED = "rejected"      # shed at submit (queue full / inadmissible)
    ERROR = "error"            # step failure isolated to this request


class EngineError(RuntimeError):
    """Base of the serving layer's typed failures."""


class InvalidRequestError(EngineError, ValueError):
    """The request can never be admitted (shape/budget violations)."""


class DuplicateRequestError(InvalidRequestError):
    """A request with this rid is already in flight."""


class QueueFullError(EngineError):
    """Admission queue at ``EngineConfig.max_queue`` — request shed."""


class EngineInvariantError(EngineError):
    """check_invariants() found irreconcilable engine state."""


class EngineStalledError(EngineError):
    """The engine stopped making progress with work outstanding.

    ``stuck`` carries one dict per unfinished request: rid, where it is
    (``queued`` / ``ticket`` / ``slot N``), prompt length, tokens generated
    so far, and the decode position for running requests."""

    def __init__(self, msg: str, stuck: Optional[List[dict]] = None):
        self.stuck = stuck or []
        detail = "; ".join(
            f"rid={s['rid']} {s['where']} gen={s.get('generated', 0)}"
            for s in self.stuck)
        super().__init__(f"{msg}" + (f" [{detail}]" if detail else ""))


@dataclasses.dataclass
class GenerationRequest:
    """One generation job: prompt tokens + decode budget + sampling policy.
    ``eos_id < 0`` disables early stopping (the synthetic-corpus default).
    ``deadline_s > 0`` expires the request (queued OR running) that many
    seconds after enqueue — checked at step boundaries, partial tokens are
    kept. ``seq`` is the scheduler-assigned admission priority (submit
    order, lower = older = higher priority); callers leave it at -1."""
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    eos_id: int = -1
    deadline_s: float = 0.0            # 0 → no deadline
    seq: int = -1

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


@dataclasses.dataclass
class GenerationResult:
    """Terminal request record: generated tokens (possibly partial),
    status/finish_reason taxonomy (:class:`RequestStatus` values), and
    latency breadcrumbs (host wall-clock seconds, filled by the engine)."""
    rid: int
    prompt_len: int
    tokens: List[int]
    t_enqueue: float = 0.0
    t_admit: float = 0.0               # first admission onto a slot (0: never)
    t_first_token: float = 0.0
    t_finish: float = 0.0
    status: str = RequestStatus.OK.value
    finish_reason: str = ""            # length|eos|cancelled|deadline|...
    error: str = ""                    # detail for error/rejected statuses
    trace: Optional[object] = None     # repro_torch.obs.Trace (None: metrics off)

    @property
    def ok(self) -> bool:
        return self.status == RequestStatus.OK.value

    @property
    def latency(self) -> float:
        return self.t_finish - self.t_enqueue

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_enqueue

    @property
    def queue_time(self) -> float:
        """Seconds from submit to first admission (whole lifetime when the
        request reached a terminal status without ever being admitted)."""
        return ((self.t_admit if self.t_admit > 0.0 else self.t_finish)
                - self.t_enqueue)

    @property
    def tpot(self) -> float:
        """Mean seconds per generated token after the first (0.0 with
        fewer than two tokens)."""
        if len(self.tokens) < 2 or self.t_first_token <= 0.0:
            return 0.0
        return (self.t_finish - self.t_first_token) / (len(self.tokens) - 1)


@dataclasses.dataclass
class SlotState:
    """Live per-slot decode state. The device-facing KV write position is
    the engine's per-slot ``pos`` array (always request.prompt_len +
    generated - 1 while live), kept in one place to avoid drift."""
    request: GenerationRequest
    generated: int = 0                 # tokens sampled so far

    @property
    def done(self) -> bool:
        return self.generated >= self.request.max_new_tokens


@dataclasses.dataclass
class ResumeTicket:
    """A preempted request's host-side state, queued for re-admission.

    The engine fills it at preemption (spilled page payloads + decode
    cursor) and consumes it on resume; the scheduler only orders it
    (by ``seq``) and re-binds it to a slot. ``payload`` is engine-opaque
    (the spilled page bytes of both pools, in host memory)."""
    request: GenerationRequest
    generated: int                     # tokens sampled before preemption
    last_token: int                    # next decode input token
    pos: int                           # next cache write position
    n_pages: int                       # live pages at spill time
    payload: object = None

    @property
    def seq(self) -> int:
        return self.request.seq


@dataclasses.dataclass
class AdmittedBatch:
    """One admission group. ``chunked=False``: the FIFO head-run sharing
    one prompt ``bucket``, admitted together — one batched prefill dispatch
    covers every ``(slot, request)`` in ``items``. ``chunked=True``: a
    single request whose prompt exceeds the largest bucket; it streams
    through the bucket-width chunked-prefill program (``bucket`` is the
    chunk width, i.e. the largest bucket)."""
    bucket: int
    items: List[tuple]                 # [(slot, request), ...]
    chunked: bool = False


def default_buckets(max_len: int) -> tuple:
    """Power-of-two prompt buckets 8, 16, … covering max_len."""
    out, b = [], 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class Scheduler:
    """FIFO admission over a fixed set of device slots."""

    def __init__(self, num_slots: int, max_len: int,
                 prompt_buckets: tuple = ()):
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(prompt_buckets)) or default_buckets(max_len)
        if self.buckets[0] < 1:
            raise ValueError(f"prompt buckets must be >= 1, got {self.buckets}")
        if self.buckets[-1] > max_len:
            # a bucket wider than the cache would silently clip live prompt
            # tokens at the cache edge during the prefill splice
            raise ValueError(
                f"largest prompt bucket {self.buckets[-1]} exceeds max_len "
                f"{max_len}: the bucket-padded prefill would write past the "
                f"slot cache edge")
        self.queue: Deque = deque()        # GenerationRequest | ResumeTicket
        self.free: Deque[int] = deque(range(num_slots))
        self.slots: List[Optional[SlotState]] = [None] * num_slots
        self._seq = 0                      # monotone admission priority

    # -- admission ---------------------------------------------------------
    def submit(self, req: GenerationRequest) -> None:
        if req.max_new_tokens < 1:
            raise InvalidRequestError(
                f"request {req.rid}: max_new_tokens {req.max_new_tokens} < 1 "
                f"(every admitted request emits at least one token)")
        if req.prompt_len + req.max_new_tokens > self.max_len:
            raise InvalidRequestError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"max_new {req.max_new_tokens} exceeds max_len {self.max_len}")
        if req.prompt_len < 1:
            raise InvalidRequestError(f"request {req.rid}: empty prompt")
        # prompts beyond the largest bucket are fine: they admit alone and
        # stream through the chunked prefill (see admit_batch)
        req.seq = self._seq
        self._seq += 1
        self.queue.append(req)

    def remove(self, rid: int):
        """Pull a QUEUED request or resume ticket out of the queue by rid
        (cancellation / deadline expiry). Returns the removed item, or None
        if no queued item carries that rid (it may be running or done)."""
        for i, item in enumerate(self.queue):
            r = item.request if isinstance(item, ResumeTicket) else item
            if r.rid == rid:
                del self.queue[i]
                return item
        return None

    def admit(self) -> Optional[tuple]:
        """Pop the FIFO head onto a free slot → (slot, request), or None."""
        if not self.queue or not self.free:
            return None
        assert not isinstance(self.queue[0], ResumeTicket), \
            "resume tickets re-admit through admit_head (engine restores " \
            "spilled pages); admit() only handles fresh requests"
        slot = self.free.popleft()
        req = self.queue.popleft()
        assert self.slots[slot] is None, f"slot {slot} double-booked"
        self.slots[slot] = SlotState(request=req)
        return slot, req

    def peek(self):
        """The queue head (GenerationRequest or ResumeTicket), or None."""
        return self.queue[0] if self.queue else None

    def admit_head(self) -> Optional[tuple]:
        """Pop the FIFO head — request *or* resume ticket — onto a free
        slot → (slot, head). Tickets rebind with their pre-preemption
        decode progress; the engine restores their pages/pos/token."""
        if not self.queue or not self.free:
            return None
        slot = self.free.popleft()
        head = self.queue.popleft()
        assert self.slots[slot] is None, f"slot {slot} double-booked"
        if isinstance(head, ResumeTicket):
            self.slots[slot] = SlotState(request=head.request,
                                         generated=head.generated)
        else:
            self.slots[slot] = SlotState(request=head)
        return slot, head

    def requeue(self, ticket: ResumeTicket) -> None:
        """Re-enter a preempted request, ordered by seq: behind any older
        tickets already waiting, ahead of everything never admitted (all
        plain queued requests have larger seq — they were submitted after
        the ticket's request was already running)."""
        at = 0
        for item in self.queue:
            if isinstance(item, ResumeTicket) and item.seq < ticket.seq:
                at += 1
            else:
                break
        self.queue.insert(at, ticket)

    def preempt(self, slot: int, ticket: ResumeTicket) -> SlotState:
        """Evict a live slot and requeue its ticket. The engine builds the
        ticket (spilled pages + decode cursor) before calling this."""
        state = self.slots[slot]
        assert state is not None, f"preempting empty slot {slot}"
        assert state.request is ticket.request, \
            f"ticket/slot mismatch on slot {slot}"
        self.slots[slot] = None
        self.free.append(slot)
        self.requeue(ticket)
        return state

    def admit_batch(self, mixed: bool = False) -> Optional[AdmittedBatch]:
        """Pop the longest FIFO head-run sharing one prompt bucket onto
        free slots — one batched prefill dispatch admits the whole run.

        A prompt beyond the largest bucket admits alone (``chunked=True``):
        it streams through the bucket-width program chunk by chunk. FIFO
        order is preserved strictly — the run stops at the first queued
        request whose bucket differs (never skips over it) or when the
        free-list empties. With ``mixed=True`` the run crosses buckets:
        it pops the head-run of every in-bucket request and dispatches one
        prefill right-padded to the LARGEST member's bucket (causal masking
        plus per-row lengths make the padding inert), collapsing a
        short/long interleave into one dispatch instead of one per bucket
        flip. Returns None when nothing is admissible.

        Resume tickets are never popped here — the caller drains them via
        :meth:`admit_head` (they need page restoration, not prefill)."""
        if not self.queue or not self.free:
            return None
        if isinstance(self.queue[0], ResumeTicket):
            return None
        wmax = self.buckets[-1]
        if self.queue[0].prompt_len > wmax:
            return AdmittedBatch(bucket=wmax, items=[self.admit()],
                                 chunked=True)
        items = []
        if mixed:
            bucket = 0
            while (self.queue and self.free
                   and not isinstance(self.queue[0], ResumeTicket)
                   and self.queue[0].prompt_len <= wmax):
                bucket = max(bucket, self.bucket_for(self.queue[0].prompt_len))
                items.append(self.admit())
            return AdmittedBatch(bucket=bucket, items=items)
        bucket = self.bucket_for(self.queue[0].prompt_len)
        while (self.queue and self.free
               and not isinstance(self.queue[0], ResumeTicket)
               and self.queue[0].prompt_len <= wmax
               and self.bucket_for(self.queue[0].prompt_len) == bucket):
            items.append(self.admit())
        return AdmittedBatch(bucket=bucket, items=items)

    def retire(self, slot: int) -> GenerationRequest:
        state = self.slots[slot]
        assert state is not None, f"retiring empty slot {slot}"
        self.slots[slot] = None
        self.free.append(slot)
        return state.request

    # -- queries -----------------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        # beyond the largest bucket: the request is chunked — the largest
        # bucket is the chunk width it streams through
        return self.buckets[-1]

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and self.num_active == 0

    def stuck_state(self) -> List[dict]:
        """Snapshot of every unfinished request (queue + slots) for
        :class:`EngineStalledError` diagnostics."""
        out = []
        for item in self.queue:
            if isinstance(item, ResumeTicket):
                out.append({"rid": item.request.rid, "where": "ticket",
                            "prompt_len": item.request.prompt_len,
                            "generated": item.generated, "pos": item.pos})
            else:
                out.append({"rid": item.rid, "where": "queued",
                            "prompt_len": item.prompt_len, "generated": 0})
        for slot, state in enumerate(self.slots):
            if state is not None:
                out.append({"rid": state.request.rid, "where": f"slot {slot}",
                            "prompt_len": state.request.prompt_len,
                            "generated": state.generated})
        return out


__all__ = ["AdmittedBatch", "DuplicateRequestError", "EngineError",
           "EngineInvariantError", "EngineStalledError", "GenerationRequest",
           "GenerationResult", "InvalidRequestError", "QueueFullError",
           "RequestStatus", "ResumeTicket", "SlotState", "Scheduler",
           "default_buckets"]
