"""Request-lifecycle traces: ordered event stamps -> derived spans (the
port's own copy of ``repro/obs/trace.py``).

A ``Trace`` is a list of ``(event, t)`` stamps recorded at existing engine
step boundaries via ``Engine._now`` (so ``FaultPlan``'s virtual clock makes
them deterministic).  No per-decode-tick events are recorded — the decode
phase is a single derived span — so tracing adds zero device syncs and O(1)
host work per request per lifecycle transition.

Event vocabulary::

    submit        request accepted into the engine (queue or direct admit)
    admitted      first dispatched as part of a prefill/chunk program
    first_token   first generated token observed on host
    preempt       evicted mid-decode (paged engine under page pressure)
    resume        re-admitted after a preemption
    end:<status>  terminal; <status> is the RequestStatus string

Derived spans (``Trace.spans()``): ``queued`` (submit -> admitted or end),
``prefill`` (admitted -> first_token), ``decode`` (first_token -> end) and one
``preempted`` span per preempt -> resume (or end) pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

__all__ = ["Span", "Trace", "TraceError", "TERMINAL_STATUSES"]

# The RequestStatus values of repro_torch.serving.scheduler, kept as
# literals so obs stays import-free of the serving package.
TERMINAL_STATUSES = ("ok", "length", "eos", "cancelled", "deadline", "rejected", "error")


class TraceError(AssertionError):
    """Raised by Trace.validate() when lifecycle invariants are violated."""


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


class Trace:
    __slots__ = ("rid", "events")

    def __init__(self, rid: int, t_submit: float):
        self.rid = rid
        self.events: List[Tuple[str, float]] = [("submit", float(t_submit))]

    def stamp(self, event: str, t: float) -> None:
        self.events.append((event, float(t)))

    def finish(self, status: str, t: float) -> None:
        self.stamp(f"end:{status}", t)

    # -- derived views ------------------------------------------------------

    @property
    def status(self) -> Optional[str]:
        name, _ = self.events[-1]
        return name[4:] if name.startswith("end:") else None

    @property
    def done(self) -> bool:
        return self.status is not None

    def first(self, event: str) -> Optional[float]:
        for name, t in self.events:
            if name == event:
                return t
        return None

    def spans(self) -> List[Span]:
        t_submit = self.events[0][1]
        t_admit = self.first("admitted")
        t_first = self.first("first_token")
        t_end = self.events[-1][1] if self.done else None

        spans: List[Span] = []
        queued_end = t_admit if t_admit is not None else t_end
        if queued_end is not None:
            spans.append(Span("queued", t_submit, queued_end))
        if t_admit is not None and t_first is not None:
            spans.append(Span("prefill", t_admit, t_first))
        if t_first is not None and t_end is not None:
            spans.append(Span("decode", t_first, t_end))

        open_preempt: Optional[float] = None
        for name, t in self.events:
            if name == "preempt":
                open_preempt = t
            elif name == "resume" and open_preempt is not None:
                spans.append(Span("preempted", open_preempt, t))
                open_preempt = None
        if open_preempt is not None and t_end is not None:
            spans.append(Span("preempted", open_preempt, t_end))

        spans.sort(key=lambda s: (s.start, s.end))
        return spans

    def validate(self) -> bool:
        """Check lifecycle invariants; raises TraceError on violation."""
        ev = self.events
        if not ev or ev[0][0] != "submit":
            raise TraceError(f"rid {self.rid}: trace must start with submit: {ev[:1]}")
        times = [t for _, t in ev]
        if any(b < a for a, b in zip(times, times[1:])):
            raise TraceError(f"rid {self.rid}: timestamps not monotone: {ev}")
        terminals = [i for i, (n, _) in enumerate(ev) if n.startswith("end:")]
        if len(terminals) != 1 or terminals[0] != len(ev) - 1:
            raise TraceError(f"rid {self.rid}: exactly one terminal event, last: {ev}")
        status = self.status
        if status not in TERMINAL_STATUSES:
            raise TraceError(f"rid {self.rid}: unknown terminal status {status!r}")

        names = [n for n, _ in ev]
        if names.count("submit") != 1:
            raise TraceError(f"rid {self.rid}: duplicate submit: {ev}")
        if names.count("admitted") > 1:
            raise TraceError(f"rid {self.rid}: duplicate admitted: {ev}")
        if names.count("first_token") > 1:
            raise TraceError(f"rid {self.rid}: duplicate first_token: {ev}")

        admitted_at = names.index("admitted") if "admitted" in names else None
        first_at = names.index("first_token") if "first_token" in names else None
        if first_at is not None and (admitted_at is None or admitted_at > first_at):
            raise TraceError(f"rid {self.rid}: first_token before admitted: {ev}")

        depth = 0
        for n in names:
            if n == "preempt":
                if admitted_at is None:
                    raise TraceError(f"rid {self.rid}: preempt before admitted: {ev}")
                depth += 1
                if depth > 1:
                    raise TraceError(f"rid {self.rid}: nested preempt: {ev}")
            elif n == "resume":
                depth -= 1
                if depth < 0:
                    raise TraceError(f"rid {self.rid}: resume without preempt: {ev}")

        if status in ("ok", "length", "eos") and first_at is None:
            raise TraceError(f"rid {self.rid}: {status} without first_token: {ev}")
        if status == "rejected" and admitted_at is not None:
            raise TraceError(f"rid {self.rid}: rejected after admission: {ev}")
        return True

    def asdict(self) -> dict:
        return {"rid": self.rid, "events": [[n, t] for n, t in self.events]}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        body = ", ".join(f"{n}@{t:.6g}" for n, t in self.events)
        return f"Trace(rid={self.rid}, [{body}])"
