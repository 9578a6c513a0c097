"""Deterministic fault injection for the serving engine (a copy of
``repro/serving/faults.py``; numpy only).

Overload, memory pressure, and partial failure are the steady state of the
constrained deployments AWP-compressed models target — the engine's
failure semantics (docs/serving.md §"Failure semantics") need to be
*testable*, not just asserted. A :class:`FaultPlan` is a seeded source of
injected faults that hooks into three places:

- the page allocator (``PageAllocator(..., faults=plan)``): ``alloc_fail``
  makes :meth:`PageAllocator.alloc` report pool-dry, driving the engine
  through its real escalation path (prefix eviction → preemption → wait);
- the spill/restore path (engine preemption/resume): ``spill_fail`` raises
  :class:`InjectedFault` where the page gather/scatter would run, so the
  engine must reclaim the victim's pages and fail only that request;
- the decode step (engine): ``nan_logits`` poisons one slot's finite-logit
  flag for a step, exercising the guard that fails the offending slot and
  keeps the batch serving.

In the port all three act: the slot engine reads ``nan_logits`` and the
clock, and the paged engine attaches the plan to its page allocator
(``alloc_fail``) and checks ``spill_fail`` at every spill and restore.

``slow_step_s`` switches the engine onto the plan's VIRTUAL clock (one
tick per engine step), making deadline expiry deterministic in tests — no
wall-clock sleeps, no flakiness.

Faults draw from one seeded ``numpy`` Generator in engine call order, so a
given (plan seed, trace) pair replays the identical fault sequence; the
chaos tests and the ``engine_bench`` chaos row lean on that to assert
bit-identical survivor outputs against a fault-free run. One-shot faults
can be scripted exactly with ``script`` entries ``(step, kind)`` or
``(step, kind, rid)`` (rid only filters ``nan_logits``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np

ALLOC_FAIL = "alloc_fail"
SPILL_FAIL = "spill_fail"
NAN_LOGITS = "nan_logits"
KINDS = (ALLOC_FAIL, SPILL_FAIL, NAN_LOGITS)


class InjectedFault(RuntimeError):
    """Raised where an injected fault simulates a failing operation."""


@dataclasses.dataclass
class FaultPlan:
    """Seeded, deterministic fault source for one engine run.

    Rates are per-opportunity probabilities (an opportunity being one
    allocator call, one spill/restore, or one active slot × decode step).
    ``max_faults`` caps the TOTAL injected faults across kinds (-1 →
    unlimited); ``script`` fires faults at exact engine steps regardless
    of rates and does not count against the cap."""
    seed: int = 0
    alloc_fail: float = 0.0
    spill_fail: float = 0.0
    nan_logits: float = 0.0
    slow_step_s: float = 0.0           # >0 → virtual clock, this much/step
    max_faults: int = -1
    script: Tuple = ()                 # ((step, kind[, rid]), ...)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.step = 0                  # engine step counter (tick())
        self._vtime = 0.0
        self.fired: Dict[str, int] = {k: 0 for k in KINDS}
        for entry in self.script:
            if len(entry) not in (2, 3) or entry[1] not in KINDS:
                raise ValueError(f"bad script entry {entry!r}: want "
                                 f"(step, kind[, rid]) with kind in {KINDS}")

    # -- engine integration ------------------------------------------------
    def tick(self) -> None:
        """Advance one engine step (and the virtual clock)."""
        self.step += 1
        self._vtime += self.slow_step_s

    def now(self) -> float:
        """The engine's clock: virtual when ``slow_step_s`` is set (so
        deadline tests are deterministic), wall-clock otherwise."""
        return self._vtime if self.slow_step_s > 0 else time.perf_counter()

    # -- fault draws (engine call order == replay order) -------------------
    def _scripted(self, kind: str, rid: int = -1) -> bool:
        for entry in self.script:
            if entry[0] == self.step and entry[1] == kind and \
                    (len(entry) < 3 or rid < 0 or entry[2] == rid):
                return True
        return False

    def _draw(self, kind: str, rate: float) -> bool:
        if rate <= 0.0:
            return False
        if 0 <= self.max_faults <= sum(self.fired.values()):
            return False
        hit = bool(self._rng.random() < rate)
        if hit:
            self.fired[kind] += 1
        return hit

    def fail_alloc(self) -> bool:
        """One allocator call pretends the pool is dry."""
        if self._scripted(ALLOC_FAIL):
            return True
        return self._draw(ALLOC_FAIL, self.alloc_fail)

    def check_spill(self, what: str = "spill") -> None:
        """Raise :class:`InjectedFault` where a spill/restore would run."""
        if self._scripted(SPILL_FAIL) or self._draw(SPILL_FAIL,
                                                    self.spill_fail):
            raise InjectedFault(f"injected {what} failure "
                                f"(step {self.step})")

    def poison_logits(self, rid: int) -> bool:
        """True → treat this slot's decode logits as non-finite this step."""
        if self._scripted(NAN_LOGITS, rid):
            return True
        return self._draw(NAN_LOGITS, self.nan_logits)

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())


__all__ = ["FaultPlan", "InjectedFault", "ALLOC_FAIL", "SPILL_FAIL",
           "NAN_LOGITS", "KINDS"]
