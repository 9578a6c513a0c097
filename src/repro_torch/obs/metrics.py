"""Process-local metrics registry: counters, gauges, histograms (the port's
own copy of ``repro/obs/metrics.py``: the same families, bucket ladders,
snapshot dict and text exposition).

Design notes
------------
* Pure host-side Python; nothing here touches torch or the device.  Recording a
  sample is a dict lookup plus a float add, so the engine can stamp metrics
  inside its step loop without perturbing dispatch behaviour.
* A *family* (``Counter``/``Gauge``/``Histogram``) owns a set of label names;
  ``family.labels(k=v, ...)`` returns a bound *child* that does the actual
  counting.  Children are cached, so hot paths bind once and hold the child.
* ``MetricsRegistry(enabled=False)`` freezes observation-grade collection
  (histogram observations become no-ops; the engine also skips building
  request traces).  Counters and gauges always count because engine
  bookkeeping (``queue_stats``/``page_stats``/dispatch counters) is a thin
  view over them.
* Export: ``snapshot()`` (plain dict, JSON-serialisable), ``to_prometheus()``
  (text exposition), ``append_jsonl(path)`` (one snapshot per line).
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "LATENCY_BUCKETS",
    "ITER_BUCKETS",
    "RESIDUAL_BUCKETS",
    "RingBuffer",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "parse_exposition",
    "snapshot_series",
    "hist_quantile",
]

# Fixed log-spaced latency buckets: 3 per decade from 100 us to ~4600 s.
# Shared by every *_seconds histogram so exposition stays mergeable.
LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (i / 3.0 - 4.0), 10) for i in range(22)
)

# Power-of-two buckets for iteration counts (PGD steps per layer).
ITER_BUCKETS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(11))  # 1..1024

# Log-spaced buckets for reconstruction residuals (relative Frobenius loss).
RESIDUAL_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (i / 2.0 - 6.0), 12) for i in range(17)
)  # 1e-6 .. 1e2


class RingBuffer:
    """Fixed-capacity ring keeping the most recent samples.

    Unlike the old list-with-cap it never silently stops recording: once full
    the oldest sample is overwritten and ``dropped`` is incremented, so
    consumers can tell a truncated trace from a complete one.
    """

    __slots__ = ("capacity", "_buf", "_start", "_len", "dropped")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"RingBuffer capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[float] = [0.0] * self.capacity
        self._start = 0
        self._len = 0
        self.dropped = 0

    def append(self, value: float) -> None:
        if self._len < self.capacity:
            self._buf[(self._start + self._len) % self.capacity] = value
            self._len += 1
        else:
            self._buf[self._start] = value
            self._start = (self._start + 1) % self.capacity
            self.dropped += 1

    def values(self) -> List[float]:
        return [self._buf[(self._start + i) % self.capacity] for i in range(self._len)]

    def clear(self) -> None:
        self._start = 0
        self._len = 0
        self.dropped = 0

    def __len__(self) -> int:
        return self._len


def _label_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _CounterChild:
    __slots__ = ("labels", "_value")

    def __init__(self, labels: Dict[str, str]):
        self.labels = labels
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


class _GaugeChild:
    """Gauge child with running peak/sum/samples and an optional ring trace."""

    __slots__ = ("labels", "_value", "peak", "sum", "samples", "ring")

    def __init__(self, labels: Dict[str, str], trace_capacity: int = 0):
        self.labels = labels
        self._value = 0.0
        self.peak = 0.0
        self.sum = 0.0
        self.samples = 0
        self.ring: Optional[RingBuffer] = (
            RingBuffer(trace_capacity) if trace_capacity > 0 else None
        )

    def set(self, value: float) -> None:
        self._value = value
        if value > self.peak:
            self.peak = value
        self.sum += value
        self.samples += 1
        if self.ring is not None:
            self.ring.append(value)

    def set_value(self, value: float) -> None:
        """Refresh the instantaneous value without recording a sample
        (keeps snapshot-time refreshes out of the per-step mean/trace)."""
        self._value = value
        if value > self.peak:
            self.peak = value

    @property
    def value(self) -> float:
        return self._value

    @property
    def mean(self) -> float:
        return self.sum / self.samples if self.samples else 0.0

    def trace_values(self) -> List[float]:
        return self.ring.values() if self.ring is not None else []

    @property
    def trace_dropped(self) -> int:
        return self.ring.dropped if self.ring is not None else 0

    def reset(self) -> None:
        self._value = 0.0
        self.peak = 0.0
        self.sum = 0.0
        self.samples = 0
        if self.ring is not None:
            self.ring.clear()


class _HistogramChild:
    __slots__ = ("labels", "bounds", "counts", "sum", "count", "min", "max", "_registry")

    def __init__(self, labels: Dict[str, str], bounds: Tuple[float, ...], registry):
        self.labels = labels
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot is the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf
        self._registry = registry

    def observe(self, value: float) -> None:
        if self._registry is not None and not self._registry.enabled:
            return
        # First bucket whose upper bound is >= value (le semantics).
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.sum += value
        self.count += 1
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile by linear interpolation within buckets."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i >= len(self.bounds):  # overflow bucket: best guess is max
                    return self.max
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i > 0 else min(self.min, hi)
                frac = (target - cum) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...], unit: str):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.unit = unit
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _make_child(self, labels: Dict[str, str]):
        raise NotImplementedError

    def labels(self, **labels: str):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {sorted(self.labelnames)}, "
                f"got {sorted(labels)}"
            )
        labels = {k: str(v) for k, v in labels.items()}
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._make_child(labels)
            self._children[key] = child
        return child

    def children(self) -> Iterable[object]:
        return self._children.values()

    def reset(self) -> None:
        for child in self._children.values():
            child.reset()


class Counter(_Family):
    kind = "counter"

    def _make_child(self, labels: Dict[str, str]) -> _CounterChild:
        return _CounterChild(labels)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)  # type: ignore[call-arg]

    @property
    def value(self) -> float:
        return sum(c.value for c in self._children.values())


class Gauge(_Family):
    kind = "gauge"

    def __init__(self, name, help, labelnames, unit, trace_capacity: int = 0):
        super().__init__(name, help, labelnames, unit)
        self.trace_capacity = trace_capacity

    def _make_child(self, labels: Dict[str, str]) -> _GaugeChild:
        return _GaugeChild(labels, self.trace_capacity)

    def set(self, value: float) -> None:
        self.labels().set(value)  # type: ignore[call-arg]


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, unit, buckets: Sequence[float], registry):
        super().__init__(name, help, labelnames, unit)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"{name}: histogram buckets must be strictly increasing")
        self.bounds = bounds
        self._registry = registry

    def _make_child(self, labels: Dict[str, str]) -> _HistogramChild:
        return _HistogramChild(labels, self.bounds, self._registry)

    def observe(self, value: float) -> None:
        self.labels().observe(value)  # type: ignore[call-arg]


class MetricsRegistry:
    """Container of metric families; the unit of snapshot/exposition.

    ``enabled=False`` disables histogram observations (and is the flag the
    engine consults before building request traces); counters and gauges keep
    counting so engine bookkeeping views stay correct either way.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # -- family constructors (get-or-create; definitions must agree) --------

    def _get_or_create(self, name: str, kind: str, make):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}, not {kind}"
                    )
                return fam
            fam = make()
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                unit: str = "") -> Counter:
        return self._get_or_create(
            name, "counter", lambda: Counter(name, help, tuple(labelnames), unit)
        )

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = (),
              unit: str = "", trace_capacity: int = 0) -> Gauge:
        return self._get_or_create(
            name, "gauge",
            lambda: Gauge(name, help, tuple(labelnames), unit, trace_capacity),
        )

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  unit: str = "", buckets: Sequence[float] = LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._get_or_create(
            name, "histogram",
            lambda: Histogram(name, help, tuple(labelnames), unit, buckets, self),
        )

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def families(self) -> List[_Family]:
        return list(self._families.values())

    def reset(self) -> None:
        for fam in self._families.values():
            fam.reset()

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict snapshot, JSON-serialisable, schema-checked in CI."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for fam in self._families.values():
            if fam.kind == "counter":
                out["counters"][fam.name] = {
                    "help": fam.help,
                    "unit": fam.unit,
                    "series": [
                        {"labels": dict(c.labels), "value": c.value}
                        for c in fam.children()
                    ],
                }
            elif fam.kind == "gauge":
                series = []
                for c in fam.children():
                    entry = {
                        "labels": dict(c.labels),
                        "value": c.value,
                        "peak": c.peak,
                        "mean": c.mean,
                        "samples": c.samples,
                    }
                    if c.ring is not None:
                        entry["trace"] = c.trace_values()
                        entry["dropped"] = c.trace_dropped
                    series.append(entry)
                out["gauges"][fam.name] = {
                    "help": fam.help, "unit": fam.unit, "series": series,
                }
            else:  # histogram
                out["histograms"][fam.name] = {
                    "help": fam.help,
                    "unit": fam.unit,
                    "series": [
                        {
                            "labels": dict(c.labels),
                            "le": list(c.bounds),
                            "counts": list(c.counts),
                            "sum": c.sum,
                            "count": c.count,
                            "min": c.min if c.count else 0.0,
                            "max": c.max if c.count else 0.0,
                        }
                        for c in fam.children()
                    ],
                }
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4 subset)."""
        lines: List[str] = []
        for fam in self._families.values():
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for c in fam.children():
                base = _fmt_labels(c.labels)
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{fam.name}{base} {_fmt_value(c.value)}")
                else:
                    cum = 0
                    for bound, n in zip(c.bounds, c.counts):
                        cum += n
                        le = _fmt_labels(dict(c.labels, le=_fmt_value(bound)))
                        lines.append(f"{fam.name}_bucket{le} {cum}")
                    cum += c.counts[-1]
                    le = _fmt_labels(dict(c.labels, le="+Inf"))
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                    lines.append(f"{fam.name}_sum{base} {_fmt_value(c.sum)}")
                    lines.append(f"{fam.name}_count{base} {c.count}")
        return "\n".join(lines) + "\n"

    def append_jsonl(self, path: str, extra: Optional[dict] = None) -> None:
        """Append one snapshot as a single JSON line."""
        record = dict(extra or {})
        record["snapshot"] = self.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def dump_json(self, path: str, meta: Optional[dict] = None) -> dict:
        """Write the snapshot (plus optional ``meta`` key) as pretty JSON."""
        snap = self.snapshot()
        if meta:
            snap["meta"] = meta
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        return snap


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """Process-global registry, used by compression when none is passed."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def parse_exposition(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Parse the text exposition back into {metric: {label-key: value}}.

    Used by the round-trip tests; handles the subset ``to_prometheus`` emits
    (histograms appear under their ``_bucket``/``_sum``/``_count`` names).
    """
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        labels: Dict[str, str] = {}
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            body = rest.rsplit("}", 1)[0]
            for item in _split_labels(body):
                k, _, v = item.partition("=")
                labels[k] = _unescape(v.strip('"'))
        else:
            name = name_part
        value = math.inf if value_part == "+Inf" else float(value_part)
        out.setdefault(name, {})[_label_key(labels)] = value
    return out


def _split_labels(body: str) -> List[str]:
    items, depth, cur = [], False, []
    for ch in body:
        if ch == '"':
            depth = not depth
            cur.append(ch)
        elif ch == "," and not depth:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        items.append("".join(cur))
    return items


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def snapshot_series(snap: dict, kind: str, name: str,
                    labels: Optional[Mapping[str, str]] = None) -> Optional[dict]:
    """Find one series entry in a snapshot by family name + label subset."""
    fam = snap.get(kind, {}).get(name)
    if fam is None:
        return None
    matches = [
        s for s in fam["series"]
        if labels is None or all(s["labels"].get(k) == str(v) for k, v in labels.items())
    ]
    if not matches:
        return None
    if len(matches) > 1:
        raise ValueError(f"{name}: {len(matches)} series match labels {labels}")
    return matches[0]


def hist_quantile(entry: Mapping, q: float) -> float:
    """Quantile estimate from a snapshot histogram series entry."""
    count = entry["count"]
    if count == 0:
        return 0.0
    bounds, counts = entry["le"], entry["counts"]
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            if i >= len(bounds):
                return entry["max"]
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else min(entry["min"], hi)
            est = lo + (hi - lo) * (target - cum) / c
            return min(max(est, entry["min"]), entry["max"])
        cum += c
    return entry["max"]
