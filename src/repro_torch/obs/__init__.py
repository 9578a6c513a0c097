"""repro_torch.obs — process-local telemetry: metrics, traces, profiling
hooks (the port of ``repro/obs``, with the same ``__all__``).

Pure host-side Python (no torch import at module load); safe to import from
the scheduler, the launchers and scripts alike.
"""

from repro_torch.obs.metrics import (
    ITER_BUCKETS,
    LATENCY_BUCKETS,
    RESIDUAL_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RingBuffer,
    default_registry,
    hist_quantile,
    parse_exposition,
    snapshot_series,
)
from repro_torch.obs.profiling import StepTraceWindow, trace_window
from repro_torch.obs.trace import TERMINAL_STATUSES, Span, Trace, TraceError

__all__ = [
    "ITER_BUCKETS",
    "LATENCY_BUCKETS",
    "RESIDUAL_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RingBuffer",
    "default_registry",
    "hist_quantile",
    "parse_exposition",
    "snapshot_series",
    "StepTraceWindow",
    "trace_window",
    "TERMINAL_STATUSES",
    "Span",
    "Trace",
    "TraceError",
]
