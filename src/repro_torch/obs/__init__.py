"""repro_torch.obs — runtime telemetry + numerics health for the port.

The port's copy of ``repro.obs``, seven small pieces:

  * :mod:`repro_torch.obs.metrics` — counters / gauges / nested wall-clock
    timers that synchronise the card before the clock stops; zero-overhead
    no-op when disabled, enabled via ``enable()`` / ``using()`` /
    ``REPRO_METRICS=1``; ``instrument_call`` steps aside during CUDA graph
    capture.
  * :mod:`repro_torch.obs.health`  — field probes with torch reductions
    (``field_stats``: int32 NaN/Inf counts, finite min/max/mean, L2) and
    the cadence/policy ``HealthMonitor``.
  * :mod:`repro_torch.obs.events`  — the flight recorder: bounded ring of
    structured events, span helpers, ``REPRO_EVENT_LOG`` JSONL sink and a
    crash dump that flushes the ring on abort.
  * :mod:`repro_torch.obs.export`  — Prometheus-style text exposition of
    the metrics snapshot (health gauges included).
  * :mod:`repro_torch.obs.drift`   — model-vs-measured drift detection.
  * :mod:`repro_torch.obs.report`  — structured JSON run reports + the
    ``runtime_metadata()`` stamp (torch / CUDA, the card, its power limit).
  * :mod:`repro_torch.obs.profile` — env-gated ``torch.profiler`` capture
    (``REPRO_TRACE_DIR``), with per-IR-op ``record_function`` labels.

The port's IR lowerings report through this package. Importing it
initialises no CUDA context.
"""

from repro_torch.obs import events, metrics
from repro_torch.obs.drift import DEFAULT_TOLERANCE, DriftResult, check_drift
from repro_torch.obs.events import EVENT_LOG_ENV, Event, FlightRecorder
from repro_torch.obs.export import prometheus_text, sanitize_metric_name
from repro_torch.obs.health import (
    HealthMonitor,
    NumericsError,
    field_stats,
    host_stats,
    is_healthy,
)
from repro_torch.obs.metrics import (
    METRICS_ENV,
    MetricsRegistry,
    TimerStat,
    instrument_call,
)
from repro_torch.obs.profile import TRACE_DIR_ENV, maybe_trace, profiler_trace
from repro_torch.obs.report import MATCH_KEYS, RunReport, git_commit, runtime_metadata

__all__ = [
    "DEFAULT_TOLERANCE",
    "DriftResult",
    "EVENT_LOG_ENV",
    "Event",
    "FlightRecorder",
    "HealthMonitor",
    "MATCH_KEYS",
    "METRICS_ENV",
    "MetricsRegistry",
    "NumericsError",
    "RunReport",
    "TRACE_DIR_ENV",
    "TimerStat",
    "check_drift",
    "events",
    "field_stats",
    "git_commit",
    "host_stats",
    "instrument_call",
    "is_healthy",
    "maybe_trace",
    "metrics",
    "profiler_trace",
    "prometheus_text",
    "runtime_metadata",
    "sanitize_metric_name",
]
