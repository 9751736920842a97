"""Prometheus-style text exposition of the metrics registry.

Turns a :class:`repro_torch.obs.metrics.MetricsRegistry` snapshot — counters,
gauges (including the ``health.<field>.<stat>`` gauges the
:class:`~repro_torch.obs.health.HealthMonitor` maintains) and timers — into the
Prometheus text exposition format, so a scrape endpoint in front of any
instrumented run is one call away (the port's copy of
``repro/obs/export.py``). No HTTP server lives here: serving bytes is
the caller's framework's job; this module only owns the wire format.

Mapping rules:

  * counter ``serve.prefills``      -> ``repro_serve_prefills_total``
  * gauge   ``health.psi.nan_count``-> ``repro_health_psi_nan_count``
  * timer   ``serve.decode_step``   -> summary ``repro_serve_decode_step_
    seconds`` (``_count`` + ``_sum``) plus ``_seconds_min``/``_seconds_max``
    gauges (min/max aren't part of the summary type but are too useful to
    drop).

Metric names are sanitised to ``[a-zA-Z_:][a-zA-Z0-9_:]*``; every exported
family carries ``# TYPE`` (and the original dotted name in ``# HELP``).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

from repro_torch.obs import metrics

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """A dotted/free-form metric name as a valid Prometheus identifier."""
    out = _INVALID.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _fmt(value: float) -> str:
    f = float(value)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def prometheus_text(
    source: metrics.MetricsRegistry | Mapping[str, Any] | None = None,
    *,
    prefix: str = "repro",
) -> str:
    """The Prometheus exposition of ``source``.

    ``source`` may be a registry, an already-taken ``snapshot()`` dict, or
    None for the active registry. With metrics disabled (no registry) the
    exposition is a single comment line — a scrape endpoint must always
    have *something* well-formed to serve.
    """
    if source is None:
        source = metrics.current()
    if source is None:
        return "# repro metrics disabled (no registry installed)\n"
    snap = source.snapshot() if isinstance(source, metrics.MetricsRegistry) else source

    lines: list[str] = []

    for name in sorted(snap.get("counters", {})):
        m = f"{prefix}_{sanitize_metric_name(name)}_total"
        lines.append(f"# HELP {m} counter {name!r}")
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(snap['counters'][name])}")

    for name in sorted(snap.get("gauges", {})):
        m = f"{prefix}_{sanitize_metric_name(name)}"
        lines.append(f"# HELP {m} gauge {name!r}")
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(snap['gauges'][name])}")

    for name in sorted(snap.get("timers", {})):
        stat = snap["timers"][name]
        base = f"{prefix}_{sanitize_metric_name(name)}_seconds"
        lines.append(f"# HELP {base} wall-clock summary of timer {name!r}")
        lines.append(f"# TYPE {base} summary")
        lines.append(f"{base}_count {_fmt(stat['count'])}")
        lines.append(f"{base}_sum {_fmt(stat['total_s'])}")
        for suffix, key in (("min", "min_s"), ("max", "max_s")):
            g = f"{base}_{suffix}"
            lines.append(f"# TYPE {g} gauge")
            lines.append(f"{g} {_fmt(stat[key])}")

    return "\n".join(lines) + "\n"
