"""``torch.profiler`` spans and trace capture.

The port's counterpart of ``repro/obs/profile.py``. :func:`span` is the one
way the port labels its work in a trace: while any ``torch.profiler`` is
capturing (the port's own :func:`profiler_trace`, a benchmark's profiler,
an operator's), it returns ``torch.profiler.record_function(name)``, so the
label is a ``user_annotation`` event in the same Chrome trace as the
CUPTI kernel, copy and runtime events, on one clock; otherwise it returns
one shared no-op context manager (a flag check, no allocation, no
synchronise). The spans the port opens:

  * ``serve.forecast.step`` around a :class:`ForecastServer` step, with
    ``serve.forecast.admit``, ``.stack``, ``.call``, ``.wait`` and
    ``.retire`` inside it, in that order;
  * ``health.probe`` around a probe that runs (on the card one
    ``field_stats`` kernel and one read of its seven scalars), inside
    ``serve.forecast.retire`` when the server probes;
  * every lowered call, named as its metric (``ir.lower_cuda.<program>``,
    ``ir.lower_batched.<program>.<backend>``, ...;
    :func:`repro_torch.obs.metrics.instrument_call`);
  * ``kernels.hdiff_fused`` around a K1 call;
  * ``ir/<program>/<op>`` around every op the IR evaluator computes.

Set ``REPRO_TRACE_DIR=/some/dir`` and every entry point that wraps its work
in :func:`maybe_trace` writes a Chrome trace there (one subdirectory per
label, ``trace.json``), viewable in ``ui.perfetto.dev`` or
``chrome://tracing``.

:func:`profiler_trace` records CPU activity always and CUDA activity when
PyTorch sees a card; the profile object it yields answers
``key_averages()`` (kernel names, device time) after the block ends.
Capture failures (another profiler active, missing CUPTI pieces) degrade
to a warning and a no-op for library callers: tracing must never take a
run down. A caller that needs the trace checks for ``None``.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

TRACE_DIR_ENV = "REPRO_TRACE_DIR"
TRACE_FILE = "trace.json"

_NULL_SPAN = nullcontext()  # reusable: the span while no profiler captures


def trace_dir_from_env() -> str | None:
    """The configured capture directory, or None when capture is off."""
    d = os.environ.get(TRACE_DIR_ENV, "").strip()
    return d or None


def tracing() -> bool:
    """True while any ``torch.profiler`` is capturing (the flag the
    profiler sets on start and clears on stop)."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def span(name: str):
    """A ``record_function(name)`` span while a profiler captures, else the
    shared no-op context manager."""
    if not tracing():
        return _NULL_SPAN
    return torch.profiler.record_function(name)


@contextmanager
def profiler_trace(trace_dir: str | Path):
    """Captures a ``torch.profiler`` trace of the enclosed block and
    exports it to ``trace_dir/trace.json`` (the directory is created if
    needed). Yields the ``torch.profiler.profile`` object, or None when
    capture could not start."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(trace_dir)
    prof = None
    try:
        path.mkdir(parents=True, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # pragma: no cover - backend-dependent
        print(f"repro_torch.obs.profile: trace capture unavailable ({e!r}); "
              f"continuing without", file=sys.stderr)
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(str(path / TRACE_FILE))
            except Exception as e:  # pragma: no cover - backend-dependent
                print(f"repro_torch.obs.profile: stopping the trace failed ({e!r})",
                      file=sys.stderr)


def maybe_trace(label: str | None = None):
    """Env-gated capture: a :func:`profiler_trace` into
    ``$REPRO_TRACE_DIR[/label]`` when the env var is set, else a shared
    no-op context manager."""
    base = trace_dir_from_env()
    if base is None:
        return nullcontext(None)
    return profiler_trace(Path(base) / label if label else Path(base))
