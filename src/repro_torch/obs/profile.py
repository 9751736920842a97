"""Optional ``torch.profiler`` trace capture, env-gated.

The port's counterpart of ``repro/obs/profile.py``. Set
``REPRO_TRACE_DIR=/some/dir`` and every entry point that wraps its work in
:func:`maybe_trace` writes a Chrome trace there (one subdirectory per
label, ``trace.json``), viewable in ``ui.perfetto.dev`` or
``chrome://tracing``. While a trace is being captured,
:mod:`repro_torch.ir.evaluate` labels every IR op with
``torch.profiler.record_function("ir/<program>/<op>")``, so the timelines
carry stencil-op names; outside a trace it enters no label at all.

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

TRACE_DIR_ENV = "REPRO_TRACE_DIR"
TRACE_FILE = "trace.json"

_ACTIVE = 0  # number of profiler_trace blocks currently capturing


def trace_dir_from_env() -> str | None:
    """The configured capture directory, or None when capture is off."""
    d = os.environ.get(TRACE_DIR_ENV, "").strip()
    return d or None


def tracing() -> bool:
    """True while a :func:`profiler_trace` block is capturing."""
    return _ACTIVE > 0


@contextmanager
def profiler_trace(trace_dir: str | Path):
    """Captures a ``torch.profiler`` trace of the enclosed block and
    exports it to ``trace_dir/trace.json`` (the directory is created if
    needed). Yields the ``torch.profiler.profile`` object, or None when
    capture could not start."""
    global _ACTIVE
    import torch

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
    if prof is not None:
        _ACTIVE += 1
    try:
        yield prof
    finally:
        if prof is not None:
            _ACTIVE -= 1
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
