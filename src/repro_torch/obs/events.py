"""Flight recorder: a bounded ring of structured run events + JSONL sink.

The port's copy of ``repro/obs/events.py`` (pure Python).

The run-health counterpart of :mod:`repro_torch.obs.metrics`: where the registry
aggregates (counters/gauges/timers), the recorder keeps the *sequence* —
what happened, in what order, right up to the moment a long forecast blew
up. Design constraints mirror the metrics switchboard:

  * **Zero overhead when disabled.** No recorder installed means every
    module hook (:func:`record`, :func:`span`, :func:`crash_dump`) is one
    attribute check; ``span`` hands back a shared no-op context manager.
  * **Bounded memory.** The ring holds the last ``capacity`` events
    (``deque(maxlen=...)``); older events are dropped (and counted in
    ``dropped``) — a million-step forecast can record every probe without
    growing without bound.
  * **Crash-survivable.** With a sink configured (``REPRO_EVENT_LOG=path``
    or ``FlightRecorder(sink=...)``) every event is appended to the JSONL
    file *as it is recorded* (line-buffered + flushed), so a hard crash
    still leaves the log on disk. The first line of the sink is a ``meta``
    event carrying :func:`repro_torch.obs.report.runtime_metadata`. On a managed
    abort, :meth:`FlightRecorder.crash_dump` additionally writes the whole
    ring (plus metadata and the abort reason) as one JSON document.

Event timestamps are ``time.monotonic()`` (ordering/durations are immune
to wall-clock steps) plus ``time.time()`` for cross-run correlation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any

EVENT_LOG_ENV = "REPRO_EVENT_LOG"
DEFAULT_CAPACITY = 4096


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured run event."""

    seq: int              # recorder-local sequence number (total order)
    ts: float             # time.monotonic() at record time
    wall: float           # time.time() at record time
    kind: str             # dotted event name, e.g. "health.blowup"
    data: dict[str, Any]  # free-form JSON-serialisable payload

    def as_dict(self) -> dict[str, Any]:
        return {
            "seq": self.seq,
            "ts": self.ts,
            "wall": self.wall,
            "kind": self.kind,
            "data": self.data,
        }


class FlightRecorder:
    """Bounded ring buffer of :class:`Event` with an optional JSONL sink."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        sink: str | Path | None = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.sink = Path(sink) if sink else None
        self.dropped = 0
        self._ring: deque[Event] = deque(maxlen=capacity)
        self._seq = 0
        self._file = None  # lazily opened append handle
        self._header_written = False  # once per recorder, even across close/reopen

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, **data: Any) -> Event:
        ev = Event(seq=self._seq, ts=time.monotonic(), wall=time.time(),
                   kind=kind, data=data)
        self._seq += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)
        if self.sink is not None:
            self._write_line(ev)
        return ev

    @contextmanager
    def span(self, kind: str, **data: Any):
        """Times a ``with`` block and records ONE event on exit with the
        measured ``duration_s`` (single-event spans keep the sink small;
        the start instant is recoverable as ``ts - duration_s``)."""
        t0 = time.monotonic()
        try:
            yield self
        finally:
            self.record(kind, duration_s=time.monotonic() - t0, **data)

    # -- inspection --------------------------------------------------------
    def events(self, kind: str | None = None) -> list[Event]:
        """A snapshot of the ring, optionally filtered by exact kind."""
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e.kind == kind]

    def __len__(self) -> int:
        return len(self._ring)

    # -- sink / dump -------------------------------------------------------
    def _metadata(self) -> dict[str, Any]:
        """Best-effort runtime stamp: recorder I/O must never take the run
        down (and must not initialise a CUDA context that is not there)."""
        try:
            from repro_torch.obs.report import runtime_metadata

            return runtime_metadata()
        except Exception as e:  # pragma: no cover - backend-dependent
            return {"error": f"runtime_metadata unavailable: {e!r}"}

    def _write_line(self, ev: Event) -> None:
        if self._file is None:
            self.sink.parent.mkdir(parents=True, exist_ok=True)
            self._file = self.sink.open("a", buffering=1)
            if not self._header_written:
                header = {"seq": -1, "ts": time.monotonic(), "wall": time.time(),
                          "kind": "meta", "data": self._metadata()}
                self._file.write(json.dumps(header, default=str) + "\n")
                self._header_written = True
        self._file.write(json.dumps(ev.as_dict(), default=str) + "\n")
        self._file.flush()

    def crash_dump(self, path: str | Path | None = None, *,
                   reason: str = "") -> Path | None:
        """Flushes the whole ring (+ metadata + ``reason``) as one JSON
        document — the abort-path artifact. Default target: the sink path
        with ``.crash.json`` appended; returns None (no-op) when neither a
        path nor a sink is configured (the in-memory ring remains
        inspectable via :meth:`events`)."""
        if path is None:
            if self.sink is None:
                return None
            path = self.sink.with_name(self.sink.name + ".crash.json")
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "reason": reason,
            "metadata": self._metadata(),
            "dropped": self.dropped,
            "events": [e.as_dict() for e in self._ring],
        }
        path.write_text(json.dumps(payload, indent=2, default=str) + "\n")
        return path

    def close(self) -> None:
        """Closes the sink file handle. Safe to keep using the recorder:
        the next sink write lazily reopens in append mode (without
        duplicating the ``meta`` header)."""
        if self._file is not None:
            self._file.close()
            self._file = None


# --- module-level switchboard (mirrors repro_torch.obs.metrics) ------------

_RECORDER: FlightRecorder | None = None


def current() -> FlightRecorder | None:
    """The active recorder, or None when event logging is disabled."""
    return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


def enable(recorder: FlightRecorder | None = None) -> FlightRecorder:
    """Installs ``recorder`` (or a fresh sink-less one) as active. A
    different recorder being replaced has its sink handle closed — the
    switchboard owns the fd of whatever it installed (re-enabling the old
    recorder later is safe: the sink lazily reopens)."""
    global _RECORDER
    rec = recorder if recorder is not None else FlightRecorder()
    if _RECORDER is not None and _RECORDER is not rec:
        _RECORDER.close()
    _RECORDER = rec
    return _RECORDER


def disable() -> None:
    """Uninstalls (and closes the sink handle of) the active recorder."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
    _RECORDER = None


@contextmanager
def using(recorder: FlightRecorder | None = None):
    """Scoped :func:`enable`: restores the previous recorder on exit and
    closes the scoped one's sink handle (its ring stays inspectable)."""
    global _RECORDER
    prev = _RECORDER
    rec = recorder if recorder is not None else FlightRecorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = prev
        if rec is not prev:
            rec.close()


# -- zero-overhead convenience hooks (instrumented layers call these) -------


def record(kind: str, **data: Any) -> Event | None:
    if _RECORDER is not None:
        return _RECORDER.record(kind, **data)
    return None


def span(kind: str, **data: Any):
    """A span on the active recorder, or a shared no-op when disabled."""
    if _RECORDER is None:
        return nullcontext(None)
    return _RECORDER.span(kind, **data)


def crash_dump(path: str | Path | None = None, *, reason: str = "") -> Path | None:
    if _RECORDER is not None:
        return _RECORDER.crash_dump(path, reason=reason)
    return None


if os.environ.get(EVENT_LOG_ENV, "").strip():
    enable(FlightRecorder(sink=os.environ[EVENT_LOG_ENV].strip()))
