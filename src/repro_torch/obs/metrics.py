"""Lightweight metrics registry: counters, gauges, wall-clock timers.

The port's copy of ``repro/obs/metrics.py``: the observability substrate
the port's IR lowerings report through. Design constraints, in order:

  * **Zero overhead when disabled.** No registry is installed by default;
    every instrumentation hook checks ``current() is None`` (one module
    attribute read) and falls straight through. Timers hand back a shared
    no-op context manager, so a disabled hot loop allocates nothing.
  * **Synchronise before the clock stops.** A CUDA launch returns before
    the card has run it, so timing a call without waiting measures the
    enqueue, not the work. :func:`MetricsRegistry.time_call` synchronises
    the device of every CUDA tensor in the call's result (a tensor, or a
    mapping of tensors) before stopping the clock; CPU results
    need no wait. :func:`instrument_call` applies the same rule to a whole
    lowered step function, and steps aside entirely while a CUDA graph is
    being captured on the current stream (:func:`capturing`): a
    synchronise inside capture would break the capture, and captured calls
    do no work to time. This is the port's counterpart of the JAX
    version's step-aside on tracer arguments.
  * **Nesting is visible.** Active timers form a stack; a timer opened
    inside another records under ``"outer/inner"``.

Enable explicitly (``enable()`` / ``using(reg)``) or via the environment:
``REPRO_METRICS=1`` installs a registry at import time.
"""

from __future__ import annotations

import dataclasses
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Mapping

import torch

METRICS_ENV = "REPRO_METRICS"

_TRUTHY = ("1", "true", "yes", "on")


@dataclasses.dataclass
class TimerStat:
    """Aggregated wall-clock stats for one timer name."""

    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    def as_dict(self) -> dict[str, float]:
        return {
            "count": self.count,
            "total_s": self.total_s,
            "min_s": self.min_s if self.count else 0.0,
            "max_s": self.max_s,
            "mean_s": self.total_s / self.count if self.count else 0.0,
        }


def synchronize(result: Any) -> None:
    """Waits for the devices of every CUDA tensor in ``result`` (a tensor,
    or a mapping of them, as the lowerings return); does nothing for CPU
    tensors and other values."""
    if isinstance(result, torch.Tensor):
        tensors = [result]
    elif isinstance(result, Mapping):
        tensors = [v for v in result.values() if isinstance(v, torch.Tensor)]
    else:
        return
    for device in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(device)


def capturing() -> bool:
    """True while a CUDA graph is being captured on the current stream.
    Without an initialised CUDA context no capture can be underway, and
    the query is not made (it would raise on a CPU-only build)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class MetricsRegistry:
    """Counters, gauges and nested wall-clock timers.

    Not thread-safe by design: the instrumented paths are single-threaded
    (one Python caller launching kernels); a per-thread registry is the
    caller's job if they ever need one.
    """

    def __init__(self) -> None:
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.timers: dict[str, TimerStat] = {}
        self._stack: list[str] = []

    # -- counters / gauges -------------------------------------------------
    def inc(self, name: str, n: float = 1.0) -> float:
        new = self.counters.get(name, 0.0) + n
        self.counters[name] = new
        return new

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    # -- timers ------------------------------------------------------------
    @contextmanager
    def timer(self, name: str):
        """Times a ``with`` block. Nested timers record under the joined
        path of every active timer (``"outer/inner"``)."""
        self._stack.append(name)
        path = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            popped = self._stack.pop()
            assert popped == name
            self.timers.setdefault(path, TimerStat()).record(dt)

    def observe(self, name: str, dt: float) -> None:
        """Records an externally-measured duration (seconds) under ``name``."""
        self.timers.setdefault(name, TimerStat()).record(dt)

    def time_call(self, name: str, fn: Callable, *args, **kwargs) -> Any:
        """Calls ``fn`` under ``timer(name)``, synchronising the devices of
        its CUDA results (:func:`synchronize`) before the clock stops."""
        with self.timer(name):
            out = fn(*args, **kwargs)
            synchronize(out)
        return out

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.timers.clear()
        self._stack.clear()

    def snapshot(self) -> dict[str, Any]:
        """A JSON-serialisable copy of everything recorded so far."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "timers": {k: v.as_dict() for k, v in self.timers.items()},
        }


# --- module-level switchboard --------------------------------------------

_REGISTRY: MetricsRegistry | None = None


class _NullTimer:
    """Shared no-op context manager: the disabled-path timer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


def current() -> MetricsRegistry | None:
    """The active registry, or None when metrics are disabled."""
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY is not None


def enable(registry: MetricsRegistry | None = None) -> MetricsRegistry:
    """Installs ``registry`` (or a fresh one) as the active registry."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else MetricsRegistry()
    return _REGISTRY


def disable() -> None:
    global _REGISTRY
    _REGISTRY = None


@contextmanager
def using(registry: MetricsRegistry | None = None):
    """Scoped ``enable()``: restores the previous registry on exit."""
    global _REGISTRY
    prev = _REGISTRY
    reg = registry if registry is not None else MetricsRegistry()
    _REGISTRY = reg
    try:
        yield reg
    finally:
        _REGISTRY = prev


# -- zero-overhead convenience hooks (the instrumented layers call these) --


def inc(name: str, n: float = 1.0) -> None:
    if _REGISTRY is not None:
        _REGISTRY.inc(name, n)


def set_gauge(name: str, value: float) -> None:
    if _REGISTRY is not None:
        _REGISTRY.set_gauge(name, value)


def timer(name: str):
    """A timer for the active registry, or the shared no-op when disabled."""
    if _REGISTRY is None:
        return _NULL_TIMER
    return _REGISTRY.timer(name)


def observe(name: str, dt: float) -> None:
    if _REGISTRY is not None:
        _REGISTRY.observe(name, dt)


def instrument_call(fn: Callable, name: str) -> Callable:
    """Wraps a lowered step function with a per-call timer + counter.

    When metrics are disabled the wrapper is a single attribute check and
    calls straight through; while a CUDA graph is being captured it also
    steps aside, so captured launches never land in wall-clock stats and
    the captured work is identical to the uninstrumented one.
    """

    def wrapped(*args, **kwargs):
        reg = _REGISTRY
        if reg is None or capturing():
            return fn(*args, **kwargs)
        reg.inc(f"{name}.calls")
        return reg.time_call(name, fn, *args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    wrapped.__wrapped__ = fn
    wrapped.metric_name = name
    return wrapped


if os.environ.get(METRICS_ENV, "").lower() in _TRUTHY:
    enable()
