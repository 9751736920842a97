"""The program's own spans in the traced stretch, and the device work and
idle time they hold.

While a profiler captures, the port labels its work with ``record_function``
spans (``repro_torch.obs.profile.span``) whose names start with ``serve.``,
``health.``, ``ir.`` or ``kernels.``. They are ``user_annotation`` events on
the host's clock, the clock of the CUPTI kernel, copy, set and runtime events
of the same Chrome trace (the ``gpu_user_annotation`` copies on the device's
rows are left out). A kernel, copy or set is tied to the runtime call that
launched it by the ``correlation`` in both events' ``args``; it was launched
inside a span when that call started inside it. Idle time is the part of the
stretch in which no kernel, copy or set runs, as ``tracing.Summary`` counts
it, and a span holds the idle time it overlaps.

``tracing.Summary`` keeps no events, so :func:`of` reads the trace the traced
run wrote (``tracing.TRACE_FILE``) once for each summary and holds the result
on it. On a program that opens none of these spans each reader returns None.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

from portbench.tracing import DEVICE_CATS, STRETCH, TRACE_FILE, union

PREFIXES = ("serve.", "health.", "ir.", "kernels.")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# Runtime calls that hold the host until the device has caught up.
WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")


def subtract(a, b):
    """The merged intervals ``a`` less the merged intervals ``b``."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append([s, bs])
            s = max(s, be)
            if s >= e:
                break
        if s < e:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length that the merged intervals ``a`` and ``b`` share."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total


def covering(merged):
    """A test of whether a time lies inside one of the merged intervals."""
    starts = [s for s, _ in merged]

    def covers(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]

    return covers


class Spans:
    """The program's spans of one traced stretch, in microseconds of the
    trace's clock; the readers' answers in seconds."""

    def __init__(self, events: list) -> None:
        stretch = [e for e in events if e.get("name") == STRETCH
                   and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        if not stretch:
            raise RuntimeError("the trace holds no stretch span")
        self.t0 = float(stretch[0]["ts"])
        self.t1 = self.t0 + float(stretch[0]["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.spans: dict[str, list] = {}
        launches: dict = {}
        self.waits: list[float] = []
        self.has_runtime = False
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), e.get("name", "")
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if cat == "user_annotation" and name.startswith(PREFIXES):
                if b > self.t0 and a < self.t1:
                    self.spans.setdefault(name, []).append((a, b))
            elif cat in RUNTIME_CATS:
                self.has_runtime = True
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = a
                if name in WAITS and self.t0 <= a < self.t1:
                    self.waits.append(a)
            elif cat in DEVICE_CATS:
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    device.append(((e.get("args") or {}).get("correlation"), a, b))
        for v in self.spans.values():
            v.sort()
        self.waits.sort()
        # Each device activity in the stretch with the start of its launch.
        self.launched = [(launches.get(corr), a, b) for corr, a, b in device]
        busy = union((a, b) for _, a, b in device)
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        self.idle = [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]
        self.busy_s = sum(b - a for a, b in busy) * 1e-6

    def count(self, name: str) -> int:
        """Spans of ``name`` that start inside the stretch."""
        return sum(self.t0 <= a < self.t1 for a, _ in self.spans.get(name, ()))

    def merged(self, name: str):
        return union(self.spans.get(name, ()))

    def device_s(self, name: str) -> float:
        """Device seconds of the work launched inside spans of ``name``."""
        covers = covering(self.merged(name))
        return sum(b - a for t, a, b in self.launched if t is not None and covers(t)) * 1e-6

    def idle_s(self, name: str, exclude=()) -> float:
        """Device-idle seconds that overlap spans of ``name`` and no span of
        the names in ``exclude``."""
        region = self.merged(name)
        for other in exclude:
            region = subtract(region, self.merged(other))
        return overlap(self.idle, region) * 1e-6

    def waits_in(self, name: str) -> int:
        """Runtime calls of ``WAITS`` that start inside spans of ``name``."""
        covers = covering(self.merged(name))
        return sum(covers(t) for t in self.waits)

    def outermost(self, prefixes) -> tuple[int, float]:
        """The count and host seconds of the spans whose names start with
        one of ``prefixes``, start inside the stretch and lie inside no
        other program span."""
        every = sorted((a, -b, n) for n, v in self.spans.items() for a, b in v)
        count, total, end = 0, 0.0, -float("inf")
        for a, b, name in ((a, -nb, n) for a, nb, n in every):
            if a < end and b <= end:
                continue  # inside an earlier span
            end = max(end, b)
            if name.startswith(tuple(prefixes)) and self.t0 <= a < self.t1:
                count += 1
                total += b - a
        return count, total * 1e-6


def of(t, path: Path | None = None) -> Spans:
    """The program's spans of the summary ``t``'s stretch, read once from
    the trace at ``path`` (the traced run's, by default) and held on ``t``."""
    spans = getattr(t, "program_spans", None)
    if spans is None:
        path = TRACE_FILE if path is None else path
        spans = Spans(json.loads(Path(path).read_text())["traceEvents"])
        if abs(spans.window_s - t.window_s) > 1e-9:
            raise RuntimeError(f"{path} holds a stretch of {spans.window_s} s, not this "
                               f"run's {t.window_s} s")
        t.program_spans = spans
    return spans


def per_unit(t, value, scale: float = 1.0):
    """``value`` over the stretch's units, times ``scale``; None without
    units."""
    units = t.counts.get("units", 0)
    if value is None or not units:
        return None
    return scale * value / units
