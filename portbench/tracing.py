"""The traced stretch: torch.profiler (CUPTI) over a fixed number of units.

The stretch is the span ``portbench.stretch`` that opens at a unit boundary,
one unit after the profiler has started, and closes after ``trace_units``
units, each ending synchronised. The profiler's Chrome trace (a few MB, at a fixed path inside
the checkout, overwritten by the next traced run) is read back here:
device activity is every event of the kernel, memcpy and memset categories
inside the stretch; the device is busy where any of them runs, and idle in
the gaps between, each gap named by the innermost host event that covers
its middle. The per-layer readers (``metrics/``) take a :class:`Summary`.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
TRACE_FILE = HERE.parent / "build" / "portbench" / "trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
STRETCH = "portbench.stretch"
TOP = 10


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its return type and its argument list, cut
    to ``width`` characters."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i and name[i - 1] != " ":
                    name = name[:i]
                break
    return name.removeprefix("void ")[:width]


def union(intervals):
    """Merged, sorted ``[start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def host_names(times, host) -> list:
    """For each of the sorted ``times``, the name of the shortest host event
    of ``host`` (sorted by start) that covers it."""
    names, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        inner = min(active, key=lambda h: h[1] - h[0], default=None)
        names.append(inner[2] if inner else "host (no traced op)")
    return names


class Summary:
    """What one traced stretch shows, in seconds."""

    def __init__(self, events: list, driver, cfg: dict, mix: dict, device: str,
                 power_w) -> None:
        self.cfg, self.mix, self.device, self.power_w = cfg, mix, device, power_w
        self.counts = dict(driver.stretch)
        self.layer = driver.layer_stats() if hasattr(driver, "layer_stats") else {}
        stretch = [e for e in events if e.get("name") == STRETCH
                   and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        if not stretch:
            raise RuntimeError("the trace holds no stretch span")
        t0 = float(stretch[0]["ts"])
        t1 = t0 + float(stretch[0]["dur"])
        self.window_s = (t1 - t0) * 1e-6
        self.kernels: dict[str, dict] = {}
        spans = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            spans.append((a, b))
            row = self.kernels.setdefault(e["name"], {"calls": 0, "s": 0.0})
            row["calls"] += 1
            row["s"] += (b - a) * 1e-6
        busy = union(spans)
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                      and e.get("name") != STRETCH)
        self.gaps: dict[str, float] = {}
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        names = host_names([(a + b) / 2 for a, b in gaps], host)
        for (a, b), name in zip(gaps, names):
            self.gaps[name] = self.gaps.get(name, 0.0) + (b - a) * 1e-6

    @property
    def peaks(self):
        """The data-sheet peaks of this card's part (``peaks.json``), or None
        for a device the table does not hold."""
        table = json.loads((HERE / "peaks.json").read_text())
        return next((v for k, v in table.items() if k in self.device), None)

    def device_s(self, match) -> float:
        """Device seconds of the activities whose names ``match`` accepts."""
        return sum(v["s"] for k, v in self.kernels.items() if match(k))

    def breakdown(self) -> dict:
        ops: dict[str, float] = {}
        for k, v in self.kernels.items():
            ops[short(k)] = ops.get(short(k), 0.0) + v["s"]
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    """Starts and stops the profiler around the stretch, and reads it."""

    def __init__(self, on_card: bool, path: Path = TRACE_FILE) -> None:
        self.on_card = on_card
        self.path = path
        self.started = self.running = False
        self.power_w = None

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """One short profiled region in set-up, so that the stretch does not
        pay the profiler's first start; and the card's power limit."""
        with self._profile():
            torch.zeros(1, device="cuda" if self.on_card else "cpu").add_(1)
            if self.on_card:
                torch.cuda.synchronize()
        if self.on_card:
            self.power_w = power_limit_w()

    def start(self) -> None:
        """Starts the profiler; the stretch opens after the next unit."""
        self.prof = self._profile()
        self.prof.start()
        self.started = self.running = True
        self.units = -1

    def after_unit(self, driver, units: int) -> None:
        """Opens the stretch after the lead-in unit, closes it after
        ``units`` more."""
        if not self.running:
            return
        self.units += 1
        if self.units == 0:
            self.span = torch.profiler.record_function(STRETCH)
            self.span.__enter__()
            driver.start_stretch()
        elif self.units >= units:
            self.stop(driver)

    def stop(self, driver) -> None:
        if self.on_card:
            torch.cuda.synchronize()
        if self.units >= 0:
            self.span.__exit__(None, None, None)
            driver.stop_stretch()
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        self.running = False

    def summary(self, driver, cfg: dict, mix: dict) -> Summary:
        events = json.loads(self.path.read_text())["traceEvents"]
        device = torch.cuda.get_device_name() if self.on_card else "cpu"
        return Summary(events, driver, cfg, mix, device, self.power_w)
