"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one cell is found by name. ``BENCHMARK.json``
names the cell's configuration (a file of sizes under ``configs/``) and its
traffic mix (``traffic/<mix>.json``, whose ``driver`` names the general
generator under ``drivers/`` that reads it); each per-layer metric is read by
``metrics/<name>.py``, each kernel's work is reckoned by ``work/<kernel>.py``.

The window runs whole units of the driver until ``seconds`` have passed, and
its length is read when the last unit has finished. The window's first unit
and ``check_units`` more, at moments drawn from the seed, are held for the
check, which runs after the window has closed, the peak memory has been read
and the program's other state is dropped. A traced run profiles a stretch of
``trace_units`` units starting at a quarter of the window.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_AT = 0.25


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration, its
    traffic mix and the metrics it reports, all read from their files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "chips": cell["chips"], "config": cfg, "traffic": mix,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def make_driver(cfg: dict, mix: dict, seed: int, device):
    """The traffic's generator, ``drivers/<driver>.py``, over the config."""
    mod = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    return mod.DRIVER(cfg, mix, seed, device)


def run_window(driver, seconds: float, tracer=None) -> float:
    """Runs whole units until ``seconds`` have passed; returns the window's
    length. Each unit ends synchronised. A traced run starts the profiler at
    a unit boundary past ``TRACE_AT`` of the window, lets one unit run under
    it before the stretch opens (the profiler's own start-up stays outside),
    and closes the stretch after ``trace_units`` units."""
    draws = sorted(driver.rng.random() for _ in range(driver.mix["check_units"]))
    t0 = time.perf_counter()
    first = True
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        keep = first
        while draws and draws[0] * seconds <= elapsed:
            draws.pop(0)
            keep = True
        first = False
        if tracer is not None and not tracer.started and elapsed >= TRACE_AT * seconds:
            tracer.start()
        driver.unit(keep)
        if tracer is not None:
            tracer.after_unit(driver, driver.mix["trace_units"])
    window = time.perf_counter() - t0
    if tracer is not None and tracer.running:
        tracer.stop(driver)
    return window


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             setup_clock=None, driver_hook=None) -> dict:
    """One run. ``setup_clock()`` gives the seconds since the process began
    (``setup_s`` is read from it when the window opens); ``driver_hook``
    lets the control and the fault runs replace the port's calls."""
    cfg, mix = cell["config"], cell["traffic"]
    driver = make_driver(cfg, mix, seed, device)
    if driver_hook is not None:
        driver_hook(driver)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    tracer = None
    if trace:
        from portbench.tracing import Tracer

        tracer = Tracer(on_card)
        tracer.warm()
    setup_s = setup_clock() if setup_clock is not None else None
    window_s = run_window(driver, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e2e = driver.end_to_end(window_s)
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check()
    limits = mix["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    # Work that failed in the window is never correct, held for the check or not.
    compared["failed"] = {"value": driver.failed, "limit": 0}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values()) and set(checks) == set(limits)
    out = {"correct": correct, "attempted": driver.attempted, "failed": driver.failed,
           "window_s": window_s, "setup_s": setup_s, "memory_peak_bytes": peak,
           "compared": compared}
    if trace:
        summary = tracer.summary(driver, cfg, mix)
        out["per_layer"] = read_layers(cell, summary)
        out["busy_s"], out["window_trace_s"] = summary.busy_s, summary.window_s
        out["breakdown"] = summary.breakdown()
        out["power_limit_w"] = tracer.power_w
    else:
        e2e["setup_s"] = setup_s
        out["end_to_end"] = {m["name"]: e2e[m["name"]] for m in cell["end_to_end"]}
    return out


def read_layers(cell: dict, summary) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that finds
    nothing returns None, the metric is left out and standard error names
    it."""
    values = {}
    for m in cell["per_layer"]:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(summary)
        if value is None:
            print(f"portbench: {m['name']} found nothing to read in the traced stretch",
                  file=sys.stderr)
        else:
            values[m["name"]] = value
    return values
