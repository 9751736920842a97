"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``src/repro_torch`` and ``BENCHMARK.json``,
on a machine with as many CUDA cards as the cell asks for. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``, each number the check compared beside its limit, which also
make the last lines of standard error. Without a card, in a directory that
lacks the port, or with JAX or the JAX package loaded once the window has
closed, it exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    del sys.path[0]  # run as a script: its modules are imported as portbench.*
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The program's and its libraries' caches, at fixed paths in the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def process_age() -> float:
    """Seconds since this process began (the kernel's start time, at the
    clock tick), or since this module was first read where that is not
    available."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        now = time.clock_gettime(time.CLOCK_BOOTTIME)
        return now - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def number(x):
    """A value for the JSON line: a non-finite number has no JSON form."""
    return x if not isinstance(x, float) or math.isfinite(x) else None


def result_line(cell: dict, out: dict, trace: bool, kind: str) -> dict:
    """The run's last line from :func:`portbench.harness.run_cell`'s output,
    its keys in the order the driver reads them, ``compared`` last."""
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    values = out["per_layer"] if trace else out["end_to_end"]
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": {k: {"value": number(v), "unit": units[k]} for k, v in values.items()},
              "device": device}
    if trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_trace_s"],
                      power_limit_w=out["power_limit_w"])
        result["breakdown"] = out["breakdown"]
    result["compared"] = {k: {"value": number(c["value"]), "limit": c["limit"]}
                          for k, c in out["compared"].items()}
    return result


def fail(code: int, msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir() or not (ROOT / "BENCHMARK.json").is_file():
        fail(2, f"{ROOT} holds no src/repro_torch or no BENCHMARK.json")
    for key in ("REPRO_METRICS", "REPRO_EVENT_LOG"):
        os.environ.pop(key, None)  # the registry would synchronise every call
    for key, sub in CACHES.items():
        os.environ[key] = str(ROOT / "build" / "portbench" / sub)
    sys.path[:0] = [str(src), str(ROOT)]

    import torch

    from portbench.harness import load_cell, run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(3, f"{args.workload} needs {cell['chips']} CUDA card(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(src.resolve()):
        fail(2, f"repro_torch came from {repro_torch.__file__}, not {src}")
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                   setup_clock=process_age)
    bad = forbidden_modules()
    if bad:
        fail(4, f"modules of JAX or the JAX package are loaded: {bad}")

    result = result_line(cell, out, bool(args.trace), torch.cuda.get_device_name(0))
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
