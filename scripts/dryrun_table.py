"""Prints the dry run's JSON files (``python -m repro_torch.launch.dryrun``)
as one markdown table: a row an arch, a column a shape, each entry the
cell on the (16, 16) and the (2, 16, 16) production meshes ("single /
multi"): a rank's peak GB, whether it fits in 80 GB, the dominant
roofline term, the compute (c), memory (m) and collective (x) seconds,
and the counted FLOPs of all ranks over the analytic model's (x N). A
cell whose JSON says ``error`` prints its error; "-" marks a cell the
arch does not have.

    python scripts/dryrun_table.py [DIR]   # default artifacts/dryrun_torch
"""

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")


def _g(x: float) -> str:
    return f"{x:.3g}"


def _entry(by_mesh: dict) -> str:
    rs = [by_mesh.get(m) for m in MESHES]
    if any(r is None for r in rs):
        return "missing"
    bad = [r for r in rs if r.get("status") != "ok"]
    if bad:
        return f"error: {bad[0].get('error', '?')[:80]}"
    peak = "/".join(f"{r['memory_analysis']['peak_bytes'] / 1e9:.1f}" for r in rs)
    fits = "/".join("fits" if r["memory_analysis"]["fits"] else "no" for r in rs)
    dom = "/".join(sorted({r["roofline"]["dominant"] for r in rs}))
    secs = ", ".join(f"{k} " + "/".join(_g(r["roofline"][f"{term}_s"]) for r in rs)
                     for k, term in (("c", "compute"), ("m", "memory"), ("x", "collective")))
    ratio = "/".join(f"{r['analytic']['counted_over_analytic']:.1f}" for r in rs)
    return f"{peak} GB, {fits}; {dom}; {secs} s; x {ratio}"


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun_torch")
    cells: dict[str, dict[str, dict]] = {}
    for path in sorted(root.glob("*__*__*.json")):
        arch, shape, mesh = path.stem.split("__")
        cells.setdefault(arch, {}).setdefault(shape, {})[mesh] = json.loads(path.read_text())
    print("| Arch | " + " | ".join(SHAPES) + " |")
    print("|---" * (len(SHAPES) + 1) + "|")
    for arch, shapes in cells.items():
        row = [_entry(shapes[s]) if s in shapes else "-" for s in SHAPES]
        print(f"| `{arch}` | " + " | ".join(row) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
