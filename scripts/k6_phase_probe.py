#!/usr/bin/env python3
"""Where a block of K6 (``csrc/rglru.cu``) spends its time, on one NVIDIA GPU.

    python3 scripts/k6_phase_probe.py [--src DIR] [--label NAME] [--no-check]

Builds an instrumented copy of the K6 source (``--src``: another tree's
``src/``, as in ``scripts/kernel_bench.py``): thread 0 of every block, the
first chain lane, reads the card's ``%globaltimer`` when the block starts,
at the top of each stage's iteration (the chain has finished the stage
before), right after that iteration's barrier (every copy of the stage has
landed) and when the block ends. Runs one call at (1, 512, 2560) and one at
(8, 4096, 2560), float32 (after two warm-up calls each), and prints the
median over blocks of: the time from the block's start to its first stage
(the ring's fill), the wait at each stage's barrier, the chain's time per
stage and per step, and the block's time; plus the span from the first
block's start to the last block's end, in microseconds. The instrumented
copy is built under its own name; the kernel the port launches is not
touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

MAX_BLOCKS = 1024
MAX_STAMPS = 2 + 2 * 64  # start, end, and two per stage for up to 64 stages


def instrument(src: str) -> str:
    """The K6 source with timestamps around each stage's barrier."""
    header = f"""
__device__ unsigned long long k6_probe_t[{MAX_BLOCKS}][{MAX_STAMPS}];
__device__ __forceinline__ void k6_stamp(int k) {{
  if (threadIdx.x == 0 && k < {MAX_STAMPS}) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int blk = blockIdx.x + gridDim.x * blockIdx.y;
    if (blk < {MAX_BLOCKS}) k6_probe_t[blk][k] = t;
  }}
}}
extern "C" int k6_probe_read(void* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, k6_probe_t, sizeof(k6_probe_t)));
}}
"""
    loop = "  for (int s = 0; s < nstage; ++s) {\n"
    barrier = "    __syncthreads();"
    for marker in ('#include "stencil_common.cuh"', "  extern __shared__", loop, barrier,
                   "  if (lane) h_last"):
        if src.count(marker) != 1:
            raise RuntimeError(f"k6_phase_probe: the K6 source has {src.count(marker)} "
                               f"copies of {marker!r}; the probe expects one")
    src = src.replace('#include "stencil_common.cuh"', '#include "stencil_common.cuh"' + header)
    src = src.replace("  extern __shared__", "  k6_stamp(0);\n  extern __shared__")
    src = src.replace(loop, loop + "    k6_stamp(2 + 2 * s);\n")
    src = src.replace(barrier, barrier + "\n    k6_stamp(3 + 2 * s);")
    src = src.replace("  if (lane) h_last", "  k6_stamp(1);\n  if (lane) h_last")
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the parity check (for a deliberately altered source)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k6_phase_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import kernel as k6
    from repro_torch.kernels.rglru import rglru_seq_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    lib = _build.load("rglru_probe", instrument(k6.SOURCE.read_text()))
    lib.rglru_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.rglru_f32.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2024)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in ((1, 512, 2560), (8, 4096, 2560)):
        batch, steps, width = shape
        a = 0.5 + 0.499 * torch.rand(shape, generator=gen, device=dev)
        b = torch.randn(shape, generator=gen, device=dev)
        h0 = torch.randn((batch, width), generator=gen, device=dev)
        h = torch.empty(shape, device=dev)
        last = torch.empty((batch, width), device=dev)
        plan = k6.plan_scan(batch, steps, width, 4, sms, vec=True)
        for _ in range(3):
            code = lib.rglru_f32(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                                 last.data_ptr(), batch, steps, width, plan.tile,
                                 plan.stage_steps, 1, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"instrumented K6 launch failed: {code}")
        torch.cuda.synchronize()
        want = rglru_seq_ref(a, b, h0)
        if not args.no_check and not (torch.equal(h, want[0]) and torch.equal(last, want[1])):
            raise RuntimeError(f"instrumented K6 {shape}: not bit-equal to rglru_seq_ref")
        stamps = (ctypes.c_ulonglong * (MAX_BLOCKS * MAX_STAMPS))()
        if lib.k6_probe_read(stamps):
            raise RuntimeError("k6_phase_probe: reading the timestamps failed")
        nstage = -(-steps // plan.stage_steps)
        blocks = min(plan.blocks, MAX_BLOCKS)
        rows = [stamps[i * MAX_STAMPS:(i + 1) * MAX_STAMPS] for i in range(blocks)]
        us = 1e-3
        med = statistics.median
        fill = [(r[3] - r[0]) * us for r in rows]
        waits = [(r[3 + 2 * s] - r[2 + 2 * s]) * us for r in rows for s in range(1, nstage)]
        chains = [(r[4 + 2 * s] - r[3 + 2 * s]) * us for r in rows for s in range(nstage - 1)]
        chains += [(r[1] - r[3 + 2 * (nstage - 1)]) * us for r in rows]
        total = [(r[1] - r[0]) * us for r in rows]
        print(json.dumps({
            "label": args.label, "nvidia_smi": smi, "shape": "x".join(map(str, shape)),
            "tile": plan.tile, "stage_steps": plan.stage_steps, "stages": nstage,
            "blocks": plan.blocks, "blocks_probed": blocks,
            "fill_us": med(fill), "barrier_wait_us": med(waits), "max_barrier_wait_us": max(waits),
            "chain_us_per_stage": med(chains),
            "chain_ns_per_step": med(chains) * 1e3 / plan.stage_steps,
            "block_us": med(total), "max_block_us": max(total),
            "span_us": (max(r[1] for r in rows) - min(r[0] for r in rows)) * us,
        }), flush=True)
        del a, b, h0, h, last, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
