#!/usr/bin/env python3
"""Where a block of K7 (``csrc/wkv6.cu``) and of its backward
(``csrc/wkv6_bwd.cu``) spends its time, on one NVIDIA GPU.

    python3 scripts/k7_phase_probe.py [--only k7,k7bwd] [--src DIR] [--label NAME]

Builds an instrumented copy of each source: thread 0 of every block of the
chunk passes (K7's ``wkv6_chunk_state`` and ``wkv6_chunk_output``, the
backward's ``wkv6_bwd_chunk`` and ``wkv6_bwd_grad``) reads the card's
``%globaltimer`` at the start, after each ``__syncthreads()`` of the kernel
body (those at the body's own indentation) and at the end; the scan passes
(``wkv6_state_scan``, ``wkv6_bwd_scan``) stamp their start and end only.
K7 runs at (1, 512, 40, 64) and (8, 4096, 40, 64), the backward at the
trainer's (4, 256, 40, 64) and at (1, 512, 40, 64), chunk 64, each after
two warm-up calls. Prints per pass the median and largest time of each
phase between two stamps, the median block time, and the span from the
first block's start to the last block's end, in microseconds. The
instrumented copies are built under their own names; the kernels the port
launches are not touched. ``--src`` names the ``src/`` directory whose
sources and wrappers are probed (default: this checkout's).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_BLOCKS = 8192
MAX_STAMPS = 16
# Pass name -> its row of the timestamp table; the scan passes stamp only
# their start and end.
FWD_PASSES = {"wkv6_chunk_state": 0, "wkv6_chunk_output": 1}
BWD_PASSES = {"wkv6_bwd_chunk": 2, "wkv6_bwd_scan": 3, "wkv6_bwd_grad": 4}
SCAN_PASSES = {"wkv6_state_scan": 5, "wkv6_bwd_scan": 3}


def instrument(src: str, passes: dict[str, int], scans: dict[str, int]) -> str:
    """``src`` with a timestamp after each top-level barrier of the named
    chunk passes, and at the start and end of the named scan passes."""
    header = f"""
__device__ unsigned long long k7_probe_t[6][{MAX_BLOCKS}][{MAX_STAMPS}];
__device__ __forceinline__ void k7_stamp(int pass, int k) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (blk < {MAX_BLOCKS}) k7_probe_t[pass][blk][k] = t;
  }}
}}
extern "C" int k7_probe_read(void* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, k7_probe_t, sizeof(k7_probe_t)));
}}
"""
    anchor = re.search(r'#include "[\w.]+\.cuh"\n', src)
    src = src[:anchor.end()] + header + src[anchor.end():]
    for name, pas in {**passes, **scans}.items():
        match = re.search(rf"\n{name}\(", src)
        if match is None:
            continue
        body = src.index("{\n", match.start()) + 2
        end = src.index("\n}\n", body)
        text = src[body:end]
        if name in scans:
            text = f"  k7_stamp({pas}, 0);\n" + text + f"\n  k7_stamp({pas}, 1);"
        else:
            count = iter(range(1, MAX_STAMPS))
            text = re.sub(r"^(  __syncthreads\(\);[^\n]*\n)",
                          lambda m: m.group(1) + f"  k7_stamp({pas}, {next(count)});\n", text,
                          flags=re.M)
            text = (f"  k7_stamp({pas}, 0);\n" + text +
                    f"\n  __syncthreads();\n  k7_stamp({pas}, {next(count)});")
        src = src[:body] + text + src[end:]
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="k7,k7bwd")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    only = set(args.only.split(","))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k7_phase_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import kernel as k7

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def inputs(shape, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        b, _, h, n = shape
        r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        w = 0.6 + 0.399 * torch.rand(shape, generator=g, device=dev)
        return r, k, v, w, torch.randn((h, n), device=dev), 0.1 * torch.randn((b, h, n, n), device=dev)

    def report(lib, shape, passes, label):
        torch.cuda.synchronize()
        stamps = np.zeros((6, MAX_BLOCKS, MAX_STAMPS), np.uint64)
        if lib.k7_probe_read(stamps.ctypes.data):
            raise RuntimeError("could not read the timestamps")
        b, t, h, n = shape
        for name, pas in passes.items():
            blocks = min(MAX_BLOCKS, (b * h * n * n + 255) // 256 if name in SCAN_PASSES
                         else (t // 64) * h * b)
            ts = stamps[pas, :blocks].astype(np.int64)
            used = int((ts[0] > 0).sum())
            ts = ts[:, :used]
            phases = np.diff(ts, axis=1) / 1e3
            print(json.dumps({
                "label": label, "nvidia_smi": smi, "shape": list(shape), "pass": name,
                "blocks": blocks, "phase_us_median": np.median(phases, axis=0).round(2).tolist(),
                "phase_us_max": phases.max(axis=0).round(2).tolist(),
                "block_us_median": float(np.median(ts[:, -1] - ts[:, 0]) / 1e3),
                "span_us": float((ts[:, -1].max() - ts[:, 0].min()) / 1e3)}), flush=True)

    if "k7" in only:
        passes = {**FWD_PASSES, "wkv6_state_scan": SCAN_PASSES["wkv6_state_scan"]}
        lib = _build.load("wkv6_probe", instrument(
            k7.SOURCE.read_text(), FWD_PASSES, {"wkv6_state_scan": SCAN_PASSES["wkv6_state_scan"]}))
        lib.wkv6_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.k7_probe_read.argtypes = [ctypes.c_void_p]
        for shape in ((1, 512, 40, 64), (8, 4096, 40, 64)):
            b, t, h, n = shape
            r, k, v, w, u, s0 = inputs(shape)
            y, s_out = torch.empty_like(r), torch.empty_like(s0)
            kv = torch.empty((b, h, t // 64, n, n), device=dev)
            decay = torch.empty((b, h, t // 64, n), device=dev)
            for _ in range(3):
                code = lib.wkv6_f32(*(x.data_ptr() for x in (r, k, v, w, u, s0, y, s_out, kv,
                                                             decay)), b, t, h, n, 64, stream)
                if code:
                    raise RuntimeError(f"launch failed: {torch.cuda.CudaError(code)}")
            report(lib, shape, passes, args.label)

    if "k7bwd" in only and hasattr(k7, "BWD_SOURCE"):
        lib = _build.load("wkv6_bwd_probe", instrument(
            k7.BWD_SOURCE.read_text(), {p: i for p, i in BWD_PASSES.items() if p != "wkv6_bwd_scan"},
            {"wkv6_bwd_scan": BWD_PASSES["wkv6_bwd_scan"]}))
        lib.wkv6_bwd_f32.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.k7_probe_read.argtypes = [ctypes.c_void_p]
        for shape in ((4, 256, 40, 64), (1, 512, 40, 64)):
            b, t, h, n = shape
            nch = t // 64
            r, k, v, w, u, s0 = inputs(shape)
            dy, ds_t = torch.randn_like(r), torch.randn_like(s0)
            grads = [torch.empty_like(r) for _ in range(4)]
            ds0 = torch.empty_like(s0)
            kv = torch.empty((b, h, nch, n, n), device=dev)
            rdy = torch.empty_like(kv)
            decay = torch.empty((b, h, nch, n), device=dev)
            dupart = torch.empty((b, nch, h, n), device=dev)
            for _ in range(3):
                code = lib.wkv6_bwd_f32(
                    *(x.data_ptr() for x in (r, k, v, w, u, s0, dy, ds_t, *grads, dupart, ds0, kv,
                                             rdy, decay)), b, t, h, n, 64, stream)
                if code:
                    raise RuntimeError(f"launch failed: {torch.cuda.CudaError(code)}")
            report(lib, shape, BWD_PASSES, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
