#!/usr/bin/env python3
"""Where a block of K7 (``csrc/wkv6.cu``) spends its time, on one NVIDIA GPU.

    python3 scripts/k7_phase_probe.py

Builds an instrumented copy of the K7 source: thread 0 of every block of
the two chunk passes (``wkv6_chunk_state``, ``wkv6_chunk_output``) reads
the card's ``%globaltimer`` at the start, after each ``__syncthreads()``
of the kernel body and at the end. Runs one call at (1, 512, 40, 64) and
one at (8, 4096, 40, 64) (chunk 64, after two warm-up calls each), and
prints per pass the median and largest time of each phase between two
barriers, the median block time, and the span from the first block's start
to the last block's end, in microseconds. The instrumented copy is built
under its own name; the kernel the port launches is not touched.
"""

from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_BLOCKS = 8192
PASSES = {"wkv6_chunk_state": 0, "wkv6_chunk_output": 1}


def instrument(src: str) -> str:
    """The K7 source with a timestamp after each barrier of the chunk passes."""
    header = f"""
__device__ unsigned long long k7_probe_t[2][{MAX_BLOCKS}][16];
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
    src = src.replace('#include "stencil_common.cuh"', '#include "stencil_common.cuh"' + header, 1)
    for name, pas in PASSES.items():
        start = src.index(f"\n{name}(")
        body = src.index("{\n", start) + 2
        end = src.index("\n}\n", body)
        text = src[body:end]
        count = iter(range(1, 16))
        text = re.sub(r"^(  __syncthreads\(\);\n)",
                      lambda m: m.group(1) + f"  k7_stamp({pas}, {next(count)});\n", text,
                      flags=re.M)
        n = next(count)
        text = f"  k7_stamp({pas}, 0);\n" + text + f"\n  __syncthreads();\n  k7_stamp({pas}, {n});"
        src = src[:body] + text + src[end:]
    return src


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k7_phase_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import kernel as k7

    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    lib = _build.load("wkv6_probe", instrument(k7.SOURCE.read_text()))
    lib.wkv6_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.k7_probe_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    for shape in ((1, 512, 40, 64), (8, 4096, 40, 64)):
        g = torch.Generator(device=dev).manual_seed(0)
        b, t, h, n = shape
        r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        w = 0.6 + 0.399 * torch.rand(shape, generator=g, device=dev)
        u, s0 = torch.randn((h, n), device=dev), torch.zeros((b, h, n, n), device=dev)
        y, s_out = torch.empty_like(r), torch.empty_like(s0)
        kv = torch.empty((b, h, t // 64, n, n), device=dev)
        decay = torch.empty((b, h, t // 64, n), device=dev)
        for _ in range(3):
            code = lib.wkv6_f32(*(x.data_ptr() for x in (r, k, v, w, u, s0, y, s_out, kv, decay)),
                                b, t, h, n, 64, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"launch failed: {torch.cuda.CudaError(code)}")
        torch.cuda.synchronize()
        stamps = np.zeros((2, MAX_BLOCKS, 16), np.uint64)
        if lib.k7_probe_read(stamps.ctypes.data):
            raise RuntimeError("could not read the timestamps")
        blocks = min(MAX_BLOCKS, (t // 64) * h * b)
        for name, pas in PASSES.items():
            ts = stamps[pas, :blocks].astype(np.int64)
            used = int((ts[0] > 0).sum())
            ts = ts[:, :used]
            phases = np.diff(ts, axis=1) / 1e3
            print(json.dumps({
                "nvidia_smi": smi, "shape": list(shape), "pass": name, "blocks": blocks,
                "phase_us_median": np.median(phases, axis=0).round(2).tolist(),
                "phase_us_max": phases.max(axis=0).round(2).tolist(),
                "block_us_median": float(np.median(ts[:, -1] - ts[:, 0]) / 1e3),
                "span_us": float((ts[:, -1].max() - ts[:, 0].min()) / 1e3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
