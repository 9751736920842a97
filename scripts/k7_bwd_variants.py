#!/usr/bin/env python3
"""Design choices of K7's backward (``csrc/wkv6_bwd.cu``), each against the
kernel as built, on one NVIDIA GPU.

    python3 scripts/k7_bwd_variants.py [--seeds 10] [--reps 3]

Builds copies of the backward's source, each changed by text substitution
and built under its own name (the kernel the port launches is not
touched), and launches each through the wrapper's ``_launch_bwd``:

* ``as_built``: the source as it is; ``as_built_copy``: the same code under
  another name, a control for differences between two loaded libraries;
* ``p_tf32``: P = dy v^T, tril(P)^T r~ and tril(P) k~ in 3xTF32 on the
  tensor cores instead of FP32 on the CUDA cores;
* ``one_block``: the gradient pass asks for 36 KB more shared memory, so
  one block takes an SM where two share one;
* ``pdl``: the scan and the gradient pass launched as programmatic
  dependents of the launch before them, the gradient pass waiting for the
  scan only before it reads the entering states.

A variant whose text the source no longer has raises. For each it prints
the worst error of every gradient against ``wkv6_backward_plain``, as a
multiple of its tolerance ``1e-5 max|g| + 1e-6``, over ``--seeds`` inputs
at strong decay (w drawn from [0.05, 0.999], (2, 128, 3, 64), chunk 64),
and dw's per seed; the largest distance of dw from the same gradient in
float64 (the plain version's code in float64) for the variant and for the
plain version; and the median warm (CUDA-graph replays) and cold (L2
evicted) µs of a call at (4, 256, 40, 64) and (1, 512, 40, 64) over
``--reps`` rounds that run the variants in alternating order. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

P_TF32 = [
    ("""    product_f32(
        acc, [&](int t, int j) { return X3[t * lr + j]; },
        [&](int j, int s) { return make_float2(X2[s * lr + j], X2[(s + 1) * lr + j]); }, am0, an0,
        anq, 0, np);""",
     """    product(
        acc, [&](int t, int j) { return X3[t * lr + j]; },
        [&](int j, int s) { return X2[s * lr + j]; }, am0, an0, anq, 0, np);"""),
    ("""    product_f32(
        dka, [&](int s, int t) { return X5[t * lt + s]; },
        [&](int t, int i) { return *reinterpret_cast<const float2*>(X0 + t * lv + i); }, m0, n0,
        nq, m0, cp);""",
     """    product(
        dka, [&](int s, int t) { return X5[t * lt + s]; },
        [&](int t, int i) { return X0[t * lv + i]; }, m0, n0, nq, m0, cp);"""),
    ("""    product_f32(
        dra, [&](int t, int s) { return X5[t * lt + s]; },
        [&](int s, int i) { return *reinterpret_cast<const float2*>(X1 + s * lr + i); }, m0, n0,
        nq, 0, min(cp, m0 + 16));""",
     """    product(
        dra, [&](int t, int s) { return X5[t * lt + s]; },
        [&](int s, int i) { return X1[s * lr + i]; }, m0, n0, nq, 0, min(cp, m0 + 16));"""),
]
ONE_BLOCK = [("int grad_floats() const { return 6 * region() + kThreads + 2 * cp + 3 * np; }",
              "int grad_floats() const { return 6 * region() + kThreads + 2 * cp + 3 * np + 9216; }")]
PDL = [
    ("  const int warp = threadIdx.x >> 5;\n",
     "  allow_dependents();\n  const int warp = threadIdx.x >> 5;\n"),
    ("  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;\n",
     "  allow_dependents();\n  wait_for_prerequisite();\n"
     "  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;\n"),
    ("  load_block(X2, lr, states + bhc * nn",
     "  wait_for_prerequisite();\n  load_block(X2, lr, states + bhc * nn"),
    ("  wkv6_bwd_scan<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0, st>>>(",
     "  err = launch_dependent(wkv6_bwd_scan,\n"
     "                         dim3(static_cast<unsigned>((elems + kThreads - 1) / kThreads)), 0, st,"),
    ("  wkv6_bwd_grad<<<grid, kThreads, smem_grad, st>>>(",
     "  err = launch_dependent(wkv6_bwd_grad, grid, smem_grad, st,"),
    ("t, heads, n, chunk, vec, pairs);\n  return static_cast<int>(cudaGetLastError());",
     "t, heads, n, chunk, vec, pairs);\n  return err;"),
]
VARIANTS = {"as_built": [], "as_built_copy": [], "p_tf32": P_TF32, "one_block": ONE_BLOCK,
            "pdl": PDL}


def variant(text: str, name: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has the text this variant changes")
        text = text.replace(old, new)
    return text + ("\n// copy\n" if name == "as_built_copy" else "")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k7_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import cold_ms, graph_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import kernel as k7
    from repro_torch.kernels.wkv6 import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    base = k7.BWD_SOURCE.read_text()
    sources = {name: (f"wkv6_bwd_{name}", variant(base, name, edits))
               for name, edits in VARIANTS.items()}
    _build.build(list(sources.values()))
    libs = {}
    for name, (lib_name, text) in sources.items():
        lib = ctypes.CDLL(str(_build.library_path(lib_name, text)))
        lib.wkv6_bwd_f32.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.wkv6_bwd_f32.restype = ctypes.c_int
        libs[name] = lib
    # The plain version's code in float64, for the distance of each from the exact gradient.
    ns = dict(vars(ref))
    exec(inspect.getsource(ref.wkv6_backward_plain).replace("torch.float32", "torch.float64"), ns)
    plain64 = ns["wkv6_backward_plain"]
    dev = torch.device("cuda")

    def call(lib, r, k, v, w, u, s0, dy, ds):
        grads = [torch.empty_like(r) for _ in range(4)]
        ds0 = torch.empty_like(s0)
        du = k7._launch_bwd(lib, r, k, v, w, u, s0, dy, ds, *grads, ds0, 64)
        return (*grads, du, ds0)

    def inputs(shape, seed, w_lo):
        b, _, h, n = shape
        g = torch.Generator(device=dev).manual_seed(seed)

        def randn(*s):
            return torch.randn(s, generator=g, device=dev)

        w = w_lo + (0.999 - w_lo) * torch.rand(shape, generator=g, device=dev)
        return (0.5 * randn(*shape), 0.5 * randn(*shape), randn(*shape), w, 0.3 * randn(h, n),
                0.1 * randn(b, h, n, n), randn(*shape), randn(b, h, n, n))

    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    cases = [inputs((2, 128, 3, 64), 20 + seed, 0.05) for seed in range(args.seeds)]
    plains = [ref.wkv6_backward_plain(*xs, chunk=64) for xs in cases]
    exact = [plain64(*(x.double() for x in xs), chunk=64) for xs in cases]
    plain_dw64 = max((p[3].double() - e[3]).abs().max().item() for p, e in zip(plains, exact))
    for name, lib in libs.items():
        worst, dw_seeds, dw64 = {}, [], 0.0
        for xs, plain, ex in zip(cases, plains, exact):
            got = call(lib, *xs)
            for gname, x, y in zip(names, got, plain):
                ratio = (x - y).abs().max().item() / (1e-5 * y.abs().max().item() + 1e-6)
                worst[gname] = max(worst.get(gname, 0.0), ratio)
            dw_seeds.append(round((got[3] - plain[3]).abs().max().item()
                                  / (1e-5 * plain[3].abs().max().item() + 1e-6), 3))
            dw64 = max(dw64, (got[3].double() - ex[3]).abs().max().item())
        print(json.dumps({"nvidia_smi": smi, "variant": name, "strong_decay_err_over_tol": worst,
                          "dw_err_over_tol_by_seed": dw_seeds, "dw_from_float64": dw64,
                          "plain_dw_from_float64": plain_dw64}), flush=True)
    del cases, plains, exact
    for shape in ((4, 256, 40, 64), (1, 512, 40, 64)):
        xs = inputs(shape, 1, 0.6)
        times = {name: ([], []) for name in libs}
        order = list(libs)
        for rep in range(args.reps):
            for name in order if rep % 2 == 0 else order[::-1]:
                fn = lambda: call(libs[name], *xs)  # noqa: E731
                times[name][0].append(graph_ms(fn) * 1e3)
                times[name][1].append(cold_ms(fn) * 1e3)
        for name, (warm, cold) in times.items():
            print(json.dumps({"nvidia_smi": smi, "variant": name, "shape": list(shape),
                              "warm_us": statistics.median(warm), "cold_us": statistics.median(cold),
                              "warm_samples": [round(x, 1) for x in warm],
                              "cold_samples": [round(x, 1) for x in cold]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
