#!/usr/bin/env python3
"""Times the port's K7 (``wkv6_cuda``) and its backward (``wkv6_bwd_cuda``),
K2 (``stencil_program_cuda``), K6
(``rglru_scan_cuda``), K3 (``hdiff_fixed_cuda``), K1 (``hdiff_cuda``), K4
(``stencil2d_cuda``) and K5' (``stencil_program_1d_cuda``) on one NVIDIA
GPU, for a source tree given on the command line.

    python3 scripts/kernel_bench.py [--src DIR] [--label NAME]
                                    [--only k7,k7bwd,k2,k6,k3,k1,k4,k5p,k2adj]
                                    [--ptxas] [--profile] [--sass DIR] [--no-check] [--cold]

``--src`` names the ``src/`` directory whose ``repro_torch`` is imported
(default: this checkout's), so two versions of the kernels can be timed in
one process tree on one card, in turns. Each case is first checked against
its plain version (K7 within ``1e-5 * max|y| + 1e-6``, K2 bit for bit), then
timed as ``chip_smoke.py`` times it: the median of 25 replays (10 at the
large shapes) of a CUDA graph of 10 launches, after a warm-up. Cases: K7 at
(1, 512, 40, 64) and (8, 4096, 40, 64) with chunk 64 (K7 also checked as a
replayed CUDA graph); ``k7bwd``: K7's backward at (1, 512, 40, 64) and the
trainer's (4, 256, 40, 64), chunk 64, with non-zero state and state
cotangent, each gradient within ``1e-5 * max|g| + 1e-6`` of
``wkv6_backward_plain`` (only where the tree has it); K2 hdiff x 2 and
hdiff_coupled at 64x256x256 and 80x1024x1024, float32; K6 at (1, 512, 2560)
and (8, 4096, 2560), float32 and bfloat16, bit for bit against
``rglru_seq_ref`` (also checked as a replayed CUDA graph); K3 at 64x256x256
and 80x1024x1024, bit for bit against ``hdiff_fixed_point_ref`` on int32
values that wrap; K1 at the same two grids, float32 and bfloat16, bit for
bit against ``hdiff_plain`` with the limiter on and off, beside its in-tree
yardstick K2 running ``hdiff`` x 1; K4 at the same grids, float32 and
bfloat16, bit for bit against ``stencil2d_plain`` for every named mask and
a random one, timed on ``jacobi2d_9pt`` beside K2 running the same program
and one ``conv2d`` of the interior (TF32 off, never called by the port);
K5' on ``jacobi1d`` and ``hdiff1d`` x 1, 2 and 3 at (16384, 256)
and (81920, 1024), float32 and bfloat16, bit for bit against
``stencil_program_1d_plain``, beside its yardsticks K5 (``jacobi1d_cuda``)
and, in float32, one ``conv1d`` of the interior with jacobi1d's composed
filter (``hdiff1d`` only where the tree's generator has it); ``k2adj``:
K2 on the gradient path's N-output programs, ``hdiff_coupled``'s augmented
forward (6 outputs) and adjoint (2 outputs), at the grids ``make_vjp`` runs
them on, 64x260x260 and 80x1028x1028 (padded by 2), float32, bit for bit,
each row with its tile and frame count (only where the tree has
``ir.adjoint``).
``--only`` picks kernels (default: all nine). ``--ptxas``
also compiles each kernel source once more with ``-Xptxas -v`` and prints
the registers, shared memory and spills it reports; ``--profile`` adds, per
K7 and K7 backward shape, the device time of each of the call's launches from one
``torch.profiler`` window of 5 calls; ``--sass DIR`` writes ``cuobjdump
-sass`` of the K6, K3/K1, K4 and K5' libraries into DIR and prints, for
each loop of each kernel (a backward branch), its instructions by opcode
(the row loops of K3, K1 and K4 are unrolled by 4: a point is a quarter of
one), and for K5' (straight-line code, no loop) the whole kernel's
instructions by opcode and per point.
``--no-check`` skips K1's and K4's checks, to time deliberately altered
copies of them (a probe with part of the kernel removed). ``--cold`` adds,
per K7 and K7 backward shape, the time of one call with L2 evicted before
it (``chip_smoke.py``'s ``cold_ms``).

Prints one JSON line per case, with the card's name and power limit, and
exits non-zero without a card or if a check fails.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def graph_ms(fn, launches=10, replays=25):
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def ptxas(build, name: str, text: str) -> list[str]:
    """``-Xptxas -v`` lines for one source: registers, shared memory, spills."""
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / f"{name}.cu"
        cu.write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC),
               "-o", str(Path(tmp) / f"{name}.so"), str(cu)]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return [line.strip() for line in (out.stdout + out.stderr).splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def sass_loops(text: str) -> list[dict]:
    """The loops of each function in ``cuobjdump -sass`` output: for every
    backward branch, the instructions from its target to it, by opcode."""
    loops, func, lines, labels, pending = [], None, {}, {}, []
    pat = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func, lines, labels, pending = m.group(1), {}, {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = pat.search(line)
        if not m or func is None:
            continue
        addr, op, args = int(m.group(1), 16), m.group(3), m.group(4)
        lines[addr] = op
        labels.update({name: addr for name in pending})
        pending = []
        t = re.search(r"(0x[0-9a-f]+)|\((\.L_x_\d+)\)", args)
        target = None if not t else int(t.group(1), 16) if t.group(1) else labels.get(t.group(2))
        if op.startswith("BRA") and target is not None and target < addr:
            body = [o for a, o in sorted(lines.items()) if target <= a <= addr]
            ops: dict[str, int] = {}
            for o in body:
                ops[o.split(".")[0]] = ops.get(o.split(".")[0], 0) + 1
            loops.append({"function": func, "start": hex(target),
                          "end": hex(addr), "instructions": len(body),
                          "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))})
    return loops


def sass_functions(text: str) -> list[dict]:
    """Every function in ``cuobjdump -sass`` output: its instructions by
    opcode."""
    funcs, func = [], None
    pat = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = {"function": m.group(1), "by_opcode": {}}
            funcs.append(func)
            continue
        m = pat.search(line)
        if m and func is not None:
            op = m.group(2).split(".")[0]
            func["by_opcode"][op] = func["by_opcode"].get(op, 0) + 1
    for func in funcs:
        func["instructions"] = sum(func["by_opcode"].values())
        func["by_opcode"] = dict(sorted(func["by_opcode"].items(), key=lambda kv: -kv[1]))
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--only", default="k7,k7bwd,k2,k6,k3,k1,k4,k5p,k2adj")
    ap.add_argument("--sass", default=None)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--cold", action="store_true")
    args = ap.parse_args()
    only = set(args.only.split(","))

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import cold_ms

    sys.path.insert(0, args.src)
    import repro_torch.ir as ir
    from repro_torch.ir.lower_cuda import kernel_source, tile_for
    from repro_torch.kernels import _build
    from repro_torch.kernels.hdiff import hdiff_fixed_point_ref
    from repro_torch.kernels.hdiff import kernel as k13
    from repro_torch.kernels.stencil2d import kernel as k45
    from repro_torch.kernels.stencil2d import weights_for
    from repro_torch.kernels.rglru import kernel as k6
    from repro_torch.kernels.rglru import rglru_seq_ref
    from repro_torch.kernels.wkv6 import kernel as k7
    from repro_torch.kernels.wkv6 import wkv6_plain
    from repro_torch.kernels.wkv6 import ref as wkv6_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2024)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)

    hdiff2, coupled = ir.repeat(ir.hdiff_program(), 2), ir.hdiff_coupled_program()
    hdiff1, jac9 = ir.hdiff_program(), ir.jacobi2d_9pt_program()
    grids = ((64, 256, 256), (80, 1024, 1024))

    def k2_sources(progs):
        return [kernel_source(p, ("float32",) * len(p.inputs), tile_for(p, *g[1:]))
                for p in progs for g in grids]

    # Built: the picked kernels' sources (K1's and K4's with their K2
    # yardsticks). Shown by --ptxas: one of each (K2's two programs at the
    # paper grid); by --sass: K6's, K3's (K1's) and K4's.
    # K5': jacobi1d x 1-3, and hdiff1d x 1-3 where the tree has it (the
    # first 1-D generator could not compile a limited flux).
    k5p_progs = {f"jacobi1d x{k}": ir.repeat(ir.jacobi1d_program(), k) for k in (1, 2, 3)}
    if hasattr(ir, "hdiff1d_program"):
        k5p_progs.update({f"hdiff1d x{k}": ir.repeat(ir.hdiff1d_program(), k) for k in (1, 2, 3)})
    rows_1d = ((16384, 256), (81920, 1024))
    k5p_sources = {(label, d, shape): kernel_source(p, (d,), tile_for(p, *shape))
                   for label, p in k5p_progs.items() for d in ("float32", "bfloat16")
                   for shape in rows_1d}
    # k2adj: the gradient path's augmented forward and adjoint of hdiff_coupled.
    adj_progs = {} if not hasattr(ir, "adjoint") else {
        "hdiff_coupled.aug": ir.augmented_forward(coupled), "hdiff_coupled.adj": ir.adjoint(coupled)}
    adj_grids = tuple((d, r + 4, c + 4) for d, r, c in grids)
    adj_sources = [kernel_source(p, ("float32",) * len(p.inputs), tile_for(p, *g[1:]))
                   for p in adj_progs.values() for g in adj_grids]
    # k7bwd: K7's backward, where the tree has it.
    bwd_sources = [k7.bwd_source()] if hasattr(k7, "bwd_source") else []
    picked = {"k7": [k7.source()], "k7bwd": bwd_sources,
              "k2": k2_sources((hdiff2, coupled)), "k6": [k6.source()],
              "k3": [k13.source()], "k1": [k13.source(), *k2_sources((hdiff1,))],
              "k4": [k45.source(), *k2_sources((jac9,))],
              "k5p": [k45.source(), *k5p_sources.values()], "k2adj": adj_sources}
    shown = {"k7": [k7.source()], "k7bwd": bwd_sources, "k2": picked["k2"][::2],
             "k6": [k6.source()],
             "k3": [k13.source()], "k1": [k13.source()], "k4": [k45.source()],
             "k5p": [src for (_, _, shape), src in k5p_sources.items() if shape == rows_1d[0]],
             "k2adj": adj_sources[::2]}
    _build.build(list(dict.fromkeys(src for k, srcs in picked.items() if k in only
                                    for src in srcs)))
    emit = {"label": args.label, "src": args.src, "nvidia_smi": smi}
    if args.ptxas:
        for name, text in dict.fromkeys(src for k, srcs in shown.items() if k in only
                                        for src in srcs):
            print(json.dumps({**emit, "ptxas": name, "lines": ptxas(_build, name, text)}),
                  flush=True)
    if args.sass:
        out_dir = Path(args.sass)
        out_dir.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
        for name, text in dict.fromkeys(src for k in ("k6", "k3", "k1", "k4", "k5p")
                                        if k in only for src in shown[k]):
            so = _build.library_path(name, text)
            dump = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                                  text=True, check=True, timeout=120).stdout
            (out_dir / f"{args.label.replace(' ', '_')}-{name}.sass").write_text(dump)
            for loop in sass_loops(dump):
                print(json.dumps({**emit, "sass": name, **loop}), flush=True)
            if name.startswith("stencil_"):
                points = re.search(r"constexpr int P = (\d+);", text)
                head = re.search(r"// input: (.*)\n// span: (.*)", text)
                for func in sass_functions(dump):
                    if "stencil_program_1d" not in func["function"]:
                        continue
                    per = func["instructions"] / int(points.group(1)) if points else None
                    print(json.dumps({**emit, "sass": name, "k5p": list(head.groups()),
                                      "per_point": per, **func}), flush=True)

    def row(kernel, case, shape, ms, err):
        print(json.dumps({**emit, "kernel": kernel, "case": case,
                          "shape": "x".join(map(str, shape)), "ms": ms, "max_abs_err": err}),
              flush=True)

    def launch_us(fn, calls=5):
        """Device µs a call of each kernel ``fn`` launches, from one
        torch.profiler window of ``calls`` calls."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / calls for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}

    for shape in ((1, 512, 40, 64), (8, 4096, 40, 64)) if "k7" in only else ():
        b, t, h, n = shape
        r, k, v = 0.5 * randn(shape), 0.5 * randn(shape), randn(shape)
        w = 0.6 + 0.399 * torch.rand(shape, generator=gen, device=dev)
        u, s0 = 0.3 * randn((h, n)), 0.1 * randn((b, h, n, n))
        want = wkv6_plain(r, k, v, w, u, s0, chunk=64)
        bound = 1e-5 * want[0].abs().max().item() + 1e-6
        graph = torch.cuda.CUDAGraph()  # checked eagerly and as a replayed graph
        with torch.cuda.graph(graph):
            replayed = k7.wkv6_cuda(r, k, v, w, u, s0, chunk=64)
        graph.replay()
        err = 0.0
        for got in (k7.wkv6_cuda(r, k, v, w, u, s0, chunk=64), replayed):
            torch.cuda.synchronize()
            err = max(err, *((g - p).abs().max().item() for g, p in zip(got, want)))
        if not err <= bound:
            raise RuntimeError(f"K7 {shape}: {err} from its plain version (bound {bound})")
        del got, want, replayed, graph
        ms = graph_ms(lambda: k7.wkv6_cuda(r, k, v, w, u, s0, chunk=64),
                      replays=10 if b > 1 else 25)
        row("wkv6_cuda", "wkv6", shape, ms, err)
        if args.cold:
            row("wkv6_cuda", "wkv6 cold", shape,
                cold_ms(lambda: k7.wkv6_cuda(r, k, v, w, u, s0, chunk=64)), err)
        if args.profile:
            print(json.dumps({**emit, "kernel": "wkv6_cuda", "shape": "x".join(map(str, shape)),
                              "device_us_per_call": launch_us(
                                  lambda: k7.wkv6_cuda(r, k, v, w, u, s0, chunk=64))}),
                  flush=True)
        del r, k, v, w, u, s0
        torch.cuda.empty_cache()

    shapes_bwd = ((1, 512, 40, 64), (4, 256, 40, 64))
    for shape in shapes_bwd if "k7bwd" in only and bwd_sources else ():
        b, _, h, n = shape
        args_ = (0.5 * randn(shape), 0.5 * randn(shape), randn(shape),
                 0.6 + 0.399 * torch.rand(shape, generator=gen, device=dev),
                 0.3 * randn((h, n)), 0.1 * randn((b, h, n, n)), randn(shape),
                 randn((b, h, n, n)))
        want = wkv6_ref.wkv6_backward_plain(*args_, chunk=64)
        got = k7.wkv6_bwd_cuda(*args_, chunk=64)
        torch.cuda.synchronize()
        err = 0.0
        for g, p in zip(got, want):
            e = (g - p).abs().max().item()
            if not e <= 1e-5 * p.abs().max().item() + 1e-6:
                raise RuntimeError(f"K7 backward {shape}: {e} from its plain version")
            err = max(err, e)
        del got, want
        ms = graph_ms(lambda: k7.wkv6_bwd_cuda(*args_, chunk=64))
        row("wkv6_bwd_cuda", "wkv6 backward", shape, ms, err)
        if args.cold:
            row("wkv6_bwd_cuda", "wkv6 backward cold", shape,
                cold_ms(lambda: k7.wkv6_bwd_cuda(*args_, chunk=64)), err)
        if args.profile:
            print(json.dumps({**emit, "kernel": "wkv6_bwd_cuda", "shape": "x".join(map(str, shape)),
                              "device_us_per_call": launch_us(
                                  lambda: k7.wkv6_bwd_cuda(*args_, chunk=64))}), flush=True)
        del args_
        torch.cuda.empty_cache()

    for grid in grids if "k2" in only else ():
        for label, prog in (("hdiff x2", hdiff2), ("hdiff_coupled", coupled)):
            arrays = tuple(randn(grid) if f != "coeff" else
                           0.025 * (1.0 + 0.25 * torch.tanh(randn(grid))) for f in prog.inputs)
            got = ir.stencil_program_cuda(prog, arrays)
            want = ir.stencil_program_plain(prog, arrays)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K2 {label} {grid}: not bit-equal to its plain version")
            ms = graph_ms(lambda p=prog, a=arrays: ir.stencil_program_cuda(p, a),
                          replays=10 if grid[0] > 64 else 25)
            row("stencil_program_cuda", label, grid, ms, 0.0)
            del arrays, got, want
            torch.cuda.empty_cache()
    for grid in adj_grids if "k2adj" in only else ():
        for label, prog in adj_progs.items():
            arrays = tuple(torch.zeros(grid, device=dev) if f.startswith("c~") and
                           label.endswith(".aug") else
                           0.025 * (1.0 + 0.25 * torch.tanh(randn(grid))) if f == "coeff" else
                           randn(grid) for f in prog.inputs)
            got = ir.stencil_program_cuda(prog, arrays)
            want = ir.stencil_program_plain(prog, arrays)
            torch.cuda.synchronize()
            if not all(torch.equal(got[f], want[f]) for f in want):
                raise RuntimeError(f"K2 {label} {grid}: not bit-equal to its plain version")
            ms = graph_ms(lambda p=prog, a=arrays: ir.stencil_program_cuda(p, a),
                          replays=10 if grid[0] > 64 else 25)
            tile = tile_for(prog, *grid[1:])
            row("stencil_program_cuda", f"{label} (tile {tile.rows}x{tile.cols}, "
                f"{tile.buffers} frames)", grid, ms, 0.0)
            del arrays, got, want
            torch.cuda.empty_cache()
    for shape in ((1, 512, 2560), (8, 4096, 2560)) if "k6" in only else ():
        for dtype in (torch.float32, torch.bfloat16):
            a = (0.5 + 0.499 * torch.rand(shape, generator=gen, device=dev)).to(dtype)
            b, h0 = randn(shape).to(dtype), randn((shape[0], shape[2]))
            want = rglru_seq_ref(a, b, h0)
            eager = k6.rglru_scan_cuda(a, b, h0)  # checked eagerly and as a replayed graph
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = k6.rglru_scan_cuda(a, b, h0)
            graph.replay()
            for got in (eager, replayed):
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"K6 {shape} {dtype}: not bit-equal to rglru_seq_ref")
            del got, eager, want, replayed, graph
            ms = graph_ms(lambda: k6.rglru_scan_cuda(a, b, h0), replays=10 if shape[0] > 1 else 25)
            row("rglru_scan_cuda", f"rglru {str(dtype)[6:]}", shape, ms, 0.0)
            del a, b, h0
            torch.cuda.empty_cache()
    for grid in grids if "k3" in only else ():
        wrap = torch.randint(-(2**31), 2**31, grid, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
        for coeff in ((26, 10), (3, 2)):
            got, want = k13.hdiff_fixed_cuda(wrap, coeff_num=coeff[0], coeff_shift=coeff[1]), \
                hdiff_fixed_point_ref(wrap, *coeff)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K3 {grid} {coeff}: not bit-equal to hdiff_fixed_point_ref")
        del wrap, got, want
        xq = torch.randint(-(2**20), 2**20, grid, generator=gen, device=dev, dtype=torch.int32)
        ms = graph_ms(lambda: k13.hdiff_fixed_cuda(xq), replays=10 if grid[0] > 64 else 25)
        row("hdiff_fixed_cuda", "hdiff i32", grid, ms, 0.0)
        del xq
        torch.cuda.empty_cache()

    def program_row(label, prog, grid, x):
        got, want = ir.stencil_program_cuda(prog, (x,)), ir.stencil_program_plain(prog, (x,))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"K2 {label} {grid}: not bit-equal to its plain version")
        ms = graph_ms(lambda: ir.stencil_program_cuda(prog, (x,)),
                      replays=10 if grid[0] > 64 else 25)
        row("stencil_program_cuda", label, grid, ms, 0.0)

    for grid in grids if "k1" in only else ():
        x = randn(grid)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for limit in (True, False):
                got = k13.hdiff_cuda(xd, 0.025, limit=limit)
                want = k13.hdiff_plain(xd, 0.025, limit=limit)
                torch.cuda.synchronize()
                if not args.no_check and not torch.equal(got, want):
                    raise RuntimeError(f"K1 {grid} {dtype} limit={limit}: not bit-equal to "
                                       "hdiff_plain")
            del got, want
            ms = graph_ms(lambda a=xd: k13.hdiff_cuda(a, 0.025),
                          replays=10 if grid[0] > 64 else 25)
            row("hdiff_cuda", f"hdiff {str(dtype)[6:]}", grid, ms, 0.0)
        program_row("hdiff x1 (K1 yardstick)", hdiff1, grid, x)
        del x, xd
        torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(2024)
    masks = {n: weights_for(n) for n in ("jacobi2d_3pt", "laplacian", "jacobi2d_5pt",
                                         "jacobi2d_9pt", "seidel2d")}
    masks["random"] = torch.randn((3, 3), generator=g).numpy()
    for grid in grids if "k4" in only else ():
        x = randn(grid)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for name, w in masks.items():
                got, want = k45.stencil2d_cuda(xd, w), k45.stencil2d_plain(xd, w)
                torch.cuda.synchronize()
                if not args.no_check and not torch.equal(got, want):
                    raise RuntimeError(f"K4 {grid} {dtype} {name}: not bit-equal to "
                                       "stencil2d_plain")
            del got, want
            ms = graph_ms(lambda a=xd: k45.stencil2d_cuda(a, masks["jacobi2d_9pt"]),
                          replays=10 if grid[0] > 64 else 25)
            row("stencil2d_cuda", f"jacobi2d_9pt {str(dtype)[6:]}", grid, ms, 0.0)
        program_row("jacobi2d_9pt (K4 yardstick)", jac9, grid, x)
        x4 = x.view(grid[0], 1, grid[1], grid[2])
        w4 = torch.tensor(masks["jacobi2d_9pt"], device=dev).view(1, 1, 3, 3)
        ms = graph_ms(lambda: torch.nn.functional.conv2d(x4, w4),
                      replays=10 if grid[0] > 64 else 25)
        row("conv2d", "jacobi2d_9pt interior, TF32 off (K4 yardstick)", grid, ms, None)
        del x, xd, x4
        torch.cuda.empty_cache()
    for shape in rows_1d if "k5p" in only else ():
        y = randn(shape)
        replays = 10 if shape[0] > 16384 else 25
        for dtype in (torch.float32, torch.bfloat16):
            yd = y.to(dtype)
            for label, prog in k5p_progs.items():
                got = ir.stencil_program_1d_cuda(prog, yd)
                want = ir.stencil_program_1d_plain(prog, yd)
                torch.cuda.synchronize()
                if not args.no_check and not torch.equal(got, want):
                    raise RuntimeError(f"K5' {label} {shape} {dtype}: not bit-equal to "
                                       "stencil_program_1d_plain")
                del got, want
                ms = graph_ms(lambda p=prog, a=yd: ir.stencil_program_1d_cuda(p, a),
                              replays=replays)
                row("stencil_program_1d_cuda", f"{label} {str(dtype)[6:]}", shape, ms, 0.0)
            ms = graph_ms(lambda a=yd: k45.jacobi1d_cuda(a), replays=replays)
            row("jacobi1d_cuda", f"jacobi1d {str(dtype)[6:]} (K5' yardstick)", shape, ms, 0.0)
        third = float(torch.tensor(1.0 / 3.0))
        composed = {1: [1.0, 1, 1], 2: [1.0, 2, 3, 2, 1], 3: [1.0, 3, 6, 7, 6, 3, 1]}
        y3 = y.view(shape[0], 1, shape[1])
        for k, taps in composed.items():
            w = (third**k * torch.tensor(taps, device=dev)).view(1, 1, -1)
            ms = graph_ms(lambda w=w: torch.nn.functional.conv1d(y3, w), replays=replays)
            row("conv1d", f"jacobi1d x{k} interior, f32 (K5' yardstick)", shape, ms, None)
        del y, yd, y3
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
