"""CUDA C++ code generation for one fused kernel per IR program (K2, K5').

The Hopper counterpart of the body of ``repro/ir/lower_pallas.py``
(``_generic_kernel``; for 1-D programs ``_kernel_1d``, rendered by
:func:`render_1d` the same way over ``(batch, n)`` rows, with column
frames in place of 2-D ones): :func:`render` turns a :class:`StencilProgram` — its
op list, its chain of sweeps, its per-field exchange radii and its outputs
— into the source of one kernel, ``stencil_program``, plus a C launcher
``launch`` that :mod:`repro_torch.ir.lower_cuda` binds with ctypes.

The generated kernel, one block per (plane, row tile, column tile):

  1. loads every input field into a float32 shared-memory *frame* of
     ``(TR + 2H) x (TC + 2H)`` words, ``H`` the chain radius. Each field is
     read only within its own ``exchange_radii()`` halo (a radius-0
     coefficient field fetches no neighbours); cells beyond that halo or
     outside the grid are zero — they feed only points that are discarded;
  2. for each sweep of ``program.chain``, evaluates each op over its
     margin-extended region of the frame (the region shrinks by the
     sweep's margins, exactly as ``interior_eval`` insets it) into its own
     frame, with ``__syncthreads()`` between ops. Frames are reused once a
     field is dead (:func:`frame_plan`);
  3. re-applies the boundary ring by ABSOLUTE row and column index from the
     runtime ``(row_offset, rows_global, col_offset, cols_global)``
     arguments — ``slab_step``'s column-slab form; for a whole grid,
     ``(0, R, 0, C)``, it equals the full-width form — writing each
     evolving field's new state in place;
  4. stores each ``program.outputs`` field once, in its input dtype.

Ops become C++ through :attr:`StencilOp.emit`, which keeps each
combinator's association and writes its constants as exact float32 bit
patterns. The sources are compiled with ``-fmad=false``
(:mod:`repro_torch.kernels._build`), so a launch rounds like the plain
version. Everything here is text: it runs, and is tested, without a card.
"""

from __future__ import annotations

import dataclasses

from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.plan import TilePlan

CTYPES = {"float32": "float", "bfloat16": "__nv_bfloat16"}


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """One sweep's frame assignment: ``env`` maps every field the sweep
    reads or computes to its frame; ``updates`` lists, per evolving field,
    ``(state frame, frame of the op producing its next value)``."""

    program: StencilProgram
    inset: int
    env: dict[str, int]
    updates: tuple[tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Frames of the whole kernel: one per program input (evolving fields
    are updated in place), then op frames shared across sweeps."""

    input_frames: dict[str, int]
    sweeps: tuple[SweepPlan, ...]
    n_frames: int


def frame_plan(program: StencilProgram) -> FramePlan:
    """Assigns shared-memory frames to the program's fields.

    Each input gets its own frame for the whole kernel. Within a sweep each
    op takes a free frame (or a new one) and an op's frame is released
    right after its last reader, unless it produces an evolving field's
    next value (those live until the ring step). A frame is taken before
    the op's dead inputs are released, so an op never overwrites what it
    reads."""
    inputs = {f: i for i, f in enumerate(program.inputs)}
    extras = [f for f in program.inputs if f not in program.outputs]
    n_frames = len(inputs)
    sweeps = []
    inset = 0
    for p in program.chain:
        env = {f: inputs[f] for f in extras}
        if len(program.outputs) > 1:
            states = {f: inputs[f] for f in p.outputs}
        else:
            states = {p.passthrough: inputs[program.passthrough]}
        env.update(states)
        missing = [f for f in p.inputs if f not in env]
        if missing:
            raise ValueError(
                f"sweep {p.name!r} of {program.name!r} reads {missing}, which are "
                f"neither evolving fields nor shared inputs {extras}"
            )
        last_use: dict[str, int] = {}
        for idx, op in enumerate(p.ops):
            for r in op.reads:
                last_use[r.field] = idx
        keep = set(p.outputs.values())
        op_names = {op.name for op in p.ops}
        free = list(range(len(inputs), n_frames))
        for idx, op in enumerate(p.ops):
            if free:
                env[op.name] = free.pop(0)
            else:
                env[op.name] = n_frames
                n_frames += 1
            dead = [op.name] if op.name not in last_use and op.name not in keep else []
            dead += [
                f for f in dict.fromkeys(r.field for r in op.reads)
                if f in op_names and last_use[f] == idx and f not in keep
            ]
            free = sorted(free + [env[f] for f in dead])
        updates = tuple((states[f], env[p.outputs[f]]) for f in p.outputs)
        sweeps.append(SweepPlan(p, inset, env, updates))
        inset += p.radius
    return FramePlan(inputs, tuple(sweeps), n_frames)


def kernel_name(program: StencilProgram) -> str:
    """The library name of the program's kernel: keyed by the fingerprint,
    so structurally equal programs share one kernel whatever their names."""
    return "stencil_" + program.fingerprint()[:16]


def _region_loop(rows: tuple[int, int], cols: tuple[int, int], body: list[str]) -> list[str]:
    nr, nc = rows[1] - rows[0], cols[1] - cols[0]
    if nr <= 0 or nc <= 0:
        raise ValueError(f"empty frame region rows={rows} cols={cols}")
    return [
        f"  for (int q = threadIdx.x; q < {nr * nc}; q += kThreads) {{",
        f"    const int p = ({rows[0]} + q / {nc}) * FC + {cols[0]} + q % {nc};",
        *[f"    {line}" for line in body],
        "  }",
        "  __syncthreads();",
    ]


def _span_loop(lo: int, hi: int, body: list[str]) -> list[str]:
    """The 1-D form of :func:`_region_loop`: frame positions ``[lo, hi)``."""
    if hi <= lo:
        raise ValueError(f"empty frame span [{lo}, {hi})")
    return [
        f"  for (int q = threadIdx.x; q < {hi - lo}; q += kThreads) {{",
        f"    const int p = {lo} + q;",
        *[f"    {line}" for line in body],
        "  }",
        "  __syncthreads();",
    ]


def render(program: StencilProgram, dtypes, tile: TilePlan) -> str:
    """CUDA C++ source of the fused kernel for ``program`` with input
    dtypes ``dtypes`` (``"float32"`` / ``"bfloat16"``, in
    ``program.inputs`` order) and output tile ``tile``. Deterministic: the
    same arguments always give the same text, and the text depends on the
    program only through its structure (never its display name).

    2-D programs give K2 (``stencil_program``); single-input 1-D programs
    give K5' (``stencil_program_1d``, :func:`render_1d`)."""
    if program.ndim not in (1, 2):
        raise ValueError(f"the CUDA codegen handles 1-D and 2-D programs, got ndim={program.ndim}")
    if program.ndim == 1 and len(program.inputs) != 1:
        raise ValueError(
            f"the 1-D CUDA codegen handles single-input programs only, got {program.inputs}"
        )
    dtypes = tuple(dtypes)
    if len(dtypes) != len(program.inputs):
        raise ValueError(f"need one dtype per input {program.inputs}, got {dtypes}")
    unknown = [d for d in dtypes if d not in CTYPES]
    if unknown:
        raise TypeError(f"dtype(s) {unknown} not supported (want one of {tuple(CTYPES)})")
    for p in program.chain:
        for op in p.ops:
            if op.emit is None:
                raise ValueError(f"op {op.name!r} of {p.name!r} has no CUDA emitter")
    plan = frame_plan(program)
    if tile.halo != program.radius or tile.buffers != plan.n_frames:
        raise ValueError(
            f"tile plan {tile} does not match program radius {program.radius} "
            f"and {plan.n_frames} frames"
        )
    if program.ndim == 1:
        return render_1d(program, dtypes[0], tile, plan)
    H = program.radius
    FR, FC = tile.rows + 2 * H, tile.cols + 2 * H
    halos = program.exchange_radii()
    outs = [(f, plan.input_frames[f]) for f in program.outputs]
    ctype = dict(zip(program.inputs, (CTYPES[d] for d in dtypes)))

    src = [
        "// Generated by repro_torch.ir.codegen_cuda; do not edit.",
        "// K2 stencil_program_cuda: replaces the JAX package's",
        "// repro/ir/lower_pallas.py::lower_pallas (_generic_kernel).",
        "// Bound on an H100: device-memory bytes, each input read once and each",
        "// output written once per launch of all k sweeps, (inputs + outputs) x",
        "// D*R*C x itemsize; the ops' flops per point are far below the card's",
        "// FP32 rate per byte. Design: each field is read once per tile (plus",
        "// its own halo, mostly from L2) into shared memory, every intermediate",
        "// of every sweep stays there, and each output is stored once.",
        f"// fingerprint: {program.fingerprint()}",
        "// inputs: "
        + ", ".join(f"{f}:{d}(halo {halos[f]})" for f, d in zip(program.inputs, dtypes)),
        "// outputs: " + ", ".join(program.outputs),
        f"// tile: {tile.rows}x{tile.cols}  chain halo: {H}  frames: {plan.n_frames}"
        f"  sweeps: {program.steps}",
        '#include "stencil_common.cuh"',
        "",
        "namespace {",
        "using repro_torch::from_f32;",
        "using repro_torch::kThreads;",
        "using repro_torch::limit_flux;",
        "using repro_torch::to_f32;",
        f"constexpr int TR = {tile.rows}, TC = {tile.cols}, H = {H};",
        "constexpr int FR = TR + 2 * H, FC = TC + 2 * H, FRAME = FR * FC;",
        f"constexpr int NFRAMES = {plan.n_frames};",
        "",
        "__global__ void __launch_bounds__(kThreads) stencil_program(",
    ]
    params = [f"    const {ctype[f]}* __restrict__ I{i}" for i, f in enumerate(program.inputs)]
    params += [f"    {ctype[f]}* __restrict__ O{k}" for k, (f, _) in enumerate(outs)]
    params += ["    int rows, int cols, int row_offset, int rows_global, int col_offset, "
               "int cols_global) {"]
    src += [",\n".join(params)]
    src += [
        "  extern __shared__ __align__(16) float smem[];",
        "  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;",
        "  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;",
        *[f"  float* const F{n} = smem + {n} * FRAME;" for n in range(plan.n_frames)],
        "",
    ]
    for i, f in enumerate(program.inputs):
        lo, hi_r, hi_c = H - halos[f], FR - H + halos[f], FC - H + halos[f]
        src += [
            f"  // load {f!r}: halo {halos[f]}, zero beyond it and outside the grid",
            "  for (int q = threadIdx.x; q < FRAME; q += kThreads) {",
            "    const int i = q / FC, j = q - i * FC;",
            "    const int gr = r0 + i - H, gc = c0 + j - H;",
            f"    const bool live = i >= {lo} && i < {hi_r} && j >= {lo} && j < {hi_c} &&",
            "                      gr >= 0 && gr < rows && gc >= 0 && gc < cols;",
            f"    F{plan.input_frames[f]}[q] = live ? to_f32(I{i}[plane + "
            "static_cast<long long>(gr) * cols + gc]) : 0.0f;",
            "  }",
        ]
    src += ["  __syncthreads();"]
    for s, sweep in enumerate(plan.sweeps):
        p, e = sweep.program, sweep.inset
        margins = p.margins()
        for op in p.ops:
            (lo_r, lo_c), (hi_r, hi_c) = margins[op.name]
            views = []
            for r in op.reads:
                off = r.offset[0] * FC + r.offset[1]
                views.append(f"F{sweep.env[r.field]}[p{off:+d}]" if off else
                             f"F{sweep.env[r.field]}[p]")
            src.append(f"  // sweep {s}, op {op.name!r}: {op.tag}")
            src += _region_loop(
                (e + lo_r, FR - e - hi_r), (e + lo_c, FC - e - hi_c),
                [f"F{sweep.env[op.name]}[p] = {op.emit(*views)};"],
            )
        r = p.radius
        src.append(f"  // sweep {s}: ring of radius {r} kept at absolute indices")
        body = [
            "const int gr = row_offset + r0 + p / FC - H, gc = col_offset + c0 + p % FC - H;",
            f"if (!(gr < {r} || gr >= rows_global - {r} ||"
            f" gc < {r} || gc >= cols_global - {r})) {{",
            *[f"  F{state}[p] = F{new}[p];" for state, new in sweep.updates],
            "}",
        ]
        src += _region_loop((e + r, FR - e - r), (e + r, FC - e - r), body)
    src += [
        "  for (int q = threadIdx.x; q < TR * TC; q += kThreads) {",
        "    const int ti = q / TC, tj = q - ti * TC;",
        "    const int gr = r0 + ti, gc = c0 + tj;",
        "    if (gr >= rows || gc >= cols) continue;",
        "    const int p = (ti + H) * FC + tj + H;",
        "    const long long g = plane + static_cast<long long>(gr) * cols + gc;",
        *[f"    O{k}[g] = from_f32<{ctype[f]}>(F{frame}[p]);  // store {f!r}"
          for k, (f, frame) in enumerate(outs)],
        "  }",
        "}",
        "",
        "}  // namespace",
        "",
        "// C launcher bound with ctypes; returns the CUDA error code (0 = ok).",
        'extern "C" int launch(',
    ]
    args = [f"    const void* I{i}" for i in range(len(program.inputs))]
    args += [f"    void* O{k}" for k in range(len(outs))]
    args += ["    int depth, int rows, int cols, int row_offset, int rows_global, "
             "int col_offset, int cols_global, void* stream) {"]
    src += [",\n".join(args)]
    call = [f"static_cast<const {ctype[f]}*>(I{i})" for i, f in enumerate(program.inputs)]
    call += [f"static_cast<{ctype[f]}*>(O{k})" for k, (f, _) in enumerate(outs)]
    call += ["rows", "cols", "row_offset", "rows_global", "col_offset", "cols_global"]
    src += [
        "  static size_t reserved = 0;",
        "  const size_t smem = sizeof(float) * FRAME * NFRAMES;",
        "  const int err = repro_torch::reserve_smem(stencil_program, smem, reserved);",
        "  if (err) return err;",
        "  const dim3 grid((cols + TC - 1) / TC, (rows + TR - 1) / TR, depth);",
        "  stencil_program<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(",
        "      " + ", ".join(call) + ");",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
    ]
    return "\n".join(src)


def render_1d(program: StencilProgram, dtype: str, tile: TilePlan, plan: FramePlan) -> str:
    """K5': the fused kernel of a single-input 1-D program over ``(batch,
    n)`` rows, the Hopper counterpart of ``lower_pallas.py::_kernel_1d``.

    One block per (row, column tile of ``tile.cols``): it loads the tile
    plus a ``k * r`` halo into a float32 frame, runs every sweep of the
    chain there (each op over its margin-shrunk span, ``interior_eval``'s
    region), re-applies the radius-``r`` end points at ABSOLUTE column
    indices between sweeps — what ``_kernel_1d`` does on its whole row —
    and stores the tile once in the input dtype."""
    H = program.radius
    TC = tile.cols
    FC = TC + 2 * H
    (field,) = program.inputs
    halo = program.exchange_radii()[field]
    ctype = CTYPES[dtype]
    src = [
        "// Generated by repro_torch.ir.codegen_cuda; do not edit.",
        "// K5' stencil_program_1d_cuda: replaces the JAX package's",
        "// repro/ir/lower_pallas.py::_lower_pallas_1d (_kernel_1d).",
        "// Bound on an H100: device-memory bytes, the (batch, n) row field read",
        "// once and written once per launch of all k sweeps; the ops' flops per",
        "// point are far below the card's FP32 rate per byte. Design: the row is",
        "// tiled across blocks (Pallas held a whole row per program) with a k*r",
        "// halo read from L2, every sweep stays in shared memory, one store.",
        f"// fingerprint: {program.fingerprint()}",
        f"// input: {field}:{dtype}(halo {halo})",
        f"// tile: {TC}  chain halo: {H}  frames: {plan.n_frames}  sweeps: {program.steps}",
        '#include "stencil_common.cuh"',
        "",
        "namespace {",
        "using repro_torch::from_f32;",
        "using repro_torch::kThreads;",
        "using repro_torch::to_f32;",
        f"constexpr int TC = {TC}, H = {H};",
        "constexpr int FC = TC + 2 * H;",
        f"constexpr int NFRAMES = {plan.n_frames};",
        "",
        "// Rows map to blockIdx.z * gridDim.y + blockIdx.y (no 65535-row limit).",
        "__global__ void __launch_bounds__(kThreads) stencil_program_1d(",
        f"    const {ctype}* __restrict__ I0, {ctype}* __restrict__ O0, int batch, int n) {{",
        "  extern __shared__ __align__(16) float smem[];",
        "  const int b = blockIdx.z * gridDim.y + blockIdx.y;",
        "  if (b >= batch) return;",
        "  const long long row = static_cast<long long>(b) * n;",
        "  const int c0 = blockIdx.x * TC;",
        *[f"  float* const F{k} = smem + {k} * FC;" for k in range(plan.n_frames)],
        "",
        f"  // load {field!r}: halo {halo}, zero beyond it and outside the row",
        "  for (int q = threadIdx.x; q < FC; q += kThreads) {",
        "    const int gc = c0 + q - H;",
        f"    const bool live = q >= {H - halo} && q < {FC - H + halo} && gc >= 0 && gc < n;",
        f"    F{plan.input_frames[field]}[q] = live ? to_f32(I0[row + gc]) : 0.0f;",
        "  }",
        "  __syncthreads();",
    ]
    for s, sweep in enumerate(plan.sweeps):
        p, e = sweep.program, sweep.inset
        margins = p.margins()
        for op in p.ops:
            (lo,), (hi,) = margins[op.name]
            views = [
                f"F{sweep.env[r.field]}[p{r.offset[0]:+d}]" if r.offset[0]
                else f"F{sweep.env[r.field]}[p]"
                for r in op.reads
            ]
            src.append(f"  // sweep {s}, op {op.name!r}: {op.tag}")
            src += _span_loop(e + lo, FC - e - hi,
                              [f"F{sweep.env[op.name]}[p] = {op.emit(*views)};"])
        r = p.radius
        src.append(f"  // sweep {s}: end points of radius {r} kept at absolute indices")
        body = [
            "const int gc = c0 + p - H;",
            f"if (!(gc < {r} || gc >= n - {r})) {{",
            *[f"  F{state}[p] = F{new}[p];" for state, new in sweep.updates],
            "}",
        ]
        src += _span_loop(e + r, FC - e - r, body)
    out_frame = plan.input_frames[program.passthrough]
    src += [
        "  for (int q = threadIdx.x; q < TC; q += kThreads) {",
        "    const int gc = c0 + q;",
        "    if (gc >= n) break;",
        f"    O0[row + gc] = from_f32<{ctype}>(F{out_frame}[q + H]);  // store {field!r}",
        "  }",
        "}",
        "",
        "}  // namespace",
        "",
        "// C launcher bound with ctypes; returns the CUDA error code (0 = ok).",
        'extern "C" int launch(const void* I0, void* O0, int batch, int n, void* stream) {',
        "  static size_t reserved = 0;",
        "  const size_t smem = sizeof(float) * FC * NFRAMES;",
        "  const int err = repro_torch::reserve_smem(stencil_program_1d, smem, reserved);",
        "  if (err) return err;",
        "  const unsigned gz = (batch + 65534) / 65535;",
        "  const dim3 grid((n + TC - 1) / TC, (batch + gz - 1) / gz, gz);",
        "  stencil_program_1d<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(",
        f"      static_cast<const {ctype}*>(I0), static_cast<{ctype}*>(O0), batch, n);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
    ]
    return "\n".join(src)
