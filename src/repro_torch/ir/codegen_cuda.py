"""CUDA C++ code generation for one fused kernel per IR program (K2, K5').

The Hopper counterpart of the body of ``repro/ir/lower_pallas.py``
(``_generic_kernel``; for 1-D programs ``_kernel_1d``, rendered by
:func:`render_1d`): :func:`render` turns a :class:`StencilProgram` — its
op list, its chain of sweeps, its per-field exchange radii and its outputs
— into the source of one kernel, ``stencil_program``, plus a C launcher
``launch`` that :mod:`repro_torch.ir.lower_cuda` binds with ctypes.

The generated 2-D kernel (K2), one block per (plane, row tile, column
tile):

  1. loads every input field into a float32 shared-memory *frame* of
     ``(TR + 2H) x (TC + 2H)`` words, ``H`` the chain radius, with 16-byte
     ``cp.async`` copies for the aligned groups of 4 columns of a float32
     field. Each field is read only within its own ``exchange_radii()``
     halo (a radius-0 coefficient field fetches no neighbours); cells
     beyond that halo or outside the grid are zero — they feed only points
     that are discarded;
  2. for each sweep of ``program.chain``, evaluates the ops over their
     margin-extended regions of the frame (the region shrinks by the
     sweep's margins, exactly as ``interior_eval`` insets it). An op that
     one later op reads, only at offset zero, and that is no sweep output
     is *inlined*: computed in registers inside its consumer's loop. The
     other ops get a frame each, reused once dead (:func:`frame_plan`),
     and one loop with a ``__syncthreads()`` after it. In every loop a
     thread walks a run of rows down one column and slides each column's
     taps through registers, so a frame word is read about once per
     thread, not once per tap;
  3. computes the evolving fields' next values in one *update* loop that
     re-applies the boundary ring by ABSOLUTE row and column index from
     the runtime ``(row_offset, rows_global, col_offset, cols_global)``
     arguments — ``slab_step``'s column-slab form; for a whole grid,
     ``(0, R, 0, C)``, it equals the full-width form. Before the last
     sweep it writes each next state into the field's other state frame
     (two per evolving field when the chain has several sweeps);
  4. in the last sweep's update loop stores each ``program.outputs`` field
     straight from registers, once, in its input dtype.

The generated 1-D kernel (K5', ``stencil_program_1d``) takes the
``(batch, n)`` field as one flat array cut into spans of 16-byte vectors,
one a thread, whatever rows a span crosses; spans overlap by the chain
radius in whole vectors, which each span loads but leaves to its
neighbours to store. A thread keeps its points in registers through every
sweep and computes each op at the positions its readers need (an
intermediate read at offset -1 is computed one position further out, not
shared through memory); a sweep exchanges only the neighbours' points and
keeps every row's end points by a select on each point's column. A chain
of sweeps with a small halo runs a span a warp and exchanges by shuffles,
with no barrier; anything else a span a block, through a shared frame with
one barrier a sweep. A point that is no end point reads only its own row
through the whole chain, so what a span computes across a row boundary
reaches only end points and unstored halo points.

Ops become C++ through :attr:`StencilOp.emit`, which keeps each
combinator's association and writes its constants as exact float32 bit
patterns; an inlined op is its own ``emit`` text bound to a local. The
sources are compiled with ``-fmad=false``
(:mod:`repro_torch.kernels._build`), so a launch rounds like the plain
version. Everything here is text: it runs, and is tested, without a card.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.plan import THREADS, TilePlan, program_frame_layout

CTYPES = {"float32": "float", "bfloat16": "__nv_bfloat16"}


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """One sweep's frame assignment.

    ``env`` maps every field the sweep reads from shared memory (shared
    inputs, the evolving fields' current state, the ops that get a frame)
    to its frame. ``inlined`` names the ops computed in registers inside
    their one consumer; ``materialized`` the ops, in order, that get a
    frame and a loop of their own. ``updates`` lists, per evolving field,
    ``(field, producing op, state frame, next-state frame)``; the
    next-state frame is ``None`` in the last sweep, which stores the output
    instead."""

    program: StencilProgram
    inset: int
    env: dict[str, int]
    inlined: tuple[str, ...]
    materialized: tuple[str, ...]
    updates: tuple[tuple[str, str, int, int | None], ...]


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Frames of the whole kernel: one per program input, then (more than
    one sweep) a second state frame per evolving field, then op frames
    shared across sweeps."""

    input_frames: dict[str, int]
    sweeps: tuple[SweepPlan, ...]
    n_frames: int


def _sweep_env(program: StencilProgram, p: StencilProgram, state_frames: dict[str, int]):
    """``(env, states)`` at the start of sweep ``p``: the shared inputs and
    the evolving fields (``states`` maps the sweep's evolving field to the
    program's) bound to their current frames."""
    inputs = {f: i for i, f in enumerate(program.inputs)}
    extras = [f for f in program.inputs if f not in program.outputs]
    env = {f: inputs[f] for f in extras}
    if len(program.outputs) > 1:
        states = {f: f for f in p.outputs}
    else:
        states = {p.passthrough: program.passthrough}
    env.update({sf: state_frames[pf] for sf, pf in states.items()})
    missing = [f for f in p.inputs if f not in env]
    if missing:
        raise ValueError(
            f"sweep {p.name!r} of {program.name!r} reads {missing}, which are "
            f"neither evolving fields nor shared inputs {extras}"
        )
    return env, states


def _live_ops(p: StencilProgram) -> set[str]:
    ops = {op.name: op for op in p.ops}
    live, stack = set(), list(p.outputs.values())
    while stack:
        name = stack.pop()
        if name not in live:
            live.add(name)
            stack += [r.field for r in ops[name].reads if r.field in ops]
    return live


def inlined_ops(p: StencilProgram) -> tuple[str, ...]:
    """The ops of sweep ``p`` that its kernel computes in registers inside
    their consumer: every op that exactly one later op reads, only at
    offset zero, and that produces no evolving field's next value. Ops that
    no output depends on are dropped from the kernel altogether."""
    ops = {op.name: op for op in p.ops}
    live = _live_ops(p)
    readers: dict[str, list] = {name: [] for name in ops}
    for op in p.ops:
        if op.name in live:
            for r in op.reads:
                if r.field in readers:
                    readers[r.field].append((op.name, r.offset))
    zero = (0,) * p.ndim
    outs = set(p.outputs.values())
    return tuple(
        op.name for op in p.ops
        if op.name in live and op.name not in outs
        and len({name for name, _ in readers[op.name]}) == 1
        and all(o == zero for _, o in readers[op.name])
    )


def frame_plan(program: StencilProgram) -> FramePlan:
    """Assigns shared-memory frames to the program's fields.

    2-D (K2): each input gets its own frame for the whole kernel, and with
    more than one sweep each evolving field gets a second one, the two
    taking turns as the state a sweep reads and the state it writes.
    Within a sweep the inlined ops (:func:`inlined_ops`) get no frame; the
    producing ops that no other op reads are computed in the update loop
    and get none either. Each remaining op takes a free frame (or a new
    one) and its frame is released right after its last reader, an
    inlined reader counting as its consumer. A frame is taken before the
    op's dead inputs are released, so an op never overwrites what it
    reads. 2-D programs only: the 1-D kernel (K5', :func:`render_1d`) keeps
    every op in registers."""
    if program.ndim != 2:
        raise ValueError(f"frame_plan plans 2-D programs, got ndim={program.ndim}")
    inputs = {f: i for i, f in enumerate(program.inputs)}
    n_frames = len(inputs)
    spare = {}
    if program.steps > 1:
        for f in program.outputs:
            spare[f] = n_frames
            n_frames += 1
    current = {f: inputs[f] for f in program.outputs}
    first_op_frame = n_frames
    sweeps = []
    inset = 0
    for s, p in enumerate(program.chain):
        last = s == program.steps - 1
        env, states = _sweep_env(program, p, current)
        ops = {op.name: op for op in p.ops}
        live = _live_ops(p)
        inlined = inlined_ops(p)
        read_by_ops = {r.field for op in p.ops if op.name in live for r in op.reads}
        in_update = [p.outputs[f] for f in p.outputs if p.outputs[f] not in read_by_ops]
        materialized = [op.name for op in p.ops if op.name in live
                        and op.name not in inlined and op.name not in in_update]

        def frame_reads(name, inlined=inlined, ops=ops):
            out = set()
            for r in ops[name].reads:
                out |= frame_reads(r.field) if r.field in inlined else {r.field}
            return out

        units = [(name, frame_reads(name)) for name in materialized]
        units.append((None, set().union(*(frame_reads(n) for n in in_update))
                      | {p.outputs[f] for f in p.outputs if p.outputs[f] not in in_update}))
        last_use = {f: idx for idx, (_, reads) in enumerate(units) for f in reads}
        free = list(range(first_op_frame, n_frames))
        for idx, (name, reads) in enumerate(units):
            if name is not None:
                if free:
                    env[name] = free.pop(0)
                else:
                    env[name] = n_frames
                    n_frames += 1
            dead = [f for f in reads if f in ops and last_use[f] == idx]
            free = sorted(free + [env[f] for f in dead])
        updates = []
        for f, op_name in p.outputs.items():
            pf = states[f]
            old = current[pf]
            new = None if last else (spare[pf] if old == inputs[pf] else inputs[pf])
            updates.append((f, op_name, old, new))
        for f, _, _, new in updates:
            current[states[f]] = new
        sweeps.append(SweepPlan(p, inset, env, inlined, tuple(materialized), tuple(updates)))
        inset += p.radius
    return FramePlan(inputs, tuple(sweeps), n_frames)


def kernel_name(program: StencilProgram) -> str:
    """The library name of the program's kernel: keyed by the fingerprint,
    so structurally equal programs share one kernel whatever their names."""
    return "stencil_" + program.fingerprint()[:16]


def _run_length(nr: int, nc: int, span: int) -> int:
    """Rows one thread walks down a column in a loop over an ``nr x nc``
    region whose taps span ``span`` extra rows: the run that minimises the
    rows each thread loads, passes over the block's threads included."""
    def cost(run):
        items = nc * math.ceil(nr / run)
        return math.ceil(items / THREADS) * (run + span), -run
    return min(range(1, min(nr, 16) + 1), key=cost)


def _tap(frame: int, dr: int, dc: int) -> str:
    def s(v):
        return f"m{-v}" if v < 0 else str(v)
    return f"x{frame}_{s(dr)}_{s(dc)}"


def _at(frame: int, off: int, base: str = "p") -> str:
    return f"F{frame}[{base}{off:+d}]" if off else f"F{frame}[{base}]"


class _Loop:
    """One loop over a frame region: a thread per (column, run of rows),
    each column's taps sliding through registers down the run."""

    def __init__(self, sweep: SweepPlan, ld: int):
        self.sweep, self.ld = sweep, ld
        self.ops = {op.name: op for op in sweep.program.ops}
        self.taps: dict[tuple[int, int], set[int]] = {}
        self.locals: dict[str, str] = {}
        self.lines: list[str] = []

    def view(self, field: str, offset) -> str:
        if field in self.sweep.inlined:
            return self.value(field)
        dr, dc = offset
        frame = self.sweep.env[field]
        self.taps.setdefault((frame, dc), set()).add(dr)
        return _tap(frame, dr, dc)

    def value(self, name: str) -> str:
        """The C expression of op ``name`` at the loop's point; an inlined op
        is bound to a local once, before its first use."""
        if name in self.locals:
            return self.locals[name]
        op = self.ops[name]
        text = op.emit(*(self.view(r.field, r.offset) for r in op.reads))
        if name not in self.sweep.inlined:
            return text
        var = f"v{list(self.ops).index(name)}"
        self.lines.append(f"const float {var} = {text};  // {name}")
        self.locals[name] = var
        return var

    def has_tap(self, frame: int) -> bool:
        return 0 in self.taps.get((frame, 0), ())

    def render(self, rows: tuple[int, int], cols: tuple[int, int], head: list[str],
               body: list[str]) -> list[str]:
        nr, nc = rows[1] - rows[0], cols[1] - cols[0]
        if nr <= 0 or nc <= 0:
            raise ValueError(f"empty frame region rows={rows} cols={cols}")
        groups = {key: (min(drs), max(drs)) for key, drs in sorted(self.taps.items())}
        span = max((hi - lo for lo, hi in groups.values()), default=0)
        run = _run_length(nr, nc, span)
        nseg = math.ceil(nr / run)
        ld = self.ld
        out = [
            f"  for (int w = threadIdx.x; w < {nc * nseg}; w += kThreads) {{",
            f"    const int seg = w / {nc};",
            f"    const int j = {cols[0]} + w - seg * {nc};",
            f"    const int i0 = {rows[0]} + seg * {run};",
            "    const int p0 = i0 * LD + j;",
            *[f"    {line}" for line in head],
        ]
        for (frame, dc), (lo, hi) in groups.items():
            names = [_tap(frame, dr, dc) for dr in range(lo, hi + 1)]
            inits = [f"{n} = {_at(frame, dr * ld + dc, 'p0')}"
                     for n, dr in zip(names[:-1], range(lo, hi))]
            out.append("    float " + ", ".join(inits + [names[-1]]) + ";")
        out += [
            "#pragma unroll",
            f"    for (int s = 0; s < {run}; ++s) {{",
            f"      if (i0 + s >= {rows[1]}) break;",
            "      const int p = p0 + s * LD;",
        ]
        for (frame, dc), (lo, hi) in groups.items():
            out.append(f"      {_tap(frame, hi, dc)} = {_at(frame, hi * ld + dc)};")
        out += [f"      {line}" for line in self.lines + body]
        for (frame, dc), (lo, hi) in groups.items():
            out += [f"      {_tap(frame, dr, dc)} = {_tap(frame, dr + 1, dc)};"
                    for dr in range(lo, hi)]
        out += ["    }", "  }"]
        return out


def _load_field(field: str, i: int, frame: int, dtype: str, halo: int, H: int,
                FR: int, FC: int) -> list[str]:
    """Copies field ``i`` into its frame: zero beyond its halo and outside
    the grid. A float32 field's aligned groups of 4 columns go by one 16-byte
    ``cp.async`` each when bit ``i`` of ``aligned`` is set (16-byte-aligned
    pointer, columns a multiple of 4); the rest element by element."""
    lo, hi_r, hi_c = H - halo, FR - H + halo, FC - H + halo
    live = (f"i >= {lo} && i < {hi_r} && gr >= 0 && gr < rows")
    src = [f"  // load {field!r}: halo {halo}, zero beyond it and outside the grid"]
    scalar = [
        "const int gc = c0 + j - H;",
        f"F{frame}[i * LD + j] = {live} && j >= {lo} && j < {hi_c} && gc >= 0 && gc < cols",
        f"    ? to_f32(I{i}[plane + static_cast<long long>(gr) * cols + gc]) : 0.0f;",
    ]
    if dtype != "float32":
        return src + [
            f"  for (int q = threadIdx.x; q < {FR * FC}; q += kThreads) {{",
            f"    const int i = q / {FC}, j = q - i * {FC}, gr = r0 + i - H;",
            *[f"    {line}" for line in scalar],
            "  }",
        ]
    j0 = H % 4  # first frame column whose grid column is a multiple of 4
    nq = (FC - j0) // 4
    ns = FC - 4 * nq
    per_row = nq + ns
    return src + [
        f"  for (int q = threadIdx.x; q < {FR * per_row}; q += kThreads) {{",
        f"    const int i = q / {per_row}, u = q - i * {per_row}, gr = r0 + i - H;",
        f"    if (u < {nq}) {{",
        f"      const int j = {j0} + 4 * u, gc = c0 + j - H;",
        f"      if ((aligned >> {i} & 1) && {live} && j >= {lo} && j + 4 <= {hi_c} &&",
        "          gc >= 0 && gc + 4 <= cols) {",
        f"        copy16(F{frame} + i * LD + j,",
        f"               I{i} + plane + static_cast<long long>(gr) * cols + gc);",
        "      } else {",
        "        for (int e = 0; e < 4; ++e) {",
        f"          const bool ok = {live} && j + e >= {lo} && j + e < {hi_c} &&",
        "                          gc + e >= 0 && gc + e < cols;",
        f"          F{frame}[i * LD + j + e] = ok ? I{i}[plane + static_cast<long long>(gr) * "
        "cols + gc + e] : 0.0f;",
        "        }",
        "      }",
        "    } else {",
        f"      const int v = u - {nq}, j = v < {j0} ? v : {4 * nq} + v;",
        *[f"      {line}" for line in scalar],
        "    }",
        "  }",
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
    if program.ndim == 1:
        return render_1d(program, dtypes[0], tile)
    plan = frame_plan(program)
    if tile.halo != program.radius or tile.buffers != plan.n_frames:
        raise ValueError(
            f"tile plan {tile} does not match program radius {program.radius} "
            f"and {plan.n_frames} frames"
        )
    H = program.radius
    TR, TC = tile.rows, tile.cols
    FR, FC = TR + 2 * H, TC + 2 * H
    LD, SHIFT, FSTRIDE = program_frame_layout(TR, TC, H)
    halos = program.exchange_radii()
    out_index = {f: k for k, f in enumerate(program.outputs)}
    ctype = dict(zip(program.inputs, (CTYPES[d] for d in dtypes)))
    last = plan.sweeps[-1]
    if last.inset + last.program.radius > H:
        raise ValueError(f"the chain of {program.name!r} is deeper than its radius {H}")

    body: list[str] = []
    n_sync = 0
    for s, sweep in enumerate(plan.sweeps):
        p, e = sweep.program, sweep.inset
        margins = p.margins()
        for name in sweep.materialized:
            loop = _Loop(sweep, LD)
            value = loop.value(name)
            (lo_r, lo_c), (hi_r, hi_c) = margins[name]
            inl = [n for n in sweep.inlined if n in loop.locals]
            body.append(f"  // sweep {s}, op {name!r}: {loop.ops[name].tag}"
                        + (f"; inlined: {', '.join(inl)}" if inl else ""))
            body += loop.render((e + lo_r, FR - e - hi_r), (e + lo_c, FC - e - hi_c), [],
                                [f"F{sweep.env[name]}[p] = {value};"])
            body.append("  __syncthreads();")
            n_sync += 1
        r = p.radius
        is_last = sweep is last
        loop = _Loop(sweep, LD)
        values = [(field, old, new, loop.view(op_name, (0, 0)) if op_name in sweep.materialized
                   else loop.value(op_name)) for field, op_name, old, new in sweep.updates]
        inl = [n for n in sweep.inlined if n in loop.locals]
        body.append(f"  // sweep {s}: next state of {', '.join(f for f, *_ in values)}, "
                    f"ring of radius {r} kept at absolute indices"
                    + (f"; inlined: {', '.join(inl)}" if inl else ""))
        lines = [f"const bool ring = gr < {r} || gr >= rows_global - {r} || "
                 f"gc < {r} || gc >= cols_global - {r};"]
        stores = []
        for k, (field, old, new, value) in enumerate(values):
            keep = _tap(old, 0, 0) if loop.has_tap(old) else f"F{old}[p]"
            if new is not None:
                lines.append(f"F{new}[p] = ring ? {keep} : {value};")
            else:
                f = field if len(program.outputs) > 1 else program.passthrough
                lines.append(f"const float n{k} = ring ? {keep} : {value};")
                stores.append(f"  O{out_index[f]}[g] = from_f32<{ctype[f]}>(n{k});  // store {f!r}")
        head = ["const int gc = col_offset + c0 + j - H;"]
        if is_last:
            lines = ["const int gr = row_offset + r0 + i0 + s - H;", *lines,
                     "if (r0 + i0 + s - H < rows && c0 + j - H < cols) {",
                     "  const long long g = plane + static_cast<long long>(r0 + i0 + s - H) * "
                     "cols + c0 + j - H;", *stores, "}"]
            body += loop.render((H, H + TR), (H, H + TC), head, lines)
        else:
            lines = ["const int gr = row_offset + r0 + i0 + s - H;", *lines]
            body += loop.render((e + r, FR - e - r), (e + r, FC - e - r), head, lines)
            body.append("  __syncthreads();")
            n_sync += 1

    src = [
        "// Generated by repro_torch.ir.codegen_cuda; do not edit.",
        "// K2 stencil_program_cuda: replaces the JAX package's",
        "// repro/ir/lower_pallas.py::lower_pallas (_generic_kernel).",
        "// Bound on an H100: device-memory bytes, each input read once and each",
        "// output written once per launch of all k sweeps, (inputs + outputs) x",
        "// D*R*C x itemsize; the ops' flops per point are far below the card's",
        "// FP32 rate per byte. Design: each field is copied once per tile (plus",
        "// its own halo, mostly from L2) into shared memory, 16-byte cp.async",
        "// where aligned; ops read by one consumer at offset 0 are inlined into",
        "// it, the rest get a frame; each thread walks a run of rows down a",
        "// column with its taps in registers; the last sweep stores each output",
        "// from registers, once. What is left to bound it: shared-memory words",
        "// per point (the frames' writes and the taps' reads) and the barriers.",
        f"// fingerprint: {program.fingerprint()}",
        "// inputs: "
        + ", ".join(f"{f}:{d}(halo {halos[f]})" for f, d in zip(program.inputs, dtypes)),
        "// outputs: " + ", ".join(program.outputs),
        f"// tile: {TR}x{TC}  chain halo: {H}  frames: {plan.n_frames}"
        f"  sweeps: {program.steps}  barriers: {n_sync + 1}",
        '#include "stencil_common.cuh"',
        "",
        "namespace {",
        "using repro_torch::from_f32;",
        "using repro_torch::kThreads;",
        "using repro_torch::limit_flux;",
        *(["using repro_torch::limit_gate;"] if any("limit_gate(" in b for b in body) else []),
        "using repro_torch::to_f32;",
        f"constexpr int TR = {TR}, TC = {TC}, H = {H};",
        f"constexpr int LD = {LD};  // frame row stride: TC + 2H padded to a multiple of 4",
        f"constexpr int FSTRIDE = {FSTRIDE}, SHIFT = {SHIFT};",
        f"constexpr int NFRAMES = {plan.n_frames};",
        "",
        "__device__ __forceinline__ void copy16(float* dst, const float* src) {",
        "  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));",
        '  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" :: "r"(d), "l"(src));',
        "}",
        "",
        "__global__ void __launch_bounds__(kThreads) stencil_program(",
    ]
    params = [f"    const {ctype[f]}* __restrict__ I{i}" for i, f in enumerate(program.inputs)]
    params += [f"    {ctype[f]}* __restrict__ O{k}" for k, f in enumerate(program.outputs)]
    params += ["    int rows, int cols, int row_offset, int rows_global, int col_offset, "
               "int cols_global, int aligned) {"]
    src += [",\n".join(params)]
    src += [
        "  extern __shared__ __align__(16) float smem[];",
        "  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;",
        "  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;",
        *[f"  float* const F{n} = smem + {n} * FSTRIDE + SHIFT;" for n in range(plan.n_frames)],
        "",
    ]
    for i, f in enumerate(program.inputs):
        src += _load_field(f, i, plan.input_frames[f], dtypes[i], halos[f], H, FR, FC)
    src += ['  asm volatile("cp.async.wait_all;\\n" ::);', "  __syncthreads();"]
    src += body
    src += [
        "}",
        "",
        "}  // namespace",
        "",
        "// C launcher bound with ctypes; returns the CUDA error code (0 = ok).",
        'extern "C" int launch(',
    ]
    args = [f"    const void* I{i}" for i in range(len(program.inputs))]
    args += [f"    void* O{k}" for k in range(len(program.outputs))]
    args += ["    int depth, int rows, int cols, int row_offset, int rows_global, "
             "int col_offset, int cols_global, void* stream) {"]
    src += [",\n".join(args)]
    call = [f"static_cast<const {ctype[f]}*>(I{i})" for i, f in enumerate(program.inputs)]
    call += [f"static_cast<{ctype[f]}*>(O{k})" for k, f in enumerate(program.outputs)]
    call += ["rows", "cols", "row_offset", "rows_global", "col_offset", "cols_global",
             "aligned"]
    flags = [f"(reinterpret_cast<uintptr_t>(I{i}) % 16 == 0 ? {1 << i} : 0)"
             for i, d in enumerate(dtypes) if d == "float32"]
    src += [
        "  static size_t reserved = 0;",
        "  const size_t smem = sizeof(float) * FSTRIDE * NFRAMES;",
        "  const int err = repro_torch::reserve_smem(stencil_program, smem, reserved);",
        "  if (err) return err;",
        "  // bit i: input i is float32, 16-byte aligned, and rows are a multiple of 4 words",
        "  const int aligned = cols % 4 ? 0 : " + (" | ".join(flags) if flags else "0") + ";",
        "  const dim3 grid((cols + TC - 1) / TC, (rows + TR - 1) / TR, depth);",
        "  stencil_program<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(",
        "      " + ", ".join(call) + ");",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
    ]
    return "\n".join(src)




# K5''s 16-byte vector loads and stores, per input dtype: whole where the
# pointer is 16-byte aligned and the vector lies inside the field, word by
# word otherwise (zero outside the field on loads). bfloat16 is widened to
# float32 as it loads and rounded once, as it stores.
_VECTOR_IO = {
    "float32": """\
__device__ __forceinline__ void load_vector(const float* __restrict__ in, long long g,
                                            long long total, bool whole, float* x) {
  if (whole && g >= 0 && g + V <= total) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(in + g));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = g + e >= 0 && g + e < total ? in[g + e] : 0.0f;
  }
}

__device__ __forceinline__ void store_vector(float* __restrict__ out, long long g,
                                             long long total, bool whole, const float* y) {
  if (whole && g + V <= total) {
    *reinterpret_cast<float4*>(out + g) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (g + e < total) out[g + e] = y[e];
    }
  }
}""",
    "bfloat16": """\
__device__ __forceinline__ void load_vector(const __nv_bfloat16* __restrict__ in, long long g,
                                            long long total, bool whole, float* x) {
  if (whole && g >= 0 && g + V <= total) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(in + g));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = g + e >= 0 && g + e < total ? __bfloat162float(in[g + e]) : 0.0f;
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(from_f32<__nv_bfloat16>(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(from_f32<__nv_bfloat16>(hi))) << 16;
}

__device__ __forceinline__ void store_vector(__nv_bfloat16* __restrict__ out, long long g,
                                             long long total, bool whole, const float* y) {
  if (whole && g + V <= total) {
    *reinterpret_cast<uint4*>(out + g) = make_uint4(
        pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (g + e < total) out[g + e] = from_f32<__nv_bfloat16>(y[e]);
    }
  }
}""",
}


def _positions_1d(p: StencilProgram, points: int) -> dict[str, list[int]]:
    """For each live op of sweep ``p`` and for its input, the positions
    (relative to a thread's first point) at which a thread computing the
    output at ``0 .. points - 1`` needs it, sorted."""
    need: dict[str, set[int]] = {p.output: set(range(points))}
    for op in reversed(p.ops):
        for r in op.reads if op.name in need else ():
            need.setdefault(r.field, set()).update(q + r.offset[0] for q in need[op.name])
    return {f: sorted(qs) for f, qs in need.items()}


def _sweep_1d(s: int, p: StencilProgram, points: int, frame: int | None) -> list[str]:
    """One sweep of K5' over a thread's ``points`` state values ``x[]``: the
    neighbours it reads from frame ``frame`` (``None``: from the warp's
    other lanes, by shuffles), every live op at every position its readers
    need (straight-line code, each value once), then the next state, the
    end points of radius ``r`` kept by absolute column."""
    need = _positions_1d(p, points)
    state = p.inputs[0]
    index = {op.name: i for i, op in enumerate(p.ops)}

    def at(field: str, q: int) -> str:
        if field != state:
            return f"v{index[field]}_{'m' if q < 0 else ''}{abs(q)}"
        if q < 0:
            return f"l{-q}"
        return f"x[{q}]" if q < points else f"r{q - points + 1}"

    nbrs = [q for q in need.get(state, []) if not 0 <= q < points]
    lines = [f"  {{  // sweep {s}: " + "; ".join(f"{op.name!r} {op.tag}" for op in p.ops
                                               if op.name in need)]
    if nbrs and frame is not None:
        lines.append("    const float " + ", ".join(
            f"{at(state, q)} = F{frame}[b {'-' if q < 0 else '+'} {abs(q)}]" for q in nbrs) + ";")
    for q in nbrs if frame is None else ():
        lane, i = divmod(q, points)  # the lane that holds it, and where
        shfl = "__shfl_up_sync" if lane < 0 else "__shfl_down_sync"
        lines.append(f"    const float {at(state, q)} = {shfl}(0xffffffffu, x[{i}], {abs(lane)});")
    for op in p.ops:
        for q in need.get(op.name, ()):
            value = op.emit(*(at(r.field, q + r.offset[0]) for r in op.reads))
            lines.append(f"    const float {at(op.name, q)} = {value};")
    r = p.radius
    for q in range(points):
        new = at(p.output, q)
        if r:
            new = f"(c[{q}] < {r} || c[{q}] >= n - {r}) ? x[{q}] : {new}"
        lines.append(f"    x[{q}] = {new};")
    return lines + ["  }"]


def render_1d(program: StencilProgram, dtype: str, tile: TilePlan) -> str:
    """K5': the fused kernel of a single-input 1-D program over a ``(batch,
    n)`` field, the Hopper counterpart of ``lower_pallas.py::_kernel_1d``.

    The field is one flat array of ``batch * n`` points, cut into spans of
    ``P`` points a thread (``tile.cols`` 16-byte vectors) whatever rows a
    span crosses, overlapping by the chain halo rounded up to whole
    vectors, ``HP``: a span's threads store it but its first and last
    ``HP`` points. Each thread loads its points into registers by 16-byte
    vectors and keeps them there through every sweep; it computes every op
    at the positions its readers need and keeps the end points of radius
    ``r`` of every row by absolute column ``f mod n`` — what ``_kernel_1d``
    does on its whole row. A point that is no end point reads only its own
    row through the whole chain, so the values a span computes across a
    row boundary reach only end points (which keep their old value) and
    halo points (which are not stored).

    ``tile.buffers`` picks the span (:func:`repro_torch.ir.plan.plan_tile_1d`):
    0, a warp's: its lanes exchange neighbours by shuffles, with no shared
    memory and no barrier; 1 or 2, a block's: neighbours go through a
    shared frame (two, taking turns, for several sweeps), one barrier a
    sweep."""
    if tile.halo != program.radius or tile.buffers not in (0, 1 if program.steps == 1 else 2):
        raise ValueError(f"tile plan {tile} does not match program radius "
                         f"{program.radius} and {program.steps} sweeps")
    (field,) = program.inputs
    ctype = CTYPES[dtype]
    H = program.radius
    V = 4 if dtype == "float32" else 8
    P = V * tile.cols
    SPANS = 1 if tile.buffers else THREADS // 32  # spans a block holds
    S = THREADS // SPANS * P
    HP = -(-H // V) * V
    PAD = -(-max(p.radius for p in program.chain) // 4) * 4 if tile.buffers else 0
    if S - 2 * HP <= 0:
        raise ValueError(f"a chain halo of {H} leaves a {S}-point span nothing to store")
    frames = range(tile.buffers)
    body = []
    for s, p in enumerate(program.chain):
        body += _sweep_1d(s, p, P, s % 2 if frames else None)
        if s < program.steps - 1 and frames:
            body += [f"  put_frame(F{(s + 1) % 2} + b, x);", "  __syncthreads();"]
    barriers = program.steps if frames else 0
    src = [
        "// Generated by repro_torch.ir.codegen_cuda; do not edit.",
        "// K5' stencil_program_1d_cuda: replaces the JAX package's",
        "// repro/ir/lower_pallas.py::_lower_pallas_1d (_kernel_1d).",
        "// Bound on an H100: device-memory bytes, the (batch, n) field read once",
        "// and written once per launch of all k sweeps; the ops' flops per point",
        "// are far below the card's FP32 rate per byte. Design: the field is one",
        "// flat array cut into overlapping spans, one a warp or one a block,",
        "// whatever rows a span crosses; each thread loads and stores 16-byte",
        "// vectors and keeps its points in registers through every sweep,",
        "// computing each op where its readers need it; a sweep exchanges only",
        "// the neighbours: by shuffles (warp spans, no barrier) or through a",
        "// shared frame with one barrier (block spans); the end-point rule is a",
        "// select on each point's column, computed once a thread.",
        f"// fingerprint: {program.fingerprint()}",
        f"// input: {field}:{dtype}(halo {H})",
        f"// span: {S} points, {P} a thread, {SPANS} a block; chain halo: {H}"
        f"  frames: {tile.buffers}  sweeps: {program.steps}  barriers: {barriers}",
        '#include "stencil_common.cuh"',
        "",
        "namespace {",
        "using repro_torch::from_f32;",
        "using repro_torch::kThreads;",
        "using repro_torch::limit_flux;",
        *(["using repro_torch::limit_gate;"] if any("limit_gate(" in b for b in body) else []),
        f"constexpr int V = {V};  // points a 16-byte vector holds",
        f"constexpr int P = {P};  // points a thread holds: {tile.cols} vector(s)",
        f"constexpr int SPANS = {SPANS};  // spans a block holds: one a warp, or one",
        "constexpr int S = kThreads / SPANS * P;  // points a span holds",
        f"constexpr int H = {H};  // chain halo: the sweeps' radii added up",
        f"constexpr int HP = {HP};  // H in whole vectors: the span's ends, which neighbours store",
        f"constexpr int PAD = {PAD};  // words beside each frame: the widest sweep's reach",
        "constexpr int FSTRIDE = S + 2 * PAD;",
        f"constexpr int NFRAMES = {tile.buffers};",
        "",
        _VECTOR_IO[dtype],
        "",
    ]
    if frames:
        src += [
            "__device__ __forceinline__ void put_frame(float* dst, const float* x) {",
            "#pragma unroll",
            "  for (int u = 0; u < P / 4; ++u) {",
            "    reinterpret_cast<float4*>(dst)[u] =",
            "        make_float4(x[4 * u], x[4 * u + 1], x[4 * u + 2], x[4 * u + 3]);",
            "  }",
            "}",
            "",
        ]
    src += [
        "__global__ void __launch_bounds__(kThreads) stencil_program_1d(",
        f"    const {ctype}* __restrict__ I0, {ctype}* __restrict__ O0, long long total, int n,",
        "    int aligned) {",
        *(["  extern __shared__ __align__(16) float smem[];"] if frames else []),
        *[f"  float* const F{k} = smem + {k} * FSTRIDE + PAD;" for k in frames],
        "  // The thread's first point in its span, and in the field.",
        "  const int b = threadIdx.x % (kThreads / SPANS) * P;",
        "  const long long span =",
        "      static_cast<long long>(blockIdx.x) * SPANS + threadIdx.x / (kThreads / SPANS);",
        "  const long long f = span * (S - 2 * HP) - HP + b;",
        "  // Each point's column, for the end-point rule: one division a thread.",
        "  int c[P];",
        "  c[0] = static_cast<int>(f % n);",
        "  if (c[0] < 0) c[0] += n;",
        "#pragma unroll",
        "  for (int j = 1; j < P; ++j) c[j] = c[j - 1] + 1 == n ? 0 : c[j - 1] + 1;",
        f"  // load {field!r}, zero outside the field",
        "  float x[P];",
        "#pragma unroll",
        "  for (int u = 0; u < P / V; ++u) load_vector(I0, f + u * V, total, aligned & 1, x + u * V);",
    ]
    if PAD:
        src += [
            "  for (int q = threadIdx.x; q < PAD; q += kThreads) {",
            *[f"    F{k}[-1 - q] = 0.0f, F{k}[S + q] = 0.0f;" for k in frames],
            "  }",
        ]
    if frames:
        src += ["  put_frame(F0 + b, x);", "  __syncthreads();"]
    src += body
    src += [
        "  // store: the span but its ends, one vector at a time",
        "#pragma unroll",
        "  for (int u = 0; u < P / V; ++u) {",
        "    if (b + u * V >= HP && b + u * V < S - HP) {",
        f"      store_vector(O0, f + u * V, total, aligned & 2, x + u * V);  // store {field!r}",
        "    }",
        "  }",
        "}",
        "",
        "}  // namespace",
        "",
        "// C launcher bound with ctypes; returns the CUDA error code (0 = ok).",
        'extern "C" int launch(const void* I0, void* O0, int batch, int n, void* stream) {',
        "  static size_t reserved = 0;",
        "  const size_t smem = sizeof(float) * FSTRIDE * NFRAMES;",
        "  const int err = repro_torch::reserve_smem(stencil_program_1d, smem, reserved);",
        "  if (err) return err;",
        "  const long long total = static_cast<long long>(batch) * n;",
        "  const long long spans = (total + S - 2 * HP - 1) / (S - 2 * HP);",
        "  const long long blocks = (spans + SPANS - 1) / SPANS;",
        "  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);",
        "  // bit 0: the input is 16-byte aligned; bit 1: the output is",
        "  const int aligned = (reinterpret_cast<uintptr_t>(I0) % 16 == 0 ? 1 : 0) |",
        "                      (reinterpret_cast<uintptr_t>(O0) % 16 == 0 ? 2 : 0);",
        "  stencil_program_1d<<<static_cast<unsigned>(blocks), kThreads, smem,",
        "                       static_cast<cudaStream_t>(stream)>>>(",
        f"      static_cast<const {ctype}*>(I0), static_cast<{ctype}*>(O0), total, n, aligned);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
    ]
    return "\n".join(src)
