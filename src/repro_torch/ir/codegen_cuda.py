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
from repro_torch.ir.plan import TilePlan, program_frame_layout

CTYPES = {"float32": "float", "bfloat16": "__nv_bfloat16"}
THREADS = 256  # repro_torch::kThreads (csrc/stencil_common.cuh)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """One sweep's frame assignment.

    ``env`` maps every field the sweep reads from shared memory (shared
    inputs, the evolving fields' current state, the ops that get a frame)
    to its frame. ``inlined`` names the ops computed in registers inside
    their one consumer; ``materialized`` the ops, in order, that get a
    frame and a loop of their own. ``updates`` lists, per evolving field,
    ``(field, producing op, state frame, next-state frame)``; the
    next-state frame is ``None`` in the last sweep of a 2-D kernel, which
    stores the output instead. A 1-D kernel (K5') inlines nothing and
    copies each producing op's frame into the state frame in place."""

    program: StencilProgram
    inset: int
    env: dict[str, int]
    inlined: tuple[str, ...]
    materialized: tuple[str, ...]
    updates: tuple[tuple[str, str, int, int | None], ...]


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Frames of the whole kernel: one per program input, then (2-D, more
    than one sweep) a second state frame per evolving field, then op
    frames shared across sweeps."""

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
    reads. 1-D programs (K5') keep one frame per op: :func:`_staged_frame_plan`."""
    if program.ndim == 1:
        return _staged_frame_plan(program)
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


def _staged_frame_plan(program: StencilProgram) -> FramePlan:
    """K5''s frames: each input gets its own frame for the whole kernel
    (the evolving one is updated in place). Within a sweep each op takes a
    free frame (or a new one) and an op's frame is released right after its
    last reader, unless it produces an evolving field's next value (those
    live until the ring step). A frame is taken before the op's dead inputs
    are released, so an op never overwrites what it reads."""
    inputs = {f: i for i, f in enumerate(program.inputs)}
    n_frames = len(inputs)
    current = {f: inputs[f] for f in program.outputs}
    sweeps = []
    inset = 0
    for p in program.chain:
        env, states = _sweep_env(program, p, current)
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
        updates = tuple((f, p.outputs[f], current[states[f]], env[p.outputs[f]])
                        for f in p.outputs)
        sweeps.append(SweepPlan(p, inset, env, (), tuple(op.name for op in p.ops), updates))
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
    plan = frame_plan(program)
    if tile.halo != program.radius or tile.buffers != plan.n_frames:
        raise ValueError(
            f"tile plan {tile} does not match program radius {program.radius} "
            f"and {plan.n_frames} frames"
        )
    if program.ndim == 1:
        return render_1d(program, dtypes[0], tile, plan)
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
            *[f"  F{state}[p] = F{new}[p];" for _, _, state, new in sweep.updates],
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
