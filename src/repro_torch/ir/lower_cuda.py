"""Fused-CUDA lowering: one generated Hopper kernel per IR program (K2, K5').

The port of ``repro/ir/lower_pallas.py::lower_pallas``: :func:`lower_cuda`
takes the same program and ``block_rows`` and returns ``x -> program(x)``
for a bare ``(depth, rows, cols)`` tensor or a ``{field: tensor}`` mapping,
returning a tensor or ``{field: tensor}`` like the JAX lowering. The
Pallas-only knobs have no counterpart (``interpret``; ``vmem_budget``,
which the shared-memory tile planner replaces). Like ``lower_pallas``'s,
the callable takes keyword ``row_offset`` / ``rows_global`` /
``col_offset`` / ``cols_global``: the global placement of the tensor's
first row and column, for a halo-padded shard block of
:mod:`repro_torch.ir.lower_sharded` (K2's offset mode). Standalone calls
pass ``(0, rows, 0, cols)``. With offsets the contract is the kept region
of the block: rows ``[h, R - h)`` over the full width (row mode, no
``cols_global``) or ``[h, R - h) x [h, C - h)`` (column mode), ``h`` the
chain radius, bit-equal to the same region of the unsharded launch; the
caller slices the rest off.
A single-input 1-D program (``jacobi1d``, any 1-D chain) lowers to K5'
over a ``(batch, n)`` tensor, the port of ``_lower_pallas_1d``.

On CUDA tensors the call launches :func:`stencil_program_cuda` (2-D) or
:func:`stencil_program_1d_cuda` (1-D), the kernels
:mod:`repro_torch.ir.codegen_cuda` renders from the op list. Each is
compiled once per ``(fingerprint(), dtypes, tile)`` and cached in memory
here and on disk by :mod:`repro_torch.kernels._build`. On CPU tensors the
call computes the kernel's plain version (:func:`stencil_program_plain`,
:func:`stencil_program_1d_plain`) — what the Pallas kernel computes too:
all k sweeps of the chain in float32 over the whole grid, cast to each
field's dtype at the end. For float32 inputs that equals ``apply_program``.

Every lowered callable is wrapped in
:func:`repro_torch.obs.metrics.instrument_call` under
``ir.lower_cuda.<program>`` (the JAX package records
``ir.lower_pallas.<program>``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Mapping

import torch

from repro_torch.ir.codegen_cuda import frame_plan, kernel_name, render
from repro_torch.ir.evaluate import interior_eval, resolve_field_arrays, ring_crop, slab_sweep
from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.plan import TilePlan, plan_program_tile, plan_tile_1d
from repro_torch.kernels import _build
from repro_torch.obs import metrics

Tensor = torch.Tensor
KERNEL = "stencil_program_cuda"
KERNEL_1D = "stencil_program_1d_cuda"
# K2's N-output launches (adjoint and augmented programs, the counterpart of
# lower_pallas's N-output site), counted here as well as under KERNEL.
KERNEL_N_OUT = "stencil_program_cuda.n_outputs"
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_KERNELS: dict[tuple, object] = {}


def stencil_program_plain(
    program: StencilProgram, arrays, *, row_offset: int = 0, rows_global: int | None = None,
    col_offset: int = 0, cols_global: int | None = None,
) -> Tensor | dict[str, Tensor]:
    """K2's plain version: the program's chain over the whole grid via
    ``slab_sweep`` in float32, each output cast to its field's dtype. Rows
    are zero-padded by the chain radius and the ring kept at absolute row
    ``row_offset + i`` of ``rows_global``; without ``cols_global`` the
    column ring is local (row mode), with it columns are padded too and the
    ring kept at absolute column ``col_offset + j`` (column mode)."""
    h = program.radius
    rows = arrays[0].shape[-2]
    rows_global = rows if rows_global is None else rows_global
    col_mode = cols_global is not None
    pad = (h, h, h, h) if col_mode else (0, 0, h, h)
    padded = {
        f: torch.nn.functional.pad(a.to(torch.float32), pad)
        for f, a in zip(program.inputs, arrays)
    }
    dtypes = {f: a.dtype for f, a in zip(program.inputs, arrays)}
    out_fields = tuple(program.outputs)
    states = {f: padded.pop(f) for f in out_fields}
    state = states[program.passthrough] if len(out_fields) == 1 else states
    cols = (col_offset - h, cols_global) if col_mode else (None, None)
    vals = slab_sweep(program, state, row_offset - h, rows_global, *cols,
                      extras=padded or None)
    if len(out_fields) == 1:
        return vals.to(dtypes[program.passthrough])
    return {f: vals[f].to(dtypes[f]) for f in out_fields}


@functools.lru_cache(maxsize=256)
def tile_for(program: StencilProgram, rows: int, cols: int,
             block_rows: int | None = None) -> TilePlan:
    """The shared-memory tile the kernel for ``program`` uses on a grid
    (cached: programs hash by fingerprint, and planning the frames walks
    the whole chain, which would cost more host time than a launch). A 1-D
    program's rows are ``cols`` points long (its ``rows`` is ignored): its
    span does not depend on them, but a row too short for an op's margins
    raises here as it does in the plain version (``op_views``)."""
    if program.ndim == 1:
        for prog in program.chain:
            margins = prog.margins()
            for op in prog.ops:
                (lo,), (hi,) = margins[op.name]
                if cols - lo - hi <= 0:
                    raise ValueError(f"grid {(cols,)} too small for program margins "
                                     f"lo={(lo,)} hi={(hi,)}")
        return plan_tile_1d(halo=program.radius, steps=program.steps)
    buffers = frame_plan(program).n_frames
    return plan_program_tile(rows, cols, halo=program.radius, buffers=buffers,
                             block_rows=block_rows)


def kernel_source(program: StencilProgram, dtypes, tile: TilePlan) -> tuple[str, str]:
    """``(library name, CUDA source)`` of the program's kernel, for
    :func:`repro_torch.kernels._build.build`."""
    return kernel_name(program), render(program, dtypes, tile)


def _kernel(program: StencilProgram, dtypes: tuple[str, ...], tile: TilePlan):
    key = (program.fingerprint(), dtypes, tile.rows, tile.cols)
    fn = _KERNELS.get(key)
    if fn is None:
        fn = _build.load(*kernel_source(program, dtypes, tile)).launch
        n_ptr = len(program.inputs) + len(program.outputs)
        n_int = 2 if program.ndim == 1 else 7
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _KERNELS[key] = fn
    return fn


def stencil_program_cuda(
    program: StencilProgram, arrays, *, block_rows: int | None = None, row_offset: int = 0,
    rows_global: int | None = None, col_offset: int = 0, cols_global: int | None = None,
) -> Tensor | dict[str, Tensor]:
    """K2: one launch of the program's fused kernel over CUDA tensors
    ``arrays`` (one per ``program.inputs``, one grid, float32 or bfloat16,
    contiguous), the ring kept at the absolute indices the offsets give
    (:func:`stencil_program_plain`; in row mode the kernel's columns are
    the global ones, ``(0, cols)``). A field deeper than the grid's 65535
    planes takes consecutive launches, each counted
    (:func:`repro_torch.kernels._build.plane_chunks`). CPU tensors take
    :func:`stencil_program_plain`."""
    if arrays[0].device.type == "cpu":
        return stencil_program_plain(program, arrays, row_offset=row_offset,
                                     rows_global=rows_global, col_offset=col_offset,
                                     cols_global=cols_global)
    device = arrays[0].device
    for f, a in zip(program.inputs, arrays):
        _build.check_input(KERNEL, a, tuple(_DTYPE_NAMES), field=f"field {f!r}")
        if a.device != device:
            raise ValueError(f"{KERNEL}: field {f!r} is on {a.device}, not {device}")
    depth, rows, cols = arrays[0].shape
    rows_global = rows if rows_global is None else rows_global
    if cols_global is None:
        col_offset, cols_global = 0, cols
    dtypes = tuple(_DTYPE_NAMES[a.dtype] for a in arrays)
    outs = {f: torch.empty_like(arrays[program.inputs.index(f)]) for f in program.outputs}
    if arrays[0].numel():
        tile = tile_for(program, rows, cols, block_rows)
        fn = _kernel(program, dtypes, tile)
        bases = [(t.data_ptr(), rows * cols * t.element_size())
                 for t in (*arrays, *outs.values())]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            for first, planes in _build.plane_chunks(depth):
                code = fn(*(p + first * plane for p, plane in bases), planes, rows, cols,
                          row_offset, rows_global, col_offset, cols_global, stream)
                _build.check_launch(KERNEL, code)
                if len(outs) > 1:
                    _build.count_launch(KERNEL_N_OUT)
    if len(outs) == 1:
        return outs[program.passthrough]
    return outs


def stencil_program_1d_plain(program: StencilProgram, x: Tensor) -> Tensor:
    """K5''s plain version, ``_kernel_1d`` in PyTorch: every sweep of the
    chain in float32 over the whole ``(batch, n)`` row field, its interior
    embedded at columns ``[r, n - r)``, cast to ``x``'s dtype at the end."""
    xf = x.to(torch.float32)
    n = xf.shape[-1]
    for prog in program.chain:
        vals = ring_crop(prog, interior_eval(prog, {prog.inputs[0]: xf}))
        r = prog.radius
        if r:
            xf = xf.clone()
            xf[..., r : n - r] = vals
        else:
            xf = vals
    return xf.to(x.dtype)


def stencil_program_1d_cuda(program: StencilProgram, x: Tensor) -> Tensor:
    """K5': one launch of a 1-D program's fused kernel (all k sweeps) over a
    contiguous ``(batch, n)`` float32 or bfloat16 CUDA tensor, at any
    pointer alignment. CPU tensors take :func:`stencil_program_1d_plain`.
    Rows too short for the program raise as the plain version does."""
    if x.device.type == "cpu":
        return stencil_program_1d_plain(program, x)
    _build.check_input(KERNEL_1D, x, tuple(_DTYPE_NAMES), ndim=2)
    out = torch.empty_like(x)
    if x.numel():
        batch, n = x.shape
        fn = _kernel(program, (_DTYPE_NAMES[x.dtype],), tile_for(program, 1, n))
        with torch.cuda.device(x.device):
            code = fn(x.data_ptr(), out.data_ptr(), batch, n,
                      torch.cuda.current_stream().cuda_stream)
        _build.check_launch(KERNEL_1D, code)
    return out


def lower_cuda(
    program: StencilProgram, *, block_rows: int | None = None
) -> Callable[[Tensor | Mapping[str, Tensor]], Tensor | dict[str, Tensor]]:
    """Builds ``x -> program(x)`` as one fused CUDA kernel launch.

    ``block_rows`` fixes the tile rows of a block; like ``lower_pallas`` it
    must divide ``rows`` and be at least the chain halo, so the two APIs
    accept the same calls (the kernel itself masks ragged tiles, and the
    default planner's tiles need not divide the grid). A composed program
    (``repeat(p, k)``) runs all k sweeps in one launch. A 1-D program must
    have one input and takes a ``(batch, n)`` tensor (``block_rows`` does
    not apply), as in ``lower_pallas``.

    The 2-D callable takes keyword ``row_offset``, ``rows_global``,
    ``col_offset`` and ``cols_global`` (K2's offset mode, see the module
    docstring); ``cols_global`` selects the column mode."""
    name = f"ir.lower_cuda.{program.name}"
    if program.ndim == 1:
        if len(program.inputs) != 1:
            raise ValueError(
                "1-D CUDA lowering supports single-input programs only, "
                f"got {program.inputs}"
            )

        def fn_1d(x):
            if x.ndim != 2:
                raise ValueError(f"expected (batch, n), got shape {tuple(x.shape)}")
            return stencil_program_1d_cuda(program, x)

        return metrics.instrument_call(fn_1d, name)
    if program.ndim != 2:
        raise ValueError(f"unsupported ndim {program.ndim}")
    min_block = max(program.radius, 1)

    def fn(x, *, row_offset=0, rows_global=None, col_offset=0, cols_global=None):
        arrays = resolve_field_arrays(program, x, ndim=3)
        rows = arrays[0].shape[1]
        if block_rows is not None:
            if rows % block_rows:
                raise ValueError(f"rows={rows} not divisible by block_rows={block_rows}")
            if block_rows < min_block:
                raise ValueError(
                    f"block_rows={block_rows} < inferred row halo {min_block} for "
                    f"program {program.name!r}"
                )
        return stencil_program_cuda(program, arrays, block_rows=block_rows,
                                    row_offset=row_offset, rows_global=rows_global,
                                    col_offset=col_offset, cols_global=cols_global)

    return metrics.instrument_call(fn, name)
