"""Fused-CUDA lowering: one generated Hopper kernel per 2-D IR program (K2).

The port of ``repro/ir/lower_pallas.py::lower_pallas``: :func:`lower_cuda`
takes the same program and ``block_rows`` and returns ``x -> program(x)``
for a bare ``(depth, rows, cols)`` tensor or a ``{field: tensor}`` mapping,
returning a tensor or ``{field: tensor}`` like the JAX lowering. The
Pallas-only knobs have no counterpart (``interpret``; ``vmem_budget``,
which the shared-memory tile planner replaces), and the column-slab mode
(``cols_global`` / ``col_offset``) arrives with the distributed lowering
(ROADMAP M9): standalone calls pass ``(0, rows, 0, cols)`` to the kernel.

On CUDA tensors the call launches :func:`stencil_program_cuda`, the kernel
:mod:`repro_torch.ir.codegen_cuda` renders from the op list. It is compiled
once per ``(fingerprint(), dtypes, tile)`` and cached in memory here and on
disk by :mod:`repro_torch.kernels._build`. On CPU tensors the call computes
:func:`stencil_program_plain`, the kernel's plain version — what the Pallas
kernel computes too: all k sweeps of the chain in float32 over the whole
grid (``slab_sweep``), cast to each field's dtype at the end. For float32
inputs that equals ``apply_program``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Mapping

import torch

from repro_torch.ir.codegen_cuda import frame_plan, kernel_name, render
from repro_torch.ir.evaluate import resolve_field_arrays, slab_sweep
from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.plan import TilePlan, plan_tile
from repro_torch.kernels import _build

Tensor = torch.Tensor
KERNEL = "stencil_program_cuda"
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_KERNELS: dict[tuple, object] = {}


def stencil_program_plain(program: StencilProgram, arrays) -> Tensor | dict[str, Tensor]:
    """K2's plain version: the program's chain over the whole grid via
    ``slab_sweep`` in float32 (rows zero-padded by the chain radius, the
    column ring local), each output cast to its field's dtype."""
    h = program.radius
    rows = arrays[0].shape[-2]
    padded = {
        f: torch.nn.functional.pad(a.to(torch.float32), (0, 0, h, h))
        for f, a in zip(program.inputs, arrays)
    }
    dtypes = {f: a.dtype for f, a in zip(program.inputs, arrays)}
    out_fields = tuple(program.outputs)
    states = {f: padded.pop(f) for f in out_fields}
    state = states[program.passthrough] if len(out_fields) == 1 else states
    vals = slab_sweep(program, state, -h, rows, extras=padded or None)
    if len(out_fields) == 1:
        return vals.to(dtypes[program.passthrough])
    return {f: vals[f].to(dtypes[f]) for f in out_fields}


@functools.lru_cache(maxsize=256)
def tile_for(program: StencilProgram, rows: int, cols: int,
             block_rows: int | None = None) -> TilePlan:
    """The shared-memory tile the kernel for ``program`` uses on a grid
    (cached: programs hash by fingerprint, and planning the frames walks
    the whole chain, which would cost more host time than a launch)."""
    return plan_tile(
        rows, cols, halo=program.radius, buffers=frame_plan(program).n_frames,
        block_rows=block_rows,
    )


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
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _KERNELS[key] = fn
    return fn


def stencil_program_cuda(
    program: StencilProgram, arrays, *, block_rows: int | None = None
) -> Tensor | dict[str, Tensor]:
    """K2: one launch of the program's fused kernel over CUDA tensors
    ``arrays`` (one per ``program.inputs``, one grid, float32 or bfloat16,
    contiguous). CPU tensors take :func:`stencil_program_plain`."""
    if arrays[0].device.type == "cpu":
        return stencil_program_plain(program, arrays)
    device = arrays[0].device
    for f, a in zip(program.inputs, arrays):
        _build.check_input(KERNEL, a, tuple(_DTYPE_NAMES), field=f"field {f!r}")
        if a.device != device:
            raise ValueError(f"{KERNEL}: field {f!r} is on {a.device}, not {device}")
    depth, rows, cols = arrays[0].shape
    dtypes = tuple(_DTYPE_NAMES[a.dtype] for a in arrays)
    outs = {f: torch.empty_like(arrays[program.inputs.index(f)]) for f in program.outputs}
    if arrays[0].numel():
        tile = tile_for(program, rows, cols, block_rows)
        fn = _kernel(program, dtypes, tile)
        ptrs = [a.data_ptr() for a in arrays] + [o.data_ptr() for o in outs.values()]
        with torch.cuda.device(device):
            code = fn(*ptrs, depth, rows, cols, 0, rows, 0, cols,
                      torch.cuda.current_stream().cuda_stream)
        _build.check_launch(KERNEL, code)
    if len(outs) == 1:
        return outs[program.passthrough]
    return outs


def lower_cuda(
    program: StencilProgram, *, block_rows: int | None = None
) -> Callable[[Tensor | Mapping[str, Tensor]], Tensor | dict[str, Tensor]]:
    """Builds ``x -> program(x)`` as one fused CUDA kernel launch.

    ``block_rows`` fixes the tile rows of a block; like ``lower_pallas`` it
    must divide ``rows`` and be at least the chain halo, so the two APIs
    accept the same calls (the kernel itself masks ragged tiles, and the
    default planner's tiles need not divide the grid). A composed program
    (``repeat(p, k)``) runs all k sweeps in one launch. 1-D programs raise
    ``NotImplementedError``: their kernel is ROADMAP K5 (M6)."""
    if program.ndim == 1:
        raise NotImplementedError(
            f"1-D program {program.name!r}: the 1-D fused kernel is ROADMAP K5 (M6)"
        )
    if program.ndim != 2:
        raise ValueError(f"unsupported ndim {program.ndim}")
    min_block = max(program.radius, 1)

    def fn(x):
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
        return stencil_program_cuda(program, arrays, block_rows=block_rows)

    return fn
