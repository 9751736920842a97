"""Shared program evaluator: the one place offset arithmetic becomes slices.

The PyTorch counterpart of ``repro/ir/evaluate.py``. ``interior_eval``
computes a program's output on its maximal valid interior by materialising
each field on its own margin-inset region and feeding each op aligned
shifted views (plain tensor slices, so no copies until an op computes).
``apply_program`` re-embeds the interior into the full-shape grid with the
paper's boundary passthrough; ``slab_sweep`` is the per-sweep applicator the
fused kernel's plain version runs. Row and column ids are plain
``torch.arange`` vectors.
"""

from __future__ import annotations

import functools
from typing import Mapping

import torch

from repro_torch.ir.graph import StencilProgram
from repro_torch.obs import profile

Tensor = torch.Tensor


def _window(arr: Tensor, starts, sizes) -> Tensor:
    idx = (Ellipsis,) + tuple(slice(s, s + z) for s, z in zip(starts, sizes))
    return arr[idx]


def resolve_field_arrays(program: StencilProgram, x, *, ndim: int | None = None):
    """Validates a lowering input and returns one array per declared field,
    in ``program.inputs`` order — the single home of the field-mapping
    contract every backend shares.

    ``x`` is a bare array (single-input programs only) or a
    ``{field: array}`` mapping covering every declared input; all arrays
    must share one grid, and ``ndim`` (when given) pins the expected array
    rank (e.g. 3 for the ``(depth, rows, cols)`` kernels). Works for torch
    tensors and numpy arrays alike.
    """
    fields = program.inputs
    if isinstance(x, Mapping):
        missing = [f for f in fields if f not in x]
        if missing:
            raise ValueError(
                f"program {program.name!r} field mapping is missing "
                f"input(s) {missing}; declared inputs are {list(fields)}"
            )
        arrays = tuple(x[f] for f in fields)
    else:
        if len(fields) != 1:
            raise ValueError(
                f"program {program.name!r} has inputs {fields}; pass a mapping"
            )
        arrays = (x,)
    for f, a in zip(fields, arrays):
        if ndim is not None and a.ndim != ndim:
            raise ValueError(
                f"expected {'(depth, rows, cols)' if ndim == 3 else f'{ndim}-D'} "
                f"for field {f!r}, got shape {tuple(a.shape)}"
            )
        if tuple(a.shape) != tuple(arrays[0].shape):
            raise ValueError(
                f"all input fields must share one grid; {f!r} has shape "
                f"{tuple(a.shape)} vs {fields[0]!r} {tuple(arrays[0].shape)}"
            )
    return arrays


def thread_chain(program: StencilProgram, x, steps):
    """Runs a composed program's per-sweep callables with the shared-field
    threading convention: the evolving (:attr:`~repro_torch.ir.graph
    .StencilProgram.outputs`) fields evolve sweep-to-sweep, every other
    input feeds each sweep unchanged. ``steps`` pairs each chain entry with
    its executor: ``[(sub_program, callable), ...]``.

    Single-output programs thread one array (and return one array);
    multi-output programs thread the ``{field: array}`` state dict.
    """
    arrays = resolve_field_arrays(program, x)
    shared = dict(zip(program.inputs, arrays))
    if len(program.outputs) > 1:
        states = {f: shared[f] for f in program.outputs}
        for p, step in steps:
            sub = {f: shared[f] for f in p.inputs if f not in p.outputs}
            sub.update(states)
            states = dict(step(sub))
        return states
    arr = shared[program.passthrough] if isinstance(x, Mapping) else arrays[0]
    for p, step in steps:
        if len(p.inputs) == 1:
            arr = step(arr)
        else:
            sub = {f: shared[f] for f in p.inputs if f != p.passthrough}
            sub[p.passthrough] = arr
            arr = step(sub)
    return arr


def op_views(op, env: Mapping[str, Tensor], margins, grid: tuple[int, ...], nd: int):
    """Aligned shifted views for one op — the single home of the
    margin/offset-to-slice arithmetic.

    ``env`` maps each read field to its materialised array (inset by that
    field's margins); ``grid`` is the source-grid extent of the trailing
    ``nd`` dims. Returns one view per declared read, all of the op's output
    shape.
    """
    lo_out, hi_out = margins[op.name]
    sizes = tuple(grid[d] - lo_out[d] - hi_out[d] for d in range(nd))
    if any(s <= 0 for s in sizes):
        raise ValueError(
            f"grid {grid} too small for program margins lo={lo_out} hi={hi_out}"
        )
    views = []
    for read in op.reads:
        in_lo, _ = margins[read.field]
        starts = tuple(lo_out[d] + read.offset[d] - in_lo[d] for d in range(nd))
        views.append(_window(env[read.field], starts, sizes))
    return views


def interior_eval_multi(
    program: StencilProgram, arrays: Mapping[str, Tensor]
) -> dict[str, Tensor]:
    """Evaluates ``program`` over source fields given on a common grid.

    ``arrays`` maps each program input to an array whose trailing ``ndim``
    dims are the grid (leading dims are batch). Returns every output field's
    interior in one DAG evaluation — ``{field: array}`` with each array on
    that OUTPUT's own maximal valid region."""
    nd = program.ndim
    for f in program.inputs:
        if f not in arrays:
            raise ValueError(f"missing input field {f!r}")
    grid = tuple(arrays[program.inputs[0]].shape[-nd:])
    margins = program.margins()

    env: dict[str, Tensor] = dict(arrays)
    traced = profile.tracing()
    for op in program.ops:
        if traced:
            # Per-op label, so a port trace (repro_torch.obs.profile) names
            # stencil ops; entered only while a trace is capturing.
            with torch.profiler.record_function(f"ir/{program.name}/{op.name}"):
                env[op.name] = op.compute(*op_views(op, env, margins, grid, nd))
        else:
            env[op.name] = op.compute(*op_views(op, env, margins, grid, nd))
    return {f: env[op_name] for f, op_name in program.outputs.items()}


def interior_eval(program: StencilProgram, arrays: Mapping[str, Tensor]) -> Tensor:
    """The :attr:`~repro_torch.ir.graph.StencilProgram.passthrough` output's
    interior — the single-output view of :func:`interior_eval_multi`."""
    return interior_eval_multi(program, arrays)[program.passthrough]


def interior_region(program: StencilProgram, grid: tuple[int, ...]) -> tuple[slice, ...]:
    """Trailing-dim slices selecting the program's interior of a full grid.

    Per the paper's convention the boundary ring is *square*: width
    ``program.radius`` in every dim."""
    r = program.radius
    return tuple(slice(r, grid[d] - r) for d in range(program.ndim))


def ring_crop(program: StencilProgram, interior: Tensor, *, output: str | None = None) -> Tensor:
    """Crops an exact-margin interior (as produced by :func:`interior_eval`
    / :func:`interior_eval_multi`) to the square radius-``r`` ring region.
    ``output`` names which output field's interior is being cropped (its own
    margins set the alignment); defaults to the passthrough output."""
    r = program.radius
    lo, hi = program.output_margins(output or program.passthrough)
    nd = program.ndim
    idx = []
    for d in range(nd):
        size = interior.shape[-nd + d] - (r - lo[d]) - (r - hi[d])
        idx.append(slice(r - lo[d], r - lo[d] + size))
    return interior[(Ellipsis,) + tuple(idx)]


def slab_step(
    program: StencilProgram,
    slab: Tensor | Mapping[str, Tensor],
    row_ids: Tensor,
    rows_total,
    col_ids: Tensor | None = None,
    cols_total=None,
    extras: Mapping[str, Tensor] | None = None,
):
    """One sweep of a (single-sweep) program over a slab — the per-step body
    of every temporal-blocked lowering.

    ``slab`` carries the program's *evolving* state: a bare ``(..., n, m)``
    array for the passthrough field, or a ``{field: array}`` dict covering
    every output field. The return mirrors the input. ``row_ids`` gives the
    GLOBAL row index of each of the ``n - 2r`` rows produced, shaped
    ``(n - 2r,)`` or ``(n - 2r, 1)``; rows whose global index falls in the
    radius-``r`` boundary ring keep each slab's current value.

    ``extras`` supplies the program's non-evolving input fields, each on the
    SAME grid as ``slab``; they are read, never written.

    Columns come in two modes: ``col_ids is None`` — full-width mode, the
    column ring is local and only rows shrink; ``col_ids`` given (with
    ``cols_total``) — column-slab mode, the slab shrinks by ``r`` in BOTH
    dims and the global column ring is applied by absolute index.
    """
    r = program.radius
    is_multi = isinstance(slab, Mapping)
    if is_multi:
        missing = [f for f in program.outputs if f not in slab]
        if missing:
            raise ValueError(
                f"slab dict is missing evolving field(s) {missing} of "
                f"program {program.name!r} (outputs: {tuple(program.outputs)})"
            )
        states = {f: slab[f] for f in program.outputs}
    else:
        states = {program.passthrough: slab}
    # States LAST: a chain entry's evolving-field name may collide with a
    # composed program's shared field, and the evolving slabs must win.
    arrays = dict(extras) if extras else {}
    arrays.update(states)
    interiors = interior_eval_multi(program, arrays)
    vals = {
        f: ring_crop(program, interiors[f], output=f) for f in program.outputs
    }
    if r == 0:
        out = {f: vals[f].to(states[f].dtype) for f in states}
        return out if is_multi else out[program.passthrough]
    keep_r = (row_ids < r) | (row_ids >= rows_total - r)
    if keep_r.ndim == 1:
        keep_r = keep_r[:, None]
    if col_ids is None:
        out = {}
        for f, s in states.items():
            cols = s.shape[-1]
            cur = s[..., r:-r, :]
            upd = cur.clone()
            upd[..., :, r : cols - r] = vals[f].to(s.dtype)
            out[f] = torch.where(keep_r, cur, upd)
        return out if is_multi else out[program.passthrough]
    keep_c = (col_ids < r) | (col_ids >= cols_total - r)
    if keep_c.ndim == 1:
        keep_c = keep_c[None, :]
    out = {}
    for f, s in states.items():
        cur = s[..., r:-r, r:-r]
        out[f] = torch.where(keep_r | keep_c, cur, vals[f].to(s.dtype))
    return out if is_multi else out[program.passthrough]


def _any_state(slab):
    """One representative array of a Tensor-or-``{field: Tensor}`` slab."""
    return next(iter(slab.values())) if isinstance(slab, Mapping) else slab


def slab_sweep(
    program: StencilProgram,
    slab: Tensor | Mapping[str, Tensor],
    row_offset: int,
    rows_total: int,
    col_offset: int | None = None,
    cols_total: int | None = None,
    extras: Mapping[str, Tensor] | None = None,
):
    """Runs ``program``'s whole chain over ``slab`` via :func:`slab_step`.

    ``row_offset`` is the global row index of the slabs' first row. The
    slabs must carry the full chain halo: output has ``2 * program.radius``
    fewer rows than the input. With ``col_offset`` / ``cols_total`` given
    the slab is column-decomposed too: columns shrink and ring-pass-through
    by ABSOLUTE index exactly like rows. ``extras`` maps the program's
    non-evolving inputs to slabs on the SAME initial grid as ``slab``; each
    sweep reads them through a view inset by the state's cumulative shrink.
    """
    base_r = row_offset
    base_c = col_offset
    state0 = _any_state(slab)
    n0, m0 = state0.shape[-2], state0.shape[-1]
    device = state0.device
    inset = 0  # cumulative state shrink vs the extras' (initial) grid
    for prog in program.chain:
        r = prog.radius
        n = _any_state(slab).shape[-2]
        ex = None
        if extras:
            if col_offset is None:
                ex = {f: a[..., inset : n0 - inset, :] for f, a in extras.items()}
            else:
                ex = {
                    f: a[..., inset : n0 - inset, inset : m0 - inset]
                    for f, a in extras.items()
                }
        ids = base_r + r + torch.arange(n - 2 * r, device=device)
        if col_offset is None:
            slab = slab_step(prog, slab, ids, rows_total, extras=ex)
        else:
            m = _any_state(slab).shape[-1]
            cids = base_c + r + torch.arange(m - 2 * r, device=device)
            slab = slab_step(prog, slab, ids, rows_total, cids, cols_total, extras=ex)
            base_c = base_c + r
        base_r = base_r + r
        inset += r
    return slab


def apply_program(program: StencilProgram, x: Tensor | Mapping[str, Tensor]):
    """Full-shape application: interior computed, boundary ring passed
    through from each evolving source field. Single-output programs return
    one array; multi-output programs return ``{field: array}``. A composed
    program applies its chain sweep by sweep, re-applying the ring
    passthrough between sweeps — the oracle semantics of ``repeat(p, k)``."""
    if program.steps > 1:
        return thread_chain(
            program, x, [(p, functools.partial(apply_program, p)) for p in program.chain]
        )
    if isinstance(x, Mapping):
        arrays = dict(x)
    else:
        if len(program.inputs) != 1:
            raise ValueError(
                f"program {program.name!r} has inputs {program.inputs}; pass a mapping"
            )
        arrays = {program.inputs[0]: x}
    interiors = interior_eval_multi(program, arrays)
    if len(program.outputs) > 1:
        return {
            f: embed_interior(program, arrays[f], interiors[f], output=f)
            for f in program.outputs
        }
    base = arrays[program.passthrough]
    return embed_interior(program, base, interiors[program.passthrough])


def embed_interior(
    program: StencilProgram, base: Tensor, interior: Tensor, *, output: str | None = None
) -> Tensor:
    """Embeds an exact-margin interior into a copy of ``base`` with the
    square-ring boundary passthrough — the single home of the embedding
    convention. ``base`` itself is left unchanged."""
    cropped = ring_crop(program, interior, output=output)
    region = interior_region(program, tuple(base.shape[-program.ndim :]))
    out = base.clone()
    out[(Ellipsis,) + region] = cropped.to(base.dtype)
    return out
