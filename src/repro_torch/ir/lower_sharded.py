"""Sharded lowering: rows x cols domain decomposition with inferred-radius halos.

The port of ``repro/ir/lower_sharded.py`` on ``torch.distributed`` — the
paper's B-block scale-out (§3.4) driven by the graph analysis. Each rank of
a :class:`~repro_torch.dist.sharding.Mesh` owns one block of the grid; the
halo it trades with its neighbours is the program's *inferred* chain
radius (k*r for a temporally blocked ``repeat(p, k)``), and the per-shard
compute is either the generated fused kernel (``inner="cuda"``: K2 in its
offset mode, :func:`repro_torch.ir.lower_cuda.lower_cuda`; its plain
version on CPU tensors) or the eager evaluator (``inner="reference"``).

The step is SPMD, as a ``shard_map`` body sees it: it takes this rank's
block (a tensor, or ``{field: tensor}`` for multi-field programs) and
returns this rank's block of every evolving field; every rank of the mesh
calls it in the same order. :func:`repro_torch.dist.sharding.shard_param`
(spec ``(None, "rows", "cols")``) and
:func:`~repro_torch.dist.sharding.gather_blocks` cut and join global arrays
for drivers and tests.

Multi-field programs exchange halos PER FIELD at each field's composed
radius (``exchange_radii``): the evolving state moves the full chain
radius, a velocity field its own reach, and a radius-0 coefficient field
nothing. Exchanged aux fields are zero-padded up to the state's halo grid
so every field shares one coordinate system; the pads are never read into
a kept point. ``merge_exchange=True`` (the default) stacks fields of equal
(radius, dtype) along a fresh leading axis, so one message per direction
carries all of them: the same bytes, N-fold fewer messages for an N-field
coupled system; ``False`` exchanges field by field. Results are
bit-identical either way.

Domain decomposition is 2-D: ``row_axis`` and/or ``col_axis`` name mesh
axes (or ``mesh_shape=(R, C)`` builds a ("rows", "cols") mesh over the
process group), and :mod:`repro_torch.dist.halo` moves the row and col
bands and the four diagonal corners. The global boundary ring is applied
PER SWEEP at absolute row and column indices (the block's offsets), so the
zeros an edge rank pads with never reach an owned point and the k-sweep
result bit-matches k single-device sweeps.

``overlap=True`` posts the exchange, computes the halo-free interior of
the unpadded block while the bands travel, then waits and computes the
four radius-``halo`` edge bands from the padded block. Interior and bands
go through the SAME inner (K2 for ``cuda``, on contiguous copies of the
slices), so ``overlap=True`` bit-matches ``overlap=False``: an eager band
next to a kernel interior could round differently.

``boundary="zero"`` computes every owned point with zero extension beyond
the global grid (the zero pads at the grid edges ARE the extension) — the
evaluation the derived adjoint sweeps need (``repro_torch.ir.autodiff``);
single-sweep programs only.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from repro_torch.ir.evaluate import resolve_field_arrays, slab_sweep
from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.lower_cuda import lower_cuda
from repro_torch.ir.lower_reference import lower_reference
from repro_torch.obs import events, metrics

Tensor = torch.Tensor
INNERS = ("cuda", "reference")

# Sentinel: distinguishes "caller did not pass depth_axis" (defaults to
# "data", or to None when mesh_shape builds the mesh) from an explicit one.
_DEPTH_DEFAULT = "__default_depth_axis__"


def block_placement(mesh, row_axis: str | None = "rows", col_axis: str | None = "cols"):
    """``grid -> (offsets, global extents)`` of this rank's block on
    ``mesh``: a ``(rows, cols)`` block shape placed in the global grid (row
    offset ``row coordinate x rows``, global rows ``rows x row shards``,
    and the same for columns). What ``make_vjp``'s ring masks need."""
    n_row = mesh.axis_size(row_axis) if row_axis is not None else 1
    n_col = mesh.axis_size(col_axis) if col_axis is not None else 1
    i = mesh.coord(row_axis) if n_row > 1 else 0
    j = mesh.coord(col_axis) if n_col > 1 else 0

    def placement(grid):
        r, c = grid
        return (i * r, j * c), (r * n_row, c * n_col)

    return placement


def lower_sharded(
    program: StencilProgram,
    mesh=None,
    *,
    depth_axis: str | None = _DEPTH_DEFAULT,
    row_axis: str | None = None,
    col_axis: str | None = None,
    mesh_shape: tuple[int, int] | None = None,
    device=None,
    overlap: bool = False,
    inner: str = "cuda",
    merge_exchange: bool = True,
    boundary: str = "ring",
) -> Callable:
    """Builds the SPMD step ``block -> block'`` of the program (all
    ``program.steps`` sweeps) domain-decomposed over ``mesh``.

    Args:
      program: 2-D IR program; a composed program fuses its k sweeps behind
        one depth-``k*r`` halo exchange.
      mesh: a :class:`~repro_torch.dist.sharding.Mesh`; axes named by
        ``depth_axis`` / ``row_axis`` / ``col_axis``. Exclusive with
        ``mesh_shape``.
      depth_axis: mesh axis splitting dim 0 (planes, no traffic), or None.
      row_axis: mesh axis splitting dim 1 (rows), or None.
      col_axis: mesh axis splitting dim 2 (cols; corners move when rows
        are split too), or None.
      mesh_shape: ``(R, C)`` — build a ("rows", "cols") mesh over the
        initialised process group, with its backend, on ``device``
        (:mod:`repro_torch.device`: ``None`` is the card).
      overlap: compute the interior while the halo bands travel, then the
        edge bands. Bit-matches ``overlap=False``; active when the block
        keeps a non-empty interior (rows/shard > 2*halo, and cols/shard >
        2*halo when columns are split).
      inner: "cuda" (K2 in offset mode; its plain version on CPU tensors)
        or "reference" (the eager evaluator).
      merge_exchange: one message per direction for all fields of equal
        (radius, dtype) (default), or one per field.
      boundary: "ring" (the forward semantics of every lowering) or "zero"
        (zero extension beyond the grid, single-sweep programs only).
    """
    from repro_torch.dist.halo import program_exchange_radii
    from repro_torch.dist.sharding import _mesh_sizes

    if program.ndim != 2:
        raise ValueError("sharded lowering needs a 2-D program")
    if inner not in INNERS:
        raise ValueError(f"unknown inner backend {inner!r} (want one of {INNERS})")
    if boundary not in ("ring", "zero"):
        raise ValueError(f"unknown boundary mode {boundary!r}")
    if boundary == "zero" and program.steps != 1:
        raise ValueError(
            "boundary='zero' evaluates one merged DAG with zero extension; "
            "chains thread per-sweep rings — lower each chain entry "
            "separately (repro_torch.ir.autodiff does)"
        )

    if mesh_shape is not None:
        if mesh is not None:
            raise ValueError("pass either mesh or mesh_shape, not both")
        if depth_axis != _DEPTH_DEFAULT or row_axis is not None or col_axis is not None:
            raise ValueError(
                "mesh_shape fixes the mesh axes to (rows, cols) with no depth "
                "sharding; don't pass depth_axis/row_axis/col_axis with it — "
                "build the mesh yourself to name axes"
            )
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh

        if not dist.is_initialized():
            raise RuntimeError(
                "lower_sharded(mesh_shape=...) needs an initialised process group "
                "(torch.distributed.init_process_group)"
            )
        r_sh, c_sh = mesh_shape
        mesh = make_mesh((int(r_sh), int(c_sh)), ("rows", "cols"),
                         backend=str(dist.get_backend()).lower(), device=device)
        depth_axis, row_axis, col_axis = None, "rows", "cols"
    else:
        if mesh is None:
            raise ValueError("lower_sharded needs a mesh (or mesh_shape=(R, C))")
        if depth_axis == _DEPTH_DEFAULT:
            depth_axis = "data"

    sizes = _mesh_sizes(mesh)
    axes = {"depth_axis": depth_axis, "row_axis": row_axis, "col_axis": col_axis}
    for role, ax in axes.items():
        if ax is not None and ax not in sizes:
            raise ValueError(f"mesh {tuple(sizes)} has no axis {ax!r} ({role})")
    named = [ax for ax in axes.values() if ax is not None]
    if len(set(named)) != len(named):
        raise ValueError("depth_axis, row_axis and col_axis must be distinct mesh axes")
    n_row = sizes[row_axis] if row_axis is not None else 1
    n_col = sizes[col_axis] if col_axis is not None else 1

    halo = program.radius  # full chain radius; exchanged once per k sweeps
    fields = program.inputs
    state_f = program.passthrough
    out_fields = tuple(program.outputs)
    n_out = len(out_fields)
    aux_fields = tuple(f for f in fields if f not in program.outputs)
    fhalos = program_exchange_radii(program)
    col_mode = n_col > 1
    placement = block_placement(mesh, row_axis, col_axis)  # global (offsets, extents)

    if inner == "cuda":
        apply_full = lower_cuda(program)
    else:
        apply_full = lower_reference(program, mode="fused")

    def _as_dict(vals):
        return dict(vals) if isinstance(vals, Mapping) else {state_f: vals}

    def _full_input(states, aux):
        if n_out == 1 and not aux_fields:
            return states[state_f]
        return {**aux, **states}

    def _start(env):
        """Posts one exchange round for every field with a nonzero
        exchanged radius; returns ``wait() -> {field: padded block}``."""
        from repro_torch.dist.halo import start_exchange

        need = [f for f in fields if fhalos[f]]
        if merge_exchange:
            groups: dict[tuple, list[str]] = {}
            for f in need:
                groups.setdefault((fhalos[f], env[f].dtype), []).append(f)
            grouped = list(groups.items())
        else:
            grouped = [((fhalos[f], env[f].dtype), [f]) for f in need]
        items = [
            (env[grp[0]] if len(grp) == 1 else torch.stack([env[f] for f in grp]), hf)
            for (hf, _dt), grp in grouped
        ]
        rnd = start_exchange(items, mesh, row_axis, col_axis, pad_cols=col_mode)

        def wait():
            out = {}
            for ((_, _), grp), padded in zip(grouped, rnd.wait()):
                if len(grp) == 1:
                    out[grp[0]] = padded
                else:
                    for j, f in enumerate(grp):
                        out[f] = padded[j]
            return out

        return wait

    def _pad_to_halo(a: Tensor, hf: int) -> Tensor:
        """Zero-pads a radius-``hf`` block out to the state's ``halo`` grid
        (rows always; cols too when columns are split)."""
        pw = halo - hf
        if pw == 0:
            return a
        return torch.nn.functional.pad(a, (pw, pw, pw, pw) if col_mode else (0, 0, pw, pw))

    def _inner(states, aux, row0, col0, r_glob, c_glob):
        """One inner sweep over blocks whose first row/col sit at global
        ``(row0, col0)``: the program's full output on the K2 path (the
        caller crops), or ``slab_sweep``'s shrunk output on the reference
        path. Returns ``{output field: tensor}``."""
        if inner == "cuda":
            kw = dict(row_offset=row0, rows_global=r_glob)
            if col_mode:
                kw.update(col_offset=col0, cols_global=c_glob)
            return _as_dict(apply_full(_full_input(states, aux), **kw))
        state = states[state_f] if n_out == 1 else states
        cols = (col0, c_glob) if col_mode else (None, None)
        return _as_dict(slab_sweep(program, state, row0, r_glob, *cols, extras=aux or None))

    def _crop(vals):
        """The kept region of a K2 output: ``halo`` off each side of the rows
        (and of the cols in column mode). ``slab_sweep`` (the reference
        path) has already shrunk its output by as much."""
        if inner != "cuda":
            return vals
        cs = slice(halo, -halo) if col_mode else slice(None)
        return {f: v[..., halo:-halo, cs] for f, v in vals.items()}

    def _edge_bands(padded_states, padded_aux, off_r, off_c, r_glob, c_glob, r_loc, c_loc):
        """The four radius-``halo`` edge bands of the block's output, each
        one inner sweep over a contiguous copy of a slice of the padded
        blocks (top/bottom span all owned cols; left/right the rows
        between them)."""
        h = halo

        def sweep(rows_sl, cols_sl, row0, col0):
            slabs = {f: a[..., rows_sl, cols_sl].contiguous() for f, a in padded_states.items()}
            ex = {f: a[..., rows_sl, cols_sl].contiguous() for f, a in padded_aux.items()}
            return _crop(_inner(slabs, ex, row0, col0, r_glob, c_glob))

        full = slice(None)
        top = sweep(slice(None, 3 * h), full, off_r - h, off_c - h)
        bottom = sweep(slice(-3 * h, None), full, off_r + r_loc - 2 * h, off_c - h)
        if not col_mode:
            return top, bottom, None, None
        left = sweep(slice(h, h + r_loc), slice(None, 3 * h), off_r, off_c - h)
        right = sweep(slice(h, h + r_loc), slice(-3 * h, None), off_r, off_c + c_loc - 2 * h)
        return top, bottom, left, right

    def _ret(vals):
        if n_out == 1:
            return vals[state_f].contiguous()
        return {f: vals[f].contiguous() for f in out_fields}

    def local_step(arrays):
        env = dict(zip(fields, arrays))
        states = {f: env[f] for f in out_fields}
        aux = {f: env[f] for f in aux_fields}
        if halo == 0 or (boundary == "ring" and n_row == 1 and n_col == 1):
            # The whole grid is local (or there is no spatial coupling): the
            # single-device lowering's boundary handling is already correct.
            return _ret(_as_dict(apply_full(_full_input(states, aux))))
        block = states[state_f]
        r_loc, c_loc = block.shape[-2], block.shape[-1]

        if boundary == "zero":
            # Every owned point from the exchanged block; the zero pads at
            # the grid edges are the wanted extension, so the kernel's own
            # ring (on the padded block) lands in the sliced-off frame.
            exchanged = _start(env)()
            zs = {f: exchanged[f] for f in out_fields}
            za = {f: _pad_to_halo(exchanged.get(f, aux[f]), fhalos[f]) for f in aux_fields}
            if not col_mode:
                zs = {f: torch.nn.functional.pad(a, (halo, halo)) for f, a in zs.items()}
                za = {f: torch.nn.functional.pad(a, (halo, halo)) for f, a in za.items()}
            vals = _as_dict(apply_full(_full_input(zs, za)))
            return _ret({
                f: vals[f][..., halo : halo + r_loc, halo : halo + c_loc].to(states[f].dtype)
                for f in out_fields
            })

        (off_r, off_c), (r_glob, c_glob) = placement((r_loc, c_loc))
        can_overlap = overlap and r_loc > 2 * halo and (not col_mode or c_loc > 2 * halo)
        wait = _start(env)
        if can_overlap:
            # The interior reads only the unpadded blocks: it runs while the
            # bands travel.
            interior = _crop(_inner(states, aux, off_r, off_c, r_glob, c_glob))
        exchanged = wait()
        padded_states = {f: exchanged[f] for f in out_fields}
        padded_aux = {f: _pad_to_halo(exchanged.get(f, aux[f]), fhalos[f]) for f in aux_fields}
        if not can_overlap:
            vals = _crop(_inner(padded_states, padded_aux, off_r - halo, off_c - halo,
                                r_glob, c_glob))
            return _ret({f: vals[f].to(states[f].dtype) for f in out_fields})
        top, bottom, left, right = _edge_bands(
            padded_states, padded_aux, off_r, off_c, r_glob, c_glob, r_loc, c_loc
        )
        out = {}
        for f in out_fields:
            mid = interior[f]
            if col_mode:
                mid = torch.cat([left[f], mid, right[f]], dim=-1)
            out[f] = torch.cat([top[f], mid, bottom[f]], dim=-2).to(states[f].dtype)
        return _ret(out)

    def _record_halo_model(arrays) -> None:
        """Per-field PER-CHIP model bytes of this call's round (the
        ``halo.model_bytes.<field>`` counters) and one ``halo.exchange``
        event."""
        reg = metrics.current()
        if reg is None and events.current() is None:
            return
        events.record(
            "halo.exchange", program=program.name, halo=halo,
            fields=[f for f in fields if fhalos[f]], merged=merge_exchange,
        )
        if reg is None:
            return
        from repro_torch.dist.halo import halo_exchange_bytes_per_shard

        d, r, c = arrays[0].shape
        reg.inc("halo.exchange_rounds")
        for f, a in zip(fields, arrays):
            hf = fhalos[f]
            if hf:
                reg.inc(
                    f"halo.model_bytes.{f}",
                    halo_exchange_bytes_per_shard(
                        d, r, c, itemsize=a.element_size(), halo=hf,
                        row_sharded=n_row > 1, col_sharded=n_col > 1,
                    ),
                )

    def step(x: Tensor | Mapping[str, Tensor]):
        arrays = resolve_field_arrays(program, x, ndim=3)
        shape = arrays[0].shape
        for f, a in zip(fields, arrays):
            if a.shape != shape:
                raise ValueError(f"field {f!r} block {tuple(a.shape)} != {tuple(shape)}")
        _, r, c = shape
        for extent, n_sh, what, remedy in (
            (r, n_row, "rows", "columns (col_axis=...)"),
            (c, n_col, "cols", "rows (row_axis=...)"),
        ):
            if n_sh > 1 and extent < halo:
                raise ValueError(
                    f"{what}/shard {extent} < inferred halo {halo} "
                    f"(chain radius of {program.name!r}): too many {what} "
                    f"shards for the single-neighbour halo exchange — use "
                    f"fewer, or shard {remedy} instead"
                )
        if halo > 0 and (n_row > 1 or n_col > 1):
            _record_halo_model(arrays)
        return local_step(arrays)

    wrapped = metrics.instrument_call(step, f"ir.lower_sharded.{program.name}")
    wrapped.placement = placement
    return wrapped
