"""Domain-decomposed stencils on ``torch.distributed``: halo exchange + wire models.

The port of ``repro/dist/halo.py``. Each rank of a
:class:`~repro_torch.dist.sharding.Mesh` holds one block of the
``(D, R, C)`` grid: depth planes split over a depth axis with no traffic at
all, rows and columns split with a halo exchange. Every function here is
SPMD, as a ``shard_map`` body is: it takes and returns this rank's block,
and every rank of the mesh calls it in the same order.

The exchange is point to point (``isend``/``irecv``): the row bands with
the two row neighbours, the column bands with the two column neighbours,
and the four ``h x h`` corners with the diagonal neighbours in one hop —
the paper's 2-D B-block neighbour pattern. A rank at the grid edge sends
nothing outward and pads its outward side with zeros, where a JAX
``ppermute`` delivers zeros; the absolute-index boundary ring of the
lowerings never reads them into an owned point. An axis with one shard is
padded with zeros and moves nothing. Each message carries a tag made of
its direction and its field group, so that the merged and the sequential
exchanges, and the four corners, cannot be matched to the wrong receive.

Under gloo with CUDA blocks the bands are staged through pinned host
buffers (gloo is handed CPU tensors only); under nccl they stay on the
device. :func:`count_wire` is the port's counterpart of the JAX package's
``measured_collective_permute_bytes``: it counts the bytes and messages
this rank sends, the bytes it receives, and the bytes staged through the
host. A batched step (:func:`repro_torch.ir.lower_batched` on a sharded
backend) folds N members into the block's depth, so its round moves
exactly N times an unbatched member's bytes in the same messages.

The byte models are the JAX package's, unchanged. Two exact equalities tie
them to the counter: the bytes sent, summed over the mesh, equal
:func:`program_halo_exchange_bytes`; the bytes received by a rank with all
eight neighbours equal :func:`program_halo_exchange_bytes_per_shard` (the
per-chip model counts what every SPMD chip receives, zeros included, which
only an interior rank receives for real here).
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.hdiff import HALO, _hdiff_interior, hdiff, hdiff_simple
from repro_torch.dist.sharding import Mesh, _mesh_sizes, all_reduce, stage_collective

Tensor = torch.Tensor

# (name, row step, col step) of each halo region, as seen by the receiver:
# the region is filled from the rank at (row + di, col + dj). Row bands,
# column bands, then corners; the index is the tag's direction.
DIRECTIONS = (
    ("top", -1, 0), ("bottom", 1, 0), ("left", 0, -1), ("right", 0, 1),
    ("top_left", -1, -1), ("top_right", -1, 1),
    ("bottom_left", 1, -1), ("bottom_right", 1, 1),
)
_TAGS_PER_GROUP = len(DIRECTIONS)


@dataclasses.dataclass
class WireCount:
    """What one rank put on and took off the wire inside :func:`count_wire`."""

    sent_bytes: int = 0
    recv_bytes: int = 0
    sent_messages: int = 0
    host_staged_bytes: int = 0
    tags: set = dataclasses.field(default_factory=set)  # message families sent


_COUNTERS: list[WireCount] = []


@contextmanager
def count_wire():
    """Counts every halo message of this rank while the block runs."""
    c = WireCount()
    _COUNTERS.append(c)
    try:
        yield c
    finally:
        _COUNTERS.remove(c)


def _count(kind: str, nbytes: int, tag: int | None = None) -> None:
    for c in _COUNTERS:
        if kind == "send":
            c.sent_bytes += nbytes
            c.sent_messages += 1
            c.tags.add(tag)
        elif kind == "recv":
            c.recv_bytes += nbytes
        else:
            c.host_staged_bytes += nbytes


def _check_band(extent: int, halo: int, what: str) -> None:
    """A band comes from the IMMEDIATE neighbour only: a shard owning fewer
    than ``halo`` rows/cols cannot provide a full band, so raise rather than
    compute interiors from the wrong data."""
    if extent < halo:
        raise ValueError(
            f"{what}/shard {extent} < halo {halo}: the single-neighbour "
            f"halo exchange cannot deliver a depth-{halo} halo band; "
            f"use fewer {what} shards, shard the other grid axis instead, "
            f"or use a smaller halo / fewer fused steps"
        )


def _facing(step: int, h: int) -> slice:
    """My rows (or cols) that the neighbour at ``-step`` receives: the last
    ``h`` for a neighbour after me (``step < 0``), the first ``h`` for one
    before me, all of them along an axis the message does not cross."""
    return slice(-h, None) if step < 0 else slice(None, h) if step > 0 else slice(None)


def _landing(step: int, h: int, n: int) -> slice:
    """Where, in a block of extent ``n`` padded by ``h`` each side, the band
    from the neighbour at ``+step`` lands."""
    return slice(0, h) if step < 0 else slice(h + n, 2 * h + n) if step > 0 else slice(h, h + n)


class _Round:
    """One exchange round in flight: every field group's messages posted,
    :meth:`wait` assembles the padded blocks."""

    def __init__(self, blocks: Sequence[tuple[Tensor, int]], mesh: Mesh,
                 row_axis: str | None, col_axis: str | None, *, pad_cols: bool):
        sizes = _mesh_sizes(mesh)
        n_row = sizes[row_axis] if row_axis is not None else 1
        n_col = sizes[col_axis] if col_axis is not None else 1
        self.pad_cols = pad_cols
        self.blocks = blocks
        # (group, direction, buffer, source rank, tag, staged) per receive
        self.recvs: list[tuple] = []
        sends = []  # (tensor, destination rank, tag, staged)
        active = []  # (direction, di, dj, source rank, destination rank)
        for d, (_, di, dj) in enumerate(DIRECTIONS):
            if (di and n_row == 1) or (dj and n_col == 1):
                continue
            src = {**({row_axis: di} if di else {}), **({col_axis: dj} if dj else {})}
            dst = {axis: -step for axis, step in src.items()}
            active.append((d, di, dj, mesh.shifted(src), mesh.shifted(dst)))
        for g, (block, h) in enumerate(blocks):
            if n_row > 1:
                _check_band(block.shape[-2], h, "rows")
            if n_col > 1:
                _check_band(block.shape[-1], h, "cols")
            stage = stage_collective(mesh, block)
            for d, di, dj, src, dst in active:
                tag = g * _TAGS_PER_GROUP + d
                if dst is not None:
                    part = block[..., _facing(di, h), _facing(dj, h)]
                    if stage:
                        host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
                        part = host.copy_(part, non_blocking=True)
                    sends.append((part.contiguous(), dst, tag, stage))
                if src is not None:
                    shape = list(block.shape)
                    shape[-2] = h if di else shape[-2]
                    shape[-1] = h if dj else shape[-1]
                    buf = torch.empty(shape, dtype=block.dtype, pin_memory=stage,
                                      device="cpu" if stage else block.device)
                    self.recvs.append((g, d, buf, src, tag, stage))
        if any(stage for *_, stage in sends):
            torch.cuda.current_stream(blocks[0][0].device).synchronize()  # the host copies
        for part, _, tag, stage in sends:
            n = part.numel() * part.element_size()
            _count("send", n, tag)
            if stage:
                _count("stage", n)
        ops = [("send", part, peer, tag) for part, peer, tag, _ in sends]
        ops += [("recv", buf, peer, tag) for _, _, buf, peer, tag, _ in self.recvs]
        self.handles = _post(ops, mesh)

    def wait(self) -> list[Tensor]:
        for work in self.handles:
            work.wait()
        out = []
        for block, h in self.blocks:
            r, c = block.shape[-2], block.shape[-1]
            padded = block.new_zeros((*block.shape[:-2], r + 2 * h,
                                      c + 2 * h if self.pad_cols else c))
            padded[..., h : h + r, _landing(0, h, c) if self.pad_cols else slice(None)] = block
            out.append(padded)
        for g, d, buf, _, _, stage in self.recvs:
            n = buf.numel() * buf.element_size()
            _count("recv", n)
            if stage:
                _count("stage", n)
            block, h = self.blocks[g]
            _, di, dj = DIRECTIONS[d]
            cs = _landing(dj, h, block.shape[-1]) if self.pad_cols else slice(None)
            out[g][..., _landing(di, h, block.shape[-2]), cs] = buf.to(out[g].device,
                                                                      non_blocking=True)
        return out


def _post(ops, mesh: Mesh) -> list:
    """Posts the round's sends and receives; returns their work handles."""
    if mesh.backend == "nccl":
        p2p = [dist.P2POp(dist.isend if k == "send" else dist.irecv, t, peer, tag=tag)
               for k, t, peer, tag in ops]
        return dist.batch_isend_irecv(p2p) if p2p else []
    return [(dist.isend if k == "send" else dist.irecv)(t, peer, tag=tag)
            for k, t, peer, tag in ops]


def start_exchange(blocks: Sequence[tuple[Tensor, int]], mesh: Mesh, row_axis: str | None,
                   col_axis: str | None, *, pad_cols: bool) -> _Round:
    """Posts one exchange round for ``blocks``, a ``(block, halo)`` per field
    group (group ``g`` tags its messages ``8 g + direction``), and returns
    the round; ``round.wait()`` gives each block padded by its halo: rows
    always, columns too when ``pad_cols``. Work issued between the two
    overlaps the transfer."""
    return _Round(blocks, mesh, row_axis, col_axis, pad_cols=pad_cols)


def _band_halos(block: Tensor, mesh: Mesh, axis_name: str, halo: int, dim: int):
    """(lo_halo, hi_halo) bands of width ``halo`` along ``dim`` (-2 rows or
    -1 cols), fetched from the two neighbours on ``axis_name``. With one
    shard on the axis nothing moves: both are zero pads (an extent thinner
    than ``halo`` is then fine)."""
    rows = dim == -2
    padded = start_exchange([(block, halo)], mesh, axis_name if rows else None,
                            None if rows else axis_name, pad_cols=not rows).wait()[0]
    if rows:
        return padded[..., :halo, :], padded[..., -halo:, :]
    r = block.shape[-2]
    return padded[..., halo : halo + r, :halo], padded[..., halo : halo + r, -halo:]


def exchange_row_halos(block: Tensor, mesh: Mesh, row_axis: str, halo: int = HALO) -> Tensor:
    """Pads ``block`` (..., R_loc, C) with ``halo`` rows from each row
    neighbour. Edge shards get zeros on their outward side; with a single
    row shard nothing moves. Returns (..., R_loc + 2*halo, C). A sharded
    axis needs ``R_loc >= halo`` (:func:`_check_band`)."""
    return start_exchange([(block, halo)], mesh, row_axis, None, pad_cols=False).wait()[0]


def exchange_halos_2d(block: Tensor, mesh: Mesh, row_axis: str | None, col_axis: str | None,
                      halo: int = HALO) -> Tensor:
    """2-D halo exchange: pads ``block`` (..., R_loc, C_loc) with ``halo``
    rows, cols and corners from its 8 mesh neighbours. Returns
    (..., R_loc + 2*halo, C_loc + 2*halo).

    Row bands move between row neighbours, col bands between col
    neighbours, and the four ``halo x halo`` corners between diagonal
    neighbours in one hop, only when both axes are sharded. An axis with
    one shard gets zero pads (and may be thinner than the halo). The
    neighbours come from the mesh's coordinates, whatever order its axes
    were declared in."""
    return start_exchange([(block, halo)], mesh, row_axis, col_axis, pad_cols=True).wait()[0]


def owned_rows_mask(shard_index: int, rows_local: int, rows_global: int, halo: int = HALO,
                    device=None) -> Tensor:
    """Boolean (rows_local,): which of my rows are GLOBAL interior rows
    (the radius-``halo`` global boundary ring passes through)."""
    g = shard_index * rows_local + torch.arange(rows_local, device=device)
    return (g >= halo) & (g < rows_global - halo)


def halo_exchange_bytes(
    depth: int,
    rows: int,
    cols: int,
    row_shards: int,
    itemsize: int = 4,
    halo: int = HALO,
    steps: int = 1,
    col_shards: int = 1,
) -> int:
    """Total bytes on the wire for ONE halo-exchange round, summed over the
    whole mesh (``h = halo * steps``): row bands ``2 (R-1) depth h cols``,
    col bands ``2 (C-1) depth h rows``, corners ``4 (R-1)(C-1) depth h^2``
    elements. Independent of depth sharding. Symmetric under (rows, R) <->
    (cols, C); ``col_shards=1`` is the 1-D row formula. ``steps`` models
    temporal blocking: one round of a depth-``steps * halo`` band serves
    ``steps`` fused sweeps."""
    h = halo * steps
    total = 0
    if row_shards > 1:
        total += 2 * (row_shards - 1) * depth * h * cols
    if col_shards > 1:
        total += 2 * (col_shards - 1) * depth * h * rows
    if row_shards > 1 and col_shards > 1:
        total += 4 * (row_shards - 1) * (col_shards - 1) * depth * h * h
    return total * itemsize


def halo_exchange_bytes_per_shard(
    local_depth: int,
    local_rows: int,
    local_cols: int,
    itemsize: int = 4,
    halo: int = HALO,
    steps: int = 1,
    row_sharded: bool = True,
    col_sharded: bool = False,
) -> int:
    """Per-chip result bytes of one exchange round in the SPMD model: row
    bands 2 x (D_loc, h, C_loc), col bands 2 x (D_loc, R_loc, h), and 4
    corners (D_loc, h, h) when both axes are sharded — what a rank with
    all eight neighbours receives."""
    h = halo * steps
    total = 0
    if row_sharded:
        total += 2 * local_depth * h * local_cols
    if col_sharded:
        total += 2 * local_depth * local_rows * h
    if row_sharded and col_sharded:
        total += 4 * local_depth * h * h
    return total * itemsize


def program_exchange_radii(program) -> dict[str, int]:
    """Per-field EXCHANGED halo depth: ``program.exchange_radii()``, the one
    home of the rule the byte models, ``lower_sharded``'s exchange and the
    kernel's per-field halos share."""
    return program.exchange_radii()


def program_halo_exchange_bytes(
    program,
    depth: int,
    rows: int,
    cols: int,
    row_shards: int,
    itemsize: int = 4,
    col_shards: int = 1,
) -> int:
    """Whole-mesh wire bytes for ONE exchange round of a (possibly
    multi-field, possibly temporally composed) program: the per-field sum of
    :func:`halo_exchange_bytes` at each field's exchanged radius (a radius-0
    field adds nothing). Equals the bytes ``lower_sharded`` sends, summed
    over the ranks."""
    return sum(
        halo_exchange_bytes(
            depth, rows, cols, row_shards,
            itemsize=itemsize, halo=r, col_shards=col_shards,
        )
        for r in program_exchange_radii(program).values()
    )


def program_halo_exchange_bytes_per_shard(
    program,
    local_depth: int,
    local_rows: int,
    local_cols: int,
    itemsize: int = 4,
    row_sharded: bool = True,
    col_sharded: bool = False,
) -> int:
    """Per-chip result bytes for one multi-field exchange round: the
    per-field sum of :func:`halo_exchange_bytes_per_shard`. Equals the bytes
    a rank with all eight neighbours receives."""
    return sum(
        halo_exchange_bytes_per_shard(
            local_depth, local_rows, local_cols,
            itemsize=itemsize, halo=r,
            row_sharded=row_sharded, col_sharded=col_sharded,
        )
        for r in program_exchange_radii(program).values()
    )


def _gradient_rounds(program) -> list:
    """The programs whose exchange rounds one value-and-grad step of a
    sharded differentiable lowering runs, in the order ``make_vjp`` runs
    them: the primal forward; per sweep the augmented forward (sweeps with
    caches) or the plain sweep (non-final sweeps without caches, when the
    backward needs the primal state); per sweep the adjoint."""
    from repro_torch.ir.autodiff import adjoint, augmented_forward, cache_fields

    rounds = [program]
    chain = program.chain
    needs_state = any(
        cache_fields(q)
        or any(r.field in q.inputs for op in adjoint(q).ops for r in op.reads)
        for q in chain
    )
    for i, q in enumerate(chain):
        if cache_fields(q):
            rounds.append(augmented_forward(q))
        elif needs_state and i < len(chain) - 1:
            rounds.append(q)
        rounds.append(adjoint(q))
    return rounds


def gradient_halo_exchange_bytes_per_shard(
    program,
    local_depth: int,
    rows: int,
    cols: int,
    *,
    mesh_shape: tuple[int, int],
    itemsize: int = 4,
) -> int:
    """Per-chip result bytes of one VALUE-AND-GRAD step of a sharded
    differentiable lowering (``build_backend(..., "sharded-*",
    differentiable=True)``): the sum of
    :func:`program_halo_exchange_bytes_per_shard` over the step's rounds
    (the primal forward; per sweep an augmented forward where it caches, a
    plain sweep where a non-final sweep without caches must recompute the
    state; per sweep the adjoint). ``rows`` / ``cols`` are GLOBAL extents,
    ``local_depth`` per shard. Every backward sweep runs on the unpadded
    shards (``boundary="zero"``), so no pad or crop adds traffic."""
    n_row, n_col = int(mesh_shape[0]), int(mesh_shape[1])
    return sum(
        program_halo_exchange_bytes_per_shard(
            p, local_depth, rows // n_row, cols // n_col,
            itemsize=itemsize, row_sharded=n_row > 1, col_sharded=n_col > 1,
        )
        for p in _gradient_rounds(program)
    )


def gradient_halo_exchange_bytes(
    program,
    depth: int,
    rows: int,
    cols: int,
    *,
    mesh_shape: tuple[int, int],
    itemsize: int = 4,
) -> int:
    """Whole-mesh wire bytes of one value-and-grad step: the same rounds as
    :func:`gradient_halo_exchange_bytes_per_shard`, each counted by
    :func:`program_halo_exchange_bytes` (global extents). Equals the bytes
    the step sends, summed over the ranks."""
    n_row, n_col = int(mesh_shape[0]), int(mesh_shape[1])
    return sum(
        program_halo_exchange_bytes(p, depth, rows, cols, n_row, itemsize=itemsize,
                                    col_shards=n_col)
        for p in _gradient_rounds(program)
    )


def measured_wire_bytes(step_fn: Callable, x, mesh: Mesh) -> tuple[int, int]:
    """The port's ``measured_collective_permute_bytes``: runs ``step_fn(x)``
    once under :func:`count_wire` (a collective: every rank calls it) and
    returns ``(bytes sent, messages sent)``, each summed over the mesh."""
    with count_wire() as c:
        step_fn(x)
    totals = all_reduce(torch.tensor([c.sent_bytes, c.sent_messages], dtype=torch.int64,
                                     device=mesh.device), dist.ReduceOp.SUM, mesh)
    return int(totals[0]), int(totals[1])


def _report(name: str, program, measured: int, model: int, tolerance: float | None):
    from repro_torch.obs import events
    from repro_torch.obs.drift import DEFAULT_TOLERANCE, check_drift

    tol = DEFAULT_TOLERANCE if tolerance is None else tolerance
    result = check_drift(name, measured, model, tol)
    events.record("drift.report", name=name, program=program.name,
                  measured=result.measured, model=result.model,
                  ratio=result.ratio, ok=result.ok)
    return result


def _itemsize(x) -> int:
    leaf = next(iter(x.values())) if isinstance(x, dict) else x
    return leaf.element_size()


def wire_drift_report(
    program,
    step_fn,
    x,
    *,
    mesh: Mesh,
    depth: int,
    rows: int,
    cols: int,
    mesh_shape: tuple[int, int],
    tolerance: float | None = None,
    name: str = "halo.wire",
):
    """Measured-vs-model drift check for one sharded lowering: runs
    ``step_fn(x)`` once (every rank), sums the bytes every rank sent and
    compares them with :func:`program_halo_exchange_bytes` for the GLOBAL
    ``(depth, rows, cols)`` grid on ``mesh_shape = (row shards, col
    shards)``. The whole-mesh sum is exact on any mesh (the per-chip model
    is exact only on a rank with all eight neighbours). Records through
    :func:`repro_torch.obs.drift.check_drift` and a ``drift.report`` event,
    and returns the :class:`~repro_torch.obs.drift.DriftResult`."""
    measured, _ = measured_wire_bytes(step_fn, x, mesh)
    model = program_halo_exchange_bytes(
        program, depth, rows, cols, int(mesh_shape[0]), itemsize=_itemsize(x),
        col_shards=int(mesh_shape[1]),
    )
    return _report(name, program, measured, model, tolerance)


def gradient_wire_drift_report(
    program,
    grad_step_fn,
    x,
    *,
    mesh: Mesh,
    depth: int,
    rows: int,
    cols: int,
    mesh_shape: tuple[int, int],
    tolerance: float | None = None,
    name: str = "halo.grad_wire",
):
    """:func:`wire_drift_report` for a sharded BACKWARD pass:
    ``grad_step_fn`` runs the primal and its gradient; the bytes every rank
    sent are compared with :func:`gradient_halo_exchange_bytes`."""
    measured, _ = measured_wire_bytes(grad_step_fn, x, mesh)
    model = gradient_halo_exchange_bytes(
        program, depth, rows, cols, mesh_shape=mesh_shape, itemsize=_itemsize(x),
    )
    return _report(name, program, measured, model, tolerance)


def make_sharded_hdiff(
    mesh: Mesh,
    *,
    depth_axis: str | None = "data",
    row_axis: str | None = None,
    limit: bool = True,
    coeff: float = 0.025,
) -> Callable[[Tensor], Tensor]:
    """``block (D_loc, R_loc, C) -> block'``: this rank's part of the
    single-device :func:`repro_torch.core.hdiff` (``hdiff_simple`` with
    ``limit=False``) of the global field, domain-decomposed over ``mesh``:
    depth planes over ``depth_axis``, rows over ``row_axis`` with a
    radius-2 row halo exchange, the global ring kept by absolute row index
    (:func:`owned_rows_mask`). Eager PyTorch, as the JAX version is jnp."""
    sizes = _mesh_sizes(mesh)
    for ax in (depth_axis, row_axis):
        if ax is not None and ax not in sizes:
            raise ValueError(f"mesh {tuple(sizes)} has no axis {ax!r}")
    if depth_axis is not None and depth_axis == row_axis:
        raise ValueError("depth_axis and row_axis must be distinct mesh axes")
    n_row = sizes[row_axis] if row_axis is not None else 1
    single = hdiff if limit else hdiff_simple

    def step(block: Tensor) -> Tensor:
        if block.ndim != 3:
            raise ValueError(f"expected (depth, rows, cols), got shape {tuple(block.shape)}")
        if row_axis is None or n_row == 1:
            return single(block, coeff)
        r_loc = block.shape[-2]
        if r_loc < HALO:
            raise ValueError(f"rows/shard {r_loc} < halo {HALO}: too many row shards")
        padded = exchange_row_halos(block, mesh, row_axis)
        interior = _hdiff_interior(padded, coeff, limit=limit)
        mask = owned_rows_mask(mesh.coord(row_axis), r_loc, r_loc * n_row,
                               device=block.device)
        cur = block[..., :, HALO:-HALO]
        out = block.clone()
        out[..., :, HALO:-HALO] = torch.where(mask[:, None], interior.to(block.dtype), cur)
        return out

    return step
