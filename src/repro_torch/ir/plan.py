"""Shared-memory tile planning for the hand-written and generated kernels.

The counterpart of ``repro/ir/plan.py``'s VMEM planner. On the TPU a
Pallas block is a full-width row slab sized against a VMEM budget; on
Hopper a thread block owns a (rows x cols) output tile and holds it in
shared memory together with its halo, so the planner sizes a 2-D tile
against the per-block shared-memory limit of ``sm_90``: 227 KB (232,448
bytes) of dynamic shared memory, of which only 48 KB come without
``cudaFuncAttributeMaxDynamicSharedMemorySize`` (the kernels' launchers set
that attribute when a plan needs more).

Every kernel stores its tiles in shared-memory *frames* of
``(rows + 2 * halo)`` rows, each padded to whole 16-byte groups and shifted
so that the tile's first grid column starts a group
(:func:`frame_layout`); a frame holds float32 (or int32) words, a
bfloat16 input widened as it loads. The hand-written stencil kernels hold
one frame each: the float hdiff kernel (K1), the int32 hdiff kernel (K3)
and the mask kernel (K4, halo 1), all planned by :func:`plan_fixed_tile`
(64-row tiles, a column tile that is a template constant of the kernel);
the generated program kernel (K2) keeps one frame per input, one more per
evolving field when it runs several sweeps, and one per live op that is not
inlined (:func:`program_frame_layout`), planned by
:func:`plan_program_tile`. A 1-D program's kernel (K5') treats its
``(batch, n)`` field as one flat array cut into spans, one a warp (no
frame) or one a block (one frame, or two taking turns for a chain of
sweeps): :func:`plan_tile_1d` picks the span. :func:`plan_partition`
picks the rows x cols factorization of a mesh for ``lower_sharded`` by the
halo wire model of :mod:`repro_torch.dist.halo`.
"""

from __future__ import annotations

import dataclasses

SMEM_BLOCK_LIMIT = 232_448  # bytes of dynamic shared memory one block may use
SMEM_SM = 233_472  # bytes of shared memory per SM; each resident block reserves 1 KB of it
SMEM_BLOCK_RESERVED = 1024
# The generated program kernel's tiles, largest first: a larger tile cuts
# the k * r halo every sweep recomputes (1.27x the tile's points at 64x64
# with hdiff x 2's halo of 4, 1.41x at 32x64).
PROGRAM_TILES = ((64, 64), (32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8))
FIXED_TILE = 64  # K1's, K3's and K4's output rows and columns per block before shrinking
FIXED_TILE_COLS = (64, 32, 16, 8)  # their column tiles: the kernels' template constants
FIXED_SHIFT = 2  # words before K3's frame, so its grid column c0 starts a 16-byte group
VECTORS_1D = (1, 2, 4)  # 16-byte vectors a thread of K5' may hold, fewest first
THREADS = 256  # threads per block of every stencil kernel (csrc/stencil_common.cuh kThreads)
FRAME_ITEMSIZE = 4  # frames hold float32 (or int32) words


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One block's output tile and the shared memory it needs."""

    rows: int
    cols: int
    halo: int
    buffers: int


def frame_layout(cols: int, halo: int) -> tuple[int, int]:
    """``(row stride, shift)``, in 4-byte words, of a frame holding a
    ``cols``-column tile and its ``halo``: rows of ``cols + 2 * halo`` words
    padded to a multiple of 4, and the frame shifted by ``(-halo) % 4``
    words, so that frame column ``j`` and grid column ``c0 - halo + j``
    (``c0`` a multiple of 4) share their address modulo 16 bytes and whole
    aligned groups of 4 columns load with one 16-byte copy
    (``csrc/stencil_common.cuh``, ``Frame``; ``codegen_cuda``)."""
    return -(-(cols + 2 * halo) // 4) * 4, (-halo) % 4


def fixed_tile_bytes(rows: int, cols: int, halo: int = 2) -> int:
    """Dynamic shared memory of K1's, K3's or K4's block for a ``rows x
    cols`` tile: one frame of ``rows + 2 * halo`` rows, after its shift,
    rounded up to 16 bytes."""
    ld, shift = frame_layout(cols, halo)
    return -(-(shift + (rows + 2 * halo) * ld) // 4) * 16


def plan_fixed_tile(rows: int, cols: int, *, halo: int = 2,
                    block_rows: int | None = None) -> TilePlan:
    """The tile of the one-frame kernels K3, K1 (``halo=2``) and K4
    (``halo=1``): :data:`FIXED_TILE` rows (clipped to the grid) by the
    narrowest of :data:`FIXED_TILE_COLS` that covers the grid's columns
    (else the widest), the columns halved while the frame does not fit the
    per-block shared-memory limit. An explicit ``block_rows`` fixes the
    rows. Raises when not even an 8-column tile fits."""
    if rows < 1 or cols < 1:
        raise ValueError(f"grid ({rows}, {cols}) has no points")
    tr = block_rows if block_rows is not None else min(FIXED_TILE, rows)
    if tr < 1:
        raise ValueError(f"a tile needs at least one row, got {tr}")
    tc = next((c for c in reversed(FIXED_TILE_COLS) if c >= cols), FIXED_TILE_COLS[0])
    while fixed_tile_bytes(tr, tc, halo) > SMEM_BLOCK_LIMIT:
        if tc == FIXED_TILE_COLS[-1]:
            raise ValueError(
                f"a {tr}x{tc} tile with a {halo}-cell halo needs "
                f"{fixed_tile_bytes(tr, tc, halo)} bytes of shared memory, over the "
                f"{SMEM_BLOCK_LIMIT}-byte per-block limit; use fewer block rows"
            )
        tc //= 2
    return TilePlan(tr, tc, halo, 1)


def program_frame_layout(rows: int, cols: int, halo: int) -> tuple[int, int, int]:
    """``(row stride, shift, words)`` of one frame of the generated program
    kernel for a ``rows x cols`` tile (:func:`frame_layout`); ``words`` is
    the frame's size, shift included, rounded up to a multiple of 4."""
    ld, shift = frame_layout(cols, halo)
    return ld, shift, -(-(shift + (rows + 2 * halo) * ld) // 4) * 4


def program_tile_bytes(rows: int, cols: int, halo: int, buffers: int) -> int:
    """Dynamic shared memory of the generated program kernel's block."""
    return program_frame_layout(rows, cols, halo)[2] * FRAME_ITEMSIZE * buffers


def plan_program_tile(
    rows: int,
    cols: int,
    *,
    halo: int,
    buffers: int,
    block_rows: int | None = None,
) -> TilePlan:
    """The generated program kernel's tile: the first of
    :data:`PROGRAM_TILES` (clipped to the grid) whose ``buffers`` frames let
    two blocks share an SM, else the first that fits one block. An explicit
    ``block_rows`` fixes the tile rows and only the columns (64 down to 8)
    are chosen. Raises when not even an 8-column tile fits one block."""
    if rows < 1 or cols < 1:
        raise ValueError(f"grid ({rows}, {cols}) has no points")
    if buffers < 1:
        raise ValueError(f"buffers must be >= 1, got {buffers}")
    if block_rows is not None:
        candidates = [(block_rows, min(tc, cols)) for tc in (64, 32, 16, 8)]
    else:
        candidates = [(min(tr, rows), min(tc, cols)) for tr, tc in PROGRAM_TILES]
    for blocks in (2, 1):
        for tr, tc in candidates:
            need = program_tile_bytes(tr, tc, halo, buffers)
            if need <= SMEM_BLOCK_LIMIT and blocks * (need + SMEM_BLOCK_RESERVED) <= SMEM_SM:
                return TilePlan(tr, tc, halo, buffers)
    tr, tc = candidates[-1]
    raise ValueError(
        f"a {tr}x{tc} tile with a {halo}-cell halo needs "
        f"{program_tile_bytes(tr, tc, halo, buffers)} bytes of shared memory for "
        f"{buffers} frames, over the {SMEM_BLOCK_LIMIT}-byte per-block limit; use "
        "fewer block rows"
    )


def plan_tile_1d(*, halo: int, steps: int) -> TilePlan:
    """K5''s span: ``TilePlan(1, vectors, halo, buffers)``, ``vectors`` the
    16-byte vectors (4 float32 or 8 bfloat16 points) each thread loads. A
    span's threads store it but ``halo``, rounded up to whole vectors, at
    each end, which the neighbouring spans store.

    A chain of several sweeps whose halo fits one float32 vector takes warp
    spans, ``buffers`` 0: one vector a thread, a span a warp, neighbours by
    shuffles, no barrier (one extra vector of loads at each end of a warp's
    128 or 256 points, where a barrier a sweep would cost more). Any other
    program takes block spans of :data:`THREADS` threads with one shared
    frame, or two taking turns between sweeps: the fewest vectors of
    :data:`VECTORS_1D` whose float32 span keeps the halo to at most a
    quarter of it at each end. Raises for a chain too deep for that."""
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if steps > 1 and halo <= 4:
        return TilePlan(1, 1, halo, 0)
    for vectors in VECTORS_1D:
        if -(-halo // 4) * 4 <= THREADS * vectors:  # at most a quarter of THREADS * 4 * vectors
            return TilePlan(1, vectors, halo, 1 if steps == 1 else 2)
    raise ValueError(
        f"a chain halo of {halo} points is deeper than the 1-D kernel's widest span "
        f"({THREADS * 4 * VECTORS_1D[-1]} float32 points) allows"
    )


# ---------------------------------------------------------------------------
# 2-D (rows x cols) mesh factorization for lower_sharded.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Partition2D:
    """A rows x cols shard factorization chosen by :func:`plan_partition`.

    ``wire_bytes`` is the whole-mesh traffic of ONE halo-exchange round
    under the exact 2-axis model (row bands + col bands + diagonal
    corners), summed per input field; ``halo`` is the deepest exchanged band
    (the program's chain radius, k*r for ``repeat(p, k)``)."""

    row_shards: int
    col_shards: int
    halo: int
    wire_bytes: int

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """Directly usable as ``lower_sharded(..., mesh_shape=...)``."""
        return (self.row_shards, self.col_shards)


def plan_partition(
    program,
    depth: int,
    rows: int,
    cols: int,
    n_devices: int,
    *,
    itemsize: int = 4,
) -> Partition2D:
    """The rows x cols factorization of ``n_devices`` that minimizes the
    modelled wire bytes per exchange round for ``program`` on a (depth,
    rows, cols) grid — the JAX package's choice, ties included.

    A factorization (R, C) is feasible when both grid dims divide evenly
    and each sharded dim keeps at least the chain radius per shard (the
    single-neighbour exchange floor ``lower_sharded`` enforces). Ties break
    toward fewer column shards (rows are the paper's lane decomposition;
    columns the contiguous dim)."""
    from repro_torch.dist.halo import program_halo_exchange_bytes

    halo = program.radius
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    best: Partition2D | None = None
    for r_sh in range(1, n_devices + 1):
        if n_devices % r_sh:
            continue
        c_sh = n_devices // r_sh
        if rows % r_sh or cols % c_sh:
            continue
        if halo > 0 and (
            (r_sh > 1 and rows // r_sh < halo) or (c_sh > 1 and cols // c_sh < halo)
        ):
            continue
        wire = program_halo_exchange_bytes(
            program, depth, rows, cols, r_sh, itemsize=itemsize, col_shards=c_sh
        )
        cand = Partition2D(r_sh, c_sh, halo, wire)
        if (
            best is None
            or cand.wire_bytes < best.wire_bytes
            or (cand.wire_bytes == best.wire_bytes and c_sh < best.col_shards)
        ):
            best = cand
    if best is None:
        raise ValueError(
            f"no rows x cols factorization of {n_devices} devices fits grid "
            f"({rows}, {cols}) with halo {halo} (program {program.name!r}): "
            f"every split leaves a shard thinner than the halo band"
        )
    return best
