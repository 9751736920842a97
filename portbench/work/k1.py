"""K1's compulsory work: one hdiff sweep (``kernels/hdiff`` through
``core.run_simulation``) over a ``(depth, rows, cols)`` float32 field.

Bytes: the field read once and the result written once. Operations: the
arithmetic each interior point needs once, counted from Eq. 1-4 (the
Laplacian 5, four fluxes 4, the limiter's four differences and four
products 8, the update 5): 22. Compares and selects are not counted, nor is
a Laplacian recomputed for a neighbour; at 22 per point the bytes bound the
call by a factor of about eight, so the count only has to stay low.
"""

FLOPS_PER_POINT = 22
WORD = 4


def interior(depth: int, rows: int, cols: int) -> int:
    return depth * max(rows - 4, 0) * max(cols - 4, 0)


def per_call(depth: int, rows: int, cols: int, sweeps: int = 1) -> tuple[int, int]:
    """``(bytes, flops)`` of one call that makes ``sweeps`` sweeps."""
    return 2 * WORD * depth * rows * cols, sweeps * FLOPS_PER_POINT * interior(depth, rows, cols)


def least_s(nbytes: int, flops: int, peaks: dict) -> float:
    """The least time of the work on the chip: the larger of its bytes over
    the memory rate and its operations over the float32 rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["fp32_flops_per_s"])
