"""Temporal-blocked hdiff: TWO timesteps per device-memory round trip.

The counterpart of ``repro/kernels/hdiff/multistep.py``: ``hdiff_twostep``
is ``repeat(hdiff_program(coeff), 2)`` through the generated fused kernel
(:func:`repro_torch.ir.lower_cuda`, K2). The tile is loaded into shared
memory once with a radius-4 halo, hdiff is applied twice with the global
boundary ring re-applied at absolute indices between the sweeps, and only
the final result returns to device memory, so compulsory traffic per
simulated step halves.

``block_rows`` resolves like the other kernel entry points: an explicit
value is validated as given (never clamped to ``rows`` first) against the
two-step structural floor of the JAX kernel, so the two APIs accept the
same calls; ``None`` leaves the tile to the shared-memory planner.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.ir import hdiff_multistep_program, lower_cuda
from repro_torch.kernels.hdiff.kernel import HALO

# Two fused sweeps need a 2*HALO halo from EACH neighbouring block plus the
# block's own rows — the JAX kernel's documented floor, kept as this
# wrapper's contract.
MIN_TWOSTEP_BLOCK_ROWS = 4 * HALO


def hdiff_twostep(
    psi: torch.Tensor,
    coeff: float = 0.025,
    *,
    block_rows: int | None = None,
    limit: bool = True,
) -> torch.Tensor:
    """Two fused hdiff timesteps over ``(depth, rows, cols)``.

    ``coeff`` must be a concrete scalar: the IR path bakes it into the
    program graph (one compiled kernel per coefficient, cached)."""
    if psi.ndim != 3:
        raise ValueError(f"expected (depth, rows, cols), got shape {tuple(psi.shape)}")
    try:
        coeff = float(coeff)
    except TypeError as e:
        raise ValueError(
            "coeff must be a concrete Python/NumPy scalar — the IR-based "
            "kernel bakes it into the program graph"
        ) from e
    rows = psi.shape[1]
    if block_rows is not None:
        if rows % block_rows:
            raise ValueError(f"rows={rows} not divisible by block_rows={block_rows}")
        if block_rows < MIN_TWOSTEP_BLOCK_ROWS:
            raise ValueError(
                f"block_rows must be >= {MIN_TWOSTEP_BLOCK_ROWS} for two-step halos"
            )
    return _lowered_twostep(coeff, limit, block_rows)(psi)


@functools.lru_cache(maxsize=64)
def _lowered_twostep(coeff: float, limit: bool, block_rows: int | None):
    """Caches the lowering (and so the program and its fingerprint) per
    coefficient; the compiled kernel is cached by :mod:`lower_cuda`."""
    prog = hdiff_multistep_program(2, coeff, limit=limit)
    return lower_cuda(prog, block_rows=block_rows)
