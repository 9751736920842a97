"""Public entry points for the elementary-stencil kernels.

The counterpart of ``repro/kernels/stencil2d/ops.py``. Each call runs
where its tensor lives: a CUDA tensor launches the hand-written kernel (K4
/ K5), a CPU tensor computes the kernel's plain version. The Pallas-only
``interpret`` knob has no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.stencil2d.kernel import jacobi1d_cuda, stencil2d_cuda
from repro_torch.kernels.stencil2d.ref import weights_for


def stencil2d(
    x: torch.Tensor, name_or_weights, *, block_rows: int | None = None
) -> torch.Tensor:
    """Applies a named §3.5 stencil (or an explicit 3x3 mask) to
    ``(depth, rows, cols)``.

    An explicit ``block_rows`` is validated as the JAX kernel validates it
    (clamped to ``rows``, must divide it) so the two APIs accept the same
    calls; ``None`` leaves the tile to the shared-memory planner, whose
    tiles need not divide the grid (the kernel masks ragged edges)."""
    if isinstance(name_or_weights, str):
        weights = weights_for(name_or_weights)
    else:
        weights = name_or_weights
    if x.ndim != 3:
        raise ValueError(f"expected (depth, rows, cols), got shape {tuple(x.shape)}")
    rows, cols = x.shape[1], x.shape[2]
    if rows < 3 or cols < 3:
        raise ValueError(f"a 3x3 stencil needs a grid of at least 3x3, got {rows}x{cols}")
    br = None
    if block_rows is not None:
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        br = min(block_rows, rows)
        if rows % br:
            raise ValueError(f"rows={rows} not divisible by block_rows={br}")
    return stencil2d_cuda(x, weights, block_rows=br)


def jacobi1d(x: torch.Tensor, *, coeff: float = 1.0 / 3.0) -> torch.Tensor:
    """1-D 3-point Jacobi over ``(batch, n)`` or ``(n,)``."""
    if x.ndim not in (1, 2):
        raise ValueError(f"expected (batch, n) or (n,), got shape {tuple(x.shape)}")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    out = jacobi1d_cuda(x, coeff)
    return out[0] if squeeze else out
