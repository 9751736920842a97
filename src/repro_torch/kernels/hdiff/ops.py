"""Public entry points for the hdiff kernels.

The counterpart of ``repro/kernels/hdiff/ops.py``. Each call runs where
its tensor lives: a CUDA tensor launches the hand-written kernel (K1 / K3),
a CPU tensor computes the kernel's plain version. The differentiable
``hdiff_fused_ad`` arrives with the adjoint port (ROADMAP M8).
"""

from __future__ import annotations

import torch

from repro_torch.core.hdiff import HALO
from repro_torch.kernels.hdiff.kernel import hdiff_cuda, hdiff_fixed_cuda


def _block_rows(shape, block_rows: int | None) -> int | None:
    """Validates an explicit ``block_rows`` exactly as the JAX kernel does
    (clamped to ``rows``, must divide it, at least ``2 * HALO``) so the two
    APIs accept the same calls; ``None`` leaves the tile to the planner,
    whose tiles need not divide the grid (the kernel masks ragged edges)."""
    if len(shape) != 3:
        raise ValueError(f"expected (depth, rows, cols), got shape {tuple(shape)}")
    if block_rows is None:
        return None
    rows = shape[1]
    br = min(block_rows, rows)
    if rows % br:
        raise ValueError(f"rows={rows} not divisible by block_rows={br}")
    if 2 * HALO > br:
        raise ValueError(f"block_rows must be >= {2 * HALO}")
    return br


def hdiff_fused(
    psi: torch.Tensor,
    coeff: float | torch.Tensor = 0.025,
    *,
    block_rows: int | None = None,
    limit: bool = True,
) -> torch.Tensor:
    """Fused hdiff (Laplacian + flux + output in one shared-memory-resident
    kernel) over a ``(depth, rows, cols)`` float32/bfloat16 field.

    ``coeff`` is a scalar (a Python number or a 0-d tensor); ``limit``
    applies the Eq. 2-3 flux limiter (the production COSMO form)."""
    br = _block_rows(psi.shape, block_rows)
    return hdiff_cuda(psi, float(coeff), limit=limit, block_rows=br)


def hdiff_fixed(
    psi_q: torch.Tensor,
    *,
    coeff_num: int = 26,
    coeff_shift: int = 10,
    block_rows: int | None = None,
) -> torch.Tensor:
    """int32 fixed-point hdiff (the paper's i32 datapath)."""
    br = _block_rows(psi_q.shape, block_rows)
    return hdiff_fixed_cuda(
        psi_q, coeff_num=coeff_num, coeff_shift=coeff_shift, block_rows=br
    )
