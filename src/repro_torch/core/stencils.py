"""Elementary stencil kernels (plain PyTorch reference implementations).

The counterpart of ``repro/core/stencils.py``: the five elementary
stencils SPARTA implements in §3.5 (jacobi1d, jacobi2d_3pt, laplacian,
jacobi2d_9pt, seidel2d), in the JAX package's operation order. All operate
on the trailing two dims (one for jacobi1d), preserve shape, and leave the
boundary ring equal to the input. Everything runs where the tensor lives.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """Static description of a stencil's per-output-point cost (Eq. 5-10):
    ``macs`` multiply-accumulates, ``other_ops`` non-MAC vector ops,
    ``reads`` distinct input elements per output, ``radius`` the halo."""

    name: str
    macs: int
    other_ops: int
    reads: int
    radius: int
    ndim: int = 2

    @property
    def flops(self) -> int:
        # A MAC is 2 flops (mul + add).
        return 2 * self.macs + self.other_ops


ELEMENTARY_SPECS: dict[str, StencilSpec] = {
    "jacobi1d": StencilSpec("jacobi1d", macs=3, other_ops=0, reads=3, radius=1, ndim=1),
    "jacobi2d_3pt": StencilSpec("jacobi2d_3pt", macs=3, other_ops=0, reads=3, radius=1),
    "laplacian": StencilSpec("laplacian", macs=5, other_ops=0, reads=5, radius=1),
    "jacobi2d_5pt": StencilSpec("jacobi2d_5pt", macs=5, other_ops=0, reads=5, radius=1),
    "jacobi2d_9pt": StencilSpec("jacobi2d_9pt", macs=9, other_ops=0, reads=9, radius=1),
    "seidel2d": StencilSpec("seidel2d", macs=9, other_ops=0, reads=9, radius=1),
}


def _interior_update_2d(x: Tensor, new_interior: Tensor, radius: int) -> Tensor:
    """A copy of ``x`` with ``new_interior`` written into its interior."""
    r = radius
    out = x.clone()
    out[..., r:-r, r:-r] = new_interior.to(x.dtype)
    return out


def jacobi1d(x: Tensor, coeff: float = 1.0 / 3.0) -> Tensor:
    """PolyBench jacobi-1d: ``out[i] = c * (x[i-1] + x[i] + x[i+1])``."""
    out = x.clone()
    out[..., 1:-1] = (coeff * (x[..., :-2] + x[..., 1:-1] + x[..., 2:])).to(x.dtype)
    return out


def jacobi2d_3pt(x: Tensor, coeff: float = 1.0 / 3.0) -> Tensor:
    """3-point 2-D Jacobi (Fig. 8): ``c * (x[i-1,j] + x[i,j] + x[i+1,j])``."""
    interior = coeff * (x[..., :-2, 1:-1] + x[..., 1:-1, 1:-1] + x[..., 2:, 1:-1])
    return _interior_update_2d(x, interior, 1)


def lap_field(x: Tensor) -> Tensor:
    """Raw Laplacian values on the interior (shape shrinks by 2 per dim)."""
    return (
        4.0 * x[..., 1:-1, 1:-1]
        - x[..., 2:, 1:-1]
        - x[..., :-2, 1:-1]
        - x[..., 1:-1, 2:]
        - x[..., 1:-1, :-2]
    )


def laplacian(x: Tensor) -> Tensor:
    """COSMO 5-point Laplacian (Eq. 1), computed on the interior."""
    return _interior_update_2d(x, lap_field(x), 1)


def jacobi2d_5pt(x: Tensor, coeff: float = 0.2) -> Tensor:
    """PolyBench jacobi-2d: 5-point star average."""
    interior = coeff * (
        x[..., 1:-1, 1:-1]
        + x[..., 2:, 1:-1]
        + x[..., :-2, 1:-1]
        + x[..., 1:-1, 2:]
        + x[..., 1:-1, :-2]
    )
    return _interior_update_2d(x, interior, 1)


def jacobi2d_9pt(x: Tensor, coeff: float = 1.0 / 9.0) -> Tensor:
    """9-point box Jacobi: mean of the 3x3 neighbourhood."""
    acc = torch.zeros_like(x[..., 1:-1, 1:-1])
    rows, cols = x.shape[-2], x.shape[-1]
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            acc = acc + x[..., 1 + dr : rows - 1 + dr, 1 + dc : cols - 1 + dc]
    return _interior_update_2d(x, coeff * acc, 1)


def seidel2d_sweep(x: Tensor, coeff: float = 1.0 / 9.0) -> Tensor:
    """Parallel (Jacobi-style) 9-point sweep — the throughput-benchmark form."""
    return jacobi2d_9pt(x, coeff)


def seidel2d_exact(x: Tensor, coeff: float = 1.0 / 9.0) -> Tensor:
    """Exact PolyBench seidel-2d: in-place Gauss-Seidel, row-major order.

    Doubly sequential (each point reads already-updated west and north
    neighbours): a Python loop over points, so use small grids."""
    grid = x.clone().reshape((-1,) + tuple(x.shape[-2:]))
    rows, cols = grid.shape[-2], grid.shape[-1]
    for i in range(1, rows - 1):
        for j in range(1, cols - 1):
            s = (
                grid[:, i - 1, j - 1] + grid[:, i - 1, j] + grid[:, i - 1, j + 1]
                + grid[:, i, j - 1] + grid[:, i, j] + grid[:, i, j + 1]
                + grid[:, i + 1, j - 1] + grid[:, i + 1, j] + grid[:, i + 1, j + 1]
            )
            grid[:, i, j] = (coeff * s).to(grid.dtype)
    return grid.reshape(x.shape)


ELEMENTARY_FNS: dict[str, Callable[..., Tensor]] = {
    "jacobi1d": jacobi1d,
    "jacobi2d_3pt": jacobi2d_3pt,
    "laplacian": laplacian,
    "jacobi2d_5pt": jacobi2d_5pt,
    "jacobi2d_9pt": jacobi2d_9pt,
    "seidel2d": seidel2d_sweep,
}
