"""Horizontal diffusion (hdiff) — the paper's compound stencil (Eq. 1-4, Alg. 1).

The PyTorch counterpart of ``repro/core/hdiff.py``, written in the same
operation order so its float32 results are bit-identical to the JAX
reference's (each elementwise op rounds once, in the same sequence):

  * :func:`hdiff` — the full COSMO kernel with the *flux limiter*
    (Eq. 2-3: a flux is zeroed when it points up-gradient).
  * :func:`hdiff_simple` — Algorithm 1's unlimited polynomial form.
  * :func:`hdiff_staged` — every stage materialised as its own tensor, with
    a device synchronisation between stages on the card.

Grid convention: ``(depth, rows, cols)``. All computation happens on the
interior ``[2 : -2]`` in rows and cols — a radius-2 halo, because a flux
reads the Laplacian of a neighbour, which reads the neighbour's neighbour.
Boundary cells pass through. Everything runs where ``psi`` lives.
"""

from __future__ import annotations

import torch

from repro_torch.core.stencils import StencilSpec
from repro_torch.ir.programs import hdiff_program

Tensor = torch.Tensor

# Per-output-point op counts for the analytical model (§3.1), DERIVED from
# the port's IR dataflow graph: 26 MACs / 20 other ops / 13 reads / r=2.
_DERIVED = hdiff_program().spec()
HDIFF_SPEC = StencilSpec(
    name="hdiff",
    macs=_DERIVED.macs,
    other_ops=_DERIVED.other_ops,
    reads=_DERIVED.reads,
    radius=_DERIVED.radius,
)

# Radius of the compound stencil (flux-of-laplacian): 2 cells, inferred.
HALO = HDIFF_SPEC.radius


def _limit(dlap: Tensor, dpsi: Tensor) -> Tensor:
    """Flux limiter (Eq. 2-3): ``F = dL if dL * dpsi <= 0 else 0``."""
    return torch.where(dlap * dpsi <= 0, dlap, torch.zeros_like(dlap))


def _coeff_interior(coeff):
    if isinstance(coeff, Tensor) and coeff.ndim >= 2:
        return coeff[..., 2:-2, 2:-2]
    return coeff


def _hdiff_interior(psi: Tensor, coeff: Tensor | float, *, limit: bool) -> Tensor:
    """hdiff output on the interior: ``(..., R, C) -> (..., R-4, C-4)``."""
    lap = (
        4.0 * psi[..., 1:-1, 1:-1]
        - psi[..., 2:, 1:-1]
        - psi[..., :-2, 1:-1]
        - psi[..., 1:-1, 2:]
        - psi[..., 1:-1, :-2]
    )
    lap_c = lap[..., 1:-1, 1:-1]
    psi_c = psi[..., 2:-2, 2:-2]

    flx_r = lap[..., 2:, 1:-1] - lap_c
    flx_rm = lap_c - lap[..., :-2, 1:-1]
    flx_c = lap[..., 1:-1, 2:] - lap_c
    flx_cm = lap_c - lap[..., 1:-1, :-2]

    if limit:
        flx_r = _limit(flx_r, psi[..., 3:-1, 2:-2] - psi_c)
        flx_rm = _limit(flx_rm, psi_c - psi[..., 1:-3, 2:-2])
        flx_c = _limit(flx_c, psi[..., 2:-2, 3:-1] - psi_c)
        flx_cm = _limit(flx_cm, psi_c - psi[..., 2:-2, 1:-3])

    return psi_c - _coeff_interior(coeff) * ((flx_r - flx_rm) + (flx_c - flx_cm))


def _embed(psi: Tensor, interior: Tensor) -> Tensor:
    out = psi.clone()
    out[..., HALO:-HALO, HALO:-HALO] = interior.to(psi.dtype)
    return out


def hdiff(psi: Tensor, coeff: Tensor | float = 0.025) -> Tensor:
    """Full COSMO horizontal diffusion with flux limiter (Eq. 1-4).

    ``psi`` is ``(..., R, C)``; ``coeff`` a scalar or a field broadcastable
    to ``psi``. Returns the same shape, interior diffused, radius-2 border
    unchanged.
    """
    return _embed(psi, _hdiff_interior(psi, coeff, limit=True))


def hdiff_simple(psi: Tensor, coeff: Tensor | float = 0.025) -> Tensor:
    """Unlimited hdiff (Algorithm 1 / NERO-NARMADA form)."""
    return _embed(psi, _hdiff_interior(psi, coeff, limit=False))


def _sync(x: Tensor) -> Tensor:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def hdiff_staged(psi: Tensor, coeff: Tensor | float = 0.025, *, limit: bool = True) -> Tensor:
    """Stage-materialising hdiff: the Laplacian, the four fluxes and the
    output are each produced as separate tensors with a device
    synchronisation between stages (the single-AIE / load-store baseline
    of ``benchmarks/fig9_designs.py``). Numerically identical to
    :func:`hdiff`."""
    lap = _sync(
        4.0 * psi[..., 1:-1, 1:-1]
        - psi[..., 2:, 1:-1]
        - psi[..., :-2, 1:-1]
        - psi[..., 1:-1, 2:]
        - psi[..., 1:-1, :-2]
    )
    lap_c = lap[..., 1:-1, 1:-1]
    flx = [
        lap[..., 2:, 1:-1] - lap_c,
        lap_c - lap[..., :-2, 1:-1],
        lap[..., 1:-1, 2:] - lap_c,
        lap_c - lap[..., 1:-1, :-2],
    ]
    if limit:
        psi_c = psi[..., 2:-2, 2:-2]
        grads = (
            psi[..., 3:-1, 2:-2] - psi_c,
            psi_c - psi[..., 1:-3, 2:-2],
            psi[..., 2:-2, 3:-1] - psi_c,
            psi_c - psi[..., 2:-2, 1:-3],
        )
        flx = [_limit(f, g) for f, g in zip(flx, grads)]
    flx_r, flx_rm, flx_c, flx_cm = flx
    _sync(flx_cm)
    interior = psi[..., 2:-2, 2:-2] - _coeff_interior(coeff) * (
        (flx_r - flx_rm) + (flx_c - flx_cm)
    )
    return _embed(psi, interior)


def hdiff_flops(depth: int, rows: int, cols: int) -> int:
    """Total flops for one hdiff sweep (paper Eq. 5-7 op counts, as flops)."""
    interior = (rows - 2 * HALO) * (cols - 2 * HALO) * depth
    return interior * HDIFF_SPEC.flops


def hdiff_min_bytes(depth: int, rows: int, cols: int, itemsize: int = 4) -> int:
    """Minimum HBM traffic for one sweep: read grid + coeff once, write once
    (the JAX package's accounting, which charges a coefficient field; a
    scalar-coefficient kernel moves ``2 * depth * rows * cols * itemsize``)."""
    return (3 * depth * rows * cols) * itemsize


def hdiff_algorithmic_bytes(depth: int, rows: int, cols: int, itemsize: int = 4) -> int:
    """Paper Eq. 8-9 traffic model: every stencil read hits memory."""
    interior = (rows - 2 * HALO) * (cols - 2 * HALO) * depth
    reads = 5 * 5 * interior + 2 * 4 * interior  # Laplacian + flux streams
    writes = interior
    return (reads + writes) * itemsize
