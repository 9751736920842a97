"""The plain reference of the stencil cells, in PyTorch alone.

A frozen copy of COSMO's horizontal diffusion with the flux limiter (the
SPARTA paper's Eq. 1-4), written from the equations in the order the port's
own plain versions use, so that float32 on the card rounds as the port's
kernels are built to round (``-fmad=false``: each product and sum once).
It imports nothing of the port. Everything runs where its tensors live.

Grid convention: ``(depth, rows, cols)``. A sweep computes the interior
``[2:-2, 2:-2]`` of every plane and passes the radius-2 ring through, so
``repeat`` semantics (the ring re-applied between sweeps) are those of
sweeping again: the ring of each sweep's output is its input's ring.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

HALO = 2


def _limit(dlap: Tensor, dpsi: Tensor) -> Tensor:
    """Eq. 2-3: a flux that points up the gradient of the field is zeroed."""
    return torch.where(dlap * dpsi <= 0, dlap, torch.zeros_like(dlap))


def interior(psi: Tensor, coeff, *, limit: bool = True) -> Tensor:
    """One sweep's interior, ``(..., R, C) -> (..., R - 4, C - 4)``.
    ``coeff`` is a number or a full-shape field (read at the interior)."""
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
    if isinstance(coeff, Tensor) and coeff.ndim >= 2:
        coeff = coeff[..., 2:-2, 2:-2]
    return psi_c - coeff * ((flx_r - flx_rm) + (flx_c - flx_cm))


def sweep(psi: Tensor, coeff, *, limit: bool = True) -> Tensor:
    """One hdiff sweep of the whole field: the interior diffused, the ring
    kept."""
    out = psi.clone()
    out[..., HALO:-HALO, HALO:-HALO] = interior(psi, coeff, limit=limit).to(psi.dtype)
    return out


def sweeps(psi: Tensor, coeff, n: int, *, limit: bool = True, block: int = 8) -> Tensor:
    """``n`` sweeps (``repeat`` semantics), ``block`` planes at a time so
    that the temporaries of a large field fit beside it."""
    out = torch.empty_like(psi)
    for first in range(0, psi.shape[0], block):
        x = psi[first:first + block]
        for _ in range(n):
            x = sweep(x, coeff, limit=limit)
        out[first:first + block] = x
    return out
