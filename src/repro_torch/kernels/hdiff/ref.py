"""Plain-PyTorch oracles for the hdiff kernels.

The counterpart of ``repro/kernels/hdiff/ref.py``: a re-export of the core
implementation as the float oracle, plus the fixed-point (int32) variant
that mirrors the paper's ``i32`` datapath (§5.1.1, Fig. 9).
"""

from __future__ import annotations

import torch

from repro_torch.core.hdiff import hdiff as hdiff_ref  # noqa: F401  (canonical f32 oracle)
from repro_torch.core.hdiff import hdiff_simple as hdiff_simple_ref  # noqa: F401


def hdiff_fixed_point_ref(psi_q: torch.Tensor, coeff_num: int, coeff_shift: int) -> torch.Tensor:
    """int32 fixed-point hdiff oracle (the paper's i32 datapath).

    ``coeff = coeff_num / 2**coeff_shift``. All arithmetic is int32 and
    wraps on overflow like the JAX reference; the final coefficient multiply
    is a multiply + arithmetic right shift, matching an AIE fixed-point MAC
    + srs() round.
    """
    if psi_q.dtype != torch.int32:
        raise TypeError(f"expected an int32 field, got {psi_q.dtype}")
    lap = (
        4 * psi_q[..., 1:-1, 1:-1]
        - psi_q[..., 2:, 1:-1]
        - psi_q[..., :-2, 1:-1]
        - psi_q[..., 1:-1, 2:]
        - psi_q[..., 1:-1, :-2]
    )
    lap_c = lap[..., 1:-1, 1:-1]
    flx_r = lap[..., 2:, 1:-1] - lap_c
    flx_rm = lap_c - lap[..., :-2, 1:-1]
    flx_c = lap[..., 1:-1, 2:] - lap_c
    flx_cm = lap_c - lap[..., 1:-1, :-2]

    # Sign-based limiter: ``a * b <= 0`` without the (overflowing) int32
    # product — true iff either operand is zero or the signs differ.
    def _keep(a, b):
        return (a == 0) | (b == 0) | ((a > 0) != (b > 0))

    psi_c = psi_q[..., 2:-2, 2:-2]
    zero = torch.zeros_like(flx_r)
    flx_r = torch.where(_keep(flx_r, psi_q[..., 3:-1, 2:-2] - psi_c), flx_r, zero)
    flx_rm = torch.where(_keep(flx_rm, psi_c - psi_q[..., 1:-3, 2:-2]), flx_rm, zero)
    flx_c = torch.where(_keep(flx_c, psi_q[..., 2:-2, 3:-1] - psi_c), flx_c, zero)
    flx_cm = torch.where(_keep(flx_cm, psi_c - psi_q[..., 2:-2, 1:-3]), flx_cm, zero)

    total = (flx_r - flx_rm) + (flx_c - flx_cm)
    interior = psi_c - ((total * coeff_num) >> coeff_shift)
    out = psi_q.clone()
    out[..., 2:-2, 2:-2] = interior
    return out
