"""Public entry points for the hdiff kernels.

The counterpart of ``repro/kernels/hdiff/ops.py``. Each call runs where
its tensor lives: a CUDA tensor launches the hand-written kernel (K1 / K3),
a CPU tensor computes the kernel's plain version. ``hdiff_fused_ad`` is the
differentiable form: K1 forward, the derived adjoint of the IR twin
backward.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.hdiff import HALO
from repro_torch.ir.autodiff import make_vjp
from repro_torch.ir.lower_cuda import lower_cuda
from repro_torch.ir.programs import hdiff_coupled_program
from repro_torch.kernels.hdiff.kernel import hdiff_cuda, hdiff_fixed_cuda
from repro_torch.obs import profile


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
    applies the Eq. 2-3 flux limiter (the production COSMO form). A
    profiler sees the call as the span ``kernels.hdiff_fused``."""
    with profile.span("kernels.hdiff_fused"):
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


# -- differentiable wrapper ---------------------------------------------------
#
# K1 has no hand-written backward, so the differentiable entry point pairs
# the kernel FORWARD with the DERIVED-ADJOINT backward of the IR twin
# (``hdiff_coupled_program``, whose coefficient is a field): one augmented
# forward and one adjoint sweep through the generated kernel (K2) on the
# card, their plain versions on the CPU. The adjoint's linearization
# recompute costs one extra hdiff sweep, the same trade as remat.


@functools.lru_cache(maxsize=None)
def _coupled_vjp(limit: bool):
    return make_vjp(hdiff_coupled_program(limit=limit), lower_cuda)


class _HdiffFusedAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi, coeff, limit):
        ctx.limit = limit
        ctx.save_for_backward(psi, coeff)
        return hdiff_fused(psi, coeff, limit=limit)

    @staticmethod
    def backward(ctx, g):
        psi, coeff = ctx.saved_tensors
        # The IR twin takes a coefficient FIELD: the scalar broadcasts in and
        # its cotangent is the sum over the broadcast, accumulated in float64
        # (its terms cancel: at 2x24x24 they sum to 0.64 from magnitudes
        # adding up to 393, so a float32 sum depends on its order by ~1e-5).
        field = coeff.to(psi.dtype).expand(psi.shape).contiguous()
        with torch.no_grad():
            cot = _coupled_vjp(ctx.limit)({"u": psi, "coeff": field}, g.contiguous())
        dcoeff = cot["coeff"].sum(dtype=torch.float64).to(coeff.dtype).reshape(coeff.shape)
        return cot["u"], dcoeff, None


def hdiff_fused_ad(
    psi: torch.Tensor, coeff: float | torch.Tensor, limit: bool = True
) -> torch.Tensor:
    """:func:`hdiff_fused` with a derived-adjoint backward: gradients flow
    to ``psi`` and to a scalar tensor ``coeff`` (a Python number is a
    constant). Forward: one K1 launch; backward: two K2 launches (the
    augmented forward and the adjoint of ``hdiff_coupled_program``) on CUDA
    tensors."""
    if not isinstance(coeff, torch.Tensor):
        coeff = torch.tensor(float(coeff), device=psi.device)
    return _HdiffFusedAD.apply(psi, coeff, limit)
