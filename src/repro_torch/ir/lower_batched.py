"""One dispatch point over the port's lowerings: ``build_backend``.

The counterpart of ``repro/ir/lower_batched.py::build_backend``: a
conformance-style backend name becomes one unbatched lowered callable, and
``differentiable=True`` attaches the derived adjoint
(:mod:`repro_torch.ir.autodiff`) as its backward. The backends:

  * ``reference`` — :func:`~repro_torch.ir.lower_reference.lower_reference`
    (eager PyTorch, the whole DAG per call);
  * ``staged`` — the same, one op at a time; its backward runs through
    ``reference`` (a per-op dispatch of an adjoint DAG would be all
    overhead, and the gradient contract is backend-independent);
  * ``cuda`` — :func:`~repro_torch.ir.lower_cuda.lower_cuda`, the generated
    fused kernel (K2), the counterpart of ``pallas``: forward, augmented
    forward and adjoint are each one launch a sweep on CUDA tensors, and
    each the kernel's plain version on CPU tensors.

The sharded backends (``sharded-reference``, ``sharded-cuda``) need the
distributed lowering and raise until it is ported (ROADMAP M9);
``lower_batched``, the ensemble lowering over a member axis, is ROADMAP
M10.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.ir.autodiff import differentiable_lowering
from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.lower_cuda import lower_cuda
from repro_torch.ir.lower_reference import lower_reference

BACKENDS = ("reference", "staged", "cuda")
SHARDED_BACKENDS = ("sharded-reference", "sharded-cuda")


def build_backend(
    program: StencilProgram,
    backend: str,
    *,
    differentiable: bool = False,
) -> Callable:
    """One lowered callable for ``backend`` (:data:`BACKENDS`).

    With ``differentiable=True`` the callable carries a
    ``torch.autograd.Function`` whose backward runs the program's ADJOINT IR
    through the same backend (``staged`` pairs with a ``reference``
    backward)."""
    if backend in SHARDED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} needs the distributed lowering "
            "(lower_sharded), which is ROADMAP M9 of the port"
        )
    if backend == "reference":
        fwd = lower_reference(program)
    elif backend == "staged":
        fwd = lower_reference(program, mode="staged")
    elif backend == "cuda":
        fwd = lower_cuda(program)
    else:
        raise ValueError(
            f"unknown backend {backend!r} (want one of {BACKENDS + SHARDED_BACKENDS})"
        )
    if not differentiable:
        return fwd
    bwd_backend = "reference" if backend == "staged" else backend
    return differentiable_lowering(
        program, fwd, lambda p: build_backend(p, bwd_backend)
    )
