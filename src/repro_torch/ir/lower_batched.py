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

  * ``sharded-reference`` / ``sharded-cuda`` —
    :func:`~repro_torch.ir.lower_sharded.lower_sharded` over ``mesh`` (or
    ``mesh_shape=(R, C)``) with the evaluator or K2 inside each shard; the
    callable is SPMD (this rank's block in, this rank's block out). Their
    backward recomputes forward sweeps with the ring lowering and runs the
    adjoint and augmented sweeps with ``boundary="zero"``.

``lower_batched``, the ensemble lowering over a member axis, is not ported
yet.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.ir.autodiff import differentiable_lowering
from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.lower_cuda import lower_cuda
from repro_torch.ir.lower_reference import lower_reference
from repro_torch.ir.lower_sharded import lower_sharded

BACKENDS = ("reference", "staged", "cuda")
SHARDED_BACKENDS = ("sharded-reference", "sharded-cuda")


def build_backend(
    program: StencilProgram,
    backend: str,
    *,
    mesh=None,
    mesh_shape: tuple[int, int] | None = None,
    device=None,
    overlap: bool = False,
    merge_exchange: bool = True,
    differentiable: bool = False,
) -> Callable:
    """One lowered callable for ``backend`` (:data:`BACKENDS` or
    :data:`SHARDED_BACKENDS`; the sharded ones take ``mesh`` — a
    ("rows", "cols") mesh — or ``mesh_shape``, and ``device``, ``overlap``
    and ``merge_exchange`` as :func:`lower_sharded` does).

    With ``differentiable=True`` the callable carries a
    ``torch.autograd.Function`` whose backward runs the program's ADJOINT IR
    through the same backend (``staged`` pairs with a ``reference``
    backward)."""
    if backend in SHARDED_BACKENDS:
        if mesh is None and mesh_shape is None:
            raise ValueError(
                f"backend {backend!r} needs mesh= or mesh_shape=(R, C) — the rows x "
                "cols mesh the shards map onto"
            )
        where = (dict(mesh_shape=mesh_shape, device=device) if mesh is None else
                 dict(mesh=mesh, depth_axis=None, row_axis="rows", col_axis="cols"))

        def sharded(p, boundary="ring"):
            return lower_sharded(p, inner=backend.removeprefix("sharded-"),
                                 overlap=overlap and boundary == "ring",
                                 merge_exchange=merge_exchange, boundary=boundary, **where)

        fwd = sharded(program)
        if not differentiable:
            return fwd
        return differentiable_lowering(
            program, fwd, sharded, build_zero=lambda p: sharded(p, "zero"),
            placement=fwd.placement,
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
