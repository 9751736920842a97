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

:func:`lower_batched`, the port of ``repro/ir/lower_batched.py::lower_batched``,
runs any of :data:`BATCHED_BACKENDS` over a leading ensemble-member axis:
N perturbed initial conditions (or N tenants' scenarios on one grid) share
one call. The JAX package wraps the lowering in ``jax.vmap``; a ctypes
launch cannot be vmapped, and needs not be: every op of a 2-D program acts
on rows and columns only, so depth planes are independent and members can
ride the depth axis. The batched callable views a contiguous ``(N, D, R,
C)`` field as ``(N*D, R, C)``, makes ONE call of the unbatched lowering and
views each output back as ``(N, D, R, C)``:

  * member i of the batched output is bit-equal to the unbatched call on
    member i's fields, on every backend, by construction;
  * on CUDA tensors a batched step of ``cuda`` is one K2 launch over N*D
    planes, not one a member (an N-output launch for a multi-output
    program; past 65535 planes, consecutive launches of at most that many);
    on CPU tensors it is K2's plain version;
  * the sharded backends stay SPMD: the callable takes this rank's block
    ``(N, D_local, r, c)`` and folds the members into the block's depth,
    so one halo exchange a round carries every member's bands in the same
    messages, N times the unbatched bytes (what
    :func:`repro_torch.dist.halo.count_wire` counts). With ``mesh=`` and a
    depth axis, the members fold into the local depth after the split.

The backends' names are the JAX package's with ``cuda`` for ``pallas``.
"""

from __future__ import annotations

from typing import Callable, Mapping

from repro_torch.ir.autodiff import differentiable_lowering
from repro_torch.ir.graph import StencilProgram
from repro_torch.ir.lower_cuda import lower_cuda
from repro_torch.ir.lower_reference import lower_reference
from repro_torch.ir.lower_sharded import lower_sharded
from repro_torch.obs import metrics

BACKENDS = ("reference", "staged", "cuda")
SHARDED_BACKENDS = ("sharded-reference", "sharded-cuda")
#: The backends a batched lowering can wrap: the conformance backends but
#: "staged" (a per-op dispatch gains nothing from a member axis).
BATCHED_BACKENDS = ("reference", "cuda", "sharded-reference", "sharded-cuda")


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


def lower_batched(
    program: StencilProgram,
    *,
    backend: str = "reference",
    mesh=None,
    mesh_shape: tuple[int, int] | None = None,
    device=None,
    overlap: bool = False,
    merge_exchange: bool = True,
) -> Callable:
    """Builds ``x (N, D, R, C) -> program(x)`` over the leading member axis.

    Args:
      program: a 2-D IR program (1-D programs batch over their own leading
        axis already).
      backend: one of :data:`BATCHED_BACKENDS`. The sharded ones need
        ``mesh`` or ``mesh_shape``; the member axis rides unsharded.
      mesh / mesh_shape / device / overlap / merge_exchange: forwarded to
        the wrapped lowering (:func:`build_backend`).

    The callable takes one batched tensor per declared input (a ``{field:
    (N, *grid)}`` mapping, or the bare tensor for single-input programs)
    and returns ``(N, *grid)``, or ``{field: (N, *grid)}`` for multi-output
    programs. The whole batch is one call of the unbatched lowering over
    ``(N*D, R, C)`` (see the module docstring).
    """
    if program.ndim != 2:
        raise ValueError(
            f"lower_batched supports 2-D programs, got ndim={program.ndim}"
        )
    if backend not in BATCHED_BACKENDS:
        raise ValueError(
            f"unknown batched backend {backend!r} (want one of {BATCHED_BACKENDS})"
        )
    if backend in ("reference", "cuda") and (mesh is not None or mesh_shape is not None):
        raise ValueError(
            f"backend {backend!r} is single-device; mesh_shape only applies "
            "to the sharded backends"
        )
    base = build_backend(program, backend, mesh=mesh, mesh_shape=mesh_shape, device=device,
                         overlap=overlap, merge_exchange=merge_exchange)
    fields = program.inputs
    grid_ndim = program.ndim + 1  # (depth, rows, cols)

    def fn(x):
        if isinstance(x, Mapping):
            missing = [f for f in fields if f not in x]
            if missing:
                raise ValueError(
                    f"program {program.name!r} batched field mapping is "
                    f"missing input(s) {missing}; declared inputs are "
                    f"{list(fields)}"
                )
            arrays = [x[f] for f in fields]
        else:
            if len(fields) != 1:
                raise ValueError(
                    f"program {program.name!r} has inputs {fields}; pass a mapping"
                )
            arrays = [x]
        for f, a in zip(fields, arrays):
            if a.ndim != grid_ndim + 1:
                raise ValueError(
                    f"batched field {f!r} must be (members, depth, rows, cols)"
                    f" — {grid_ndim + 1}-D — got shape {tuple(a.shape)}; "
                    "members lead, grid trails"
                )
            if a.shape != arrays[0].shape:
                raise ValueError(
                    f"all batched fields must share one (members, *grid) "
                    f"shape; {f!r} has {tuple(a.shape)} vs {fields[0]!r} "
                    f"{tuple(arrays[0].shape)}"
                )
        n, depth, *plane = arrays[0].shape
        folded = [a.reshape(n * depth, *plane) for a in arrays]
        out = base(dict(zip(fields, folded)) if isinstance(x, Mapping) else folded[0])
        if isinstance(out, Mapping):
            return {f: v.reshape(n, depth, *v.shape[1:]) for f, v in out.items()}
        return out.reshape(n, depth, *out.shape[1:])

    return metrics.instrument_call(fn, f"ir.lower_batched.{program.name}.{backend}")
