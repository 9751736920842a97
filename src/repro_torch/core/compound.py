"""Compound-stencil composition with explicit execution policies.

The counterpart of ``repro/core/compound.py``, a thin policy layer over the
port's IR lowerings:

  * :class:`CompoundStencil` — wraps a :class:`repro_torch.ir.StencilProgram`
    and dispatches its three execution policies, the counterparts of the JAX
    package's ``staged`` / ``fused-xla`` / ``fused-pallas``:
      - ``staged``      ``ir.lower_reference(mode="staged")`` — every stage
                        materialised, the device synchronised between stages
                        (single-AIE / load-store baseline, slow side of Fig. 9);
      - ``fused-eager`` ``ir.lower_reference(mode="fused")`` — the whole DAG
                        in one eager call (``fused-xla``'s counterpart; PyTorch
                        still runs one kernel per op);
      - ``fused-cuda``  ``ir.lower_cuda`` — the generated fused CUDA kernel,
                        intermediates in shared memory (``fused-pallas``'s
                        counterpart, the multi-AIE/B-block analogue).
  * :class:`StencilStage` — per-op accounting view derived from the graph.
  * :func:`plan_partition` — the B-block planner over depth x rows shards,
    evaluating the analytical model's three roofline terms; it defaults to
    the :data:`~repro_torch.core.analytical.H100_SXM` machine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import hdiff as hdiff_mod
from repro_torch.core.analytical import H100_SXM, MachineModel, roofline_terms
from repro_torch.device import resolve_device
from repro_torch.ir import StencilProgram, hdiff_program, lower_cuda, lower_reference

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StencilStage:
    """Accounting view of one stage of a compound stencil (metadata only)."""

    name: str
    inputs: tuple[str, ...]
    macs: int
    other_ops: int
    reads: int
    evaluations: int = 1

    @property
    def flops(self) -> int:
        return 2 * self.macs + self.other_ops


class CompoundStencil:
    """An IR program placed on a device, plus the three named execution
    policies.

    ``device=None`` means ``"cuda"`` (without a card pass ``device="cpu"``);
    :meth:`apply` takes tensors on that device and runs there — a CPU
    stencil's ``fused-cuda`` policy computes the kernel's plain version."""

    POLICIES = ("staged", "fused-eager", "fused-cuda")

    def __init__(self, name: str, program: StencilProgram, *, device=None):
        self.name = name
        self.program = program
        self.device = resolve_device(device)
        self.radius = program.radius
        evals = program.evaluations()
        self.stages = tuple(
            StencilStage(
                name=op.name,
                inputs=op.fields(),
                macs=op.cost.macs,
                other_ops=op.cost.other_ops,
                reads=len(op.reads),
                evaluations=evals[op.name],
            )
            for op in program.ops
        )
        self._fused = lower_reference(program, mode="fused")
        self._staged = lower_reference(program, mode="staged")
        self._cuda: Callable = lower_cuda(program)

    # -- execution policies ------------------------------------------------

    def apply(self, x, policy: str = "fused-eager"):
        leaves = x.values() if isinstance(x, dict) else (x,)
        for a in leaves:
            if a.device.type != self.device.type:
                raise ValueError(
                    f"{self.name}: input on {a.device}, but the stencil was "
                    f"placed on {self.device}"
                )
        if policy == "fused-eager":
            return self._fused(x)
        if policy == "staged":
            return self._staged(x)
        if policy == "fused-cuda":
            return self._cuda(x)
        raise ValueError(f"unknown policy {policy!r} (want one of {self.POLICIES})")

    # -- analytical accounting (§3.1), graph-derived -------------------------

    def total_flops(self, interior_points: int) -> int:
        return interior_points * self.program.spec().flops

    def staged_bytes(self, interior_points: int, itemsize: int = 4) -> int:
        return self.program.staged_bytes(interior_points, itemsize)

    def fused_bytes(self, total_points: int, itemsize: int = 4) -> int:
        return self.program.fused_bytes(total_points, itemsize)


def make_hdiff_compound(
    coeff: float = 0.025, limit: bool = True, *, device=None
) -> CompoundStencil:
    """hdiff as an explicit compound DAG (Laplacian -> fluxes -> output)."""
    return CompoundStencil("hdiff", hdiff_program(coeff, limit=limit), device=device)


# ---------------------------------------------------------------------------
# The B-block planner: partition choice driven by the analytical model.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A chosen domain decomposition for a (grid, mesh) pair."""

    kind: str              # "depth" | "rows" | "depth+rows"
    depth_shards: int
    row_shards: int
    halo: int
    # Predicted per-device roofline terms (seconds) for one sweep.
    compute_s: float
    hbm_s: float
    ici_s: float

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.hbm_s, self.ici_s)


def plan_partition(
    depth: int,
    rows: int,
    cols: int,
    n_devices: int,
    *,
    halo: int | None = None,
    itemsize: int = 4,
    machine: MachineModel = H100_SXM,
    flops_per_point: int | None = None,
    program: StencilProgram | None = None,
) -> PartitionPlan:
    """Chooses how to shard a (depth, rows, cols) grid over ``n_devices``
    (§3.4): enumerates the depth x rows factorisations, evaluates the three
    roofline terms per device, and picks the minimum bottleneck term. With
    ``program`` given, halo and flops/point come from the graph analysis."""
    if program is not None:
        spec = program.spec()
        halo = spec.radius if halo is None else halo
        flops_per_point = spec.flops if flops_per_point is None else flops_per_point
    if halo is None:
        halo = hdiff_mod.HALO
    if flops_per_point is None:
        flops_per_point = hdiff_mod.HDIFF_SPEC.flops
    best: PartitionPlan | None = None
    for d_sh in _divisors(n_devices):
        r_sh = n_devices // d_sh
        if depth % d_sh or d_sh > depth:
            continue
        if (rows - 2 * halo) // r_sh < 2 * halo + 1:
            continue  # shards thinner than the halo make no sense
        local_depth = depth // d_sh
        local_rows = rows // r_sh + (2 * halo if r_sh > 1 else 0)
        points = local_depth * local_rows * cols
        flops = points * flops_per_point
        hbm_bytes = 3 * points * itemsize  # in + coeff + out, fused policy
        # Halo exchange: 2 faces x halo rows x cols x depth, both directions.
        ici_bytes = 0 if r_sh == 1 else 2 * halo * cols * local_depth * itemsize * 2
        comp_s, hbm_s, ici_s = roofline_terms(flops, hbm_bytes, ici_bytes, machine)
        kind = "depth" if r_sh == 1 else ("rows" if d_sh == 1 else "depth+rows")
        cand = PartitionPlan(kind, d_sh, r_sh, halo, comp_s, hbm_s, ici_s)
        if best is None or cand.step_s < best.step_s:
            best = cand
    if best is None:
        # Grid too small to fill every device: underfill the mesh with the
        # largest depth-parallel plan instead of failing.
        d_sh = max(d for d in _divisors(depth) if d <= n_devices)
        points = (depth // d_sh) * rows * cols
        comp_s, hbm_s, ici_s = roofline_terms(
            points * flops_per_point, 3 * points * itemsize, 0, machine
        )
        return PartitionPlan("depth-underfilled", d_sh, 1, halo, comp_s, hbm_s, ici_s)
    return best


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]
