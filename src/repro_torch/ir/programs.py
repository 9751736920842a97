"""The paper's stencils expressed as IR programs.

``hdiff_program`` is the compound COSMO horizontal diffusion (Eq. 1-4): a
5-point Laplacian, four limited fluxes, and the coefficient update — six ops
over two source-consumed fields. The five elementary §3.5 stencils are each
a single affine op. Halo, op counts, and footprints for all of them are
*derived* by the graph analysis. This module is the port's copy of
``repro/ir/programs.py``: same programs, same tap orders, same
fingerprints (``tests/test_torch_ir_graph.py`` holds the two against each
other).

``MULTIFIELD_PROGRAMS`` holds the multi-input workloads (the larger-dycore
fragments NERO/StencilFlow motivate): ``vadvc_program`` (vertical advection,
velocity + scalar fields) and ``hdiff_coupled_program`` (hdiff with a
diffusion-coefficient *field*). Per-field halos, reads and wire bytes are
derived per field and summed.

``MULTIOUTPUT_PROGRAMS`` holds the coupled PDE systems (whole-model
timesteps): ``shallow_water_program`` evolves {u, v, h} together through
the gravity-wave coupling, ``advection_diffusion_program`` evolves {c, u}
over a shared velocity field — several ``outputs`` per sweep.

``hdiff1d_program`` and ``smooth1d_program`` are the port's own: 1-D
chains whose intermediates are read at non-zero offsets, which the 1-D
kernel (K5') must handle beside ``jacobi1d``. The JAX package has no such
programs; its combinators build the same DAGs, fingerprints equal
(``tests/test_torch_lower_cuda.py``).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.ir.graph import StencilProgram, repeat
from repro_torch.ir.ops import affine, flux, product, scaled_residual, weighted_residual

# Tap orders deliberately mirror the hand-written kernels' evaluation order
# (see repro_torch/core/{hdiff,stencils}.py) so lowered outputs are bit-identical.
_LAP_TAPS = {(0, 0): 4.0, (1, 0): -1.0, (-1, 0): -1.0, (0, 1): -1.0, (0, -1): -1.0}


def hdiff_program(coeff: float = 0.025, *, limit: bool = True) -> StencilProgram:
    """COSMO horizontal diffusion as a 6-op DAG (Eq. 1-4 / Alg. 1).

    ``limit=True`` is the production flux-limited kernel; ``limit=False`` is
    Algorithm 1's unlimited polynomial form (NERO/NARMADA baseline).
    """
    lim = "psi" if limit else None
    ops = [
        affine("lap", "psi", _LAP_TAPS),
        flux("flx_r", "lap", lo=(0, 0), hi=(1, 0), limiter=lim),
        flux("flx_rm", "lap", lo=(-1, 0), hi=(0, 0), limiter=lim),
        flux("flx_c", "lap", lo=(0, 0), hi=(0, 1), limiter=lim),
        flux("flx_cm", "lap", lo=(0, -1), hi=(0, 0), limiter=lim),
        scaled_residual(
            "out",
            "psi",
            [("flx_r", 1), ("flx_rm", -1), ("flx_c", 1), ("flx_cm", -1)],
            coeff,
        ),
    ]
    return StencilProgram("hdiff" if limit else "hdiff_simple", ["psi"], ops)


def hdiff_multistep_program(
    k: int, coeff: float = 0.025, *, limit: bool = True
) -> StencilProgram:
    """``k`` temporally-blocked hdiff sweeps: ``repeat(hdiff_program(), k)``.

    One fused application simulates ``k`` timesteps per HBM (and, sharded,
    per wire) round-trip; radius is ``2 * k``. The k=2 instance is what
    ``kernels.hdiff.multistep.hdiff_twostep`` wraps.
    """
    return repeat(hdiff_program(coeff, limit=limit), k)


def hdiff_coupled_program(*, limit: bool = True) -> StencilProgram:
    """hdiff with a spatially-varying diffusion coefficient *field*.

    The COSMO/Smagorinsky pattern NERO couples hdiff with: the Eq. 4 update
    scales the flux divergence by a per-point coefficient (derived from the
    local deformation in the full model) instead of the baked-in scalar —
    two source fields, ``u`` (the evolving state, radius 2) and ``coeff``
    (read at offset zero only, radius 0, so it exchanges NO halo at k=1;
    under ``repeat(p, k)`` its composed radius grows to ``2 (k-1)`` while
    ``u``'s grows to ``2 k`` — both derived, both tested).
    """
    lim = "u" if limit else None
    ops = [
        affine("lap", "u", _LAP_TAPS),
        flux("flx_r", "lap", lo=(0, 0), hi=(1, 0), limiter=lim),
        flux("flx_rm", "lap", lo=(-1, 0), hi=(0, 0), limiter=lim),
        flux("flx_c", "lap", lo=(0, 0), hi=(0, 1), limiter=lim),
        flux("flx_cm", "lap", lo=(0, -1), hi=(0, 0), limiter=lim),
        weighted_residual(
            "out",
            "u",
            "coeff",
            [("flx_r", 1), ("flx_rm", -1), ("flx_c", 1), ("flx_cm", -1)],
        ),
    ]
    return StencilProgram(
        "hdiff_coupled" if limit else "hdiff_coupled_simple",
        ["u", "coeff"],
        ops,
        passthrough="u",
    )


def vadvc_program(dt: float = 0.25) -> StencilProgram:
    """NERO-style vertical-advection fragment: 2 fields, level-offset reads.

    The vertical dimension maps to the IR's leading stencil dim (``rows`` of
    the ``(batch, levels, columns)`` grid — depth planes are hdiff's
    embarrassingly-parallel dim, but vadvc couples *along* the column, so
    levels take the halo-carrying axis). One explicit advection sweep of a
    scalar ``s`` by a face-staggered vertical velocity ``w``:

      wbar = (w[k] + w[k+1]) / 2          destagger to cell centres
      grad = (s[k+1] - s[k-1]) / 2        centered level gradient
      out  = s - dt * wbar * grad

    Per-field radii: ``s`` 1 (the gradient), ``w`` 1 (the destagger) —
    BOTH fields exchange a halo when sharded, unlike ``hdiff_coupled``'s
    radius-0 coefficient, so the two workloads cover both sides of the
    per-field exchange logic.
    """
    ops = [
        affine("wbar", "w", {(0, 0): 0.5, (1, 0): 0.5}),
        affine("grad", "s", {(1, 0): 0.5, (-1, 0): -0.5}),
        product("adv", "wbar", "grad"),
        scaled_residual("out", "s", [("adv", 1)], dt),
    ]
    return StencilProgram("vadvc", ["s", "w"], ops, passthrough="s")


def smagorinsky_coeff(noise):
    """Deterministic positive diffusion-coefficient field from unit noise:
    0.025 modulated +-25% through tanh. The ONE generator every
    hdiff_coupled test/benchmark feeds the ``coeff`` input with, so the
    conformance oracle, the paper-grid acceptance and fig13 all stress the
    same coefficient regime (works on numpy arrays and CPU tensors alike)."""
    import numpy as np

    return np.asarray(0.025 * (1.0 + 0.25 * np.tanh(np.asarray(noise))), np.float32)


MULTIFIELD_PROGRAMS: dict[str, Callable[[], StencilProgram]] = {
    "vadvc": vadvc_program,
    "hdiff_coupled": hdiff_coupled_program,
}


def shallow_water_program(
    g_dt: float = 0.2, h_dt: float = 0.2
) -> StencilProgram:
    """Linearised shallow-water gravity-wave step: the canonical coupled
    system a weather timestep runs — THREE evolving fields in one sweep.

    One explicit (Jacobi-style, simultaneous) update on an unstaggered grid:

      u' = u - g_dt * dh/dx          momentum, pressure-gradient force
      v' = v - g_dt * dh/dy
      h' = h - h_dt * (du/dx + dv/dy)   continuity, divergence of OLD (u, v)

    with centered differences (radius 1 per sweep, all three outputs).
    ``outputs={"u": ..., "v": ..., "h": ...}`` makes it one multi-output IR
    program: one fused kernel computes all three updates from one on-chip
    residency, the sharded lowering moves all three halos in ONE merged
    exchange per k sweeps, and ``repeat(p, k)`` couples the sweeps so each
    output's radius composes to ``k`` (u' at sweep 2 reads sweep 1's h,
    which read sweep 1's... — the gravity-wave coupling the per-output
    footprint analysis has to get right).

    Defaults keep the scheme comfortably inside the CFL bound on unit-noise
    fields, so k<=3 conformance stays in a tame numeric range.
    """
    ops = [
        affine("dhdx", "h", {(1, 0): 0.5, (-1, 0): -0.5}),
        affine("dhdy", "h", {(0, 1): 0.5, (0, -1): -0.5}),
        scaled_residual("u_new", "u", [("dhdx", 1)], g_dt),
        scaled_residual("v_new", "v", [("dhdy", 1)], g_dt),
        affine("dudx", "u", {(1, 0): 0.5, (-1, 0): -0.5}),
        affine("dvdy", "v", {(0, 1): 0.5, (0, -1): -0.5}),
        scaled_residual("h_new", "h", [("dudx", 1), ("dvdy", 1)], h_dt),
    ]
    return StencilProgram(
        "shallow_water",
        ["u", "v", "h"],
        ops,
        outputs={"u": "u_new", "v": "v_new", "h": "h_new"},
    )


def advection_diffusion_program(
    nu: float = 0.05, dt: float = 0.1, kappa: float = 0.05
) -> StencilProgram:
    """Passive scalar advected by a self-diffusing flow: TWO evolving fields
    plus one SHARED (non-evolving) field in a single sweep.

    ``c`` (the scalar) and ``u`` (the row-velocity) both evolve; ``v`` (the
    column-velocity) is a shared input read at offset zero:

      u' = u - nu * lap(u)                     the carrier diffuses
      c' = (c - dt * (u * dc/dx + v * dc/dy)) - kappa * lap(c)

    Radii per sweep: both outputs 1; shared ``v`` radius 0 at k=1, growing
    to ``k - 1`` under ``repeat`` (read through the downstream sweeps) —
    the multi-output analogue of ``hdiff_coupled``'s radius-0 coefficient,
    so the merged sharded exchange gets a radius-0 shared field AND a
    two-field evolving group in one program.
    """
    ops = [
        affine("lap_u", "u", _LAP_TAPS),
        scaled_residual("u_new", "u", [("lap_u", 1)], nu),
        affine("gcr", "c", {(1, 0): 0.5, (-1, 0): -0.5}),
        affine("gcc", "c", {(0, 1): 0.5, (0, -1): -0.5}),
        product("advr", "u", "gcr"),
        product("advc", "v", "gcc"),
        scaled_residual("cadv", "c", [("advr", 1), ("advc", 1)], dt),
        affine("lap_c", "c", _LAP_TAPS),
        scaled_residual("c_new", "cadv", [("lap_c", 1)], kappa),
    ]
    return StencilProgram(
        "advection_diffusion",
        ["c", "u", "v"],
        ops,
        outputs={"c": "c_new", "u": "u_new"},
    )


MULTIOUTPUT_PROGRAMS: dict[str, Callable[[], StencilProgram]] = {
    "shallow_water": shallow_water_program,
    "advection_diffusion": advection_diffusion_program,
}


def jacobi1d_program(coeff: float = 1.0 / 3.0) -> StencilProgram:
    taps = {(-1,): coeff, (0,): coeff, (1,): coeff}
    return StencilProgram("jacobi1d", ["x"], [affine("out", "x", taps)], ndim=1)


def hdiff1d_program(coeff: float = 0.025, *, limit: bool = True) -> StencilProgram:
    """hdiff along a row: a 3-point Laplacian, the row's two (limited)
    fluxes and the scaled residual — radius 2, the Laplacian read at
    offsets -1, 0 and +1."""
    lim = "psi" if limit else None
    ops = [
        affine("lap", "psi", {(0,): 2.0, (1,): -1.0, (-1,): -1.0}),
        flux("flx", "lap", lo=(0,), hi=(1,), limiter=lim),
        flux("flx_m", "lap", lo=(-1,), hi=(0,), limiter=lim),
        scaled_residual("out", "psi", [("flx", 1), ("flx_m", -1)], coeff, ndim=1),
    ]
    return StencilProgram("hdiff1d", ["psi"], ops, ndim=1)


def smooth1d_program() -> StencilProgram:
    """Two 3-point filters in a row (radius 2): the second reads the first
    at offsets -1, 0 and +1, with unequal weights."""
    ops = [
        affine("blur", "x", {(-1,): 0.25, (0,): 0.5, (1,): 0.25}),
        affine("out", "blur", {(-1,): -0.125, (0,): 1.25, (1,): -0.125}),
    ]
    return StencilProgram("smooth1d", ["x"], ops, ndim=1)


def jacobi2d_3pt_program(coeff: float = 1.0 / 3.0) -> StencilProgram:
    taps = {(-1, 0): coeff, (0, 0): coeff, (1, 0): coeff}
    return StencilProgram("jacobi2d_3pt", ["x"], [affine("out", "x", taps)])


def laplacian_program() -> StencilProgram:
    return StencilProgram("laplacian", ["x"], [affine("out", "x", _LAP_TAPS)])


def jacobi2d_5pt_program(coeff: float = 0.2) -> StencilProgram:
    taps = {
        (0, 0): coeff,
        (1, 0): coeff,
        (-1, 0): coeff,
        (0, 1): coeff,
        (0, -1): coeff,
    }
    return StencilProgram("jacobi2d_5pt", ["x"], [affine("out", "x", taps)])


def jacobi2d_9pt_program(coeff: float = 1.0 / 9.0) -> StencilProgram:
    taps = {(dr, dc): coeff for dr in (-1, 0, 1) for dc in (-1, 0, 1)}
    return StencilProgram("jacobi2d_9pt", ["x"], [affine("out", "x", taps)])


def seidel2d_program(coeff: float = 1.0 / 9.0) -> StencilProgram:
    """Parallel (Jacobi-style) 9-point sweep — the throughput form the
    streaming spatial mapping pipelines (see ``core.stencils.seidel2d_sweep``)."""
    taps = {(dr, dc): coeff for dr in (-1, 0, 1) for dc in (-1, 0, 1)}
    return StencilProgram("seidel2d", ["x"], [affine("out", "x", taps)])


ELEMENTARY_PROGRAMS: dict[str, Callable[[], StencilProgram]] = {
    "jacobi1d": jacobi1d_program,
    "jacobi2d_3pt": jacobi2d_3pt_program,
    "laplacian": laplacian_program,
    "jacobi2d_5pt": jacobi2d_5pt_program,
    "jacobi2d_9pt": jacobi2d_9pt_program,
    "seidel2d": seidel2d_program,
}
