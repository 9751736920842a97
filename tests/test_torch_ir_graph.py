"""The port's IR analysis equals the JAX package's, program by program.

For the 11 conformance programs plus ``jacobi1d`` and k in {1, 2, 3}, the
``repro_torch`` program and the ``repro`` program agree on every derived
quantity and on ``fingerprint()`` — the identity that later lets the two
packages share compile-cache keys.
"""

import dataclasses

import pytest

import repro.ir as jir
import repro_torch.ir as tir
from conformance import KS, PROGRAMS

TORCH_PROGRAMS = {
    "hdiff": lambda: tir.hdiff_program(),
    "hdiff_simple": lambda: tir.hdiff_program(limit=False),
    "jacobi2d_3pt": tir.jacobi2d_3pt_program,
    "laplacian": tir.laplacian_program,
    "jacobi2d_5pt": tir.jacobi2d_5pt_program,
    "jacobi2d_9pt": tir.jacobi2d_9pt_program,
    "seidel2d": tir.seidel2d_program,
    "vadvc": tir.vadvc_program,
    "hdiff_coupled": lambda: tir.hdiff_coupled_program(),
    "shallow_water": tir.shallow_water_program,
    "advection_diffusion": tir.advection_diffusion_program,
    "jacobi1d": tir.jacobi1d_program,
}
JAX_PROGRAMS = {**PROGRAMS, "jacobi1d": jir.jacobi1d_program}


def test_roster_covers_every_conformance_program():
    assert set(TORCH_PROGRAMS) == set(JAX_PROGRAMS)
    assert len(TORCH_PROGRAMS) == 12


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(TORCH_PROGRAMS))
def test_analysis_and_fingerprint_match_reference(name, k):
    pj = jir.repeat(JAX_PROGRAMS[name](), k)
    pt = tir.repeat(TORCH_PROGRAMS[name](), k)
    assert dataclasses.astuple(pt.spec()) == dataclasses.astuple(pj.spec())
    assert pt.radius == pj.radius
    assert pt.field_radii() == pj.field_radii()
    assert pt.exchange_radii() == pj.exchange_radii()
    assert pt.output_radii() == pj.output_radii()
    assert pt.margins() == pj.margins()
    assert pt.outputs == pj.outputs and pt.steps == pj.steps == k
    assert pt.fingerprint() == pj.fingerprint()


def test_fingerprint_tracks_coefficients_not_emitters():
    """The CUDA emitter is outside the fingerprint (like compute), while a
    coefficient change moves it — in both packages alike."""
    a, b = tir.hdiff_program(0.025), tir.hdiff_program(0.05)
    assert a.fingerprint() != b.fingerprint()
    assert b.fingerprint() == jir.hdiff_program(0.05).fingerprint()
    stripped = tir.StencilProgram(
        "renamed", a.inputs,
        [dataclasses.replace(op, emit=None) for op in a.ops],
    )
    assert stripped.fingerprint() == a.fingerprint()


def test_compose_keeps_emitters():
    prog = tir.repeat(tir.shallow_water_program(), 3)
    assert all(op.emit is not None for op in prog.ops)
    assert all(op.emit is not None for p in prog.chain for op in p.ops)
