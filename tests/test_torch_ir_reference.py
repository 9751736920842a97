"""The port's eager reference lowering against the JAX reference lowering.

Both modes of ``repro_torch.ir.lower_reference`` (fused and staged) are held
against ``repro.ir.lower_reference`` (the conformance oracle) on the same
numpy inputs, for the 11 conformance programs x k in {1, 2, 3} on
``GRID``, plus hdiff on the paper grid 64x256x256. Tolerance is the
conformance ``TOL`` (1e-6, rtol and atol): the port keeps each
combinator's tap order and ``_tree_sum`` association, so the remaining
differences are last-ulp ones from XLA's fused CPU code.
"""

import numpy as np
import pytest

import repro.ir as jir
import repro_torch.ir as tir
from conformance import KS, PROGRAMS, assert_close, make_fields, make_input, oracle, to_host
from repro_torch.interop import fields_from_numpy, to_numpy
from test_torch_ir_graph import TORCH_PROGRAMS

PAPER_GRID = (64, 256, 256)


def _port(name, k):
    return tir.repeat(TORCH_PROGRAMS[name](), k)


@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_lower_reference_matches_jax(name, k, mode):
    prog = _port(name, k)
    x = fields_from_numpy(prog, to_host(make_fields(name)), device="cpu")
    got = to_numpy(tir.lower_reference(prog, mode=mode)(x))
    assert_close(got, oracle(name, k), err_msg=f"{name}/k={k}/{mode}")


@pytest.mark.parametrize("k", KS)
def test_hdiff_paper_grid_matches_jax(k):
    x = np.asarray(make_input(PAPER_GRID))
    want = to_host(jir.lower_reference(jir.repeat(jir.hdiff_program(), k))(x))
    prog = _port("hdiff", k)
    got = to_numpy(tir.lower_reference(prog)(fields_from_numpy(prog, x, device="cpu")))
    assert_close(got, want, err_msg=f"hdiff/paper grid/k={k}")


def test_staged_equals_fused_bitwise():
    """Materialising every op changes no rounding in eager PyTorch."""
    prog = _port("shallow_water", 2)
    x = fields_from_numpy(prog, to_host(make_fields("shallow_water")), device="cpu")
    fused = to_numpy(tir.lower_reference(prog)(x))
    staged = to_numpy(tir.lower_reference(prog, mode="staged")(x))
    for f in fused:
        np.testing.assert_array_equal(fused[f], staged[f])


def test_unknown_mode_and_missing_field_raise():
    prog = _port("vadvc", 1)
    with pytest.raises(ValueError, match="unknown mode"):
        tir.lower_reference(prog, mode="pallas")
    x = fields_from_numpy(prog, to_host(make_fields("vadvc")), device="cpu")
    with pytest.raises(ValueError, match="missing"):
        tir.lower_reference(prog)({"s": x["s"]})
