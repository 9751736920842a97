"""The port's elementary-stencil entry points (CPU path = the plain versions
of K4 ``stencil2d_cuda`` and K5 ``jacobi1d_cuda``) against the JAX
package's Pallas kernels run in interpret mode.

Same names and shapes as ``tests/test_kernels_stencil2d.py``. Tolerances:
``TOL`` (1e-6, rtol and atol) against the Pallas kernels — the port rounds
exactly like the JAX oracle run eagerly (bit-equal, checked below), while
XLA's compiled CPU code may contract a multiply and an add into one fused
multiply-add and so differ in the last ulp; one bfloat16 ulp for bfloat16,
since both sides round once from float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conformance import SEED, TOL
from repro.kernels.stencil2d import jacobi1d as jax_jacobi1d
from repro.kernels.stencil2d import jacobi1d_ref as jax_jacobi1d_ref
from repro.kernels.stencil2d import stencil2d as jax_stencil2d
from repro.kernels.stencil2d import stencil2d_ref as jax_stencil2d_ref
from repro.kernels.stencil2d import weights_for as jax_weights_for
from repro_torch.kernels.stencil2d import (
    jacobi1d,
    jacobi1d_cuda,
    jacobi1d_plain,
    stencil2d,
    stencil2d_cuda,
    stencil2d_plain,
    stencil2d_ref,
    weights_for,
)

NAMES = ["jacobi2d_3pt", "laplacian", "jacobi2d_5pt", "jacobi2d_9pt", "seidel2d"]
SHAPES = [(1, 8, 8), (2, 16, 24), (3, 64, 64), (1, 128, 256)]


def _rand(shape, seed=SEED):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _random_mask():
    return _rand((3, 3), seed=SEED + 1)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _within_one_bf16_ulp(got: torch.Tensor, want):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want.astype(jnp.float32))
    mag = np.maximum(np.abs(want), np.float32(2.0**-126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@pytest.mark.parametrize("name", NAMES + ["random"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stencil2d_matches_pallas(name, shape):
    x = _rand(shape)
    spec = _random_mask() if name == "random" else name
    want = jax_stencil2d(jnp.asarray(x), jnp.asarray(spec) if name == "random" else spec,
                         interpret=True)
    _close(stencil2d(torch.from_numpy(x), spec), want)


@pytest.mark.parametrize("name", NAMES)
def test_plain_version_is_bit_equal_to_the_eager_jax_oracle(name):
    x = _rand((2, 16, 24), seed=3)
    with jax.disable_jit():
        want = jax_stencil2d_ref(jnp.asarray(x), jnp.asarray(jax_weights_for(name)))
    got = stencil2d_plain(torch.from_numpy(x), weights_for(name))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zero_taps_propagate_inf_as_nan_like_jax():
    """jacobi2d_3pt's mask has zero columns: 0 * Inf is NaN, so an Inf
    poisons every interior point whose 3x3 window holds it."""
    x = _rand((1, 8, 8), seed=5)
    x[0, 3, 4] = np.inf
    x[0, 5, 1] = -np.inf
    want = np.asarray(jax_stencil2d(jnp.asarray(x), "jacobi2d_3pt", interpret=True))
    got = stencil2d(torch.from_numpy(x), "jacobi2d_3pt").numpy()
    assert np.isnan(want).sum() > 2
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, equal_nan=True)


def test_general_mask_ref_matches_jax_ref():
    """The oracle takes any odd square mask, as the JAX one does."""
    x = _rand((2, 12, 14), seed=6)
    w = _rand((5, 5), seed=7)
    with jax.disable_jit():
        want = jax_stencil2d_ref(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(stencil2d_ref(torch.from_numpy(x), w).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("block_rows", [8, 16, 64, 128])
def test_stencil2d_block_sweep_matches_pallas(block_rows):
    x = _rand((1, 64, 32), seed=4)
    want = jax_stencil2d(jnp.asarray(x), "jacobi2d_9pt", block_rows=block_rows,
                         interpret=True)
    _close(stencil2d(torch.from_numpy(x), "jacobi2d_9pt", block_rows=block_rows), want)


def test_stencil2d_rejects_what_jax_rejects():
    x = _rand((1, 64, 32))
    with pytest.raises(ValueError, match="not divisible"):
        jax_stencil2d(jnp.asarray(x), "laplacian", block_rows=7, interpret=True)
    with pytest.raises(ValueError, match="not divisible"):
        stencil2d(torch.from_numpy(x), "laplacian", block_rows=7)
    with pytest.raises(ValueError, match="unknown elementary stencil"):
        stencil2d(torch.from_numpy(x), "blur")
    with pytest.raises(ValueError, match=r"\(3, 3\)"):
        stencil2d(torch.from_numpy(x), np.ones((5, 5), np.float32))
    with pytest.raises(ValueError, match="at least 3x3"):
        stencil2d(torch.zeros(1, 2, 8), "laplacian")
    with pytest.raises(ValueError, match="depth, rows, cols"):
        stencil2d(torch.zeros(8, 8), "laplacian")


def test_stencil2d_bf16_within_one_ulp_of_pallas():
    x = _rand((1, 32, 32), seed=6)
    want = jax_stencil2d(jnp.asarray(x).astype(jnp.bfloat16), "jacobi2d_5pt", interpret=True)
    got = stencil2d(torch.from_numpy(x).to(torch.bfloat16), "jacobi2d_5pt")
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got, want)


def test_wrappers_cpu_path_is_the_plain_version():
    x = torch.from_numpy(_rand((2, 20, 24), seed=9))
    w = _random_mask()
    np.testing.assert_array_equal(stencil2d_cuda(x, w).numpy(), stencil2d_plain(x, w).numpy())
    y = torch.from_numpy(_rand((3, 40), seed=10))
    np.testing.assert_array_equal(jacobi1d_cuda(y, 0.3).numpy(), jacobi1d_plain(y, 0.3).numpy())


@pytest.mark.parametrize("n", [8, 33, 256])
def test_jacobi1d_matches_pallas(n):
    x = _rand((4, n), seed=8)
    want = jax_jacobi1d(jnp.asarray(x), interpret=True)
    _close(jacobi1d(torch.from_numpy(x)), want)
    with jax.disable_jit():
        eager = jax_jacobi1d_ref(jnp.asarray(x))
    np.testing.assert_array_equal(jacobi1d(torch.from_numpy(x)).numpy(), np.asarray(eager))


def test_jacobi1d_1d_input_and_coeff():
    x = _rand((17,), seed=9)
    got = jacobi1d(torch.from_numpy(x), coeff=0.3)
    assert got.shape == (17,)
    _close(got, jax_jacobi1d(jnp.asarray(x), coeff=0.3, interpret=True))
    with pytest.raises(ValueError, match=r"\(batch, n\)"):
        jacobi1d(torch.zeros(2, 3, 4))


def test_jacobi1d_bf16_within_one_ulp_of_pallas():
    x = _rand((3, 64), seed=11)
    want = jax_jacobi1d(jnp.asarray(x).astype(jnp.bfloat16), interpret=True)
    got = jacobi1d(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_weights_for_equals_jax(name):
    got, want = weights_for(name), jax_weights_for(name)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_weights_for_rejects_unknown_names_like_jax():
    for fn in (weights_for, jax_weights_for):
        with pytest.raises(ValueError, match="unknown elementary stencil"):
            fn("jacobi3d")
