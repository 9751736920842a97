"""The port's hdiff entry points (CPU path = the kernels' plain versions)
against the JAX package's Pallas kernels run in interpret mode.

Same shapes as ``tests/test_kernels_hdiff.py``; tolerance ``TOL`` (1e-6,
rtol and atol) for float32 and bfloat16 (compared in float32: both sides
compute in float32 and round to bfloat16 once), exact for int32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conformance import TOL
from repro.kernels.hdiff import hdiff_fixed as jax_hdiff_fixed
from repro.kernels.hdiff import hdiff_fused as jax_hdiff_fused
from repro.kernels.hdiff.multistep import hdiff_twostep as jax_hdiff_twostep
from repro.kernels.hdiff.ref import hdiff_fixed_point_ref as jax_fixed_ref
from repro_torch.kernels.hdiff import hdiff_fixed, hdiff_fused, hdiff_twostep
from repro_torch.kernels.hdiff.kernel import hdiff_cuda, hdiff_plain

SHAPES = [(1, 8, 8), (2, 16, 12), (3, 32, 64), (1, 64, 128), (2, 256, 256)]


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL
    )


@pytest.mark.parametrize("limit", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_hdiff_fused_matches_pallas(shape, limit):
    x = _rand(shape)
    want = jax_hdiff_fused(jnp.asarray(x), 0.025, limit=limit, interpret=True)
    _close(hdiff_fused(torch.from_numpy(x), 0.025, limit=limit), want)


@pytest.mark.parametrize("block_rows", [8, 16, 32, 64])
def test_hdiff_fused_block_rows_match_pallas(block_rows):
    x = _rand((2, 64, 48), seed=3)
    want = jax_hdiff_fused(jnp.asarray(x), 0.05, block_rows=block_rows, interpret=True)
    _close(hdiff_fused(torch.from_numpy(x), 0.05, block_rows=block_rows), want)


def test_hdiff_fused_bf16_matches_pallas():
    x = _rand((2, 32, 32), seed=5)
    want = jax_hdiff_fused(jnp.asarray(x).astype(jnp.bfloat16), 0.025, interpret=True)
    got = hdiff_fused(torch.from_numpy(x).to(torch.bfloat16), 0.025)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)))


def test_hdiff_fused_rejects_block_rows_like_jax():
    x = torch.from_numpy(_rand((1, 30, 16)))
    with pytest.raises(ValueError, match="not divisible"):
        hdiff_fused(x, block_rows=8)
    with pytest.raises(ValueError, match=">= 4"):
        hdiff_fused(x, block_rows=2)


def test_wrapper_cpu_path_is_the_plain_version():
    x = torch.from_numpy(_rand((2, 20, 24), seed=9))
    np.testing.assert_array_equal(
        hdiff_cuda(x, 0.025).numpy(), hdiff_plain(x, 0.025).numpy()
    )


def _wrap_input(shape, seed):
    """Values near 2**29: the Laplacian's 4*x alone wraps int32."""
    rng = np.random.default_rng(seed)
    return rng.integers(2**29 - 2**20, 2**29, size=shape, dtype=np.int32) * rng.choice(
        np.array([-1, 1], np.int32), size=shape
    )


@pytest.mark.parametrize(
    "shape,wrap", [((1, 8, 8), False), ((2, 32, 24), False), ((1, 64, 64), False),
                   ((2, 32, 24), True)],
)
def test_hdiff_fixed_bit_exact(shape, wrap):
    x = (_wrap_input(shape, 7) if wrap
         else np.random.default_rng(7).integers(-1000, 1000, size=shape, dtype=np.int32))
    want = np.asarray(jax_fixed_ref(jnp.asarray(x), 26, 10))
    got = hdiff_fixed(torch.from_numpy(x), coeff_num=26, coeff_shift=10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if wrap:  # the JAX kernel path agrees too
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_hdiff_fixed(jnp.asarray(x), interpret=True))
        )


@pytest.mark.parametrize("limit", [True, False])
@pytest.mark.parametrize("shape", [(1, 16, 12), (2, 32, 32), (1, 64, 48)])
def test_hdiff_twostep_matches_pallas(shape, limit):
    x = _rand(shape, seed=shape[1])
    want = jax_hdiff_twostep(jnp.asarray(x), 0.025, limit=limit, interpret=True)
    _close(hdiff_twostep(torch.from_numpy(x), 0.025, limit=limit), want)


def test_hdiff_twostep_is_two_fused_sweeps():
    """Within the port, two fused IR sweeps equal two hand-written sweeps
    bit for bit on float32 (the same association in both)."""
    x = torch.from_numpy(_rand((2, 40, 36), seed=4))
    two = hdiff_fused(hdiff_fused(x, 0.05), 0.05)
    np.testing.assert_array_equal(hdiff_twostep(x, 0.05).numpy(), two.numpy())


def test_hdiff_twostep_rejects_block_rows_like_jax():
    x = torch.from_numpy(_rand((1, 16, 16)))
    with pytest.raises(ValueError, match="not divisible"):
        hdiff_twostep(x, block_rows=128)
    with pytest.raises(ValueError, match=">= 8"):
        hdiff_twostep(x, block_rows=4)
