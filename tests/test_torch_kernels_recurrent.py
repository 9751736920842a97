"""The recurrent-LM kernels' plain versions (K6 RG-LRU scan, K7 WKV-6)
against the JAX package on the CPU.

Inputs are numpy arrays from a seed, built as in ``tests/test_kernels_wkv6.py``
and ``tests/test_kernels_rglru.py``; the JAX side runs the Pallas kernels in
interpret mode and the jnp oracles. Tolerances are the JAX tests' own:
2e-4 for the chunked WKV form against the sequential oracle (exp(-cum)
grows with the chunk, so sums of large and small terms meet), 3e-4 for the
kernel, 1e-5 for the RG-LRU scan (the sequential and associative orders
differ by ulps). On the card the kernels are held to these plain versions
by ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.rglru import rglru_scan as jax_rglru_scan
from repro.kernels.rglru import rglru_scan_ref as jax_rglru_scan_ref
from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.kernels.wkv6 import wkv6_chunked_ref as jax_wkv6_chunked_ref
from repro.kernels.wkv6 import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels import _build
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_cuda, rglru_scan_ref, rglru_seq_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked_ref, wkv6_cuda, wkv6_plain, wkv6_ref


def _wkv_inputs(b=2, t=32, h=2, n=16, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, t, h, n)).astype(np.float32) * np.float32(0.5)
    k = rng.standard_normal((b, t, h, n)).astype(np.float32) * np.float32(0.5)
    v = rng.standard_normal((b, t, h, n)).astype(np.float32)
    w = rng.uniform(0.6, 0.999, (b, t, h, n)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32) * np.float32(0.3)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32) * np.float32(0.1)
    return r, k, v, w, u, s0


def _rglru_inputs(b=2, t=16, w=32, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, t, w)).astype(np.float32)
    bb = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, bb, h0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# -- K7: WKV-6 ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_wkv6_chunked_ref_matches_jax(chunk):
    arrays = _wkv_inputs()
    y_j, s_j = jax_wkv6_chunked_ref(*map(jnp.asarray, arrays), chunk=chunk)
    y, s = wkv6_chunked_ref(*_t(arrays), chunk=chunk)
    _close(y, y_j, 2e-4)
    _close(s, s_j, 2e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_sequential_ref_matches_jax(with_state):
    r, k, v, w, u, s0 = _wkv_inputs(2, 24, 3, 8, seed=3)
    s0 = s0 if with_state else None
    y_j, s_j = jax_wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)),
                            None if s0 is None else jnp.asarray(s0))
    y, s = wkv6_ref(*_t((r, k, v, w, u)), None if s0 is None else torch.from_numpy(s0))
    _close(y, y_j, 1e-5)
    _close(s, s_j, 1e-5)


WKV_CASES = [((1, 16, 1, 8), 4), ((2, 64, 3, 16), 8), ((1, 128, 2, 32), 16),
             ((2, 64, 1, 64), 32), ((1, 128, 2, 64), 64), ((1, 64, 2, 8), 64)]


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "state"])
@pytest.mark.parametrize("shape,chunk", WKV_CASES, ids=[f"{s}-c{c}" for s, c in WKV_CASES])
def test_wkv6_matches_jax_kernel_and_oracle(shape, chunk, with_state):
    """The port's entry point on CPU tensors (K7's plain version, the Pallas
    kernel's chunk body) against the Pallas kernel in interpret mode and the
    sequential oracle, at the JAX kernel test's 3e-4."""
    r, k, v, w, u, s0 = _wkv_inputs(*shape, seed=shape[1] + shape[3])
    s0 = s0 if with_state else None
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)] + [None if s0 is None else jnp.asarray(s0)]
    y_k, s_k = jax_wkv6(*jargs, chunk=chunk, interpret=True)
    y_o, s_o = jax_wkv6_ref(*jargs)
    y, s = wkv6(*_t((r, k, v, w, u)), None if s0 is None else torch.from_numpy(s0), chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == shape and tuple(s.shape) == (shape[0], shape[2], shape[3], shape[3])
    for got, want in ((y, y_k), (s, s_k), (y, y_o), (s, s_o)):
        _close(got, want, 3e-4)


def test_wkv6_plain_many_chunks_with_state_matches_jax():
    """Sixteen chunks and a non-zero initial state: K7's plain version (its
    three passes, the scan over chunks in the middle) against the JAX
    package's chunked form, the Pallas kernel in interpret mode and the
    sequential oracle, at 3e-4."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 128, 2, 16, seed=16)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    y, s = wkv6_plain(*_t((r, k, v, w, u, s0)), chunk=8)
    for y_j, s_j in (jax_wkv6_chunked_ref(*jargs, chunk=8),
                     jax_wkv6(*jargs, chunk=8, interpret=True), jax_wkv6_ref(*jargs)):
        _close(y, y_j, 3e-4)
        _close(s, s_j, 3e-4)


def test_wkv6_plain_clamps_chunk_and_rejects_ragged_lengths():
    r, k, v, w, u, s0 = _t(_wkv_inputs(1, 12, 1, 8))
    y_big, s_big = wkv6_plain(r, k, v, w, u, s0, chunk=64)  # clamped to T = 12
    y_seq, s_seq = wkv6_ref(r, k, v, w, u, s0)
    _close(y_big, y_seq, 3e-4)
    _close(s_big, s_seq, 3e-4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv6_plain(r, k, v, w, u, s0, chunk=8)


# -- K6: RG-LRU scan -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 4, 8), (2, 16, 32), (3, 64, 128), (1, 128, 64)])
def test_rglru_matches_jax_kernel_and_oracle(shape):
    a, b, h0 = _rglru_inputs(*shape, seed=shape[1])
    h_k, last_k = jax_rglru_scan(*map(jnp.asarray, (a, b, h0)), block_w=min(32, shape[2]),
                                 interpret=True)
    h_o, last_o = jax_rglru_scan_ref(*map(jnp.asarray, (a, b, h0)))
    h, last = rglru_scan(*_t((a, b, h0)))
    h_r, last_r = rglru_scan_ref(*_t((a, b, h0)))
    for got, want in ((h, h_k), (last, last_k), (h, h_o), (last, last_o), (h_r, h_o),
                      (last_r, last_o)):
        _close(got, want, 1e-5)


def test_rglru_bf16_inputs_match_jax():
    a, b, h0 = _rglru_inputs(2, 32, 64, seed=5)
    ab, bb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    a_j, b_j = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (ab, bb))
    h_k, last_k = jax_rglru_scan(a_j, b_j, jnp.asarray(h0), block_w=32, interpret=True)
    h, last = rglru_scan(ab, bb, torch.from_numpy(h0))
    assert h.dtype == last.dtype == torch.float32
    _close(h, h_k, 1e-5)
    _close(last, last_k, 1e-5)


def test_rglru_seq_ref_is_mul_then_add_in_float32():
    """K6's plain version rounds a * h, then adds b: a numpy float32 loop
    doing the same is bit-equal."""
    a, b, h0 = _rglru_inputs(2, 20, 16, seed=7)
    h, last = rglru_seq_ref(*_t((a, b, h0)))
    hv = h0.copy()
    for t in range(a.shape[1]):
        hv = (a[:, t] * hv).astype(np.float32) + b[:, t]
        np.testing.assert_array_equal(h[:, t].numpy(), hv)
    np.testing.assert_array_equal(last.numpy(), hv)
    zero, _ = rglru_scan(*_t((a, b)))
    np.testing.assert_array_equal(zero.numpy(), rglru_seq_ref(*_t((a, b, 0 * h0)))[0].numpy())


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    _build.reset_launches()
    r, k, v, w, u, s0 = _t(_wkv_inputs(1, 16, 1, 8))
    y, s = wkv6_cuda(r, k, v, w, u, s0, chunk=8)
    y_p, s_p = wkv6_plain(r, k, v, w, u, s0, chunk=8)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    a, b, h0 = _t(_rglru_inputs(1, 8, 16))
    h, _ = rglru_scan_cuda(a, b, h0)
    assert torch.equal(h, rglru_seq_ref(a, b, h0)[0])
    assert _build.LAUNCHES == {}
