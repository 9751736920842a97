"""The port's cross-rank gradient reduce on 2 gloo ranks against the JAX
package's arithmetic.

Each rank reduces its own gradients (float32 leaves and an int32 counter)
by mean and by sum, in float32 and on the bfloat16 wire. The expected
results are computed here from the same numbers: the float32 sums and
means in numpy (the same two operands, one rounding each), the bfloat16
wire through the JAX package's ``compress_bf16`` / ``decompress_bf16``
with the two bfloat16 operands summed once, and integer means by floor
division, as ``repro.dist.reduce`` defines them.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.dist.reduce import compress_bf16 as jax_compress
from repro.dist.reduce import decompress_bf16 as jax_decompress
from repro_torch.dist import reduce_gradients

from torch_dist_harness import reduce_suite, run_ranks

WORLD = 2


def _grads(rank):
    rng = np.random.default_rng(rank)
    return {"w": (rng.standard_normal((3, 5)) * 10).astype(np.float32),
            "b": {"x": rng.standard_normal(4).astype(np.float32)},
            "n": rng.integers(-7, 8, (3,)).astype(np.int32)}


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    grads = [_grads(r) for r in range(WORLD)]
    return grads, run_ranks(reduce_suite, WORLD, tmp_path_factory.mktemp("reduce"), grads,
                            timeout=120)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _expect(grads, method, mean):
    out = []
    for leaves in zip(*(_leaves(g) for g in grads)):
        if method == "bf16" and leaves[0].dtype == np.float32:
            wire = [jax_compress(jnp.asarray(a)) for a in leaves]
            total = np.asarray(jax_decompress(wire[0] + wire[1], jnp.float32))
        else:
            total = leaves[0] + leaves[1]
        if mean:
            total = total / np.float32(WORLD) if total.dtype == np.float32 else total // WORLD
        out.append(total)
    return out


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("method", ["none", "bf16"])
def test_reduce_matches_the_reference_arithmetic_on_every_rank(reduced, method, mean):
    grads, results = reduced
    want = _expect(grads, method, mean)
    for res in results:
        got = _leaves(res[(method, mean)])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_bf16_wire_is_the_jax_packages(reduced):
    grads, results = reduced
    for rank, res in enumerate(results):
        want = np.asarray(jax_compress(jnp.asarray(grads[rank]["w"])).astype(jnp.float32))
        np.testing.assert_array_equal(res["wire"], want)


def test_one_rank_group_returns_the_rank_own_gradients(reduced):
    grads, results = reduced
    for rank, res in enumerate(results):
        for g, w in zip(_leaves(res["alone"]), _leaves(grads[rank])):
            np.testing.assert_array_equal(g, w)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown reduction method"):
        reduce_gradients({}, method="fp8")


def test_run_ranks_ends_the_run_when_a_rank_fails(tmp_path):
    """``repro_torch.launch.spawn.run_ranks`` (the weather driver's and
    ``chip_smoke.py``'s spawner): one failed rank ends the run at once, its
    waiting peer killed, with the failure's traceback in the error."""
    import time

    from repro_torch.launch.spawn import run_ranks
    from torch_dist_harness import failing_rank

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
        run_ranks(failing_rank, 2, tmp_path, timeout=120)
    assert time.monotonic() - t0 < 50
    assert not list(tmp_path.iterdir())  # the store and result files are removed
