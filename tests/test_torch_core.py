"""repro_torch.core against repro.core: execution policies, the time-stepping
driver, the hand-written stencils, the H100 machine model and the
default-device rule. Tolerance ``TOL`` (1e-6, rtol and atol)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from conformance import GRID, PROGRAMS, TOL, assert_close, make_fields, to_host
from repro_torch.interop import fields_from_numpy, to_numpy
from repro_torch.kernels.hdiff import hdiff_fused
from test_torch_ir_graph import TORCH_PROGRAMS

POLICY_PAIRS = [("staged", "staged"), ("fused-eager", "fused-xla"),
                ("fused-cuda", "fused-pallas")]


@pytest.mark.parametrize("port_policy,jax_policy", POLICY_PAIRS)
@pytest.mark.parametrize("name", ["hdiff", "hdiff_coupled", "shallow_water"])
def test_compound_policies_match_jax(name, port_policy, jax_policy):
    jprog, tprog = PROGRAMS[name](), TORCH_PROGRAMS[name]()
    x = to_host(make_fields(name))
    want = to_host(jcore.CompoundStencil(name, jprog).apply(make_fields(name), jax_policy))
    stencil = tcore.CompoundStencil(name, tprog, device="cpu")
    got = to_numpy(stencil.apply(fields_from_numpy(tprog, x, "cpu"), port_policy))
    assert_close(got, want, err_msg=f"{name}/{port_policy}")


def test_compound_rejects_unknown_policy_and_wrong_device():
    stencil = tcore.make_hdiff_compound(device="cpu")
    assert stencil.POLICIES == ("staged", "fused-eager", "fused-cuda")
    x = torch.zeros(GRID)
    with pytest.raises(ValueError, match="unknown policy"):
        stencil.apply(x, "fused-pallas")
    with pytest.raises(ValueError, match="placed on"):
        stencil.apply(x.to("meta"), "fused-eager")


@pytest.mark.parametrize("collect_every", [0, 5])
def test_run_simulation_matches_jax(collect_every):
    """The JAX driver runs under ``jax.disable_jit()``, i.e. step by step as
    the port's Python loop does. Jitted, its fused float32 steps round some
    points differently and the flux limiter amplifies that past ``TOL``
    within 20 steps on this field (ROADMAP Queue 3), while the port is
    bit-identical to the eager steps."""
    psi0 = np.asarray(jcore.make_initial_field(4, 64, 64, kind="gaussian"))
    with jax.disable_jit():
        want, want_diag = jcore.run_simulation(
            jnp.asarray(psi0), 0.025, step_fn=jcore.hdiff, n_steps=20,
            collect_every=collect_every,
        )
    got, got_diag = tcore.run_simulation(
        torch.tensor(psi0), 0.025, step_fn=hdiff_fused, n_steps=20,
        collect_every=collect_every,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if collect_every:
        np.testing.assert_allclose(got_diag.numpy(), np.asarray(want_diag), rtol=TOL, atol=TOL)
    else:
        assert got_diag is None and want_diag is None


@pytest.mark.parametrize("kind", ["gaussian", "checker"])
def test_initial_fields_match_jax(kind):
    want = np.asarray(jcore.make_initial_field(3, 20, 28, kind=kind))
    got = tcore.make_initial_field(3, 20, 28, kind=kind, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_random_initial_field_is_seeded_uniform():
    a = tcore.make_initial_field(2, 16, 16, kind="random", seed=3, device="cpu")
    b = tcore.make_initial_field(2, 16, 16, kind="random", seed=3, device="cpu")
    assert torch.equal(a, b) and 0.0 <= a.min() and a.max() < 1.0
    assert not torch.equal(a, tcore.make_initial_field(2, 16, 16, kind="random", seed=4,
                                                       device="cpu"))


def test_default_device_is_the_card():
    """Entry points that create tensors default to CUDA; without a card
    they raise and say how to ask for the CPU."""
    if torch.cuda.is_available():
        assert tcore.make_initial_field(1, 8, 8).is_cuda
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcore.make_initial_field(1, 8, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcore.make_hdiff_compound()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fields_from_numpy(TORCH_PROGRAMS["hdiff"](), np.zeros(GRID, np.float32))


@pytest.mark.parametrize("fn", ["hdiff", "hdiff_simple", "hdiff_staged"])
def test_hand_written_hdiff_matches_jax(fn):
    """The eager forms are bit-identical (same op order, one rounding per
    op); the JAX staged form jits each stage, and XLA's fused stage code
    differs in the last ulp, so it is held at ``TOL``."""
    x = to_host(make_fields("hdiff"))
    want = np.asarray(getattr(jcore, fn)(jnp.asarray(x), 0.025))
    got = getattr(tcore, fn)(torch.tensor(x), 0.025).numpy()
    if fn == "hdiff_staged":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(jcore.ELEMENTARY_FNS))
def test_elementary_stencils_match_jax(name):
    shape = (2, 12) if name == "jacobi1d" else (2, 12, 10)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jcore.ELEMENTARY_FNS[name](jnp.asarray(x)))
    got = tcore.ELEMENTARY_FNS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert tcore.ELEMENTARY_SPECS[name] == tcore.StencilSpec(
        *[getattr(jcore.ELEMENTARY_SPECS[name], f) for f in
          ("name", "macs", "other_ops", "reads", "radius", "ndim")]
    )


def test_seidel2d_exact_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 7, 6)).astype(np.float32)
    want = np.asarray(jcore.seidel2d_exact(jnp.asarray(x)))
    got = tcore.seidel2d_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_hdiff_spec_and_traffic_models_match_jax():
    assert (tcore.HDIFF_SPEC.macs, tcore.HDIFF_SPEC.other_ops, tcore.HDIFF_SPEC.reads,
            tcore.HALO) == (26, 20, 13, 2)
    for f in ("hdiff_flops", "hdiff_min_bytes", "hdiff_algorithmic_bytes"):
        assert getattr(tcore, f)(64, 256, 256) == getattr(jcore, f)(64, 256, 256)
    assert tcore.aie_hdiff_cycles(256, 256, 64) == jcore.aie_hdiff_cycles(256, 256, 64)


def test_h100_model_and_planner():
    m = tcore.H100_SXM
    assert (m.hbm_bw, m.peak_flops_vpu_f32, m.peak_flops_bf16) == (3.35e12, 67e12, 989e12)
    assert m.vmem_bytes == 232_448 and m.ici_bw == 900e9
    assert round(m.hbm_gib * 2**30) == 80_000_000_000
    plan = tcore.plan_partition(64, 256, 256, 8)
    assert plan.kind == "depth" and plan.depth_shards == 8 and plan.row_shards == 1
    points = 8 * 256 * 256
    assert plan.hbm_s == pytest.approx(3 * points * 4 / 3.35e12)
    assert plan.compute_s == pytest.approx(points * 72 / 67e12)
    deep = tcore.plan_partition(2, 256, 256, 8, program=TORCH_PROGRAMS["hdiff"]())
    assert deep.kind == "depth+rows" and deep.depth_shards * deep.row_shards == 8
    tpu = tcore.plan_partition(64, 256, 256, 8, machine=tcore.TPUV5E)
    assert tpu.hbm_s > plan.hbm_s
