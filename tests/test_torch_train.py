"""The port's optimizer stack, loss monitor and assimilation trainer
(``repro_torch.optim``, ``repro_torch.train``) against the JAX package's, on
the CPU.

  * AdamW and Adafactor (factored and full second moments, float32 and
    bfloat16 moments), ``schedule_lr`` and ``clip_by_global_norm``: several
    updates from the same state (carried across by
    ``interop.optimizer_state_from_numpy``) within 1e-6 relative of the JAX
    package's, leaf by leaf — the two round alike except where ``cos`` and
    ``pow`` differ by an ulp;
  * ``SpikeDetector`` flags the same steps;
  * ``fit_coefficient_field`` at (2, 16, 16): a >= 10x loss drop in 40
    steps with the boundary ring exactly at its first guess, and a loss
    trajectory within 1e-4 relative of the JAX package's fit on the same
    numpy ``u0`` and true coefficients (measured: 1.4e-5; the loss is a
    mean over the grid summed in another order, and AdamW's normalised
    steps carry that difference on).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro_torch.optim as topt
from conformance import SEED
from repro.train import AssimilationConfig as JaxAssimilationConfig
from repro.train import fit_coefficient_field as jax_fit
from repro.train.assimilate import synthetic_observations as jax_observations
from repro.train.assimilate import true_coefficients as jax_true_coefficients
from repro.train.loop import SpikeDetector as JaxSpikeDetector
from repro_torch.interop import optimizer_state_from_numpy
from repro_torch.train import (
    AssimilationConfig,
    SpikeDetector,
    fit_coefficient_field,
    synthetic_observations,
    true_coefficients,
)

OPT_TOL = 1e-6
TRAJ_TOL = 1e-4


def _params(seed=SEED):
    """A dict of leaves covering both Adafactor branches: a matrix above
    the factoring threshold (set low), a small matrix and a vector."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 8, 6)).astype(np.float32),
        "v": rng.standard_normal((5,)).astype(np.float32),
        "s": {"m": rng.standard_normal((2, 3)).astype(np.float32)},
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_close(got, want, tol, what):
    if isinstance(want, dict):
        for k in want:
            _assert_tree_close(got[k], want[k], tol, f"{what}/{k}")
        return
    g = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, np.float32)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


CONFIGS = {
    "adamw": dict(name="adamw", warmup_steps=2, total_steps=6),
    "adamw-bf16": dict(name="adamw", warmup_steps=2, total_steps=6, moment_dtype="bfloat16"),
    "adafactor": dict(name="adafactor", warmup_steps=2, total_steps=6, factored_threshold=16),
}


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_optimizer_updates_match_jax(label):
    """Init, then six clipped updates: the JAX state after the first
    update crosses into the port, and the rest run in both from it."""
    kw = CONFIGS[label]
    jcfg = jopt.OptimizerConfig(**kw, learning_rate=1e-2, weight_decay=0.1, grad_clip=0.5)
    tcfg = topt.OptimizerConfig(**dataclasses.asdict(jcfg))
    jinit, jupdate = jopt.make_optimizer(jcfg)
    tinit, tupdate = topt.make_optimizer(tcfg)
    params = _params()
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jinit(jp), tinit(tp)
    _assert_tree_close(ts[1], jax.tree.map(np.asarray, js[1]), 0.0, f"{label}/init")
    rng = np.random.default_rng(SEED + 1)
    for step in range(6):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 3,
                             params)
        jg, jnorm = jopt.clip_by_global_norm(_to_jax(grads), jcfg.grad_clip)
        tg, tnorm = topt.clip_by_global_norm(_to_torch(grads), tcfg.grad_clip)
        assert abs(float(tnorm) - float(jnorm)) <= OPT_TOL * float(jnorm)
        _assert_tree_close(tg, jax.tree.map(np.asarray, jg), OPT_TOL, f"{label}/clip {step}")
        jp, js = jupdate(jg, js, jp)
        if step == 0:  # carry the JAX state (and params) across
            ts = optimizer_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
            tp = _to_torch(jax.tree.map(np.asarray, jp))
            continue
        tp, ts = tupdate(tg, ts, tp)
        assert int(ts.step) == int(js.step)
        _assert_tree_close(tp, jax.tree.map(np.asarray, jp), OPT_TOL, f"{label}/params {step}")
        for f in ts._fields[1:]:
            _assert_tree_close(getattr(ts, f), jax.tree.map(np.asarray, getattr(js, f)),
                               OPT_TOL if "bf16" not in label else 1e-2, f"{label}/{f} {step}")


def test_schedule_lr_matches_jax():
    kw = dict(learning_rate=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jopt.schedule_lr(jcfg, jnp.int32(step)))
        got = float(topt.schedule_lr(tcfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * max(abs(want), 1e-30), (step, got, want)


def test_interop_rejects_other_states():
    with pytest.raises(TypeError, match="AdamWState or AdafactorState"):
        optimizer_state_from_numpy((np.zeros(()), {}, {}), device="cpu")


def test_spike_detector_flags_the_same_steps():
    losses = [1.0, 0.9, 0.8, 0.85, 0.7, 0.6, 0.65, 9.0, 0.5, float("nan"), 0.45,
              0.4, 3.0, 0.35, float("inf"), 0.3] + [0.3 - 0.01 * i for i in range(10)]
    jd, td = JaxSpikeDetector(factor=4.0, warmup=3, window=5), SpikeDetector(4.0, 3, 5)
    flags = [(jd.record(i, x), td.record(i, x)) for i, x in enumerate(losses)]
    assert [j for j, _ in flags] == [t for _, t in flags]
    assert [s for s, _ in jd.spikes] == [s for s, _ in td.spikes] == [7, 9, 12, 14]


def test_spike_detector_records_counter_and_event():
    from repro_torch.obs import FlightRecorder, MetricsRegistry, events, metrics

    reg, rec = MetricsRegistry(), FlightRecorder()
    with metrics.using(reg), events.using(rec):
        det = SpikeDetector(warmup=0)
        for i, x in enumerate([1.0, 1.0, 10.0]):
            det.record(i, x)
    assert reg.counters["train.loss_spikes"] == 1.0
    (ev,) = rec.events("train.loss_spike")
    assert ev.data["step"] == 2 and ev.data["threshold"] == 5.0


# -- the assimilation fit -------------------------------------------------------

GRID = (2, 16, 16)


def _twin():
    u0 = np.random.default_rng(SEED).standard_normal(GRID).astype(np.float32)
    coeff_true = np.array(jax_true_coefficients(GRID, seed=1))
    return u0, coeff_true


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_fit_coefficient_field_converges_like_jax(backend):
    """The >= 10x first-to-best drop, the ring untouched, and the loss
    trajectory of the JAX package's fit on the same numpy inputs."""
    u0, coeff_true = _twin()
    jcfg = JaxAssimilationConfig(steps=40)
    want = jax_fit(jnp.asarray(u0), jax_observations(jnp.asarray(u0), jnp.asarray(coeff_true),
                                                     jcfg), jcfg)
    cfg = AssimilationConfig(steps=40, backend=backend)
    u0_t = torch.from_numpy(u0)
    obs = synthetic_observations(u0_t, torch.from_numpy(coeff_true), cfg).detach()
    res = fit_coefficient_field(u0_t, obs, cfg)
    assert res.loss_ratio >= 10.0, f"loss only improved {res.loss_ratio:.1f}x"
    assert res.losses[-1] < res.losses[0] and not res.spikes
    ring = np.ones(GRID[-2:], bool)
    ring[2:-2, 2:-2] = False
    np.testing.assert_array_equal(res.coeff.numpy()[..., ring], np.float32(0.025))
    lj, lt = np.array(want.losses), np.array(res.losses)
    rel = np.abs(lt - lj) / lj
    assert rel.max() <= TRAJ_TOL, f"trajectory off by {rel.max():.3e} (step {rel.argmax()})"


def test_fit_k2_matches_jax_first_steps():
    """Temporal blocking: the fit through repeat(p, 2) (two augmented and two
    adjoint sweeps a step) tracks the JAX package's for 10 steps."""
    u0, coeff_true = _twin()
    jcfg = JaxAssimilationConfig(steps=10, k=2)
    want = jax_fit(jnp.asarray(u0), jax_observations(jnp.asarray(u0), jnp.asarray(coeff_true),
                                                     jcfg), jcfg)
    cfg = AssimilationConfig(steps=10, k=2)
    u0_t = torch.from_numpy(u0)
    obs = synthetic_observations(u0_t, torch.from_numpy(coeff_true), cfg).detach()
    res = fit_coefficient_field(u0_t, obs, cfg)
    rel = np.abs(np.array(res.losses) - np.array(want.losses)) / np.array(want.losses)
    assert rel.max() <= TRAJ_TOL


def test_true_coefficients_is_seeded_and_in_range():
    a = true_coefficients((2, 8, 8), seed=3, device="cpu")
    assert torch.equal(a, true_coefficients((2, 8, 8), seed=3, device="cpu"))
    assert not torch.equal(a, true_coefficients((2, 8, 8), seed=4, device="cpu"))
    assert a.dtype == torch.float32 and float(a.min()) > 0.025 * 0.75
    assert float(a.max()) < 0.025 * 1.25
