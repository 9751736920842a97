"""The sharded LM trainer on the media LMs, gloo ranks against one device
and the JAX package, on the CPU.

One spawn of four ranks through ``tests/torch_dist_harness.py``
(``train_suite``, no checkpoint drills; the children import no JAX) runs
two steps of the smoke ``llama-3.2-vision-90b`` (``memory`` in every
batch, cut into the ranks' rows with the tokens) and ``hubert-xlarge``
(frames in place of tokens; its ``embed``, which the loss never reads,
gets a zero gradient and no gather on any rank) at float32 compute, from
the seed, on ``tests/test_torch_train_sharded.py``'s meshes: ``(4, 1)``,
``(2, 2)``, ``(1, 4)``, ``(2, 2, 1)`` with ``pod``, ``(4,)`` without
``model`` and ``(2, 2)`` with two microbatches, labels ``-100`` unevenly
over the rows. The cross-attention gates start at zero, so the first step
moves them and the second runs the media path live. Both steps' losses and
the first grad norm within 1e-5 relative of one device's and of JAX's
(the second grad norm 5e-5 and 2e-4), every parameter and moment gathered
whole within 2e-4 (a bfloat16 moment: and 2^-8 of its value), as there.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import optimizer_config_from_model as jax_opt_config
from repro.train import make_train_step as jax_make_train_step
from repro.train import shape_for_microbatches as jax_shape
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import lm_stacked
from repro_torch.optim import optimizer_config_from_model
from repro_torch.train import init_train_state, make_train_step, shape_for_microbatches
from repro_torch.tree import tree_flatten, tree_map

from torch_dist_harness import SEED_TRAIN, start_ranks, train_suite

ARCHS = ["llama-3.2-vision-90b", "hubert-xlarge"]
# (name, mesh shape, axes, remat, microbatches): tests/test_torch_train_sharded.py's
MESHES = [
    ("dm4x1", (4, 1), ("data", "model"), False, 1),
    ("dm2x2", (2, 2), ("data", "model"), True, 1),
    ("dm1x4", (1, 4), ("data", "model"), False, 1),
    ("pdm2x2x1", (2, 2, 1), ("pod", "data", "model"), True, 1),
    ("d4", (4,), ("data",), False, 1),
    ("dm2x2mb2", (2, 2), ("data", "model"), True, 2),
]
BATCH, SEQ, STEPS = 8, 16, 2
LOSS_REL = 1e-5
NORM2_REL = 2e-4
SHARDED_NORM2_REL = 5e-5
TOL = 2e-4
BF16_REL = 2.0**-8
OPT = {"warmup_steps": 1}


def _over(remat):
    return {"compute_dtype": "float32", "remat": remat}


@functools.cache
def _batches(arch, n=STEPS, seed=7):
    """Global batches: tokens (frames for hubert), ``memory`` for
    llama-vision, ``-100`` labels spread unevenly over the rows."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        labels[0, :5] = -100
        labels[1, :SEQ - 1] = -100
        labels[5, 3:9] = -100
        labels[6, i] = -100
        if cfg.frontend == "audio":
            toks = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
        else:
            toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        batch = {"tokens": toks, "labels": labels}
        if cfg.frontend == "vision":
            batch["memory"] = rng.standard_normal(
                (BATCH, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return tuple(out)


def _cases():
    return {(arch, name): (arch, _over(remat), OPT, shape, axes, mb, list(_batches(arch)))
            for arch in ARCHS for name, shape, axes, remat, mb in MESHES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spawn = start_ranks(train_suite, 4, tmp_path_factory.mktemp("media4"), _cases(), "", None,
                        timeout=300)
    refs = {(arch, mb): (_one_device(arch, mb), _jax(arch, mb)) for arch in ARCHS
            for mb in (1, 2)}
    return spawn.join(), refs


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), **_over(False))


def _opt(cfg):
    return dataclasses.replace(optimizer_config_from_model(cfg), **OPT)


def _numpy(tree):
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(), tree)


def _stack(cfg, tree):
    return lm_stacked(cfg, tree, lambda ts, stacked: np.stack(ts) if stacked else ts[0])


@functools.cache
def _one_device(arch, mb):
    cfg = _cfg(arch)
    params, state = init_train_state(cfg, "cpu", seed=SEED_TRAIN)
    step = make_train_step(cfg, _opt(cfg), microbatches=mb)
    out = {"loss": [], "grad_norm": []}
    for batch in _batches(arch):
        params, state, m = step(params, state, shape_for_microbatches(batch, mb))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"], out["state"] = _numpy(params), _numpy(state)
    return out


@functools.cache
def _jax(arch, mb):
    """JAX's ``make_train_step`` on the global batches from the port's
    initial weights (its optimizer state freshly initialised)."""
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(jax_smoke_config(arch), **_over(False))
    jopt = dataclasses.replace(jax_opt_config(jcfg), **OPT)
    pdt = jnp.dtype(jcfg.param_dtype)
    params0, _ = init_train_state(cfg, "cpu", seed=SEED_TRAIN)
    params = jax.tree.map(lambda a: jnp.asarray(a, pdt), _stack(cfg, _numpy(params0)))
    state = jax_make_optimizer(jopt)[0](params)
    step = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=mb))
    out = {"loss": [], "grad_norm": []}
    for batch in _batches(arch):
        params, state, m = step(params, state, jax_shape(batch, mb))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    out["state"] = jax.tree.map(lambda a: np.asarray(a, np.float32), state)
    return out


def _metrics_close(got, want, norm2_rel):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_REL, atol=0)
    np.testing.assert_allclose(got["grad_norm"][:1], want["grad_norm"][:1], rtol=LOSS_REL, atol=0)
    np.testing.assert_allclose(got["grad_norm"][1:], want["grad_norm"][1:], rtol=norm2_rel,
                               atol=0)


def _leaves_close(mine, ref, bf16, what):
    a, da = tree_flatten(mine)
    b, db = tree_flatten(ref)
    assert da == db, what
    for x, y in zip(a, b):
        assert x.shape == y.shape, what
        np.testing.assert_allclose(x, y, rtol=BF16_REL if bf16 else 0, atol=TOL, err_msg=what)


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_one_device_and_jax(ranks, arch, mesh):
    found, refs = ranks
    got = found[0][(arch, mesh)]
    mb = dict((m[0], m[4]) for m in MESHES)[mesh]
    one, jx = refs[(arch, mb)]
    for r, res in enumerate(found):
        mine = res[(arch, mesh)]
        _metrics_close(mine, one, SHARDED_NORM2_REL)
        assert mine["loss"] == got["loss"] and mine["grad_norm"] == got["grad_norm"], r
    _metrics_close(got, jx, NORM2_REL)
    cfg = _cfg(arch)
    p16, m16 = cfg.param_dtype == "bfloat16", cfg.moment_dtype == "bfloat16"
    _leaves_close(got["params"], one["params"], p16, "params vs one device")
    _leaves_close(got["state"], one["state"], m16, "state vs one device")
    _leaves_close(_stack(cfg, got["params"]), jx["params"], p16, "params vs JAX")
    state = got["state"]
    for f in state._fields[1:]:
        _leaves_close(_stack(cfg, getattr(state, f)), getattr(jx["state"], f), m16,
                      f"{f} vs JAX")
    assert int(state.step) == int(jx["state"].step) == STEPS
    if cfg.frontend == "audio":  # embed: a zero gradient on every rank, so zero moments
        assert not np.any(state.mu["embed"]) and not np.any(state.nu["embed"])
    else:  # the gates moved off zero in the first step
        gates = [b["mixer"]["gate"] for b in got["params"]["blocks"] if "gate" in b["mixer"]]
        assert gates and all(abs(float(g)) > 0 for g in gates)
