"""LM training in the port against the JAX package on the CPU.

* One ``make_train_step`` from the same weights (``lm_params_from_numpy``),
  the same optimizer state after one JAX step (``optimizer_state_from_numpy``,
  moments unstacked into the port's per-layer layout) and the same batch, at
  float32 compute: loss, grad norm, updated parameters and moments within
  2e-4 of the JAX step, for both recurrent smoke configs (RWKV-6 at a
  sequence length its chunk divides, so the chunked form runs), with one
  and with two microbatches.
* ``train()`` held to the statements of the three reference tests that
  are red on this JAX version (``test_train_resume_from_checkpoint``,
  ``test_sigterm_triggers_checkpoint_and_resume`` and
  ``test_train_health_checkpoint_then_abort_survives_donation``): the port
  runs them on RecurrentGemma's smoke config.
* K6's backward: the plain reverse recurrence against autograd through
  the plain forward and against ``jax.grad`` of the JAX oracle, within
  ``GRAD_TOL``.
"""

import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import GRAD_TOL
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_ref
from repro.models import build_lm as jax_build_lm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import optimizer_config_from_model as jax_opt_config
from repro.train import make_train_step as jax_make_train_step
from repro.train import shape_for_microbatches as jax_shape
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.interop import lm_params_from_numpy, lm_tree_from_numpy
from repro_torch.interop import optimizer_state_from_numpy
from repro_torch.kernels.rglru import rglru_backward, rglru_scan, rglru_seq_ref
from repro_torch.models import lm_params
from repro_torch.obs.health import NumericsError
from repro_torch.optim import optimizer_config_from_model
from repro_torch.train import (TrainConfig, init_train_state, make_train_step,
                               shape_for_microbatches, train)
from repro_torch.tree import tree_flatten, tree_map

REPO = Path(__file__).resolve().parent.parent
TOL = 2e-4
# Each leaf's step delta (after minus before) against the JAX package's, as
# a share of the largest JAX delta: an update never applied, of the wrong
# sign or at a wrong learning rate misses by 100 % or more; float32
# rounding of the stored parameters and of near-zero gradients costs up to
# about 0.4 % at the compared step's learning rate.
DELTA_TOL = 1e-2
SEQ = {"recurrentgemma-2b": 16, "rwkv6-3b": 64}  # RWKV-6: its 64-step chunk divides it


def _batch(vocab, seq, seed):
    t = np.random.default_rng(seed).integers(0, vocab, (4, seq + 1)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
    b["labels"][0, :3] = -100  # padded positions
    return b


@functools.cache
def _jax_steps(arch, mb):
    """The JAX side: weights, one step (for a non-zero state), then the
    compared step; numpy trees of the state before and after it. The warmup
    is one step, so the compared step moves each parameter at the full
    learning rate."""
    cfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32")
    params, _ = jax_build_lm(cfg, jax.random.PRNGKey(0))
    ocfg = dataclasses.replace(jax_opt_config(cfg), warmup_steps=1)
    init, _ = jax_make_optimizer(ocfg)
    step = jax.jit(jax_make_train_step(cfg, ocfg, microbatches=mb))
    p1, o1, _ = step(params, init(params), jax_shape(_batch(cfg.vocab_size, SEQ[arch], 0), mb))
    p2, o2, m2 = step(p1, o1, jax_shape(_batch(cfg.vocab_size, SEQ[arch], 1), mb))
    host = functools.partial(jax.tree.map, np.asarray)
    return host(p1), host(o1), host(p2), host(o2), {k: float(v) for k, v in m2.items()}


def _opt_config(cfg):
    return dataclasses.replace(optimizer_config_from_model(cfg), warmup_steps=1)


def _max_err(jax_tree, port_tree, cfg):
    want = tree_flatten(lm_tree_from_numpy(cfg, jax_tree))[0]
    got = tree_flatten(port_tree)[0]
    assert len(want) == len(got)
    return max(float(np.abs(w - g.detach().numpy()).max()) for w, g in zip(want, got))


def _max_delta_err(jax_before, jax_after, port_before, port_after, cfg):
    """The largest leaf-wise miss of the port's step delta against the JAX
    package's, as a share of that leaf's largest JAX delta."""
    worst = 0.0
    for a, b, x, y in zip(*(tree_flatten(lm_tree_from_numpy(cfg, t))[0]
                            for t in (jax_before, jax_after)),
                          port_before, tree_flatten(port_after)[0]):
        want, got = b - a, (y - x).detach().numpy()
        assert np.abs(want).max() > 0
        worst = max(worst, float(np.abs(want - got).max() / np.abs(want).max()))
    return worst


@pytest.mark.parametrize("arch,mb", [("recurrentgemma-2b", 1), ("recurrentgemma-2b", 2),
                                     ("rwkv6-3b", 1)])
def test_train_step_matches_jax(arch, mb):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    p1, o1, p2, o2, m2 = _jax_steps(arch, mb)
    params = tree_map(lambda t: t.detach().clone(),
                      lm_params(lm_params_from_numpy(cfg, p1, device="cpu")))
    before = [t.clone() for t in tree_flatten(params)[0]]
    state = optimizer_state_from_numpy(o1, device="cpu", cfg=cfg)
    step = make_train_step(cfg, _opt_config(cfg), microbatches=mb)
    batch = shape_for_microbatches(_batch(cfg.vocab_size, SEQ[arch], 1), mb)
    params, state, m = step(params, state, batch)
    assert abs(float(m["loss"]) - m2["loss"]) <= TOL
    assert abs(float(m["grad_norm"]) - m2["grad_norm"]) <= TOL * max(1.0, m2["grad_norm"])
    assert int(state.step) == 2
    assert _max_err(p2, params, cfg) <= TOL
    assert _max_delta_err(p1, p2, before, params, cfg) <= DELTA_TOL
    assert _max_err(o2.mu, state.mu, cfg) <= TOL
    assert _max_err(o2.nu, state.nu, cfg) <= TOL
    if mb == 1:
        assert float(m["ntokens"]) == m2["ntokens"] and float(m["aux_loss"]) == 0.0


def test_remat_and_bf16_compute_train_the_same_model():
    """``cfg.remat`` recomputes each block in the backward (the same
    gradients, bit for bit on the CPU); bf16 compute casts the f32 masters
    inside the loss and still returns f32 gradients and masters."""
    cfg = get_smoke_config("recurrentgemma-2b")
    batch = _batch(cfg.vocab_size, 16, 2)
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, compute_dtype="float32")
        params, state = init_train_state(c, "cpu", seed=1)
        params, state, m = make_train_step(c, optimizer_config_from_model(c))(params, state,
                                                                             batch)
        outs.append((float(m["loss"]), tree_flatten(params)[0]))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    params, state = init_train_state(cfg, "cpu", seed=1)
    params, state, m = make_train_step(cfg, optimizer_config_from_model(cfg))(params, state,
                                                                             batch)
    assert np.isfinite(float(m["loss"]))
    assert all(p.dtype == torch.float32 for p in tree_flatten(params)[0])


# -- train(): the statements of the three red reference tests ----------------------


def _cfg(learning_rate=3e-3):
    return dataclasses.replace(get_smoke_config("recurrentgemma-2b"), vocab_size=64,
                               d_model=32, rnn_width=32, d_ff=64, head_dim=16,
                               learning_rate=learning_rate)


def _ds(cfg):
    return SyntheticLM(DataConfig(seq_len=8, global_batch=4, vocab_size=cfg.vocab_size))


def _quiet(*_):
    return None


def test_train_resume_from_checkpoint(tmp_path):
    cfg = _cfg()
    tc = TrainConfig(steps=6, ckpt_every=2, ckpt_dir=str(tmp_path), log_every=100)
    _, _, hist1 = train(cfg, tc, _ds(cfg), device="cpu", log_fn=_quiet)
    assert [h["step"] for h in hist1] == list(range(6))
    assert latest_step(tmp_path) == 5
    # resume: should start after step 5 -> no further steps executed
    _, _, hist2 = train(cfg, tc, _ds(cfg), device="cpu", log_fn=_quiet)
    assert hist2 == []


def test_interrupted_and_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """A SIGTERM at step 3 commits a synchronous checkpoint and returns; the
    rerun resumes at step 4 and ends with the parameters and optimizer
    state of a run that was never interrupted, bit for bit."""
    cfg = _cfg()
    ref_params, ref_state, _ = train(cfg, TrainConfig(steps=6, log_every=100), _ds(cfg),
                                     device="cpu", log_fn=_quiet)
    tc = TrainConfig(steps=6, ckpt_every=2, ckpt_dir=str(tmp_path), log_every=1)
    logged = []

    def log(msg):
        logged.append(msg)
        if "step 3 " in msg:
            os.kill(os.getpid(), signal.SIGTERM)

    _, _, hist1 = train(cfg, tc, _ds(cfg), device="cpu", log_fn=log)
    assert [h["step"] for h in hist1] == [0, 1, 2, 3]
    assert any("SIGTERM at step 3" in m for m in logged)
    assert latest_step(tmp_path) == 3
    assert signal.getsignal(signal.SIGTERM) is not None  # the handler was restored
    params, state, hist2 = train(cfg, tc, _ds(cfg), device="cpu", log_fn=log)
    assert [h["step"] for h in hist2] == [4, 5]
    for a, b in zip(tree_flatten((params, state))[0], tree_flatten((ref_params, ref_state))[0]):
        assert torch.equal(a, b)


PREEMPT_SCRIPT = """
import os, signal, sys
sys.path.insert(0, {src!r})
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.train import TrainConfig, train

cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), vocab_size=64, d_model=32,
                          rnn_width=32, d_ff=64, head_dim=16)
ds = SyntheticLM(DataConfig(seq_len=8, global_batch=4, vocab_size=64))
tc = TrainConfig(steps={steps}, ckpt_every=10_000, ckpt_dir={ckpt!r}, log_every=1)

def log(msg):
    print(msg, flush=True)
    if "step 3 " in msg:          # simulate the preemption notice mid-run
        os.kill(os.getpid(), signal.SIGTERM)

train(cfg, tc, ds, device="cpu", log_fn=log)
print("EXITED_CLEANLY", flush=True)
"""


def _preempt(tmp_path, steps):
    script = PREEMPT_SCRIPT.format(src=str(REPO / "src"), ckpt=str(tmp_path), steps=steps)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_sigterm_triggers_checkpoint_and_resume(tmp_path):
    out = _preempt(tmp_path, 10_000)
    assert "EXITED_CLEANLY" in out and "SIGTERM" in out
    step = latest_step(tmp_path)
    assert step is not None and step >= 3
    out = _preempt(tmp_path, step + 2)
    assert f"resuming at {step + 1}" in out and "SIGTERM" not in out
    assert latest_step(tmp_path) == step + 1


def test_train_health_checkpoint_then_abort_survives_buffer_reuse(tmp_path):
    """The step updates (params, opt_state) in place, so the last-healthy
    state the loss monitor retains would hold the next step's values unless
    it was host-snapshotted at probe time. A diverging run (lr=1e9) must
    COMMIT the last healthy step's state before the abort: the checkpoint
    equals a clean run stopped at that step."""
    cfg = _cfg(learning_rate=1e9)
    tc = TrainConfig(steps=6, ckpt_every=10_000, ckpt_dir=str(tmp_path), log_every=100,
                     health_every=1, health_policy="checkpoint-then-abort")
    with pytest.raises(NumericsError) as ei:
        train(cfg, tc, _ds(cfg), device="cpu", log_fn=_quiet)
    bad = ei.value.step
    assert bad >= 1 and ei.value.stats["nan_count"] + ei.value.stats["inf_count"] == 1
    assert latest_step(tmp_path) == bad - 1
    meta = json.loads((tmp_path / f"step_{bad - 1:08d}" / "meta.json").read_text())
    assert meta["extra"]["reason"] == "health-abort"
    assert meta["health"]["nan_count"] == 0 and meta["health"]["inf_count"] == 0
    params, state, _ = train(cfg, TrainConfig(steps=bad, log_every=100), _ds(cfg),
                             device="cpu", log_fn=_quiet)
    saved, _ = restore_checkpoint(tmp_path, bad - 1, (params, state))
    for a, b in zip(tree_flatten(saved)[0], tree_flatten((params, state))[0]):
        assert torch.equal(a, b)


def test_checkpoint_then_abort_needs_a_directory():
    cfg = _cfg()
    with pytest.raises(ValueError, match="needs ckpt_dir"):
        train(cfg, TrainConfig(steps=1, health_every=1, health_policy="checkpoint-then-abort"),
              _ds(cfg), device="cpu", log_fn=_quiet)


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        train(_cfg(), TrainConfig(steps=1), _ds(_cfg()), log_fn=_quiet)


# -- K6's backward -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 13, 5), (1, 1, 3), (3, 40, 8)])
def test_plain_reverse_recurrence_against_autograd_and_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a_np = (0.5 + 0.499 * rng.random(shape)).astype(np.float32)
    b_np = rng.standard_normal(shape).astype(np.float32)
    h0_np = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    dh = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dlast = torch.from_numpy(rng.standard_normal((shape[0], shape[2])).astype(np.float32))
    a, b, h0 = (torch.from_numpy(x).requires_grad_() for x in (a_np, b_np, h0_np))
    h, last = rglru_scan(a, b, h0)  # the autograd Function (plain on the CPU)
    got = torch.autograd.grad((h * dh).sum() + (last * dlast).sum(), (a, b, h0))
    direct = rglru_backward(a.detach(), h.detach(), h0.detach(), dh, dlast)
    for x, y in zip(got, direct):
        assert torch.equal(x, y)
    h_p, last_p = rglru_seq_ref(a, b, h0)
    want = torch.autograd.grad((h_p * dh).sum() + (last_p * dlast).sum(), (a, b, h0))

    def jax_loss(a, b, h0, dh, dlast):
        hj, lj = jax_rglru_ref(a, b, h0)
        return jnp.sum(hj * dh) + jnp.sum(lj * dlast)

    jgrads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(a_np, b_np, h0_np, dh.numpy(),
                                                            dlast.numpy())
    for x, y, z in zip(got, want, jgrads):
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= GRAD_TOL * scale
        assert float(np.abs(x.numpy() - np.asarray(z)).max()) <= GRAD_TOL * scale


# -- the entry points ---------------------------------------------------------------


def test_launcher_and_example_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main as launch

    launch(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--steps", "2",
            "--global-batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "a"),
            "--ckpt-every", "1"])
    assert "[train] step 0 loss" in capsys.readouterr().out
    assert latest_step(tmp_path / "a") == 1
    with pytest.raises(KeyError, match=r"ROADMAP M13b\.3"):
        launch(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu"])
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_train_lm.py"), "--arch", "rwkv6-3b",
         "--scale", "tiny", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "b")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "arch=rwkv6-3b" in out.stdout and "loss: first10=" in out.stdout
    assert latest_step(tmp_path / "b") == 1
