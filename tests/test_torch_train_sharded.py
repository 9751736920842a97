"""The LM trainer sharded over gloo ranks (ZeRO-3 / FSDP storage;
data-parallel compute, tensor-parallel where ``model`` has more than one
rank) against the port on one device and against the JAX package's
``make_train_step``, on the CPU.

One spawn of four ranks through ``tests/torch_dist_harness.py``
(``train_suite``; the children import no JAX) runs every case while the
parent computes the references:

* **Step parity.** Two steps of the smoke ``qwen1.5-0.5b`` (dense,
  AdamW), ``rwkv6-3b``, ``qwen3-moe-235b-a22b`` (AdamW, bfloat16 moments)
  and ``arctic-480b`` (Adafactor, bfloat16 parameters and moments) at
  float32 compute, from the seed, on ``("data", "model")`` meshes
  ``(4, 1)``, ``(2, 2)``, ``(1, 4)`` and a ``("pod", "data", "model")``
  ``(2, 2, 1)``, with remat off on the first and third and on elsewhere,
  and with two microbatches on ``(2, 2)``; labels ``-100`` unevenly over
  the ranks' rows. The MoE archs run dropless (``capacity_factor=64``):
  each data rank routes its own tokens, so a capacity computed from a
  rank's tokens would drop others than one from the whole batch. Both
  steps' losses and the first step's grad norm within 1e-5 relative of
  one device's on the global batch and of JAX's; every parameter and
  moment, gathered whole, within 2e-4 (a bfloat16 leaf: also one
  bfloat16 step, 2^-8 of its value, where the rounding of a sum lands on
  the other side). The second step's grad norm is held to 2e-4 relative
  (``tests/test_torch_train_lm.py``'s bound): the first step moves every
  parameter by the full learning rate in the direction of its Adam-
  normalised gradient, which turns float32 rounding in near-zero
  gradients into parameter differences, so RWKV-6's second grad norm
  differs by 1.6e-4 between the port on one device and JAX. Against the
  port on one device, where the readings reach 2.4e-5, it is held to
  5e-5, so a fault of the sharded path alone shows there; where ``model``
  splits the step (tensor-parallel), RWKV-6's to 1e-4 (readings 5.9e-5
  and 6.3e-5).
* **Data-only mesh.** The same steps on a ``("data",)`` mesh of 4, with
  no ``model`` axis: the MoE runs its local path on each rank's rows,
  and its ``aux`` must still be the whole batch's.
* **Shares.** Each rank's pieces, each leaf's bytes over its replica
  count, sum over the ranks to the whole tree's bytes exactly, and no
  rank holds the whole tree.
* **Checkpoints.** A checkpoint saved on ``(2, 2)`` restores bit-equal
  onto ``(4, 1)`` and onto one device; a run stopped after 2 steps and
  resumed on ``(4, 1)`` gives 4 straight steps' losses within 1e-5
  relative.
* **SIGTERM.** SIGTERM to rank 1 at step 2 makes every rank save step 2
  and return.
* **Launcher.** ``python -m repro_torch.launch.train --backend gloo`` under
  a two-rank torchrun-style environment trains 2 steps and checkpoints.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

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
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import lm_stacked
from repro_torch.optim import optimizer_config_from_model
from repro_torch.train import (TrainConfig, init_train_state, make_train_step,
                               shape_for_microbatches, train)
from repro_torch.tree import tree_flatten, tree_map

from torch_dist_harness import SEED_TRAIN, start_ranks, train_suite

REPO = Path(__file__).resolve().parent.parent
ARCHS = ["qwen1.5-0.5b", "rwkv6-3b", "qwen3-moe-235b-a22b", "arctic-480b"]
MOE = ("qwen3-moe-235b-a22b", "arctic-480b")
# (name, mesh shape, axes, remat, microbatches)
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
NORM2_REL = 2e-4  # the second step's grad norm against JAX (see the module docstring)
SHARDED_NORM2_REL = 5e-5  # ... and the ranks' against one device
# ... where ``model`` splits the step (tensor-parallel: sums in another
# order), RWKV-6's, whose float32 gradients move ~1e-4 relative when its
# residual stream moves by a rounding step: it reads 6.3e-5 on (2, 2) and
# 5.9e-5 on (2, 2) with two microbatches.
RWKV_TP_NORM2_REL = 1e-4
TOL = 2e-4
BF16_REL = 2.0**-8
OPT = {"warmup_steps": 1}  # the first step moves at the full learning rate
CKPT_ARCH = "qwen1.5-0.5b"


def _over(arch, remat):
    over = {"compute_dtype": "float32", "remat": remat}
    if arch in MOE:
        over["capacity_factor"] = 64.0
    return over


@functools.cache
def _batches(vocab, n=STEPS, seed=7):
    """Global batches with ``-100`` labels spread unevenly over the rows
    (a data rank of (4, 1) holds 2 rows, of (2, 2) 4)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, :5] = -100
        labels[1, :SEQ - 1] = -100
        labels[5, 3:9] = -100
        labels[6, i] = -100
        out.append({"tokens": toks[:, :-1].copy(), "labels": labels})
    return tuple(out)


def _cases():
    cases = {}
    for arch in ARCHS:
        vocab = get_smoke_config(arch).vocab_size
        for name, shape, axes, remat, mb in MESHES:
            cases[(arch, name)] = (arch, _over(arch, remat), OPT, shape, axes, mb,
                                   list(_batches(vocab)))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = get_smoke_config(CKPT_ARCH)
    ckpt_case = (CKPT_ARCH, _over(CKPT_ARCH, False), list(_batches(ckpt.vocab_size, 6, 11)))
    root = tmp_path_factory.mktemp("ckpt")
    spawn = start_ranks(train_suite, 4, tmp_path_factory.mktemp("train4"), _cases(), str(root),
                        ckpt_case, timeout=300)
    refs = {(arch, mb): (_one_device(arch, mb), _jax(arch, mb)) for arch in ARCHS
            for mb in (1, 2)}
    return spawn.join(), refs, root


def _cfg(arch, remat=False):
    return dataclasses.replace(get_smoke_config(arch), **_over(arch, remat))


def _opt(cfg):
    return dataclasses.replace(optimizer_config_from_model(cfg), **OPT)


def _numpy(tree):
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(), tree)


def _stack(cfg, tree):
    """A per-layer numpy tree in the JAX package's stacked layout."""
    return lm_stacked(cfg, tree, lambda ts, stacked: np.stack(ts) if stacked else ts[0])


@functools.cache
def _initial(arch):
    """The port's one-device initial state from the seed (numpy)."""
    params, state = init_train_state(_cfg(arch), "cpu", seed=SEED_TRAIN)
    return _numpy(params), _numpy(state)


@functools.cache
def _one_device(arch, mb):
    cfg = _cfg(arch)
    params, state = init_train_state(cfg, "cpu", seed=SEED_TRAIN)
    step = make_train_step(cfg, _opt(cfg), microbatches=mb)
    out = {"loss": [], "grad_norm": []}
    for batch in _batches(cfg.vocab_size):
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
    jcfg = dataclasses.replace(jax_smoke_config(arch), **_over(arch, False))
    jopt = dataclasses.replace(jax_opt_config(jcfg), **OPT)
    pdt = jnp.dtype(jcfg.param_dtype)
    params = jax.tree.map(lambda a: jnp.asarray(a, pdt), _stack(cfg, _initial(arch)[0]))
    state = jax_make_optimizer(jopt)[0](params)
    step = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=mb))
    out = {"loss": [], "grad_norm": []}
    for batch in _batches(cfg.vocab_size):
        params, state, m = step(params, state, jax_shape(batch, mb))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    out["state"] = jax.tree.map(lambda a: np.asarray(a, np.float32), state)
    return out


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


def _metrics_close(got, want, norm2_rel):
    _close(got["loss"], want["loss"], LOSS_REL)
    _close(got["grad_norm"][:1], want["grad_norm"][:1], LOSS_REL)
    _close(got["grad_norm"][1:], want["grad_norm"][1:], norm2_rel)


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
    found, refs, _ = ranks
    got = found[0][(arch, mesh)]
    mb = dict((m[0], m[4]) for m in MESHES)[mesh]
    one, jx = refs[(arch, mb)]
    shape = dict((m[0], m[1]) for m in MESHES)[mesh]
    tp = len(shape) > 1 and shape[-1] > 1
    for r, res in enumerate(found):
        mine = res[(arch, mesh)]
        _metrics_close(mine, one, RWKV_TP_NORM2_REL if tp and arch == "rwkv6-3b"
                       else SHARDED_NORM2_REL)
        assert mine["loss"] == got["loss"] and mine["grad_norm"] == got["grad_norm"], r
    _metrics_close(got, jx, NORM2_REL)
    if arch in MOE and mb == 1:
        assert all(a > 0 for a in got["aux_loss"])
    cfg = _cfg(arch)
    p16, m16 = cfg.param_dtype == "bfloat16", cfg.moment_dtype == "bfloat16"
    _leaves_close(got["params"], one["params"], p16, "params vs one device")
    _leaves_close(got["state"], one["state"], m16, "state vs one device")
    # Against JAX, in its layout (AdamW's per-layer moments stacked).
    _leaves_close(_stack(cfg, got["params"]), jx["params"], p16, "params vs JAX")
    state = got["state"]
    for f in state._fields[1:]:
        mine = getattr(state, f) if cfg.optimizer == "adafactor" else _stack(cfg, getattr(state, f))
        _leaves_close(mine, getattr(jx["state"], f), m16, f"{f} vs JAX")
    assert int(state.step) == int(jx["state"].step) == STEPS


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES if m[4] == 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_pieces_share_the_whole_tree_exactly(ranks, arch, mesh):
    found, _, _ = ranks
    for i, tree in enumerate(init_train_state(_cfg(arch), "cpu", seed=SEED_TRAIN)):
        whole = sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])
        per_rank = [res[(arch, mesh)]["shares"][i] for res in found]
        assert sum(s["per_replica"] for s in per_rank) == whole
        assert all(s["bytes"] < whole for s in per_rank)


def test_checkpoint_restores_bit_equal_across_meshes(ranks):
    found, _, root = ranks
    ck = found[0]["ckpt"]
    assert ck["extra"] == {"step": 1}
    for x, y in zip(tree_flatten(ck["restored"])[0], tree_flatten(ck["saved"])[0]):
        np.testing.assert_array_equal(x, y)
    cfg = _cfg(CKPT_ARCH)
    like = init_train_state(cfg, "cpu", seed=SEED_TRAIN + 1)
    one, _ = restore_checkpoint(root / "resume", 1, like)
    # The resumed run's final save is step 3; step 1 was pruned only past keep_last.
    for x, y in zip(tree_flatten(_numpy(one))[0], tree_flatten(ck["saved"])[0]):
        np.testing.assert_array_equal(x, y)


def test_resume_on_another_mesh_gives_the_straight_losses(ranks):
    found, _, _ = ranks
    ck = found[0]["ckpt"]
    cfg = _cfg(CKPT_ARCH)
    batches = _batches(cfg.vocab_size, 6, 11)

    class Data:
        def batch_at(self, step):
            return batches[step]

    *_, hist = train(cfg, TrainConfig(steps=4, log_every=100), Data(), device="cpu",
                     seed=SEED_TRAIN, log_fn=lambda m: None)
    straight = [h["loss"] for h in hist]
    assert [s for s, _ in ck["rest"]] == [2, 3]
    _close(ck["first"] + [loss for _, loss in ck["rest"]], straight, LOSS_REL)
    for res in found[1:]:
        assert res["ckpt"]["rest"] == ck["rest"]


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(ranks):
    found, _, root = ranks
    for res in found:
        assert res["ckpt"]["sigterm_steps"] == [0, 1, 2]
        assert res["ckpt"]["sigterm_latest"] == 2
    assert latest_step(root / "sigterm") == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_trains_on_two_torchrun_ranks(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "RANK": str(rank),
               "LOCAL_RANK": str(rank), "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
             "--smoke", "--device", "cpu", "--backend", "gloo", "--steps", "2",
             "--global-batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all("[train] step 0 loss" in o for o in outs), outs
    assert latest_step(tmp_path / "ck") == 1
