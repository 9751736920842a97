"""The LM trainer tensor-parallel over ``model`` on gloo ranks, against the
port's one-process trainer and the JAX package's ``make_train_step``, on
the CPU.

On a mesh whose ``model`` axis is larger than 1, ``make_train_step``
computes each rank's share of the heads, kv heads, ``mlp``, RG-LRU width
and vocabulary (a vocabulary-parallel loss), a replicated branch whole.
One spawn of four ranks (``torch_dist_harness.train_tp_suite``; the
children import no JAX) runs every case while the parent computes the
references. Two steps at float32 compute from the seed, labels ``-100``
unevenly over the rows, the MoE archs dropless, on ``("data", "model")``
meshes ``(1, 2)`` (a pair of ranks), ``(1, 4)`` and ``(2, 2)``, one with
two microbatches:

* qwen1.5 (every split even; tied embeddings), glm4 (2 kv heads
  replicated on 4 ranks: k and v projected whole and entering the split
  attention after it; split on 2; 32 tokens through the flash scan below
  a lowered ``FLASH_THRESHOLD``), recurrentgemma (2 heads replicated on 4 and split
  on 2, the RG-LRU width split: K6's plain version and its backward on
  each rank's channels, the gate products' reduce-scatter), rwkv6 (the
  time mix whole on every rank over two 64-token chunks: K7's and K7's
  backward's plain versions; the channel mix split), starcoder2 with 6
  heads (``model`` splits none of them: the blocked local path, its
  blocks split over ``model``, taken below a lowered
  ``FLASH_THRESHOLD``), arctic (64 padded heads: the head mask on each
  rank's heads; bfloat16 parameters, Adafactor, the dense residual),
  qwen3-moe (the expert-parallel MoE beside tensor-parallel attention) and
  llama-vision (cross-attention over ``memory``; its kv heads on 4 ranks
  replicated).
* Against the port on one process: both losses and the first grad norm
  within ``SHARDED_LOSS_REL`` (1e-5) relative, the second grad norm within
  ``SHARDED_NORM2_REL`` (5e-5) (RWKV-6's grad norms within
  ``RWKV_TP_NORM_REL``, 1e-4: its first reads 3.6e-5, its f32 gradients
  amplifying the other summation order), every parameter and moment gathered whole
  within ``TOL`` (2e-4; a bfloat16 leaf: and 2^-8 of its value, one
  bfloat16 step where the rounding of a sum lands on the other side);
  every rank's metrics equal. Against JAX's one-device step on the same
  numpy weights: the first step's loss and grad norm within 2e-4
  relative.
* Every parameter and moment piece that ``model`` does not split is
  bit-equal on every model rank after each step (the replicas never
  drift).
* ``token_nll_sharded`` on four ranks' vocabulary columns equals
  ``token_nll`` on the whole logits, padded labels included, and its
  gradient is the whole gradient's columns.
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
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers
from repro_torch.models.lm import lm_stacked, token_nll
from repro_torch.optim import optimizer_config_from_model
from repro_torch.train import init_train_state, make_train_step, shape_for_microbatches
from repro_torch.tree import tree_flatten, tree_map

from torch_dist_harness import SEED_TRAIN, start_ranks, train_tp_suite

BATCH, SEQ, STEPS = 8, 16, 2
SEQS = {"rwkv6-3b": 128, "starcoder2-3b": 32, "glm4-9b": 32}  # rwkv6: two chunks (K7's path)
# 32 tokens past a lowered FLASH_THRESHOLD: starcoder2's blocked local path
# (8 blocks of 4), glm4's flash scan (its autograd Function on local heads).
FLASH = {"starcoder2-3b": 16, "glm4-9b": 16}
MOE = ("qwen3-moe-235b-a22b", "arctic-480b")
OVER = {"starcoder2-3b": {"n_heads": 6}}  # 6 heads on 4 model ranks: blocks split instead
# (arch, mesh shape, remat, microbatches)
CASES = [
    ("qwen1.5-0.5b", (1, 2), False, 1),
    ("qwen1.5-0.5b", (1, 4), False, 1),
    ("qwen1.5-0.5b", (2, 2), True, 2),
    ("glm4-9b", (1, 4), True, 1),
    ("glm4-9b", (2, 2), False, 1),
    ("recurrentgemma-2b", (1, 4), True, 1),
    ("recurrentgemma-2b", (1, 2), False, 1),
    ("rwkv6-3b", (1, 4), True, 1),
    ("starcoder2-3b", (1, 4), True, 1),
    ("arctic-480b", (2, 2), True, 1),
    ("qwen3-moe-235b-a22b", (1, 4), False, 1),
    ("llama-3.2-vision-90b", (1, 4), False, 1),
    ("llama-3.2-vision-90b", (2, 2), True, 1),
]
SHARDED_LOSS_REL = 1e-5
SHARDED_NORM2_REL = 5e-5
# RWKV-6's float32 gradients move ~1e-4 relative when its residual stream
# moves by a rounding step (the chunked WKV's backward), and a split
# ``model`` sums in another order than one process: its first grad norm on
# (1, 4) reads 3.6e-5 off one process's. The bound for its grad norms.
RWKV_TP_NORM_REL = 1e-4
JAX_REL = 2e-4
TOL = 2e-4
BF16_REL = 2.0**-8
OPT = {"warmup_steps": 1}  # the first step moves at the full learning rate


def _over(arch, remat=False):
    over = {"compute_dtype": "float32", "remat": remat, **OVER.get(arch, {})}
    if arch in MOE:
        over["capacity_factor"] = 64.0
    return over


def _cfg(arch, remat=False):
    return dataclasses.replace(get_smoke_config(arch), **_over(arch, remat))


def _opt(cfg):
    return dataclasses.replace(optimizer_config_from_model(cfg), **OPT)


@functools.cache
def _batches(arch, seed=7):
    """Global batches with ``-100`` labels spread unevenly over the rows,
    llama-vision's ``memory``."""
    cfg = _cfg(arch)
    seq = SEQS.get(arch, SEQ)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (BATCH, seq + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, :5] = -100
        labels[1, :seq - 1] = -100
        labels[5, 3:9] = -100
        labels[6, i] = -100
        batch = {"tokens": toks[:, :-1].copy(), "labels": labels}
        if cfg.frontend == "vision":
            batch["memory"] = rng.standard_normal(
                (BATCH, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return tuple(out)


def _key(arch, shape, mb):
    return f"{arch} {shape} mb{mb}"


def _nll_case():
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((3, 7, 64))).astype(np.float32)
    labels = rng.integers(0, 64, (3, 7)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, 6] = -100
    return logits, labels


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {_key(arch, shape, mb): (arch, _over(arch, remat), OPT, shape, mb,
                                     list(_batches(arch)), FLASH.get(arch))
             for arch, shape, remat, mb in CASES}
    spawn = start_ranks(train_tp_suite, 4, tmp_path_factory.mktemp("tp4"), cases, _nll_case(),
                        timeout=300)
    refs = {(arch, mb): _one_device(arch, mb) for arch, _, _, mb in CASES}
    jax_refs = {arch: _jax_first_step(arch) for arch in dict.fromkeys(a for a, *_ in CASES)}
    return spawn.join(), refs, jax_refs


def _numpy(tree):
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(), tree)


@functools.cache
def _one_device(arch, mb):
    cfg = _cfg(arch)
    params, state = init_train_state(cfg, "cpu", seed=SEED_TRAIN)
    step = make_train_step(cfg, _opt(cfg), microbatches=mb)
    out = {"loss": [], "grad_norm": []}
    threshold = layers.FLASH_THRESHOLD
    layers.FLASH_THRESHOLD = FLASH.get(arch, threshold)
    try:
        for batch in _batches(arch):
            params, state, m = step(params, state, shape_for_microbatches(batch, mb))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    finally:
        layers.FLASH_THRESHOLD = threshold
    out["params"], out["state"] = _numpy(params), _numpy(state)
    return out


def _jax_first_step(arch):
    """JAX's ``make_train_step``, one device, first step, on the port's
    initial weights (its optimizer state freshly initialised)."""
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(jax_smoke_config(arch), **_over(arch))
    jopt = dataclasses.replace(jax_opt_config(jcfg), **OPT)
    pdt = jnp.dtype(jcfg.param_dtype)
    params = _numpy(init_train_state(cfg, "cpu", seed=SEED_TRAIN)[0])
    params = lm_stacked(cfg, params, lambda ts, stacked: np.stack(ts) if stacked else ts[0])
    params = jax.tree.map(lambda a: jnp.asarray(a, pdt), params)
    state = jax_make_optimizer(jopt)[0](params)
    _, _, m = jax.jit(jax_make_train_step(jcfg, jopt))(params, state, _batches(arch)[0])
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


def _leaves_close(mine, ref, bf16, what):
    a, da = tree_flatten(mine)
    b, db = tree_flatten(ref)
    assert da == db, what
    for x, y in zip(a, b):
        assert x.shape == y.shape, what
        np.testing.assert_allclose(x, y, rtol=BF16_REL if bf16 else 0, atol=TOL, err_msg=what)


def _results(found, key):
    return [res[key] for res in found]


@pytest.mark.parametrize("arch,shape,remat,mb", CASES)
def test_tensor_parallel_steps_match_one_process(ranks, arch, shape, remat, mb):
    found, refs, _ = ranks
    one = refs[(arch, mb)]
    mine = _results(found, _key(arch, shape, mb))
    for r, res in enumerate(mine):
        assert res["loss"] == mine[0]["loss"] and res["grad_norm"] == mine[0]["grad_norm"], r
    got = mine[0]
    _close(got["loss"], one["loss"], SHARDED_LOSS_REL)
    norm1, norm2 = ((RWKV_TP_NORM_REL,) * 2 if arch == "rwkv6-3b"
                    else (SHARDED_LOSS_REL, SHARDED_NORM2_REL))
    _close(got["grad_norm"][:1], one["grad_norm"][:1], norm1)
    _close(got["grad_norm"][1:], one["grad_norm"][1:], norm2)
    cfg = _cfg(arch)
    _leaves_close(got["params"], one["params"], cfg.param_dtype == "bfloat16",
                  "params vs one process")
    _leaves_close(got["state"], one["state"], cfg.moment_dtype == "bfloat16",
                  "state vs one process")


@pytest.mark.parametrize("arch,shape,remat,mb", CASES)
def test_model_replicated_pieces_stay_bit_equal(ranks, arch, shape, remat, mb):
    found, _, _ = ranks
    mine = _results(found, _key(arch, shape, mb))
    size = shape[0] * shape[1]
    for step in range(STEPS):
        by_data = {}  # the model ranks of one data coordinate of one mesh
        for r, res in enumerate(mine):
            by_data.setdefault((r // size, res["coords"][0]), []).append(res["replicated"][step])
        for digests in by_data.values():
            assert len(digests) == shape[1]
            assert any(d is not None for d in digests[0])
            assert all(d == digests[0] for d in digests), f"step {step}"


@pytest.mark.parametrize("arch", list(dict.fromkeys(a for a, *_ in CASES)))
def test_first_step_matches_jax(ranks, arch):
    found, _, jax_refs = ranks
    shape, mb = next((s, m) for a, s, _, m in CASES if a == arch)
    got = found[0][_key(arch, shape, mb)]
    want = jax_refs[arch]
    _close(got["loss"][0], want["loss"], JAX_REL)
    _close(got["grad_norm"][0], want["grad_norm"], JAX_REL)


def test_vocab_parallel_nll_equals_the_plain_one(ranks):
    found, _, _ = ranks
    logits, labels = _nll_case()
    whole = torch.from_numpy(logits).requires_grad_()
    nll, count = token_nll(whole, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(nll, whole)
    n = logits.shape[-1] // len(found)
    for r, res in enumerate(found):
        got = res["nll"]
        assert got["count"] == int(count) == int((labels >= 0).sum())
        _close(got["nll"], float(nll.detach()), 1e-6)
        np.testing.assert_allclose(got["grad"], grad[..., r * n:(r + 1) * n].numpy(),
                                   rtol=0, atol=1e-6)
