"""The port's dense LMs against the JAX package on the CPU.

The four dense smoke configs (qwen1.5-0.5b, starcoder2-3b, nemotron-4-15b,
glm4-9b: q/k/v biases, GQA, a sliding window, LayerNorm, squared ReLU,
SwiGLU, tied and untied heads) with the JAX ``build_lm`` weights carried
across by ``lm_params_from_numpy`` (the zero-initialised q/k/v biases
given random values, so the bias path carries something), tokens from a
numpy seed. At ``compute_dtype="float32"``: forward logits, prefill
logits, every cache leaf and 8 decode steps within 2e-4, the bound of
``tests/test_torch_models.py``; one train step (loss, grad norm,
parameters, moments) within 2e-4 of the JAX ``make_train_step``; the
``BatchedServer``'s greedy tokens equal to the JAX server's. bfloat16
compute is held to 5 % of the largest logit, as there.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_cache as jax_build_cache
from repro.models import build_lm as jax_build_lm
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_forward as jax_lm_forward
from repro.models import lm_prefill as jax_lm_prefill
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import optimizer_config_from_model as jax_opt_config
from repro.serve import BatchedServer as JaxBatchedServer
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.interop import (lm_cache_to_numpy, lm_params_from_numpy, lm_tree_from_numpy,
                                 optimizer_state_from_numpy)
from repro_torch.models import (build_cache, build_lm, lm_decode, lm_forward, lm_params,
                                lm_prefill)
from repro_torch.optim import optimizer_config_from_model
from repro_torch.serve import BatchedServer
from repro_torch.train import make_train_step
from repro_torch.tree import tree_flatten, tree_map

DENSE = ["qwen1.5-0.5b", "starcoder2-3b", "nemotron-4-15b", "glm4-9b"]
TOL = 2e-4
BF16_REL = 5e-2
B, S = 2, 64


def _cfgs(arch, compute_dtype="float32"):
    return (dataclasses.replace(jax_smoke_config(arch), compute_dtype=compute_dtype),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=compute_dtype))


def _with_bias(params, seed=5):
    """The JAX params with every q/k/v bias leaf drawn from a numpy seed."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        if isinstance(tree, dict):
            return {n: (jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
                        if n in ("bq", "bk", "bv") else visit(a)) for n, a in tree.items()}
        if isinstance(tree, list):
            return [visit(a) for a in tree]
        return tree

    return visit(params)


@functools.cache
def _jax_params(arch):
    """(JAX params, numpy tree) of one smoke config, biases non-zero."""
    params, _ = jax_build_lm(jax_smoke_config(arch), jax.random.PRNGKey(0))
    params = _with_bias(params)
    return params, jax.tree.map(np.asarray, params)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def test_dense_configs_are_registered_and_the_jax_packages():
    assert set(DENSE) <= set(ARCH_IDS)
    for arch in DENSE:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(jax_smoke_config(arch)))
        assert get_config(arch).block_pattern == ("attn",)
    assert get_config("qwen1.5-0.5b").qkv_bias and get_config("starcoder2-3b").window == 4096


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_jax_float32(arch):
    params, tree = _jax_params(arch)
    jcfg, tcfg = _cfgs(arch)
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    assert ("head" in dict(model.named_parameters())) == (not tcfg.tied_embeddings)
    toks = _tokens(tcfg, (B, S))

    want, _ = jax_lm_forward(jcfg, params, jnp.asarray(toks))
    got, aux = lm_forward(tcfg, model, torch.from_numpy(toks))
    assert got.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)

    jc, _ = jax_build_cache(jcfg, B, S + 16)
    last_j, jc = jax_lm_prefill(jcfg, params, jnp.asarray(toks), jc)
    last_t, tc = lm_prefill(tcfg, model, torch.from_numpy(toks),
                            build_cache(tcfg, B, S + 16, device="cpu"))
    np.testing.assert_allclose(_np(last_t), _np(last_j), rtol=TOL, atol=TOL)
    got_cache, want_cache = lm_cache_to_numpy(tcfg, tc), jax.tree.map(np.asarray, jc)
    assert jax.tree.structure(got_cache) == jax.tree.structure(want_cache)
    for g, w in zip(jax.tree.leaves(got_cache), jax.tree.leaves(want_cache)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=TOL, atol=TOL)

    steps = _tokens(tcfg, (8, B), seed=2)
    for i, tok in enumerate(steps):
        lj, jc = jax_lm_decode(jcfg, params, jnp.asarray(tok), jc, jnp.int32(S + i))
        lt, tc = lm_decode(tcfg, model, torch.from_numpy(tok), tc, S + i)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=TOL, atol=TOL,
                                   err_msg=f"{arch} decode step {i}")


@pytest.mark.parametrize("arch", DENSE)
def test_bfloat16_compute_matches_jax_within_bf16_bound(arch):
    params, tree = _jax_params(arch)
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    toks = _tokens(tcfg, (B, S), seed=3)
    want, _ = jax_lm_forward(jcfg, params, jnp.asarray(toks))
    got, _ = lm_forward(tcfg, model, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    want = _np(want)
    assert np.abs(_np(got) - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_teacher_forcing(arch):
    """Prefill the first half, decode the rest token by token, and
    reproduce one teacher-forced forward pass (starcoder2's 8-token smoke
    window wraps its ring cache)."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = build_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (B, 32), seed=7))
    full, _ = lm_forward(cfg, model, toks)
    last, cache = lm_prefill(cfg, model, toks[:, :16], build_cache(cfg, B, 32, device="cpu"))
    torch.testing.assert_close(last, full[:, 15], rtol=TOL, atol=TOL)
    for t in range(16, 32):
        step, cache = lm_decode(cfg, model, toks[:, t], cache, t)
        torch.testing.assert_close(step, full[:, t], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_jax_per_leaf(arch):
    """Every leaf drawn with the JAX init's std and constants (a smoke
    config widened to d_model 256, so each random leaf has at least 16384
    values and a 5 % bound on the std ratio is far outside sampling noise)."""
    wide = dict(d_model=256, d_ff=512, vocab_size=512, head_dim=0)
    jcfg = dataclasses.replace(jax_smoke_config(arch), **wide)
    cfg = dataclasses.replace(get_smoke_config(arch), **wide)
    params, _ = jax_build_lm(jcfg, jax.random.PRNGKey(0))
    theirs = dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                       device="cpu").named_parameters())
    mine = dict(build_lm(cfg, seed=0, device="cpu").named_parameters())
    assert theirs.keys() == mine.keys()
    checked = 0
    for name, ref in theirs.items():
        x = mine[name]
        assert x.shape == ref.shape and x.dtype == ref.dtype, name
        if ref.std() == 0:
            assert torch.equal(x, ref), name
        elif ref.numel() >= 16384:
            ratio = (x.std() / ref.std()).item()
            assert abs(ratio - 1) < 0.05, (name, ratio)
            checked += 1
    assert checked >= 5


def _batch(vocab, seq, seed):
    t = np.random.default_rng(seed).integers(0, vocab, (4, seq + 1)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
    b["labels"][0, :3] = -100  # padded positions
    return b


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_jax(arch):
    """The second step of the JAX ``make_train_step`` (one-step warmup, so
    it moves every parameter at the full learning rate) from the same
    state in both packages: loss, grad norm, parameters and moments within
    2e-4."""
    jcfg, cfg = _cfgs(arch)
    params, _ = _jax_params(arch)
    ocfg = dataclasses.replace(jax_opt_config(jcfg), warmup_steps=1)
    init, _ = jax_make_optimizer(ocfg)
    step = jax.jit(jax_make_train_step(jcfg, ocfg))
    p1, o1, _ = step(params, init(params), _batch(jcfg.vocab_size, 16, 0))
    p2, o2, m2 = step(p1, o1, _batch(jcfg.vocab_size, 16, 1))
    host = functools.partial(jax.tree.map, np.asarray)
    tparams = tree_map(lambda t: t.detach().clone(),
                       lm_params(lm_params_from_numpy(cfg, host(p1), device="cpu")))
    state = optimizer_state_from_numpy(host(o1), device="cpu", cfg=cfg)
    tstep = make_train_step(cfg, dataclasses.replace(optimizer_config_from_model(cfg),
                                                     warmup_steps=1))
    tparams, state, m = tstep(tparams, state, _batch(cfg.vocab_size, 16, 1))
    assert abs(float(m["loss"]) - float(m2["loss"])) <= TOL
    assert abs(float(m["grad_norm"]) - float(m2["grad_norm"])) <= TOL * max(
        1.0, float(m2["grad_norm"]))
    assert int(state.step) == 2
    for jax_tree, port_tree in ((p2, tparams), (o2.mu, state.mu), (o2.nu, state.nu)):
        want = tree_flatten(lm_tree_from_numpy(cfg, host(jax_tree)))[0]
        got = tree_flatten(port_tree)[0]
        assert len(want) == len(got)
        assert max(float(np.abs(w - g.detach().numpy()).max()) for w, g in zip(want, got)) <= TOL


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "starcoder2-3b"])
def test_greedy_tokens_match_the_jax_server(arch):
    """Prompts shorter and longer than starcoder2's 8-token smoke window,
    more requests than lanes: the same greedy tokens as the JAX server."""
    params, tree = _jax_params(arch)
    jcfg, cfg = _cfgs(arch)
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (16, 5, 40, 12, 7)]

    def serve(server):
        rids = [server.submit(p, 6) for p in prompts]
        done = {r.rid: r for r in server.run_until_idle()}
        return [done[rid].out_tokens for rid in rids]

    want = serve(JaxBatchedServer(jcfg, params, lanes=2, max_len=64))
    got = serve(BatchedServer(cfg, model, lanes=2, max_len=64))
    assert got == want and all(len(t) == 6 for t in got)
