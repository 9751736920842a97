"""The port's recurrent LMs against the JAX package on the CPU.

Both smoke configs (RWKV-6 and RecurrentGemma) with the JAX ``build_lm``
weights carried across by ``lm_params_from_numpy``; tokens from a numpy
seed. At ``compute_dtype="float32"`` forward logits, prefill logits, every
cache leaf and eight decode steps agree within 2e-4, the bound of
``tests/test_rwkv_chunked_model.py`` (the chunked and sequential WKV forms,
and the sequential and associative RG-LRU scans, sum in other orders). The
published bfloat16 compute dtype is held to 5 % of the largest logit:
bfloat16 keeps 8 bits of mantissa, and the two frameworks round at other
places (XLA's fused CPU code against PyTorch's per-op casts), which the
layers compound.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_cache as jax_build_cache
from repro.models import build_lm as jax_build_lm
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_forward as jax_lm_forward
from repro.models import lm_prefill as jax_lm_prefill
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.interop import lm_cache_to_numpy, lm_params_from_numpy
from repro_torch.models import build_cache, build_lm, lm_decode, lm_forward, lm_prefill
from repro_torch.models.layers import FLASH_THRESHOLD

ARCHS = ["rwkv6-3b", "recurrentgemma-2b"]
TOL = 2e-4
BF16_REL = 5e-2
B, S = 2, 64  # S a multiple of rwkv_chunk (64): the chunked WKV path, K7's plain version


def _cfgs(arch, compute_dtype):
    return (dataclasses.replace(jax_smoke_config(arch), compute_dtype=compute_dtype),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=compute_dtype))


@functools.cache
def _jax_params(arch):
    """(JAX params, numpy param tree) of one smoke config, built once."""
    params, _ = jax_build_lm(jax_smoke_config(arch), jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def test_registry_has_the_two_recurrent_archs_and_names_the_rest():
    """The two recurrent archs, the four dense ones and the two MoE ones are
    registered; an arch of the JAX registry that is not ported yet names
    its ROADMAP item."""
    assert set(ARCH_IDS) == set(ARCHS) | {"qwen1.5-0.5b", "starcoder2-3b", "nemotron-4-15b",
                                          "glm4-9b", "qwen3-moe-235b-a22b", "arctic-480b"}
    assert get_config("rwkv6-3b").rwkv_chunk == 64
    assert get_config("recurrentgemma-2b").block_pattern == ("rglru", "rglru", "local_attn")
    with pytest.raises(KeyError, match=r"not ported.*M13b\.4"):
        get_config("llama-3.2-vision-90b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("nope")


def test_configs_are_the_jax_packages():
    from repro.configs import get_config as jax_config

    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(jax_smoke_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax_float32(arch):
    params, tree = _jax_params(arch)
    jcfg, tcfg = _cfgs(arch, "float32")
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
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


@pytest.mark.parametrize("arch", ARCHS)
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

    jc, _ = jax_build_cache(jcfg, B, S + 4)
    last_j, jc = jax_lm_prefill(jcfg, params, jnp.asarray(toks), jc)
    last_t, tc = lm_prefill(tcfg, model, torch.from_numpy(toks),
                            build_cache(tcfg, B, S + 4, device="cpu"))
    for g, w in [(last_t, last_j)] + list(zip(jax.tree.leaves(lm_cache_to_numpy(tcfg, tc)),
                                              jax.tree.leaves(jc))):
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= BF16_REL * max(np.abs(w).max(), 1.0)


def test_rwkv_chunked_and_sequential_paths_agree():
    arch = "rwkv6-3b"
    _, tree = _jax_params(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (B, 32), seed=4))
    seq, _ = lm_forward(dataclasses.replace(cfg, rwkv_chunk=0), model, toks)
    for chunk in (8, 32):
        chunked, _ = lm_forward(dataclasses.replace(cfg, rwkv_chunk=chunk), model, toks)
        np.testing.assert_allclose(_np(chunked), _np(seq), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """The port's own check of ``tests/test_models_smoke.py``: prefill the
    first half, decode the rest token by token, and reproduce one
    teacher-forced forward pass."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = build_lm(cfg, seed=0, device="cpu")
    # RWKV-6: the prefill half is chunk-aligned, so it runs K7's plain version.
    n = 2 * (cfg.rwkv_chunk or 16)
    toks = torch.from_numpy(_tokens(cfg, (B, n), seed=7))
    full, _ = lm_forward(cfg, model, toks)
    p = n // 2
    last, cache = lm_prefill(cfg, model, toks[:, :p], build_cache(cfg, B, n, device="cpu"))
    torch.testing.assert_close(last, full[:, p - 1], rtol=TOL, atol=TOL)
    for t in range(p, n):
        step, cache = lm_decode(cfg, model, toks[:, t], cache, t)
        torch.testing.assert_close(step, full[:, t], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_per_leaf(arch):
    """The port's fan-in init draws every leaf with the JAX init's std and
    the same constants. A smoke config widened to d_model 256 gives each
    random leaf at least 16384 values, so a 5 % bound on the std ratio is
    far outside sampling noise (about 0.6 % per leaf)."""
    wide = dict(d_model=256, d_ff=512, rnn_width=256, vocab_size=512)
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
            assert abs(x.mean().item()) < 0.05 * ref.std().item(), name
            checked += 1
    assert checked >= 5


def test_published_configs_build_lazily_and_default_to_the_card():
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        build_lm(get_smoke_config("rwkv6-3b"), seed=0)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        build_cache(get_smoke_config("rwkv6-3b"), 1, 8)


def test_long_attention_prefill_is_not_ported_yet():
    """A prefill longer than ``FLASH_THRESHOLD`` (now ported): RecurrentGemma's
    local attention at FLASH_THRESHOLD + 512 tokens takes the blocked local
    path in both packages; last logits and every cache leaf within 2e-4."""
    arch = "recurrentgemma-2b"
    params, tree = _jax_params(arch)
    jcfg, tcfg = _cfgs(arch, "float32")
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    toks = _tokens(tcfg, (1, FLASH_THRESHOLD + 512), seed=5)
    jc, _ = jax_build_cache(jcfg, 1, toks.shape[1] + 8)
    last_j, jc = jax_lm_prefill(jcfg, params, jnp.asarray(toks), jc)
    last_t, tc = lm_prefill(tcfg, model, torch.from_numpy(toks),
                            build_cache(tcfg, 1, toks.shape[1] + 8, device="cpu"))
    np.testing.assert_allclose(_np(last_t), _np(last_j), rtol=TOL, atol=TOL)
    for g, w in zip(jax.tree.leaves(lm_cache_to_numpy(tcfg, tc)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(g, np.asarray(w).astype(g.dtype), rtol=TOL, atol=TOL)
