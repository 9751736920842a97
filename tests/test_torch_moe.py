"""The port's local MoE layer against the JAX package's on the CPU.

Both smoke configs (qwen3-moe: 8 experts top-2; arctic: the same with its
dense residual FFN), the JAX ``init_moe`` weights carried across as numpy,
inputs from a numpy seed. At ``compute_dtype="float32"`` and the default
``capacity_factor`` 1.25 (tokens dropped) and 64 (dropless): the output
within 2e-4 and ``aux`` within 1e-5 relative of ``_apply_moe_local``; the
router's expert ids (``torch.topk`` against ``lax.top_k``; random float32
inputs leave no ties) and the kept-slot maps (``_dispatch_local``'s
slot -> token, for all experts and for one rank's slice) exactly, the
slot -> gate maps within 1e-6. bfloat16 within 5 % of max|y|. Batches of
fewer than 4 tokens (capacity clamped to the token count) and
``capacity == t``. The
gradient of a scalar of ``(y, aux)`` with respect to ``x`` and every MoE
weight against ``jax.grad`` within 2e-4 (float32 parameters, so neither
side rounds a gradient to bfloat16).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_lm
from repro_torch.models import layers as L
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
TOL = 2e-4
AUX_REL = 1e-5
BF16_REL = 5e-2


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@functools.cache
def _params(arch, param_dtype=None):
    jcfg, _ = _cfgs(arch, **({"param_dtype": param_dtype} if param_dtype else {}))
    p, _ = JL.init_moe(jcfg, jax.random.PRNGKey(3))
    return p


def _torch(p, cfg):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, cfg.param_dtype)), jax.tree.map(np.asarray, p))


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(np.float32)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


def _jax_route(jcfg, p, x):
    """The JAX layer's routing, line for line (``_apply_moe_local`` keeps it
    inside): the float32 router, softmax, ``lax.top_k``, gate normalisation."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"].astype(jnp.float32), axis=-1)
    gate, idx = jax.lax.top_k(probs, jcfg.top_k)
    return xt, probs, gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9), idx


def test_moe_configs_are_the_jax_packages():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCH_IDS, get_config

    for arch in ARCHS:
        assert arch in ARCH_IDS
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(jax_smoke_config(arch)))
    assert get_config("arctic-480b").optimizer == "adafactor"
    assert get_config("arctic-480b").pad_heads_to == 64


@pytest.mark.parametrize("capacity_factor", [1.25, 64.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_local_moe_matches_jax_float32(arch, capacity_factor):
    jcfg, cfg = _cfgs(arch, compute_dtype="float32", capacity_factor=capacity_factor)
    p = _params(arch)
    x = _x(cfg, (4, 8))
    y_j, aux_j = JL._apply_moe_local(jcfg, p, jnp.asarray(x))
    y, aux = L._apply_moe_local(cfg, _torch(p, cfg), torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (4, 8, cfg.d_model)
    np.testing.assert_allclose(_np(y), _np(y_j), rtol=TOL, atol=TOL)
    assert abs(float(aux) - float(aux_j)) <= AUX_REL * abs(float(aux_j))


@pytest.mark.parametrize("capacity_factor", [1.25, 64.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_kept_slots_are_exactly_the_jax_layers(arch, capacity_factor):
    """Expert ids exactly (the gates within 1e-6); the slot -> token maps of
    the whole dispatch and of one quarter of the experts (the
    expert-parallel path's slice) exactly, their gates within 1e-6."""
    jcfg, cfg = _cfgs(arch, compute_dtype="float32", capacity_factor=capacity_factor)
    p = _params(arch)
    x = _x(cfg, (4, 8), seed=2)
    xt_j, _, gate_j, idx_j = _jax_route(jcfg, p, x)
    tp = _torch(p, cfg)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, gate, idx = L._route(cfg, tp["router"], xt)
    differ = np.argwhere(idx.numpy() != np.asarray(idx_j))
    assert differ.size == 0, f"top-k expert ids differ at (token, k) {differ.tolist()}"
    np.testing.assert_allclose(gate.numpy(), np.asarray(gate_j), rtol=1e-6, atol=1e-6)
    t, e = xt.shape[0], cfg.n_experts
    capacity = L._capacity(cfg, t)
    kept = 0
    for lo, hi in ((0, e), (e // 4, e // 2)):
        _, tok_j, g_j = JL._dispatch_local(xt_j, gate_j, idx_j, lo, hi, capacity, hi - lo,
                                          jnp.float32)
        _, tok, g = L._dispatch_local(xt, gate, idx, lo, hi, capacity, hi - lo, torch.float32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-6)
        kept += int((tok < t).sum())
    assert kept > 0
    if capacity_factor == 1.25:  # 64 assignments into 8 x 10 slots: some are dropped
        assert int((L._dispatch_local(xt, gate, idx, 0, e, capacity, e,
                                      torch.float32)[1] < t).sum()) < t * cfg.top_k


@pytest.mark.parametrize("arch", ARCHS)
def test_local_moe_bfloat16_within_bound(arch):
    jcfg, cfg = _cfgs(arch)  # bfloat16 compute, as published
    p = _params(arch)
    x = _x(cfg, (4, 8), seed=3)
    y_j, _ = JL._apply_moe_local(jcfg, p, jnp.asarray(x))
    y, _ = L._apply_moe_local(cfg, _torch(p, cfg), torch.from_numpy(x))
    assert y.dtype == torch.bfloat16
    want = _np(y_j)
    assert np.abs(_np(y) - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (3, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_fewer_than_four_tokens(arch, shape):
    """t < 4: the capacity's floor of 4 is clamped to t (every expert can
    take every token, nothing drops)."""
    jcfg, cfg = _cfgs(arch, compute_dtype="float32")
    t = shape[0] * shape[1]
    assert L._capacity(cfg, t) == t
    p = _params(arch)
    x = _x(cfg, shape, seed=4)
    y_j, aux_j = JL._apply_moe_local(jcfg, p, jnp.asarray(x))
    y, aux = L._apply_moe_local(cfg, _torch(p, cfg), torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(y_j), rtol=TOL, atol=TOL)
    assert abs(float(aux) - float(aux_j)) <= AUX_REL * abs(float(aux_j))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equal_to_the_token_count(arch):
    """A capacity factor that asks for exactly t slots an expert (E / k):
    ``capacity == t``, no clamp needed, nothing drops."""
    jcfg, cfg = _cfgs(arch, compute_dtype="float32", capacity_factor=4.0)
    assert L._capacity(cfg, 16) == 16
    p = _params(arch)
    x = _x(cfg, (2, 8), seed=5)
    y_j, _ = JL._apply_moe_local(jcfg, p, jnp.asarray(x))
    y, _ = L._apply_moe_local(cfg, _torch(p, cfg), torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(y_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    """d/d(x, every weight) of ``sum(y * w) + 0.37 * aux`` at the default
    capacity factor (tokens dropped), float32 parameters and compute."""
    jcfg, cfg = _cfgs(arch, compute_dtype="float32", param_dtype="float32")
    p = _params(arch, "float32")
    x = _x(cfg, (4, 8), seed=6)
    wgt = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JL._apply_moe_local(jcfg, p, x)
        return jnp.sum(y * wgt) + 0.37 * aux

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves, treedef = tree_flatten(_torch(p, cfg))
    work = [t.requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = L._apply_moe_local(cfg, tree_unflatten(treedef, work), xt)
    loss = (y * torch.from_numpy(wgt)).sum() + 0.37 * aux
    grads = torch.autograd.grad(loss, [xt] + work)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j), rtol=TOL, atol=TOL)
    want = tree_flatten(jax.tree.map(np.asarray, gp_j))[0]
    assert len(want) == len(grads) - 1
    for g, w in zip(grads[1:], want):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_init_moe_shapes_axes_and_std():
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"), d_model=128, d_ff=256,
                              param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = L.init_moe(cfg, L.Init(gen, torch.float32, "cpu"))
    shapes = L.moe_shapes(cfg)
    assert tree_map(lambda t: tuple(t.shape), p) == shapes
    assert tree_flatten(shapes)[1] == tree_flatten(
        {k: v for k, v in L.MOE_AXES.items()})[1]
    e, d = cfg.n_experts, cfg.d_model
    # Fan-in over every axis but the last, as PBuilder: E * D for the experts.
    for name, std in (("router", 0.1 / d**0.5), ("w1", (e * d) ** -0.5),
                      ("w2", (e * cfg.d_ff) ** -0.5)):
        assert abs(p[name].std().item() / std - 1) < 0.05, name


def test_fan_in_scales_in_place_with_the_out_of_place_bits(monkeypatch):
    """``Init.fan_in`` scales its float32 draw in place; the weights of an
    existing arch's smoke build are bit-equal to the out-of-place form's."""
    import math

    mine = build_lm(get_smoke_config("recurrentgemma-2b"), seed=3, device="cpu")

    def out_of_place(self, shape, *, scale=1.0, fan_axes=None):
        fan = math.prod(shape[i] for i in (fan_axes if fan_axes is not None
                                           else range(len(shape) - 1)))
        std = scale / math.sqrt(max(fan, 1))
        x = torch.randn(tuple(shape), generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (x * std).to(self.dtype)

    monkeypatch.setattr(L.Init, "fan_in", out_of_place)
    theirs = build_lm(get_smoke_config("recurrentgemma-2b"), seed=3, device="cpu")
    a, b = dict(mine.named_parameters()), dict(theirs.named_parameters())
    assert a.keys() == b.keys()
    assert all(torch.equal(a[n], b[n]) for n in a)
