"""The LM trainer's in-place optimizer (``update_in_place``,
``clip_in_place``) against the tree updates and the JAX package's, on
the CPU, with ``SLICE_ELEMENTS`` lowered so that small leaves go slice by
slice as an arctic expert stack does at full width.

* A sliced AdamW update equals the whole-leaf one bit for bit (it is
  elementwise), float32 and bfloat16 moments, every slicing of a leaf.
* A sliced Adafactor update — factored and not, stacked (the JAX layout's
  scanned leaves, held as per-layer tensors) and not, a stacked leaf of
  vectors whose column statistics run across the layers — is within 1e-6
  relative of the whole-leaf one and of the JAX ``adafactor_update``;
  under the budget it is the whole-leaf update's bits.
* The in-place clip writes the bits of ``clip_by_global_norm`` given the
  same norm; the sliced norm is within 1e-6 relative of the whole one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as opt

REL = 1e-6
# (per-layer shape, layers or 0 for an unstacked leaf)
LEAVES = {
    "stacked3d": ((6, 8, 5), 3),
    "stacked2d": ((12, 7), 2),
    "stacked1d": ((40,), 4),
    "flat2d": ((40, 7), 0),
    "flat3d": ((5, 6, 4), 0),
}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _case(key, seed=0):
    shape, layers = LEAVES[key]
    n = max(layers, 1)
    p = [_rand(shape, seed + i) for i in range(n)]
    g = [_rand(shape, seed + 10 + i, 0.3) for i in range(n)]
    return p, g, layers


def _group(arrs, dtype=torch.float32):
    return [torch.from_numpy(a.copy()).to(dtype) for a in arrs]


def _whole(ts, layers):
    return torch.stack(ts) if layers else ts[0]


@pytest.fixture
def sliced(monkeypatch):
    monkeypatch.setattr(opt, "SLICE_ELEMENTS", 20)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["flat2d", "flat3d", "stacked3d"])
def test_sliced_adamw_is_the_whole_leaf_update_bit_for_bit(sliced, key, mdt):
    cfg = opt.OptimizerConfig(moment_dtype=mdt, warmup_steps=1)
    p, g, _ = _case(key)
    p, g = _group(p[:1]), _group(g[:1])
    state = opt.adamw_init(cfg, p[0])
    state = opt.AdamWState(state.step + 2, state.mu + 0.01, state.nu + 0.02)
    want_p, want_s = opt.adamw_update(cfg, g[0], state, p[0])
    one = opt.AdamWState(state.step, state.mu.clone(), state.nu.clone())
    out = opt.update_in_place(cfg, one, [(p, False)], [(g, False)])
    assert len(opt._slices(p, False)) > 1
    assert torch.equal(p[0], want_p)
    assert torch.equal(one.mu, want_s.mu) and torch.equal(one.nu, want_s.nu)
    assert int(out.step) == int(want_s.step)


def _adafactor_state(cfg, p_whole, seed):
    """A state after some steps: positive moments."""
    s = opt.adafactor_init(cfg, p_whole)
    vr = torch.from_numpy(np.abs(_rand(tuple(s.vr.shape), seed)) + 0.1).to(s.vr.dtype)
    vc = torch.from_numpy(np.abs(_rand(tuple(s.vc.shape), seed + 1)) + 0.1).to(s.vc.dtype)
    return opt.AdafactorState(s.step + 3, vr, vc)


@pytest.mark.parametrize("factored", [True, False])
@pytest.mark.parametrize("key", list(LEAVES))
def test_sliced_adafactor_matches_whole_leaf_and_jax(sliced, key, factored):
    cfg = opt.OptimizerConfig(name="adafactor", warmup_steps=1,
                              factored_threshold=16 if factored else 10**9)
    p, g, layers = _case(key, seed=3)
    pw = _whole(_group(p), layers)
    assert opt._factored(pw, cfg.factored_threshold) == (factored and pw.ndim >= 2)
    state = _adafactor_state(cfg, pw, 5)
    want_p, want_s = opt.adafactor_update(cfg, _whole(_group(g), layers), state, pw)
    jcfg = jopt.OptimizerConfig(name="adafactor", warmup_steps=1,
                                factored_threshold=cfg.factored_threshold)
    jstate = jopt.AdafactorState(jnp.asarray(int(state.step), jnp.int32),
                                 jnp.asarray(state.vr.numpy()), jnp.asarray(state.vc.numpy()))
    jp, js = jopt.adafactor_update(jcfg, jnp.asarray(_whole(_group(g), layers).numpy()),
                                   jstate, jnp.asarray(pw.numpy()))

    ps, gs = _group(p), _group(g)
    mine = opt.AdafactorState(state.step, state.vr.clone(), state.vc.clone())
    opt.update_in_place(cfg, mine, [(ps, bool(layers))], [(gs, bool(layers))])
    assert len(opt._slices(ps, bool(layers))) > 1
    got = _whole(ps, layers)
    for a, b in ((got, want_p), (mine.vr, want_s.vr), (mine.vc, want_s.vc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=REL, atol=0)
    for a, b in ((got, jp), (mine.vr, js.vr), (mine.vc, js.vc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL, atol=0)


@pytest.mark.parametrize("key", ["stacked3d", "stacked1d", "flat2d"])
def test_adafactor_under_the_budget_keeps_the_whole_leaf_bits(key):
    cfg = opt.OptimizerConfig(name="adafactor", warmup_steps=1, factored_threshold=16)
    p, g, layers = _case(key, seed=4)
    pw = _whole(_group(p), layers)
    state = _adafactor_state(cfg, pw, 6)
    want_p, want_s = opt.adafactor_update(cfg, _whole(_group(g), layers), state, pw)
    ps = _group(p)
    mine = opt.AdafactorState(state.step, state.vr.clone(), state.vc.clone())
    opt.update_in_place(cfg, mine, [(ps, bool(layers))], [(_group(g), bool(layers))])
    assert torch.equal(_whole(ps, layers), want_p)
    assert torch.equal(mine.vr, want_s.vr) and torch.equal(mine.vc, want_s.vc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_in_place_clip_equals_the_tree_clip(dtype, max_norm):
    grads = [torch.from_numpy(_rand(s, i, 2.0)).to(dtype)
             for i, s in enumerate([(40, 7), (5, 6, 4), (9,)])]
    want, want_norm = opt.clip_by_global_norm([g.clone() for g in grads], max_norm)
    got = [g.clone() for g in grads]
    norm = opt.clip_in_place(got, max_norm)
    assert torch.equal(norm, want_norm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_clip_given_its_norm_writes_the_tree_clip_bits(sliced, dtype):
    grads = [torch.from_numpy(_rand(s, i, 2.0)).to(dtype)
             for i, s in enumerate([(40, 7), (5, 6, 4), (9,)])]
    _, whole_norm = opt.clip_by_global_norm([g.clone() for g in grads], 1.0)
    got = [g.clone() for g in grads]
    norm = opt.clip_in_place(got, 1.0)
    np.testing.assert_allclose(float(norm), float(whole_norm), rtol=REL)
    scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
    for a, g in zip(got, grads):
        assert torch.equal(a, (g.to(torch.float32) * scale).to(dtype))


def test_a_leaf_past_the_budget_is_cut_on_its_leading_dim(sliced):
    t = torch.zeros((7, 3, 4))
    parts = opt._slices([t], False)
    assert [ix for ix, _ in parts] == [(slice(a, min(a + 1, 7)),) for a in range(7)]
    assert all(v.data_ptr() == t[ix].data_ptr() for ix, v in parts)
    stacked = opt._slices([t, t.clone()], True)
    assert len(stacked) == 14 and stacked[0][1].shape == (1, 1, 3, 4)
    vec = opt._slices([torch.zeros(64)], False)
    assert len(vec) == 1  # a vector is never cut: its last dim is the row
