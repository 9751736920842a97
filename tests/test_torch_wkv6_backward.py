"""K7's backward in the port against autograd and ``jax.grad`` on the CPU.

* ``wkv6_backward_plain`` (the plain version of ``wkv6_bwd_cuda``, the
  three passes of its kernel in tensor code) against autograd through
  ``wkv6_plain`` and through the port's ``wkv6_chunked_ref``, and against
  ``jax.grad`` of the JAX package's ``wkv6_chunked_ref`` (the function the
  JAX model differentiates), at shapes (2, 128, 3, 16) and (1, 64, 2, 64),
  chunks 16 and 64, a non-zero initial state and a non-zero cotangent on
  the final state: every gradient within ``GRAD_TOL`` of the largest
  entry of its reference (float32, other summation orders).
* The ``WKV6`` autograd Function on the CPU: its gradients are the plain
  backward's, bit for bit.
* An RWKV-6 smoke-config train step (two 64-step chunks, so the state
  crosses a chunk boundary) against the JAX ``make_train_step`` within
  2e-4, its time mix differentiated through ``WKV6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import GRAD_TOL
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.wkv6.ref import wkv6_chunked_ref as jax_wkv6_chunked_ref
from repro.models import build_lm as jax_build_lm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import optimizer_config_from_model as jax_opt_config
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_params_from_numpy, lm_tree_from_numpy
from repro_torch.interop import optimizer_state_from_numpy
from repro_torch.kernels.wkv6 import (WKV6, wkv6, wkv6_backward_plain, wkv6_bwd_cuda,
                                      wkv6_chunked_ref, wkv6_plain)
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models import lm_params
from repro_torch.optim import optimizer_config_from_model
from repro_torch.train import make_train_step
from repro_torch.tree import tree_flatten, tree_map

CASES = [((2, 128, 3, 16), 16), ((2, 128, 3, 16), 64), ((1, 64, 2, 64), 16),
         ((1, 64, 2, 64), 64)]
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")
TOL = 2e-4


def _inputs(shape, seed):
    """r, k, v, w, u, state0, dy, ds_t as float32 numpy: w in [0.6, 1), the
    state and both cotangents non-zero."""
    b, t, h, n = shape
    rng = np.random.default_rng(seed)

    def randn(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    w = (0.6 + 0.399 * rng.random(shape)).astype(np.float32)
    return (randn(*shape, scale=0.5), randn(*shape, scale=0.5), randn(*shape), w,
            randn(h, n, scale=0.3), randn(b, h, n, n, scale=0.1), randn(*shape),
            randn(b, h, n, n))


def _autograd(fn, arrays, chunk):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
    dy, ds = (torch.from_numpy(a) for a in arrays[6:])
    y, s = fn(*xs, chunk=chunk)
    return torch.autograd.grad((y * dy).sum() + (s * ds).sum(), xs)


def _jax_grad(arrays, chunk):
    def loss(r, k, v, w, u, s0, dy, ds):
        y, s = jax_wkv6_chunked_ref(r, k, v, w, u, s0, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    return [torch.from_numpy(np.array(g)) for g in
            jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*arrays)]


def _assert_rel(got, want, label):
    for name, x, y in zip(NAMES, got, want):
        assert x.shape == y.shape, (label, name)
        scale = float(y.abs().max())
        err = float((x - y).abs().max())
        assert err <= GRAD_TOL * scale, f"{label} {name}: {err} > {GRAD_TOL} * {scale}"


@pytest.mark.parametrize("against", ["wkv6_plain", "wkv6_chunked_ref", "jax"])
@pytest.mark.parametrize("shape,chunk", CASES)
def test_plain_backward_matches_autograd_and_jax(shape, chunk, against):
    arrays = _inputs(shape, seed=sum(shape) + chunk)
    got = wkv6_backward_plain(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    if against == "jax":
        want = _jax_grad(arrays, chunk)
    else:
        want = _autograd({"wkv6_plain": wkv6_plain, "wkv6_chunked_ref": wkv6_chunked_ref}[against],
                         arrays, chunk)
    _assert_rel(got, want, f"{shape} chunk {chunk} vs {against}")


def test_plain_backward_defaults_and_clamps():
    """``ds_t=None`` is a zero cotangent; a chunk past T is clamped to T; a
    chunk that does not divide T raises. The wrapper gives a CPU tensor the
    plain version."""
    arrays = [torch.from_numpy(a) for a in _inputs((1, 32, 2, 8), seed=3)]
    zero = wkv6_backward_plain(*arrays[:7], torch.zeros_like(arrays[7]), chunk=16)
    for x, y in zip(wkv6_backward_plain(*arrays[:7], None, chunk=16), zero):
        assert torch.equal(x, y)
    for x, y in zip(wkv6_backward_plain(*arrays, chunk=64), wkv6_backward_plain(*arrays, chunk=32)):
        assert torch.equal(x, y)
    for x, y in zip(wkv6_bwd_cuda(*arrays, chunk=16), wkv6_backward_plain(*arrays, chunk=16)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv6_backward_plain(*arrays, chunk=12)


@pytest.mark.parametrize("state_grad", [False, True])
def test_wkv6_function_on_the_cpu(state_grad):
    """``wkv6`` runs through ``WKV6`` when an input requires grad: its
    gradients are the plain backward's bit for bit (the final state's
    cotangent zero when the loss does not read it), and within GRAD_TOL of
    autograd through the plain forward. Without gradients it returns plain
    tensors."""
    arrays = _inputs((2, 64, 2, 16), seed=11)
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
    dy, ds = (torch.from_numpy(a) for a in arrays[6:])
    if not state_grad:
        ds = torch.zeros_like(ds)
    y, s = wkv6(*xs, chunk=16)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "WKV6Backward"
    loss = (y * dy).sum() + ((s * ds).sum() if state_grad else 0.0)
    got = torch.autograd.grad(loss, xs)
    direct = wkv6_backward_plain(*(x.detach() for x in xs), dy, ds, chunk=16)
    for x, z in zip(got, direct):
        assert torch.equal(x, z)
    want = _autograd(wkv6_plain, [*arrays[:6], arrays[6], ds.numpy()], 16)
    _assert_rel(got, want, "WKV6")
    with torch.no_grad():
        y2, _ = wkv6(*xs, chunk=16)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())
    y3, _ = WKV6.apply(*xs, 16)
    assert torch.equal(y3, y)


def _batch(vocab, seq, seed):
    t = np.random.default_rng(seed).integers(0, vocab, (2, seq + 1)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
    b["labels"][0, :3] = -100  # padded positions
    return b


def test_rwkv6_train_step_through_wkv6_matches_jax(monkeypatch):
    """One RWKV-6 smoke-config step (the second, from the JAX package's
    state after one step with a one-step warmup, so it moves at the full
    learning rate) at 128 tokens, two 64-step chunks: loss, grad norm,
    parameters and moments within 2e-4 of the JAX step; the time mix of
    each of the two layers goes through ``WKV6``'s backward once."""
    arch = "rwkv6-3b"
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    seq = 2 * cfg.rwkv_chunk
    params, _ = jax_build_lm(jcfg, jax.random.PRNGKey(0))
    ocfg = dataclasses.replace(jax_opt_config(jcfg), warmup_steps=1)
    init, _ = jax_make_optimizer(ocfg)
    step = jax.jit(jax_make_train_step(jcfg, ocfg))
    p1, o1, _ = step(params, init(params), _batch(jcfg.vocab_size, seq, 0))
    p2, o2, m2 = step(p1, o1, _batch(jcfg.vocab_size, seq, 1))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731

    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return wkv6_bwd_cuda(*args, **kw)

    monkeypatch.setattr(wkv6_ops, "wkv6_bwd_cuda", counted)
    tparams = tree_map(lambda t: t.detach().clone(),
                       lm_params(lm_params_from_numpy(cfg, host(p1), device="cpu")))
    state = optimizer_state_from_numpy(host(o1), device="cpu", cfg=cfg)
    tstep = make_train_step(cfg, dataclasses.replace(optimizer_config_from_model(cfg),
                                                     warmup_steps=1))
    tparams, state, m = tstep(tparams, state, _batch(cfg.vocab_size, seq, 1))
    assert calls == [(2, seq, cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size)] * 2
    assert abs(float(m["loss"]) - float(m2["loss"])) <= TOL
    assert abs(float(m["grad_norm"]) - float(m2["grad_norm"])) <= TOL * max(
        1.0, float(m2["grad_norm"]))
    for jax_tree, port_tree in ((p2, tparams), (o2.mu, state.mu), (o2.nu, state.nu)):
        want = tree_flatten(lm_tree_from_numpy(cfg, host(jax_tree)))[0]
        got = tree_flatten(port_tree)[0]
        assert len(want) == len(got)
        assert max(float(np.abs(w - g.detach().numpy()).max()) for w, g in zip(want, got)) <= TOL
