"""The port's media LMs against the JAX package on the CPU:
llama-3.2-vision (tanh-gated cross-attention over media tokens) and
hubert-xlarge (a bidirectional encoder over frame embeddings).

Both smoke configs, their JAX ``build_lm`` weights carried across by
``lm_params_from_numpy``; every cross-attention ``gate`` is set to 0.5 in
the numpy weights (at its zero init the cross layers add exactly nothing,
so a parity test there would prove nothing). ``memory`` (B, 8, 64) and the
frames (B, S, 64) come from a numpy seed. At ``compute_dtype="float32"``:
logits, the loss, prefill, every cache leaf and 8 decode steps within
2e-4 (``tests/test_torch_models.py``'s bound); each gradient leaf within
``GRAD_REL`` = 1e-5 of the largest |gradient| of its leaf plus 1e-6 (the
gate's included; hubert's unread ``embed`` exactly zero); one train step
(the second of JAX's ``make_train_step``, one-step warmup) within 2e-4,
hubert's decayed ``embed`` included. bfloat16 compute within 5 % of the
largest logit. Also: the memory-less prefill that REPLACES the media cache
with the prompt's keys and values (the JAX quirk the port copies), the
encoder's bidirectional check, its non-causal flash scan at 2560 frames
(the first multiple of ``FLASH_CHUNK`` past ``FLASH_THRESHOLD``),
``remat_policy="dots"`` against ``"full"`` and JAX's ``dots_saveable``,
and the launchers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_cache as jax_build_cache
from repro.models import build_lm as jax_build_lm
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_forward as jax_lm_forward
from repro.models import lm_loss as jax_lm_loss
from repro.models import lm_prefill as jax_lm_prefill
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import optimizer_config_from_model as jax_opt_config
from repro.serve import BatchedServer as JaxBatchedServer
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.interop import (lm_cache_to_numpy, lm_params_from_numpy, lm_tree_from_numpy,
                                 optimizer_state_from_numpy)
from repro_torch.models import (build_cache, build_lm, lm_decode, lm_forward, lm_loss, lm_params,
                                lm_prefill)
from repro_torch.models import layers as L
from repro_torch.optim import optimizer_config_from_model
from repro_torch.serve import BatchedServer
from repro_torch.train import make_train_step
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

VISION, AUDIO = "llama-3.2-vision-90b", "hubert-xlarge"
MEDIA = [VISION, AUDIO]
TOL = 2e-4
GRAD_REL = 1e-5
BF16_REL = 5e-2
GATE = 0.5
B, S = 2, 16
MM = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
      torch.ops.aten.baddbmm.default)


def _cfgs(arch, **over):
    over.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _gated(tree):
    """``tree`` with every cross-attention ``gate`` leaf set to GATE."""
    if isinstance(tree, dict):
        return {n: (jnp.full_like(a, GATE) if n == "gate" else _gated(a)) for n, a in tree.items()}
    if isinstance(tree, list):
        return [_gated(a) for a in tree]
    return tree


@functools.cache
def _jax_params(arch):
    """(JAX params, numpy tree) of one smoke config, the gates at GATE."""
    params, _ = jax_build_lm(jax_smoke_config(arch), jax.random.PRNGKey(0))
    params = _gated(params)
    return params, jax.tree.map(np.asarray, params)


def _inputs(cfg, b=B, s=S, seed=1):
    """``(tokens or frames, memory or None)`` as numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mem = None
    if cfg.frontend == "vision":
        mem = rng.standard_normal((b, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return x, mem


def _batch(cfg, seq, seed):
    x, mem = _inputs(cfg, 4, seq, seed)
    labels = np.random.default_rng(seed + 100).integers(0, cfg.vocab_size, (4, seq))
    batch = {"tokens": x, "labels": labels.astype(np.int32)}
    batch["labels"][0, :3] = -100  # padded positions
    if mem is not None:
        batch["memory"] = mem
    return batch


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _model(arch, cfg):
    return lm_params_from_numpy(cfg, _jax_params(arch)[1], device="cpu")


def test_registry_and_configs_are_the_jax_packages():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in MEDIA:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(jax_smoke_config(arch)))
    assert get_config(VISION).layer_kinds.count("cross_attn") == 20
    assert not get_config(AUDIO).supports_decode


def test_interop_round_trips_the_gate_and_the_media_cache():
    """``lm_params_from_numpy`` unstacks the gate, a ``(n_super,)`` JAX leaf,
    into one scalar a cross layer, and stacking the port's tree back gives
    the JAX tree bit for bit; ``lm_cache_to_numpy`` gives a cache of the
    JAX ``build_cache``'s layout, the cross entries without ``slot_pos``."""
    from repro_torch.models.lm import lm_stacked

    _, tree = _jax_params(VISION)
    jcfg, cfg = _cfgs(VISION)
    model = _model(VISION, cfg)
    gates = [b["mixer"]["gate"] for b in model.blocks if "gate" in b["mixer"]]
    assert [tuple(g.shape) for g in gates] == [()] and float(gates[0]) == GATE
    back = lm_stacked(cfg, tree_map(lambda t: t.detach().numpy(), lm_params(model)),
                      lambda ts, stacked: np.stack(ts) if stacked else ts[0])
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jc, _ = jax_build_cache(jcfg, B, 32)
    got = lm_cache_to_numpy(cfg, build_cache(cfg, B, 32, device="cpu"))
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, jax.tree.map(np.asarray, jc))
    assert set(got["scan"]["b4"]) == {"k", "v"}


@pytest.mark.parametrize("arch", MEDIA)
def test_forward_and_loss_match_jax_float32(arch):
    params, _ = _jax_params(arch)
    jcfg, cfg = _cfgs(arch)
    model = _model(arch, cfg)
    x, mem = _inputs(cfg)
    want, _ = jax_lm_forward(jcfg, params, _j(x), memory=_j(mem))
    got, aux = lm_forward(cfg, model, _t(x), memory=_t(mem))
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    if mem is not None:  # the media path is live: other memory, other logits
        other, _ = lm_forward(cfg, model, _t(x), memory=_t(mem[::-1].copy()))
        assert np.abs(_np(other) - _np(got)).max() > 1e-3
    batch = _batch(cfg, S, 3)
    jtotal, jm = jax_lm_loss(jcfg, params, {k: _j(v) for k, v in batch.items()})
    total, m = lm_loss(cfg, lm_params(model), {k: _t(v) for k, v in batch.items()})
    assert abs(float(total) - float(jtotal)) <= TOL
    assert int(m["ntokens"]) == int(jm["ntokens"])


@pytest.mark.parametrize("arch", MEDIA)
def test_gradients_match_jax_float32(arch):
    """Every leaf's gradient, the gates' included; hubert never reads its
    ``embed``: JAX's gradient there is zero, the port's exactly zero."""
    params, tree = _jax_params(arch)
    jcfg, cfg = _cfgs(arch)
    batch = _batch(cfg, S, 4)
    jgrads = jax.grad(lambda p: jax_lm_loss(jcfg, p, {k: _j(v) for k, v in batch.items()})[0])(
        params)
    want = tree_flatten(lm_tree_from_numpy(cfg, jax.tree.map(np.asarray, jgrads)))[0]
    leaves, treedef = tree_flatten(tree_map(lambda t: t.detach().clone(),
                                            lm_params(_model(arch, cfg))))
    work = [p.requires_grad_() for p in leaves]
    loss, _ = lm_loss(cfg, tree_unflatten(treedef, work), {k: _t(v) for k, v in batch.items()})
    got = torch.autograd.grad(loss, work, allow_unused=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + 1e-6, i
    got = tree_unflatten(treedef, list(got))
    if arch == AUDIO:
        assert got["embed"] is None
    else:
        gates = [b["mixer"]["gate"] for b in got["blocks"] if "gate" in b["mixer"]]
        assert len(gates) == 1 and float(gates[0].abs()) > 1e-4


def test_vision_prefill_decode_and_cache_match_jax():
    """A prefill against ``memory`` fills the media cache; 8 decode steps
    read it: logits equal to JAX's and to the teacher-forced forward,
    every cache leaf equal to JAX's."""
    params, _ = _jax_params(VISION)
    jcfg, cfg = _cfgs(VISION)
    model = _model(VISION, cfg)
    x, mem = _inputs(cfg, s=S)
    p = S // 2
    full, _ = lm_forward(cfg, model, _t(x), memory=_t(mem))
    jc, _ = jax_build_cache(jcfg, B, S)
    lj, jc = jax_lm_prefill(jcfg, params, _j(x[:, :p]), jc, memory=_j(mem))
    lt, tc = lm_prefill(cfg, model, _t(x[:, :p]), build_cache(cfg, B, S, device="cpu"),
                        memory=_t(mem))
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(lt), _np(full[:, p - 1]), rtol=TOL, atol=TOL)
    assert tc[4]["k"].shape == (B, cfg.num_media_tokens, cfg.n_kv_heads, cfg.head_dim)
    for t in range(p, S):
        lj, jc = jax_lm_decode(jcfg, params, _j(x[:, t]), jc, jnp.int32(t), memory=_j(mem))
        lt, tc = lm_decode(cfg, model, _t(x[:, t]), tc, t, memory=_t(mem))
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=TOL, atol=TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(_np(lt), _np(full[:, t]), rtol=TOL, atol=TOL)
    got, want = lm_cache_to_numpy(cfg, tc), jax.tree.map(np.asarray, jc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=TOL, atol=TOL)


def test_vision_memoryless_prefill_replaces_the_media_cache():
    """Without ``memory`` (the servers' case) the cross layers attend to
    the prompt itself and the prefill replaces their cache entry with the
    prompt's keys and values, shape and all, as the JAX package does; the
    decode steps then read those."""
    params, _ = _jax_params(VISION)
    jcfg, cfg = _cfgs(VISION)
    model = _model(VISION, cfg)
    x, _ = _inputs(cfg, b=1, s=20, seed=5)
    jc, _ = jax_build_cache(jcfg, 1, 32)
    lj, jc = jax_lm_prefill(jcfg, params, _j(x[:, :12]), jc)
    lt, tc = lm_prefill(cfg, model, _t(x[:, :12]), build_cache(cfg, 1, 32, device="cpu"))
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=TOL, atol=TOL)
    shape = (1, 12, cfg.n_kv_heads, cfg.head_dim)
    assert tc[4]["k"].shape == tc[4]["v"].shape == shape
    assert jc["scan"]["b4"]["k"].shape == (1,) + shape
    for t in range(12, 20):
        lj, jc = jax_lm_decode(jcfg, params, _j(x[:, t]), jc, jnp.int32(t))
        lt, tc = lm_decode(cfg, model, _t(x[:, t]), tc, t)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=TOL, atol=TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", MEDIA)
def test_train_step_matches_jax(arch):
    """The second step of the JAX ``make_train_step`` (one-step warmup, so
    it moves every parameter at the full learning rate) from the same
    state in both packages: loss, grad norm, parameters and moments within
    2e-4; hubert's ``embed``, whose gradient is zero, moved by the weight
    decay alone in both."""
    params, _ = _jax_params(arch)
    jcfg, cfg = _cfgs(arch)
    ocfg = dataclasses.replace(jax_opt_config(jcfg), warmup_steps=1)
    init, _ = jax_make_optimizer(ocfg)
    step = jax.jit(jax_make_train_step(jcfg, ocfg))
    p1, o1, _ = step(params, init(params), _batch(jcfg, 16, 0))
    p2, o2, m2 = step(p1, o1, _batch(jcfg, 16, 1))
    host = functools.partial(jax.tree.map, np.asarray)
    tparams = tree_map(lambda t: t.detach().clone(),
                       lm_params(lm_params_from_numpy(cfg, host(p1), device="cpu")))
    state = optimizer_state_from_numpy(host(o1), device="cpu", cfg=cfg)
    tstep = make_train_step(cfg, dataclasses.replace(optimizer_config_from_model(cfg),
                                                     warmup_steps=1))
    embed0 = tparams["embed"].clone()
    tparams, state, m = tstep(tparams, state, _batch(cfg, 16, 1))
    assert abs(float(m["loss"]) - float(m2["loss"])) <= TOL
    assert abs(float(m["grad_norm"]) - float(m2["grad_norm"])) <= TOL * max(
        1.0, float(m2["grad_norm"]))
    assert int(state.step) == 2
    for jax_tree, port_tree in ((p2, tparams), (o2.mu, state.mu), (o2.nu, state.nu)):
        want = tree_flatten(lm_tree_from_numpy(cfg, host(jax_tree)))[0]
        got = tree_flatten(port_tree)[0]
        assert len(want) == len(got)
        assert max(float(np.abs(w - _np(g.detach())).max()) for w, g in zip(want, got)) <= TOL
    if arch == AUDIO:
        assert not torch.any(state.mu["embed"]) and not torch.equal(tparams["embed"], embed0)


def test_encoder_is_bidirectional_as_in_jax():
    """``tests/test_models_smoke.py``'s check on the port: one channel of the
    LAST frame moves the FIRST position's logits; both packages agree."""
    params, _ = _jax_params(AUDIO)
    jcfg, cfg = _cfgs(AUDIO)
    model = _model(AUDIO, cfg)
    x = np.random.default_rng(2).standard_normal((1, 8, cfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[:, -1, 0] += 1.0
    l1, _ = lm_forward(cfg, model, _t(x))
    l2, _ = lm_forward(cfg, model, _t(x2))
    assert np.abs(_np(l2[:, 0]) - _np(l1[:, 0])).max() > 1e-6
    want, _ = jax_lm_forward(jcfg, params, _j(x2))
    np.testing.assert_allclose(_np(l2), _np(want), rtol=TOL, atol=TOL)


def test_encoder_flash_scan_without_a_causal_mask_matches_jax():
    """Past ``FLASH_THRESHOLD`` the encoder takes the flash scan with no
    causal mask: 2560 frames (5 chunks of 512), each layer's scan counted."""
    params, _ = _jax_params(AUDIO)
    jcfg, cfg = _cfgs(AUDIO)
    model = _model(AUDIO, cfg)
    n = 5 * L.FLASH_CHUNK
    assert n > L.FLASH_THRESHOLD
    x, _ = _inputs(cfg, b=1, s=n, seed=9)
    calls, scan = [], L._flash_fwd_scan

    def counted(*a, **k):
        calls.append(k["causal"])
        return scan(*a, **k)

    L._flash_fwd_scan = counted
    try:
        got, _ = lm_forward(cfg, model, _t(x))
    finally:
        L._flash_fwd_scan = scan
    assert calls == [False] * cfg.n_layers
    want, _ = jax_lm_forward(jcfg, params, _j(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", MEDIA)
def test_bfloat16_compute_matches_jax_within_bf16_bound(arch):
    params, _ = _jax_params(arch)
    jcfg, cfg = _cfgs(arch, compute_dtype="bfloat16")
    model = _model(arch, cfg)
    x, mem = _inputs(cfg, seed=3)
    want, _ = jax_lm_forward(jcfg, params, _j(x), memory=_j(mem))
    got, _ = lm_forward(cfg, model, _t(x), memory=_t(mem))
    assert got.dtype == torch.bfloat16
    want = _np(want)
    assert np.abs(_np(got) - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("arch", MEDIA)
def test_init_matches_jax_per_leaf(arch):
    """Every leaf drawn with the JAX init's std and constants (the gate a
    zero scalar), at a smoke config widened to d_model 256."""
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
        if ref.numel() == 1 or ref.std() == 0:
            assert torch.equal(x, ref), name
        elif ref.numel() >= 16384:
            ratio = (x.std() / ref.std()).item()
            assert abs(ratio - 1) < 0.05, (name, ratio)
            checked += 1
    assert checked >= 5
    if arch == VISION:
        assert any(n.endswith("mixer.gate") for n in mine)


class _Matmuls(TorchDispatchMode):
    """Counts the dense products dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in MM
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", VISION])
def test_remat_dots_matches_full_and_jax(arch):
    """``remat_policy="dots"`` (selective checkpointing that keeps every
    matmul's output): the loss and every gradient equal to ``"full"``'s
    and to JAX's ``dots_saveable`` at float32, and its backward recomputes
    no matmul where ``"full"`` recomputes the forward's."""
    base = dict(compute_dtype="float32", remat=True)
    jcfg, _ = _cfgs(arch, remat_policy="dots", **base)
    params = (_jax_params(arch)[0] if arch == VISION
              else jax_build_lm(jcfg, jax.random.PRNGKey(0))[0])
    tree = jax.tree.map(np.asarray, params)
    batch = _batch(jcfg, S, 6)
    results, counts = {}, {}
    for policy in ("full", "dots", "none"):
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                                  remat=policy != "none",
                                  remat_policy="full" if policy == "none" else policy)
        leaves, treedef = tree_flatten(tree_map(lambda a: torch.from_numpy(np.array(a)),
                                                lm_tree_from_numpy(cfg, tree)))
        work = [p.requires_grad_() for p in leaves]
        loss, _ = lm_loss(cfg, tree_unflatten(treedef, work), {k: _t(v) for k, v in batch.items()})
        with _Matmuls() as mm:
            grads = torch.autograd.grad(loss, work)
        results[policy], counts[policy] = (float(loss.detach()), [g.numpy() for g in grads]), mm.n
    assert results["dots"][0] == results["full"][0]
    for a, b in zip(results["dots"][1], results["full"][1]):
        np.testing.assert_array_equal(a, b)
    assert counts["dots"] == counts["none"] < counts["full"], counts
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, p, {k: _j(v) for k, v in batch.items()})[0])(params)
    assert abs(results["dots"][0] - float(jloss)) <= TOL
    want = tree_flatten(lm_tree_from_numpy(jcfg, jax.tree.map(np.asarray, jgrads)))[0]
    for g, w in zip(results["dots"][1], want):
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + 1e-6


def test_vision_greedy_tokens_match_the_jax_server():
    """The servers pass no memory: the prefill fills the media cache from
    the prompt. The same greedy tokens as the JAX server, more requests
    than lanes."""
    params, _ = _jax_params(VISION)
    jcfg, cfg = _cfgs(VISION)
    model = _model(VISION, cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (16, 5, 30, 12, 7)]

    def serve(server):
        rids = [server.submit(p, 6) for p in prompts]
        done = {r.rid: r for r in server.run_until_idle()}
        return [done[rid].out_tokens for rid in rids]

    want = serve(JaxBatchedServer(jcfg, params, lanes=2, max_len=64))
    got = serve(BatchedServer(cfg, model, lanes=2, max_len=64))
    assert got == want and all(len(t) == 6 for t in got)


def test_launchers_serve_and_train_the_media_archs(capsys):
    """The serve launcher refuses the encoder (no decode), as the JAX one
    does, and serves llama-vision; the train launcher trains llama-vision
    on its token stream (no media) and refuses hubert, naming the frames
    its token stream cannot make."""
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train

    with pytest.raises(SystemExit, match="encoder-only"):
        serve(["--arch", AUDIO, "--smoke", "--device", "cpu"])
    serve(["--arch", VISION, "--smoke", "--device", "cpu", "--requests", "3", "--lanes", "2",
           "--max-len", "32", "--max-new", "4"])
    assert "3/3 requests" in capsys.readouterr().out
    train(["--arch", VISION, "--smoke", "--device", "cpu", "--steps", "2", "--global-batch",
           "2", "--seq", "16"])
    assert "[train] step 0 loss" in capsys.readouterr().out
    with pytest.raises(ValueError, match="frame embeddings"):
        train(["--arch", AUDIO, "--smoke", "--device", "cpu"])
