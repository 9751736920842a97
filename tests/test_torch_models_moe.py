"""The port's MoE LMs against the JAX package on the CPU.

The two MoE smoke configs (qwen3-moe: 8 experts top-2, untied head,
bfloat16 AdamW moments; arctic: the same with a dense residual FFN, heads
padded to 64, bfloat16 parameters, Adafactor) with the JAX ``build_lm``
weights carried across by ``lm_params_from_numpy`` (the stacked
``(n_super, E, D, F)`` expert leaves unstacked, arctic's ``dense`` group
nested), tokens from a numpy seed. At ``compute_dtype="float32"``: the
forward logits within 2e-4 and ``aux`` within 1e-5 relative (the default
capacity factor: tokens are dropped in both packages alike); dropless
(``capacity_factor=64``, as the JAX package's own decode checks run,
since capacity drops tokens at train shapes and never at decode) the
prefill logits, every cache leaf and 8 decode steps within 2e-4, and the
port's decode equal to its teacher-forced forward. One train step (loss,
aux loss, grad norm, parameters and moments) within 2e-4 of the JAX
``make_train_step``; the ``BatchedServer``'s greedy tokens equal to the
JAX server's. bfloat16 compute is held to 5 % of the largest logit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.configs import get_smoke_config
from repro_torch.interop import (lm_cache_to_numpy, lm_params_from_numpy, lm_tree_from_numpy,
                                 optimizer_state_from_numpy)
from repro_torch.models import (build_cache, build_lm, lm_decode, lm_forward, lm_params,
                                lm_prefill)
from repro_torch.optim import optimizer_config_from_model
from repro_torch.serve import BatchedServer
from repro_torch.train import make_train_step
from repro_torch.tree import tree_flatten, tree_map

MOE = ["qwen3-moe-235b-a22b", "arctic-480b"]
TOL = 2e-4
AUX_REL = 1e-5
BF16_REL = 5e-2
DROPLESS = 64.0
B, S = 2, 32


def _cfgs(arch, compute_dtype="float32", **over):
    return (dataclasses.replace(jax_smoke_config(arch), compute_dtype=compute_dtype, **over),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=compute_dtype, **over))


@functools.cache
def _jax_params(arch):
    """(JAX params, numpy tree) of one smoke config."""
    params, _ = jax_build_lm(jax_smoke_config(arch), jax.random.PRNGKey(0))
    return params, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("arch", MOE)
def test_moe_trees_carry_across_in_the_jax_layout(arch):
    _, tree = _jax_params(arch)
    cfg = get_smoke_config(arch)
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    ffn = lm_params(model)["blocks"][0]["ffn"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tree["scan"]["b0"]["ffn"]["w1"].shape == (cfg.n_super, e, d, f)
    assert tuple(ffn["w1"].shape) == (e, d, f) and ffn["w1"].dtype == getattr(
        torch, cfg.param_dtype)
    assert ("dense" in ffn) == cfg.moe_dense_residual
    if cfg.moe_dense_residual:
        assert set(ffn["dense"]) == {"w1", "w3", "w2"}
        assert "blocks.0.ffn.dense.w1" in dict(model.named_parameters())
    want = tree_flatten(lm_tree_from_numpy(cfg, tree))[0]
    got = tree_flatten(lm_params(model))[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), w)


@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_decode_match_jax_float32(arch):
    params, tree = _jax_params(arch)
    jcfg, tcfg = _cfgs(arch)
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    toks = _tokens(tcfg, (B, S))

    want, aux_j = jax_lm_forward(jcfg, params, jnp.asarray(toks))
    got, aux = lm_forward(tcfg, model, torch.from_numpy(toks))
    assert got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    assert float(aux) > 0 and abs(float(aux) - float(aux_j)) <= AUX_REL * float(aux_j)

    jcfg, tcfg = _cfgs(arch, capacity_factor=DROPLESS)
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
    for g, w in zip(jax.tree.leaves(lm_cache_to_numpy(tcfg, tc)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", MOE)
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


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_teacher_forcing(arch):
    """Dropless: prefill the first half, decode the rest token by token,
    and reproduce one teacher-forced forward pass (at the default capacity
    the forward drops tokens that decode keeps: the train/serve skew the
    JAX package's test names)."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              capacity_factor=DROPLESS)
    model = build_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (B, 32), seed=7))
    full, aux = lm_forward(cfg, model, toks)
    assert float(aux) > 0
    last, cache = lm_prefill(cfg, model, toks[:, :16], build_cache(cfg, B, 32, device="cpu"))
    torch.testing.assert_close(last, full[:, 15], rtol=TOL, atol=TOL)
    for t in range(16, 32):
        step, cache = lm_decode(cfg, model, toks[:, t], cache, t)
        torch.testing.assert_close(step, full[:, t], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", MOE)
def test_init_matches_jax_per_leaf(arch):
    """Every leaf drawn with the JAX init's std and constants (a smoke
    config widened to d_model 256, so each random leaf has at least 16384
    values and a 5 % bound on the std ratio is far outside sampling noise)."""
    wide = dict(d_model=256, d_ff=256, vocab_size=512, head_dim=0)
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
        if ref.float().std() == 0:
            assert torch.equal(x, ref), name
        elif ref.numel() >= 16384:
            ratio = (x.float().std() / ref.float().std()).item()
            assert abs(ratio - 1) < 0.05, (name, ratio)
            checked += 1
    assert checked >= 8


def _batch(vocab, seq, seed):
    t = np.random.default_rng(seed).integers(0, vocab, (4, seq + 1)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
    b["labels"][0, :3] = -100  # padded positions
    return b


@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_jax(arch):
    """The second step of the JAX ``make_train_step`` (one-step warmup, so
    it moves every parameter at the full learning rate) from the same
    state in both packages: loss, aux loss, grad norm, parameters and
    moments (AdamW's bfloat16 mu and nu for qwen3-moe, Adafactor's vr and
    vc for arctic) within 2e-4."""
    jcfg, cfg = _cfgs(arch)
    params, _ = _jax_params(arch)
    ocfg = dataclasses.replace(jax_opt_config(jcfg), warmup_steps=1)
    init, _ = jax_make_optimizer(ocfg)
    step = jax.jit(jax_make_train_step(jcfg, ocfg))
    p1, o1, _ = step(params, init(params), _batch(jcfg.vocab_size, 16, 0))
    p2, o2, m2 = step(p1, o1, _batch(jcfg.vocab_size, 16, 1))
    host = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float32))
    tparams = tree_map(lambda t: t.detach().clone(),
                       lm_params(lm_params_from_numpy(cfg, host(p1), device="cpu")))
    state = optimizer_state_from_numpy(jax.tree.map(np.asarray, o1), device="cpu", cfg=cfg)
    tstep = make_train_step(cfg, dataclasses.replace(optimizer_config_from_model(cfg),
                                                     warmup_steps=1))
    tparams, state, m = tstep(tparams, state, _batch(cfg.vocab_size, 16, 1))
    assert abs(float(m["loss"]) - float(m2["loss"])) <= TOL
    assert float(m["aux_loss"]) > 0
    assert abs(float(m["aux_loss"]) - float(m2["aux_loss"])) <= AUX_REL * float(m2["aux_loss"])
    assert abs(float(m["grad_norm"]) - float(m2["grad_norm"])) <= TOL * max(
        1.0, float(m2["grad_norm"]))
    assert int(state.step) == 2
    # AdamW's per-layer moments unstack; Adafactor's state is the JAX layout.
    per_layer = type(state).__name__ == "AdamWState"
    pairs = [(lm_tree_from_numpy(cfg, host(p2)), tparams)] + [
        (lm_tree_from_numpy(cfg, host(getattr(o2, f))) if per_layer else host(getattr(o2, f)),
         getattr(state, f)) for f in state._fields[1:]]
    for want_tree, port_tree in pairs:
        want = tree_flatten(want_tree)[0]
        got = tree_flatten(port_tree)[0]
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert w.shape == tuple(g.shape)
            assert float(np.abs(w - _np(g.detach())).max()) <= TOL


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_match_the_jax_server(arch):
    """Prompts of several lengths, more requests than lanes: the same greedy
    tokens as the JAX server (each package's default capacity factor)."""
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


def test_adafactor_state_keeps_the_jax_layout():
    """arctic's Adafactor state from the port's trainer has the JAX
    package's tree and shapes: its stacked leaves are factored by their
    stacked shape (a smoke expert stack (2, 8, 64, 32) is factored where one
    layer's (8, 64, 32) would not be)."""
    from repro.optim import make_optimizer as jax_opt
    from repro_torch.train import init_train_state

    cfg = get_smoke_config("arctic-480b")
    params, _ = jax_build_lm(jax_smoke_config("arctic-480b"), jax.random.PRNGKey(0))
    want = jax_opt(jax_opt_config(jax_smoke_config("arctic-480b")))[0](params)
    _, state = init_train_state(cfg, device="cpu")
    assert type(state).__name__ == "AdafactorState"
    for field in ("vr", "vc"):
        got = tree_map(lambda t: tuple(t.shape), getattr(state, field))
        assert got == jax.tree.map(lambda a: tuple(a.shape), getattr(want, field),
                                   is_leaf=lambda a: hasattr(a, "shape"))
    assert tuple(state.vr["scan"]["b0"]["ffn"]["w1"].shape) == (2, 8, 64)


@pytest.mark.parametrize("arch", MOE)
def test_entry_points_take_the_moe_archs_on_the_cpu(arch, tmp_path, capsys):
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as launch

    serve(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3", "--lanes", "2",
           "--max-new", "4"])
    launch(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--global-batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "1"])
    assert "[train] step 0 loss" in capsys.readouterr().out
    # bfloat16 leaves (arctic's parameters, qwen3-moe's moments) checkpoint
    # widened to float32 and restore bit for bit: a rerun resumes, runs nothing.
    assert latest_step(tmp_path / "a") == 1
    launch(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--global-batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "1"])
    assert "resuming at 2" in capsys.readouterr().out
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, str(repo / "examples" / "torch_train_lm.py"), "--arch", arch,
         "--smoke", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "b")],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(repo / "src")},
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"arch={arch}" in out.stdout and "loss: first10=" in out.stdout
