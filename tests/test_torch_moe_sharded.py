"""The port's expert-parallel MoE on gloo ranks against its local MoE and
the JAX package's.

Two spawns through ``tests/torch_dist_harness.py`` (``moe_suite``; the
children import no JAX): four ranks for the ``(1, 4)`` and ``(2, 2)``
``("data", "model")`` meshes, three for the ``(1, 3)`` one. Each rank
holds its ``shard_moe_params`` pieces of one smoke MoE layer (both archs;
arctic with its dense residual branch) and its block of the batch, and
calls ``apply_moe`` under the ambient mesh:

* at float32 and dropless (``capacity_factor=64``), the gathered output
  within 2e-4 of the port's ``_apply_moe_local`` and of the JAX package's
  on the whole batch (the bound of the JAX package's own sharded check),
  ``aux`` within 1e-5 relative (the per-expert statistics averaged over
  the data ranks before their product);
* at bfloat16 on ``(1, 4)``, within 4 bfloat16 steps (2^-7 each) of
  max|y|: each of the 4 model ranks rounds its partial output to
  bfloat16 and the sum over ``model`` runs in bfloat16, as the JAX
  ``psum`` in the compute dtype does, where the local path rounds one
  float32 sum;
* the one-token step under a mesh (the pieces gathered whole, then the
  local path) and the ``(1, 3)`` fallback (8 experts do not split three
  ways) equal to the local path within 2e-4;
* one qwen3-moe smoke LM's loss, aux loss and every gradient through the
  sharded path on ``(1, 4)``, with and without remat, within 2e-4 of the
  local path's (the default capacity factor, so tokens are dropped in
  both: one model group sees every token, so the capacity is the same).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_lm as jax_build_lm
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_tree_from_numpy
from repro_torch.models import layers as L
from repro_torch.models.lm import lm_loss
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

from torch_dist_harness import moe_suite, run_ranks

ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
TOL = 2e-4
AUX_REL = 1e-5
BF16_STEPS = 4 * 2.0**-7  # one bfloat16 step of max|y| per model rank
F32_DROPLESS = {"compute_dtype": "float32", "capacity_factor": 64.0}
LM_ARCH = "qwen3-moe-235b-a22b"


@functools.cache
def _moe_params(arch, seed):
    p, _ = JL.init_moe(jax_smoke_config(arch), jax.random.PRNGKey(seed))
    return p, jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _x(arch, shape, seed):
    d = get_smoke_config(arch).d_model
    return np.random.default_rng(seed).standard_normal(shape + (d,)).astype(np.float32)


def _layer_cases(world):
    cases = {}
    for i, arch in enumerate(ARCHS):
        _, p = _moe_params(arch, i)
        meshes = [(1, 4), (2, 2)] if world == 4 else [(1, 3)]
        for shape in meshes:
            cases[(arch, shape, "f32")] = (arch, F32_DROPLESS, shape, p, _x(arch, (4, 8), 10 + i))
            cases[(arch, shape, "step")] = (arch, F32_DROPLESS, shape, p, _x(arch, (4, 1), 20 + i))
        if world == 4:
            cases[(arch, (1, 4), "bf16")] = (arch, {"capacity_factor": 64.0}, (1, 4), p,
                                            _x(arch, (4, 8), 30 + i))
    return cases


@functools.cache
def _lm():
    cfg = dataclasses.replace(jax_smoke_config(LM_ARCH), compute_dtype="float32")
    params, _ = jax_build_lm(cfg, jax.random.PRNGKey(4))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int64)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -100
    return tree, batch


def _lm_cases():
    tree, batch = _lm()
    return {remat: (LM_ARCH, {"compute_dtype": "float32", "remat": remat}, (1, 4), tree, batch)
            for remat in (False, True)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    four = run_ranks(moe_suite, 4, tmp_path_factory.mktemp("moe4"), _layer_cases(4),
                     _lm_cases(), timeout=180)
    three = run_ranks(moe_suite, 3, tmp_path_factory.mktemp("moe3"), _layer_cases(3), {},
                      timeout=120)
    return four, three


def _local(key, case):
    arch, over, _, p, x = case
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()).to(getattr(torch, cfg.param_dtype)), p)
    y, aux = L._apply_moe_local(cfg, tp, torch.from_numpy(x))
    return cfg, y.float().numpy(), float(aux)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 3)])
def test_sharded_forward_matches_the_local_paths(ranks, arch, shape):
    results = ranks[0] if shape != (1, 3) else ranks[1]
    key = (arch, shape, "f32")
    case = _layer_cases(4 if shape != (1, 3) else 3)[key]
    cfg, y_loc, aux_loc = _local(key, case)
    jp, _ = _moe_params(arch, ARCHS.index(arch))
    jcfg = dataclasses.replace(jax_smoke_config(arch), **F32_DROPLESS)
    y_jax, aux_jax = JL._apply_moe_local(jcfg, jp, jnp.asarray(case[4]))
    np.testing.assert_allclose(y_loc, np.asarray(y_jax), rtol=TOL, atol=TOL)
    for rank, res in enumerate(results):
        y, aux = res["layers"][key]
        np.testing.assert_allclose(y, y_loc, rtol=TOL, atol=TOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(y, np.asarray(y_jax), rtol=TOL, atol=TOL)
        assert abs(aux - aux_loc) <= AUX_REL * abs(aux_loc), (rank, aux, aux_loc)
        assert abs(aux - float(aux_jax)) <= AUX_REL * abs(float(aux_jax))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 3)])
def test_one_token_step_under_a_mesh_is_the_local_path(ranks, arch, shape):
    results = ranks[0] if shape != (1, 3) else ranks[1]
    key = (arch, shape, "step")
    _, y_loc, aux_loc = _local(key, _layer_cases(4 if shape != (1, 3) else 3)[key])
    for res in results:
        y, aux = res["layers"][key]
        np.testing.assert_allclose(y, y_loc, rtol=TOL, atol=TOL)
        assert abs(aux - aux_loc) <= AUX_REL * abs(aux_loc)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_bfloat16_within_a_step_a_rank_of_the_local_path(ranks, arch):
    key = (arch, (1, 4), "bf16")
    _, y_loc, _ = _local(key, _layer_cases(4)[key])
    bound = BF16_STEPS * np.abs(y_loc).max()
    for res in ranks[0]:
        y, _ = res["layers"][key]
        assert np.abs(y - y_loc).max() <= bound


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_loss_and_gradients_equal_the_local_paths(ranks, remat):
    tree, batch = _lm()
    cfg = dataclasses.replace(get_smoke_config(LM_ARCH), compute_dtype="float32", remat=remat)
    leaves, treedef = tree_flatten(tree_map(lambda a: torch.from_numpy(a.copy()),
                                            lm_tree_from_numpy(cfg, tree)))
    work = [p.requires_grad_(True) for p in leaves]
    loss, metrics = lm_loss(cfg, tree_unflatten(treedef, work),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    want = [g.numpy() for g in torch.autograd.grad(loss, work)]
    loss, aux = float(loss.detach()), float(metrics["aux_loss"].detach())
    assert aux > 0
    for rank, res in enumerate(ranks[0]):
        got = res["lms"][remat]
        assert abs(got["loss"] - loss) <= TOL, rank
        assert abs(got["aux_loss"] - aux) <= AUX_REL * aux
        got_leaves, got_def = tree_flatten(got["grads"])
        assert got_def == treedef
        for g, w in zip(got_leaves, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=f"rank {rank}")
