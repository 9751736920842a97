"""The expert-parallel MoE's dense residual branch where ``model`` does not
split its ``mlp`` dim: arctic's smoke config with 8 experts and ``d_ff``
36 on a ``(1, 8)`` ``("data", "model")`` mesh (36 is no multiple of 8,
so ``spec_for`` leaves the dense weights' ``mlp`` dim whole, while the 8
experts split one a rank).

* The JAX package's ``apply_moe_sharded`` (``tests/torch_jax_moe_dense.py``
  in an 8-device subprocess) adds each rank's whole dense output into the
  partial sum over ``model``, so its result is the local path's plus 7
  times the dense branch (a reference fault, recorded in ROADMAP, not
  fixed there).
* The port computes the branch whole on every rank, outside the sum: on 8
  gloo ranks (``torch_dist_harness.moe_suite``) one float32 dropless MoE
  layer equals the port's and the JAX package's local path within 2e-4,
  ``aux`` within 1e-5 relative, and one smoke LM's loss and every gradient
  through the sharded path equal the local path's within 2e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.dist.sharding import spec_for as jax_spec_for
from repro.models import build_lm as jax_build_lm
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.dist.sharding import spec_for
from repro_torch.interop import lm_tree_from_numpy
from repro_torch.models import layers as L
from repro_torch.models.lm import lm_loss
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

from torch_dist_harness import moe_suite, run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCH = "arctic-480b"
F2 = {"n_experts": 8, "d_ff": 36}
F32_DROPLESS = {**F2, "compute_dtype": "float32", "capacity_factor": 64.0}
MESH = (1, 8)
TOL = 2e-4
AUX_REL = 1e-5


class FakeMesh:
    """Both packages' duck type: ``axis_names`` with ``devices.shape`` (JAX)
    and ``shape`` (the port)."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = tuple(shape)
        self.devices = np.empty(shape, dtype=object)


def _layer():
    cfg = dataclasses.replace(jax_smoke_config(ARCH), **F32_DROPLESS)
    p, _ = JL.init_moe(cfg, jax.random.PRNGKey(2))
    x = np.random.default_rng(3).standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    return cfg, p, jax.tree.map(lambda a: np.asarray(a, np.float32), p), x


def _lm():
    cfg = dataclasses.replace(jax_smoke_config(ARCH), **F2, compute_dtype="float32")
    params, _ = jax_build_lm(cfg, jax.random.PRNGKey(4))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 17)).astype(np.int64)
    return tree, {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, _, p, x = _layer()
    tree, batch = _lm()
    layer_cases = {"f32": (ARCH, F32_DROPLESS, MESH, p, x)}
    lm_cases = {"lm": (ARCH, {**F2, "compute_dtype": "float32"}, MESH, tree, batch)}
    return run_ranks(moe_suite, 8, tmp_path_factory.mktemp("moe8"), layer_cases, lm_cases,
                     timeout=240)


def test_f2_config_leaves_the_dense_mlp_unsplit():
    cfg = dataclasses.replace(get_smoke_config(ARCH), **F2)
    mesh = FakeMesh(MESH, ("data", "model"))
    shapes = L.moe_shapes(cfg)
    for name, axes in (("w1", ("fsdp", "mlp")), ("w3", ("fsdp", "mlp")), ("w2", ("mlp", "fsdp"))):
        spec = spec_for(axes, mesh, shapes["dense"][name])
        assert "model" not in spec, (name, spec)
        assert spec == tuple(jax_spec_for(axes, mesh, shapes["dense"][name]))
    assert L.moe_specs(cfg, mesh)["w1"][0] == "model"  # one expert a rank


def test_jax_sums_the_replicated_dense_partials():
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_jax_moe_dense.py"),
                           json.dumps(F32_DROPLESS)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # The sharded result is off by far more than the tolerance, and by exactly
    # mp - 1 = 7 dense branches.
    assert got["sharded_minus_local"] > 100 * TOL * got["local_max"]
    assert got["minus_seven_dense"] <= TOL * got["local_max"]


def test_port_computes_the_unsplit_dense_branch_whole(ranks):
    cfg, jp, p, x = _layer()
    y_jax, aux_jax = JL._apply_moe_local(cfg, jp, jnp.asarray(x))
    tcfg = dataclasses.replace(get_smoke_config(ARCH), **F32_DROPLESS)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()).to(getattr(torch, tcfg.param_dtype)), p)
    y_loc, aux_loc = L._apply_moe_local(tcfg, tp, torch.from_numpy(x))
    y_loc, aux_loc = y_loc.float().numpy(), float(aux_loc)
    np.testing.assert_allclose(y_loc, np.asarray(y_jax), rtol=TOL, atol=TOL)
    for rank, res in enumerate(ranks):
        y, aux = res["layers"]["f32"]
        np.testing.assert_allclose(y, y_loc, rtol=TOL, atol=TOL, err_msg=f"rank {rank}")
        assert abs(aux - aux_loc) <= AUX_REL * abs(aux_loc), (rank, aux, aux_loc)
        assert abs(aux - float(aux_jax)) <= AUX_REL * abs(float(aux_jax))


def test_port_loss_and_gradients_through_the_whole_dense_branch(ranks):
    tree, batch = _lm()
    cfg = dataclasses.replace(get_smoke_config(ARCH), **F2, compute_dtype="float32")
    leaves, treedef = tree_flatten(tree_map(lambda a: torch.from_numpy(a.copy()).to(
        getattr(torch, cfg.param_dtype)), lm_tree_from_numpy(cfg, tree)))
    work = [t.requires_grad_(True) for t in leaves]
    loss, _ = lm_loss(cfg, tree_unflatten(treedef, work),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    want = [g.float().numpy() for g in torch.autograd.grad(loss, work)]
    for rank, res in enumerate(ranks):
        got = res["lms"]["lm"]
        assert abs(got["loss"] - float(loss.detach())) <= TOL, rank
        got_leaves, got_def = tree_flatten(got["grads"])
        assert got_def == treedef
        for g, w in zip(got_leaves, want):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=f"rank {rank}")
