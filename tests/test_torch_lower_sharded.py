"""The port's sharded lowering (``repro_torch.ir.lower_sharded``) against the
JAX package, on gloo meshes of 8 CPU processes.

One spawn (``torch_dist_harness.lower_sharded_suite``) runs every cell and
returns the gathered results; the tests below compare them with
``tests/conformance.py``'s JAX oracles:

  * the 11 programs x k = 1-3 x {8x1, 2x4, 1x8, 2x2x2} x {reference, cuda}
    within ``TOL`` of ``lower_reference`` (the cuda inner is K2's plain
    version on the CPU);
  * an acceptance subset within ``TOL`` of JAX ``lower_sharded`` itself
    (one 8-fake-device subprocess), and ``make_sharded_hdiff`` against the
    JAX package's on 8x1 and 2x4 data x rows meshes;
  * bit-equalities: ``overlap=True`` against ``False``, merged against
    sequential exchanges, ``boundary="zero"`` against the padded
    single-device evaluation;
  * wire bytes: the bytes every rank sent, summed, equal
    ``program_halo_exchange_bytes`` (and ``gradient_halo_exchange_bytes``
    for a value-and-grad step) at ratio 1.000;
  * gradients of ``build_backend(..., "sharded-*", differentiable=True)``
    within ``GRAD_TOL`` of ``jax.grad(lower_reference)``.

K2's plain version in offset mode is also held against JAX ``lower_pallas``
with offsets (interpret mode) on the kept region.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conformance as C
import torch_dist_harness as H
from repro.ir import lower_pallas, repeat
from repro_torch import ir as tir

ROOT = Path(__file__).resolve().parents[1]
INNERS = ("reference", "cuda")
SPAWN_TIMEOUT = 300
JAX_TIMEOUT = 300
PSI_SHAPE = (8, 32, 16)


def _np(x):
    if isinstance(x, dict):
        return {f: np.asarray(a) for f, a in x.items()}
    return np.asarray(x)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's results and the JAX side's, computed once for the file:
    the ranks and the JAX subprocess run while this process makes the
    oracles."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = {name: _np(C.make_fields(name)) for name in C.PROGRAMS}
    weights = {(name, k): _np(C.make_loss_weights(name, k))
               for name in C.PROGRAMS for k in C.KS}
    psi = np.random.default_rng(0).standard_normal(PSI_SHAPE).astype(np.float32)
    np.savez(tmp / "psi.npz", psi=psi)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    jax_proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_jax_sharded.py"), str(tmp / "psi.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ranks = H.start_ranks(H.lower_sharded_suite, 8, tmp, inputs, weights, psi,
                          timeout=SPAWN_TIMEOUT)
    for name in C.PROGRAMS:
        for k in C.KS:
            C.oracle(name, k)
            C.grad_oracle(name, k)
    try:
        out, err = jax_proc.communicate(timeout=JAX_TIMEOUT)
    finally:
        jax_proc.kill()
    results = ranks.join()[0]
    assert jax_proc.returncode == 0 and "JAX_SHARDED_OK" in out, err
    with np.load(tmp / "jax.npz") as z:
        results["jax"] = dict(z)
    results["psi"] = psi
    return results


MATRIX = [(m, name, k, inner) for m in H.MESHES for name in C.PROGRAMS for k in C.KS
          for inner in INNERS]


@pytest.mark.parametrize("mesh,name,k,inner", MATRIX,
                         ids=[f"{m}-{n}-k{k}-{i}" for m, n, k, i in MATRIX])
def test_sharded_within_tol_of_jax_reference(runs, mesh, name, k, inner):
    C.assert_close(runs["fwd"][(mesh, name, k, inner)], C.oracle(name, k),
                   err_msg=f"{name}/k={k}/mesh={mesh}/{inner}")


@pytest.mark.parametrize("mesh", list(H.MESHES))
@pytest.mark.parametrize("inner", INNERS)
def test_overlap_bit_equal_to_serial(runs, mesh, inner):
    cells = {key: v for key, v in runs["overlap_equal"].items()
             if key[0] == mesh and key[3] == inner}
    assert len(cells) == len(C.PROGRAMS) * len(C.KS)
    assert all(cells.values()), [key for key, v in cells.items() if not v]


@pytest.mark.parametrize("mesh", list(H.MESHES))
def test_wire_bytes_summed_over_ranks_equal_the_model(runs, mesh):
    cells = {key: v for key, v in runs["wire"].items() if key[0] == mesh}
    assert len(cells) == len(C.PROGRAMS) * len(C.KS) * len(INNERS)
    for key, (sent, model) in cells.items():
        assert sent == model, (key, sent, model)  # ratio 1.000
    assert cells[(mesh, "hdiff", 1, "cuda")][1] > 0


@pytest.mark.parametrize("name", ["vadvc", "hdiff_coupled", "shallow_water",
                                  "advection_diffusion"])
def test_merged_exchange_equals_sequential(runs, name):
    for k in C.KS:
        cell = runs["merged"][(name, k)]
        assert cell["equal"], (name, k)
        assert cell["bytes"][0] == cell["bytes"][1], cell


def test_merged_exchange_cuts_shallow_water_messages_threefold(runs):
    # 2 row bands + 2 col bands + 4 corners per field group on 2x4.
    for k in C.KS:
        assert runs["merged"][("shallow_water", k)]["families"] == (8, 24)


@pytest.mark.parametrize("inner", INNERS)
def test_zero_boundary_equals_padded_single_device(runs, inner):
    cells = {name: v for (name, i), v in runs["zero_equal"].items() if i == inner}
    assert len(cells) == len(C.PROGRAMS) and all(cells.values()), cells


GRAD_CELLS = [("sharded-reference", name, k) for name in C.PROGRAMS for k in C.KS] + [
    ("sharded-cuda", name, k) for name in H.GRAD_CUDA for k in (1, 2)]


@pytest.mark.parametrize("backend,name,k", GRAD_CELLS,
                         ids=[f"{b}-{n}-k{k}" for b, n, k in GRAD_CELLS])
def test_sharded_gradients_within_grad_tol(runs, backend, name, k):
    C.assert_grad_close(runs["grad"][(backend, name, k)], C.grad_oracle(name, k),
                        err_msg=f"{backend}/{name}/k={k}/2x4")


def test_gradient_wire_bytes_equal_the_model(runs):
    assert len(runs["grad_wire"]) == len(GRAD_CELLS)
    for key, (sent, model) in runs["grad_wire"].items():
        assert sent == model and model > 0, (key, sent, model)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("inner", INNERS)
def test_cols_first_mesh_routes_corners(runs, k, inner):
    C.assert_close(runs["fwd"][("cols-first 4x2", "hdiff", k, inner)], C.oracle("hdiff", k),
                   err_msg="col-first mesh corner routing")


def test_fine_mesh_raises_and_names_the_remedy(runs):
    assert "rows/shard 5 < inferred halo 6" in runs["raises"]["rows"]
    assert "shard columns" in runs["raises"]["rows"]
    assert "cols/shard 5 < inferred halo 6" in runs["raises"]["cols"]
    assert "shard rows" in runs["raises"]["cols"]


@pytest.mark.parametrize("name", ["hdiff", "shallow_water", "hdiff_coupled"])
@pytest.mark.parametrize("k", C.KS)
def test_acceptance_subset_against_jax_lower_sharded(runs, name, k):
    want = {f.split("/")[2]: a for f, a in runs["jax"].items()
            if f.startswith(f"{name}/{k}/")}
    want = want[""] if "" in want else want
    for inner in INNERS:
        C.assert_close(runs["fwd"][("2x4", name, k, inner)], want,
                       err_msg=f"{name}/k={k}/2x4/{inner} vs JAX lower_sharded")


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_make_sharded_hdiff_matches_jax(runs, shape):
    want = runs["jax"][f"sharded_hdiff/{shape[0]}x{shape[1]}"]
    np.testing.assert_allclose(runs["sharded_hdiff"][shape], want, rtol=C.TOL, atol=C.TOL)


# -- K2's plain version in offset mode against JAX lower_pallas ---------------

OFFSET_CASES = [("hdiff", 1), ("hdiff", 3), ("shallow_water", 1), ("hdiff_coupled", 2),
                ("vadvc", 1)]


@pytest.mark.parametrize("name,k", OFFSET_CASES, ids=[f"{n}-k{k}" for n, k in OFFSET_CASES])
@pytest.mark.parametrize("mode", ["rows", "cols"])
def test_k2_plain_offset_mode_matches_lower_pallas(name, k, mode):
    """A halo-padded shard block of a 2x4 split of the conformance grid
    (shard (1, 2)), through K2's plain version and JAX ``lower_pallas``
    with the same offsets: the kept region agrees within TOL."""
    p_jax = repeat(C.PROGRAMS[name](), k)
    prog = tir.repeat(H.program(name), k)
    h = prog.radius
    x = C.make_fields(name)
    arrays = x if isinstance(x, dict) else {prog.inputs[0]: x}
    _, rows, cols = C.GRID
    r_loc, c_loc = rows // 2, cols // 4
    r0, c0 = r_loc, 2 * c_loc
    if mode == "cols":
        blk = {f: np.pad(np.asarray(a), ((0, 0), (h, h), (h, h)))[
            :, r0 : r0 + r_loc + 2 * h, c0 : c0 + c_loc + 2 * h] for f, a in arrays.items()}
        kw = dict(row_offset=r0 - h, rows_global=rows, col_offset=c0 - h, cols_global=cols)
        keep = (slice(None), slice(h, h + r_loc), slice(h, h + c_loc))
    else:
        blk = {f: np.pad(np.asarray(a), ((0, 0), (h, h), (0, 0)))[:, r0 : r0 + r_loc + 2 * h]
               for f, a in arrays.items()}
        kw = dict(row_offset=r0 - h, rows_global=rows)
        keep = (slice(None), slice(h, h + r_loc), slice(None))
    want = lower_pallas(p_jax, interpret=True)(
        {f: jnp.asarray(a) for f, a in blk.items()} if len(blk) > 1
        else jnp.asarray(blk[prog.inputs[0]]), **kw)
    got = tir.stencil_program_plain(
        prog, tuple(torch.from_numpy(blk[f]) for f in prog.inputs), **kw)
    want = want if isinstance(want, dict) else {prog.passthrough: want}
    got = got if isinstance(got, dict) else {prog.passthrough: got}
    for f in prog.outputs:
        np.testing.assert_allclose(got[f].numpy()[keep], np.asarray(want[f])[keep],
                                   rtol=C.TOL, atol=C.TOL, err_msg=f"{name}/k={k}/{mode}/{f}")


def test_k2_offset_mode_is_the_standalone_launch_at_zero_offsets():
    prog = tir.repeat(tir.hdiff_program(), 2)
    x = torch.from_numpy(np.array(C.make_input()))
    fn = tir.lower_cuda(prog)
    _, rows, cols = x.shape
    for kw in ({}, dict(row_offset=0, rows_global=rows),
               dict(row_offset=0, rows_global=rows, col_offset=0, cols_global=cols)):
        assert torch.equal(fn(x, **kw), fn(x))


def test_sharded_backends_need_a_mesh():
    for backend in tir.SHARDED_BACKENDS:
        with pytest.raises(ValueError, match="mesh"):
            tir.build_backend(tir.hdiff_program(), backend)
    with pytest.raises(ValueError, match="unknown inner"):
        tir.lower_sharded(tir.hdiff_program(), object(), inner="pallas")
    with pytest.raises(ValueError, match="boundary='zero'"):
        tir.lower_sharded(tir.repeat(tir.hdiff_program(), 2), object(), boundary="zero")
