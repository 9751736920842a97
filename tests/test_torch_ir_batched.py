"""The port's batched lowering (``repro_torch.ir.lower_batched``) against the
JAX package's.

Cells are ``tests/conformance.py``'s batched ones: ``BATCHED_PROGRAMS`` x
{reference, cuda} x ``BATCHED_KS``, ``BATCH_MEMBERS`` members made by
``make_batched_fields``. In each cell member i of the port's batched result
is bit-equal to the port's unbatched call on the same backend (the fold
into depth must not change what any member computes), and within ``TOL``
of JAX ``lower_batched`` on the same numpy inputs (``reference``, and
``pallas`` in interpret mode for ``cuda``, whose CPU path is K2's plain
version).

The sharded cells run on 8 gloo ranks (``torch_dist_harness
.lower_batched_suite``, one spawn for the file) on the 2x4 mesh, both
inners, k = 1 and 2: each member bit-equal to the unbatched sharded call,
within ``TOL`` of JAX ``lower_batched`` on 8 fake devices (one subprocess,
``tests/torch_jax_batched.py``), and the bytes sent per round exactly
``BATCH_MEMBERS`` times one unbatched member's. k = 1 also runs on a
2x2x2 data x rows x cols mesh and through ``mesh_shape=(2, 4)``.

The validation tests mirror ``tests/test_ir_batched.py``'s.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import conformance as C
import repro.ir as jir
import repro_torch.ir as tir
import torch_dist_harness as H
from repro_torch.interop import to_numpy
from repro_torch.obs import events, metrics

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 300
JAX_TIMEOUT = 300
JAX_BACKEND = {"reference": "reference", "cuda": "pallas"}


@pytest.fixture(autouse=True)
def _metrics_on():
    # Instrumented, as the JAX package's batched cells run.
    with metrics.using(), events.using():
        yield


def _np(x):
    return {f: np.asarray(a) for f, a in x.items()} if isinstance(x, dict) else np.asarray(x)


def _tensors(x):
    if isinstance(x, dict):
        return {f: torch.from_numpy(np.array(a)) for f, a in x.items()}
    return torch.from_numpy(np.array(x))


def _member(x, i):
    return {f: a[i] for f, a in x.items()} if isinstance(x, dict) else x[i]


SINGLE_DEV_CELLS = [
    pytest.param(name, backend, k, id=f"{name}-{backend}-k{k}")
    for name in C.BATCHED_PROGRAMS
    for backend in ("reference", "cuda")
    for k in C.BATCHED_KS
]


@pytest.mark.parametrize("name,backend,k", SINGLE_DEV_CELLS)
def test_batched_conformance_1x1(name, backend, k):
    prog = tir.repeat(H.program(name), k)
    fields = C.make_batched_fields(name)
    got = tir.lower_batched(prog, backend=backend)(_tensors(fields))
    base = tir.build_backend(prog, backend)
    want = C.to_host(C.build_batched(jir.repeat(C.PROGRAMS[name](), k), JAX_BACKEND[backend],
                                     (1, 1))(fields))
    tag = f"{name}/{backend}/k={k}"
    for i in range(C.BATCH_MEMBERS):
        got_i = to_numpy(_member(got, i))
        C.assert_equal(got_i, to_numpy(base(_tensors(_member(_np(fields), i)))),
                       err_msg=f"{tag}/member={i} (vs the port's unbatched call)")
        C.assert_close(got_i, C.member_slice(want, i),
                       err_msg=f"{tag}/member={i} (vs JAX lower_batched)")


def test_batched_member_slice_shapes():
    fields = _tensors(C.make_batched_fields("shallow_water", members=2, grid=(2, 16, 16)))
    out = tir.lower_batched(tir.shallow_water_program())(fields)
    assert set(out) == set(tir.shallow_water_program().outputs)
    for f, a in out.items():
        assert a.shape == (2, 2, 16, 16), (f, a.shape)
    m0 = C.member_slice(out, 0)
    assert all(v.shape == (2, 16, 16) for v in m0.values())


def test_batched_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown batched backend"):
        tir.lower_batched(tir.hdiff_program(), backend="staged")


def test_batched_rejects_mesh_on_single_device_backend():
    with pytest.raises(ValueError, match="single-device"):
        tir.lower_batched(tir.hdiff_program(), backend="cuda", mesh_shape=(1, 1))
    with pytest.raises(ValueError, match="single-device"):
        tir.lower_batched(tir.hdiff_program(), backend="reference", mesh=object())


def test_batched_sharded_requires_mesh():
    with pytest.raises(ValueError, match="mesh_shape"):
        tir.lower_batched(tir.hdiff_program(), backend="sharded-reference")


def test_batched_rejects_unbatched_input():
    fn = tir.lower_batched(tir.hdiff_program())
    with pytest.raises(ValueError, match="members, depth, rows, cols"):
        fn(torch.zeros((2, 16, 16)))


def test_batched_rejects_missing_field():
    fn = tir.lower_batched(tir.shallow_water_program())
    with pytest.raises(ValueError, match="missing input"):
        fn({"u": torch.zeros((2, 2, 16, 16))})


def test_batched_rejects_bare_tensor_for_multi_input():
    with pytest.raises(ValueError, match="pass a mapping"):
        tir.lower_batched(tir.shallow_water_program())(torch.zeros((2, 2, 16, 16)))


def test_batched_rejects_ragged_members():
    fn = tir.lower_batched(tir.shallow_water_program())
    fields = _tensors(C.make_batched_fields("shallow_water", members=2, grid=(2, 16, 16)))
    fields["h"] = torch.zeros((3, 2, 16, 16))
    with pytest.raises(ValueError, match="share one"):
        fn(fields)


def test_batched_rejects_1d_programs():
    with pytest.raises(ValueError, match="2-D programs"):
        tir.lower_batched(tir.jacobi1d_program())


def test_batched_backends_exports():
    assert set(tir.BATCHED_BACKENDS) == {
        "reference", "cuda", "sharded-reference", "sharded-cuda",
    }
    # The JAX package's names, with cuda for pallas.
    assert {b.replace("cuda", "pallas") for b in tir.BATCHED_BACKENDS} == set(
        jir.BATCHED_BACKENDS)


def test_batched_single_member_matches_unbatched():
    got = tir.lower_batched(tir.hdiff_program())(
        _tensors(C.make_batched_fields("hdiff", members=1)))
    want = tir.lower_reference(tir.hdiff_program())(_tensors(C.make_fields("hdiff")))
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_batched_call_is_instrumented_under_the_jax_name(backend):
    fn = tir.lower_batched(tir.hdiff_program(), backend=backend)
    assert fn.metric_name == f"ir.lower_batched.hdiff.{backend}"
    fn(torch.zeros((2, 2, 16, 16)))
    assert metrics.current().counters[f"ir.lower_batched.hdiff.{backend}.calls"] == 1


def test_batched_bf16_members_match_unbatched():
    prog = tir.repeat(tir.hdiff_program(), 2)
    x = _tensors(C.make_batched_fields("hdiff")).to(torch.bfloat16)
    got = tir.lower_batched(prog, backend="cuda")(x)
    assert got.dtype == torch.bfloat16
    for i in range(x.shape[0]):
        assert torch.equal(got[i], tir.lower_cuda(prog)(x[i]))


def test_batched_non_contiguous_members_fold_by_copy():
    """A member axis that is not outermost in memory is folded through a
    copy: the result is the same as for a contiguous batch."""
    x = _tensors(C.make_batched_fields("hdiff"))
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    fn = tir.lower_batched(tir.hdiff_program(), backend="cuda")
    assert torch.equal(fn(strided), fn(x))


# -- sharded cells: 8 gloo ranks against JAX on 8 fake devices ------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's results and the JAX subprocess's, computed once for the
    file (both run at the same time)."""
    tmp = tmp_path_factory.mktemp("batched")
    inputs = {name: _np(C.make_batched_fields(name)) for name in C.BATCHED_PROGRAMS}
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    jax_proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_jax_batched.py"), str(tmp / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = H.start_ranks(H.lower_batched_suite, 8, tmp, inputs, C.BATCH_MEMBERS,
                          timeout=SPAWN_TIMEOUT)
    try:
        out, err = jax_proc.communicate(timeout=JAX_TIMEOUT)
    finally:
        jax_proc.kill()
    results = ranks.join()[0]
    assert jax_proc.returncode == 0 and "JAX_BATCHED_OK" in out, err
    with np.load(tmp / "jax.npz") as z:
        results["jax"] = dict(z)
    return results


SHARDED_CELLS = [(name, k, inner) for name in C.BATCHED_PROGRAMS for k in C.BATCHED_KS
                 for inner in ("reference", "cuda")]
SHARDED_IDS = [f"{n}-k{k}-{i}" for n, k, i in SHARDED_CELLS]


def _jax(runs, name, k, inner):
    backend = f"sharded-{JAX_BACKEND[inner]}"
    want = {key.split("/")[3]: a for key, a in runs["jax"].items()
            if key.startswith(f"{name}/{k}/{backend}/")}
    return want[""] if "" in want else want


@pytest.mark.parametrize("name,k,inner", SHARDED_CELLS, ids=SHARDED_IDS)
def test_sharded_batched_members_bit_equal_to_unbatched(runs, name, k, inner):
    assert runs["members_equal"][("2x4", name, k, inner)]


@pytest.mark.parametrize("name,k,inner", SHARDED_CELLS, ids=SHARDED_IDS)
def test_sharded_batched_within_tol_of_jax_lower_batched(runs, name, k, inner):
    got, want = runs["fwd"][("2x4", name, k, inner)], _jax(runs, name, k, inner)
    for i in range(C.BATCH_MEMBERS):
        C.assert_close(C.member_slice(got, i), C.member_slice(want, i),
                       err_msg=f"{name}/k={k}/2x4/{inner}/member={i} vs JAX lower_batched")


@pytest.mark.parametrize("name,k,inner", SHARDED_CELLS, ids=SHARDED_IDS)
def test_sharded_batched_wire_bytes_are_members_times_unbatched(runs, name, k, inner):
    batched, per_member = runs["wire"][("2x4", name, k, inner)]
    assert len(set(per_member)) == 1 and per_member[0] > 0, per_member
    assert batched == C.BATCH_MEMBERS * per_member[0], (batched, per_member)
    depth, rows, cols = C.GRID
    from repro_torch.dist import program_halo_exchange_bytes

    assert per_member[0] == program_halo_exchange_bytes(
        tir.repeat(H.program(name), k), depth, rows, cols, 2, col_shards=4)


@pytest.mark.parametrize("mesh", ["2x2x2", "mesh_shape"])
@pytest.mark.parametrize("inner", ["reference", "cuda"])
@pytest.mark.parametrize("name", C.BATCHED_PROGRAMS)
def test_sharded_batched_other_meshes(runs, mesh, inner, name):
    """A depth axis (members fold into the local depth after its split) and
    the ``mesh_shape=`` route: members bit-equal to the unbatched call on
    the same mesh, within TOL of the JAX package's 2x4 result, and the
    bytes N times an unbatched member's."""
    key = (mesh, name, 1, inner)
    assert runs["members_equal"][key]
    batched, per_member = runs["wire"][key]
    assert batched == C.BATCH_MEMBERS * per_member[0] and per_member[0] > 0
    want = _jax(runs, name, 1, inner)
    for i in range(C.BATCH_MEMBERS):
        C.assert_close(C.member_slice(runs["fwd"][key], i), C.member_slice(want, i),
                       err_msg=f"{name}/{mesh}/{inner}/member={i}")


def test_forecast_server_on_a_sharded_backend(runs):
    """Each rank serves its blocks of 3 hdiff members through
    ``ForecastServer(backend="sharded-cuda", mesh_shape=(2, 4))``: one batch,
    results equal to the batched lowering on the same blocks."""
    assert runs["served"]
