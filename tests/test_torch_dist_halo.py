"""The port's distribution layer (``repro_torch.dist``, ``launch/mesh.py``,
``ir/plan.py::plan_partition``) against the JAX package.

The byte models, the planner and ``owned_rows_mask`` are pure arithmetic:
they are compared with the JAX functions over a grid of shapes, meshes,
halos and k, as exact integers. The exchange itself runs on a 3 x 3 gloo
mesh of 9 CPU processes (``torch_dist_harness.halo_suite``), where rank 4
has all eight neighbours: its padded blocks equal slices of the zero-padded
global array, the bytes it receives equal the per-chip models, and
``field_stats(axis_names=...)`` equals the JAX single-device stats of the
global field.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import conformance as C
import jax.numpy as jnp
import torch_dist_harness as H
from repro import dist as jdist
from repro.ir import autodiff as jad
from repro.ir import plan_partition as jax_plan_partition
from repro.ir import repeat as jrepeat
from repro.obs import field_stats as jax_field_stats
from repro.obs import host_stats as jax_host_stats
from repro_torch import dist as tdist
from repro_torch import ir as tir
from repro_torch.dist.halo import _check_band
from repro_torch.launch.mesh import make_mesh

SPAWN_TIMEOUT = 180
HALO_GRID = (2, 48, 48)
MESH_SHAPES = [(1, 1), (2, 1), (1, 3), (2, 4), (4, 2), (3, 3), (8, 1), (1, 8)]


@pytest.mark.parametrize("row_shards,col_shards", MESH_SHAPES)
def test_halo_exchange_bytes_models_match_jax(row_shards, col_shards):
    for depth, rows, cols, halo, steps, itemsize in itertools.product(
            (1, 3), (12, 48, 64), (16, 48), (0, 1, 2, 3), (1, 2, 3), (2, 4)):
        args = (depth, rows, cols, row_shards)
        kw = dict(itemsize=itemsize, halo=halo, steps=steps, col_shards=col_shards)
        assert tdist.halo_exchange_bytes(*args, **kw) == jdist.halo_exchange_bytes(*args, **kw)
        local = (depth, rows // row_shards, cols // col_shards)
        kw = dict(itemsize=itemsize, halo=halo, steps=steps, row_sharded=row_shards > 1,
                  col_sharded=col_shards > 1)
        assert (tdist.halo_exchange_bytes_per_shard(*local, **kw)
                == jdist.halo_exchange_bytes_per_shard(*local, **kw))


@pytest.mark.parametrize("name", list(C.PROGRAMS))
def test_program_byte_models_match_jax(name):
    for k in C.KS:
        tp, jp = tir.repeat(H.program(name), k), jrepeat(C.PROGRAMS[name](), k)
        assert tdist.program_exchange_radii(tp) == jdist.program_exchange_radii(jp)
        for (r_sh, c_sh), depth, itemsize in itertools.product(MESH_SHAPES, (2, 64), (2, 4)):
            rows, cols = 48, 48
            assert (tdist.program_halo_exchange_bytes(tp, depth, rows, cols, r_sh,
                                                      itemsize=itemsize, col_shards=c_sh)
                    == jdist.program_halo_exchange_bytes(jp, depth, rows, cols, r_sh,
                                                         itemsize=itemsize, col_shards=c_sh))
            local = (depth, rows // r_sh, cols // c_sh)
            kw = dict(itemsize=itemsize, row_sharded=r_sh > 1, col_sharded=c_sh > 1)
            assert (tdist.program_halo_exchange_bytes_per_shard(tp, *local, **kw)
                    == jdist.program_halo_exchange_bytes_per_shard(jp, *local, **kw))


@pytest.mark.parametrize("name", list(C.PROGRAMS))
def test_gradient_byte_model_matches_jax(name):
    from repro.dist.halo import gradient_halo_exchange_bytes_per_shard as jax_grad_bytes

    for k in C.KS:
        tp, jp = tir.repeat(H.program(name), k), jrepeat(C.PROGRAMS[name](), k)
        for mesh_shape, depth in itertools.product(MESH_SHAPES, (2, 64)):
            assert (tdist.gradient_halo_exchange_bytes_per_shard(
                tp, depth, 48, 48, mesh_shape=mesh_shape)
                == jax_grad_bytes(jp, depth, 48, 48, mesh_shape=mesh_shape))
        # The whole-mesh form: the same rounds, each under the whole-mesh model.
        want = sum(jdist.program_halo_exchange_bytes(q, 2, 48, 48, 2, col_shards=4)
                   for q in _jax_gradient_rounds(jp))
        assert tdist.gradient_halo_exchange_bytes(tp, 2, 48, 48, mesh_shape=(2, 4)) == want


def _jax_gradient_rounds(p):
    """The programs whose exchange rounds a value-and-grad step runs, by the
    rule of the JAX package's ``gradient_halo_exchange_bytes_per_shard``."""
    chain = p.chain
    needs_state = any(
        jad.cache_fields(q)
        or any(r.field in q.inputs for op in jad.adjoint(q).ops for r in op.reads)
        for q in chain)
    rounds = [p]
    for i, q in enumerate(chain):
        if jad.cache_fields(q):
            rounds.append(jad.augmented_forward(q))
        elif needs_state and i < len(chain) - 1:
            rounds.append(q)
        rounds.append(jad.adjoint(q))
    return rounds


@pytest.mark.parametrize("name", list(C.PROGRAMS))
def test_plan_partition_matches_jax(name):
    for k in C.KS:
        tp, jp = tir.repeat(H.program(name), k), jrepeat(C.PROGRAMS[name](), k)
        for (depth, rows, cols), n in itertools.product(
                ((2, 48, 48), (64, 256, 256), (4, 4, 256), (3, 96, 24), (8, 12, 60)),
                (1, 2, 4, 6, 8, 12, 16)):
            try:
                want = jax_plan_partition(jp, depth, rows, cols, n)
            except ValueError as e:
                with pytest.raises(ValueError, match="no rows x cols factorization"):
                    tir.plan_partition(tp, depth, rows, cols, n)
                assert "no rows x cols factorization" in str(e)
                continue
            got = tir.plan_partition(tp, depth, rows, cols, n)
            assert (got.row_shards, got.col_shards, got.halo, got.wire_bytes) == (
                want.row_shards, want.col_shards, want.halo, want.wire_bytes)
            assert got.mesh_shape == want.mesh_shape


def test_plan_partition_paper_grid_over_eight_devices():
    plan = tir.plan_partition(tir.hdiff_program(), 64, 256, 256, 8)
    assert plan.mesh_shape == (4, 2) and plan.wire_bytes == 1_060_864
    assert isinstance(plan, tir.Partition2D)


@pytest.mark.parametrize("halo", [1, 2, 3])
def test_owned_rows_mask_matches_jax(halo):
    for n_shards, rows_local in itertools.product((1, 2, 4, 8), (2, 5, 16)):
        for shard in range(n_shards):
            got = tdist.owned_rows_mask(shard, rows_local, rows_local * n_shards, halo)
            want = jdist.owned_rows_mask(shard, rows_local, rows_local * n_shards, halo)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_check_band_names_the_remedy():
    _check_band(4, 4, "rows")
    with pytest.raises(ValueError, match="shard the other grid axis instead"):
        _check_band(3, 4, "rows")


def test_make_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((2, 4), ("rows", "cols"), backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        make_mesh((2, 4), ("rows", "cols"), backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 4), ("rows",), backend="gloo", device="cpu")


# -- the 3 x 3 gloo mesh ---------------------------------------------------------


@pytest.fixture(scope="module")
def halo_runs(tmp_path_factory):
    rng = np.random.default_rng(C.SEED)
    x = rng.standard_normal(HALO_GRID).astype(np.float32)
    poisoned = rng.standard_normal((4, 48, 48)).astype(np.float32)
    poisoned[0, 10, 20] = np.nan  # the counts must sum across ranks
    poisoned[1, 40, 30] = np.inf
    poisoned[2, 5, 47] = -np.inf
    poisoned[3, 20, 20] = 37.5  # the global max, on one shard only
    runs = H.run_ranks(H.halo_suite, 9, tmp_path_factory.mktemp("halo"), x, poisoned,
                       tuple(C.PROGRAMS), timeout=SPAWN_TIMEOUT)
    return {"ranks": runs, "x": x, "poisoned": poisoned}


def test_exchange_pads_edges_with_zeros_and_routes_every_band(halo_runs):
    for res in halo_runs["ranks"]:
        for h, (two_d, rows, cols) in res["exchange"].items():
            assert two_d and rows and cols, (res["coords"], h)


def test_exchange_rejects_a_fine_mesh(halo_runs):
    for res in halo_runs["ranks"]:
        assert "rows/shard 4 < halo 6" in res["fine"]
        assert "use fewer rows shards, shard the other grid axis instead" in res["fine"]


@pytest.mark.parametrize("name", list(C.PROGRAMS))
def test_interior_rank_receives_the_per_chip_model(halo_runs, name):
    ranks = halo_runs["ranks"]
    interior = next(r for r in ranks if r["coords"] == (1, 1))
    d, rows, cols = HALO_GRID
    for k in C.KS:
        jp = jrepeat(C.PROGRAMS[name](), k)
        model = jdist.program_halo_exchange_bytes_per_shard(
            jp, d, rows // 3, cols // 3, row_sharded=True, col_sharded=True)
        assert interior["recv"][(name, k)] == model > 0  # ratio 1.000
        assert all(r["recv"][(name, k)] < model for r in ranks if r is not interior)
        from repro.dist.halo import gradient_halo_exchange_bytes_per_shard as jax_grad_bytes

        assert interior["grad_recv"][(name, k)] == jax_grad_bytes(
            jp, d, rows, cols, mesh_shape=(3, 3))


def test_wire_drift_report_is_exact(halo_runs):
    for res in halo_runs["ranks"]:
        measured, model, ok = res["drift"]
        assert ok and measured == model > 0


def test_gradient_wire_drift_report_is_exact(halo_runs):
    for res in halo_runs["ranks"]:
        measured, model, ok = res["grad_drift"]
        assert ok and measured == model > 0


def test_mesh_shape_lowering_records_the_halo_model(halo_runs):
    d, rows, cols = HALO_GRID
    per_chip = jdist.program_halo_exchange_bytes_per_shard(
        jrepeat(C.PROGRAMS["hdiff"](), 2), d, rows // 3, cols // 3, row_sharded=True,
        col_sharded=True)
    for res in halo_runs["ranks"]:
        assert res["mesh_shape_equal"] and res["backend_mesh_shape_equal"]
        assert res["counters"]["halo.exchange_rounds"] == 1
        assert res["counters"]["halo.model_bytes.psi"] == per_chip
        assert res["counters"]["ir.lower_sharded.hdiff_x2.calls"] == 1
        assert res["events"].count("halo.exchange") == 1


def test_field_stats_over_mesh_axes_equal_single_device_stats(halo_runs):
    p = halo_runs["poisoned"]
    want = jax_host_stats(jax_field_stats(jnp.asarray(p)))
    assert want["nan_count"] == 1 and want["inf_count"] == 2 and want["max"] == 37.5
    for res in halo_runs["ranks"]:
        got = res["stats"]
        for key in ("size", "nan_count", "inf_count", "min", "max"):
            assert got[key] == want[key], (key, got[key], want[key])
        for key in ("mean", "l2"):  # tests/multidev/_health_check.py's bound
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
        # One axis: the stats of this rank's column slab of the mesh.
        j = res["coords"][1]
        slab = jax_host_stats(jax_field_stats(jnp.asarray(p[:, :, j * 16 : (j + 1) * 16])))
        for key in ("size", "nan_count", "inf_count", "min", "max"):
            assert res["stats_rows"][key] == slab[key], key
        for key in ("mean", "l2"):
            np.testing.assert_allclose(res["stats_rows"][key], slab[key], rtol=1e-6, atol=1e-6)


def test_make_mesh_checks_the_world_size(halo_runs):
    for res in halo_runs["ranks"]:
        assert "mesh (2, 4) needs 8 ranks, the group has 9" in res["bad_mesh"]


def test_exchange_counts_bytes_without_a_group():
    # A 1x1 mesh moves nothing: zero pads, zero bytes, no collective.
    mesh = tdist.Mesh(("rows", "cols"), (1, 1), (0, 0), torch.device("cpu"), "gloo")
    x = torch.randn(2, 5, 7)
    with tdist.count_wire() as c:
        y = tdist.exchange_halos_2d(x, mesh, "rows", "cols", 3)
    assert torch.equal(y, torch.nn.functional.pad(x, (3, 3, 3, 3)))
    assert (c.sent_bytes, c.recv_bytes, c.sent_messages) == (0, 0, 0)
