"""The port's logical-axis rules (``repro_torch.dist.sharding.spec_for``)
against the JAX package's, entry for entry, on the CPU.

A table of cases: the fake-mesh cases of ``tests/test_dist.py`` (batch
folding pod, the divisibility fallback, no double assignment, kv_seq in
decode and train, the grid axes, fsdp's partial divisibility), every
``MOE_AXES`` entry at the smoke and published shapes of both MoE archs on
``(2, 4)``, ``(1, 4)``, ``(2, 16, 16)`` and ``(1, 3)`` meshes, and
indivisible dims. The port's spec is a plain tuple with the entries of the
JAX ``PartitionSpec``. Also ``shard_param``: the pieces of every rank
under a spec with tuple entries tile the tensor, and ``use_mesh`` nests.
"""

import numpy as np
import pytest
import torch

from repro.dist.sharding import spec_for as jax_spec_for
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist.sharding import (Mesh, _ambient_mesh, rank_coords, shard_param, spec_for,
                                       use_mesh)
from repro_torch.models.layers import MOE_AXES, moe_shapes


class FakeMesh:
    """Both packages' duck type: ``axis_names`` with ``devices.shape`` (JAX)
    and ``shape`` (the port)."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = tuple(shape)
        self.devices = np.empty(shape, dtype=object)


MESHES = {
    "dm2x4": ((2, 4), ("data", "model")),
    "dm1x4": ((1, 4), ("data", "model")),
    "pdm2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "dm1x3": ((1, 3), ("data", "model")),
    "dm16x16": ((16, 16), ("data", "model")),
    "rc2x4": ((2, 4), ("rows", "cols")),
    "drc2x2x2": ((2, 2, 2), ("depth", "rows", "cols")),
}

# (mesh, logical axes, shape, mode): tests/test_dist.py's cases, then
# indivisible dims and unknown names.
TABLE = [
    ("pdm2x16x16", ("batch", "seq", "embed"), (256, 4096, 1024), "train"),
    ("dm16x16", ("batch", "heads", "head_dim"), (256, 24, 128), "train"),
    ("dm16x16", ("batch", "heads", "head_dim"), (256, 64, 128), "train"),
    ("dm16x16", ("heads", "mlp"), (64, 12288), "train"),
    ("dm16x16", ("batch", "kv_seq", "kv_heads", "head_dim"), (128, 32768, 8, 128), "decode"),
    ("dm16x16", ("batch", "kv_seq", "kv_heads", "head_dim"), (128, 32768, 8, 128), "train"),
    ("dm16x16", ("batch", "kv_seq", "kv_heads", "head_dim"), (128, 32768, 16, 128), "train"),
    ("rc2x4", ("depth", "rows", "cols"), (64, 256, 256), "train"),
    ("rc2x4", ("depth", "rows", "cols"), (64, 255, 256), "train"),
    ("drc2x2x2", ("depth", "rows", "cols"), (8, 16, 16), "train"),
    ("dm2x4", ("depth", "rows", "cols"), (8, 16, 16), "train"),
    ("pdm2x16x16", ("fsdp",), (32,), "train"),
    ("pdm2x16x16", ("fsdp",), (16,), "train"),
    ("pdm2x16x16", ("fsdp",), (7,), "train"),
    ("pdm2x16x16", ("batch", "fsdp"), (32, 32), "train"),
    ("dm2x4", ("batch", "vocab"), (3, 6), "train"),
    ("dm2x4", ("blocks", "experts", None), (8, 8, 5), "train"),
    ("dm2x4", ("novel", "mlp"), (8, 8), "train"),
]


def _moe_cases():
    cases = []
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        for cfg in (get_smoke_config(arch), get_config(arch)):
            shapes = moe_shapes(cfg)
            for mesh in ("dm2x4", "dm1x4", "pdm2x16x16", "dm1x3"):
                for name, axes in MOE_AXES.items():
                    if name not in shapes:
                        continue
                    if isinstance(axes, dict):
                        cases += [(mesh, axes[n], shapes[name][n], "train") for n in axes]
                    else:
                        cases.append((mesh, axes, shapes[name], "train"))
    return cases


@pytest.mark.parametrize("case", TABLE + _moe_cases(),
                         ids=lambda c: f"{c[0]}-{'.'.join(map(str, c[1]))}-"
                                       f"{'x'.join(map(str, c[2]))}-{c[3]}")
def test_spec_for_matches_jax_entry_for_entry(case):
    mesh_key, axes, shape, mode = case
    mesh = FakeMesh(*MESHES[mesh_key])
    want = tuple(jax_spec_for(axes, mesh, shape, mode=mode))
    got = spec_for(axes, mesh, shape, mode=mode)
    assert isinstance(got, tuple) and got == want, (got, want)


def test_spec_for_refuses_mismatched_axes():
    with pytest.raises(ValueError, match="do not match shape"):
        spec_for(("batch",), FakeMesh(*MESHES["dm2x4"]), (4, 4))


def _mesh(shape, axes, rank):
    return Mesh(tuple(axes), tuple(shape), rank_coords(rank, shape), torch.device("cpu"),
                "gloo")


@pytest.mark.parametrize("shape,axes,spec", [
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model", None)),
    ((2, 4), ("data", "model"), ("model", ("data",), None)),
    ((2, 4), ("rows", "cols"), ("rows", "cols", None)),
])
def test_shard_param_pieces_tile_the_tensor(shape, axes, spec):
    """Every rank's piece, placed by its coordinates (a tuple entry's first
    axis outermost), rebuilds the tensor; ranks that differ only on axes
    the spec leaves out hold the same piece."""
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    seen = torch.zeros_like(x)
    for rank in range(int(np.prod(shape))):
        mesh = _mesh(shape, axes, rank)
        piece = shard_param(x, mesh, spec)
        idx = []
        for dim, entry in enumerate(spec):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            i, n = 0, 1
            for a in names:
                i, n = i * mesh.axis_size(a) + mesh.coord(a), n * mesh.axis_size(a)
            size = x.shape[dim] // n
            idx.append(slice(i * size, (i + 1) * size))
        assert torch.equal(piece, x[tuple(idx)])
        seen[tuple(idx)] = piece
    assert torch.equal(seen, x)


def test_shard_param_refuses_bad_specs():
    mesh = _mesh((2, 4), ("data", "model"), 0)
    with pytest.raises(ValueError, match="not divisible"):
        shard_param(torch.zeros(6, 3), mesh, ("model", None))
    with pytest.raises(ValueError, match="names an axis twice"):
        shard_param(torch.zeros(8, 8), mesh, (("data", "model"), "model"))


def test_use_mesh_nests_and_restores():
    a, b = FakeMesh(*MESHES["dm2x4"]), FakeMesh(*MESHES["dm1x4"])
    assert _ambient_mesh() is None
    with use_mesh(a):
        assert _ambient_mesh() is a
        with use_mesh(b):
            assert _ambient_mesh() is b
        assert _ambient_mesh() is a
    assert _ambient_mesh() is None
