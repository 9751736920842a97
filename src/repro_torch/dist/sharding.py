"""The stencil grid's device mesh on ``torch.distributed``.

The port's copy of the grid part of ``repro/dist/sharding.py``. A JAX mesh
is a named array of devices that ``shard_map`` maps a program over; here
every rank of an initialised process group is one shard, and :class:`Mesh`
names the ranks' layout: the axis names in declaration order, the shape,
this rank's coordinates, the process group, the device the rank computes
on and the collective backend (``"nccl"`` or ``"gloo"``). Ranks map to
coordinates row-major in declaration order (the last axis varies fastest),
the numbering ``jax.lax.ppermute`` gives the flattened pairs of a
multi-axis mesh — explicit here, see :meth:`Mesh.rank_of`.

:func:`shard_block` slices this rank's block out of a global array and
:func:`gather_blocks` assembles the global array from every rank's block;
both are for tests and drivers (the halo exchange's wire counter never
sees them).

The LM logical-axis rules of the JAX module (``spec_for``,
``tree_shardings``, ``constrain``) belong to the LM substrate and are not
ported here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def rank_coords(rank: int, shape: Sequence[int]) -> tuple[int, ...]:
    """The coordinates of ``rank`` on a mesh of ``shape``, row-major (the
    last axis varies fastest)."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a named mesh of ranks.

    ``group`` is the default process group, which the mesh spans: the
    mesh's rank ``i`` is that group's rank ``i`` (what ``isend`` and
    ``irecv`` address)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device
    backend: str
    group: object = None
    _axis_groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh {self.axis_names} has no axis {axis!r}")
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    def rank_of(self, coords: Sequence[int]) -> int:
        """The mesh rank at ``coords`` (one per axis, declaration order)."""
        rank = 0
        for c, n in zip(coords, self.shape):
            if not 0 <= c < n:
                raise ValueError(f"coordinates {tuple(coords)} outside mesh {self.shape}")
            rank = rank * n + c
        return rank

    def coords_of(self, rank: int) -> tuple[int, ...]:
        return rank_coords(rank, self.shape)

    def shifted(self, shifts: dict[str, int]) -> int | None:
        """The rank whose coordinates differ from this rank's by ``shifts``
        (axis name -> step), or None past the mesh edge."""
        coords = list(self.coords)
        for axis, step in shifts.items():
            i = self._axis(axis)
            coords[i] += step
            if not 0 <= coords[i] < self.shape[i]:
                return None
        return self.rank_of(coords)

    def axis_group(self, axes: Sequence[str]):
        """The process group of the ranks that share this rank's coordinates
        on every axis not in ``axes`` (``None`` when that is the whole
        mesh's group). Built at first use: every rank of the mesh must ask
        for the same ``axes`` in the same order, as SPMD code does."""
        for a in axes:
            self._axis(a)
        key = tuple(a for a in self.axis_names if a in axes)
        others = [i for i, a in enumerate(self.axis_names)
                  if a not in key and self.shape[i] > 1]
        if not others:
            return self.group
        if key not in self._axis_groups:
            mine = None
            # new_group is collective over the whole mesh: every rank creates
            # every group of the partition, in one order.
            fixed_shape = [self.shape[i] for i in others]
            for flat in range(math.prod(fixed_shape)):
                fixed = dict(zip(others, rank_coords(flat, fixed_shape)))
                members = [r for r in range(self.size)
                           if all(self.coords_of(r)[i] == c for i, c in fixed.items())]
                g = dist.new_group(members, backend=self.backend)
                if all(self.coords[i] == c for i, c in fixed.items()):
                    mine = g
            self._axis_groups[key] = mine
        return self._axis_groups[key]


def _mesh_sizes(mesh: Mesh) -> dict[str, int]:
    """``{axis name: size}`` in declaration order."""
    return dict(zip(mesh.axis_names, mesh.shape))


def stage_collective(mesh: Mesh, t: Tensor) -> bool:
    """Whether ``t`` goes through a host copy for a collective on ``mesh``:
    gloo is handed CPU tensors only (the one-card machine runs several gloo
    ranks on one card and stages every band through host memory)."""
    return mesh.backend == "gloo" and t.device.type != "cpu"


def all_reduce(t: Tensor, op, mesh: Mesh, group=None) -> Tensor:
    """``dist.all_reduce`` of ``t`` over ``group`` (default: the mesh's),
    staged through the host under gloo; returns the reduced tensor on
    ``t``'s device."""
    group = mesh.group if group is None else group
    if stage_collective(mesh, t):
        host = t.detach().to("cpu")
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    t = t.detach().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def _block_index(shape: Sequence[int], mesh: Mesh, spec: Sequence[str | None],
                 coords: Sequence[int]) -> tuple[slice, ...]:
    idx = []
    for dim, axis in zip(range(len(shape) - len(spec), len(shape)), spec):
        if axis is None:
            idx.append(slice(None))
            continue
        n = mesh.axis_size(axis)
        size = shape[dim] // n
        c = coords[mesh._axis(axis)]
        idx.append(slice(c * size, (c + 1) * size))
    return (Ellipsis, *idx)


def _check_spec(shape, mesh: Mesh, spec) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than shape {tuple(shape)}")
    named = [a for a in spec if a is not None]
    if len(set(named)) != len(named):
        raise ValueError(f"spec {tuple(spec)} names an axis twice")
    for dim, axis in zip(range(len(shape) - len(spec), len(shape)), spec):
        if axis is not None and shape[dim] % mesh.axis_size(axis):
            raise ValueError(
                f"dim {dim} of {tuple(shape)} not divisible by {mesh.axis_size(axis)} "
                f"{axis!r} shards"
            )


def shard_block(x: Tensor, mesh: Mesh, spec: Sequence[str | None] = (None, "rows", "cols")
                ) -> Tensor:
    """This rank's block of the global tensor ``x``: ``spec`` names the mesh
    axis that splits each trailing dim (``None``: not split), like a
    ``PartitionSpec``. Returns a contiguous copy."""
    _check_spec(x.shape, mesh, spec)
    return x[_block_index(x.shape, mesh, spec, mesh.coords)].contiguous()


def gather_blocks(block: Tensor, mesh: Mesh,
                  spec: Sequence[str | None] = (None, "rows", "cols")) -> Tensor:
    """The global tensor assembled from every rank's ``block`` (the inverse
    of :func:`shard_block`), on every rank, on ``block``'s device. A
    collective over the mesh; never counted as halo traffic."""
    shape = list(block.shape)
    for dim, axis in zip(range(len(shape) - len(spec), len(shape)), spec):
        if axis is not None:
            shape[dim] *= mesh.axis_size(axis)
    staged = stage_collective(mesh, block)
    src = block.detach().to("cpu") if staged else block.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.empty(shape, dtype=block.dtype, device=src.device)
    for r, part in enumerate(parts):
        out[_block_index(shape, mesh, spec, mesh.coords_of(r))] = part
    return out.to(block.device) if staged else out

