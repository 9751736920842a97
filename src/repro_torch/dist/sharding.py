"""The port's ``repro/dist/sharding.py``: rank meshes on
``torch.distributed`` and the logical-axis rules.

**Meshes.** A JAX mesh is a named array of devices that ``shard_map`` maps
a program over; here every rank of an initialised process group is one
shard, and :class:`Mesh` names the ranks' layout: the axis names in
declaration order, the shape, this rank's coordinates, the process group,
the device the rank computes on and the collective backend (``"nccl"`` or
``"gloo"``). Ranks map to coordinates row-major in declaration order (the
last axis varies fastest), the numbering ``jax.lax.ppermute`` gives the
flattened pairs of a multi-axis mesh — explicit here, see
:meth:`Mesh.rank_of`.

**Pieces.** :func:`shard_param` slices this rank's piece out of a global
tensor under a spec (one entry per trailing dim: ``None``, a mesh axis, or
a tuple of axes that split the dim together, the first outermost; a
stencil grid's is ``(None, "rows", "cols")``) and :func:`gather_blocks`
joins the pieces again. Both are for tests and drivers (the halo
exchange's wire counter never sees them).

**Rules.** :func:`spec_for` maps a tensor's logical axes (``batch``,
``fsdp``, ``experts``, ``mlp``, ...) to one spec entry per dim, by the JAX
package's rules (its ``PartitionSpec`` entries, as a plain tuple): batch
and fsdp fold the data axes ``("pod", "data")``, dropping pod first when
the dim does not divide; heads, mlp, experts, vocab and blocks take
``"model"``; kv_seq takes it in decode only; depth, rows and cols take the
mesh axis of their own name; an indivisible dim, or an axis already taken
to its left, replicates. :func:`use_mesh` installs an *ambient mesh* that
deep model code reads (:func:`_ambient_mesh`) without a mesh argument: the
MoE takes its expert-parallel path under one.

**Collectives with gradients.** :func:`gather_dim`, :func:`copy_to`,
:func:`sum_over` and :func:`mean_over` are the collectives the
expert-parallel MoE runs, written as autograd Functions (a plain
collective carries no gradient): a gather's backward sums the gradient
over the axes the caller names and keeps this rank's piece; *copy_to* is
the identity forward and a sum backward, *sum_over* the reverse (the
Megatron f and g).

Not ported: ``tree_shardings``, ``sharding_for`` and ``constrain``, which
place whole parameter trees and annotate intermediates for the GSPMD
partitioner (ROADMAP M13b.3b).
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.obs import metrics

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


def _wire(t: Tensor, mesh: Mesh) -> Tensor:
    """``t`` as a collective sends it: detached and contiguous, copied to
    the host under gloo (:func:`stage_collective`)."""
    return t.detach().to("cpu") if stage_collective(mesh, t) else t.detach().contiguous()


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


def _entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, an axis, or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _piece(mesh: Mesh, axes: Sequence[str], coords: Sequence[int]) -> tuple[int, int]:
    """``(index, count)`` of the piece of a dim split over ``axes`` (the
    first outermost) that the rank at ``coords`` holds."""
    index, count = 0, 1
    for a in axes:
        n = mesh.axis_size(a)
        index, count = index * n + coords[mesh._axis(a)], count * n
    return index, count


def _block_index(shape: Sequence[int], mesh: Mesh, spec: Sequence,
                 coords: Sequence[int]) -> tuple[slice, ...]:
    idx = []
    for dim, entry in zip(range(len(shape) - len(spec), len(shape)), spec):
        index, count = _piece(mesh, _entry_axes(entry), coords)
        size = shape[dim] // count
        idx.append(slice(index * size, (index + 1) * size))
    return (Ellipsis, *idx)


def _check_spec(shape, mesh: Mesh, spec) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than shape {tuple(shape)}")
    named = [a for entry in spec for a in _entry_axes(entry)]
    if len(set(named)) != len(named):
        raise ValueError(f"spec {tuple(spec)} names an axis twice")
    for dim, entry in zip(range(len(shape) - len(spec), len(shape)), spec):
        count = _piece(mesh, _entry_axes(entry), mesh.coords)[1]
        if shape[dim] % count:
            raise ValueError(
                f"dim {dim} of {tuple(shape)} not divisible by {count} {entry!r} shards"
            )


def shard_param(x: Tensor, mesh: Mesh, spec: Sequence) -> Tensor:
    """This rank's piece of the global tensor ``x`` under ``spec``: one entry
    per trailing dim, ``None`` (whole), a mesh axis, or a tuple of axes that
    split the dim together, the first outermost (a ``PartitionSpec``
    entry, as :func:`spec_for` gives). Returns a contiguous copy."""
    _check_spec(x.shape, mesh, spec)
    return x[_block_index(x.shape, mesh, spec, mesh.coords)].contiguous()


def gather_blocks(block: Tensor, mesh: Mesh,
                  spec: Sequence[str | None] = (None, "rows", "cols")) -> Tensor:
    """The global tensor assembled from every rank's ``block`` (the inverse
    of :func:`shard_param`), on every rank, on ``block``'s device. A
    collective over the mesh; never counted as halo traffic."""
    shape = list(block.shape)
    for dim, entry in zip(range(len(shape) - len(spec), len(shape)), spec):
        shape[dim] *= _piece(mesh, _entry_axes(entry), mesh.coords)[1]
    src = _wire(block, mesh)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.empty(shape, dtype=block.dtype, device=src.device)
    for r, part in enumerate(parts):
        out[_block_index(shape, mesh, spec, mesh.coords_of(r))] = part
    return out.to(block.device)



# -- ambient mesh -----------------------------------------------------------------

_AMBIENT: ContextVar[Any] = ContextVar("repro_torch_ambient_mesh", default=None)


def _ambient_mesh():
    """The mesh installed by :func:`use_mesh`, or None."""
    return _AMBIENT.get()


@contextmanager
def use_mesh(mesh):
    """Context manager installing ``mesh`` as the ambient mesh."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


# -- rule engine --------------------------------------------------------------------

# Mesh axes that carry batch/data parallelism, outermost first.
_DATA_AXES = ("pod", "data")

# Logical axes that ride the model (tensor-parallel) axis unconditionally.
_MODEL_LOGICAL = ("heads", "kv_heads", "mlp", "experts", "vocab", "blocks")

# Logical axes that are always replicated.
_REPLICATED = ("seq", "embed", "head_dim")

# Stencil-grid logical axes: shard over the mesh axis of the SAME name.
_GRID_LOGICAL = ("depth", "rows", "cols")


def _fold_data_axes(dim: int, sizes: dict[str, int], used: set[str]) -> tuple[str, ...]:
    """Longest suffix of ("pod", "data") present+unused whose product
    divides ``dim``; pod is dropped first (partial divisibility)."""
    axes = tuple(a for a in _DATA_AXES if a in sizes and a not in used)
    while axes:
        if dim % math.prod(sizes[a] for a in axes) == 0:
            return axes
        axes = axes[1:]
    return ()


def _take_model(dim: int, sizes: dict[str, int], used: set[str]) -> str | None:
    if "model" in sizes and "model" not in used and dim % sizes["model"] == 0:
        return "model"
    return None


def _assign(name, dim: int, sizes: dict[str, int], used: set[str], mode: str):
    """One spec entry for one (logical axis, dim). Mutates ``used``."""
    if name is None or name in _REPLICATED:
        return None
    if name in ("batch", "fsdp"):
        axes = _fold_data_axes(dim, sizes, used)
        if not axes:
            return None
        used.update(axes)
        # One axis is the bare name, as a PartitionSpec normalises a
        # one-axis tuple entry (the JAX rule's fsdp tuple included).
        return axes if len(axes) > 1 else axes[0]
    if name in _MODEL_LOGICAL or (name == "kv_seq" and mode == "decode"):
        ax = _take_model(dim, sizes, used)
        if ax:
            used.add(ax)
        return ax
    if name in _GRID_LOGICAL and name in sizes and name not in used and dim % sizes[name] == 0:
        used.add(name)
        return name
    # kv_seq in train, an indivisible grid dim, an unknown name: replicated.
    return None


def spec_for(logical_axes: Sequence[str | None], mesh, shape: Sequence[int],
             mode: str = "train") -> tuple:
    """The spec of a tensor with ``logical_axes`` and ``shape`` on ``mesh``
    (a :class:`Mesh` or anything with ``axis_names`` and ``shape``): one
    entry per dim, ``None``, a mesh axis or a tuple of axes, the entries of
    the JAX package's ``PartitionSpec``. Each mesh axis is taken at most
    once, by the leftmost logical axis that can take it."""
    if len(logical_axes) != len(shape):
        raise ValueError(
            f"logical axes {tuple(logical_axes)} do not match shape {tuple(shape)}")
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    return tuple(_assign(name, int(dim), sizes, used, mode)
                 for name, dim in zip(logical_axes, shape))


# -- collectives with gradients --------------------------------------------------------


def _group_members(mesh: Mesh, axes: Sequence[str]) -> list[int]:
    """The mesh ranks of this rank's group over ``axes`` (those that share
    its coordinates on every other axis), in rank order: the order
    ``dist.all_gather`` returns their tensors in."""
    fixed = [i for i, a in enumerate(mesh.axis_names) if a not in axes]
    return [r for r in range(mesh.size)
            if all(mesh.coords_of(r)[i] == mesh.coords[i] for i in fixed)]


def _all_gather_dim(t: Tensor, mesh: Mesh, axes: tuple[str, ...], dim: int) -> Tensor:
    """The pieces of ``t`` held by this rank's group over ``axes``,
    concatenated along ``dim``, each placed by its coordinates on ``axes``
    (the first outermost): the inverse of :func:`shard_param`."""
    members = _group_members(mesh, axes)
    src = _wire(t, mesh)
    parts = [torch.empty_like(src) for _ in members]
    dist.all_gather(parts, src, group=mesh.axis_group(axes))
    order = sorted(range(len(members)),
                   key=lambda i: _piece(mesh, axes, mesh.coords_of(members[i]))[0])
    return torch.cat([parts[i] for i in order], dim=dim).to(t.device)


def _all_reduce_sum(t: Tensor, mesh: Mesh, axes: tuple[str, ...]) -> Tensor:
    return all_reduce(t, dist.ReduceOp.SUM, mesh, mesh.axis_group(axes))


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, sum_axes):
        ctx.mesh, ctx.axes, ctx.dim, ctx.sum_axes = mesh, axes, dim, sum_axes
        return _all_gather_dim(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        if ctx.sum_axes:
            g = _all_reduce_sum(g, mesh, ctx.sum_axes)
        index, count = _piece(mesh, axes, mesh.coords)
        size = g.shape[dim] // count
        return g.narrow(dim, index * size, size).contiguous(), None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.mesh, ctx.axes), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        with metrics.timer("dist.sum_over"):
            out = _all_reduce_sum(t, mesh, axes)
        metrics.inc("dist.sum_over.bytes", t.numel() * t.element_size())
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, len(_group_members(mesh, axes))
        return _all_reduce_sum(t, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.mesh, ctx.axes) / ctx.n, None, None


def gather_dim(t: Tensor, mesh: Mesh, axes: Sequence[str], dim: int,
               sum_grad_over: Sequence[str] = ()) -> Tensor:
    """All-gather of ``t`` along ``dim`` over the group of ``axes`` (the
    pieces :func:`shard_param` cut with the entry ``axes``). Its backward
    sums the gradient over ``sum_grad_over`` (the axes whose ranks see
    different tokens, e.g. the data axes of an fsdp weight) and returns
    this rank's piece: a reduce-scatter."""
    axes = tuple(axes)
    if _piece(mesh, axes, mesh.coords)[1] == 1:
        return t
    return _GatherDim.apply(t, mesh, axes, dim, tuple(sum_grad_over))


def copy_to(t: Tensor, mesh: Mesh, axes: Sequence[str]) -> Tensor:
    """Identity forward, gradient summed over ``axes`` backward: a replicated
    tensor entering a region whose ranks each compute part of the result."""
    return _CopyTo.apply(t, mesh, tuple(axes))


def sum_over(t: Tensor, mesh: Mesh, axes: Sequence[str]) -> Tensor:
    """Sum over ``axes`` forward, identity backward: the partial results of
    such a region combined (host seconds under the ``dist.sum_over``
    timer and bytes under ``dist.sum_over.bytes`` when metrics are on)."""
    return _SumOver.apply(t, mesh, tuple(axes))


def mean_over(t: Tensor, mesh: Mesh, axes: Sequence[str]) -> Tensor:
    """Mean over ``axes``, forward and backward (the derivative of the sum
    of every rank's loss)."""
    return _MeanOver.apply(t, mesh, tuple(axes))
