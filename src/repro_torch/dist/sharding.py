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
:func:`sum_over`, :func:`sum_scatter` and :func:`mean_over` are the
collectives the tensor-parallel model code and the expert-parallel MoE
run, written as autograd Functions (a plain collective carries no
gradient): a gather's backward sums the gradient over the axes the caller
names and keeps this rank's piece; *copy_to* is the identity forward and a
sum backward, *sum_over* the reverse (the Megatron f and g); *sum_scatter*
sums and keeps this rank's columns, and gathers the columns' gradients
back.

**Trees.** :class:`NamedSharding` is one tensor's placement (a mesh and
a spec): :meth:`~NamedSharding.piece` cuts a rank's piece from the whole,
:meth:`~NamedSharding.whole` joins the pieces again. :func:`sharding_for`
gives the placement of one tensor's logical axes and
:func:`tree_shardings` of a whole tree of them (the JAX ``_is_axes_leaf``
rule: a tuple of names and ``None`` is one leaf), which is how the LM
trainer stores its parameters, gradients and optimizer moments: a rank
holds the pieces GSPMD would place on its device (ZeRO-3 / FSDP storage).
:func:`gather_param` turns a piece into the whole parameter a block
computes with, and :func:`gather_to_host` assembles a whole leaf on one
rank's host for a checkpoint.

Not ported: ``constrain``. The JAX package annotates intermediates with
sharding constraints for the GSPMD partitioner, which then splits the
computation itself; a constraint never changes values. The port has no
partitioner to steer: its model code carries out the ``model`` placements
itself. The trainer and tensor-parallel serving (``lm_prefill`` /
``lm_decode`` under :func:`use_mesh`) gather only the data-axis pieces
and compute each rank's share of the heads, kv heads, ``mlp``,
vocabulary and RG-LRU width (serving: and of the decode cache): a
replicated activation enters a split region through :func:`copy_to`,
partial results leave it through :func:`sum_over`, :func:`sum_scatter`
or :func:`gather_dim`, and a branch the rules replicate is computed whole
on every model rank, so its leaves' gradients come out equal there.
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
from repro_torch.tree import tree_flatten, tree_unflatten

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
            # every group of the partition, in one order, on the backend of
            # the group the mesh spans (the mesh's own, or the dry run's
            # fake one under an "nccl" mesh).
            backend = dist.get_backend(self.group)
            fixed_shape = [self.shape[i] for i in others]
            for flat in range(math.prod(fixed_shape)):
                fixed = dict(zip(others, rank_coords(flat, fixed_shape)))
                members = [r for r in range(self.size)
                           if all(self.coords_of(r)[i] == c for i, c in fixed.items())]
                g = dist.new_group(members, backend=backend)
                if all(self.coords[i] == c for i, c in fixed.items()):
                    mine = g
            self._axis_groups[key] = mine
        return self._axis_groups[key]


# The dry run's tally of collectives (``launch/dryrun.py``): while
# :func:`tally_collectives` is open, :func:`all_reduce` and the gathers of
# :func:`gather_dim` add ``(kind, payload bytes, ranks in the group)`` here.
_TALLY: list | None = None


@contextmanager
def tally_collectives():
    """Yields a list that every all-reduce (``"all_reduce"``: the bytes of
    the tensor reduced) and every gather of :func:`gather_dim`
    (``"all_gather"``: the bytes of the gathered result) appends ``(kind,
    payload bytes, group size)`` to until the block ends."""
    global _TALLY
    prev, rows = _TALLY, []
    _TALLY = rows
    try:
        yield rows
    finally:
        _TALLY = prev


def _tally(kind: str, nbytes: int, group) -> None:
    if _TALLY is not None:
        _TALLY.append((kind, nbytes, dist.get_world_size(group)))


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
    _tally("all_reduce", t.numel() * t.element_size(), group)
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
    entry, as :func:`spec_for` gives). Returns a contiguous copy: always a
    copy, so a piece never holds the whole tensor's storage alive (a slice
    along the first dim is contiguous already, and ``contiguous()`` would
    hand back a view of the whole)."""
    _check_spec(x.shape, mesh, spec)
    return x[_block_index(x.shape, mesh, spec, mesh.coords)].clone(
        memory_format=torch.contiguous_format)


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



# -- placements of whole trees -------------------------------------------------------


def _is_axes_leaf(x) -> bool:
    """A tuple of logical axis names and ``None``: one leaf of an axes tree."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _is_shape_leaf(x) -> bool:
    """A shape (a tuple of ints, ``torch.Size``) or anything with one."""
    return hasattr(x, "shape") or (isinstance(x, tuple) and all(isinstance(e, int) for e in x))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """One tensor's placement on a mesh: ``spec`` (one entry per dim, as
    :func:`spec_for` gives) over ``mesh`` (a :class:`Mesh`; a duck type
    with ``axis_names`` and ``shape`` serves for specs alone)."""

    mesh: Any
    spec: tuple

    @property
    def axes(self) -> tuple[str, ...]:
        """The mesh axes the spec names, in spec order."""
        return tuple(a for entry in self.spec for a in _entry_axes(entry))

    @property
    def replicas(self) -> int:
        """How many ranks hold each piece: the mesh's size over the pieces'
        count."""
        sizes = _mesh_sizes(self.mesh)
        return math.prod(sizes.values()) // math.prod(sizes[a] for a in self.axes)

    def counts(self) -> tuple[int, ...]:
        """Each dim's number of pieces."""
        sizes = _mesh_sizes(self.mesh)
        return tuple(math.prod(sizes[a] for a in _entry_axes(e)) for e in self.spec)

    def piece_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of a piece of a tensor of global ``shape``."""
        return tuple(int(n) // c for n, c in zip(shape, self.counts()))

    def global_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The global shape of a tensor whose pieces have ``shape``."""
        return tuple(int(n) * c for n, c in zip(shape, self.counts()))

    def piece(self, t: Tensor) -> Tensor:
        """This rank's piece of the whole tensor ``t`` (:func:`shard_param`)."""
        return shard_param(t, self.mesh, self.spec)

    def whole(self, piece: Tensor) -> Tensor:
        """The whole tensor, on every rank (:func:`gather_blocks`)."""
        return gather_blocks(piece, self.mesh, self.spec)


def sharding_for(logical_axes: Sequence[str | None], mesh, shape: Sequence[int],
                 mode: str = "train") -> NamedSharding:
    """The placement of a tensor with ``logical_axes`` and ``shape`` on
    ``mesh`` by the rules (:func:`spec_for`)."""
    return NamedSharding(mesh, spec_for(logical_axes, mesh, shape, mode=mode))


def tree_shardings(axes_tree: Any, mesh, shapes_tree: Any, mode: str = "train") -> Any:
    """A tree of logical-axis tuples and a tree of the same structure
    holding each leaf's global shape (tuples, or tensors, meta ones
    included) mapped to :class:`NamedSharding` leaves."""
    axes, treedef = tree_flatten(axes_tree, is_leaf=_is_axes_leaf)
    shapes, shape_def = tree_flatten(shapes_tree, is_leaf=_is_shape_leaf)
    if shape_def != treedef:
        raise ValueError(f"axes and shapes trees differ: {treedef} vs {shape_def}")
    return tree_unflatten(treedef, [
        sharding_for(ax, mesh, tuple(getattr(shp, "shape", shp)), mode=mode)
        for ax, shp in zip(axes, shapes)])


def gather_to_host(piece: Tensor, sharding: NamedSharding, dst: int = 0) -> Tensor | None:
    """The whole tensor assembled on rank ``dst``'s host from every rank's
    ``piece`` (``None`` on the other ranks): a collective over the mesh,
    one leaf at a time, so no rank holds a whole tree (checkpoints)."""
    mesh, spec = sharding.mesh, sharding.spec
    src = piece.detach()
    src = src.to("cpu") if mesh.backend == "gloo" else src.to(mesh.device)
    src = src.contiguous()
    mine = mesh.rank_of(mesh.coords) == dst
    parts = [torch.empty_like(src) for _ in range(mesh.size)] if mine else None
    dist.gather(src, parts, dst=dst, group=mesh.group)
    if not mine:
        return None
    shape = sharding.global_shape(src.shape)
    out = torch.empty(shape, dtype=src.dtype)
    for r, part in enumerate(parts):
        out[_block_index(shape, mesh, spec, mesh.coords_of(r))] = part.to("cpu")
    return out


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
    group = mesh.axis_group(axes)
    _tally("all_gather", len(members) * src.numel() * src.element_size(), group)
    dist.all_gather(parts, src, group=group)
    metrics.inc("dist.gather.bytes", (len(members) - 1) * src.numel() * src.element_size())
    order = sorted(range(len(members)),
                   key=lambda i: _piece(mesh, axes, mesh.coords_of(members[i]))[0])
    return torch.cat([parts[i] for i in order], dim=dim).to(t.device)


def _all_reduce_sum(t: Tensor, mesh: Mesh, axes: tuple[str, ...]) -> Tensor:
    return all_reduce(t, dist.ReduceOp.SUM, mesh, mesh.axis_group(axes))


def _grad_sum(g: Tensor, mesh: Mesh, axes: tuple[str, ...]) -> Tensor:
    """A gradient summed over ``axes`` (the whole tensor all-reduced: gloo
    has no reduce-scatter), its bytes counted under ``dist.grad_sum.bytes``
    when metrics are on."""
    metrics.inc("dist.grad_sum.bytes", g.numel() * g.element_size())
    return _all_reduce_sum(g, mesh, axes)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, sum_axes):
        ctx.mesh, ctx.axes, ctx.dim, ctx.sum_axes = mesh, axes, dim, sum_axes
        return _all_gather_dim(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        if ctx.sum_axes:
            g = _grad_sum(g, mesh, ctx.sum_axes)
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
        return _grad_sum(g, ctx.mesh, ctx.axes), None, None


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


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, blocks):
        ctx.mesh, ctx.axes, ctx.blocks = mesh, axes, blocks
        out = _SumOver.forward(ctx, t, mesh, axes)
        index, count = _piece(mesh, axes, mesh.coords)
        parts = out.unflatten(-1, (blocks, count, -1))[..., index, :]
        return parts.flatten(-2).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, blocks = ctx.mesh, ctx.axes, ctx.blocks
        whole = _all_gather_dim(g.unflatten(-1, (blocks, -1)), mesh, axes, -1)
        return whole.flatten(-2), None, None, None


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


def sum_scatter(t: Tensor, mesh: Mesh, axes: Sequence[str], blocks: int = 1) -> Tensor:
    """Sum over ``axes``, then this rank's piece of the last dim of each of
    its ``blocks`` equal blocks (the columns ``shard_param`` would cut with
    the entry ``axes``), concatenated: a reduce-scatter, run as the sum of
    :func:`sum_over` (gloo has no reduce-scatter) and a slice. Its backward
    all-gathers the pieces' gradients into each block's whole columns, the
    gradient of every rank's partial sum."""
    return _SumScatter.apply(t, mesh, tuple(axes), blocks)


def mean_over(t: Tensor, mesh: Mesh, axes: Sequence[str]) -> Tensor:
    """Mean over ``axes``, forward and backward (the derivative of the sum
    of every rank's loss)."""
    return _MeanOver.apply(t, mesh, tuple(axes))


def data_axes(mesh) -> tuple[str, ...]:
    """The axes that carry batch/data parallelism (pod folds into data)."""
    return tuple(a for a in mesh.axis_names if a in _DATA_AXES)


def data_axes_of(mesh) -> tuple[str, ...]:
    """The mesh's :func:`data_axes` of more than one rank: those a sum over
    the data ranks has to cross."""
    return tuple(a for a in data_axes(mesh) if mesh.axis_size(a) > 1)


def gather_param(piece: Tensor, sharding: NamedSharding, dtype=None, *,
                 keep: Sequence[str] = ()) -> Tensor:
    """The parameter a computation reads, from this rank's ``piece`` of it
    under ``sharding``: cast to ``dtype`` first (so the wire carries the
    compute dtype, as the JAX trainer's master-weight cast asks), then
    gathered whole over every mesh axis of its spec but those in ``keep``
    (the tensor-parallel model code keeps its ``model`` pieces).

    Backward: the gradient is summed over every data axis of the mesh once
    (their ranks hold other rows of the batch) — by the gathers'
    reduce-scatter over the data axes the spec names, and by
    :func:`copy_to` over the others — and never over ``model``: a kept
    ``model`` piece's gradient is this rank's share of the computation
    (the model code sums a replicated activation's over ``model`` where it
    enters a split region), and a leaf ``model`` does not split is read by
    a branch computed whole on every model rank, whose gradient is equal
    there; a leaf gathered over ``model`` keeps this rank's piece of the
    gradient every model rank computes alike."""
    mesh, spec = sharding.mesh, sharding.spec
    x = piece.to(dtype) if dtype is not None and piece.is_floating_point() else piece
    dp = data_axes_of(mesh)
    rest = tuple(a for a in dp if a not in sharding.axes)
    if rest:
        x = copy_to(x, mesh, rest)
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in _entry_axes(entry) if a not in keep)
        if axes:
            x = gather_dim(x, mesh, axes, dim, sum_grad_over=tuple(a for a in axes if a in dp))
    return x
