"""Device meshes over an initialised ``torch.distributed`` process group.

The port of ``repro/launch/mesh.py``: where JAX lays a mesh over the
devices one process sees, here each rank is one shard, so the mesh lays
its shape over the ranks of the default process group. Nothing here
initialises that group: the caller does (``init_process_group`` with its
own address, world size and rank), and chooses the backend there.

  * :func:`make_mesh` — any shape over named axes;
  * :func:`make_host_mesh` — ``("data", "model")`` over whatever ranks the
    group has, or ``None`` (one device) when there is no group;
  * :func:`make_production_mesh` — the JAX package's pod meshes, (16, 16)
    over ``("data", "model")`` or (2, 16, 16) over ``("pod", "data",
    "model")``, on a group of 256 or 512 ranks;
  * :func:`mesh_axis_names`, :func:`data_axes`, :func:`n_devices`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Mesh, rank_coords
from repro_torch.dist.sharding import data_axes  # noqa: F401  (one definition, re-exported)

BACKENDS = ("nccl", "gloo")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, backend: str,
              device=None) -> Mesh:
    """This rank's :class:`~repro_torch.dist.sharding.Mesh` of ``shape``
    over ``axes``, spanning the default process group.

    ``backend`` is the caller's explicit choice and must be the group's:
    ``"nccl"`` keeps halo bands on the device, one card per rank;
    ``"gloo"`` moves them through host memory (several ranks may then
    share a card). ``device`` follows :mod:`repro_torch.device`: ``None``
    means the card (under ``"nccl"``, card ``rank % device_count``);
    ``device="cpu"`` runs the plain path on the host. Raises when no group
    is initialised, when its world size is not ``prod(shape)`` or its
    backend is not ``backend``."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat a name")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of {BACKENDS})")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first"
        )
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the group has {world}")
    group_backend = str(dist.get_backend()).lower()
    if group_backend != backend:
        raise ValueError(
            f"make_mesh(backend={backend!r}) over a {group_backend!r} process group: "
            "initialise the group with the backend the mesh should use"
        )
    rank = dist.get_rank()
    if device is None and backend == "nccl":
        resolve_device()
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("a nccl mesh computes on CUDA devices; use backend='gloo' on the CPU")
    return Mesh(axes, shape, rank_coords(rank, shape), dev, backend, dist.group.WORLD)


def make_host_mesh(model: int = 1, *, backend: str, device=None) -> Mesh | None:
    """A ``(world // model, model)`` mesh over ``("data", "model")`` spanning
    the initialised process group, or ``None`` when no group is initialised
    (one device: the caller trains without a mesh)."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    return make_mesh((n // model, model), ("data", "model"), backend=backend, device=device)


def make_production_mesh(*, multi_pod: bool = False, backend: str, device=None) -> Mesh:
    """The JAX package's production mesh: (16, 16) over ``("data",
    "model")``, or (2, 16, 16) over ``("pod", "data", "model")`` with
    ``multi_pod``. Raises unless the group has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, backend=backend, device=device)


def mesh_axis_names(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def n_devices(mesh: Mesh | None) -> int:
    """The mesh's ranks (1 without a mesh)."""
    return 1 if mesh is None else mesh.size
