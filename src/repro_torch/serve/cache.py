"""Fingerprint-keyed LRU compile cache for the forecast-serving layer.

The port of ``repro/serve/cache.py``. Heterogeneous forecast requests must
never rebuild a lowering when an equivalent program was already lowered.
The key is everything that determines the lowered computation and nothing
else, as in the JAX package::

    (program.fingerprint(), grid shape, dtype, mesh shape, k, backend,
     batch size)

``StencilProgram.fingerprint()`` is the content-addressed structural hash
(display-name-blind, equal across the two packages), so two tenants
submitting structurally-equal programs under different names share one
entry, while a program differing in one coefficient tap gets its own.
``dtype`` is the numpy-style name (``"float32"``, ``"bfloat16"``), so keys
read the same as the JAX package's.

Accounting is exact and observable: ``hits`` / ``misses`` / ``evictions``
on the cache object, mirrored into :mod:`repro_torch.obs.metrics` as the
``cache.hits`` / ``cache.misses`` / ``cache.evictions`` counters (plus
``cache.traces``), with ``cache.insert`` / ``cache.evict`` events. Eviction
is LRU at ``capacity`` entries.

PyTorch traces nothing, so the JAX package's trace probe has no literal
counterpart. Its stand-in counts what a ``jax.jit`` would trace on: every
cached callable is wrapped so that ``entry.traces`` counts the first-seen
call signatures (field names, shapes, dtypes, device type), and the same
request sequence gives the same count in both packages. On CUDA tensors
the entry also records the work a trace would stand for: how far
:data:`repro_torch.ir.lower_cuda._KERNELS` (the loaded kernel
specialisations) grew during its calls (``kernels_built``), and how many
nvcc builds ran (``nvcc_builds``). The zero-retrace invariant becomes: a
warm wave adds no signature and builds no new kernel specialisation.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.ir.lower_batched import build_backend, lower_batched
from repro_torch.ir.lower_cuda import _KERNELS
from repro_torch.kernels import _build
from repro_torch.obs import events, metrics


def dtype_name(dtype: Any) -> str:
    """The numpy-style name of a torch, numpy or named dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:  # a name numpy lacks ("bfloat16")
        return str(dtype)


@dataclasses.dataclass(frozen=True)
class CompileKey:
    """Everything that determines one lowered computation.

    ``fingerprint`` is the program's canonical structural hash; ``k`` is
    its chain length (``program.steps`` — redundant with the fingerprint,
    kept explicit so cache introspection and eviction logs read well);
    ``batch`` is the ensemble-member count (None = unbatched single
    forecast); ``mesh`` is the (R, C) mesh factorization for the sharded
    backends (None = single device)."""

    fingerprint: str
    grid: tuple[int, ...]
    dtype: str
    mesh: tuple[int, int] | None
    k: int
    backend: str
    batch: int | None


def compile_key(
    program,
    *,
    grid: tuple[int, ...],
    dtype: Any = torch.float32,
    backend: str = "reference",
    mesh_shape: tuple[int, int] | None = None,
    batch: int | None = None,
) -> CompileKey:
    """The :class:`CompileKey` of one request shape."""
    return CompileKey(
        fingerprint=program.fingerprint(),
        grid=tuple(int(g) for g in grid),
        dtype=dtype_name(dtype),
        mesh=tuple(int(m) for m in mesh_shape) if mesh_shape is not None else None,
        k=program.steps,
        backend=backend,
        batch=int(batch) if batch is not None else None,
    )


@dataclasses.dataclass
class CacheEntry:
    """One cached lowered callable and its probe's counts."""

    key: CompileKey
    fn: Callable
    program_name: str
    traces: int = 0
    hits: int = 0
    kernels_built: int = 0
    nvcc_builds: int = 0


class CompileCache:
    """LRU cache of lowered (and probed) program callables.

    ``get`` is the whole API the server uses: key the request, return the
    cached callable or build and insert it, evicting the least recently
    used entry past ``capacity``. Like the metrics registry it is not
    thread-safe: one Python scheduler drives it.

    ``builder(program, key, **lower_kwargs) -> callable`` constructs a
    lowered callable on a miss; the default dispatches to
    :func:`repro_torch.ir.lower_batched` (``key.batch`` set) or
    :func:`repro_torch.ir.build_backend` (``key.batch is None``). Tests
    inject stub builders to drive the LRU bookkeeping alone.
    """

    def __init__(
        self,
        capacity: int = 16,
        *,
        builder: Callable[..., Callable] | None = None,
        trace_probe: bool = True,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.builder = builder if builder is not None else _default_builder
        self.trace_probe = trace_probe
        self._entries: OrderedDict[CompileKey, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: CompileKey) -> bool:
        return key in self._entries

    def keys(self) -> list[CompileKey]:
        """Keys in LRU order: least recently used first."""
        return list(self._entries)

    def lookup(self, key: CompileKey) -> CacheEntry | None:
        """The entry for ``key`` with NO accounting and NO recency bump —
        for tests and diagnostics; the serving path goes through
        :meth:`get`."""
        return self._entries.get(key)

    def stats(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "size": len(self._entries),
            "capacity": self.capacity,
        }

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def total_traces(self) -> int:
        """Signatures across LIVE entries — an evicted entry's count goes
        with it: rebuilding it is a miss, and its fresh signature is the
        miss's cost, not a hit's."""
        return sum(e.traces for e in self._entries.values())

    # -- the cache ---------------------------------------------------------
    def get(
        self,
        program,
        *,
        grid: tuple[int, ...],
        dtype: Any = torch.float32,
        backend: str = "reference",
        mesh_shape: tuple[int, int] | None = None,
        batch: int | None = None,
        **lower_kwargs,
    ) -> Callable:
        """The lowered callable for one request shape (cached)."""
        key = compile_key(
            program, grid=grid, dtype=dtype, backend=backend,
            mesh_shape=mesh_shape, batch=batch,
        )
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            entry.hits += 1
            self.hits += 1
            metrics.inc("cache.hits")
            return entry.fn
        self.misses += 1
        metrics.inc("cache.misses")
        built = self.builder(program, key, **lower_kwargs)
        entry = CacheEntry(key=key, fn=built, program_name=program.name)
        if self.trace_probe:
            entry.fn = _with_trace_probe(built, entry)
        self._entries[key] = entry
        events.record(
            "cache.insert", program=program.name, backend=backend,
            k=key.k, batch=key.batch, size=len(self._entries),
        )
        while len(self._entries) > self.capacity:
            old_key, old = self._entries.popitem(last=False)
            self.evictions += 1
            metrics.inc("cache.evictions")
            events.record(
                "cache.evict", program=old.program_name,
                backend=old_key.backend, k=old_key.k, batch=old_key.batch,
            )
        return entry.fn


def _signature(x) -> tuple:
    """What a ``jax.jit`` traces on: field names, shapes, dtypes and the
    device type of every tensor of one call."""
    items = sorted(x.items()) if isinstance(x, Mapping) else [(None, x)]
    return tuple((f, tuple(a.shape), a.dtype, a.device.type) for f, a in items)


def _with_trace_probe(fn: Callable, entry: CacheEntry) -> Callable:
    """Wraps ``fn`` so every first-seen call signature bumps
    ``entry.traces`` (and ``cache.traces``), and calls on CUDA tensors add
    the kernel specialisations and nvcc builds they caused to the entry.
    The wrapped computation is untouched."""
    seen: set[tuple] = set()

    def probed(x):
        sig = _signature(x)
        if sig not in seen:
            seen.add(sig)
            entry.traces += 1
            metrics.inc("cache.traces")
        if not any(device == "cuda" for *_, device in sig):
            return fn(x)
        kernels, builds = len(_KERNELS), len(_build.NVCC_RUNS)
        out = fn(x)
        entry.kernels_built += len(_KERNELS) - kernels
        entry.nvcc_builds += len(_build.NVCC_RUNS) - builds
        return out

    probed.__name__ = f"cached_{getattr(fn, '__name__', 'lowering')}"
    return probed


def _default_builder(program, key: CompileKey, **lower_kwargs) -> Callable:
    """Builds the lowering ``key`` describes (the real, non-stub builder)."""
    if key.batch is None:
        return build_backend(program, key.backend, mesh_shape=key.mesh, **lower_kwargs)
    return lower_batched(program, backend=key.backend, mesh_shape=key.mesh, **lower_kwargs)
