"""Forecast serving: admission, member-batched execution, per-request health.

The port of ``repro/serve/forecast.py``, the stencil-side counterpart of
:class:`repro_torch.serve.engine.BatchedServer`: the schedulable unit is a
*forecast request* — one IR program applied to one set of
initial-condition fields. The scheduler groups compatible pending requests
(same :class:`repro_torch.serve.cache.CompileKey` modulo batch size: same
program fingerprint, grid, dtype, mesh, k, backend) into ONE batched step
over the member axis (:func:`repro_torch.ir.lower_batched`), so N tenants'
scenarios — or N perturbed members of one ensemble — share one call per
step: on the card, one K2 launch for the whole batch. The compile cache
guarantees a repeat batch shape never builds its lowering or a kernel
again.

Fault isolation rides the batched lowering's bit-exactness: members fold
into independent depth planes and never mix, so a request whose fields
blow up (NaN/Inf, caught by a ``HealthMonitor`` post-step check) fails
ALONE — its batchmates complete with results identical to unbatched runs.

Device rule: ``device=None`` is the card (it raises without one). The
server turns numpy fields into tensors on its device and rejects a tensor
on another device; it never moves a tensor quietly. Results are views of
the batch's outputs.

Telemetry carries the JAX package's names:

  * ``serve.forecast.queue_latency`` — per-request submit-to-dispatch wait;
  * ``serve.forecast.member_occupancy`` — members in the last batch /
    ``max_batch`` (0.0 when idle);
  * ``serve.forecast.steps_per_sec`` / ``serve.forecast.members_per_sec``
    — batched-step and member throughput over a ``run_until_idle`` drain;
  * ``serve.forecast.step`` — the batched call, synchronised on a CUDA
    batch (``jax.block_until_ready``'s stand-in);
  * counters ``serve.forecast.{requests_submitted,batches,members,
    completed,failed}``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import events, metrics
from repro_torch.obs.health import HealthMonitor, NumericsError
from repro_torch.serve.cache import CompileCache, CompileKey, compile_key

Tensor = torch.Tensor


@dataclasses.dataclass
class ForecastRequest:
    """One tenant's forecast: a program and its initial-condition fields.

    The server stamps the telemetry the token server stamps on
    :class:`repro_torch.serve.engine.Request`: submit / dispatch / done
    timestamps, queue latency, and per-request throughput
    (``items_per_sec``, where the item is one completed forecast)."""

    rid: int
    program: Any                      # StencilProgram
    fields: dict[str, Tensor]         # {input: (depth, rows, cols)}
    result: Any = None                # tensor, or {field: tensor} (multi-output)
    error: Exception | None = None
    done: bool = False
    submitted_ts: float | None = None
    dispatch_ts: float | None = None
    done_ts: float | None = None
    queue_latency_s: float | None = None
    items_per_sec: float | None = None

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def group_key(self) -> CompileKey:
        """The admission key: everything the compile key pins EXCEPT the
        batch size — requests sharing it can ride one batched step."""
        return self._group_key

    _group_key: CompileKey = dataclasses.field(init=False, repr=False, default=None)


class ForecastServer:
    """Admission control and member-batched execution over a compile cache.

    One ``step()`` = one batched forecast: pop the oldest pending request,
    sweep the queue for up to ``max_batch - 1`` more requests with the SAME
    group key (FIFO within the group; incompatible requests keep their
    place for a later step), stack their fields along a fresh member axis,
    run the cached batched lowering once, and unstack per-member results.
    Heterogeneous tenants therefore interleave safely: each step is
    homogeneous, and no request is starved because group sweeps always
    start from the queue head.

    ``monitor`` (optional, a :class:`HealthMonitor`) is applied PER MEMBER
    after the step: each member's output fields are force-checked, and a
    member that trips the monitor retires with ``error`` set while its
    batchmates complete normally.
    """

    def __init__(
        self,
        *,
        backend: str = "reference",
        mesh_shape: tuple[int, int] | None = None,
        max_batch: int = 8,
        cache: CompileCache | None = None,
        cache_capacity: int = 16,
        monitor: HealthMonitor | None = None,
        lower_kwargs: Mapping[str, Any] | None = None,
        device=None,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.backend = backend
        self.mesh_shape = tuple(mesh_shape) if mesh_shape is not None else None
        self.max_batch = max_batch
        self.cache = cache if cache is not None else CompileCache(cache_capacity)
        self.monitor = monitor
        self.lower_kwargs = dict(lower_kwargs or {})
        if backend.startswith("sharded-"):
            self.lower_kwargs.setdefault("device", dev)  # the mesh's device
        self._queue: list[ForecastRequest] = []
        self._next_rid = 0
        self.completed: list[ForecastRequest] = []
        self.stats = {"batches": 0, "members": 0, "completed": 0, "failed": 0}

    def _tensor(self, name: str, a) -> Tensor:
        """``a`` on the server's device: a tensor must already be there; an
        array (numpy or nested sequences) is copied onto it."""
        if isinstance(a, Tensor):
            if a.device != self.device:
                raise ValueError(
                    f"field {name!r} is on {a.device}, but the server runs on "
                    f"{self.device}; move it there first"
                )
            return a
        return torch.tensor(np.asarray(a), device=self.device)

    # -- admission ---------------------------------------------------------
    def submit(self, program, fields) -> int:
        """Enqueue one forecast. ``fields`` is a ``{input: (D, R, C)}``
        mapping (or the bare tensor or array for single-input programs);
        shapes and dtypes join the admission key, so mixed grids never
        co-batch."""
        if not isinstance(fields, Mapping):
            if len(program.inputs) != 1:
                raise ValueError(
                    f"program {program.name!r} has inputs "
                    f"{program.inputs}; pass a mapping"
                )
            fields = {program.inputs[0]: fields}
        missing = [f for f in program.inputs if f not in fields]
        if missing:
            raise ValueError(
                f"program {program.name!r} request is missing input(s) "
                f"{missing}; declared inputs are {list(program.inputs)}"
            )
        arrays = {f: self._tensor(f, fields[f]) for f in program.inputs}
        shapes = {tuple(a.shape) for a in arrays.values()}
        if len(shapes) != 1:
            raise ValueError(
                f"all fields of one forecast must share a grid, got {shapes}"
            )
        grid = shapes.pop()
        if len(grid) != program.ndim + 1:
            raise ValueError(
                f"program {program.name!r} wants a (depth, rows, cols) grid "
                f"({program.ndim + 1}-D), got shape {grid}"
            )
        rid = self._next_rid
        self._next_rid += 1
        req = ForecastRequest(rid=rid, program=program, fields=arrays)
        req._group_key = compile_key(
            program,
            grid=grid,
            dtype=next(iter(arrays.values())).dtype,
            backend=self.backend,
            mesh_shape=self.mesh_shape,
            batch=None,
        )
        req.submitted_ts = time.perf_counter()
        self._queue.append(req)
        metrics.inc("serve.forecast.requests_submitted")
        events.record(
            "serve.forecast.submit", rid=rid, program=program.name,
            grid=list(grid), k=program.steps,
        )
        return rid

    def pending(self) -> int:
        return len(self._queue)

    # -- execution ---------------------------------------------------------
    def _admit_group(self) -> list[ForecastRequest]:
        """Head-of-queue request plus every same-group-key follower, FIFO,
        up to ``max_batch``. Skipped requests keep their queue position."""
        head = self._queue[0]
        group = [head]
        for req in self._queue[1:]:
            if len(group) >= self.max_batch:
                break
            if req.group_key == head.group_key:
                group.append(req)
        picked = {id(r) for r in group}
        self._queue = [r for r in self._queue if id(r) not in picked]
        return group

    def step(self) -> bool:
        """One batched forecast step. Returns False when idle."""
        if not self._queue:
            metrics.set_gauge("serve.forecast.member_occupancy", 0.0)
            return False
        group = self._admit_group()
        now = time.perf_counter()
        for req in group:
            req.dispatch_ts = now
            if req.submitted_ts is not None:
                req.queue_latency_s = now - req.submitted_ts
                metrics.observe("serve.forecast.queue_latency", req.queue_latency_s)
        key = group[0].group_key
        program = group[0].program
        n = len(group)
        metrics.set_gauge("serve.forecast.member_occupancy", n / self.max_batch)
        fn = self.cache.get(
            program,
            grid=key.grid,
            dtype=key.dtype,
            backend=key.backend,
            mesh_shape=key.mesh,
            batch=n,
            **self.lower_kwargs,
        )
        batched = {f: torch.stack([req.fields[f] for req in group]) for f in program.inputs}
        with metrics.timer("serve.forecast.step"):
            out = fn(batched)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.stats["batches"] += 1
        self.stats["members"] += n
        metrics.inc("serve.forecast.batches")
        metrics.inc("serve.forecast.members", n)
        done = time.perf_counter()
        for i, req in enumerate(group):
            member = (
                {f: v[i] for f, v in out.items()}
                if isinstance(out, Mapping)
                else out[i]
            )
            req.done_ts = done
            if req.dispatch_ts is not None and done > req.dispatch_ts:
                req.items_per_sec = 1.0 / (done - req.dispatch_ts)
            try:
                self._check_member(req, member)
            except NumericsError as err:
                req.error = err
                self.stats["failed"] += 1
                metrics.inc("serve.forecast.failed")
                events.record(
                    "serve.forecast.fail", rid=req.rid,
                    program=program.name, field=err.field,
                )
            else:
                req.result = member
                self.stats["completed"] += 1
                metrics.inc("serve.forecast.completed")
            req.done = True
            self.completed.append(req)
            events.record(
                "serve.forecast.retire", rid=req.rid, batch=n,
                failed=req.failed, queue_latency_s=req.queue_latency_s,
                items_per_sec=req.items_per_sec,
            )
        return True

    def _check_member(self, req: ForecastRequest, member) -> None:
        """Force-check every output field of ONE member's result against
        the monitor — this is where a NaN-injected request dies alone."""
        if self.monitor is None:
            return
        outputs = member if isinstance(member, Mapping) else {"out": member}
        for fname, arr in outputs.items():
            self.monitor.check(
                req.program.steps, arr,
                name=f"{req.program.name}[{req.rid}].{fname}", force=True,
            )

    def run_until_idle(self, max_steps: int = 10_000) -> list[ForecastRequest]:
        """Drain the queue; returns the requests retired by THIS drain (in
        retirement order) and stamps the throughput gauges."""
        start = len(self.completed)
        steps0 = self.stats["batches"]
        members0 = self.stats["members"]
        t0 = time.perf_counter()
        for _ in range(max_steps):
            if not self.step():
                break
        elapsed = time.perf_counter() - t0
        if elapsed > 0:
            metrics.set_gauge(
                "serve.forecast.steps_per_sec",
                (self.stats["batches"] - steps0) / elapsed,
            )
            metrics.set_gauge(
                "serve.forecast.members_per_sec",
                (self.stats["members"] - members0) / elapsed,
            )
        return self.completed[start:]

    def metrics_text(self) -> str:
        """Prometheus-style exposition (see ``BatchedServer.metrics_text``)."""
        from repro_torch.obs.export import prometheus_text

        return prometheus_text()
