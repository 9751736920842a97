"""Numerics-health probes: on-device field statistics + blow-up policies.

The port's copy of ``repro/obs/health.py``. A forecast that goes NaN on
step 4,000 of a long run burns everything after it silently — the perf
telemetry (:mod:`repro_torch.obs.metrics`) never notices. This module
watches the *numbers*:

  * :func:`field_stats` — NaN/Inf counts, finite min/max/mean and the
    global L2 norm, computed where the tensor lives from seven accumulators
    of one pass over it: on the card one launch of the hand-written
    ``field_stats`` kernel (:mod:`repro_torch.kernels.stats`), on the CPU
    its plain version (only scalars ever cross to the host, and only when
    the caller asks). With ``axis_names`` the stats are mesh-global: the
    accumulators are all-reduced over the named axes' group of ranks.
  * :class:`HealthMonitor` — cadence-gated probing with one of three
    policies when a probe is unhealthy:

      - ``"warn"``              log + count, keep running;
      - ``"abort"``             flush the flight recorder, raise
                                :class:`NumericsError`;
      - ``"checkpoint-then-abort"``  first hand the *last healthy* probed
                                state to ``checkpoint_fn``, then abort.

    Like ``instrument_call``, :meth:`HealthMonitor.check` steps aside while
    a CUDA graph is being captured (the port's counterpart of the JAX
    version's step-aside on tracers): a probe synchronises, which capture
    forbids.

Probes report through both observability channels when they are enabled:
``health.<field>.<stat>`` gauges + ``health.probes``/``health.blowups``/
``health.reads`` counters in the metrics registry, and ``health.probe`` /
``health.blowup`` / ``health.checkpoint`` events in the flight recorder.
Neither channel is required: the monitor functions (and aborts) with both
disabled, and counts its probes and host reads (``probes``, ``reads``) in
plain integers. While a ``torch.profiler`` captures, a probe that runs is
the span ``health.probe`` (:func:`repro_torch.obs.profile.span`).
"""

from __future__ import annotations

import math
import struct
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.kernels.stats.kernel import field_stats_cuda
from repro_torch.obs import events, metrics, profile
from repro_torch.tree import tree_map

STAT_KEYS = ("size", "nan_count", "inf_count", "min", "max", "mean", "l2")

POLICIES = ("warn", "abort", "checkpoint-then-abort")


def _host_snapshot(tree: Any) -> Any:
    """A host copy of a tensor, or of a tree of them, that shares no storage
    with what the caller holds: the port may update state in place, so a
    retained buffer could change under the monitor."""
    return tree_map(lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x,
                    tree)


def _accumulate(x, axis_names: Sequence[str], mesh) -> tuple[torch.Tensor, int | None]:
    """The accumulators of ``x`` (:data:`~repro_torch.kernels.stats.kernel.ACC_KEYS`,
    float64, where ``x`` lives) and its size, ``x.numel()`` read on the host.
    Over ``axis_names`` of more than one shard they are the whole field's,
    all-reduced, and the size is None: every element is NaN, infinite or
    finite, so the field's size is the sum of the three reduced counts."""
    if axis_names and mesh is None:
        raise ValueError(
            f"field_stats(axis_names={tuple(axis_names)}) needs the mesh those axes "
            "belong to: pass mesh=..."
        )
    x = torch.as_tensor(x)
    acc = field_stats_cuda(x)
    # Axes of one shard reduce nothing (and need no process group).
    if not axis_names or not any(mesh.axis_size(a) > 1 for a in axis_names):
        return acc, x.numel()
    import torch.distributed as dist

    from repro_torch.dist.sharding import all_reduce

    group = mesh.axis_group(tuple(axis_names))
    sums = all_reduce(acc[:5], dist.ReduceOp.SUM, mesh, group)
    lo = all_reduce(acc[5:6], dist.ReduceOp.MIN, mesh, group)
    hi = all_reduce(acc[6:], dist.ReduceOp.MAX, mesh, group)
    return torch.cat([sums, lo, hi]), None


def _stats(acc: torch.Tensor, size: int | None) -> dict[str, torch.Tensor]:
    """:func:`field_stats`'s dict from the accumulators, on their device."""
    total = (acc[:3].sum() if size is None
             else torch.full((), size, dtype=torch.float64, device=acc.device))
    counts = torch.stack([total, acc[0], acc[1]]).to(torch.int32)
    moments = torch.stack([acc[5], acc[6], acc[3] / acc[2].clamp(min=1),
                           acc[4].sqrt()]).to(torch.float32)
    return dict(zip(STAT_KEYS, (*counts.unbind(), *moments.unbind())))


def _f32(v: float) -> float:
    """``v`` rounded to float32, to nearest as ``.to(torch.float32)`` rounds:
    past float32's range an infinity (where ``struct`` raises instead)."""
    try:
        return struct.unpack("f", struct.pack("f", v))[0]
    except OverflowError:
        return math.copysign(math.inf, v)


def _host_stats(acc: Sequence[float], size: int | None) -> dict[str, float]:
    """``host_stats(_stats(acc, size))`` from accumulators already on the
    host: the same float64 operations, each result rounded once to float32,
    in Python (microseconds where the tensor route costs tens)."""
    nan, inf, fin, total, sumsq, lo, hi = acc
    return {"size": float(nan + inf + fin if size is None else size), "nan_count": nan,
            "inf_count": inf, "min": lo, "max": hi, "mean": _f32(total / max(fin, 1.0)),
            "l2": _f32(math.sqrt(sumsq))}


def field_stats(x, *, axis_names: Sequence[str] = (), mesh=None) -> dict[str, Any]:
    """Health statistics of one tensor (any shape; a floating, integer or
    bool dtype), where it lives.

    Returns a dict of 0-d tensors: ``size``, ``nan_count``, ``inf_count``
    (``torch.int32``, exact up to 2^31-1 elements — a float32 count would
    silently lose exactness past 2^24 (~16.7M), below a full ERA5-scale
    field), ``min``, ``max``, ``mean``, ``l2`` (``torch.float32``).
    Min/max/mean/L2 are over the FINITE values only, each rounded to float32
    first; with no finite values min/max are +/-inf and mean/L2 are 0 —
    ``nan_count`` / ``inf_count`` carry the alarm. All of them come from one
    pass over ``x`` (:func:`~repro_torch.kernels.stats.kernel.field_stats_cuda`):
    on the card one launch of the hand-written ``field_stats`` kernel, which
    reads each element once and sums in float64; on the CPU its plain
    version. ``size`` is ``x.numel()``, from the host: nothing is copied to
    the card. Nothing synchronises: convert with :func:`host_stats` when a
    Python-side decision is needed (:class:`HealthMonitor` reads all seven
    in one copy).

    ``axis_names`` names mesh axes to reduce across, as in a ``shard_map``
    body of the JAX package: every rank of ``mesh`` (required with
    ``axis_names``) calls this with its block, and the counts and sums are
    all-reduced by sum, min and max by min and max (three collectives),
    over the group of ranks that differ only on those axes — so GLOBAL
    statistics of the sharded field come back on every rank. This
    synchronises (it is a collective).
    """
    return _stats(*_accumulate(x, axis_names, mesh))


def host_stats(stats: Mapping[str, Any]) -> dict[str, float]:
    """:func:`field_stats` output as plain Python floats (one tiny host
    transfer per scalar — the only device->host traffic a probe costs)."""
    return {k: float(v) for k, v in stats.items()}


def is_healthy(stats: Mapping[str, float], *, max_abs: float | None = None) -> bool:
    """Healthy = no NaN, no Inf, and (when ``max_abs`` is set) every finite
    value within ``[-max_abs, max_abs]`` — the early-warning bound for a
    field that is *about* to overflow."""
    if stats["nan_count"] > 0 or stats["inf_count"] > 0:
        return False
    if max_abs is not None:
        if max(abs(stats["min"]), abs(stats["max"])) > max_abs:
            return False
    return True


class NumericsError(RuntimeError):
    """A health probe found a blow-up and the policy said abort.

    Carries the failing ``step``, ``field`` name and the host-side
    ``stats`` dict so callers (and the flight-recorder crash dump) can
    report exactly what went bad without re-probing."""

    def __init__(self, message: str, *, step: int, field: str,
                 stats: dict[str, float]):
        super().__init__(message)
        self.step = step
        self.field = field
        self.stats = stats


class HealthMonitor:
    """Cadence-gated numerics watchdog for a long step loop.

    ``check(step, x)`` probes every ``cadence`` steps (and whenever
    ``force=True``); off-cadence calls return None having done NO device
    work. A healthy probe remembers ``(step, state)`` as the last healthy
    point (``state`` defaults to ``x``). The retained reference keeps that
    state alive until the next healthy probe replaces it — the memory cost
    of ``checkpoint-then-abort``.

    ``snapshot_state=True`` copies the retained state to the host
    (``.detach().cpu().clone()`` per tensor) at probe time. REQUIRED when
    the step function updates its state in place: the tensor a probe
    retains would otherwise hold the blown-up values by the time
    ``checkpoint_fn`` reads it. The copy is paid only on cadence probes.

    While a CUDA graph is being captured the probe steps aside entirely,
    exactly like ``metrics.instrument_call``.

    ``axis_names`` and ``mesh`` make the probe mesh-global (SPMD: every rank
    of ``mesh`` checks its block of the field at the same step, and
    :func:`field_stats` all-reduces over the named axes), so every rank
    sees the same verdict and raises at the same step. The probe is then a
    collective: every rank must call :meth:`check` in the same order.
    """

    def __init__(
        self,
        cadence: int = 10,
        policy: str = "warn",
        *,
        max_abs: float | None = None,
        name: str = "field",
        checkpoint_fn: Callable[[int, Any], Any] | None = None,
        snapshot_state: bool = False,
        log_fn: Callable[[str], Any] = print,
        axis_names: Sequence[str] = (),
        mesh=None,
    ) -> None:
        if cadence < 1:
            raise ValueError(f"cadence must be >= 1, got {cadence}")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if policy == "checkpoint-then-abort" and checkpoint_fn is None:
            raise ValueError("policy 'checkpoint-then-abort' needs checkpoint_fn")
        self.cadence = cadence
        self.policy = policy
        self.max_abs = max_abs
        self.name = name
        self.checkpoint_fn = checkpoint_fn
        self.snapshot_state = snapshot_state
        self.log_fn = log_fn
        self.axis_names = tuple(axis_names)
        self.mesh = mesh
        self.probes = 0
        self.reads = 0  # scalars read to the host: seven a probe, in one copy and one wait
        self.blowups = 0
        self.last_healthy: tuple[int, Any] | None = None
        self._auto_step = 0  # wrap()'s call counter

    def due(self, step: int) -> bool:
        return step % self.cadence == 0

    def check(self, step: int, x, *, name: str | None = None,
              state: Any = None, force: bool = False) -> dict[str, float] | None:
        """Probe ``x`` if due. Returns the host stats dict when a probe ran
        (healthy or not, under ``warn``), None when skipped. Raises
        :class:`NumericsError` on a blow-up under the abort policies.

        A probe computes ``x``'s accumulators (on the card one kernel launch)
        and waits once: one device-to-host copy of all seven, from which it
        builds the dict ``host_stats(field_stats(x))`` would give."""
        if metrics.capturing():
            return None
        if not force and not self.due(step):
            return None
        name = name or self.name
        with profile.span("health.probe"):
            acc, size = _accumulate(x, self.axis_names, self.mesh)
            stats = _host_stats(acc.tolist(), size)  # one copy, one wait
        self.probes += 1
        self.reads += len(stats)
        metrics.inc("health.probes")
        metrics.inc("health.reads", len(stats))
        for k, v in stats.items():
            metrics.set_gauge(f"health.{name}.{k}", v)
        events.record("health.probe", step=step, field=name, **stats)
        if is_healthy(stats, max_abs=self.max_abs):
            keep = x if state is None else state
            if self.snapshot_state:
                keep = _host_snapshot(keep)
            self.last_healthy = (step, keep)
            return stats
        self.blowups += 1
        metrics.inc("health.blowups")
        events.record("health.blowup", step=step, field=name,
                      policy=self.policy, **stats)
        msg = (
            f"numerics blow-up in {name!r} at step {step}: "
            f"nan={stats['nan_count']:.0f} inf={stats['inf_count']:.0f} "
            f"min={stats['min']:.3e} max={stats['max']:.3e} l2={stats['l2']:.3e}"
            f" [policy={self.policy}]"
        )
        if self.policy == "warn":
            self.log_fn(msg)
            return stats
        if self.policy == "checkpoint-then-abort":
            if self.last_healthy is not None:
                ck_step, ck_state = self.last_healthy
                out = self.checkpoint_fn(ck_step, ck_state)
                events.record("health.checkpoint", step=ck_step,
                              path=str(out) if out is not None else None)
                self.log_fn(f"health: checkpointed last healthy state "
                            f"(step {ck_step}) before abort")
            else:
                self.log_fn("health: no healthy probe recorded yet — "
                            "aborting without a checkpoint")
        events.crash_dump(reason=msg)
        raise NumericsError(msg, step=step, field=name, stats=stats)

    def wrap(self, fn: Callable, *, name: str | None = None) -> Callable:
        """Wraps a step function so every call counts as one step and the
        OUTPUT is probed on cadence. The output is returned unchanged
        whether or not a probe ran."""

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            step = self._auto_step
            self._auto_step += 1
            self.check(step, out, name=name)
            return out

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__wrapped__ = fn
        return wrapped
