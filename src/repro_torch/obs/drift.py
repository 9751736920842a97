"""Model-vs-measured drift detection (the port's copy of ``repro/obs/drift.py``).

The repo's central correctness claim about its wire models is analytical
exactness: measured collective bytes / modelled bytes == 1.000 (§3.1-style
accounting, fig10/fig13). This module makes that comparison a standing
runtime property instead of a figure-script one: any instrumented layer can
record a ``(measured, model)`` pair and get a flagged :class:`DriftResult`
when the ratio leaves tolerance, with the pair and the verdict mirrored
into the active metrics registry.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs import events, metrics

# The band of the JAX package's benchmark gate (its bench-smoke script uses
# the same one): the models are exact, so anything past 1% is a real
# accounting bug, not noise.
DEFAULT_TOLERANCE = 0.01


@dataclasses.dataclass(frozen=True)
class DriftResult:
    """One model-vs-measured comparison."""

    name: str
    measured: float
    model: float
    tolerance: float

    @property
    def ratio(self) -> float:
        if self.model == 0:
            # Exact-zero model (e.g. 1x1 mesh: no collectives): measured
            # must be zero too; encode agreement as ratio 1.
            return 1.0 if self.measured == 0 else float("inf")
        return self.measured / self.model

    @property
    def ok(self) -> bool:
        return abs(self.ratio - 1.0) <= self.tolerance

    def describe(self) -> str:
        verdict = "ok" if self.ok else "DRIFT"
        return (
            f"{self.name}: measured={self.measured:.0f} model={self.model:.0f} "
            f"ratio={self.ratio:.6f} tol={self.tolerance} [{verdict}]"
        )


def check_drift(
    name: str,
    measured: float,
    model: float,
    tolerance: float = DEFAULT_TOLERANCE,
    *,
    registry: metrics.MetricsRegistry | None = None,
) -> DriftResult:
    """Builds a :class:`DriftResult` and records it into ``registry`` (or
    the active registry; silently skipped when neither exists):

      * counters ``<name>.measured_bytes`` / ``<name>.model_bytes`` — the
        raw pair, accumulated so repeated rounds sum;
      * gauge   ``<name>.ratio`` — the latest measured/model ratio;
      * counter ``<name>.drift_flags`` — bumped only when out of tolerance.

    An out-of-tolerance result additionally lands in the flight recorder
    as a ``drift.flagged`` event (no event on clean checks — the recorder
    keeps *notable* history, the registry keeps aggregates).
    """
    result = DriftResult(name=name, measured=float(measured), model=float(model),
                         tolerance=tolerance)
    reg = registry if registry is not None else metrics.current()
    if reg is not None:
        reg.inc(f"{name}.measured_bytes", result.measured)
        reg.inc(f"{name}.model_bytes", result.model)
        reg.set_gauge(f"{name}.ratio", result.ratio)
        if not result.ok:
            reg.inc(f"{name}.drift_flags")
    if not result.ok:
        events.record("drift.flagged", name=name, measured=result.measured,
                      model=result.model, ratio=result.ratio,
                      tolerance=tolerance)
    return result
