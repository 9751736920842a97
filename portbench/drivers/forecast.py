"""An ensemble stepped through the forecast server, in a closed loop.

Each unit is one cycle: every member's current field is submitted as a
forecast of ``repeat(hdiff_program(), sweeps_per_call)`` to one
``serve.ForecastServer`` (``backend``, ``max_batch`` and the
``HealthMonitor`` policy from the traffic file), ``run_until_idle()`` drains
the queue, and each member's result is its next cycle's field. The
configuration gives the members and their state's fields. A forecast's latency runs
from the client's ``submit`` of it to the return of the drain that holds its
result. The server keeps every request it retired; the client takes its
results and empties that list each cycle, or the fields would pile up on the
card.

The rate counts the forecasts that succeeded; a forecast that failed, or
that the health probe aborted, is counted in ``failed``, which fails the
check. The check holds the window's first cycle (from the ensemble the
benchmark made) and ``check_units`` more drawn from the seed, and has the
reference repeat every member's sweeps.
"""

from __future__ import annotations

import math
import time

from portbench import fields
from portbench.drivers.base import Driver, change_err
from portbench.reference import hdiff as ref


class Forecast(Driver):
    def setup(self) -> None:
        from repro_torch.ir import hdiff_program, repeat
        from repro_torch.obs.health import HealthMonitor
        from repro_torch.serve.forecast import ForecastServer

        mix, cfg = self.mix, self.cfg
        self.members = cfg["members"]
        self.k = mix["sweeps_per_call"]
        self.program = repeat(hdiff_program(coeff=cfg["coeff"], limit=cfg["limit"]), self.k)
        self.server = ForecastServer(
            backend=mix["backend"], max_batch=mix["max_batch"],
            monitor=HealthMonitor(policy=mix["monitor_policy"]), device=self.device,
        )
        self.latencies: list[float] = []
        self.succeeded = 0
        self.queue_s: list[float] = []
        batch = fields.ensemble(self.grid, self.members, self.seed, self.device, self.dtype)
        self.start = list(batch.unbind(0))
        self.reserve((self.members, *self.grid), 2 * (1 + mix["check_units"]) + 2)
        self.sync()
        self.warm(lambda: self.cycle(self.start, count=False))
        self.state = self.start

    def cycle(self, state, count: bool = True):
        """One closed-loop cycle: the members' results, or None for a failed
        forecast. ``count`` records the forecasts' latencies and failures."""
        server = self.server
        submitted = []
        with self.span("client.submit"):
            for f in state:
                t = time.perf_counter()
                submitted.append((server.submit(self.program, f), t))
        with self.span("server.run_until_idle"):
            done = {req.rid: req for req in server.run_until_idle()}
        t_done = time.perf_counter()
        server.completed.clear()
        results = []
        for rid, t in submitted:
            req = done.get(rid)
            ok = req is not None and not req.failed
            results.append(req.result if ok else None)
            if count:
                self.latencies.append(t_done - t)
                self.failed += not ok
                self.succeeded += ok
                if self.in_stretch and req is not None and req.queue_latency_s is not None:
                    self.queue_s.append(req.queue_latency_s)
        return results

    def unit(self, keep: bool) -> None:
        before = self.state
        after = self.cycle(before)
        self.units += 1
        self.calls += len(before)
        if keep:
            self.kept.append((before, after))
        # A member whose forecast failed keeps its field, so the loop goes on.
        self.state = [b if a is None else a for b, a in zip(before, after)]

    def end_to_end(self, window_s: float) -> dict:
        points = self.succeeded * self.k * self.points
        lat = sorted(self.latencies)
        # The nearest-rank 95th percentile: the latency that 95 % of the
        # window's forecasts met.
        p95 = lat[math.ceil(0.95 * len(lat)) - 1] if lat else math.nan
        return {"ensemble_sweep_rate": points / window_s / 1e9, "forecast_p95_ms": p95 * 1e3}

    def release(self) -> None:
        self.server = None
        self.state = self.start = None

    def check(self) -> dict:
        def held():
            for before, after in self.kept:
                for b, a in zip(before, after):
                    if a is not None:  # a failed forecast is counted in ``failed``
                        yield a, ref.sweeps(b, self.cfg["coeff"], self.k,
                                            limit=self.cfg["limit"], block=64), b

        return {"err_over_change": change_err(held())}

    def layer_stats(self) -> dict:
        return {"queue_s": self.queue_s}


DRIVER = Forecast
