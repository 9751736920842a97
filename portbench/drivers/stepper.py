"""Time stepping of one state: each call's output is the next call's input.

The traffic file names the entry into the port:

  * ``"entry": "run_simulation"`` — ``core.run_simulation`` with
    ``step_fn=hdiff_fused`` (K1), one sweep a call;
  * ``"entry": "lower_cuda"`` — ``ir.lower_cuda(repeat(hdiff_program(),
    sweeps_per_call))`` (K2).

A unit is one output interval of the configuration (``output_interval_s``
over ``time_step_s`` steps) and ends in a synchronise, as a model run writes
its output. The check holds the input and output of the window's first unit
(from the state the benchmark made) and of ``check_units`` more drawn from
the seed, and has the reference repeat each unit's sweeps on ``PLANES``
planes of it drawn from the seed: hdiff acts on each plane alone, so a
plane is an answer of its own, and the reference's plain passes over a
whole state would outlast the window.
"""

from __future__ import annotations

import functools

import torch

from portbench import fields
from portbench.drivers.base import Driver, change_err
from portbench.reference import hdiff as ref

PLANES = 24


def steps_per_unit(cfg: dict, sweeps_per_call: int) -> int:
    """The calls of one output interval."""
    steps, rest = divmod(cfg["output_interval_s"], cfg["time_step_s"])
    calls, odd = divmod(steps, sweeps_per_call)
    if rest or odd or not calls:
        raise ValueError(f"{cfg['output_interval_s']} s of output is no whole number of "
                         f"{sweeps_per_call}-step calls of {cfg['time_step_s']} s")
    return calls


class Stepper(Driver):
    def setup(self) -> None:
        from repro_torch.core import run_simulation
        from repro_torch.ir import hdiff_program, lower_cuda, repeat
        from repro_torch.kernels.hdiff.ops import hdiff_fused

        mix, cfg = self.mix, self.cfg
        self.k = mix["sweeps_per_call"]
        self.n_calls = steps_per_unit(cfg, self.k)
        coeff, limit = cfg["coeff"], cfg["limit"]
        if mix["entry"] == "run_simulation":
            if self.k != 1:
                raise ValueError("run_simulation steps one sweep a call")
            step = functools.partial(hdiff_fused, limit=limit)

            def program(x):
                return run_simulation(x, coeff, step_fn=step, n_steps=self.n_calls)[0]
        elif mix["entry"] == "lower_cuda":
            fn = lower_cuda(repeat(hdiff_program(coeff=coeff, limit=limit), self.k))

            def program(x):
                for _ in range(self.n_calls):
                    x = fn(x)
                return x
        else:
            raise ValueError(f"unknown entry {mix['entry']!r}")
        self.program = program
        self.psi0 = fields.initial_field(self.grid, self.seed, self.device, self.dtype)
        self.reserve(self.grid, 2 * (1 + mix["check_units"]) + 2)
        self.sync()
        self.warm(lambda: self.program(self.psi0))
        self.state = self.psi0

    def unit(self, keep: bool) -> None:
        before = self.state
        with self.span("program.unit"):
            self.state = self.program(before)
        with self.span("sync"):
            self.sync()
        self.units += 1
        self.calls += self.n_calls
        if keep:
            self.kept.append((before, self.state))

    def end_to_end(self, window_s: float) -> dict:
        points = self.calls * self.k * self.points
        return {"sweep_rate": points / window_s / 1e9}

    def release(self) -> None:
        self.state = self.psi0 = None

    def check(self) -> dict:
        sweeps = self.n_calls * self.k
        depth = self.grid[0]
        n = min(PLANES, depth)

        def held():
            for before, after in self.kept:
                planes = torch.tensor(sorted(self.rng.sample(range(depth), n)),
                                      device=before.device)
                b = before.index_select(0, planes)
                want = ref.sweeps(b, self.cfg["coeff"], sweeps, limit=self.cfg["limit"], block=n)
                yield after.index_select(0, planes), want, b

        return {"err_over_change": change_err(held())}


DRIVER = Stepper
