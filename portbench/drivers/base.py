"""What every driver shares: the cell's shapes, counts, held answers, spans.

A driver runs one kind of traffic against the port. The harness calls
``setup()`` (inputs from the seed, every shape of the cell warmed), then
``unit(keep)`` until the window is over (each unit ends in a synchronise, so
the host clock reads finished work), then ``end_to_end(window_s)``,
``release()`` and ``check()``. ``keep`` asks the unit to hold its inputs and
outputs for the check. While a traced stretch runs, ``in_stretch`` is set and
the driver's spans (``span``) label the host's work in the trace.
"""

from __future__ import annotations

import contextlib
import math
import random

import torch

from portbench.fields import state_shape

DTYPES = {"float32": torch.float32}


def change_err(triples) -> float:
    """The largest gap between ``got`` and ``want`` over the largest change
    the reference made to ``before``, each over every ``(got, want, before)``
    held: 0 for equal answers, 1 for steps that left their states unchanged.
    One change for all of them: a unit late in the window, whose state the
    limited diffusion has all but settled, changes it by little or nothing,
    and a gap of rounding over so small a change would read as an error."""
    gap = change = 0.0
    for got, want, before in triples:
        g = (got.to(torch.float32) - want.to(torch.float32)).abs().max().item()
        if not math.isfinite(g):
            return math.inf
        gap = max(gap, g)
        change = max(change, (want.to(torch.float32) - before.to(torch.float32)).abs().max().item())
    if change == 0.0:
        return 0.0 if gap == 0.0 else math.inf
    return gap / change


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device) -> None:
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg["dtype"]]
        self.grid = state_shape(cfg)
        self.points = math.prod(self.grid)
        self.rng = random.Random(seed)
        self.units = 0
        self.calls = 0
        self.failed = 0
        self.kept: list = []
        self.in_stretch = False
        self.stretch: dict = {}

    # -- the harness's hooks -------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def unit(self, keep: bool) -> None:
        raise NotImplementedError

    def end_to_end(self, window_s: float) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        """Drops the program's state that the check does not read."""

    def check(self) -> dict:
        raise NotImplementedError

    @property
    def attempted(self) -> int:
        return self.calls

    def start_stretch(self) -> None:
        self.in_stretch = True
        self.stretch = {"units": self.units, "calls": self.calls}

    def stop_stretch(self) -> None:
        self.in_stretch = False
        self.stretch["units"] = self.units - self.stretch["units"]
        self.stretch["calls"] = self.calls - self.stretch["calls"]

    # -- helpers ---------------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, fn) -> None:
        """Runs ``fn`` once and waits: every kernel of the cell's shapes is
        built and loaded, and the allocator holds the cell's blocks."""
        out = fn()
        self.sync()
        del out

    def reserve(self, shape, count: int) -> None:
        """Has the allocator hold ``count`` more blocks of ``shape``: the
        answers the check holds take blocks the steady loop would reuse, and
        a block taken from the device inside the window stalls it."""
        if self.device.type == "cuda" and count > 0:
            blocks = [torch.empty(shape, dtype=self.dtype, device=self.device)
                      for _ in range(count)]
            del blocks

    def span(self, name: str):
        """A labelled span of the host's work in a traced stretch."""
        if not self.in_stretch:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"portbench.{name}")
