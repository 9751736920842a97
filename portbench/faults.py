"""The control and the planted faults: the port's calls replaced underneath
a run, so that the check can be seen to fail.

``hook(mode)`` gives a ``driver_hook`` for :func:`portbench.harness.run_cell`.
The benchmark's own runs never use it; ``control.py`` runs it on the card at
a cell's own size, the tests on the CPU at a small one. Modes:

  * ``control`` — the reference in the port's place, computed in bfloat16,
    the nearest precision below the configurations' float32;
  * ``unchanged`` — every step returns its state unchanged;
  * ``half`` — half of the batch left out (the forecast server's members);
  * ``altered`` — an answer altered where it is produced: one point of each
    plane of a stepping unit's output (the check reads a sample of planes,
    each an answer of its own), or one point of one member's forecast.
"""

from __future__ import annotations

import torch

from portbench.reference import hdiff as ref

LOW = torch.bfloat16
MODES = ("control", "unchanged", "half", "altered")


def _bump(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one point, in its middle, moved by one."""
    y = x.clone()
    y.view(-1)[y.numel() // 2] += 1.0
    return y


def _bump_planes(x: torch.Tensor) -> torch.Tensor:
    """``x`` with the middle point of each plane moved by one."""
    y = x.clone()
    y[:, y.shape[1] // 2, y.shape[2] // 2] += 1.0
    return y


def _after(driver, method: str, patch) -> None:
    """Has ``patch(driver)`` run right after the driver's ``method``."""
    real = getattr(driver, method)

    def patched():
        real()
        patch(driver)

    setattr(driver, method, patched)


def _stepper(mode):
    def patch(d):
        real, sweeps = d.program, d.n_calls * d.k
        coeff, limit = d.cfg["coeff"], d.cfg["limit"]
        if mode == "control":
            d.program = lambda x: ref.sweeps(x.to(LOW), coeff, sweeps, limit=limit,
                                             block=64).to(x.dtype)
        elif mode == "unchanged":
            d.program = lambda x: x
        elif mode == "altered":
            d.program = lambda x: _bump_planes(real(x))
        else:
            raise ValueError(f"a stepping cell has no batch to halve: {mode!r}")
    return patch


def _forecast(mode):
    def patch(d):
        server, coeff, limit, k = d.server, d.cfg["coeff"], d.cfg["limit"], d.k
        get = server.cache.get

        def lowered(program, **kw):
            real = get(program, **kw)

            def fn(batched):
                (x,) = batched.values()
                if mode == "control":
                    n = x.shape[0]
                    flat = x.reshape(-1, *x.shape[2:]).to(LOW)
                    return ref.sweeps(flat, coeff, k, limit=limit, block=64).to(x.dtype).reshape(
                        n, *x.shape[1:])
                if mode == "unchanged":
                    return x.clone()
                out = real(batched)
                if mode == "half":
                    out = out.clone()
                    out[x.shape[0] // 2:] = x[x.shape[0] // 2:]
                    return out
                out = out.clone()
                out[0] = _bump(out[0])
                return out
            return fn

        server.cache.get = lowered
    return patch


def hook(mode: str):
    """A ``driver_hook`` that plants ``mode`` into whichever driver runs."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")

    def apply(driver):
        patch = {"stepper": _stepper, "forecast": _forecast}[driver.mix["driver"]](mode)
        _after(driver, "setup", patch)

    return apply
