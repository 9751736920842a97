"""What the per-layer readers share. Each ``metrics/<name>.py`` names its
kernel or its share of the trace and calls one of these; a reader that finds
nothing to read returns None."""

from __future__ import annotations

from portbench.fields import state_shape


def idle_pct(t):
    """The device's idle share of the traced stretch: the time in which no
    kernel, copy or set runs, in percent."""
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(t, kernel: str, work):
    """The least time of the calls the traced stretch served (``work``'s
    ``per_call`` over the cell's state, ``sweeps_per_call`` sweeps a call),
    over the device time of the kernels whose names hold ``kernel``, in
    percent."""
    device = t.device_s(lambda name: kernel in name)
    calls = t.counts.get("calls", 0)
    if t.peaks is None or device <= 0 or not calls:
        return None
    nbytes, flops = work.per_call(*state_shape(t.cfg), t.mix["sweeps_per_call"])
    return 100.0 * calls * work.least_s(nbytes, flops, t.peaks) / device


def device_ms_per_unit(t, match):
    """Device milliseconds a unit in the activities ``match`` accepts."""
    device = t.device_s(match)
    units = t.counts.get("units", 0)
    if device <= 0 or not units:
        return None
    return 1e3 * device / units
