"""``obs.health``'s member probes, found where they are launched: device
milliseconds a cycle of the kernels, copies and sets whose runtime calls
start inside the program's ``health.probe`` spans (``spans.Spans.device_s``).
None where the program opens no such span or the device ran nothing."""

from portbench import spans

PROBE = "health.probe"


def read(t):
    s = spans.of(t)
    if not s.count(PROBE) or s.busy_s <= 0:
        return None
    return spans.per_unit(t, s.device_s(PROBE), 1e3)
