"""``obs.health``'s member probes, as the device sees them: device-idle
milliseconds a cycle inside the program's ``health.probe`` spans (the host
reading each probe's scalars and launching the next probe's reductions;
``spans.Spans.idle_s``). None where the program opens no such span or the
device ran nothing."""

from portbench import spans

PROBE = "health.probe"


def read(t):
    s = spans.of(t)
    if not s.count(PROBE) or s.busy_s <= 0:
        return None
    return spans.per_unit(t, s.idle_s(PROBE), 1e3)
