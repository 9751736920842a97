"""``obs.health``'s member probes: device milliseconds a cycle in every
kernel and copy that is neither K2 (``stencil_program``) nor the stack's
copy (``CatArrayBatchedCopy``): the probes' reductions and the reads of
their scalars. The probes are what is left once K2 is taken out by its
name, so a stretch whose device ran work but no kernel of that name is an
error: the rest would hold K2's own time."""

from portbench import readers

K2 = "stencil_program"
STACK = "CatArrayBatchedCopy"


def read(t):
    if t.busy_s > 0 and t.device_s(lambda name: K2 in name) <= 0:
        raise RuntimeError(f"no kernel named {K2!r} in the traced stretch: the probes' "
                           "time cannot be told from K2's")
    return readers.device_ms_per_unit(t, lambda name: K2 not in name and STACK not in name)
