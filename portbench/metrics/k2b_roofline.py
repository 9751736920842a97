"""K2's share of its roofline in its batched form (``ir.lower_batched``
under the forecast server, the members folded into depth, one launch a
cycle; ``readers.roofline``): each forecast of the traced stretch a
member's state through ``sweeps_per_call`` sweeps (``work/k2.py``), over
the device time of K2's kernel, ``stencil_program``."""

from portbench import readers
from portbench.work import k2


def read(t):
    return readers.roofline(t, "stencil_program", k2)
