"""K2's share of its roofline, one output (``ir.lower_cuda`` of
``repeat(hdiff_program(), sweeps_per_call)``; ``readers.roofline``): the
calls of the traced stretch (``work/k2.py``, from the cell's state) over
the device time of K2's kernel, ``stencil_program``."""

from portbench import readers
from portbench.work import k2


def read(t):
    return readers.roofline(t, "stencil_program", k2)
