"""K1's share of its roofline (``readers.roofline``): the K1 calls of the
traced stretch (``work/k1.py``, from the cell's state) over the device time
of K1's kernel, ``hdiff_kernel``."""

from portbench import readers
from portbench.work import k1


def read(t):
    return readers.roofline(t, "hdiff_kernel", k1)
