"""``serve.forecast``'s stacking of the members: device milliseconds a
cycle in the copy kernels of ``torch.stack`` (``CatArrayBatchedCopy``)."""

from portbench import readers

STACK = "CatArrayBatchedCopy"


def read(t):
    return readers.device_ms_per_unit(t, lambda name: STACK in name)
