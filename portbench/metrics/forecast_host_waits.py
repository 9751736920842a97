"""``serve.forecast``'s host waits: the runtime calls a cycle that hold the
host until the device has caught up (``cudaDeviceSynchronize``,
``cudaStreamSynchronize``, ``cudaEventSynchronize``; ``spans.WAITS``) and
start inside the program's ``serve.forecast.step`` spans: the step's
synchronise and every scalar a probe reads to the host, each read a copy
and a wait. None where the program opens no such span or the trace holds no
runtime call (no card)."""

from portbench import spans

STEP = "serve.forecast.step"


def read(t):
    s = spans.of(t)
    if not s.count(STEP) or not s.has_runtime:
        return None
    return spans.per_unit(t, float(s.waits_in(STEP)))
