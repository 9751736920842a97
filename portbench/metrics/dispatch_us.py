"""The wrappers' host time a call (``PERF.md`` layers 5-6): host
microseconds inside the program's outermost ``kernels.*`` and ``ir.*``
spans (``kernels.hdiff_fused`` around a K1 call, ``ir.lower_cuda.<program>``
around a lowered call; ``spans.Spans.outermost``), over the calls the
traced stretch served. Under the profiler, which adds its own cost to each
call. None where the program opens no such span."""

from portbench import spans

WRAPPERS = ("kernels.", "ir.")


def read(t):
    count, host_s = spans.of(t).outermost(WRAPPERS)
    calls = t.counts.get("calls", 0)
    if not count or not calls:
        return None
    return 1e6 * host_s / calls
