"""repro_torch.serve — the port's serving engines.

Two schedulers share one telemetry vocabulary (queue latency, occupancy,
items/sec): :class:`BatchedServer` continuous-batches LM decode lanes;
:class:`ForecastServer` admission-groups compatible stencil forecasts into
one member-batched step per batch (:func:`repro_torch.ir.lower_batched`),
run through a fingerprint-keyed LRU :class:`CompileCache`
(``cache.{hits,misses,evictions,traces}`` counters, per-entry signature
and kernel-build probes).
"""

from repro_torch.serve.cache import CacheEntry, CompileCache, CompileKey, compile_key
from repro_torch.serve.engine import BatchedServer, Request, make_serve_fns
from repro_torch.serve.forecast import ForecastRequest, ForecastServer
