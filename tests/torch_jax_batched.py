"""The JAX package's side of the port's sharded batched cells.

Run as a script with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(``tests/test_torch_ir_batched.py`` does): ``lower_batched`` with the
``sharded-reference`` and ``sharded-pallas`` (interpret mode) backends on
the 2 x 4 rows x cols mesh, for ``conformance.BATCHED_PROGRAMS`` x
``BATCHED_KS`` on ``make_batched_fields``. Writes every result to the
``.npz`` named by its first argument.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402

import repro.compat  # noqa: E402,F401  (jax.shard_map on older jax)
from conformance import (  # noqa: E402
    BATCHED_KS,
    BATCHED_PROGRAMS,
    PROGRAMS,
    build_batched,
    make_batched_fields,
)
from repro.ir import repeat  # noqa: E402

out = {}
for name in BATCHED_PROGRAMS:
    for k in BATCHED_KS:
        for backend in ("sharded-reference", "sharded-pallas"):
            fn = build_batched(repeat(PROGRAMS[name](), k), backend, (2, 4))
            y = fn(make_batched_fields(name))
            for f, a in (y.items() if isinstance(y, dict) else [("", y)]):
                out[f"{name}/{k}/{backend}/{f}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
print("JAX_BATCHED_OK")
