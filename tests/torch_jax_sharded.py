"""The JAX package's side of the port's sharded acceptance subset.

Run as a script with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(``tests/test_torch_lower_sharded.py`` does): ``lower_sharded`` on the
2 x 4 rows x cols mesh for hdiff, shallow_water (merged exchange) and
hdiff_coupled at k = 1-3 on the conformance inputs, and
``make_sharded_hdiff`` on 8 x 1 and 2 x 4 data x rows meshes on the
``psi`` array of the input file. Writes every result to the ``.npz`` named
by its second argument.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402

import repro.compat  # noqa: E402,F401  (jax.shard_map on older jax)
from conformance import PROGRAMS, make_fields  # noqa: E402
from repro.dist import make_sharded_hdiff  # noqa: E402
from repro.ir import lower_sharded, repeat  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

ACCEPTANCE = ("hdiff", "shallow_water", "hdiff_coupled")

out = {}
for name in ACCEPTANCE:
    for k in (1, 2, 3):
        y = lower_sharded(repeat(PROGRAMS[name](), k), mesh_shape=(2, 4),
                          inner="reference")(make_fields(name))
        for f, a in (y.items() if isinstance(y, dict) else [("", y)]):
            out[f"{name}/{k}/{f}"] = np.asarray(a)
psi = np.load(sys.argv[1])["psi"]
for shape in ((8, 1), (2, 4)):
    step = make_sharded_hdiff(make_mesh(shape, ("data", "model")), depth_axis="data",
                              row_axis="model")
    out[f"sharded_hdiff/{shape[0]}x{shape[1]}"] = np.asarray(step(psi))
np.savez(sys.argv[2], **out)
print("JAX_SHARDED_OK")
