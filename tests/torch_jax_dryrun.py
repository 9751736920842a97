"""The JAX package's side of ``tests/test_torch_dryrun.py``.

Run as a script with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
and the cases as a JSON list of ``[arch, kind]`` in its first argument:
builds each smoke cell's lowering spec (remat off, 64 tokens, 4 rows) on
the ``(2, 4)`` ``("data", "model")`` mesh and prints, as one JSON line,
each argument's bytes on one device: the sum over its leaves of
``NamedSharding.shard_shape`` times the item size. Nothing is compiled.
"""

import dataclasses
import json
import math
import sys

import jax

assert len(jax.devices()) == 8, jax.devices()

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.inputs import make_lowering_spec  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch, kind in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=False)
    spec = make_lowering_spec(cfg, ShapeConfig("t", 64, 4, kind), mesh)
    sizes = []
    for arg, sh in zip(spec.args, spec.in_shardings):
        leaves = jax.tree.leaves(arg)
        shs = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
        assert len(leaves) == len(shs)
        sizes.append(sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
                         for a, s in zip(leaves, shs)))
    out[f"{arch}:{kind}"] = sizes
print(json.dumps(out))
