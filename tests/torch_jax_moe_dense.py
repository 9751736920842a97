"""The JAX package's expert-parallel MoE on a config whose dense residual
``mlp`` dim the ``model`` axis does not split (the port's
``tests/test_torch_moe_dense_whole.py``).

Run as a script with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
and the overrides of arctic's smoke config as a JSON object in its first
argument: one MoE layer through ``apply_moe_sharded`` on the ``(1, 8)``
``("data", "model")`` mesh (the concrete mesh installed with
``repro.dist.sharding.use_mesh`` beside ``jax.set_mesh``, since the rules
read its devices) and through ``_apply_moe_local``, and the dense branch
alone. Prints one JSON line: the largest ``|sharded - local|``, the
largest ``|sharded - local - 7 * dense|`` and the largest ``|local|``.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

assert len(jax.devices()) == 8, jax.devices()

from repro.configs import get_smoke_config  # noqa: E402
from repro.dist.sharding import use_mesh  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import layers as L  # noqa: E402

cfg = dataclasses.replace(get_smoke_config("arctic-480b"), **json.loads(sys.argv[1]))
p, _ = L.init_moe(cfg, jax.random.PRNGKey(2))
x = jax.random.normal(jax.random.PRNGKey(3), (4, 8, cfg.d_model), jnp.float32)
y_local, _ = L._apply_moe_local(cfg, p, x)
mesh = make_mesh((1, 8), ("data", "model"))
with jax.set_mesh(mesh), use_mesh(mesh):
    y_sharded, _ = jax.jit(lambda p, x: L.apply_moe_sharded(cfg, p, x))(p, x)
dw = p["dense"]
xt = x.reshape(-1, cfg.d_model)
dense = ((jax.nn.silu(xt @ dw["w1"]) * (xt @ dw["w3"])) @ dw["w2"]).reshape(x.shape)
diff = np.asarray(y_sharded) - np.asarray(y_local)
print(json.dumps({"sharded_minus_local": float(np.abs(diff).max()),
                  "minus_seven_dense": float(np.abs(diff - 7 * np.asarray(dense)).max()),
                  "local_max": float(np.abs(np.asarray(y_local)).max())}))
