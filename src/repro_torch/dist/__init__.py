"""repro_torch.dist: the distribution layer on ``torch.distributed``.

The port of ``repro.dist`` (all but ``constrain``, which annotates
intermediates for the GSPMD partitioner; see :mod:`repro_torch.dist.sharding`):

  * :mod:`repro_torch.dist.sharding` — the rank mesh (:class:`Mesh`), its
    axis sizes and groups, ``shard_param`` / ``gather_blocks``, the
    logical-axis rules (``spec_for``), the placement of whole trees
    (``NamedSharding``, ``sharding_for``, ``tree_shardings``), the ambient
    mesh (``use_mesh``) and the collectives with gradients that the
    expert-parallel MoE and the sharded LM trainer run.
  * :mod:`repro_torch.dist.halo` — ``make_sharded_hdiff`` (depth-parallel
    planes + radius-2 row halo exchange, matching the single-device hdiff),
    ``exchange_halos_2d`` (row and col bands + diagonal corners, behind
    ``repro_torch.ir.lower_sharded``), the wire models and the byte
    counter that measures them.
  * :mod:`repro_torch.dist.reduce` — ``reduce_gradients`` over a process
    group, in float32 or on a bfloat16 wire.
"""

from repro_torch.dist.halo import (
    count_wire,
    exchange_halos_2d,
    exchange_row_halos,
    gradient_halo_exchange_bytes,
    gradient_halo_exchange_bytes_per_shard,
    gradient_wire_drift_report,
    halo_exchange_bytes,
    halo_exchange_bytes_per_shard,
    make_sharded_hdiff,
    measured_wire_bytes,
    owned_rows_mask,
    program_exchange_radii,
    program_halo_exchange_bytes,
    program_halo_exchange_bytes_per_shard,
    start_exchange,
    wire_drift_report,
)
from repro_torch.dist.reduce import compress_bf16, decompress_bf16, reduce_gradients
from repro_torch.dist.sharding import (
    Mesh,
    NamedSharding,
    gather_blocks,
    shard_param,
    sharding_for,
    spec_for,
    tree_shardings,
    use_mesh,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "compress_bf16",
    "count_wire",
    "decompress_bf16",
    "exchange_halos_2d",
    "exchange_row_halos",
    "gather_blocks",
    "gradient_halo_exchange_bytes",
    "gradient_halo_exchange_bytes_per_shard",
    "gradient_wire_drift_report",
    "halo_exchange_bytes",
    "halo_exchange_bytes_per_shard",
    "make_sharded_hdiff",
    "measured_wire_bytes",
    "owned_rows_mask",
    "program_exchange_radii",
    "program_halo_exchange_bytes",
    "program_halo_exchange_bytes_per_shard",
    "reduce_gradients",
    "shard_param",
    "sharding_for",
    "spec_for",
    "start_exchange",
    "tree_shardings",
    "use_mesh",
    "wire_drift_report",
]
