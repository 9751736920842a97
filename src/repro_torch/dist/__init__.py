"""repro_torch.dist: the distribution layer on ``torch.distributed``.

The port of ``repro.dist`` (the grid part; the LM rule engine and the
compressed gradient reduce belong to the LM substrate):

  * :mod:`repro_torch.dist.sharding` — the rank mesh (:class:`Mesh`), its
    axis sizes and groups, ``shard_block`` / ``gather_blocks``.
  * :mod:`repro_torch.dist.halo` — ``make_sharded_hdiff`` (depth-parallel
    planes + radius-2 row halo exchange, matching the single-device hdiff),
    ``exchange_halos_2d`` (row and col bands + diagonal corners, behind
    ``repro_torch.ir.lower_sharded``), the wire models and the byte
    counter that measures them.
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
from repro_torch.dist.sharding import Mesh, gather_blocks, shard_block

__all__ = [
    "Mesh",
    "count_wire",
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
    "shard_block",
    "start_exchange",
    "wire_drift_report",
]
