"""repro_torch.checkpoint — atomic, validated, async checkpoints (the JAX
package's on-disk format)."""

from repro_torch.checkpoint.store import (
    CheckpointManager,
    host_tree,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_health,
)
