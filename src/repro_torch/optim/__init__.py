"""repro_torch.optim — the JAX package's AdamW/Adafactor stack in PyTorch."""

from repro_torch.optim.optimizers import (
    AdafactorState,
    AdamWState,
    OptimizerConfig,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    clip_in_place,
    make_optimizer,
    opt_state_axes,
    optimizer_config_from_model,
    schedule_lr,
    update_in_place,
)
