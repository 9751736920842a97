"""repro_torch.train — the LM training loop and the assimilation trainer."""

from repro_torch.train.assimilate import (
    AssimilationConfig,
    FitResult,
    fit_coefficient_field,
    forward_model,
    synthetic_observations,
    true_coefficients,
)
from repro_torch.train.loop import (
    SpikeDetector,
    StepWatchdog,
    TrainConfig,
    init_train_state,
    make_train_step,
    shape_for_microbatches,
    train,
)
