"""repro_torch.train — the assimilation trainer and its loss monitor."""

from repro_torch.train.assimilate import (
    AssimilationConfig,
    FitResult,
    fit_coefficient_field,
    forward_model,
    synthetic_observations,
    true_coefficients,
)
from repro_torch.train.loop import SpikeDetector
