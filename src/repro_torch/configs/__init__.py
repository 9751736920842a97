"""Workload configurations of the port (copies of ``repro.configs``): the
paper's hdiff grid (``hdiff``), every LM of the JAX registry (recurrent,
dense, MoE, vision and audio) and the shape cells they run."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_cells,
    applicable_cells,
    get_config,
    get_shape,
    get_smoke_config,
    scale_for_smoke,
)
