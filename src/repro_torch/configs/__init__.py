"""Workload configurations of the port (copies of ``repro.configs``): the
paper's hdiff grid (``hdiff``) and the LMs ported so far (recurrent, dense
and MoE)."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
