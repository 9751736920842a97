"""--arch registry of the port: maps architecture ids to configs.

The architectures whose blocks the port runs are registered: the two
recurrent LMs (RWKV-6, RecurrentGemma) and the four dense ones (qwen1.5,
starcoder2, nemotron-4, glm4). Every other id of the JAX package's
registry (MoE, cross-attention, audio) raises a ``KeyError`` that names
the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: dict[str, str] = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "nemotron-4-15b": "repro_torch.configs.nemotron4_15b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}
# The ROADMAP item that ports each other architecture of the JAX registry.
_NOT_PORTED = {
    "qwen3-moe-235b-a22b": "M13b.3 (MoE)", "arctic-480b": "M13b.3 (MoE)",
    "llama-3.2-vision-90b": "M13b.4 (cross-attention)",
    "hubert-xlarge": "M13b.4 (audio frontend)",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch yet (ROADMAP "
                       f"{_NOT_PORTED[arch]}); ported: {sorted(_ARCH_MODULES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
