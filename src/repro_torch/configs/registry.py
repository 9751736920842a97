"""--arch registry of the port: maps architecture ids to configs.

Only the architectures whose blocks the port runs are registered: the two
recurrent LMs, RWKV-6 and RecurrentGemma. Every other id of the JAX
package's registry raises a ``KeyError`` that says so (ROADMAP M13).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: dict[str, str] = {
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}
_NOT_PORTED = (
    "llama-3.2-vision-90b", "starcoder2-3b", "nemotron-4-15b", "glm4-9b",
    "qwen1.5-0.5b", "qwen3-moe-235b-a22b", "arctic-480b", "hubert-xlarge",
)

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch yet (ROADMAP M13); "
                       f"ported: {sorted(_ARCH_MODULES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
