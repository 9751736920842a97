"""--arch registry of the port: maps architecture ids to configs, and the
shape cells each architecture runs.

Every architecture of the JAX package's registry is registered, in its
order: the two recurrent LMs (RWKV-6, RecurrentGemma), the four dense ones
(qwen1.5, starcoder2, nemotron-4, glm4), the two MoE ones (qwen3-moe,
arctic), llama-3.2-vision (cross-attention over media tokens) and
hubert-xlarge (an audio encoder over frame embeddings). Each exposes
``CONFIG`` (the published shape) and ``smoke_config()`` (a reduced
same-family variant for CPU tests).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES: dict[str, str] = {
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "nemotron-4-15b": "repro_torch.configs.nemotron4_15b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable_cells(arch: str) -> list[str]:
    """The shape cells ``arch`` runs: train and prefill always, decode
    where it decodes (not the encoder), the 500k-token decode only for the
    sub-quadratic archs."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k"]
    if cfg.supports_decode:
        cells.append("decode_32k")
        if cfg.sub_quadratic:
            cells.append("long_500k")
    return cells


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in applicable_cells(a)]


def scale_for_smoke(shape: ShapeConfig, seq: int = 64, batch: int = 2) -> ShapeConfig:
    return dataclasses.replace(shape, seq_len=seq, global_batch=batch)
