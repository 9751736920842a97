"""nemotron-4-15b [dense]: 32L, d_model 6144, 48H (GQA kv=8), d_ff 24576,
vocab 256000 — GQA, squared-ReLU MLP, LayerNorm.
[arXiv:2402.16819; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="squared_relu",
    norm="layernorm",
    tied_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=0,
        d_ff=128,
        vocab_size=256,
        remat=False,
    )
