"""starcoder2-3b [dense]: 30L, d_model 3072, 24H (GQA kv=2), d_ff 12288,
vocab 49152 — GQA, RoPE, sliding-window 4096 attention.
[arXiv:2402.19173; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    window=4096,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=100_000.0,
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
        window=8,
        remat=False,
    )
