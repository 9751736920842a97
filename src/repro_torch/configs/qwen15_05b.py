"""qwen1.5-0.5b [dense]: 24L, d_model 1024, 16H (GQA kv=16), d_ff 2816,
vocab 151936 — QKV bias, SwiGLU, tied embeddings. [hf:Qwen/Qwen1.5-0.5B; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=0,
        d_ff=128,
        vocab_size=256,
        remat=False,
    )
