"""glm4-9b [dense]: 40L, d_model 4096, 32H (GQA kv=2), d_ff 13696,
vocab 151552 — RoPE, GQA, SwiGLU. [hf:THUDM/glm-4-9b; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
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
        d_ff=96,
        vocab_size=256,
        remat=False,
    )
