"""qwen3-moe-235b-a22b [moe]: 94L, d_model 4096, 64H (GQA kv=4),
expert d_ff 1536, vocab 151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    tied_embeddings=False,
    moment_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=0,
        d_ff=32,
        vocab_size=256,
        n_experts=8,
        top_k=2,
        remat=False,
    )
