"""llama-3.2-vision-90b [vlm]: 100L, d_model 8192, 64H (GQA kv=8),
d_ff 28672, vocab 128256 — cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Vision frontend is a stub, as in the JAX package: input_specs provides
precomputed image-patch embeddings as the cross-attention memory."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    frontend="vision",
    num_media_tokens=1024,
    tied_embeddings=False,
    rope_theta=500_000.0,
    moment_dtype="bfloat16",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=0,
        d_ff=128,
        vocab_size=256,
        num_media_tokens=8,
        remat=False,
    )
