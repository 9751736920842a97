"""hubert-xlarge [audio]: 48L encoder-only, d_model 1280, 16H, d_ff 5120,
vocab 504 (cluster targets) — same backbone as wav2vec2.
[arXiv:2106.07447; unverified]

Audio frontend (conv feature extractor) is a stub, as in the JAX package:
input_specs provides precomputed frame embeddings (B, S, 1280)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    is_encoder=True,
    rope=False,
    activation="gelu",
    norm="layernorm",
    frontend="audio",
    tied_embeddings=False,
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
        vocab_size=64,
        remat=False,
    )
