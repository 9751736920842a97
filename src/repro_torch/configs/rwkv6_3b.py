"""rwkv6-3b [ssm]: 32L, d_model 2560 (attention-free), d_ff 8960,
vocab 65536 — RWKV-6 "Finch" with data-dependent decay.
[arXiv:2404.05892; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    rwkv_head_size=64,
    # Chunked WKV (kernels/wkv6 formulation): 64-step chunks turn the
    # 4096-step sequential recurrence into 64 MXU-dense steps (§Perf rwkv6).
    rwkv_chunk=64,
    norm="layernorm",
    tied_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        rwkv_head_size=16,
        remat=False,
    )
