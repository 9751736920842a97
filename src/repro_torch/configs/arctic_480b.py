"""arctic-480b [moe]: 35L, d_model 7168, 56H (GQA kv=8), expert d_ff 4864,
vocab 32000, MoE 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]

Memory posture: 480B params -> Adafactor (factored second moment, no first
moment) so optimizer state stays ~O(params); Adam m/v would not fit 16
GiB/chip on the single-pod mesh."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    # 56 heads don't divide the 16-way model axis; pad to 64 with
    # hard-masked (exactly dead) heads so attention shards (see layers.py).
    pad_heads_to=64,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    tied_embeddings=False,
    optimizer="adafactor",
    moment_dtype="bfloat16",
    # 480B params: bf16 storage (Adafactor-friendly); f32 master copies
    # would alone exceed a 256-chip pod's HBM.
    param_dtype="bfloat16",
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
