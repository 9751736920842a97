"""recurrentgemma-2b [hybrid]: 26L, d_model 2560, 10H (MQA kv=1),
d_ff 7680 (GeGLU), vocab 256000 — RG-LRU + local attention, 1 attn per
2 recurrent (Griffin pattern), window 2048. [arXiv:2402.19427; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    activation="geglu",
    block_pattern=("rglru", "rglru", "local_attn"),
    rnn_width=2560,
    conv_width=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        window=8,
        rnn_width=64,
        remat=False,
    )
