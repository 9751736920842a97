"""Model zoo of the port: the recurrent LMs (RWKV-6, RecurrentGemma), the
dense ones (qwen1.5, starcoder2, nemotron-4, glm4), the MoE ones
(qwen3-moe, arctic), llama-3.2-vision (cross-attention) and hubert (an
audio encoder)."""

from repro_torch.models.lm import (
    LM,
    build_cache,
    build_lm,
    build_lm_pieces,
    cache_axes,
    cache_shardings,
    lm_decode,
    lm_forward,
    lm_forward_train,
    lm_loss,
    lm_params,
    lm_prefill,
    serving_shardings,
    shard_tree,
)
