"""Model zoo of the port: the recurrent LMs (RWKV-6, RecurrentGemma) and the
dense ones (qwen1.5, starcoder2, nemotron-4, glm4)."""

from repro_torch.models.lm import (
    LM,
    build_cache,
    build_lm,
    lm_decode,
    lm_forward,
    lm_forward_train,
    lm_loss,
    lm_params,
    lm_prefill,
)
