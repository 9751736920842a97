"""Model zoo of the port: the recurrent LMs (RWKV-6, RecurrentGemma)."""

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
