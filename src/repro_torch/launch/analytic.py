"""Analytic FLOP/byte model for every (arch x shape) cell (the port's copy of
``repro/launch/analytic.py``, line for line).

This is the LM-side counterpart of the paper's §3.1 analytical modeling
(Eq. 5-10 count MACs and streamed words per hdiff output point; here we
count them per token per layer). Used to (a) cross-validate the compiled
cost analysis — XLA's cost model ignores `while` trip counts, so the
dry-run extrapolates from unrolled variants and checks against this — and
(b) provide honest totals for cells whose inner time-scans (RWKV/RG-LRU
prefill) can't be unrolled.

All counts are GLOBAL (whole step, all devices): divide by n_devices for
per-chip terms. FLOPs are dense-matmul convention (2 * M * N * K).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _attn_flops_per_token(cfg: ModelConfig, ctx: int, *, causal: bool, window: int) -> float:
    """One attention layer, one token, forward."""
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * d * (h + 2 * k) * dh + 2 * h * dh * d       # qkv + out proj
    eff = min(ctx, window) if window else ctx
    if causal and not window:
        eff = ctx / 2  # average causal context during a full forward
    elif causal and window:
        eff = min(ctx / 2, window) if ctx <= 2 * window else window
    score_ctx = 2 * h * dh * eff * 2                        # qk^T + pv
    return proj + score_ctx


def _ffn_flops_per_token(cfg: ModelConfig, kind: str) -> float:
    d, f = cfg.d_model, cfg.d_ff
    if kind == "rwkv6":
        # channel mix: wk (d->f), wv (f->d), wr (d->d)
        return 2 * d * f * 2 + 2 * d * d
    if cfg.n_experts:
        moe = 2 * d * cfg.n_experts + cfg.top_k * 3 * 2 * d * f
        if cfg.moe_dense_residual:
            moe += 3 * 2 * d * f
        return moe
    mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return mult * 2 * d * f


def _mixer_flops_per_token(cfg: ModelConfig, kind: str, ctx: int) -> float:
    d = cfg.d_model
    if kind in ("attn", "local_attn"):
        return _attn_flops_per_token(cfg, ctx, causal=cfg.causal, window=cfg.window)
    if kind == "cross_attn":
        d_, h, kk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        proj_q = 2 * d_ * h * dh + 2 * h * dh * d_
        # media K/V projected once per sequence; amortised per token below
        score = 2 * h * dh * cfg.num_media_tokens * 2
        return proj_q + score
    if kind == "rglru":
        w = cfg.rnn_width
        return (
            3 * 2 * d * w          # gate, branch, out projections
            + 2 * cfg.conv_width * w
            + 2 * 2 * w * w        # r/i gates (full-rank)
            + 12 * w               # recurrence pointwise
        )
    if kind == "rwkv6":
        hs = cfg.rwkv_head_size
        lora = 64
        return (
            5 * 2 * d * d          # r,k,v,g,o projections
            + 5 * 2 * 2 * d * lora # ddlerp loras
            + 8 * d * hs           # wkv state update + readout
        )
    raise ValueError(kind)


def forward_flops(cfg: ModelConfig, n_tokens: float, ctx: int) -> float:
    """Forward-pass FLOPs for n_tokens tokens with context length ctx."""
    per_tok = 0.0
    for kind in cfg.layer_kinds:
        per_tok += _mixer_flops_per_token(cfg, kind, ctx)
        per_tok += _ffn_flops_per_token(cfg, kind)
    per_tok += 2 * cfg.d_model * cfg.vocab_size  # lm head
    return per_tok * n_tokens


def cell_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, float]:
    """Global FLOPs for one step of the cell, plus the 6ND/2ND reference."""
    b, s = shape.global_batch, shape.seq_len
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        fwd = forward_flops(cfg, b * s, s)
        # remat: bwd = 2x fwd + ~1x recompute -> compiled ~= 4x fwd
        total = fwd * (4.0 if cfg.remat else 3.0)
        ref = 6 * n_act * b * s
    elif shape.kind == "prefill":
        total = forward_flops(cfg, b * s, s)
        ref = 2 * n_act * b * s
    else:  # decode: one token at full context
        total = forward_flops(cfg, b, s) * _decode_ctx_scale(cfg, s)
        ref = 2 * n_act * b
    return {"analytic": total, "reference_nd": ref}


def _decode_ctx_scale(cfg: ModelConfig, s: int) -> float:
    # forward_flops already uses ctx=s; decode reads the FULL cache (not the
    # causal average), handled inside _attn_flops (causal avg only applies
    # to full forwards) — here ctx is exact, so no extra scale.
    return 1.0


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Minimum global HBM traffic per step (params + optimizer + major
    activations/caches), the fused-kernel-style compulsory-traffic bound."""
    pbytes = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    mbytes = {"float32": 4, "bfloat16": 2}[cfg.moment_dtype]
    n_params = cfg.param_count()
    b, s = shape.global_batch, shape.seq_len
    act_bytes = 2  # bf16 activations

    if shape.kind == "train":
        # params read + grad write + adam moments r/w (adafactor ~= 1x read)
        opt_mult = 4 * mbytes if cfg.optimizer == "adamw" else mbytes
        param_traffic = n_params * (pbytes + 4 + opt_mult)
        act_traffic = b * s * cfg.d_model * cfg.n_layers * act_bytes * 4
        return param_traffic + act_traffic
    if shape.kind == "prefill":
        cache_w = _cache_bytes(cfg, b, s)
        return n_params * pbytes + cache_w + b * s * cfg.d_model * cfg.n_layers * act_bytes * 2
    # decode: read all ACTIVE params + read cache once
    n_active = cfg.active_param_count()
    return n_active * pbytes + _cache_bytes(cfg, b, s)


def _cache_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "local_attn"):
            eff = min(s, cfg.window) if cfg.window else s
            total += b * eff * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        elif kind == "cross_attn":
            total += b * cfg.num_media_tokens * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        elif kind == "rglru":
            total += b * cfg.rnn_width * (cfg.conv_width + 1) * 2
        elif kind == "rwkv6":
            hs = cfg.rwkv_head_size
            total += b * (cfg.d_model // hs) * hs * hs * 4 + 2 * b * cfg.d_model * 4
    return total
