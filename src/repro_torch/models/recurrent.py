"""Recurrent token mixers: Griffin RG-LRU (RecurrentGemma) and RWKV-6 "Finch".

The port of ``repro/models/recurrent.py``. Prefill runs the recurrence
through a hand-written kernel where the JAX package runs jnp:

  * RG-LRU: ``h_t = a_t h_{t-1} + b_t`` through K6
    (:func:`repro_torch.kernels.rglru.rglru_scan`, ``h0 = 0``), where JAX
    runs ``jax.lax.associative_scan`` (the two orders differ by ulps).
  * RWKV-6: the matrix-valued state ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``
    through K7 (:func:`repro_torch.kernels.wkv6.wkv6`) when the prefill
    length is a multiple of ``rwkv_chunk``, where JAX runs
    ``wkv6_chunked_ref``; any other length takes the sequential step loop,
    as in JAX.

Decode is the single-step recurrence with an explicit state cache, plain
tensor code. On CPU tensors the kernels' wrappers run their plain versions.

Gradients: both kernels are differentiable. K6's backward is K6 again, on
reversed time; K7's is its own kernel (``wkv6_bwd_cuda``), where the JAX
package differentiates ``wkv6_chunked_ref``. On CPU tensors the backwards
run their plain versions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.layers import Init, dt, gelu, make_buf

Tensor = torch.Tensor
F32 = torch.float32

# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma) recurrent block.
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def init_rglru(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    d, w = cfg.d_model, cfg.rnn_width
    return {
        "w_gate": ini.fan_in((d, w)),
        "w_branch": ini.fan_in((d, w)),
        "conv_k": ini.fan_in((cfg.conv_width, w)),
        "conv_b": ini.zeros((w,)),
        "w_a": ini.fan_in((w, w)),
        "b_a": ini.zeros((w,)),
        "w_x": ini.fan_in((w, w)),
        "b_x": ini.zeros((w,)),
        # Lambda init so a = sigmoid(L) in [0.9, 0.999] (Griffin appendix).
        "lam": ini.const((w,), math.log(0.95 / (1 - 0.95))),
        "w_out": ini.fan_in((w, d)),
    }


def _rglru_gates(p, bx: Tensor):
    bx32 = bx.to(F32)
    r = torch.sigmoid(bx32 @ p["w_a"].to(F32) + p["b_a"].to(F32))
    i = torch.sigmoid(bx32 @ p["w_x"].to(F32) + p["b_x"].to(F32))
    log_a = -_RGLRU_C * r * F.softplus(p["lam"].to(F32))
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * (i * bx32)


def apply_rglru(cfg: ModelConfig, p, x: Tensor, *, cache: dict | None = None):
    """x: (B, S, D). cache = {"h": (B, W), "conv": (B, conv_width-1, W)}
    for decode; prefill (``cache=None``) starts from zeros. Returns
    ``(y, new cache)``."""
    cdt = dt(cfg, "compute")
    x = x.to(cdt)
    b, s, _ = x.shape
    cw = cfg.conv_width
    gate = gelu(x @ p["w_gate"].to(cdt))
    bx = x @ p["w_branch"].to(cdt)  # (B, S, W)

    # Depthwise causal conv, width conv_width.
    if cache is None:
        prevs = torch.zeros((b, cw - 1, cfg.rnn_width), dtype=cdt, device=x.device)
    else:
        prevs = cache["conv"].to(cdt)
    bx_pad = torch.cat([prevs, bx], dim=1)  # (B, S+cw-1, W)
    conv_k = p["conv_k"].to(cdt)
    conv = sum(bx_pad[:, i : i + s] * conv_k[i] for i in range(cw)) + p["conv_b"].to(cdt)

    a, bterm = _rglru_gates(p, conv)  # (B, S, W) f32 each
    if cache is None:
        h, _ = rglru_scan(a, bterm)  # K6
    else:
        h = (a[:, 0] * cache["h"].to(F32) + bterm[:, 0])[:, None, :]
    y = (h.to(cdt) * gate) @ p["w_out"].to(cdt)
    return y, {"h": h[:, -1].to(cdt), "conv": bx_pad[:, -(cw - 1):].to(cdt)}


def rglru_cache_init(cfg: ModelConfig, batch: int, *, device) -> dict:
    cdt = dt(cfg, "compute")
    return {
        "h": make_buf((batch, cfg.rnn_width), cdt, device),
        "conv": make_buf((batch, cfg.conv_width - 1, cfg.rnn_width), cdt, device),
    }


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay time-mix + channel-mix.
# ---------------------------------------------------------------------------

_LORA = 64


def init_rwkv_tmix(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    d, hs = cfg.d_model, cfg.rwkv_head_size
    p = {f"mu_{nm}": ini.const((d,), 0.5) for nm in ("x", "w", "k", "v", "r", "g")}
    for nm in ("w", "k", "v", "r", "g"):
        p[f"lora_a_{nm}"] = ini.fan_in((d, _LORA), scale=0.1)
        p[f"lora_b_{nm}"] = ini.zeros((_LORA, d))
    p["decay_base"] = ini.const((d,), -2.0)          # w0
    p["bonus"] = ini.const((d // hs, hs), 0.5)       # u
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        p[nm] = ini.fan_in((d, d))
    p["ln_scale"] = ini.ones((d,))                   # per-head groupnorm
    return p


def _ddlerp(p, nm: str, x: Tensor, xprev: Tensor, mix_base: Tensor) -> Tensor:
    lo = torch.tanh(mix_base @ p[f"lora_a_{nm}"].to(F32)) @ p[f"lora_b_{nm}"].to(F32)
    return x + (xprev - x) * (p[f"mu_{nm}"].to(F32) + lo)


def apply_rwkv_tmix(cfg: ModelConfig, p, x: Tensor, *, cache: dict | None = None):
    """RWKV-6 time mix. x: (B, S, D). cache = {"state": (B, H, hs, hs),
    "x_prev": (B, D)} for decode; prefill starts from zeros. Returns
    ``(out, new cache)`` with the final state."""
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    nh = d // hs
    x32 = x.to(F32)
    if cache is None:
        xprev = torch.cat([torch.zeros((b, 1, d), dtype=F32, device=x.device), x32[:, :-1]],
                          dim=1)
        state0 = torch.zeros((b, nh, hs, hs), dtype=F32, device=x.device)
    else:
        xprev = cache["x_prev"].to(F32)[:, None, :]
        state0 = cache["state"].to(F32)

    mix_base = x32 + (xprev - x32) * p["mu_x"].to(F32)
    xw, xk, xv, xr, xg = (_ddlerp(p, nm, x32, xprev, mix_base) for nm in "wkvrg")

    # Data-dependent per-channel decay in (0, 1): w = exp(-exp(w0 + lora)).
    dec = torch.exp(-torch.exp(
        p["decay_base"].to(F32)
        + torch.tanh(xw @ p["lora_a_w"].to(F32)) @ p["lora_b_w"].to(F32)))

    r = (xr @ p["wr"].to(F32)).reshape(b, s, nh, hs)
    k = (xk @ p["wk"].to(F32)).reshape(b, s, nh, hs)
    v = (xv @ p["wv"].to(F32)).reshape(b, s, nh, hs)
    g = xg @ p["wg"].to(F32)
    w = dec.reshape(b, s, nh, hs)
    u = p["bonus"].to(F32)

    if cfg.rwkv_chunk and s > 1 and s % cfg.rwkv_chunk == 0:
        y4, state = wkv6(r, k, v, w, u, state0, chunk=cfg.rwkv_chunk)  # K7 (and its backward)
        y = y4.reshape(b, s, d)
    else:
        state, ys = state0, []
        for t in range(s):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,hs,hs)
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u[..., :, None] * kv))
            state = w[:, t, :, :, None] * state + kv
        y = torch.stack(ys, dim=1).reshape(b, s, d)

    # Per-head groupnorm, then silu(g) gate and output projection.
    yh = y.reshape(b, s, nh, hs)
    mean = yh.mean(-1, keepdim=True)
    var = ((yh - mean) ** 2).mean(-1, keepdim=True)
    yh = (yh - mean) * torch.rsqrt(var + 1e-6)
    y = yh.reshape(b, s, d) * p["ln_scale"].to(F32)
    y = y * F.silu(g)
    out = y @ p["wo"].to(F32)
    return out.to(x.dtype), {"state": state.to(F32), "x_prev": x32[:, -1]}


def init_rwkv_cmix(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ini.const((d,), 0.5),
        "mu_r": ini.const((d,), 0.5),
        "wk": ini.fan_in((d, f)),
        "wv": ini.fan_in((f, d)),
        "wr": ini.fan_in((d, d)),
    }


def apply_rwkv_cmix(cfg: ModelConfig, p, x: Tensor, *, cache: dict | None = None):
    """RWKV channel mix (the FFN analogue). cache = {"x_prev": (B, D)}."""
    b, _, d = x.shape
    x32 = x.to(F32)
    if cache is None:
        xprev = torch.cat([torch.zeros((b, 1, d), dtype=F32, device=x.device), x32[:, :-1]],
                          dim=1)
    else:
        xprev = cache["x_prev"].to(F32)[:, None, :]
    xk = x32 + (xprev - x32) * p["mu_k"].to(F32)
    xr = x32 + (xprev - x32) * p["mu_r"].to(F32)
    kk = torch.square(F.relu(xk @ p["wk"].to(F32)))
    y = torch.sigmoid(xr @ p["wr"].to(F32)) * (kk @ p["wv"].to(F32))
    return y.to(x.dtype), {"x_prev": x32[:, -1]}


def rwkv_cache_init(cfg: ModelConfig, batch: int, *, device) -> dict:
    d, hs = cfg.d_model, cfg.rwkv_head_size
    return {
        "tmix": {"state": make_buf((batch, d // hs, hs, hs), F32, device),
                 "x_prev": make_buf((batch, d), F32, device)},
        "cmix": {"x_prev": make_buf((batch, d), F32, device)},
    }
