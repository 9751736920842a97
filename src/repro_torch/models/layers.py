"""Transformer building blocks the recurrent LMs use: norms, RoPE, local
GQA attention with a ring cache, and the dense FFN.

The port of the parts of ``repro/models/layers.py`` that RWKV-6 and
RecurrentGemma run. Conventions, as there:

* A parameter group is a :class:`Params` module of named tensors (the JAX
  package's dict leaves, same names and shapes). Tensors are stored in
  ``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at use; softmax and
  norms run in float32.
* Attention caches are dicts ``{"k", "v"}`` of shape ``(B, L, K, Dh)`` plus
  a ``slot_pos (L,)`` table of absolute positions (-1 = empty): a ring of
  ``L = min(max_len, window)`` slots, ``slot = pos % L``. Unlike the JAX
  package, a decode step writes its slot IN PLACE and returns the same
  dict (one lane's cache is never read again after the step).

Not ported yet (ROADMAP M13): the flash scan and blocked local attention
for prefills longer than ``FLASH_THRESHOLD``, cross-attention, head
padding, ``qkv_bias`` and MoE.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

Tensor = torch.Tensor

# Prefill length above which the JAX package switches to its flash scan.
FLASH_THRESHOLD = 2048


def dt(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    return getattr(torch, cfg.param_dtype if kind == "param" else cfg.compute_dtype)


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------


class Params(nn.Module):
    """One parameter group: named tensors, read as ``p["name"]``. Inference
    only, so the parameters carry no gradient."""

    def __init__(self, tensors: dict[str, Tensor]):
        super().__init__()
        for name, value in tensors.items():
            self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str) -> Tensor:
        return self._parameters[name]


class Init:
    """Fan-in scaled initialiser on a :class:`torch.Generator`, mirroring
    the JAX package's ``PBuilder``: a normal draw in float32 scaled by
    ``scale / sqrt(fan_in)`` (fan-in over every axis but the last, unless
    ``fan_axes`` says otherwise), then cast to the parameter dtype."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype, device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def fan_in(self, shape, *, scale: float = 1.0, fan_axes=None) -> Tensor:
        fan = 1
        for i in fan_axes if fan_axes is not None else range(len(shape) - 1):
            fan *= shape[i]
        std = scale / math.sqrt(max(fan, 1))
        x = torch.randn(tuple(shape), generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (x * std).to(self.dtype)

    def const(self, shape, value: float) -> Tensor:
        return torch.full(tuple(shape), value, dtype=self.dtype, device=self.device)

    def zeros(self, shape) -> Tensor:
        return self.const(shape, 0.0)

    def ones(self, shape) -> Tensor:
        return self.const(shape, 1.0)


# ---------------------------------------------------------------------------
# Norms and RoPE.
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    p = {"scale": ini.ones((cfg.d_model,))}
    if cfg.norm == "layernorm":
        p["bias"] = ini.zeros((cfg.d_model,))
    return p


def apply_norm(cfg: ModelConfig, p, x: Tensor) -> Tensor:
    x32 = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        var = (x32**2).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + 1e-6) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rope_rotate(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding. x: (B, S, H, Dh); positions: (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs           # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (causal self-attention, sliding window, GQA, ring cache).
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    if cfg.qkv_bias or cfg.pad_heads_to:
        raise NotImplementedError("qkv_bias and head padding are not ported yet (ROADMAP M13)")
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ini.fan_in((d, h, dh)),
        "wk": ini.fan_in((d, k, dh)),
        "wv": ini.fan_in((d, k, dh)),
        "wo": ini.fan_in((h, dh, d)),
    }


def _project_qkv(cfg: ModelConfig, p, x: Tensor):
    cdt = dt(cfg, "compute")
    x = x.to(cdt)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    return q, k, v


def _gqa_scores(q: Tensor, k: Tensor) -> Tensor:
    """q: (B,S,H,Dh), k: (B,L,K,Dh) -> scores (B, H, S, L) with GQA groups."""
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, s, kheads, h // kheads, dh)
    return torch.einsum("bskgd,blkd->bkgsl", qg, k).reshape(b, h, s, k.shape[1])


def _gqa_out(w: Tensor, v: Tensor) -> Tensor:
    """w: (B,H,S,L), v: (B,L,K,Dh) -> (B,S,H,Dh)."""
    b, h, s, length = w.shape
    kheads = v.shape[2]
    wg = w.reshape(b, kheads, h // kheads, s, length)
    return torch.einsum("bkgsl,blkd->bskgd", wg, v).reshape(b, s, h, v.shape[-1])


def _self_mask(s: int, *, causal: bool, window: int, device) -> Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    return mask


def attention_apply(cfg: ModelConfig, p, x: Tensor, *, window: int = 0,
                    cache: dict | None = None, pos: int | None = None):
    """Causal self-attention, plain tensor code (matmul + masked softmax).

    Prefill: ``x (B,S,D)``, ``cache=None`` -> ``(y, None)``; S may not
    exceed ``FLASH_THRESHOLD``. Decode: ``x (B,1,D)`` with ``cache`` and
    the absolute position ``pos`` -> ``(y, cache)``, the cache updated in
    place.
    """
    cdt = dt(cfg, "compute")
    _, s, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(cfg, p, x)

    if cache is None:
        if s > FLASH_THRESHOLD:
            raise NotImplementedError(
                f"prefill of {s} tokens exceeds FLASH_THRESHOLD={FLASH_THRESHOLD}; the flash "
                "and blocked local-attention paths are not ported yet (ROADMAP M13)")
        if cfg.rope:
            positions = torch.arange(s, device=x.device)
            q = rope_rotate(q, positions, cfg.rope_theta)
            k = rope_rotate(k, positions, cfg.rope_theta)
        scores = _gqa_scores(q, k).to(torch.float32) * scale
        mask = _self_mask(s, causal=cfg.causal, window=window, device=x.device)
        scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(cdt)
        out = _gqa_out(w, v)
    else:
        if s != 1 or pos is None:
            raise ValueError("a decode step takes one token and its position")
        if cfg.rope:
            at = torch.full((1,), int(pos), device=x.device)
            q = rope_rotate(q, at, cfg.rope_theta)
            k = rope_rotate(k, at, cfg.rope_theta)
        cache = cache_write(cache, k[:, 0], v[:, 0], pos)
        slot_pos = cache["slot_pos"]
        scores = _gqa_scores(q, cache["k"].to(cdt)).to(torch.float32) * scale
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        if window:
            valid &= slot_pos > pos - window
        scores = torch.where(valid[None, None, None, :], scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(cdt)
        out = _gqa_out(w, cache["v"].to(cdt))
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))
    return y, cache


# -- cache ---------------------------------------------------------------


def make_buf(shape, dtype, device, fill=0) -> Tensor:
    return torch.full(tuple(shape), fill, dtype=dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, length: int, *, device) -> dict:
    """Empty attention cache of ``length`` slots (window ring or full)."""
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": make_buf(shape, dt(cfg, "compute"), device),
        "v": make_buf(shape, dt(cfg, "compute"), device),
        "slot_pos": make_buf((length,), torch.int32, device, fill=-1),
    }


def cache_write(cache: dict, k_t: Tensor, v_t: Tensor, pos: int) -> dict:
    """Writes one timestep (B,K,Dh) at slot ``pos % L``, in place."""
    slot = int(pos) % cache["k"].shape[1]
    cache["k"][:, slot] = k_t.to(cache["k"].dtype)
    cache["v"][:, slot] = v_t.to(cache["v"].dtype)
    cache["slot_pos"][slot] = int(pos)
    return cache


def cache_fill_from_prefill(cfg: ModelConfig, cache: dict, k: Tensor, v: Tensor) -> dict:
    """A new cache holding a prefill's (B,S,K,Dh) keys and values: all of
    them when S <= L, else the last L, ring-aligned so ``slot = pos % L``."""
    length = cache["k"].shape[1]
    s = k.shape[1]
    if s <= length:
        kk, vv, slot_pos = cache["k"].clone(), cache["v"].clone(), cache["slot_pos"].clone()
        kk[:, :s] = k.to(kk.dtype)
        vv[:, :s] = v.to(vv.dtype)
        slot_pos[:s] = torch.arange(s, dtype=torch.int32, device=k.device)
        return {"k": kk, "v": vv, "slot_pos": slot_pos}
    start = s - length
    positions = torch.arange(start, s, dtype=torch.int32, device=k.device)
    order = torch.argsort(positions % length)
    return {"k": k[:, start:][:, order].to(cache["k"].dtype),
            "v": v[:, start:][:, order].to(cache["v"].dtype),
            "slot_pos": positions[order]}


# ---------------------------------------------------------------------------
# FFN.
# ---------------------------------------------------------------------------


def init_ffn(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": ini.fan_in((d, f))}
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = ini.fan_in((d, f))
    p["w2"] = ini.fan_in((f, d))
    return p


def apply_ffn(cfg: ModelConfig, p, x: Tensor) -> Tensor:
    cdt = dt(cfg, "compute")
    x = x.to(cdt)
    h = x @ p["w1"].to(cdt)
    if cfg.activation == "swiglu":
        h = F.silu(h) * (x @ p["w3"].to(cdt))
    elif cfg.activation == "geglu":
        h = gelu(h) * (x @ p["w3"].to(cdt))
    elif cfg.activation == "gelu":
        h = gelu(h)
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.activation)
    return h @ p["w2"].to(cdt)
