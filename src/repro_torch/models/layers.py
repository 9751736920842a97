"""Transformer building blocks: norms, RoPE, GQA self-attention (full,
sliding-window, flash-style for long prefills, blocked local) with a ring
cache, and the dense FFN.

The port of the parts of ``repro/models/layers.py`` that the recurrent LMs
(RWKV-6, RecurrentGemma) and the dense ones (qwen1.5, starcoder2,
nemotron-4, glm4) run. Conventions, as there:

* A parameter group is a :class:`Params` module of named tensors (the JAX
  package's dict leaves, same names and shapes). Tensors are stored in
  ``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at use; softmax and
  norms run in float32.
* Attention caches are dicts ``{"k", "v"}`` of shape ``(B, L, K, Dh)`` plus
  a ``slot_pos (L,)`` table of absolute positions (-1 = empty): a ring of
  ``L = min(max_len, window)`` slots, ``slot = pos % L``. Unlike the JAX
  package, a decode step writes its slot IN PLACE and returns the same
  dict (one lane's cache is never read again after the step).

* A prefill longer than ``FLASH_THRESHOLD`` (or ``force_flash=True``)
  runs the JAX package's chunked online-softmax scan (:func:`_flash_fwd_scan`,
  ``FLASH_CHUNK`` keys a step) with its recompute backward
  (:class:`_FlashCore`), or, for causal sliding-window attention whose
  window and length share a block size, the blocked local path
  (:func:`_local_attention_blocked`). Both are plain tensor code, as the
  jnp is: no library attention kernel, the same ``-1e30`` fill and the
  same output (zero) on a row with no visible key. The JAX package's
  sharding constraints are no-ops on one device and are dropped.

Not ported yet (ROADMAP M13b.3-4): cross-attention and MoE.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

Tensor = torch.Tensor

# Prefill length above which the no-cache path switches to the chunked
# online-softmax (flash-style) scan, and the keys it takes a step.
FLASH_THRESHOLD = 2048
FLASH_CHUNK = 512


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

    def __contains__(self, name: str) -> bool:
        return name in self._parameters


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
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.pad_heads_to:
        # Padded heads are drawn like the rest and killed by a mask at use
        # (attention_apply): zero output, zero gradient to their weights.
        h = max(h, cfg.pad_heads_to)
    p = {
        "wq": ini.fan_in((d, h, dh)),
        "wk": ini.fan_in((d, k, dh)),
        "wv": ini.fan_in((d, k, dh)),
        "wo": ini.fan_in((h, dh, d)),
    }
    if cfg.qkv_bias:
        p.update(bq=ini.zeros((h, dh)), bk=ini.zeros((k, dh)), bv=ini.zeros((k, dh)))
    return p


def _project_qkv(cfg: ModelConfig, p, x: Tensor):
    cdt = dt(cfg, "compute")
    x = x.to(cdt)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
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


# -- flash-style and blocked local attention (long prefills) -----------------


def _chunk_mask(rows: Tensor, i: int, chunk: int, causal: bool, window: int) -> Tensor:
    cols = i * chunk + torch.arange(chunk, device=rows.device)
    mask = torch.ones((rows.shape[0], chunk), dtype=torch.bool, device=rows.device)
    if causal:
        mask &= cols[None, :] <= rows[:, None]
    if window:
        mask &= cols[None, :] > rows[:, None] - window
    return mask


def _flash_fwd_scan(q, k, v, *, causal: bool, window: int, scale: float, chunk: int,
                    unroll: bool = False, row_offset: int = 0):
    """Returns ``(out (B,H,Sq,Dh) f32, lse (B,H,Sq) f32)``: one step per
    ``chunk`` keys, folding each into a running (max, denominator,
    accumulator). ``k``/``v`` may be longer than ``q``; ``row_offset``
    places q's rows at absolute positions ``row_offset + arange(Sq)`` of
    the key axis. ``unroll`` (the JAX package's choice between ``lax.scan``
    and an unrolled loop) has no effect: the steps are a Python loop."""
    b, s, h, dh = q.shape
    n_chunks = k.shape[1] // chunk
    rows = row_offset + torch.arange(s, device=q.device)
    f32 = torch.float32
    m = torch.full((b, h, s), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((b, h, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, s, dh), dtype=f32, device=q.device)
    for i in range(n_chunks):
        ks, vs = k[:, i * chunk:(i + 1) * chunk], v[:, i * chunk:(i + 1) * chunk]
        sc = torch.einsum("bshd,bchd->bhsc", q, ks).to(f32) * scale
        mask = _chunk_mask(rows, i, chunk, causal, window)[None, None]
        sc = torch.where(mask, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhsc,bchd->bhsd", p.to(vs.dtype), vs).to(f32)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


class _FlashCore(torch.autograd.Function):
    """Flash attention with the JAX package's recompute backward
    (``_flash_core`` and its ``custom_vjp``): the S x S scores never exist
    whole; the backward recomputes each chunk's probabilities from the
    saved log-sum-exp and folds in the row term ``delta = sum(dOut * Out)``.
    q: (B,Sq,H,Dh); k/v: (B,Skv,H,Dh), KV already repeated to H heads;
    returns (B,Sq,H,Dh) in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, chunk, unroll, row_offset):
        out, lse = _flash_fwd_scan(q, k, v, causal=causal, window=window, scale=scale,
                                   chunk=chunk, unroll=unroll, row_offset=row_offset)
        out = out.transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, chunk, row_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, chunk, row_offset = ctx.args
        f32 = torch.float32
        rows = row_offset + torch.arange(q.shape[1], device=q.device)
        g32 = g.to(f32)
        delta = torch.einsum("bshd,bshd->bhs", g32, out.to(f32))
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dks, dvs = [], []
        for i in range(k.shape[1] // chunk):
            ks, vs = k[:, i * chunk:(i + 1) * chunk], v[:, i * chunk:(i + 1) * chunk]
            sc = torch.einsum("bshd,bchd->bhsc", q, ks).to(f32) * scale
            mask = _chunk_mask(rows, i, chunk, causal, window)[None, None]
            p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
            dvs.append(torch.einsum("bhsc,bshd->bchd", p, g32))
            dp = torch.einsum("bshd,bchd->bhsc", g32, vs.to(f32))
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhsc,bchd->bshd", ds, ks.to(f32))
            dks.append(torch.einsum("bhsc,bshd->bchd", ds, q.to(f32)))
        dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None, None


def _flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, window: int,
                     scale: float, chunk: int = FLASH_CHUNK, unroll: bool = False) -> Tensor:
    """Repeats GQA KV heads to H, then runs :class:`_FlashCore`; causal
    sliding-window attention whose window and length share a block size
    takes :func:`_local_attention_blocked` instead."""
    h, kheads = q.shape[2], k.shape[2]
    if kheads != h:
        k = torch.repeat_interleave(k, h // kheads, dim=2)
        v = torch.repeat_interleave(v, h // kheads, dim=2)
    s = q.shape[1]
    if causal and window and _pick_block_size(s, window):
        return _local_attention_blocked(q, k, v, window=window, scale=scale)
    if s % chunk:
        raise ValueError(f"flash attention: sequence length {s} is not a multiple of its "
                         f"chunk {chunk}")
    return _FlashCore.apply(q, k, v, causal, window, scale, chunk, unroll, 0)


def _pick_block_size(s: int, window: int, target_blocks: int = 16) -> int | None:
    """Sub-block size for windowed attention: the largest divisor of both
    ``window`` and ``s`` that still yields >= ``target_blocks`` blocks;
    else the smallest feasible divisor, or None if blocking is impossible."""
    min_bs = min(128, max(window // 2, 1))
    cands = [b for b in range(min_bs, window + 1)
             if window % b == 0 and s % b == 0 and s // b >= 2]
    if not cands:
        return None
    good = [b for b in cands if s // b >= target_blocks]
    return max(good) if good else min(cands)


def _local_attention_blocked(q: Tensor, k: Tensor, v: Tensor, *, window: int,
                             scale: float) -> Tensor:
    """Causal sliding-window attention by sub-blocks and their halo: each
    block of ``bs`` queries attends to the ``window // bs`` blocks before it
    and its own (zeros before the sequence start, masked), O(S * window)
    work instead of a masked S x S pass. q/k/v: (B,S,H,Dh), KV repeated."""
    b, s, h, dh = q.shape
    bs = _pick_block_size(s, window)
    r = window // bs  # halo radius in blocks
    nb = s // bs
    qb, kb, vb = (x.reshape(b, nb, bs, h, dh) for x in (q, k, v))

    def shift(x, by):
        return torch.cat([torch.zeros_like(x[:, :by]), x[:, :-by]], dim=1) if by else x

    # context = (prev_r ++ ... ++ prev_1 ++ cur): (B, nb, (r+1)*bs, H, Dh)
    kk = torch.cat([shift(kb, i) for i in range(r, -1, -1)], dim=2)
    vv = torch.cat([shift(vb, i) for i in range(r, -1, -1)], dim=2)
    sc = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kk).to(torch.float32) * scale
    dev = q.device
    rows = torch.arange(bs, device=dev)[:, None]            # q position within block
    cols = torch.arange((r + 1) * bs, device=dev)[None, :]  # position within halo context
    rel = cols - r * bs - rows                              # kv offset relative to q
    mask = (rel <= 0) & (rel > -window)
    blk = torch.arange(nb, device=dev)[:, None, None]
    glob_col = (blk - r) * bs + cols[None]
    m = mask[None] & (glob_col >= 0)
    sc = torch.where(m[None, :, None], sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", w.to(vv.dtype), vv)
    return out.reshape(b, s, h, dh)


def attention_apply(cfg: ModelConfig, p, x: Tensor, *, window: int = 0,
                    cache: dict | None = None, pos: int | None = None,
                    force_flash: bool | None = None):
    """Causal self-attention, plain tensor code.

    Prefill: ``x (B,S,D)``, ``cache=None`` -> ``(y, None)``: a masked
    softmax up to ``FLASH_THRESHOLD`` tokens, the flash-style scan (or the
    blocked local path) above it or when ``force_flash`` says so. Decode:
    ``x (B,1,D)`` with ``cache`` and the absolute position ``pos`` ->
    ``(y, cache)``, the cache updated in place.
    """
    cdt = dt(cfg, "compute")
    _, s, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(cfg, p, x)

    if cache is None:
        if cfg.rope:
            positions = torch.arange(s, device=x.device)
            q = rope_rotate(q, positions, cfg.rope_theta)
            k = rope_rotate(k, positions, cfg.rope_theta)
        use_flash = force_flash if force_flash is not None else s > FLASH_THRESHOLD
        if use_flash:
            out = _flash_attention(q, k, v, causal=cfg.causal, window=window, scale=scale,
                                   chunk=min(FLASH_CHUNK, s), unroll=cfg.flash_unroll)
        else:
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
    if cfg.pad_heads_to and cfg.pad_heads_to > cfg.n_heads:
        # Kill padded heads exactly (zero output, zero gradient to their
        # weights). Group-major: each of the n_kv groups holds g_new heads,
        # of which the last g_new - g_real are dead, so every real head
        # keeps its KV group.
        h_pad = out.shape[2]
        g_new, g_real = h_pad // cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        head_mask = ((torch.arange(h_pad, device=out.device) % g_new) < g_real).to(out.dtype)
        out = out * head_mask[None, None, :, None]
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
