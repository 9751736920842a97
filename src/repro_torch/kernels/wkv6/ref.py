"""Plain PyTorch versions of the RWKV-6 WKV recurrence.

The counterpart of ``repro/kernels/wkv6/ref.py``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Shapes: r/k/v/w (B, T, H, N) with head size N; u (H, N); state
(B, H, N, N) keyed as state[k_dim, v_dim]. All math in float32.

  * :func:`wkv6_ref` — the sequential oracle, one step per token.
  * :func:`wkv6_chunked_ref` — the JAX package's chunked form (its bonus is
    a diagonal-masked einsum); the JAX model's prefill path.
  * :func:`wkv6_plain` — the Pallas kernel's chunk body
    (``kernels/wkv6/kernel.py:27-63``) in its own order, bonus
    ``sum(r * u * k) * v``, split into K7's three passes (chunk-local
    products, the scan over chunks, the outputs): the plain version K7 is
    held to on the card.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _zero_state(r: Tensor) -> Tensor:
    b, _, h, n = r.shape
    return torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)


def wkv6_ref(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
             state0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Sequential WKV-6: returns (y (B,T,H,N) f32, final state (B,H,N,N) f32)."""
    state = (_zero_state(r) if state0 is None else state0).to(torch.float32)
    r, k, v, w, u = (a.to(torch.float32) for a in (r, k, v, w, u))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u[..., :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(r)
    return y, state


def wkv6_chunked_ref(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                     state0: Tensor | None = None, chunk: int = 32) -> tuple[Tensor, Tensor]:
    """The JAX package's chunked form (GLA-style): the same math as
    :func:`wkv6_ref` with T/chunk sequential steps of dense einsums."""
    b, t, h, n = r.shape
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of chunk {chunk}")
    state = (_zero_state(r) if state0 is None else state0).to(torch.float32)
    c, nch = chunk, t // chunk
    rs, ks, vs, ws = (a.to(torch.float32).reshape(b, nch, c, h, n) for a in (r, k, v, w))
    u = u.to(torch.float32)
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), -1)
    diag = torch.eye(c, dtype=torch.bool, device=r.device)
    ys = []
    for i in range(nch):
        rc, kc, vc, wc = rs[:, i], ks[:, i], vs[:, i], ws[:, i]  # (B, C, H, N)
        logw = torch.log(torch.clamp_min(wc, 1e-30))
        cum = torch.cumsum(logw, dim=1)
        total = cum[:, -1:]
        r_dec = rc * torch.exp(cum - logw)
        y_inter = torch.einsum("bchk,bhkv->bchv", r_dec, state)
        k_dec = kc * torch.exp(-cum)
        att = torch.einsum("bchk,bshk->bhcs", r_dec, k_dec)
        att = torch.where(lower, att, 0.0)
        y_intra = torch.einsum("bhcs,bshv->bchv", att, vc)
        bonus = torch.einsum("bchk,bshk->bhcs", rc * u[None, None], kc)
        bonus = torch.where(diag, bonus, 0.0)
        y_bonus = torch.einsum("bhcs,bshv->bchv", bonus, vc)
        k_tail = kc * torch.exp(total - cum)
        state = torch.exp(total)[:, 0, :, :, None] * state + torch.einsum(
            "bshk,bshv->bhkv", k_tail, vc)
        ys.append(y_inter + y_intra + y_bonus)
    return torch.stack(ys, dim=1).reshape(b, t, h, n), state


def wkv6_plain(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor, state0: Tensor,
               *, chunk: int = 64) -> tuple[Tensor, Tensor]:
    """K7's plain version: the Pallas kernel's per-chunk body, in the
    kernel's three passes and batched over (B, H) and the chunks.
    ``chunk`` is clamped to T, which it must divide.

    (a) each chunk's ``k_tail^T v`` and ``exp(total)``; (b) the scan over
    chunks, ``S <- exp(total) * S + k_tail^T v``, keeping the state that
    enters each chunk; (c) each chunk's ``(r_dec S + tril(r_dec k_dec^T, -1)
    v) + sum(r * u * k) * v``."""
    b, t, h, n = r.shape
    c = min(chunk, t)
    if c < 1 or t % c:
        raise ValueError(f"sequence length {t} is not a positive multiple of chunk {c}")
    nch = t // c
    # (B, H, chunks, C, N): one (C, N) block per chunk of each (batch, head) stream.
    rs, ks, vs, ws = (a.to(torch.float32).transpose(1, 2).reshape(b, h, nch, c, n)
                      for a in (r, k, v, w))
    logw = torch.log(torch.clamp_min(ws, 1e-30))
    cum = torch.cumsum(logw, dim=3)
    total = cum[:, :, :, -1:]
    # (a) chunk-local state products.
    kv = (ks * torch.exp(total - cum)).transpose(-1, -2) @ vs
    decay = torch.exp(total[:, :, :, 0])[..., None]
    # (b) the inter-chunk scan.
    state = state0.to(torch.float32)
    entering = []
    for i in range(nch):
        entering.append(state)
        state = decay[:, :, i] * state + kv[:, :, i]
    # (c) the outputs.
    r_dec = rs * torch.exp(cum - logw)
    k_dec = ks * torch.exp(-cum)
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), -1)
    att = torch.where(lower, r_dec @ k_dec.transpose(-1, -2), 0.0)
    bonus = torch.sum(rs * u.to(torch.float32)[None, :, None, None, :] * ks, dim=-1, keepdim=True)
    y = (r_dec @ torch.stack(entering, dim=2) + att @ vs) + bonus * vs
    return y.reshape(b, h, t, n).transpose(1, 2).contiguous(), state
