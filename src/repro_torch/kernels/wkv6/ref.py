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
  * :func:`wkv6_backward_plain` — the gradient of the chunked form in the
    three passes of K7's backward kernel (``csrc/wkv6_bwd.cu``): the plain
    version that kernel is held to, and the CPU's backward of
    :class:`~repro_torch.kernels.wkv6.ops.WKV6`.
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


def wkv6_backward_plain(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                        state0: Tensor, dy: Tensor, ds_t: Tensor | None = None, *,
                        chunk: int = 64) -> tuple[Tensor, ...]:
    """The gradient of :func:`wkv6_plain` for cotangents ``dy`` on y and
    ``ds_t`` on the final state (``None``: zeros): ``(dr, dk, dv, dw)``
    (B, T, H, N), ``du`` (H, N) and ``dstate0`` (B, H, N, N), float32.

    Per chunk, with ``r~ = r exp(cum - logw)``, ``k~ = k exp(-cum)``,
    ``k^ = k exp(total - cum)``, ``A = tril(r~ k~^T, -1)``, ``P = dy v^T``,
    S the state entering the chunk and G the cotangent of the state
    leaving it: (a') each chunk's ``k^^T v``, ``r~^T dy`` and
    ``exp(total)``; (b') the forward scan for every S, then the reverse
    scan ``G <- exp(total) G + r~^T dy`` from ``ds_t`` down to
    ``dstate0``; (c') ``dv = A^T dy + bonus dy + k^ G``, ``dr~ = dy S^T +
    tril(P, -1) k~``, ``dk~ = tril(P, -1)^T r~``, ``dk^ = v G^T``, then
    ``dr``, ``dk`` and ``du`` (the bonus terms, ``diag(P)``) and ``dlogw_tau
    = sum_{t>tau} dr~ r~ - sum_{s>=tau} dk~ k~ + sum_{s<tau} dk^ k^ +
    exp(total) sum_j G S``, ``dw = dlogw / w`` where ``w > 1e-30``."""
    b, t, h, n = r.shape
    c = min(chunk, t)
    if c < 1 or t % c:
        raise ValueError(f"sequence length {t} is not a positive multiple of chunk {c}")
    nch = t // c
    rs, ks, vs, ws, dys = (a.to(torch.float32).transpose(1, 2).reshape(b, h, nch, c, n)
                           for a in (r, k, v, w, dy))
    u32 = u.to(torch.float32)[None, :, None, None, :]
    logw = torch.log(torch.clamp_min(ws, 1e-30))
    cum = torch.cumsum(logw, dim=3)
    total = cum[:, :, :, -1:]
    r_fac, k_fac, t_fac = torch.exp(cum - logw), torch.exp(-cum), torch.exp(total - cum)
    r_dec, k_dec, k_tail = rs * r_fac, ks * k_fac, ks * t_fac
    decay = torch.exp(total[:, :, :, 0])[..., None]  # (B, H, chunks, N, 1)
    # (a') chunk-local products.
    kv = k_tail.transpose(-1, -2) @ vs
    rdy = r_dec.transpose(-1, -2) @ dys
    # (b') the state entering each chunk, then the cotangent leaving it.
    state = state0.to(torch.float32)
    entering = []
    for i in range(nch):
        entering.append(state)
        state = decay[:, :, i] * state + kv[:, :, i]
    g = torch.zeros_like(state) if ds_t is None else ds_t.to(torch.float32)
    leaving = [g] * nch
    for i in reversed(range(nch)):
        leaving[i] = g
        g = decay[:, :, i] * g + rdy[:, :, i]
    s_in, g_out = torch.stack(entering, dim=2), torch.stack(leaving, dim=2)
    # (c') the chunk gradients.
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), -1)
    att = torch.where(lower, r_dec @ k_dec.transpose(-1, -2), 0.0)
    p = dys @ vs.transpose(-1, -2)
    p_low = torch.where(lower, p, 0.0)
    p_diag = torch.diagonal(p, dim1=-2, dim2=-1)[..., None]  # (B, H, chunks, C, 1)
    bonus = torch.sum(rs * u32 * ks, dim=-1, keepdim=True)
    dv = (att.transpose(-1, -2) @ dys + bonus * dys) + k_tail @ g_out
    dr_dec = dys @ s_in.transpose(-1, -2) + p_low @ k_dec
    dk_dec = p_low.transpose(-1, -2) @ r_dec
    dk_tail = vs @ g_out.transpose(-1, -2)
    q, pk, hk = dr_dec * r_dec, dk_dec * k_dec, dk_tail * k_tail
    z = decay[..., 0] * torch.sum(g_out * s_in, dim=-1)  # (B, H, chunks, N)
    after_q = torch.flip(torch.cumsum(torch.flip(q, (3,)), dim=3), (3,)) - q
    from_p = torch.flip(torch.cumsum(torch.flip(pk, (3,)), dim=3), (3,))
    before_h = torch.cumsum(hk, dim=3) - hk
    dlogw = ((after_q - from_p) + before_h) + z[:, :, :, None]
    dw = torch.where(ws > 1e-30, dlogw / ws, 0.0)
    dr = dr_dec * r_fac + p_diag * u32 * ks
    dk = (dk_dec * k_fac + dk_tail * t_fac) + p_diag * u32 * rs
    du = torch.sum(p_diag * rs * ks, dim=3).sum(dim=(0, 2))

    def out(x):
        return x.reshape(b, h, t, n).transpose(1, 2).contiguous()

    return out(dr), out(dk), out(dv), out(dw), du, g
