"""Plain PyTorch versions of the RG-LRU linear recurrence.

The counterpart of ``repro/kernels/rglru/ref.py``:

    h_t = a_t * h_{t-1} + b_t        (elementwise over width)

Shapes: a, b (B, T, W); h0 (B, W). Both functions compute in float32 and
return ``(h (B, T, W), h_last (B, W))``.

  * :func:`rglru_seq_ref` — one step per token, a multiply then an add, as
    the Pallas kernel's ``_rglru_kernel`` does: the plain version K6 equals
    bit for bit on the card.
  * :func:`rglru_scan_ref` — the JAX oracle's formulation: ``h0`` folded
    into step 1, then an inclusive scan over time (here a loop; the JAX
    oracle's associative scan differs from it by ulps).
  * :func:`rglru_reverse_ref` — the adjoint recurrence the backward runs,
    ``g_t = a_next_t * g_{t+1} + d_t`` from ``g_T = 0``, backwards in time
    with the same multiply then add: the plain version K6 equals bit for
    bit when it runs the backward on reversed time.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def rglru_seq_ref(a: Tensor, b: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    h = h0.to(torch.float32)
    hs = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else torch.zeros_like(a32)
    return out, h


def rglru_scan_ref(a: Tensor, b: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    a32, b32 = a.to(torch.float32), b.to(torch.float32).clone()
    b32[:, 0] = b32[:, 0] + a32[:, 0] * h0.to(torch.float32)
    h = torch.zeros_like(b32[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1)
    return out, out[:, -1]


def rglru_reverse_ref(a_next: Tensor, d: Tensor) -> Tensor:
    """``g (B, T, W)`` f32 with ``g_t = a_next_t * g_{t+1} + d_t``, ``g_T = 0``."""
    a32, d32 = a_next.to(torch.float32), d.to(torch.float32)
    g = torch.zeros_like(d32[:, 0])
    gs = [None] * a_next.shape[1]
    for t in reversed(range(a_next.shape[1])):
        g = a32[:, t] * g + d32[:, t]
        gs[t] = g
    return torch.stack(gs, dim=1) if gs else torch.zeros_like(d32)
