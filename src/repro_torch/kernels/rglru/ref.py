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
