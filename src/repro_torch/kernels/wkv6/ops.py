"""Public entry point for the WKV-6 kernel (the counterpart of
``repro/kernels/wkv6/ops.py``). A CUDA tensor launches K7, a CPU tensor
computes its plain version; the Pallas-only ``interpret`` knob has no
counterpart."""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import wkv6_cuda


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor | None = None, *, chunk: int = 64
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, T, H, N), u (H, N), state0 (B, H, N, N) or ``None``
    (zeros) -> (y (B, T, H, N) f32, final state (B, H, N, N) f32)."""
    b, _, h, n = r.shape
    if state0 is None:
        state0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    return wkv6_cuda(r, k, v, w, u, state0, chunk=chunk)
