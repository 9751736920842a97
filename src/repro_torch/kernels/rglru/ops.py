"""Public entry point for the RG-LRU scan kernel (the counterpart of
``repro/kernels/rglru/ops.py``). A CUDA tensor launches K6, a CPU tensor
computes its plain version. The Pallas ``block_w`` and ``interpret`` knobs
have no counterpart: the wrapper plans the kernel's channel tile and ring
stages itself (:func:`~repro_torch.kernels.rglru.kernel.plan_scan`)."""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_cuda


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b (B, T, W); h0 (B, W) or ``None`` (zeros) -> (h (B, T, W) f32,
    h_last (B, W) f32)."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    return rglru_scan_cuda(a, b, h0.to(torch.float32).contiguous())
