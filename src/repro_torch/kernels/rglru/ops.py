"""Public entry point for the RG-LRU scan kernel (the counterpart of
``repro/kernels/rglru/ops.py``). A CUDA tensor launches K6, a CPU tensor
computes its plain version. The Pallas ``block_w`` and ``interpret`` knobs
have no counterpart: the wrapper plans the kernel's channel tile and ring
stages itself (:func:`~repro_torch.kernels.rglru.kernel.plan_scan`). A
meta tensor takes the CUDA route's allocations and launches nothing (the
dry run).

Gradients. When an input requires grad, :func:`rglru_scan` runs through
:class:`RGLRUScan`, whose backward is the same linear recurrence run
backwards in time. For ``h_t = a_t h_{t-1} + b_t`` with cotangents ``dh_t``
(and ``dh_last`` on ``h_T``), the adjoint is ``g_t = dh_t + a_{t+1} g_{t+1}``
(``dh_last`` folded into ``dh_T``); then ``db = g``, ``da_t = g_t h_{t-1}``
and ``dh0 = a_1 g_1``. On a CUDA tensor K6 computes ``g`` itself, on the
time-reversed ``a`` shifted by one step with ``dh`` as ``b``; the flips and
the shift are tensor glue. On a CPU tensor the plain reverse recurrence
(:func:`~repro_torch.kernels.rglru.ref.rglru_reverse_ref`) does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru.ref import rglru_reverse_ref

Tensor = torch.Tensor


def rglru_reverse(a_next: Tensor, d: Tensor) -> Tensor:
    """``g_t = a_next_t * g_{t+1} + d_t`` from ``g_T = 0`` (f32): K6 over the
    reversed time axis on a CUDA (or meta) tensor, the plain loop on a CPU
    one."""
    if a_next.device.type == "cpu":
        return rglru_reverse_ref(a_next, d)
    zeros = torch.zeros((d.shape[0], d.shape[2]), dtype=torch.float32, device=d.device)
    g, _ = rglru_scan_cuda(a_next.flip(1).contiguous(), d.flip(1).contiguous(), zeros)
    return g.flip(1)


def rglru_backward(a: Tensor, h: Tensor, h0: Tensor, dh: Tensor, dh_last: Tensor
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """``(da, db, dh0)`` in float32 of the scan that gave ``h`` from ``a``
    and ``h0``, for cotangents ``dh`` on every ``h`` and ``dh_last`` on the
    last one."""
    if a.shape[1] == 0:
        return torch.zeros_like(h), torch.zeros_like(h), dh_last.to(torch.float32)
    d = dh.to(torch.float32)
    d = torch.cat([d[:, :-1], (d[:, -1] + dh_last.to(torch.float32))[:, None]], dim=1)
    a32 = a.to(torch.float32)
    a_next = torch.cat([a32[:, 1:], torch.zeros_like(a32[:, :1])], dim=1)
    g = rglru_reverse(a_next, d)
    h_prev = torch.cat([h0.to(torch.float32)[:, None], h[:, :-1]], dim=1)
    return g * h_prev, g, a32[:, 0] * g[:, 0]


class RGLRUScan(torch.autograd.Function):
    """K6 with a backward: the forward is :func:`rglru_scan_cuda`, the
    backward :func:`rglru_backward` (K6 again, on reversed time)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = rglru_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.b_dtype = b.dtype
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_backward(a, h, h0, dh, dh_last)
        return da.to(a.dtype), db.to(ctx.b_dtype), dh0


def rglru_scan(a: Tensor, b: Tensor, h0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """a, b (B, T, W); h0 (B, W) or ``None`` (zeros) -> (h (B, T, W) f32,
    h_last (B, W) f32). Differentiable when an input requires grad."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    h0 = h0.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        return RGLRUScan.apply(a, b, h0)
    return rglru_scan_cuda(a, b, h0)
