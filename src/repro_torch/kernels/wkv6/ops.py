"""Public entry point for the WKV-6 kernel (the counterpart of
``repro/kernels/wkv6/ops.py``). A CUDA tensor launches K7, a CPU tensor
computes its plain version; the Pallas-only ``interpret`` knob has no
counterpart.

Gradients. When an input requires grad, :func:`wkv6` runs through
:class:`WKV6`, whose forward is K7 and whose backward is K7's backward
kernel (:func:`~repro_torch.kernels.wkv6.kernel.wkv6_bwd_cuda`) on a CUDA
tensor, its plain version on a CPU one. The backward recomputes the states
entering each chunk from the saved inputs; the JAX package gets the same
gradient from ``jax.grad`` of its jnp chunked form.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import wkv6_bwd_cuda, wkv6_cuda


class WKV6(torch.autograd.Function):
    """K7 with a backward: the forward is :func:`wkv6_cuda`, the backward
    :func:`wkv6_bwd_cuda` (the cotangent of an unused final state is zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, chunk):
        y, state = wkv6_cuda(r, k, v, w, u, state0, chunk=chunk)
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, ds_t):
        grads = wkv6_bwd_cuda(*ctx.saved_tensors, dy.contiguous(), ds_t.contiguous(),
                              chunk=ctx.chunk)
        return (*grads, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor | None = None, *, chunk: int = 64
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, T, H, N), u (H, N), state0 (B, H, N, N) or ``None``
    (zeros) -> (y (B, T, H, N) f32, final state (B, H, N, N) f32).
    Differentiable when an input requires grad."""
    b, _, h, n = r.shape
    if state0 is None:
        state0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, w, u, state0)):
        return WKV6.apply(r, k, v, w, u, state0, chunk)
    return wkv6_cuda(r, k, v, w, u, state0, chunk=chunk)
