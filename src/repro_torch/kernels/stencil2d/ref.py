"""Plain PyTorch oracles for the elementary-stencil kernels.

The counterpart of ``repro/kernels/stencil2d/ref.py``. A 2-D stencil is a
``(2R+1, 2R+1)`` weight mask: the output is the correlation of the input
with the mask on the interior, the boundary ring passed through. This
covers the whole §3.5 suite: jacobi2d_3pt (a column of 1/3), laplacian (a
star of 4 and -1s), jacobi2d_5pt (a star of 0.2), jacobi2d_9pt and the
seidel sweep (a box of 1/9). Both functions run where the tensor lives and
accumulate in float32 in the JAX oracle's order, so they round alike.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _mask_values(weights) -> np.ndarray:
    """``weights`` (numpy array, tensor or nested sequence) as a float32
    numpy mask: the one conversion both packages apply before a mask
    reaches a kernel."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    return np.asarray(weights, dtype=np.float32)


def stencil2d_ref(x: Tensor, weights) -> Tensor:
    """Correlation with ``weights`` ((2R+1, 2R+1)) on the interior: every
    tap, zero weights included, added to a float32 zero accumulator in
    row-major ``(dr, dc)`` order."""
    w = _mask_values(weights)
    k = w.shape[0]
    if w.shape != (k, k) or k % 2 != 1:
        raise ValueError(f"weights must be a square odd-sized mask, got shape {w.shape}")
    r = k // 2
    rows, cols = x.shape[-2], x.shape[-1]
    acc = torch.zeros_like(x[..., r : rows - r, r : cols - r], dtype=torch.float32)
    for dr in range(-r, r + 1):
        for dc in range(-r, r + 1):
            tap = x[..., r + dr : rows - r + dr, r + dc : cols - r + dc].to(torch.float32)
            acc = acc + float(w[dr + r, dc + r]) * tap
    out = x.clone()
    out[..., r : rows - r, r : cols - r] = acc.to(x.dtype)
    return out


def weights_for(name: str) -> np.ndarray:
    """The canonical float32 3x3 mask of a named §3.5 stencil (the JAX
    package's ``weights_for``, value for value)."""
    w = np.zeros((3, 3), np.float32)
    if name == "jacobi2d_3pt":
        w[:, 1] = 1.0 / 3.0
    elif name == "laplacian":
        w[1, 1] = 4.0
        w[0, 1] = w[2, 1] = w[1, 0] = w[1, 2] = -1.0
    elif name == "jacobi2d_5pt":
        w[1, 1] = w[0, 1] = w[2, 1] = w[1, 0] = w[1, 2] = 0.2
    elif name in ("jacobi2d_9pt", "seidel2d"):
        w[:] = 1.0 / 9.0
    else:
        raise ValueError(f"unknown elementary stencil {name!r}")
    return w


def jacobi1d_ref(x: Tensor, coeff: float = 1.0 / 3.0) -> Tensor:
    """``coeff * ((x[i-1] + x[i]) + x[i+1])`` in float32 on the last axis,
    end points passed through. ``coeff`` is rounded to float32 first, as
    JAX rounds a weakly typed Python scalar against a float32 array."""
    c = float(np.float32(coeff))
    interior = c * (
        (x[..., :-2].to(torch.float32) + x[..., 1:-1].to(torch.float32))
        + x[..., 2:].to(torch.float32)
    )
    out = x.clone()
    out[..., 1:-1] = interior.to(x.dtype)
    return out
