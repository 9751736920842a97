"""Wrappers of the hand-written elementary-stencil kernels
(``csrc/stencil2d.cu``) and their plain PyTorch versions.

  * K4 :func:`stencil2d_cuda` — replaces the JAX package's
    ``kernels/stencil2d/kernel.py::stencil2d_pallas``: a runtime 3x3
    float32 mask correlated with a ``(depth, rows, cols)`` float32/bfloat16
    field on the interior, the radius-1 ring passed through.
  * K5 :func:`jacobi1d_cuda` — replaces ``jacobi1d_pallas``: the 3-point
    Jacobi sweep over ``(batch, n)``, end points passed through.

A wrapper given a CPU tensor computes the plain version; given a CUDA
tensor it launches the kernel on the current stream or raises — it never
falls back. K4 takes a field deeper than the grid's 65535 planes in
consecutive launches (:func:`repro_torch.kernels._build.plane_chunks`),
each counted. The kernel source's header says what bounds it on the card
and what its design does about that.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.ir.plan import plan_fixed_tile
from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d.ref import _mask_values, jacobi1d_ref, stencil2d_ref

HALO = 1
SOURCE = _build.CSRC / "stencil2d.cu"
LIBRARY = "stencil2d"
_DTYPES = (torch.float32, torch.bfloat16)


def source() -> tuple[str, str]:
    """``(name, text)`` of the K4/K5 source, for :func:`_build.build`."""
    return LIBRARY, SOURCE.read_text()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound K4/K5 library, loaded once per process."""
    lib = _build.load(*source())
    for fn in (lib.stencil2d_f32, lib.stencil2d_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.jacobi1d_f32, lib.jacobi1d_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def mask_3x3(weights) -> np.ndarray:
    """``weights`` as the float32 ``(3, 3)`` mask the kernel takes; raises
    on any other shape."""
    w = _mask_values(weights)
    if w.shape != (3, 3):
        raise ValueError(f"stencil2d takes a (3, 3) weight mask, got shape {w.shape}")
    return w


def stencil2d_plain(x: torch.Tensor, weights) -> torch.Tensor:
    """K4's plain version: :func:`stencil2d_ref` with the float32 mask."""
    return stencil2d_ref(x, mask_3x3(weights))


# K5's plain version is the oracle itself (float32 math, ``coeff`` rounded
# to float32 first).
jacobi1d_plain = jacobi1d_ref


def _tile(x: torch.Tensor, block_rows: int | None):
    """K4's tile: one float32 frame with a radius-1 halo (a bfloat16 input
    is widened as it loads), 64 rows (or ``block_rows``) by the narrowest
    column tile covering the grid
    (:func:`~repro_torch.ir.plan.plan_fixed_tile`)."""
    _, rows, cols = x.shape
    return plan_fixed_tile(rows, cols, halo=HALO, block_rows=block_rows)


def stencil2d_cuda(
    x: torch.Tensor, weights, *, block_rows: int | None = None
) -> torch.Tensor:
    """K4: one masked 3x3 sweep; ``block_rows`` fixes the tile rows of a
    block (default: the planner's 64-row tiles, :func:`_tile`)."""
    w = mask_3x3(weights)
    if x.device.type == "cpu":
        return stencil2d_plain(x, w)
    _build.check_input("stencil2d_cuda", x, _DTYPES)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    depth, rows, cols = x.shape
    tile = _tile(x, block_rows)
    lib = _library()
    fn = lib.stencil2d_f32 if x.dtype == torch.float32 else lib.stencil2d_bf16
    mask = (ctypes.c_float * 9)(*w.ravel().tolist())
    plane = rows * cols * x.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for first, planes in _build.plane_chunks(depth):
            code = fn(x.data_ptr() + first * plane, out.data_ptr() + first * plane, planes,
                      rows, cols, tile.rows, tile.cols, mask, stream)
            _build.check_launch("stencil2d_cuda", code)
    return out


def jacobi1d_cuda(x: torch.Tensor, coeff: float = 1.0 / 3.0) -> torch.Tensor:
    """K5: one 3-point Jacobi sweep over a ``(batch, n)`` tensor."""
    if x.device.type == "cpu":
        return jacobi1d_plain(x, coeff)
    _build.check_input("jacobi1d_cuda", x, _DTYPES, ndim=2)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    batch, n = x.shape
    lib = _library()
    fn = lib.jacobi1d_f32 if x.dtype == torch.float32 else lib.jacobi1d_bf16
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), batch, n, float(np.float32(coeff)),
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch("jacobi1d_cuda", code)
    return out
