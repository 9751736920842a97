"""Wrappers of the hand-written hdiff kernels (``csrc/hdiff.cu``) and their
plain PyTorch versions.

  * K1 :func:`hdiff_cuda` — replaces the JAX package's
    ``kernels/hdiff/kernel.py::hdiff_pallas``: fused COSMO hdiff over a
    ``(depth, rows, cols)`` float32/bfloat16 field, float32 math, runtime
    ``coeff``, radius-2 square ring passed through.
  * K3 :func:`hdiff_fixed_cuda` — replaces ``hdiff_fixed_pallas``: the
    paper's int32 fixed-point datapath. Its plain version is the int32
    oracle :func:`~repro_torch.kernels.hdiff.ref.hdiff_fixed_point_ref`,
    which it matches bit for bit.

A wrapper given a CPU tensor computes the plain version; given a CUDA
tensor it launches the kernel on the current stream or raises — it never
falls back. A field deeper than the grid's 65535 planes takes consecutive
launches (:func:`repro_torch.kernels._build.plane_chunks`), each counted.
The kernel source's header says what bounds it on the card and what its
design does about that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.hdiff import hdiff, hdiff_simple
from repro_torch.ir.plan import plan_fixed_tile
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff.ref import hdiff_fixed_point_ref

HALO = 2
SOURCE = _build.CSRC / "hdiff.cu"
LIBRARY = "hdiff"


def source() -> tuple[str, str]:
    """``(name, text)`` of the K1/K3 source, for :func:`_build.build`."""
    return LIBRARY, SOURCE.read_text()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound K1/K3 library, loaded once per process (reading
    and hashing the source on every call would cost more host time than a
    launch on the paper grid)."""
    lib = _build.load(*source())
    ptrs = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    for fn in (lib.hdiff_f32, lib.hdiff_bf16):
        fn.argtypes = ptrs + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.hdiff_fixed_i32.argtypes = ptrs + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.hdiff_fixed_i32.restype = ctypes.c_int
    return lib


def hdiff_plain(psi: torch.Tensor, coeff: float, *, limit: bool = True) -> torch.Tensor:
    """K1's plain version: float32 hdiff in ``_hdiff_tile_math``'s order
    (the same order as :func:`repro_torch.core.hdiff.hdiff`), cast back to
    ``psi``'s dtype."""
    fn = hdiff if limit else hdiff_simple
    return fn(psi.to(torch.float32), float(coeff)).to(psi.dtype)


def _tile(x: torch.Tensor, block_rows: int | None):
    """K1's tile: one float32 frame (a bfloat16 input is widened as it
    loads), 64 rows (or ``block_rows``) by the narrowest column tile
    covering the grid (:func:`~repro_torch.ir.plan.plan_fixed_tile`)."""
    _, rows, cols = x.shape
    return plan_fixed_tile(rows, cols, halo=HALO, block_rows=block_rows)


def hdiff_cuda(
    psi: torch.Tensor, coeff: float, *, limit: bool = True, block_rows: int | None = None
) -> torch.Tensor:
    """K1: one hdiff sweep; ``block_rows`` fixes the tile rows of a block
    (default: the planner's 64-row tiles, :func:`_tile`)."""
    if psi.device.type == "cpu":
        return hdiff_plain(psi, coeff, limit=limit)
    _build.check_input("hdiff_cuda", psi, (torch.float32, torch.bfloat16))
    out = torch.empty_like(psi)
    if psi.numel() == 0:
        return out
    lib = _library()
    fn = lib.hdiff_f32 if psi.dtype == torch.float32 else lib.hdiff_bf16
    tile = _tile(psi, block_rows)
    depth, rows, cols = psi.shape
    plane = rows * cols * psi.element_size()
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream().cuda_stream
        for first, planes in _build.plane_chunks(depth):
            code = fn(
                psi.data_ptr() + first * plane, out.data_ptr() + first * plane, planes, rows,
                cols, tile.rows, tile.cols, float(coeff), int(limit), stream,
            )
            _build.check_launch("hdiff_cuda", code)
    return out


def hdiff_fixed_cuda(
    psi_q: torch.Tensor,
    *,
    coeff_num: int = 26,
    coeff_shift: int = 10,
    block_rows: int | None = None,
) -> torch.Tensor:
    """K3: one int32 fixed-point hdiff sweep (``coeff = coeff_num /
    2**coeff_shift``; products wrap like the JAX int32 datapath);
    ``block_rows`` fixes the tile rows of a block (default: the planner's
    64-row tiles, :func:`~repro_torch.ir.plan.plan_fixed_tile`)."""
    if not 0 <= coeff_shift < 32:
        raise ValueError(f"coeff_shift must be in [0, 32), got {coeff_shift}")
    if psi_q.device.type == "cpu":
        return hdiff_fixed_point_ref(psi_q, coeff_num, coeff_shift)
    _build.check_input("hdiff_fixed_cuda", psi_q, (torch.int32,))
    out = torch.empty_like(psi_q)
    if psi_q.numel() == 0:
        return out
    depth, rows, cols = psi_q.shape
    tile = plan_fixed_tile(rows, cols, halo=HALO, block_rows=block_rows)
    plane = rows * cols * psi_q.element_size()
    with torch.cuda.device(psi_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for first, planes in _build.plane_chunks(depth):
            code = _library().hdiff_fixed_i32(
                psi_q.data_ptr() + first * plane, out.data_ptr() + first * plane, planes,
                rows, cols, tile.rows, tile.cols, int(coeff_num), int(coeff_shift), stream,
            )
            _build.check_launch("hdiff_fixed_cuda", code)
    return out
