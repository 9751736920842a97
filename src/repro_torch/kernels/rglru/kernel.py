"""Wrapper of the hand-written RG-LRU scan kernel (``csrc/rglru.cu``).

K6 :func:`rglru_scan_cuda` replaces the JAX package's
``kernels/rglru/kernel.py::rglru_scan_pallas``: ``h_t = a_t h_{t-1} + b_t``
per (batch, channel) over ``(B, T, W)`` float32 or bfloat16 a and b, from a
float32 ``(B, W)`` h0, returning every h and the last one in float32.

A CPU tensor gets the plain version
(:func:`~repro_torch.kernels.rglru.ref.rglru_seq_ref`); a CUDA tensor
launches the kernel on the current stream or raises — it never falls
back. The kernel source's header says what bounds it on the card and what
its design does about that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_seq_ref

SOURCE = _build.CSRC / "rglru.cu"
LIBRARY = "rglru"
_DTYPES = (torch.float32, torch.bfloat16)


def source() -> tuple[str, str]:
    """``(name, text)`` of the K6 source, for :func:`_build.build`."""
    return LIBRARY, SOURCE.read_text()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound K6 library, loaded once per process."""
    lib = _build.load(*source())
    for fn in (lib.rglru_f32, lib.rglru_bf16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(h (B, T, W) f32, h_last (B, W) f32)``."""
    if a.device.type == "cpu":
        return rglru_seq_ref(a, b, h0)
    if a.ndim != 3:
        raise ValueError(f"rglru_scan_cuda: a must be (B, T, W), got {tuple(a.shape)}")
    batch, steps, width = a.shape
    for field, x, dtypes, shape in (("a", a, _DTYPES, a.shape), ("b", b, (a.dtype,), a.shape),
                                    ("h0", h0, (torch.float32,), (batch, width))):
        _build.check_input("rglru_scan_cuda", x, dtypes, field=field, shape=shape,
                           device=a.device)
    if batch > 65535 or steps * width >= 2**31:
        raise ValueError(f"rglru_scan_cuda: shape {tuple(a.shape)} exceeds the kernel's grid "
                         "(batch <= 65535) or int32 indexing")
    h = torch.empty((batch, steps, width), dtype=torch.float32, device=a.device)
    h_last = torch.empty((batch, width), dtype=torch.float32, device=a.device)
    if batch == 0 or width == 0:
        return h, h_last
    lib = _library()
    fn = lib.rglru_f32 if a.dtype == torch.float32 else lib.rglru_bf16
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(), h_last.data_ptr(),
                  batch, steps, width, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("rglru_scan_cuda", code)
    return h, h_last
