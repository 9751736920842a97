"""Wrapper of the hand-written ``field_stats`` kernel (``csrc/field_stats.cu``)
and its plain PyTorch version.

:func:`field_stats_cuda` computes a field's health accumulators: a float64
vector of the seven quantities :data:`ACC_KEYS` names (NaN count, Inf count,
finite count, sum and sum of squares of the finite values, their min and
max), where the field lives. A CPU tensor takes the plain version
:func:`field_stats_plain`; a CUDA tensor takes one launch of the kernel on
the current stream, or the wrapper raises: it never falls back. Each element
is rounded to float32 first, as ``.to(torch.float32)`` does, after NaN and
Inf are told on the input's own type; the sums are taken in float64. The
kernel replaces no Pallas kernel (the JAX package leaves ``field_stats`` to
XLA's fused reductions); its source's header says what bounds it and what
its design does about that. :mod:`repro_torch.obs.health` builds its
statistics from these accumulators.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "field_stats.cu"
LIBRARY = "field_stats"
ACC_KEYS = ("nan_count", "inf_count", "n_finite", "sum", "sumsq", "min", "max")

# The launch plan; THREADS, UNROLL and VECTOR_BYTES are the source's
# kThreads, kUnroll and kVecBytes, PARTIAL_WORDS its sizeof(Acc) in doubles.
THREADS = 256
UNROLL = 4
VECTOR_BYTES = 16
BLOCKS_PER_SM = 4
PARTIAL_WORDS = 5

# The C entry point of each element type the kernel takes.
_ENTRIES = {
    torch.float32: "field_stats_f32",
    torch.float64: "field_stats_f64",
    torch.float16: "field_stats_f16",
    torch.bfloat16: "field_stats_bf16",
    torch.bool: "field_stats_u8",
    torch.uint8: "field_stats_u8",
    torch.int8: "field_stats_i8",
    torch.int16: "field_stats_i16",
    torch.int32: "field_stats_i32",
    torch.int64: "field_stats_i64",
}
DTYPES = tuple(_ENTRIES)


def source() -> tuple[str, str]:
    """``(name, text)`` of the kernel's source, for :func:`_build.build`."""
    return LIBRARY, SOURCE.read_text()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound library, loaded once per process."""
    lib = _build.load(*source())
    for name in set(_ENTRIES.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _scratch(index: int, stream: int) -> torch.Tensor:
    """The scratch of launches on ``stream``, which stream order keeps from
    sharing it: a ticket (the first word), zeroed once here, that every
    launch leaves at 0 (``atomicInc`` wraps at the grid's size), then room
    for the partials of the largest grid. Made under a CUDA graph's
    capture, its zeroing is part of the graph."""
    words = 1 + PARTIAL_WORDS * BLOCKS_PER_SM * _multiprocessors(index)
    return torch.zeros(words, dtype=torch.float64, device=torch.device("cuda", index))


def launch_grid(n: int, itemsize: int, multiprocessors: int) -> int:
    """Blocks of one launch over ``n`` elements of ``itemsize`` bytes: enough
    for each thread's ``UNROLL`` vector loads a round, at most
    ``BLOCKS_PER_SM`` a multiprocessor, at least one."""
    per_block = THREADS * UNROLL * VECTOR_BYTES
    return max(1, min(multiprocessors * BLOCKS_PER_SM, -(-n * itemsize // per_block)))


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _ENTRIES:
        raise TypeError(f"field_stats: dtype {x.dtype} is not one of {DTYPES}")


def field_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the accumulators with torch ops, on
    ``x``'s device, summed in float64 in PyTorch's order."""
    _check_dtype(x)
    finite = torch.isfinite(x)
    v = x.to(torch.float32)
    kept = torch.where(finite, v, 0).to(torch.float64)
    if x.numel():
        lo = torch.where(finite, v, float("inf")).min()
        hi = torch.where(finite, v, float("-inf")).max()
    else:
        lo = torch.tensor(float("inf"), device=x.device)
        hi = torch.tensor(float("-inf"), device=x.device)
    parts = (torch.isnan(x).sum(), torch.isinf(x).sum(), finite.sum(), kept.sum(),
             (kept * kept).sum(), lo, hi)
    return torch.stack([p.to(torch.float64) for p in parts])


def field_stats_cuda(x: torch.Tensor) -> torch.Tensor:
    """The accumulators of ``x`` (:data:`ACC_KEYS`), a float64 tensor of
    seven on ``x``'s device: the plain version for a CPU tensor, one launch
    for a CUDA one. A non-contiguous CUDA tensor is first made contiguous,
    a copy; a served member (``out[i]`` of a batch) is contiguous already."""
    if x.device.type == "cpu":
        return field_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"field_stats: input is on {x.device}; it must be on a CUDA "
                         "device or the CPU")
    _check_dtype(x)
    x = x.contiguous()
    n = x.numel()
    index = x.device.index
    grid = launch_grid(n, x.element_size(), _multiprocessors(index))
    out = torch.empty(len(ACC_KEYS), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_library(), _ENTRIES[x.dtype])(
            x.data_ptr(), n, grid, out.data_ptr(), _scratch(index, stream).data_ptr(), stream)
    _build.check_launch("field_stats", code)
    return out
