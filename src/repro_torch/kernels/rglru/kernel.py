"""Wrapper of the hand-written RG-LRU scan kernel (``csrc/rglru.cu``).

K6 :func:`rglru_scan_cuda` replaces the JAX package's
``kernels/rglru/kernel.py::rglru_scan_pallas``: ``h_t = a_t h_{t-1} + b_t``
per (batch, channel) over ``(B, T, W)`` float32 or bfloat16 a and b, from a
float32 ``(B, W)`` h0, returning every h and the last one in float32.

A CPU tensor gets the plain version
(:func:`~repro_torch.kernels.rglru.ref.rglru_seq_ref`); a CUDA tensor
launches the kernel on the current stream or raises — it never falls back.
A meta tensor takes the CUDA route's checks, plan and allocations and
launches nothing: each launch it would make is noted with its work
(:func:`launch_work`) for the dry run (``_build.record_meta``). One block
runs the recurrence for a tile of channels of one batch row, with a and b
streamed through a ring of shared-memory stages; :func:`plan_scan` picks
the tile and the stage length. The batch is the grid's y dimension, which
holds at most 65535 blocks, so a larger batch takes consecutive launches
of at most that many rows (:func:`plan_launches`), each with its pointers
offset by the rows before it and each counted. The kernel source's header
says what bounds it on the card and what its design does about that.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_seq_ref

SOURCE = _build.CSRC / "rglru.cu"
LIBRARY = "rglru"
_DTYPES = (torch.float32, torch.bfloat16)
STAGES = 4  # ring slots of a block (kStages in csrc/rglru.cu)
STAGE_STEPS = 64  # steps of a and b per ring slot
MAX_TILE = 32  # channels per block: one warp of chain lanes (kMaxTile)
GROUP = 4  # channels per copy on the vector path


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch of K6: ``tile`` channels per block, ``stage_steps`` steps
    per ring slot, ``vec`` for 4-channel copies; ``blocks`` in the grid and
    ``smem`` bytes of shared memory per block."""

    tile: int
    stage_steps: int
    vec: bool
    blocks: int
    smem: int


def check_shape(batch: int, steps: int, width: int) -> None:
    """Raises for a shape beyond the kernel's grid or int32 indexing."""
    if batch > 65535 or steps * width >= 2**31:
        raise ValueError(f"rglru_scan_cuda: shape {(batch, steps, width)} exceeds the kernel's "
                         "grid (batch <= 65535) or int32 indexing")


@functools.lru_cache(maxsize=256)
def plan_scan(batch: int, steps: int, width: int, itemsize: int, sms: int, *,
              vec: bool) -> ScanPlan:
    """K6's launch plan for ``(batch, steps, width)`` inputs of ``itemsize``
    bytes on a card with ``sms`` multiprocessors.

    The tile is the fewest channels that spread ``batch * width`` lanes over
    at most ``sms`` blocks (about one wave), rounded up to a multiple of
    :data:`GROUP` on the vector path (``vec``: the width a multiple of 4 and
    the pointers aligned) and clamped to ``[1, MAX_TILE]``; slots hold
    ``min(STAGE_STEPS, steps)`` steps of :data:`MAX_TILE` channels (a
    constant row stride). Raises for shapes the grid or the kernel's
    indexing cannot take."""
    check_shape(batch, steps, width)
    if batch < 1 or width < 1 or steps < 0 or sms < 1 or itemsize not in (2, 4):
        raise ValueError(f"rglru plan: no lanes in ({batch}, {steps}, {width}), "
                         f"itemsize {itemsize}, {sms} SMs")
    if vec and width % GROUP:
        raise ValueError(f"rglru plan: the vector path needs a width that is a multiple of "
                         f"{GROUP}, got {width}")
    unit = GROUP if vec else 1
    per_block = -(-batch * width // sms)
    tile = max(unit, min(MAX_TILE, -(-per_block // unit) * unit, -(-width // unit) * unit))
    stage_steps = max(1, min(STAGE_STEPS, steps))
    smem = STAGES * 2 * stage_steps * MAX_TILE * itemsize  # 64 KB at most
    return ScanPlan(tile, stage_steps, vec, batch * -(-width // tile), smem)


def plan_launches(batch: int, steps: int, width: int, itemsize: int, sms: int, *,
                  vec: bool) -> list[tuple[int, int, ScanPlan]]:
    """``(first row, rows, plan)`` of each K6 launch over a ``batch``-row
    input: consecutive runs of at most ``_build.MAX_PLANES`` rows, each
    planned by :func:`plan_scan`."""
    return [(b0, nb, plan_scan(nb, steps, width, itemsize, sms, vec=vec))
            for b0, nb in _build.plane_chunks(batch)]


def launch_work(rows: int, steps: int, width: int, itemsize: int) -> tuple[int, int]:
    """``(operations, bytes)`` of one K6 launch over ``rows`` batch rows:
    a multiply and an add a step and channel; a and b read at ``itemsize``,
    h written and h0 read and h_last written in float32 (the bound
    ``chip_smoke.py`` times it against)."""
    n = rows * steps * width
    return 2 * n, 2 * n * itemsize + 4 * n + 8 * rows * width


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def source() -> tuple[str, str]:
    """``(name, text)`` of the K6 source, for :func:`_build.build`."""
    return LIBRARY, SOURCE.read_text()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound K6 library, loaded once per process."""
    lib = _build.load(*source())
    for fn in (lib.rglru_f32, lib.rglru_bf16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
                           device=a.device, meta=True)
    h = torch.empty((batch, steps, width), dtype=torch.float32, device=a.device)
    h_last = torch.empty((batch, width), dtype=torch.float32, device=a.device)
    if batch == 0 or width == 0:
        return h, h_last
    size = a.element_size()
    if a.device.type == "meta":
        # Fresh allocations are aligned: the vector plan, on an H100's SMs.
        for _, nb, _ in plan_launches(batch, steps, width, size, _build.META_SMS,
                                      vec=width % GROUP == 0):
            _build.record_meta("rglru_scan_cuda", *launch_work(nb, steps, width, size))
        return h, h_last
    vec = width % GROUP == 0 and a.data_ptr() % (GROUP * size) == 0 \
        and b.data_ptr() % (GROUP * size) == 0
    plans = plan_launches(batch, steps, width, size, _sm_count(a.device.index), vec=vec)
    lib = _library()
    fn = lib.rglru_f32 if a.dtype == torch.float32 else lib.rglru_bf16
    row_in, row_out = steps * width * size, steps * width * 4
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0, nb, plan in plans:
            code = fn(a.data_ptr() + b0 * row_in, b.data_ptr() + b0 * row_in,
                      h0.data_ptr() + b0 * width * 4, h.data_ptr() + b0 * row_out,
                      h_last.data_ptr() + b0 * width * 4, nb, steps, width, plan.tile,
                      plan.stage_steps, int(plan.vec), stream)
            _build.check_launch("rglru_scan_cuda", code)
    return h, h_last
