"""Builds the port's CUDA C++ with nvcc and binds it with ctypes.

Every kernel source (the hand-written ones under ``repro_torch/csrc/`` and
the ones :mod:`repro_torch.ir.codegen_cuda` renders for IR programs) is
compiled at first use into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -I src/repro_torch/csrc -o <lib>.so <src>.cu

``-fmad=false`` is part of the contract, not a tuning flag: the kernels
must round exactly like their plain PyTorch versions (see
``csrc/stencil_common.cuh``). Libraries land in ``build/repro_torch/`` at
the repository root, named by a hash of the source text, the shared headers
and the flags, so an unchanged source is compiled once and a changed one
never loads a stale library. :func:`build` compiles a batch of sources with
one ``nvcc`` process each, all started together.

The launch counters live here too: every kernel wrapper calls
:func:`count_launch` right after a successful launch (and nowhere else), so
a caller can reset the counts, run a path, and read which kernels it went
through. :data:`NVCC_RUNS` lists every library :func:`build` compiled in
this process, so a caller can tell whether a run built anything.

The stencil kernels map depth planes to a grid dimension, which holds at
most :data:`MAX_PLANES` blocks. Their wrappers cut a deeper field into
consecutive launches of at most that many planes (:func:`plane_chunks`),
each with its pointers offset by the planes before it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# The most blocks a grid's y or z dimension holds.
MAX_PLANES = 65535

LAUNCHES: dict[str, int] = {}
NVCC_RUNS: list[str] = []
_LOADED: dict[Path, ctypes.CDLL] = {}


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def plane_chunks(depth: int) -> list[tuple[int, int]]:
    """``(first plane, planes)`` of each launch over a ``depth``-plane
    field: consecutive runs of at most :data:`MAX_PLANES` planes."""
    return [(p, min(MAX_PLANES, depth - p)) for p in range(0, depth, MAX_PLANES)]


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install location."""
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found at {path}; the port's CUDA kernels are built at "
            "first use and need the CUDA toolkit (set CUDA_HOME)"
        )
    return str(path)


def _headers_text() -> str:
    return "".join(p.read_text() for p in sorted(CSRC.glob("*.cuh")))


def library_path(name: str, source: str) -> Path:
    """Where the library built from ``source`` lives (content-addressed)."""
    h = hashlib.sha256()
    for part in (source, _headers_text(), " ".join(NVCC_FLAGS)):
        h.update(part.encode())
        h.update(b"\0")
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[tuple[str, str]]) -> list[Path]:
    """Compiles every ``(name, source_text)`` whose library is missing, one
    nvcc process per source, all running at once; returns the library paths
    in order. Raises with the compiler's output if any build fails."""
    targets = [library_path(name, text) for name, text in sources]
    jobs = []
    for (name, text), so in zip(sources, targets):
        if so.exists() or any(so == j[2] for j in jobs):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Per-process file names, renamed into place when nvcc succeeds, so
        # processes building the same source at once never read each
        # other's half-written files.
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        cu = tmp.with_suffix(".cu")
        cu.write_text(text)
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        NVCC_RUNS.append(name)
        jobs.append((name, proc, so, tmp, cu))
    failures = []
    for name, proc, so, tmp, cu in jobs:
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            failures.append(f"{name}: nvcc exited {proc.returncode} on {cu}\n{out}")
        else:
            os.replace(cu, so.with_suffix(".cu"))
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def load(name: str, source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    so = library_path(name, source)
    lib = _LOADED.get(so)
    if lib is None:
        build([(name, source)])
        lib = _LOADED[so] = ctypes.CDLL(str(so))
    return lib


def check_input(kernel: str, x, dtypes, *, field: str = "input", ndim: int = 3,
                shape=None, device=None) -> None:
    """Raises unless ``x`` is a contiguous CUDA tensor of one of ``dtypes``
    laid out as ``kernel`` takes it. With ``shape`` (the recurrences' several
    inputs), it must have exactly that shape and lie on ``device``, the
    device the kernel launches on. Without, it is a stencil field:
    ``(depth, rows, cols)`` of any depth (the wrappers launch
    :func:`plane_chunks`) or, for ``ndim=2``, ``(batch, n)`` with ``n``
    below 2**31."""
    if x.device.type != "cuda" or (device is not None and x.device != device):
        on = f"the CUDA device {device}" if device is not None else "a CUDA device"
        raise ValueError(f"{kernel}: {field} is on {x.device}; it must be on {on} "
                         "(or every input on the CPU)")
    if x.dtype not in dtypes:
        raise TypeError(f"{kernel}: {field} has dtype {x.dtype}; the kernel takes {dtypes}")
    if shape is not None:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {field} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
    elif x.ndim != ndim:
        want = "(depth, rows, cols)" if ndim == 3 else "(batch, n)"
        raise ValueError(f"{kernel}: {field} must be {want}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {field} must be contiguous")
    if shape is None and ndim == 2 and (x.shape[1] >= 2**31 or x.shape[0] >= 2**31):
        raise ValueError(f"{kernel}: {field} shape {tuple(x.shape)} exceeds int32 indexing")


def check_launch(kernel: str, code: int) -> None:
    """Raises if a launcher returned a CUDA error; counts the launch if not."""
    if code:
        import torch

        raise RuntimeError(
            f"{kernel}: kernel launch failed: {torch.cuda.CudaError(code)}"
        )
    count_launch(kernel)
