"""Wrappers of the hand-written WKV-6 kernels (``csrc/wkv6.cu``, ``csrc/wkv6_bwd.cu``).

K7 :func:`wkv6_cuda` replaces the JAX package's
``kernels/wkv6/kernel.py::wkv6_pallas``: the chunked RWKV-6 WKV recurrence
over ``(B, T, H, N)`` float32 r/k/v/w with an ``(H, N)`` bonus and a
``(B, H, N, N)`` initial state, returning ``(y, final state)`` in float32.

A CPU tensor gets the plain version (:func:`~repro_torch.kernels.wkv6.ref.wkv6_plain`);
a CUDA tensor launches the kernel on the current stream or raises — it
never falls back. One call is three launches (chunk-local state products,
the scan over chunks, the chunk outputs) into scratch the wrapper
allocates, and counts as one launch of K7. The kernel source's header says
what bounds it on the card and what its design does about that.

The grid is ``(chunks, heads, batch)``, and its y and z dimensions hold at
most 65535 blocks each, so a larger batch or head count takes several
calls (:func:`plan_launches`), each counted: a run of batch rows is a
contiguous block of every input, addressed by offset pointers; a run of
heads is strided in ``(B, T, H, N)``, so its inputs are copied to
contiguous tensors and its outputs copied back.

:func:`wkv6_bwd_cuda` is K7's backward: the gradient of the same chunked
recurrence for cotangents on y and on the final state, which the JAX
package takes with ``jax.grad`` of its jnp chunked form and so has no
Pallas kernel for. A CPU tensor gets its plain version
(:func:`~repro_torch.kernels.wkv6.ref.wkv6_backward_plain`); a CUDA tensor
launches three kernels (chunk-local products, the forward and reverse
scans over chunks, the chunk gradients) counted as one launch of
``wkv6_bwd_cuda``, on the same launch plan as the forward. It takes a head
size and a chunk of at most 64.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_backward_plain, wkv6_plain

SOURCE = _build.CSRC / "wkv6.cu"
LIBRARY = "wkv6"
BWD_SOURCE = _build.CSRC / "wkv6_bwd.cu"
BWD_LIBRARY = "wkv6_bwd"
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
MAX_BWD_DIM = 64  # the backward's largest head size and chunk (kMaxDim in csrc/wkv6_bwd.cu)


def source() -> tuple[str, str]:
    """``(name, text)`` of the K7 source, for :func:`_build.build`."""
    return LIBRARY, SOURCE.read_text()


def bwd_source() -> tuple[str, str]:
    """``(name, text)`` of K7's backward source, for :func:`_build.build`."""
    return BWD_LIBRARY, BWD_SOURCE.read_text()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built and bound K7 library, loaded once per process."""
    lib = _build.load(*source())
    lib.wkv6_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.wkv6_f32.restype = ctypes.c_int
    lib.wkv6_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.wkv6_smem_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built and bound library of K7's backward, loaded once per process."""
    lib = _build.load(*bwd_source())
    lib.wkv6_bwd_f32.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.wkv6_bwd_f32.restype = ctypes.c_int
    return lib


def plan_launches(batch: int, heads: int) -> list[tuple[int, int, int, int]]:
    """``(first row, rows, first head, heads)`` of each K7 call: the batch
    and the heads each cut into consecutive runs of at most
    ``_build.MAX_PLANES``."""
    return [(b0, nb, h0, nh) for b0, nb in _build.plane_chunks(batch)
            for h0, nh in _build.plane_chunks(heads)]


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, state0: torch.Tensor, *, chunk: int = 64
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: ``(y (B,T,H,N), state (B,H,N,N))`` of the chunked WKV-6
    recurrence. ``chunk`` is clamped to T, which it must divide."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state0, chunk=chunk)
    if r.ndim != 4:
        raise ValueError(f"wkv6_cuda: r must be (B, T, H, N), got {tuple(r.shape)}")
    b, t, h, n = r.shape
    for field, x, shape in (("r", r, r.shape), ("k", k, r.shape), ("v", v, r.shape),
                            ("w", w, r.shape), ("u", u, (h, n)), ("state0", state0, (b, h, n, n))):
        _build.check_input("wkv6_cuda", x, (torch.float32,), field=field, shape=shape,
                           device=r.device)
    c = min(chunk, t)
    if c < 1 or t % c:
        raise ValueError(f"wkv6_cuda: sequence length {t} is not a positive multiple of "
                         f"chunk {c}")
    lib = _library()
    smem = lib.wkv6_smem_bytes(n, c)
    if smem > MAX_SMEM:
        raise ValueError(f"wkv6_cuda: head size {n} with chunk {c} needs {smem} bytes of "
                         f"shared memory per block, more than {MAX_SMEM}")
    y = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if y.numel() == 0:
        return y, state0.clone()
    for b0, nb, h0, nh in plan_launches(b, h):
        rows = slice(b0, b0 + nb)
        if nh == h:  # whole rows: offset views of the contiguous inputs
            _launch(lib, r[rows], k[rows], v[rows], w[rows], u, state0[rows], y[rows],
                    s_out[rows], c)
            continue
        hs = slice(h0, h0 + nh)
        ys, ss = (torch.empty((nb, t, nh, n), dtype=torch.float32, device=r.device),
                  torch.empty((nb, nh, n, n), dtype=torch.float32, device=r.device))
        _launch(lib, *(x[rows, :, hs].contiguous() for x in (r, k, v, w)), u[hs].contiguous(),
                state0[rows, hs].contiguous(), ys, ss, c)
        y[rows, :, hs] = ys
        s_out[rows, hs] = ss
    return y, s_out


def _launch(lib, r, k, v, w, u, state0, y, s_out, c: int) -> None:
    """One K7 call (three launches, one count) on contiguous tensors."""
    b, t, h, n = r.shape
    # Scratch: each chunk's k_tail^T v, replaced by the scan with the state
    # entering the next chunk, and each chunk's exp(total).
    kv = torch.empty((b, h, t // c, n, n), dtype=torch.float32, device=r.device)
    decay = torch.empty((b, h, t // c, n), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = lib.wkv6_f32(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                            u.data_ptr(), state0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                            kv.data_ptr(), decay.data_ptr(), b, t, h, n, c,
                            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("wkv6_cuda", code)


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, state0: torch.Tensor, dy: torch.Tensor,
                  ds_t: torch.Tensor | None = None, *, chunk: int = 64
                  ) -> tuple[torch.Tensor, ...]:
    """K7's backward: ``(dr, dk, dv, dw (B,T,H,N), du (H,N), dstate0
    (B,H,N,N))`` of the chunked WKV-6 recurrence for the cotangent ``dy``
    of y and ``ds_t`` of the final state (``None``: zeros). ``chunk`` is
    clamped to T, which it must divide."""
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, w, u, state0, dy, ds_t, chunk=chunk)
    if r.ndim != 4:
        raise ValueError(f"wkv6_bwd_cuda: r must be (B, T, H, N), got {tuple(r.shape)}")
    b, t, h, n = r.shape
    if ds_t is None:
        ds_t = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    for field, x, shape in (("r", r, r.shape), ("k", k, r.shape), ("v", v, r.shape),
                            ("w", w, r.shape), ("u", u, (h, n)), ("state0", state0, (b, h, n, n)),
                            ("dy", dy, r.shape), ("ds_t", ds_t, (b, h, n, n))):
        _build.check_input("wkv6_bwd_cuda", x, (torch.float32,), field=field, shape=shape,
                           device=r.device)
    c = min(chunk, t)
    if c < 1 or t % c:
        raise ValueError(f"wkv6_bwd_cuda: sequence length {t} is not a positive multiple of "
                         f"chunk {c}")
    if n > MAX_BWD_DIM or c > MAX_BWD_DIM:
        raise ValueError(f"wkv6_bwd_cuda: head size {n} and chunk {c} must be at most "
                         f"{MAX_BWD_DIM}")
    lib = _bwd_library()
    grads = [torch.empty((b, t, h, n), dtype=torch.float32, device=r.device) for _ in range(4)]
    du = torch.zeros((h, n), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        return (*grads, du, ds_t.clone())
    for b0, nb, h0, nh in plan_launches(b, h):
        rows = slice(b0, b0 + nb)
        if nh == h:  # whole rows: offset views of the contiguous tensors
            du += _launch_bwd(lib, *(x[rows] for x in (r, k, v, w)), u, state0[rows], dy[rows],
                              ds_t[rows], *(g[rows] for g in grads), ds0[rows], c)
            continue
        hs = slice(h0, h0 + nh)
        outs = [torch.empty((nb, t, nh, n), dtype=torch.float32, device=r.device)
                for _ in range(4)]
        ds0_hs = torch.empty((nb, nh, n, n), dtype=torch.float32, device=r.device)
        du[hs] += _launch_bwd(lib, *(x[rows, :, hs].contiguous() for x in (r, k, v, w)),
                              u[hs].contiguous(), state0[rows, hs].contiguous(),
                              dy[rows, :, hs].contiguous(), ds_t[rows, hs].contiguous(), *outs,
                              ds0_hs, c)
        for g, o in zip(grads, outs):
            g[rows, :, hs] = o
        ds0[rows, hs] = ds0_hs
    return (*grads, du, ds0)


def _launch_bwd(lib, r, k, v, w, u, state0, dy, ds_t, dr, dk, dv, dw, ds0, c: int
                ) -> torch.Tensor:
    """One call of K7's backward (three launches, one count) on contiguous
    tensors; returns its du, summed over its batch rows and chunks."""
    b, t, h, n = r.shape
    nch = t // c
    # Scratch: each chunk's k^T v (then the state entering it), r~^T dy
    # (then the cotangent of the state leaving it), exp(total), and du.
    kv = torch.empty((b, h, nch, n, n), dtype=torch.float32, device=r.device)
    rdy = torch.empty_like(kv)
    decay = torch.empty((b, h, nch, n), dtype=torch.float32, device=r.device)
    dupart = torch.empty((b, nch, h, n), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = lib.wkv6_bwd_f32(*(x.data_ptr() for x in (r, k, v, w, u, state0, dy, ds_t, dr, dk,
                                                          dv, dw, dupart, ds0, kv, rdy, decay)),
                                b, t, h, n, c, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("wkv6_bwd_cuda", code)
    return dupart.sum(dim=(0, 1))
