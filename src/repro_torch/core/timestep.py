"""Iterative time-stepping driver for stencil simulations.

The counterpart of ``repro/core/timestep.py``. The JAX package scans the
step with ``lax.scan`` so XLA keeps the grid on the device; here the loop is
plain Python over eager calls, and the grid stays on whatever device the
initial field lives on for the whole run — only the diagnostics are
reduced there too, never copied out per step.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor


def run_simulation(
    psi0: Tensor,
    coeff,
    *,
    step_fn: Callable[[Tensor, object], Tensor],
    n_steps: int,
    collect_every: int = 0,
) -> tuple[Tensor, Tensor | None]:
    """Runs ``n_steps`` of ``psi <- step_fn(psi, coeff)``.

    Returns the final field and, if ``collect_every > 0``, a stacked history
    of (max, mean-abs) diagnostics of the fields after steps 1,
    1 + collect_every, ... (the JAX version's ``diags[::collect_every]``).
    """
    psi = psi0
    diags = []
    for step in range(n_steps):
        psi = step_fn(psi, coeff)
        if collect_every and step % collect_every == 0:
            a = psi.abs()
            diags.append(torch.stack([a.max(), a.mean()]))
    if collect_every:
        return psi, torch.stack(diags) if diags else psi.new_zeros((0, 2))
    return psi, None


def make_initial_field(
    depth: int,
    rows: int,
    cols: int,
    *,
    kind: str = "gaussian",
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tensor:
    """Deterministic initial conditions for tests/benchmarks.

    ``gaussian``: a smooth bump (physically plausible for diffusion);
    ``random``: uniform noise in [0, 1) from a ``torch.Generator`` seeded by
    ``seed`` — NOT the JAX package's bits for the same seed (a test that
    compares the two feeds both the same numpy array instead);
    ``checker``: worst case for diffusion smoothing.

    ``device=None`` means ``"cuda"``; without a card pass ``device="cpu"``.
    """
    dev = resolve_device(device)
    if kind == "random":
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand((depth, rows, cols), generator=gen, dtype=dtype, device=dev)
    r = torch.arange(rows, dtype=dtype, device=dev)
    c = torch.arange(cols, dtype=dtype, device=dev)
    d = torch.arange(depth, dtype=dtype, device=dev)
    if kind == "gaussian":
        rr = (r[:, None] - rows / 2.0) / (rows / 8.0)
        cc = (c[None, :] - cols / 2.0) / (cols / 8.0)
        plane = torch.exp(-(rr**2 + cc**2))
        scale = 1.0 + 0.1 * d / max(depth - 1, 1)
        return plane[None] * scale[:, None, None]
    if kind == "checker":
        ri = torch.arange(rows, device=dev)
        ci = torch.arange(cols, device=dev)
        plane = ((ri[:, None] + ci[None, :]) % 2).to(dtype)
        return plane[None].expand(depth, rows, cols).clone()
    raise ValueError(f"unknown initial-condition kind {kind!r}")
