"""The cells' inputs, made from the seed on the device in a few large calls.

Both sides of the check get these same tensors: the port computes from them,
the reference works out again whatever the port derived from them.

A state is the configuration's fields (``"fields"``: each field's number of
levels) folded into one ``(depth, rows, cols)`` tensor, field after field:
hdiff acts on each plane alone, so the fold steps every field at once. Each
plane is a smooth large-scale pattern (two dozen plane waves with random
wavenumbers, amplitudes falling with the wavenumber, random phases), scaled
and shifted plane by plane, plus grid-scale noise of a twentieth of its
amplitude: the short waves hdiff exists to damp, and the long ones it keeps
changing slowly. Every seed gives the same sizes; only values differ.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

MODES = 24
NOISE = 0.05
MEMBER_SPREAD = 0.01


def state_shape(cfg: dict) -> tuple[int, int, int]:
    """``(depth, rows, cols)`` of one state: the planes of every field."""
    return sum(cfg["fields"].values()), cfg["rows"], cfg["cols"]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of the seed's draws."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2**63)


def initial_field(shape, seed: int, device, dtype=torch.float32) -> Tensor:
    """A ``(depth, rows, cols)`` field of values of order one."""
    depth, rows, cols = shape
    gen = generator(seed, 1, device)
    kx = torch.randint(1, 49, (MODES,), generator=gen, device=device).to(torch.float32)
    ky = torch.randint(1, 33, (MODES,), generator=gen, device=device).to(torch.float32)
    phase = 2 * math.pi * torch.rand((MODES,), generator=gen, device=device)
    amp = 1.0 / (1.0 + (kx * kx + ky * ky) / 64.0)
    r = torch.arange(rows, dtype=torch.float32, device=device)[:, None] / rows
    c = torch.arange(cols, dtype=torch.float32, device=device)[None, :] / cols
    plane = torch.zeros((rows, cols), dtype=torch.float32, device=device)
    for m in range(MODES):
        plane += amp[m] * torch.sin(2 * math.pi * (kx[m] * c + ky[m] * r) + phase[m])
    level = torch.rand((2, depth), generator=gen, device=device)
    scale = 1.0 + 0.2 * level[0]
    shift = level[1] - 0.5
    noise = torch.rand((depth, rows, cols), generator=gen, device=device)
    field = plane[None] * scale[:, None, None] + shift[:, None, None]
    field += NOISE * (noise - 0.5)
    return field.to(dtype)


def ensemble(shape, members: int, seed: int, device, dtype=torch.float32) -> Tensor:
    """``(members, depth, rows, cols)``: one field, each member perturbed by
    noise of a hundredth of its amplitude."""
    base = initial_field(shape, seed, device, dtype=torch.float32)
    gen = generator(seed, 2, device)
    out = torch.rand((members, *shape), generator=gen, device=device)
    out -= 0.5
    out *= MEMBER_SPREAD
    out += base[None]
    return out.to(dtype)

