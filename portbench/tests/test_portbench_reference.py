"""The plain reference against slow loops written point by point."""

import pytest
import torch

from portbench.reference import hdiff as ref


def slow_sweep(psi, coeff, limit):
    """One hdiff sweep, a Python loop over every interior point (float64)."""
    d, r, c = psi.shape
    x = psi.tolist()
    out = [[row[:] for row in plane] for plane in x]

    def co(k, i, j):
        return coeff if not isinstance(coeff, torch.Tensor) else float(coeff[k, i, j])

    for k in range(d):
        p = x[k]

        def lap(i, j):
            return 4 * p[i][j] - p[i + 1][j] - p[i - 1][j] - p[i][j + 1] - p[i][j - 1]

        for i in range(2, r - 2):
            for j in range(2, c - 2):
                fr = lap(i + 1, j) - lap(i, j)
                frm = lap(i, j) - lap(i - 1, j)
                fc = lap(i, j + 1) - lap(i, j)
                fcm = lap(i, j) - lap(i, j - 1)
                if limit:
                    fr = fr if fr * (p[i + 1][j] - p[i][j]) <= 0 else 0.0
                    frm = frm if frm * (p[i][j] - p[i - 1][j]) <= 0 else 0.0
                    fc = fc if fc * (p[i][j + 1] - p[i][j]) <= 0 else 0.0
                    fcm = fcm if fcm * (p[i][j] - p[i][j - 1]) <= 0 else 0.0
                out[k][i][j] = p[i][j] - co(k, i, j) * ((fr - frm) + (fc - fcm))
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.parametrize("limit", [True, False])
@pytest.mark.parametrize("field_coeff", [False, True])
def test_sweep_equals_the_point_loop(limit, field_coeff):
    gen = torch.Generator().manual_seed(3)
    psi = torch.rand((2, 9, 11), generator=gen, dtype=torch.float64)
    coeff = (0.025 * (1 + 0.2 * torch.rand(psi.shape, generator=gen, dtype=torch.float64))
             if field_coeff else 0.025)
    got = ref.sweep(psi, coeff, limit=limit)
    want = slow_sweep(psi, coeff, limit)
    assert torch.allclose(got, want, rtol=0, atol=1e-14)
    assert torch.equal(got[:, :2], psi[:, :2]) and torch.equal(got[:, :, -2:], psi[:, :, -2:])


def test_sweeps_repeat_with_the_ring_and_blocks_change_nothing():
    psi = torch.rand((5, 12, 13), generator=torch.Generator().manual_seed(4))
    twice = ref.sweep(ref.sweep(psi, 0.025), 0.025)
    assert torch.equal(ref.sweeps(psi, 0.025, 2, block=2), twice)
    assert torch.equal(ref.sweeps(psi, 0.025, 2, block=8), twice)
