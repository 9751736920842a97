"""The check fails where it must: the bfloat16 control in the port's place,
and each fault a cell can have planted underneath a run (on the CPU, with
the card's look skipped). The control's readings at the cells' own sizes
come from ``control.py`` on the card."""

import pytest

from portbench.faults import hook
from portbench.harness import run_cell

FAULTS = [
    ("cosmo1.k1-step", ("control", "unchanged", "altered")),
    ("cosmo1.ir-x2", ("control", "unchanged", "altered")),
    ("cosmo-e.ens21", ("control", "unchanged", "half", "altered")),
]
CASES = [(cell, mode) for cell, modes in FAULTS for mode in modes]


@pytest.mark.parametrize("name,mode", CASES)
def test_planted_fault_is_not_correct(name, mode, tiny_cell):
    out = run_cell(tiny_cell(name), 7 + len(mode), 0.3, False, device="cpu",
                   driver_hook=hook(mode))
    assert not out["correct"], out["compared"]


def test_a_stepping_cell_has_no_batch_to_halve(tiny_cell):
    with pytest.raises(ValueError, match="no batch"):
        run_cell(tiny_cell("cosmo1.k1-step"), 1, 0.3, False, device="cpu",
                 driver_hook=hook("half"))
