import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and the CUDA toolkit; skips without one"
    )


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TINY = {"cosmo1-hdiff": dict(fields={"u": 2, "w": 3}, rows=40, cols=52, output_interval_s=40),
        "cosmo-e-hdiff-ens": dict(fields={"u": 1, "w": 2}, rows=30, cols=34, members=4)}


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json at a size the CPU runs in a moment."""
    from portbench.harness import load_cell

    def make(name):
        cell = load_cell(name)
        cell["config"].update(TINY[cell["config"]["name"]])
        return cell

    return make
