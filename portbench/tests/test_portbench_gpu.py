"""One short run of a cell on the card, through the command the driver runs."""

import json
import subprocess
import sys

import pytest

from portbench.harness import ROOT


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cosmo1.k1-step",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    last = out.stderr.strip().splitlines()[-2:]
    assert last[0].startswith("compared err_over_change") and last[1].startswith("compared failed")
