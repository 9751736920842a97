"""The static check: nothing the benchmark runs imports JAX or the JAX
package, and the reference reaches nothing of the port."""

import shutil

from portbench import isolation
from portbench.harness import ROOT


def test_the_benchmark_stands_apart():
    assert isolation.violations() == []


def test_a_planted_import_is_found(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src" / "repro_torch").mkdir(parents=True)
    (root / "src" / "repro_torch" / "__init__.py").write_text("import repro_torchlike\n")
    (root / "src" / "repro_torch" / "bad.py").write_text("import repro.core\n")
    assert isolation.violations(root) == []  # nothing of the benchmark imports it yet
    (root / "portbench" / "fields.py").write_text(
        (root / "portbench" / "fields.py").read_text() + "\nimport repro_torch.bad\n")
    assert isolation.violations(root) == ["src/repro_torch/bad.py imports repro.core"]
    (root / "portbench" / "reference" / "hdiff.py").write_text(
        (root / "portbench" / "reference" / "hdiff.py").read_text()
        + "\nfrom portbench import fields\n")
    found = isolation.violations(root)
    assert any(v.startswith("the reference reaches repro_torch") for v in found)
    (root / "portbench" / "work" / "k1.py").write_text("import jax.numpy\n")
    assert "portbench/work/k1.py imports jax.numpy" in isolation.violations(root)
