"""Structured JSON run reports + runtime environment metadata.

The port's copy of ``repro/obs/report.py``. ``runtime_metadata()`` is the
one home of the "what ran this" record every perf artifact of the port
carries: torch and CUDA versions, backend, device kind and count, the
card's ``nvidia-smi`` name and power limit when there is a card, python
and platform, plus the commit SHA when one is discoverable. ``MATCH_KEYS``
names the same keys as the JAX package's, so wall-clock numbers are only
ever compared like-for-like.

``RunReport`` is the generic container for any instrumented run: metadata +
a metrics snapshot + named free-form sections, serialised to plain JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import time
from pathlib import Path
from typing import Any

from repro_torch.obs import metrics

# The metadata keys a trajectory comparison must agree on before wall-clock
# rows are comparable at all.
MATCH_KEYS = ("backend", "device_kind", "device_count")


def git_commit(cwd: str | None = None) -> str | None:
    """Best-effort commit SHA: ``GITHUB_SHA`` (CI) or ``git rev-parse``.
    Returns None outside a repo / without git — metadata must never make a
    run fail."""
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10, cwd=cwd,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def nvidia_smi() -> str | None:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` reports
    them, or None where the tool is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def runtime_metadata(cwd: str | None = None) -> dict[str, Any]:
    """Device/platform metadata for perf records. Without a card it reports
    the CPU backend and touches no CUDA context (``torch.cuda.is_available``
    initialises none); with one it names the first card."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "nvidia_smi": nvidia_smi() if cuda else None,
        "python_version": platform.python_version(),
        "platform": platform.platform(),
        "commit": git_commit(cwd),
        "recorded_at_unix": time.time(),
    }


@dataclasses.dataclass
class RunReport:
    """A structured record of one instrumented run."""

    name: str
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    sections: dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics_snapshot: dict[str, Any] | None = None

    @classmethod
    def begin(cls, name: str, *, with_metadata: bool = True) -> "RunReport":
        return cls(name=name, metadata=runtime_metadata() if with_metadata else {})

    def add_section(self, name: str, payload: Any) -> "RunReport":
        self.sections[name] = payload
        return self

    def attach_metrics(
        self, registry: metrics.MetricsRegistry | None = None
    ) -> "RunReport":
        """Snapshots ``registry`` (or the active one) into the report."""
        reg = registry if registry is not None else metrics.current()
        if reg is not None:
            self.metrics_snapshot = reg.snapshot()
        return self

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "metadata": self.metadata,
            "sections": self.sections,
            "metrics": self.metrics_snapshot,
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True, default=str)

    def write(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json() + "\n")
        return path
