"""The port's weather driver (``examples/torch_weather_simulation.py``) on
the CPU, held to the reference driver's tests (``tests/test_weather_example.py``).

The driver is SPMD: ``--devices N`` spawns N gloo ranks, each owning one
block of the shallow-water {u, v, h} state. With ``--device cpu`` it prints
the reference's lines: the program and partition, the verification against
the single-process reference, and for the ``--health`` drill
``BLOWUP_DETECTED step=9 field=h``, exit code 3, a COMMITted step-6
checkpoint of the global state (restorable through both packages) and the
flight recorder's probes. Its final fields are held against the JAX
package's ``lower_reference`` stepped eagerly (``jax.disable_jit()``:
jitted stepping is not bit-stable, ROADMAP Queue 3) within ``TOL``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.checkpoint as jax_ckpt
from conformance import TOL
from repro.core import make_initial_field as jax_initial_field
from repro.ir import lower_reference as jax_lower_reference
from repro.ir import shallow_water_program as jax_shallow_water
from repro_torch.checkpoint import latest_step, restore_checkpoint

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))
import torch_weather_simulation as drv  # noqa: E402

SMALL = ["--depth", "4", "--size", "24", "--device", "cpu"]


def _cli(*extra: str, expect_rc: int = 0) -> str:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_weather_simulation.py"), *extra],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == expect_rc, (
        f"rc={proc.returncode} (wanted {expect_rc})\n"
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}")
    return proc.stdout


def _run(capfd, *argv):
    res = drv.run(drv.parse_args([*argv, *SMALL]))
    return res, capfd.readouterr().out


def test_weather_example_smoke_small_grid():
    out = _cli("--steps", "3", "--devices", "2", *SMALL)
    assert "devices: 2 (gloo ranks on the CPU)" in out
    assert "IR program: shallow_water radius=1" in out
    assert "outputs=u+v+h" in out
    assert "partition plan: rows x2 cols x1" in out
    assert "distributed result matches single-device reference" in out
    assert "(u, v, h)" in out


def test_weather_example_health_blowup_drill(tmp_path, capfd):
    """A NaN injected into h after step 7 is caught at the next cadence-3
    probe (step 9) by h's own monitor on every rank; rank 0 COMMITs the
    last healthy probed global {u, v, h} (step 6) and the flight recorder
    holds the failing step's per-field stats."""
    ckpt = tmp_path / "ckpt"
    log = tmp_path / "events.jsonl"
    res, out = _run(capfd, "--steps", "12", "--devices", "2",
                    "--health", "--health-every", "3", "--inject-nan", "7",
                    "--health-policy", "checkpoint-then-abort",
                    "--ckpt-dir", str(ckpt), "--event-log", str(log))
    assert res["code"] == drv.BLOWUP_EXIT_CODE == 3
    assert "BLOWUP_DETECTED step=9 field=h" in out
    assert "nan_count=1" in out
    assert out.count("BLOWUP_DETECTED") == 1  # rank 0 reports; every rank stopped
    assert latest_step(ckpt) == 6
    assert (ckpt / "step_00000006" / "COMMIT").exists()
    like = {f: np.zeros((4, 24, 24), np.float32) for f in ("u", "v", "h")}
    state, extra = restore_checkpoint(ckpt, 6, like)
    assert set(state) == {"u", "v", "h"}
    assert extra["fields"] == ["u", "v", "h"]
    assert all(bool(np.isfinite(a.numpy()).all()) for a in state.values())
    jstate, _ = jax_ckpt.restore_checkpoint(ckpt, 6, like)  # the reference reads it too
    for f in state:
        np.testing.assert_array_equal(np.asarray(jstate[f]), state[f].numpy())
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    kinds = [e["kind"] for e in lines]
    assert "health.probe" in kinds and kinds.count("health.blowup") == 1
    probed = {e["data"]["field"] for e in lines if e["kind"] == "health.probe"}
    assert probed == {"u", "v", "h"}
    blowup = next(e for e in lines if e["kind"] == "health.blowup")
    assert blowup["data"]["step"] == 9
    assert blowup["data"]["field"] == "h"
    assert blowup["data"]["nan_count"] >= 1
    crash = json.loads((tmp_path / "events.jsonl.crash.json").read_text())
    assert any(e["kind"] == "health.blowup" for e in crash["events"])
    assert "blow" in crash["reason"] or "NaN" in crash["reason"]
    # The drill's checkpoint is the clean run's state after 6 steps.
    clean, _ = _run(capfd, "--steps", "6", "--devices", "2")
    for f in state:
        np.testing.assert_array_equal(state[f].numpy(), clean["final"][f])


def test_weather_example_health_probes_final_partial_chunk(tmp_path, capfd):
    """steps=11 with cadence 3 ends on a partial chunk: the final boundary
    is probed (force=True), so a NaN born in the last chunk cannot escape.
    The poisoned point lies in the second rank's block."""
    res, out = _run(capfd, "--steps", "11", "--devices", "2",
                    "--health", "--health-every", "3", "--inject-nan", "10",
                    "--health-policy", "abort", "--event-log", str(tmp_path / "events.jsonl"))
    assert res["code"] == 3
    assert "BLOWUP_DETECTED step=11 field=h" in out


def test_weather_example_health_clean_run(tmp_path, capfd):
    """--health on a healthy forecast: exit 0, probes on cadence for every
    output field (steps 0/3/6/9 x {u, v, h} = 12 probes)."""
    res, out = _run(capfd, "--steps", "9", "--devices", "2",
                    "--health", "--health-every", "3", "--health-policy", "warn",
                    "--event-log", str(tmp_path / "ok.jsonl"))
    assert res["code"] == 0
    assert "forecast healthy" in out
    assert "probes=12" in out and "blowups=0" in out
    assert "fields=u+v+h" in out


@pytest.mark.parametrize("devices,inner", [(1, "cuda"), (4, "reference")])
def test_final_fields_match_jax_lower_reference(capfd, devices, inner):
    """The gathered final {u, v, h} against the JAX package's
    lower_reference stepped eagerly on the same initial state, within TOL;
    --devices 4 on 24 rows splits the rows 4 ways."""
    steps = 3
    res, out = _run(capfd, "--steps", str(steps), "--devices", str(devices), "--inner", inner)
    assert res["code"] == 0 and len(res["launches"]) == devices
    assert all(launches == {} for launches in res["launches"])  # no kernel on the CPU
    prog = jax_shallow_water()
    h0 = jax_initial_field(4, 24, 24, kind="gaussian")
    state = {"u": jnp.zeros_like(h0), "v": jnp.zeros_like(h0), "h": h0}
    step = jax_lower_reference(prog)
    with jax.disable_jit():
        for _ in range(steps):
            state = step(state)
    for f in ("u", "v", "h"):
        np.testing.assert_allclose(res["final"][f], np.asarray(state[f]), rtol=0, atol=TOL)
    assert "distributed result matches single-device reference" in out


def test_driver_defaults_to_the_card_and_rejects_bad_flags():
    args = drv.parse_args([])
    assert (args.inner, args.device, args.devices, args.steps) == ("cuda", "cuda", 8, 50)
    if not drv_has_card():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            drv.run(drv.parse_args(["--steps", "1", "--devices", "1"]))
    with pytest.raises(SystemExit):
        drv.parse_args(["--inner", "pallas"])
    with pytest.raises(SystemExit):
        drv.parse_args(["--devices", "0"])


def drv_has_card() -> bool:
    import torch

    return torch.cuda.is_available()
