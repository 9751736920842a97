"""The harness at small sizes on the CPU: every cell runs and is correct, the
result line has the driver's keys, and BENCHMARK.json keeps the contract's
form and finds every file it names."""

import json
import re

import pytest

from portbench.harness import HERE, ROOT, load_cell, run_cell
from portbench.run import forbidden_modules, number, process_age, result_line

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct_on_the_cpu(name, trace, tiny_cell):
    cell = tiny_cell(name)
    out = run_cell(cell, 2**31 + 11, 0.3, trace, device="cpu", setup_clock=lambda: 1.5)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["compared"]) == set(cell["traffic"]["limits"]) | {"failed"}
    assert out["compared"]["failed"] == {"value": 0, "limit": 0}
    line = result_line(cell, out, trace, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["compared"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    json.loads(json.dumps(line, allow_nan=False))
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        names = {m["name"] for m in cell["end_to_end"]}
        assert set(line["metrics"]) == names and "setup_s" in names
        assert line["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}


def test_same_seed_same_inputs(tiny_cell):
    from portbench.harness import make_driver

    cell = tiny_cell("cosmo-e.ens21")
    a = make_driver(cell["config"], cell["traffic"], 2**33 + 5, "cpu")
    b = make_driver(cell["config"], cell["traffic"], 2**33 + 5, "cpu")
    c = make_driver(cell["config"], cell["traffic"], 2**33 + 6, "cpu")
    for d in (a, b, c):
        d.setup()
    assert all(x.equal(y) for x, y in zip(a.start, b.start))
    assert not a.start[0].equal(c.start[0]) and a.start[0].shape == c.start[0].shape


def test_failed_forecasts_fail_the_check_and_leave_the_rate(tiny_cell):
    """A member whose state holds a NaN is aborted by its probe every cycle:
    the run is not correct, and the rate counts only the other members."""

    def poison(driver):
        setup = driver.setup

        def patched():
            setup()
            bad = driver.state[0].clone()
            bad[0, 0, 0] = float("nan")
            driver.state = [bad] + driver.state[1:]

        driver.setup = patched

    cell = tiny_cell("cosmo-e.ens21")
    out = run_cell(cell, 5, 0.3, False, device="cpu", setup_clock=lambda: 1.0,
                   driver_hook=poison)
    units = out["attempted"] // cell["config"]["members"]
    assert out["failed"] == units and not out["correct"]
    assert out["compared"]["failed"] == {"value": units, "limit": 0}
    member = 3 * 30 * 34  # the tiny member: 3 planes of 30 x 34
    swept = out["end_to_end"]["ensemble_sweep_rate"] * 1e9 * out["window_s"]
    assert swept == pytest.approx((out["attempted"] - units) * 2 * member)


def test_a_unit_is_one_output_interval():
    from portbench.drivers.stepper import steps_per_unit

    cosmo1 = json.loads((HERE / "configs" / "cosmo1-hdiff.json").read_text())
    assert steps_per_unit(cosmo1, 1) == 360 and steps_per_unit(cosmo1, 2) == 180
    with pytest.raises(ValueError, match="no whole number"):
        steps_per_unit({"output_interval_s": 50, "time_step_s": 20}, 1)


def test_helpers_of_the_entry():
    assert number(float("inf")) is None and number(2.5) == 2.5 and number(3) == 3
    assert 0 < process_age() < 1e6
    assert "jax" not in {m.split(".")[0] for m in forbidden_modules()}


def test_benchmark_json_keeps_the_contract_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert set(cfg["fields"]) == {"u", "v", "w", "T", "pp"}
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", [cell])
    for name in CELLS:
        cell = load_cell(name)
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            if m["name"].endswith("_roofline"):
                assert m["layer"] == "kernels" and m["unit"] == "%"
