"""Reading a Chrome trace: busy time, idle gaps named by the host, the
breakdown."""

import types

import pytest

from portbench.tracing import Summary, host_names, short, union


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_union_merges_overlaps():
    assert union([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_short_names():
    assert short("void (anonymous namespace)::hdiff_kernel<float, 64, true>(float const*, int)") \
        == "(anonymous namespace)::hdiff_kernel<float, 64, true>"
    assert short("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH (Device -> Pinned)"


def test_host_names_pick_the_innermost_event():
    host = [(0.0, 10.0, "outer"), (2.0, 4.0, "inner"), (6.0, 9.0, "other")]
    assert host_names([1.0, 3.0, 7.0, 11.0], host) == ["outer", "inner", "other",
                                                       "host (no traced op)"]


def test_summary_of_a_stretch():
    events = [
        ev("portbench.stretch", "user_annotation", 100.0, 100.0),
        ev("portbench.stretch", "gpu_user_annotation", 100.0, 100.0),  # not device work
        ev("k(float*)", "kernel", 90.0, 30.0),      # clipped to 100-120
        ev("k(float*)", "kernel", 130.0, 20.0),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 145.0, 10.0),
        ev("aten::item", "cpu_op", 118.0, 15.0),
        ev("cudaStreamSynchronize", "cuda_runtime", 160.0, 45.0),
    ]
    driver = types.SimpleNamespace(stretch={"units": 2, "calls": 4}, layer_stats=lambda: {})
    s = Summary(events, driver, {}, {}, "NVIDIA H100 80GB HBM3", 700.0)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(45e-6)  # 100-120, 130-155
    assert s.device_s(lambda n: n.startswith("k(")) == pytest.approx(40e-6)
    assert s.gaps == pytest.approx({"aten::item": 10e-6, "cudaStreamSynchronize": 45e-6})
    b = s.breakdown()
    assert b["device_ops"][0] == ["k", pytest.approx(40e-6)]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(45e-6)]
    assert s.peaks["hbm_bytes_per_s"] == 3.35e12
