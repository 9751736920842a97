"""The program's spans in a traced stretch (``spans.py``) and the per-layer
metrics that read them: work launched inside a span by its correlation id,
idle time inside a span by overlap, host waits, the wrappers' host time; on
a synthetic Chrome trace, and on the CPU through the harness's own tracer."""

import types

import pytest

from portbench import spans
from portbench.harness import HERE, load_module, make_driver, run_window
from portbench.tracing import Summary, Tracer

NEW = ("probe_device_ms", "probe_idle_ms", "server_idle_ms", "forecast_host_waits",
       "dispatch_us")
OLD = ("k2b_roofline", "device_idle_pct.ensemble", "forecast_queue_ms", "forecast_copy_ms",
       "forecast_probe_ms")


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"test_metric_{name.replace('.', '_')}")


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def ann(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def launch(ts, corr, name="cudaLaunchKernel", dur=2.0):
    return ev(name, "cuda_runtime", ts, dur, corr)


def device(name, ts, dur, corr, cat="kernel"):
    return ev(name, cat, ts, dur, corr)


# One cycle of the forecast cell, in microseconds: the stretch is 100-400;
# the step 110-300 holds admit, stack, call, wait and retire, and retire two
# probes. K2 is launched in ``call``; each probe launches a reduction and
# reads a scalar (a copy and a wait); the client launches one kernel after
# the step; a launch before the stretch ends inside it.
SPANS = [
    ann("serve.forecast.step", 110, 190),
    ann("serve.forecast.admit", 111, 4),
    ann("serve.forecast.stack", 115, 5),
    ann("serve.forecast.call", 120, 6),
    ann("ir.lower_batched.hdiff_x2.cuda", 120.5, 5),
    ann("ir.lower_cuda.hdiff_x2", 121, 4),
    ann("serve.forecast.wait", 126, 34),
    ann("serve.forecast.retire", 160, 139),
    ann("health.probe", 165, 40),
    ann("health.probe", 210, 40),
    ann("serve.forecast.step", 110, 190) | {"cat": "gpu_user_annotation"},
]
BASE = [
    ann("portbench.stretch", 100, 300),
    ann("portbench.server.run_until_idle", 108, 195),
    launch(90, 1),
    device("CatArrayBatchedCopy_vectorized(float*)", 95, 10, 1),  # 100-105 in the stretch
    launch(116, 2),
    device("CatArrayBatchedCopy_vectorized(float*)", 117, 3, 2),
    launch(122, 3),
    device("stencil_program(float*)", 124, 34, 3),           # 124-158
    launch(127, None, "cudaDeviceSynchronize", 32),
    launch(166, 4),
    device("reduce_kernel(float*)", 168, 10, 4),              # 168-178
    launch(180, 5, "cudaMemcpyAsync"),
    device("Memcpy DtoH (Device -> Pageable)", 181, 1, 5, "gpu_memcpy"),
    launch(182, None, "cudaStreamSynchronize", 3),
    launch(212, 6),
    device("reduce_kernel(float*)", 215, 12, 6),              # 215-227
    launch(230, 7, "cudaMemcpyAsync"),
    device("Memcpy DtoH (Device -> Pageable)", 231, 1, 7, "gpu_memcpy"),
    launch(232, None, "cudaStreamSynchronize", 3),
    launch(310, 8),
    device("elementwise_kernel(float*)", 320, 30, 8),        # 320-350: the client's
    ev("aten::select", "cpu_op", 360, 5),
]


def summary(events, units=1, calls=21):
    driver = types.SimpleNamespace(stretch={"units": units, "calls": calls},
                                   layer_stats=lambda: {"queue_s": [1e-4, 3e-4]})
    cfg = {"rows": 30, "cols": 34, "fields": {"u": 1, "w": 2}, "members": 21}
    t = Summary(events, driver, cfg, {"sweeps_per_call": 2}, "NVIDIA H100 80GB HBM3", 700.0)
    t.program_spans = spans.Spans(events)
    return t


def test_interval_helpers():
    assert spans.subtract([[0, 10], [20, 30]], [[2, 3], [5, 25]]) == [[0, 2], [3, 5], [25, 30]]
    assert spans.overlap([[0, 10], [20, 30]], [[5, 25]]) == 10
    covers = spans.covering([[0, 1], [4, 6]])
    assert [covers(x) for x in (-1, 0.5, 2, 4, 6, 7)] == [False, True, False, True, True, False]


def test_work_is_counted_where_it_was_launched():
    t = summary(BASE + SPANS, units=2)
    s = t.program_spans
    # The probes' reductions and copies; not K2, the stack's copy or the
    # client's kernel, launched outside them.
    assert s.device_s("health.probe") == pytest.approx((10 + 1 + 12 + 1) * 1e-6)
    assert reader("probe_device_ms").read(t) == pytest.approx(0.024 / 2)
    assert s.device_s("serve.forecast.call") == pytest.approx(34e-6)
    assert s.device_s("serve.forecast.step") == pytest.approx((3 + 34 + 24) * 1e-6)
    # The stack's copy launched before the stretch counts nowhere.
    assert s.device_s("serve.forecast.stack") == pytest.approx(3e-6)


def test_probe_idle_server_idle_and_the_rest_add_up_to_the_stretch_idle():
    t = summary(BASE + SPANS)
    s = t.program_spans
    idle = t.window_s - t.busy_s
    assert s.busy_s == pytest.approx(t.busy_s)
    probe = reader("probe_idle_ms").read(t) * 1e-3
    server = reader("server_idle_ms").read(t) * 1e-3
    # Probes 165-205 and 210-250, busy 168-178, 181-182, 215-227, 231-232.
    assert probe == pytest.approx((40 - 11 + 40 - 13) * 1e-6)
    # The step 110-300 less the probes: busy 117-120 and 124-158 inside it.
    assert server == pytest.approx((190 - 80 - 3 - 34) * 1e-6)
    rest = s.idle_s("serve.forecast.step") - probe - server
    assert rest == pytest.approx(0.0, abs=1e-12)  # nested spans are not counted twice
    outside = (5 + 20 + 50) * 1e-6  # 105-110, 300-320, 350-400
    assert probe + server + outside == pytest.approx(idle)


def test_host_waits_inside_the_step():
    t = summary(BASE + SPANS, units=1)
    assert t.program_spans.waits_in("serve.forecast.step") == 3
    assert t.program_spans.waits_in("health.probe") == 2
    assert reader("forecast_host_waits").read(t) == 3.0


def test_dispatch_reads_the_outermost_wrapper_spans():
    steps = [ann("portbench.stretch", 0, 1000)]
    for i in range(4):
        steps += [ann("kernels.hdiff_fused", 10 + 100 * i, 20),
                  ann("ir.lower_cuda.hdiff", 12 + 100 * i, 5)]  # nested: not counted again
    t = summary(steps, units=1, calls=4)
    assert t.program_spans.outermost(("kernels.", "ir.")) == (4, pytest.approx(80e-6))
    assert reader("dispatch_us").read(t) == pytest.approx(20.0)
    # Under the server the lowered calls nest in its spans: nothing to read.
    assert reader("dispatch_us").read(summary(BASE + SPANS)) is None


def test_every_new_reader_finds_nothing_without_the_spans():
    t = summary(BASE)
    for name in NEW:
        assert reader(name).read(t) is None, name
    # Spans without device work, or without runtime calls (the CPU), read
    # nothing either, but the wrappers' host time.
    cpu = [e for e in BASE + SPANS if e["cat"] not in ("kernel", "gpu_memcpy", "cuda_runtime")]
    t = summary(cpu)
    for name in ("probe_device_ms", "probe_idle_ms", "server_idle_ms", "forecast_host_waits"):
        assert reader(name).read(t) is None, name


def test_existing_readers_and_breakdown_read_the_same_with_the_new_spans():
    plain, spanned = summary(BASE), summary(BASE + SPANS)
    for name in OLD:
        value = reader(name).read(plain)
        assert value is not None and reader(name).read(spanned) == value, name
    assert spanned.busy_s == plain.busy_s and spanned.window_s == plain.window_s
    a, b = plain.breakdown(), spanned.breakdown()
    assert a["device_ops"] == b["device_ops"]
    assert sum(v for _, v in a["idle_gaps"]) == pytest.approx(sum(v for _, v in b["idle_gaps"]))
    # The harness's drain span named the server's idle; its own spans do now.
    assert dict(a["idle_gaps"])["portbench.server.run_until_idle"] > 0
    assert "portbench.server.run_until_idle" not in dict(b["idle_gaps"])


def test_the_stretch_must_be_the_runs_own(tmp_path):
    import json

    t = summary(BASE)
    del t.program_spans
    other = [ann("portbench.stretch", 100, 250)]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": other}))
    with pytest.raises(RuntimeError, match="not this run's"):
        spans.of(t, tmp_path / "trace.json")


@pytest.mark.parametrize("name", ["cosmo-e.ens21", "cosmo1.k1-step", "cosmo1.ir-x2"])
def test_the_programs_spans_in_a_traced_stretch_on_the_cpu(name, tiny_cell, tmp_path):
    cell = tiny_cell(name)
    cfg, mix = cell["config"], cell["traffic"]
    driver = make_driver(cfg, mix, 2**32 + 7, "cpu")
    driver.setup()
    tracer = Tracer(False, path=tmp_path / "trace.json")
    tracer.warm()
    run_window(driver, 0.4, tracer)
    t = tracer.summary(driver, cfg, mix)
    s = spans.of(t, tmp_path / "trace.json")
    units, calls = t.counts["units"], t.counts["calls"]
    assert units > 0
    if name == "cosmo-e.ens21":
        assert s.count("serve.forecast.step") == units
        for child in ("admit", "stack", "call", "wait", "retire"):
            assert s.count(f"serve.forecast.{child}") == units
        assert s.count("health.probe") == calls == units * cfg["members"]
        assert s.count("ir.lower_batched.hdiff_x2.cuda") == units
        for m in NEW:  # no device work and no runtime calls on the CPU
            assert reader(m).read(t) is None, m
    else:
        wrapper = "kernels.hdiff_fused" if name == "cosmo1.k1-step" else "ir.lower_cuda.hdiff_x2"
        assert s.count(wrapper) == calls
        assert s.outermost(("kernels.", "ir."))[0] == calls
        assert reader("dispatch_us").read(t) > 0
