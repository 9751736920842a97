"""repro_torch.obs against repro.obs: the same calls give the same counts,
the same stats and the same exposition, and the port's own contracts hold.

Mirrors ``tests/test_obs.py``, ``tests/test_obs_health.py`` and
``tests/test_obs_events.py`` where a case needs no JAX, and adds what is the
port's own: ``instrument_call`` synchronises CUDA results and steps aside
while a CUDA graph is captured (simulated here by monkeypatching), and
``profiler_trace`` labels IR ops through ``torch.profiler``.

Tolerances: counts and extrema exact; ``field_stats`` mean and L2 within
1e-6 relative (the two packages sum in different orders).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ir as jir
import repro_torch.ir as tir
from conformance import SEED
from repro.obs import check_drift as jax_check_drift
from repro.obs import metrics as jax_metrics
from repro.obs import prometheus_text as jax_prometheus_text
from repro.obs.health import field_stats as jax_field_stats
from repro.obs.health import host_stats as jax_host_stats
from repro_torch.obs import (
    MATCH_KEYS,
    DriftResult,
    FlightRecorder,
    HealthMonitor,
    MetricsRegistry,
    NumericsError,
    RunReport,
    check_drift,
    events,
    field_stats,
    host_stats,
    is_healthy,
    maybe_trace,
    metrics,
    profiler_trace,
    prometheus_text,
    runtime_metadata,
    sanitize_metric_name,
)
from repro_torch.obs import profile as port_profile
from repro_torch.obs.health import STAT_KEYS

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both packages' channels disabled."""
    prev = (metrics.current(), events.current(), jax_metrics.current())
    metrics.disable()
    events.disable()
    jax_metrics.disable()
    yield
    metrics.enable(prev[0]) if prev[0] is not None else metrics.disable()
    events.enable(prev[1]) if prev[1] is not None else events.disable()
    jax_metrics.enable(prev[2]) if prev[2] is not None else jax_metrics.disable()


def _rand(shape, seed=SEED):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- same calls, same counts ------------------------------------------------


def _lowered_calls(ir, kernel_lowering):
    hdiff2 = ir.repeat(ir.hdiff_program(), 2)
    jac = ir.jacobi1d_program()
    return [
        (ir.lower_reference(hdiff2, mode="fused"), "grid"),
        (ir.lower_reference(hdiff2, mode="staged"), "grid"),
        (kernel_lowering(hdiff2), "grid"),
        (kernel_lowering(hdiff2), "grid"),
        (ir.lower_reference(jac, mode="fused"), "rows"),
        (ir.lower_reference(jac, mode="staged"), "rows"),
        (kernel_lowering(jac), "rows"),
        (kernel_lowering(ir.repeat(jac, 2)), "rows"),
    ]


def test_instrumented_lowerings_count_like_the_jax_package():
    grid, rows = _rand((2, 24, 20)), _rand((3, 40), seed=SEED + 1)
    inputs = {"grid": grid, "rows": rows}
    with jax_metrics.using() as jreg:
        for fn, kind in _lowered_calls(jir, lambda p: jir.lower_pallas(p, interpret=True)):
            fn(jnp.asarray(inputs[kind]))
    with metrics.using() as reg:
        for fn, kind in _lowered_calls(tir, tir.lower_cuda):
            fn(torch.from_numpy(inputs[kind]))
    want = {k.replace("ir.lower_pallas.", "ir.lower_cuda."): v
            for k, v in jreg.counters.items()}
    assert reg.counters == want
    assert reg.counters["ir.lower_cuda.hdiff_x2.calls"] == 2.0
    assert reg.counters["ir.lower_reference.jacobi1d.staged.calls"] == 1.0
    assert {k: v.count for k, v in reg.timers.items()} == {
        k.replace("ir.lower_pallas.", "ir.lower_cuda."): v.count
        for k, v in jreg.timers.items()
    }


def test_instrumented_results_equal_uninstrumented():
    x = torch.from_numpy(_rand((2, 24, 20)))
    fn = tir.lower_cuda(tir.repeat(tir.hdiff_program(), 2))
    off = fn(x)
    with metrics.using():
        on = fn(x)
    assert fn.metric_name == "ir.lower_cuda.hdiff_x2"
    np.testing.assert_array_equal(on.numpy(), off.numpy())


def test_disabled_wrapper_calls_straight_through(monkeypatch):
    """With no registry the wrapper neither queries capture nor
    synchronises: one attribute check, then the call."""
    def boom(*_):
        raise AssertionError("disabled path touched instrumentation")

    monkeypatch.setattr(metrics, "capturing", boom)
    monkeypatch.setattr(metrics, "synchronize", boom)
    fn = metrics.instrument_call(lambda a: a + 1, "test.fn")
    assert fn(1) == 2
    assert metrics.current() is None
    t1, t2 = metrics.timer("a"), metrics.timer("b")
    assert t1 is t2 is metrics._NULL_TIMER


def test_enabled_wrapper_records_and_synchronises_only_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    fn = metrics.instrument_call(lambda a: {"y": a * 2, "n": 3}, "test.dict")
    with metrics.using() as reg:
        out = fn(torch.ones(4))
        fn(torch.ones(4))
    assert torch.equal(out["y"], torch.full((4,), 2.0))
    assert reg.counters == {"test.dict.calls": 2.0}
    assert reg.timers["test.dict"].count == 2
    assert calls == []  # CPU results need no wait


def test_wrapper_steps_aside_during_graph_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert metrics.capturing()
    fn = metrics.instrument_call(lambda a: a * 2, "test.captured")
    m = HealthMonitor(cadence=1, policy="abort")
    with metrics.using() as reg:
        assert fn(torch.arange(3.0)).tolist() == [0.0, 2.0, 4.0]
        assert m.check(0, torch.tensor([float("nan")])) is None
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "timers": {}}
    assert m.probes == 0


def test_capturing_is_false_without_a_cuda_context():
    assert not torch.cuda.is_initialized()
    assert metrics.capturing() is False


def test_registry_core_mirrors_jax():
    regs = (MetricsRegistry(), jax_metrics.MetricsRegistry())
    for reg in regs:
        reg.inc("a")
        reg.inc("a", 2.5)
        reg.set_gauge("g", 7)
        with reg.timer("outer"):
            with reg.timer("inner"):
                pass
        reg.observe("lat", 0.25)
        reg.observe("lat", 0.75)
    snaps = [r.snapshot() for r in regs]
    for s in snaps:
        s["timers"] = {k: (v["count"], v["min_s"] if k == "lat" else None)
                       for k, v in s["timers"].items()}
    assert snaps[0] == snaps[1]
    json.dumps(regs[0].snapshot())
    regs[0].reset()
    assert regs[0].snapshot() == {"counters": {}, "gauges": {}, "timers": {}}


# --- health -----------------------------------------------------------------


def _poisoned():
    # Offset from zero so the mean is well conditioned: a relative bound on
    # a sum that cancels to ~0 would measure the cancellation, not the port.
    x = _rand((64, 96), seed=SEED + 2) + 2.0
    x[0, 0] = np.nan
    x[5, 7] = np.nan
    x[1, 1] = np.inf
    x[2, 2] = -np.inf
    return x


def test_field_stats_match_jax():
    x = _poisoned()
    got = field_stats(torch.from_numpy(x))
    want = jax_field_stats(jnp.asarray(x))
    assert set(got) == set(STAT_KEYS)
    for k in ("size", "nan_count", "inf_count"):
        assert got[k].dtype == torch.int32 and got[k].ndim == 0
        assert int(got[k]) == int(want[k])
    gh, wh = host_stats(got), jax_host_stats(want)
    assert gh["min"] == wh["min"] and gh["max"] == wh["max"]
    for k in ("mean", "l2"):
        np.testing.assert_allclose(gh[k], wh[k], rtol=1e-6)
    assert (gh["nan_count"], gh["inf_count"], gh["size"]) == (2, 2, x.size)


def test_field_stats_all_nonfinite_keeps_counts_as_the_alarm():
    s = host_stats(field_stats(torch.full((4,), float("nan"))))
    assert s["nan_count"] == 4
    assert s["mean"] == 0.0 and s["l2"] == 0.0
    assert s["min"] == math.inf and s["max"] == -math.inf
    assert not is_healthy(s)


def test_field_stats_counts_are_exact_past_float32_precision():
    n = 2**24 + 3
    s = field_stats(torch.ones((n,), dtype=torch.int8))
    assert s["size"].dtype == torch.int32 and int(s["size"]) == n
    assert int(s["nan_count"]) == 0 and int(s["inf_count"]) == 0


def test_field_stats_mesh_axes_wait_for_m9():
    """``axis_names`` needs the mesh those axes belong to; axes of one shard
    reduce nothing. The multi-rank all-reduce is tested on a 3x3 gloo mesh
    (tests/test_torch_dist_halo.py)."""
    from repro_torch.dist import Mesh

    x = torch.tensor([[1.0, float("nan")], [-2.0, 4.0]])
    with pytest.raises(ValueError, match="pass mesh="):
        field_stats(x, axis_names=("rows",))
    mesh = Mesh(("rows", "cols"), (1, 1), (0, 0), torch.device("cpu"), "gloo")
    want = host_stats(field_stats(x))
    assert host_stats(field_stats(x, axis_names=("rows", "cols"), mesh=mesh)) == want
    assert host_stats(field_stats(x, axis_names=("rows",), mesh=mesh)) == want
    with pytest.raises(ValueError, match="no axis 'depth'"):
        field_stats(x, axis_names=("depth",), mesh=mesh)


def test_is_healthy_max_abs_bound():
    s = host_stats(field_stats(torch.tensor([1.0, -3.0, 2.0])))
    assert is_healthy(s) and is_healthy(s, max_abs=3.0)
    assert not is_healthy(s, max_abs=2.5)


def test_monitor_validates_construction():
    with pytest.raises(ValueError, match="cadence"):
        HealthMonitor(cadence=0)
    with pytest.raises(ValueError, match="policy"):
        HealthMonitor(policy="explode")
    with pytest.raises(ValueError, match="checkpoint_fn"):
        HealthMonitor(policy="checkpoint-then-abort")


def test_monitor_probes_on_cadence_only():
    m = HealthMonitor(cadence=3)
    x = torch.ones(4)
    assert [s for s in range(10) if m.check(s, x) is not None] == [0, 3, 6, 9]
    assert m.check(1, x, force=True) is not None and m.last_healthy[0] == 1


def test_monitor_warn_policy_logs_and_continues():
    logged = []
    m = HealthMonitor(cadence=1, policy="warn", log_fn=logged.append)
    stats = m.check(0, torch.tensor([1.0, float("nan")]))
    assert stats["nan_count"] == 1 and m.blowups == 1
    assert logged and "blow-up" in logged[0]
    assert m.last_healthy is None


def test_monitor_abort_policy_raises_with_context():
    m = HealthMonitor(cadence=1, policy="abort", name="psi")
    m.check(0, torch.ones(3))
    with pytest.raises(NumericsError) as ei:
        m.check(1, torch.tensor([float("inf"), 0.0]))
    assert ei.value.step == 1 and ei.value.field == "psi"
    assert ei.value.stats["inf_count"] == 1 and m.last_healthy[0] == 0


def test_monitor_checkpoint_then_abort_hands_over_last_healthy_state():
    saved = []
    m = HealthMonitor(cadence=2, policy="checkpoint-then-abort",
                      checkpoint_fn=lambda step, state: saved.append((step, state)),
                      log_fn=lambda _: None)
    good = torch.arange(4.0)
    m.check(0, good, state={"params": good})
    m.check(2, good * 2, state={"params": good * 2})
    with pytest.raises(NumericsError):
        m.check(4, torch.tensor([float("nan")]))
    ((step, state),) = saved
    assert step == 2 and torch.equal(state["params"], torch.arange(4.0) * 2)


def test_monitor_snapshot_state_survives_in_place_updates():
    """The port's counterpart of surviving buffer donation: a step that
    updates its state in place must not change the retained snapshot."""
    saved = []
    m = HealthMonitor(cadence=1, policy="checkpoint-then-abort", snapshot_state=True,
                      checkpoint_fn=lambda s, st: saved.append((s, st)),
                      log_fn=lambda _: None)
    p = torch.arange(4.0)
    m.check(0, 1.0, state={"p": p})
    p.mul_(float("nan"))
    with pytest.raises(NumericsError):
        m.check(1, float("nan"), state={"p": p})
    ((s, st),) = saved
    assert s == 0 and torch.equal(st["p"], torch.arange(4.0))
    assert st["p"].untyped_storage().data_ptr() != p.untyped_storage().data_ptr()


def test_monitor_without_snapshot_retains_state_by_reference():
    m = HealthMonitor(cadence=1)
    x = torch.arange(3.0)
    m.check(0, 1.0, state=x)
    assert m.last_healthy[1] is x


def test_monitor_checkpoint_then_abort_without_healthy_probe_still_aborts():
    saved = []
    m = HealthMonitor(cadence=1, policy="checkpoint-then-abort",
                      checkpoint_fn=lambda s, st: saved.append(s), log_fn=lambda _: None)
    with pytest.raises(NumericsError):
        m.check(0, torch.tensor([float("nan")]))
    assert saved == []


def test_monitor_wrap_probes_outputs_bit_identically():
    m = HealthMonitor(cadence=2, policy="abort", name="out")
    fn = tir.lower_cuda(tir.jacobi1d_program())
    wrapped = m.wrap(fn, name="out")
    x = torch.from_numpy(_rand((2, 16)))
    outs = [wrapped(x) for _ in range(4)]
    assert m.probes == 2
    for got in outs:
        assert torch.equal(got, fn(x))


def test_monitor_reports_through_metrics_and_events():
    with metrics.using() as reg, events.using() as rec:
        m = HealthMonitor(cadence=1, policy="warn", name="psi", log_fn=lambda _: None)
        m.check(0, torch.ones(4))
        m.check(1, torch.tensor([float("nan")]))
    snap = reg.snapshot()
    assert snap["counters"] == {"health.probes": 2.0, "health.reads": 14.0,
                                "health.blowups": 1.0}
    assert m.reads == 14  # seven scalars a probe
    assert snap["gauges"]["health.psi.nan_count"] == 1.0
    kinds = [e.kind for e in rec.events()]
    assert kinds.count("health.probe") == 2 and kinds.count("health.blowup") == 1
    assert rec.events("health.blowup")[0].data["step"] == 1


def test_monitor_works_with_both_channels_off():
    m = HealthMonitor(cadence=1, policy="abort")
    assert m.check(0, torch.ones(2))["nan_count"] == 0
    with pytest.raises(NumericsError):
        m.check(1, torch.tensor([float("inf")]))


# --- export, drift, events ----------------------------------------------------


def _fill(reg):
    reg.inc("serve.prefills", 3)
    reg.set_gauge("health.psi.nan_count", 0)
    reg.set_gauge("g.nan", float("nan"))
    reg.observe("serve.decode_step", 0.25)
    reg.observe("serve.decode_step", 0.75)
    return reg


def test_prometheus_text_equals_jax_on_equal_snapshots():
    port = prometheus_text(_fill(MetricsRegistry()))
    ref = jax_prometheus_text(_fill(jax_metrics.MetricsRegistry()))
    assert port == ref
    assert "repro_serve_prefills_total 3.0" in port
    assert "repro_serve_decode_step_seconds_sum 1.0" in port
    assert prometheus_text().startswith("#")
    assert sanitize_metric_name("9lives") == "_9lives"


@pytest.mark.parametrize("measured,model,tol", [(1005, 1000, 0.01), (1100, 1000, 0.01),
                                                (0, 0, 0.01), (8, 0, 0.01)])
def test_check_drift_matches_jax(measured, model, tol):
    reg, jreg = MetricsRegistry(), jax_metrics.MetricsRegistry()
    got = check_drift("wire", measured, model, tol, registry=reg)
    want = jax_check_drift("wire", measured, model, tol, registry=jreg)
    assert isinstance(got, DriftResult)
    assert (got.ok, got.ratio, got.describe()) == (want.ok, want.ratio, want.describe())
    assert reg.snapshot() == jreg.snapshot()


def test_ring_is_bounded_filtered_and_ordered():
    rec = FlightRecorder(capacity=3)
    for i in range(5):
        rec.record("tick" if i % 2 else "tock", i=i)
    assert len(rec) == 3 and rec.dropped == 2
    assert [e.seq for e in rec.events()] == [2, 3, 4]
    assert [e.data["i"] for e in rec.events("tick")] == [3]
    with rec.span("phase", label="x"):
        pass
    assert rec.events("phase")[0].data["duration_s"] >= 0.0
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


def test_sink_header_carries_torch_metadata_and_crash_dump(tmp_path):
    sink = tmp_path / "run" / "events.jsonl"
    rec = FlightRecorder(capacity=2, sink=sink)
    for i in range(3):
        rec.record("step", i=i)
    out = rec.crash_dump(reason="blew up")
    rec.close()
    lines = [json.loads(line) for line in sink.read_text().splitlines()]
    assert lines[0]["kind"] == "meta" and lines[0]["data"]["backend"] == "cpu"
    assert "torch_version" in lines[0]["data"]
    assert [line["kind"] for line in lines[1:]] == ["step"] * 3
    dump = json.loads(out.read_text())
    assert out == tmp_path / "run" / "events.jsonl.crash.json"
    assert dump["reason"] == "blew up" and dump["dropped"] == 1


def test_switchboards_are_noops_when_disabled_and_scope_when_used(tmp_path):
    assert events.record("never") is None and events.crash_dump() is None
    with events.span("never"):
        pass
    with events.using(FlightRecorder(sink=tmp_path / "s.jsonl")) as rec:
        events.record("inside")
    assert rec._file is None and len(rec) == 1 and events.current() is None
    with metrics.using() as reg:
        metrics.inc("x")
    assert reg.counters == {"x": 1.0} and metrics.current() is None


def test_env_auto_enables_both_channels(tmp_path):
    sink = tmp_path / "auto.jsonl"
    code = (
        "from repro_torch.obs import events, metrics\n"
        "import sys\n"
        "assert events.enabled() and metrics.enabled()\n"
        "events.record('auto.test', ok=True)\n"
        "assert 'jax' not in sys.modules\n"
    )
    env = {**os.environ, "REPRO_EVENT_LOG": str(sink), "REPRO_METRICS": "1",
           "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [json.loads(x)["kind"] for x in sink.read_text().splitlines()] == [
        "meta", "auto.test"]


# --- report and trace ----------------------------------------------------------


def test_runtime_metadata_on_the_cpu_touches_no_cuda():
    meta = runtime_metadata()
    for key in MATCH_KEYS:
        assert key in meta
    assert meta["backend"] == "cpu" and meta["device_kind"] == "cpu"
    assert meta["device_count"] == 1 and meta["nvidia_smi"] is None
    assert meta["torch_version"] == torch.__version__
    assert not torch.cuda.is_initialized()


def test_run_report_roundtrip(tmp_path):
    rep = RunReport.begin("unit").add_section("rows", [{"value": 1.0}])
    with metrics.using() as reg:
        reg.inc("c")
        rep.attach_metrics(reg)
    loaded = json.loads(rep.write(tmp_path / "report.json").read_text())
    assert loaded["metrics"]["counters"] == {"c": 1.0}
    assert all(k in loaded["metadata"] for k in MATCH_KEYS)


def test_profiler_trace_labels_ir_ops(tmp_path):
    fn = tir.lower_reference(tir.hdiff_program())
    x = torch.from_numpy(_rand((1, 16, 16)))
    assert not port_profile.tracing()
    with profiler_trace(tmp_path / "t") as prof:
        assert prof is not None and port_profile.tracing()
        fn(x)
    assert not port_profile.tracing()
    text = (tmp_path / "t" / "trace.json").read_text()
    for op in ("lap", "flx_r", "flx_rm", "flx_c", "flx_cm", "out"):
        assert f'"ir/hdiff/{op}"' in text
    assert any(e.key == "ir/hdiff/lap" for e in prof.key_averages())


def test_maybe_trace_is_env_gated(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TRACE_DIR", raising=False)
    with maybe_trace("label") as prof:
        assert prof is None
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    with maybe_trace("unit"):
        tir.lower_reference(tir.laplacian_program())(torch.ones(1, 8, 8))
    assert '"ir/laplacian/out"' in (tmp_path / "unit" / "trace.json").read_text()


# -- spans on any profiler's clock ----------------------------------------------


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _annotations(prof, tmp_path):
    """The ``user_annotation`` spans of a finished profile, by start time."""
    path = tmp_path / "annotations.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events
                   if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                  key=lambda e: float(e["ts"]))


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not port_profile.tracing()
    first, second = port_profile.span("a"), port_profile.span("b")
    assert first is second is port_profile._NULL_SPAN
    with first as entered:
        assert entered is None
    fn = metrics.instrument_call(lambda x: x + 1, "test.span.off")
    assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))
    tir.lower_reference(tir.hdiff_program())(torch.from_numpy(_rand((1, 16, 16))))


def test_span_is_a_user_annotation_under_any_torch_profiler(tmp_path):
    with _cpu_profile() as prof:
        assert port_profile.tracing()
        with port_profile.span("test.outer"):
            with port_profile.span("test.inner"):
                torch.ones(4).sum()
    assert not port_profile.tracing()
    spans = {e["name"]: e for e in _annotations(prof, tmp_path)}
    outer, inner = spans["test.outer"], spans["test.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_lowered_calls_and_k1_open_spans_named_as_their_metrics(tmp_path):
    from repro_torch.kernels.hdiff.ops import hdiff_fused

    x = torch.from_numpy(_rand((1, 16, 16)))
    hd = tir.hdiff_program()
    ref, cuda = tir.lower_reference(hd), tir.lower_cuda(hd)
    batched = tir.lower_batched(hd, backend="cuda")
    with _cpu_profile() as prof:
        ref(x)
        cuda(x)
        batched(x[None])
        hdiff_fused(x)
    names = [e["name"] for e in _annotations(prof, tmp_path)]
    for name in (ref.metric_name, "ir.lower_cuda.hdiff", "ir.lower_batched.hdiff.cuda",
                 "kernels.hdiff_fused"):
        assert name in names
    # The batched call's unbatched lowering is a lowered call of its own.
    assert names.count("ir.lower_cuda.hdiff") == 2


def test_monitor_counts_host_reads_and_spans_each_probe(tmp_path):
    m = HealthMonitor(cadence=2, policy="warn", log_fn=lambda _: None)
    with _cpu_profile() as prof:
        for step in range(5):
            m.check(step, torch.ones(8))
    assert m.probes == 3 and m.reads == 3 * len(STAT_KEYS) == 21
    probes = [e for e in _annotations(prof, tmp_path) if e["name"] == "health.probe"]
    assert len(probes) == 3


def test_instrumented_call_spans_with_the_registry_on_too(tmp_path):
    fn = tir.lower_cuda(tir.hdiff_program())
    x = torch.from_numpy(_rand((1, 16, 16)))
    with metrics.using() as reg, _cpu_profile() as prof:
        fn(x)
        fn(x)
    assert reg.counters["ir.lower_cuda.hdiff.calls"] == 2.0
    assert reg.timers["ir.lower_cuda.hdiff"].count == 2
    names = [e["name"] for e in _annotations(prof, tmp_path)]
    assert names.count("ir.lower_cuda.hdiff") == 2


def test_skipped_probes_read_nothing_and_an_abort_counts_its_reads(tmp_path):
    m = HealthMonitor(cadence=10, policy="abort")
    with _cpu_profile() as prof:
        assert m.check(3, torch.ones(4)) is None  # off cadence: no device work
        with pytest.raises(NumericsError):
            m.check(10, torch.tensor([1.0, float("inf")]))
    assert m.probes == 1 and m.reads == len(STAT_KEYS) and m.blowups == 1
    probes = [e for e in _annotations(prof, tmp_path) if e["name"] == "health.probe"]
    assert len(probes) == 1
