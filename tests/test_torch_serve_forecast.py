"""The port's forecast-serving layer (``repro_torch.serve.cache`` and
``repro_torch.serve.forecast``) against the JAX package's.

Mirrors ``tests/test_serve_forecast.py`` (the serving stress suite, fault
injection, and the deterministic cache tests with the real builder) and
the hypothesis LRU properties of ``tests/test_serve_cache.py`` (stub
builder). The JAX package's trace probe becomes a count of first-seen
call signatures, which the zero-retrace tests read as the JAX ones read
traces. One cross-package test drives the same request schedule through
the JAX ``ForecastServer`` (``pallas``, interpret mode) and the port's
(``cuda``, K2's plain version on the CPU): the same batches (rids per
batch), cache stats and signature counts, and results within ``TOL``.

Servers here run on the CPU (``device="cpu"``); ``device=None`` means the
card and raises without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

import repro.ir as jir
import repro.serve as jserve
import repro_torch.ir as tir
from conformance import TOL, assert_close
from repro_torch.interop import to_numpy
from repro_torch.ir import StencilProgram, affine
from repro_torch.obs import events, metrics
from repro_torch.obs.health import HealthMonitor, NumericsError
from repro_torch.serve import (
    CacheEntry,
    CompileCache,
    CompileKey,
    ForecastRequest,
    ForecastServer,
    compile_key,
)

SEED = 99
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _obs_on():
    with metrics.using(), events.using():
        yield


def _noise(grid, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(grid).astype(np.float32))


def _sw_fields(grid, seed):
    rng = np.random.default_rng(seed)
    return {f: torch.from_numpy(rng.standard_normal(grid).astype(np.float32))
            for f in tir.shallow_water_program().inputs}


def _equal(a, b, msg=""):
    if isinstance(a, dict):
        assert set(a) == set(b), msg
        for f in a:
            assert torch.equal(a[f], b[f]), f"{msg}[{f}]"
    else:
        assert torch.equal(a, b), msg


def _server(**kw):
    return ForecastServer(device="cpu", **kw)


# -- deterministic cache tests (real builder) ---------------------------------


def test_cache_hit_performs_zero_retraces():
    """The per-entry probe counts first-seen call signatures, and a warm
    cache serving the same (program, grid, dtype, backend, batch) key again
    — batched and unbatched — adds none."""
    p = tir.hdiff_program()
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((3, 2, 16, 16)).astype(np.float32))

    cache = CompileCache(4)
    fn = cache.get(p, grid=(2, 16, 16), batch=3)
    fn(xb)
    entry = cache.lookup(compile_key(p, grid=(2, 16, 16), batch=3))
    assert entry.traces == 1  # the miss paid exactly one signature

    for _ in range(3):  # warm hits: same key, fresh data
        fn = cache.get(p, grid=(2, 16, 16), batch=3)
        fn(torch.from_numpy(rng.standard_normal((3, 2, 16, 16)).astype(np.float32)))
    assert entry.traces == 1, "cache hit re-traced"
    assert cache.stats()["hits"] == 3

    f1 = cache.get(p, grid=(2, 16, 16))
    f1(xb[0])
    f1 = cache.get(p, grid=(2, 16, 16))
    f1(xb[1])
    assert cache.lookup(compile_key(p, grid=(2, 16, 16))).traces == 1
    assert cache.total_traces() == 2
    # CPU calls load and build no kernel.
    assert all(cache.lookup(k).kernels_built == cache.lookup(k).nvcc_builds == 0
               for k in cache.keys())
    assert metrics.current().counters["cache.traces"] == 2


def test_rebuild_after_eviction_retraces_once():
    hd, lap = tir.hdiff_program(), tir.laplacian_program()
    x = torch.zeros((2, 16, 16))
    cache = CompileCache(1)
    cache.get(hd, grid=(2, 16, 16))(x)
    cache.get(lap, grid=(2, 16, 16))(x)   # evicts hd
    cache.get(hd, grid=(2, 16, 16))(x)    # miss again
    assert cache.stats() == {
        "hits": 0, "misses": 3, "evictions": 2, "size": 1, "capacity": 1,
    }
    assert cache.lookup(compile_key(hd, grid=(2, 16, 16))).traces == 1


def test_cache_counters_reach_registry():
    cache = CompileCache(1)
    x = torch.zeros((2, 16, 16))
    cache.get(tir.hdiff_program(), grid=(2, 16, 16))(x)      # miss
    cache.get(tir.hdiff_program(), grid=(2, 16, 16))(x)      # hit
    cache.get(tir.laplacian_program(), grid=(2, 16, 16))(x)  # miss + evict
    snap = metrics.current().snapshot()["counters"]
    assert snap["cache.hits"] == 1
    assert snap["cache.misses"] == 2
    assert snap["cache.evictions"] == 1
    kinds = [e.kind for e in events.current().events()]
    assert kinds.count("cache.insert") == 2 and kinds.count("cache.evict") == 1


def test_new_signature_on_one_entry_counts_as_a_trace():
    """What a jit would retrace on: a new dtype or device type at the same
    entry is one more signature; the same one again is none."""
    cache = CompileCache(2)
    fn = cache.get(tir.hdiff_program(), grid=(2, 16, 16))
    fn(torch.zeros((2, 16, 16)))
    fn(torch.ones((2, 16, 16)))
    fn(torch.zeros((2, 16, 16), dtype=torch.bfloat16))
    entry = cache.lookup(compile_key(tir.hdiff_program(), grid=(2, 16, 16)))
    assert entry.traces == 2


@pytest.mark.parametrize("dtype, name", [
    (torch.float32, "float32"), (torch.bfloat16, "bfloat16"), (np.float32, "float32"),
    ("float32", "float32"), ("bfloat16", "bfloat16"),
])
def test_compile_key_reads_as_the_jax_packages(dtype, name):
    """Same fingerprint, grid, dtype name, mesh, k, backend and batch as the
    JAX package's key of the same request."""
    port = compile_key(tir.repeat(tir.hdiff_program(), 2), grid=(2, 16, 16), dtype=dtype,
                       backend="cuda", mesh_shape=(2, 4), batch=3)
    jdtype = jnp.bfloat16 if name == "bfloat16" else np.float32
    ref = jserve.compile_key(jir.repeat(jir.hdiff_program(), 2), grid=(2, 16, 16),
                             dtype=jdtype, backend="cuda", mesh_shape=(2, 4), batch=3)
    assert isinstance(port, CompileKey)
    assert port.dtype == name
    assert tuple(vars(port).values()) == tuple(vars(ref).values())


# -- the serving stress suite ---------------------------------------------------


def _submit_interleaved(srv):
    """Three tenants' worth of traffic in one interleaved arrival order:
    hdiff on two DIFFERENT grids (must not co-batch) and shallow_water
    (multi-output) between them. Returns {rid: (program, fields)}."""
    hd, sw = tir.hdiff_program(), tir.shallow_water_program()
    plan = [
        (hd, _noise((2, 16, 16), SEED + 0)),
        (sw, _sw_fields((2, 12, 12), SEED + 1)),
        (hd, _noise((2, 16, 16), SEED + 2)),
        (hd, _noise((2, 24, 24), SEED + 3)),   # other grid: own batch
        (sw, _sw_fields((2, 12, 12), SEED + 4)),
        (hd, _noise((2, 16, 16), SEED + 5)),
        (hd, _noise((2, 16, 16), SEED + 6)),
        (sw, _sw_fields((2, 12, 12), SEED + 7)),
    ]
    return {srv.submit(prog, fields): (prog, fields) for prog, fields in plan}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_stress_interleaved_tenants_all_complete_and_match_oracles(backend):
    srv = _server(max_batch=4, backend=backend)
    subs = _submit_interleaved(srv)
    done = srv.run_until_idle()
    assert len(done) == len(subs) and srv.pending() == 0
    assert all(r.done and not r.failed for r in done)
    assert srv.stats["batches"] == 3
    assert srv.stats["members"] == len(subs)
    for r in done:
        prog, fields = subs[r.rid]
        want = to_numpy(tir.lower_reference(prog)(fields))
        assert_close(to_numpy(r.result), want, err_msg=f"rid={r.rid} vs oracle")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_served_results_bit_match_unbatched_same_backend(backend):
    prog = tir.repeat(tir.hdiff_program(), 2)
    fields = [_noise((2, 16, 16), SEED + i) for i in range(3)]
    srv = _server(max_batch=4, backend=backend)
    rids = [srv.submit(prog, f) for f in fields]
    done = {r.rid: r for r in srv.run_until_idle()}
    base = srv.cache.get(prog, grid=(2, 16, 16), backend=backend)  # the unbatched twin
    for rid, f in zip(rids, fields):
        _equal(done[rid].result, base(f), f"rid={rid} batched vs unbatched")


def test_telemetry_stamped_per_request_and_server():
    srv = _server(max_batch=4)
    _submit_interleaved(srv)
    done = srv.run_until_idle()
    for r in done:
        assert r.queue_latency_s is not None and r.queue_latency_s >= 0
        assert r.items_per_sec is not None and r.items_per_sec > 0
    snap = metrics.current().snapshot()
    assert snap["gauges"]["serve.forecast.steps_per_sec"] > 0
    assert snap["gauges"]["serve.forecast.members_per_sec"] > 0
    assert snap["gauges"]["serve.forecast.member_occupancy"] == 0.0
    assert snap["counters"]["serve.forecast.requests_submitted"] == len(done)
    assert snap["counters"]["serve.forecast.completed"] == len(done)
    assert snap["counters"]["serve.forecast.batches"] == 3
    assert snap["counters"]["serve.forecast.members"] == len(done)
    assert snap["timers"]["serve.forecast.queue_latency"]["count"] == len(done)
    assert snap["timers"]["serve.forecast.step"]["count"] == 3
    retires = events.current().events("serve.forecast.retire")
    assert len(retires) == len(done)
    assert all(e.data["items_per_sec"] > 0 for e in retires)
    assert len(events.current().events("serve.forecast.submit")) == len(done)
    assert f"repro_serve_forecast_completed_total {float(len(done))}" in srv.metrics_text()


def test_member_occupancy_gauge_tracks_last_batch():
    srv = _server(max_batch=4)
    for i in range(3):
        srv.submit(tir.hdiff_program(), _noise((2, 16, 16), SEED + i))
    assert srv.step() is True
    snap = metrics.current().snapshot()
    assert snap["gauges"]["serve.forecast.member_occupancy"] == 3 / 4
    assert srv.step() is False
    assert metrics.current().snapshot()["gauges"][
        "serve.forecast.member_occupancy"
    ] == 0.0


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_nan_injected_request_fails_alone(backend):
    clean = [_noise((2, 16, 16), SEED + i) for i in range(3)]
    poisoned = clean[1].clone()
    poisoned[0, 5, 5] = float("nan")

    srv = _server(max_batch=4, backend=backend, monitor=HealthMonitor(policy="abort"))
    rid0 = srv.submit(tir.hdiff_program(), clean[0])
    rid_bad = srv.submit(tir.hdiff_program(), poisoned)
    rid2 = srv.submit(tir.hdiff_program(), clean[2])
    done = {r.rid: r for r in srv.run_until_idle()}

    assert srv.stats == {"batches": 1, "members": 3, "completed": 2, "failed": 1}
    bad = done[rid_bad]
    assert bad.done and bad.failed and bad.result is None
    assert isinstance(bad.error, NumericsError)

    oracle_srv = _server(max_batch=4, backend=backend)
    o0 = oracle_srv.submit(tir.hdiff_program(), clean[0])
    o2 = oracle_srv.submit(tir.hdiff_program(), clean[2])
    oracle = {r.rid: r for r in oracle_srv.run_until_idle()}
    _equal(done[rid0].result, oracle[o0].result)
    _equal(done[rid2].result, oracle[o2].result)

    snap = metrics.current().snapshot()["counters"]
    assert snap["serve.forecast.failed"] == 1
    fails = events.current().events("serve.forecast.fail")
    assert len(fails) == 1 and fails[0].data["rid"] == rid_bad


def test_nan_isolation_multi_output():
    fields = [_sw_fields((2, 12, 12), SEED + i) for i in range(3)]
    bad = dict(fields[0])
    bad["h"] = bad["h"].clone()
    bad["h"][1, 3, 3] = float("inf")

    srv = _server(max_batch=4, backend="cuda", monitor=HealthMonitor(policy="abort"))
    rid_bad = srv.submit(tir.shallow_water_program(), bad)
    rids = [srv.submit(tir.shallow_water_program(), f) for f in fields[1:]]
    done = {r.rid: r for r in srv.run_until_idle()}
    assert done[rid_bad].failed
    ref = tir.lower_reference(tir.shallow_water_program())
    for rid, f in zip(rids, fields[1:]):
        assert not done[rid].failed
        assert_close(to_numpy(done[rid].result), to_numpy(ref(f)))


def test_warm_serving_is_all_hits_with_zero_retraces():
    srv = _server(max_batch=4, backend="cuda")

    def wave(seed0):
        for i in range(4):
            srv.submit(tir.hdiff_program(), _noise((2, 16, 16), seed0 + i))
        srv.run_until_idle()

    wave(SEED)
    misses0 = srv.cache.stats()["misses"]
    traces0 = srv.cache.total_traces()
    wave(SEED + 100)  # fresh data, same shapes
    assert srv.cache.stats()["misses"] == misses0, "warm wave missed"
    assert srv.cache.total_traces() == traces0, "warm wave re-traced"
    assert srv.cache.hit_rate > 0


def test_submit_validation():
    srv = _server()
    with pytest.raises(ValueError, match="pass a mapping"):
        srv.submit(tir.shallow_water_program(), torch.zeros((2, 8, 8)))
    with pytest.raises(ValueError, match="missing input"):
        srv.submit(tir.shallow_water_program(), {"u": torch.zeros((2, 8, 8))})
    with pytest.raises(ValueError, match="share a grid"):
        srv.submit(
            tir.shallow_water_program(),
            {"u": torch.zeros((2, 8, 8)), "v": torch.zeros((2, 8, 8)),
             "h": torch.zeros((2, 9, 9))},
        )
    with pytest.raises(ValueError, match="depth, rows, cols"):
        srv.submit(tir.hdiff_program(), torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="max_batch"):
        _server(max_batch=0)


# -- the device rule --------------------------------------------------------------


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ForecastServer()


def test_numpy_fields_become_tensors_on_the_servers_device():
    srv = _server(backend="cuda")
    a = np.random.default_rng(0).standard_normal((2, 16, 16)).astype(np.float32)
    rid = srv.submit(tir.hdiff_program(), a)
    a[...] = 0.0  # the server took a copy
    (req,) = srv.run_until_idle()
    assert req.rid == rid and req.result.device == CPU
    want = tir.lower_cuda(tir.hdiff_program())(
        torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 16))
                         .astype(np.float32)))
    assert torch.equal(req.result, want)


def test_tensor_on_another_device_is_rejected():
    srv = _server()
    with pytest.raises(ValueError, match="move it there first"):
        srv.submit(tir.hdiff_program(), torch.zeros((2, 16, 16), device="meta"))


def test_dtype_joins_the_group_key():
    srv = _server(max_batch=4, backend="cuda")
    x = _noise((2, 16, 16), SEED)
    srv.submit(tir.hdiff_program(), x)
    srv.submit(tir.hdiff_program(), x.to(torch.bfloat16))
    srv.submit(tir.hdiff_program(), x)
    done = srv.run_until_idle()
    assert srv.stats["batches"] == 2
    assert [r.rid for r in done] == [0, 2, 1]
    assert done[2].result.dtype == torch.bfloat16
    assert {k.dtype for k in srv.cache.keys()} == {"float32", "bfloat16"}


def test_request_carries_its_group_key():
    srv = _server(backend="cuda")
    srv.submit(tir.repeat(tir.hdiff_program(), 2), _noise((2, 16, 16), SEED))
    req = srv._queue[0]
    assert isinstance(req, ForecastRequest)
    assert req.group_key == compile_key(tir.repeat(tir.hdiff_program(), 2),
                                        grid=(2, 16, 16), backend="cuda")


# -- one schedule through both packages --------------------------------------------


def _spy_groups(srv):
    groups, admit = [], srv._admit_group

    def spy():
        group = admit()
        groups.append([r.rid for r in group])
        return group

    srv._admit_group = spy
    return groups


def test_same_schedule_through_both_packages():
    """Interleaved tenants, three grids and two k's, max_batch 3 and a
    cache of 3 entries (so it evicts), two waves: the JAX server
    (``pallas``, interpret mode) and the port's (``cuda``) form the same
    batches, end with equal cache stats and signature counts, and agree
    within TOL on every result."""
    rng = np.random.default_rng(SEED)
    progs = {
        "hd": (jir.hdiff_program(), tir.hdiff_program()),
        "hd2": (jir.repeat(jir.hdiff_program(), 2), tir.repeat(tir.hdiff_program(), 2)),
        "sw": (jir.shallow_water_program(), tir.shallow_water_program()),
    }
    schedule = []
    for wave in range(2):
        for name, grid in (("hd", (2, 16, 16)), ("sw", (2, 12, 12)), ("hd", (2, 16, 16)),
                           ("hd2", (2, 16, 16)), ("hd", (2, 20, 20)), ("sw", (2, 12, 12)),
                           ("hd", (2, 16, 16)), ("hd", (2, 16, 16)), ("hd2", (2, 16, 16))):
            prog = progs[name][1]
            schedule.append((name, {f: rng.standard_normal(grid).astype(np.float32)
                                    for f in prog.inputs}))
    jsrv = jserve.ForecastServer(backend="pallas", max_batch=3, cache_capacity=3,
                                 lower_kwargs={"interpret": True})
    tsrv = _server(backend="cuda", max_batch=3, cache_capacity=3)
    jgroups, tgroups = _spy_groups(jsrv), _spy_groups(tsrv)
    half = len(schedule) // 2
    jdone, tdone = {}, {}
    for part in (schedule[:half], schedule[half:]):
        for name, fields in part:
            jp, tp = progs[name]
            jsrv.submit(jp, {f: jnp.asarray(a) for f, a in fields.items()})
            tsrv.submit(tp, fields)
        jdone.update({r.rid: r for r in jsrv.run_until_idle()})
        tdone.update({r.rid: r for r in tsrv.run_until_idle()})
    assert tgroups == jgroups and len(tgroups) > 2
    assert tsrv.cache.stats() == jsrv.cache.stats()
    assert tsrv.cache.stats()["evictions"] > 0
    assert tsrv.cache.total_traces() == jsrv.cache.total_traces()
    assert tsrv.stats == jsrv.stats
    for rid, jr in jdone.items():
        want = ({f: np.asarray(a) for f, a in jr.result.items()}
                if isinstance(jr.result, dict) else np.asarray(jr.result))
        got = to_numpy(tdone[rid].result)
        if isinstance(want, dict):
            for f in want:
                np.testing.assert_allclose(got[f], want[f], rtol=TOL, atol=TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- hypothesis: the LRU properties (stub builder) ------------------------------------


def _program(weight: float, name: str = "p"):
    """A tiny 2-D program whose fingerprint varies with ``weight`` (a tap
    weight is structural) but NOT with ``name`` (display names are blind)."""
    return StencilProgram(name, ["x"], [affine("out", "x", {(0, 0): weight, (1, 0): 1.0})])


PROGRAMS = [_program(float(w)) for w in (1.0, 2.0, 3.0)]
GRIDS = [(2, 16, 16), (2, 24, 24)]
BACKENDS = ["reference", "cuda"]
BATCHES = [None, 4]

requests = st.lists(
    st.tuples(
        st.integers(0, len(PROGRAMS) - 1),
        st.integers(0, len(GRIDS) - 1),
        st.integers(0, len(BACKENDS) - 1),
        st.integers(0, len(BATCHES) - 1),
    ),
    min_size=1,
    max_size=60,
)


def _stub_builder(program, key, **kw):
    return lambda x: x


def _replay(seq, capacity):
    """Drive a CompileCache and an independent Python LRU model side by
    side; returns (cache, hits, misses, evictions, keys in LRU order)."""
    cache = CompileCache(capacity, builder=_stub_builder, trace_probe=False)
    model: list = []
    hits = misses = evictions = 0
    for pi, gi, bi, ni in seq:
        key = compile_key(PROGRAMS[pi], grid=GRIDS[gi], backend=BACKENDS[bi],
                          batch=BATCHES[ni])
        cache.get(PROGRAMS[pi], grid=GRIDS[gi], backend=BACKENDS[bi], batch=BATCHES[ni])
        if key in model:
            hits += 1
            model.remove(key)
            model.append(key)
        else:
            misses += 1
            model.append(key)
            if len(model) > capacity:
                model.pop(0)
                evictions += 1
    return cache, hits, misses, evictions, model


@given(seq=requests, capacity=st.integers(1, 6))
@settings(max_examples=200, deadline=None)
def test_lru_accounting_matches_model(seq, capacity):
    cache, hits, misses, evictions, model = _replay(seq, capacity)
    assert cache.stats() == {
        "hits": hits, "misses": misses, "evictions": evictions,
        "size": len(model), "capacity": capacity,
    }
    assert cache.keys() == model
    assert len(cache) <= capacity
    total = hits + misses
    assert cache.hit_rate == (hits / total if total else 0.0)


@given(seq=requests)
@settings(max_examples=100, deadline=None)
def test_distinct_fingerprints_never_collide(seq):
    cache, hits, misses, evictions, model = _replay(seq, capacity=64)
    distinct = {
        compile_key(PROGRAMS[pi], grid=GRIDS[gi], backend=BACKENDS[bi], batch=BATCHES[ni])
        for pi, gi, bi, ni in seq
    }
    assert evictions == 0
    assert misses == len(distinct)
    assert hits == len(seq) - len(distinct)
    assert set(cache.keys()) == distinct


@given(w=st.sampled_from([0.5, 1.0, 2.0]))
@settings(max_examples=10, deadline=None)
def test_equal_programs_different_names_share_entry(w):
    cache = CompileCache(4, builder=_stub_builder, trace_probe=False)
    cache.get(_program(w, name="tenant_a_diffusion"), grid=(2, 16, 16))
    cache.get(_program(w, name="tenant_b_diffusion"), grid=(2, 16, 16))
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    assert len(cache) == 1


@given(seq=requests)
@settings(max_examples=100, deadline=None)
def test_hits_never_invoke_builder(seq):
    calls = []

    def counting_builder(program, key, **kw):
        calls.append(key)
        return lambda x: x

    cache = CompileCache(64, builder=counting_builder, trace_probe=False)
    for pi, gi, bi, ni in seq:
        cache.get(PROGRAMS[pi], grid=GRIDS[gi], backend=BACKENDS[bi], batch=BATCHES[ni])
    assert len(calls) == cache.stats()["misses"]
    assert len(set(calls)) == len(calls)


@given(seq=requests, capacity=st.integers(1, 6))
@settings(max_examples=100, deadline=None)
def test_counter_trio_matches_registry(seq, capacity):
    with metrics.using() as reg:
        cache, hits, misses, evictions, _model = _replay(seq, capacity)
        snap = reg.snapshot()["counters"]
    assert snap.get("cache.hits", 0) == hits
    assert snap["cache.misses"] == misses
    assert snap.get("cache.evictions", 0) == evictions
    assert (cache.hits, cache.misses, cache.evictions) == (hits, misses, evictions)


def test_capacity_validation():
    with pytest.raises(ValueError, match="capacity"):
        CompileCache(0)


def test_cache_entry_records_probe_counts():
    entry = CacheEntry(key=compile_key(tir.hdiff_program(), grid=(1, 8, 8)), fn=None,
                       program_name="hdiff")
    assert (entry.traces, entry.hits, entry.kernels_built, entry.nvcc_builds) == (0, 0, 0, 0)
