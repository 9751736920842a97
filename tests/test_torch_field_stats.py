"""The health probe's statistics: the ``field_stats`` kernel and its plain version.

On the CPU (part of the tier-1 run): the plain version's accumulators give
exactly ``field_stats``'s dict, against an independent float64 reduction of
the float32-rounded values, and the monitor's one-read probe returns the same
host dict as ``host_stats(field_stats(x))``. On the card (the ``gpu`` marker;
skipped without one): the kernel against its plain version on the same
tensor for six element types, ragged sizes, an unaligned view and a strided
one, NaN and Inf, and a served COSMO-E member; bit-equal repeats; one launch
a probe; a NaN-poisoned member failing alone in a cuda-backed
``ForecastServer``. Run the card's part with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_field_stats.py

Tolerances: counts, min, max and size exact (both routes round each element
to float32 and keep the extremes); mean and L2 within 1e-6 relative (the
sums are float64 in another order).
"""

import math
import re

import numpy as np
import pytest
import torch

import repro_torch.ir as ir
from repro_torch.kernels import _build
from repro_torch.kernels.stats import kernel as ks
from repro_torch.obs.health import (
    STAT_KEYS,
    HealthMonitor,
    NumericsError,
    field_stats,
    host_stats,
)
from repro_torch.serve.forecast import ForecastServer

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int32, torch.bool]
SIZES = [1, 31, 4097, 2**20 + 7]
RTOL = 1e-6
SERVED_MEMBER = (301, 390, 582)  # a COSMO-E member: 60 levels x five fields, 582 x 390


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the field_stats kernel has no CPU mode")
    return torch.device("cuda")


def _field(n, dtype, seed=0):
    """``n`` values of ``dtype``: offset normals (a well-conditioned mean),
    integers of either sign, or random bits."""
    g = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.from_numpy(g.random(n) < 0.5)
    if not dtype.is_floating_point:
        return torch.from_numpy(g.integers(-1000, 1000, n)).to(dtype)
    return torch.from_numpy(g.standard_normal(n) * 3.0 + 2.0).to(dtype)


def _poison(x):
    """NaN, +Inf and -Inf at a few places of a floating ``x``."""
    x = x.clone()
    flat = x.view(-1)
    for i, v in ((0, math.nan), (len(flat) // 2, math.inf), (len(flat) - 1, -math.inf),
                 (len(flat) // 3, math.nan)):
        flat[i] = v
    return x


def _oracle(x) -> dict[str, float]:
    """The statistics by numpy in float64 over the float32-rounded values
    (NaN and Inf told on the input's own type): the reference of both
    routes."""
    a = x.detach().cpu()
    v = a.to(torch.float32).double().numpy().ravel()
    finite = torch.isfinite(a).numpy().ravel()
    kept = v[finite]
    n = len(kept)
    return {"size": float(a.numel()), "nan_count": float(torch.isnan(a).sum()),
            "inf_count": float(torch.isinf(a).sum()),
            "min": float(kept.min()) if n else math.inf,
            "max": float(kept.max()) if n else -math.inf,
            "mean": math.fsum(kept) / max(n, 1), "l2": math.sqrt(math.fsum(kept * kept))}


def _assert_stats(got: dict[str, float], want: dict[str, float]):
    assert list(got) == list(STAT_KEYS)
    for k in ("size", "nan_count", "inf_count", "min", "max"):
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("mean", "l2"):
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=0.0), k


# -- CPU: the plain route ------------------------------------------------------


# Integers and bool hold no NaN or Inf: only floating types are poisoned.
PLAIN_CASES = [(d, False) for d in DTYPES + [torch.int8, torch.int16, torch.int64, torch.uint8]]
PLAIN_CASES += [(d, True) for d in DTYPES if d.is_floating_point]


@pytest.mark.parametrize(("dtype", "poisoned"), PLAIN_CASES)
def test_plain_accumulators_give_field_stats_dict(dtype, poisoned):
    x = _field(4097, dtype, seed=3)
    x = _poison(x) if poisoned else x
    acc = ks.field_stats_plain(x)
    assert acc.dtype == torch.float64 and acc.shape == (len(ks.ACC_KEYS),)
    nan, inf, fin, total, sumsq, lo, hi = acc.tolist()
    stats = field_stats(x)
    for k in ("size", "nan_count", "inf_count"):
        assert stats[k].dtype == torch.int32 and stats[k].ndim == 0
    for k in ("min", "max", "mean", "l2"):
        assert stats[k].dtype == torch.float32 and stats[k].ndim == 0
    assert host_stats(stats) == {
        "size": float(x.numel()), "nan_count": nan, "inf_count": inf, "min": lo, "max": hi,
        "mean": float(np.float32(total / max(fin, 1.0))), "l2": float(np.float32(math.sqrt(sumsq)))}
    assert nan + inf + fin == x.numel()
    _assert_stats(host_stats(stats), _oracle(x))


@pytest.mark.parametrize("case", ["clean", "poisoned", "all_nan", "all_inf", "float64_beyond_f32",
                                  "l2_beyond_f32", "empty", "scalar", "python_float"])
def test_monitor_one_read_equals_host_stats_of_field_stats(case):
    x = {
        "clean": lambda: _field(1000, torch.float32, seed=5).view(10, 100),
        "poisoned": lambda: _poison(_field(1000, torch.float32, seed=6)),
        "all_nan": lambda: torch.full((7,), math.nan),
        "all_inf": lambda: torch.tensor([math.inf, -math.inf, math.inf]),
        "float64_beyond_f32": lambda: torch.tensor([1e300, 2.0, -1e300], dtype=torch.float64),
        "l2_beyond_f32": lambda: torch.full((4,), 3e38),
        "empty": lambda: torch.zeros((0, 4)),
        "scalar": lambda: torch.tensor(3.5),
        "python_float": lambda: 0.125,
    }[case]()
    m = HealthMonitor(cadence=1, policy="warn", log_fn=lambda _: None)
    got = m.check(0, x)
    np.testing.assert_equal(got, host_stats(field_stats(x)))  # NaN equal to NaN
    assert list(got) == list(STAT_KEYS)
    assert m.probes == 1 and m.reads == len(STAT_KEYS) == 7


def test_field_stats_refuses_other_dtypes_on_every_route():
    with pytest.raises(TypeError, match="complex64"):
        field_stats(torch.zeros(3, dtype=torch.complex64))
    with pytest.raises(TypeError, match="complex64"):
        ks.field_stats_cuda(torch.zeros(3, dtype=torch.complex64))
    with pytest.raises(ValueError, match="meta"):
        ks.field_stats_cuda(torch.zeros(3, device="meta"))


def test_launch_grid_and_the_constants_the_source_shares():
    text = ks.SOURCE.read_text()
    for name, value in (("kThreads", ks.THREADS), ("kUnroll", ks.UNROLL),
                        ("kVecBytes", ks.VECTOR_BYTES)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == value, name
    assert f"sizeof(Acc) == {8 * ks.PARTIAL_WORDS}" in text
    entries = re.findall(r"^FIELD_STATS_ENTRY\((\w+),", text, flags=re.M)
    assert set(entries) == set(ks._ENTRIES.values())
    assert ks.launch_grid(1, 4, 132) == 1
    assert ks.launch_grid(0, 4, 132) == 1
    assert ks.launch_grid(16384 // 4, 4, 132) == 1  # one block's first round
    assert ks.launch_grid(16384 // 4 + 1, 4, 132) == 2
    assert ks.launch_grid(math.prod(SERVED_MEMBER), 4, 132) == 132 * ks.BLOCKS_PER_SM


# -- on the card ---------------------------------------------------------------


def _views(x):
    """The contiguous field, a view one element in, and a strided view."""
    return {"contiguous": x, "offset": x[1:], "strided": x[::3]}


@pytest.mark.gpu
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_version(cuda, dtype, size):
    base = _field(size + 1, dtype, seed=size).to(cuda)
    for layout, x in _views(base).items():
        if x.numel() == 0:
            continue
        before = _build.LAUNCHES.get("field_stats", 0)
        acc = ks.field_stats_cuda(x)
        assert _build.LAUNCHES["field_stats"] == before + 1, layout
        plain = ks.field_stats_plain(x)
        for i in (0, 1, 2, 5, 6):  # counts, min, max
            assert acc[i].item() == plain[i].item(), (layout, ks.ACC_KEYS[i])
        _assert_stats(host_stats(field_stats(x)), _oracle(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_kernel_counts_nan_and_inf(cuda, dtype):
    mixed = _poison(_field(4097, dtype, seed=11)).to(cuda)
    for x in (*_views(mixed).values(), torch.full((4097,), math.nan, dtype=dtype, device=cuda)):
        _assert_stats(host_stats(field_stats(x)), _oracle(x))
    s = host_stats(field_stats(torch.full((33,), math.nan, dtype=dtype, device=cuda)))
    assert s["nan_count"] == 33 and s["min"] == math.inf and s["max"] == -math.inf
    assert s["mean"] == 0.0 and s["l2"] == 0.0


@pytest.mark.gpu
def test_served_member_of_a_batch(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = torch.randn((21, *SERVED_MEMBER), generator=g, device=cuda).mul_(3.0).add_(2.0)
    member = batch[7]
    assert member.is_contiguous()
    member.view(-1)[12345] = math.nan
    acc = ks.field_stats_cuda(member)
    again = ks.field_stats_cuda(member)
    assert torch.equal(acc, again)  # the same bits, launch after launch
    _assert_stats(host_stats(field_stats(member)), _oracle(member))
    del batch, member


@pytest.mark.gpu
def test_every_launch_leaves_its_streams_ticket_at_zero(cuda):
    x, y = _field(2**20 + 7, torch.float32).to(cuda), _field(31, torch.float16, seed=2).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # another grid, another stream, another ticket
        got = [ks.field_stats_cuda(v) for v in (x, y, x)]
    torch.cuda.current_stream().wait_stream(side)
    want = [ks.field_stats_cuda(v) for v in (y, x)]
    assert torch.equal(got[0], got[2]) and torch.equal(got[0], want[1])
    assert torch.equal(got[1], want[0])
    for stream in (side, torch.cuda.current_stream()):
        ticket = ks._scratch(cuda.index or 0, stream.cuda_stream)[:1].view(torch.int32)
        assert ticket.tolist() == [0, 0]


@pytest.mark.gpu
def test_one_launch_a_probe(cuda):
    m = HealthMonitor(cadence=1, policy="warn", log_fn=lambda _: None)
    x = _field(2**20 + 7, torch.float32).to(cuda)
    before = _build.LAUNCHES.get("field_stats", 0)
    for step in range(3):
        m.check(step, x)
    assert _build.LAUNCHES["field_stats"] == before + 3
    assert m.reads == 7 * m.probes == 21


@pytest.mark.gpu
def test_poisoned_member_fails_alone_in_a_cuda_server(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    members = [torch.randn((2, 16, 16), generator=g, device=cuda) for _ in range(4)]
    members[2][1, 5, 5] = math.nan
    srv = ForecastServer(backend="cuda", max_batch=4, device=cuda,
                         monitor=HealthMonitor(policy="abort"))
    before = _build.LAUNCHES.get("field_stats", 0)
    rids = [srv.submit(ir.hdiff_program(), m) for m in members]
    done = {r.rid: r for r in srv.run_until_idle()}
    assert srv.stats["completed"] == 3 and srv.stats["failed"] == 1
    assert [done[r].failed for r in rids] == [False, False, True, False]
    assert isinstance(done[rids[2]].error, NumericsError)
    assert srv.monitor.probes == 4 and srv.monitor.reads == 7 * srv.monitor.probes
    assert _build.LAUNCHES["field_stats"] == before + 4
