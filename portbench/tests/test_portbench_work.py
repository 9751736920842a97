"""The kernels' compulsory work against hand sums, and the readers that turn
it into roofline shares."""

import types

import pytest

from portbench.harness import HERE, load_module
from portbench.work import k1, k2

PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}


def test_k1_counts_cosmo1_by_hand():
    nbytes, flops = k1.per_call(80, 774, 1158)
    assert nbytes == 2 * 4 * 80 * 774 * 1158 == 573_626_880
    assert flops == 22 * 80 * 770 * 1154
    assert k1.least_s(nbytes, flops, PEAKS) == pytest.approx(573_626_880 / 3.35e12)


def test_k2_counts_two_sweeps_and_a_member_of_cosmo_e():
    nbytes, flops = k2.per_call(60, 390, 582, 2)
    assert nbytes == 8 * 13_618_800
    assert flops == 2 * 22 * 60 * 386 * 578
    # 21 members: 2.288 GB a cycle, 0.683 ms at 3.35 TB/s.
    assert 21 * k2.least_s(nbytes, flops, PEAKS) == pytest.approx(21 * 8 * 13_618_800 / 3.35e12)


def test_flops_bound_a_call_whose_bytes_are_few():
    assert k1.least_s(1, 6.7e13, PEAKS) == pytest.approx(1.0)


def summary(kernels, counts, cfg, mix, device="NVIDIA H100 80GB HBM3", busy=0.0, window=1.0,
            layer=None):
    peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}
    return types.SimpleNamespace(
        kernels={k: {"calls": 1, "s": s} for k, s in kernels.items()}, counts=counts, cfg=cfg,
        mix=mix, peaks=peaks if "H100" in device else None, busy_s=busy, window_s=window,
        layer=layer or {},
        device_s=lambda match: sum(s for k, s in kernels.items() if match(k)))


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"test_metric_{name.replace('.', '_')}")


COSMO1 = {"fields": {"u": 80, "v": 80, "w": 81, "T": 80, "pp": 80}, "rows": 774, "cols": 1158}
COSMO_E = {"fields": {"u": 60, "v": 60, "w": 61, "T": 60, "pp": 60}, "rows": 390, "cols": 582}


def test_k1_roofline_reads_least_time_over_device_time():
    least = 8 * 401 * 774 * 1158 / 3.35e12  # the five fields: 2.875 GB a step
    t = summary({"void (anonymous namespace)::hdiff_kernel<float, 64, true>(float*)": 0.5},
                {"calls": 1000, "units": 20}, COSMO1, {"sweeps_per_call": 1})
    assert reader("k1_roofline").read(t) == pytest.approx(100 * 1000 * least / 0.5)


@pytest.mark.parametrize("name", ["k2_roofline", "k2b_roofline"])
def test_k2_roofline_counts_a_forecast_a_call(name):
    t = summary({"(anonymous namespace)::stencil_program(float const*)": 0.12,
                 "CatArrayBatchedCopy": 0.008}, {"calls": 210, "units": 10}, COSMO_E,
                {"sweeps_per_call": 2})
    want = 100 * 210 * 8 * 301 * 390 * 582 / 3.35e12 / 0.12
    assert reader(name).read(t) == pytest.approx(want)
    assert reader("forecast_copy_ms").read(t) == pytest.approx(0.8)
    assert reader("forecast_probe_ms").read(t) is None


def test_probes_are_the_rest_of_a_cycle_and_need_k2_by_name():
    t = summary({"stencil_program": 0.12, "CatArrayBatchedCopy": 0.008,
                 "reduce_kernel": 0.5, "Memset (Device)": 0.02}, {"calls": 210, "units": 10},
                COSMO_E, {"sweeps_per_call": 2})
    assert reader("forecast_probe_ms").read(t) == pytest.approx(52.0)
    renamed = summary({"stencil_v2": 0.12, "reduce_kernel": 0.5}, {"calls": 210, "units": 10},
                      COSMO_E, {"sweeps_per_call": 2}, busy=0.62)
    with pytest.raises(RuntimeError, match="stencil_program"):
        reader("forecast_probe_ms").read(renamed)


@pytest.mark.parametrize("name", ["device_idle_pct.sweep", "device_idle_pct.ensemble"])
def test_idle_share_and_nothing_to_read(name):
    assert reader(name).read(summary({}, {}, COSMO1, {}, busy=0.75, window=1.0)) == 25.0
    assert reader(name).read(summary({}, {}, COSMO1, {}, busy=0.0)) is None


@pytest.mark.parametrize("name", ["k1_roofline", "k2_roofline", "k2b_roofline"])
def test_a_roofline_without_its_kernel_or_its_card_reads_nothing(name):
    mix = {"sweeps_per_call": 1}
    assert reader(name).read(summary({}, {"calls": 5}, COSMO1, mix)) is None
    t = summary({"hdiff_kernel stencil_program": 1.0}, {"calls": 5}, COSMO1, mix, device="cpu")
    assert reader(name).read(t) is None


def test_queue_mean():
    t = summary({}, {}, COSMO1, {}, layer={"queue_s": [0.001, 0.003]})
    assert reader("forecast_queue_ms").read(t) == pytest.approx(2.0)
    assert reader("forecast_queue_ms").read(summary({}, {}, COSMO1, {})) is None
