#!/usr/bin/env python3
"""Host time per step of the port's stencil paths on one NVIDIA GPU, for a
source tree given on the command line.

    python3 scripts/path_bench.py [--src DIR] [--label NAME] [--repeats N]

Runs each leg of ``chip_smoke.py``'s hdiff and elementary paths ``N`` times
(default 10) in turn, after one warm-up pass, on the paper's 64x256x256
float32 domain, each timed by the wall clock between two
``torch.cuda.synchronize()`` calls: 100 ``run_simulation`` steps with
``hdiff_fused`` (K1), 50 ``hdiff_twostep`` calls (K2, two steps each), 100
int32 steps with ``hdiff_fixed`` (K3), 10 ``stencil2d(x, "jacobi2d_9pt")``
sweeps (K4) and 10 sweeps of ``lower_cuda(jacobi2d_9pt)`` with no metrics
registry (K2); on fig11's (16384, 256) rows, 10 ``jacobi1d`` sweeps (K5)
and, with no registry, 10 sweeps of ``lower_cuda(jacobi1d)`` and 5 calls of
``lower_cuda(repeat(jacobi1d, 2))`` (K5'); and, where the tree has
``repro_torch.train``, the assimilation trainer: 5 steps of
``fit_coefficient_field`` on ``hdiff_coupled`` at k = 1 and at k = 2 (K2
forward, augmented forward and adjoint a sweep, AdamW), whose device time
per step (the kernels' busy time in one ``torch.profiler`` window of the
leg after the samples) is printed beside the host time; and, where the
tree has ``repro_torch.serve.ForecastServer``, the forecast path: 8
forecasts of ``repeat(hdiff, 2)`` served through
``ForecastServer(backend="cuda")`` at max_batch 1 and 8, on the paper grid
and on fig14's (1, 64, 64) nowcast tile, each result released after its
drain (µs per forecast). Prints one JSON line per leg: the median and
quartiles of µs per step, sweep or forecast and every sample, with the
card's name and power limit. ``--src`` names the ``src/`` directory whose ``repro_torch`` is
imported (default: this checkout's), so two trees can be timed in turns
on one card; one chip_smoke window gives one sample per leg, and host
times on a shared machine spread by more than the kernels' own.

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("path_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    import repro_torch.ir as ir
    from repro_torch.core import make_initial_field, run_simulation
    from repro_torch.kernels.hdiff import hdiff_fixed, hdiff_fused, hdiff_twostep
    from repro_torch.kernels.stencil2d import jacobi1d, stencil2d

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    coeff = 0.025
    psi = make_initial_field(64, 256, 256, kind="gaussian")
    psi_q = (psi * 2**16).to(torch.int32)
    x = torch.randn((64, 256, 256), generator=torch.Generator(device="cuda").manual_seed(2024),
                    device="cuda")
    jac9 = ir.lower_cuda(ir.jacobi2d_9pt_program())
    rows = x.view(64 * 256, 256)
    jac1 = ir.lower_cuda(ir.jacobi1d_program())
    jac1x2 = ir.lower_cuda(ir.repeat(ir.jacobi1d_program(), 2))

    def chain(fn, start, n):
        def run():
            y = start
            for _ in range(n):
                y = fn(y)
            return y
        return run

    legs = {  # label: (callable, steps or sweeps it runs)
        "run_simulation_100_k1": (lambda: run_simulation(psi, coeff, step_fn=hdiff_fused,
                                                         n_steps=100, collect_every=10), 100),
        "twostep_50_k2": (chain(lambda a: hdiff_twostep(a, coeff), psi, 50), 100),
        "fixed_100_k3": (lambda: run_simulation(psi_q, None, step_fn=lambda p, _: hdiff_fixed(p),
                                                n_steps=100), 100),
        "stencil2d_jacobi2d_9pt_10_k4": (chain(lambda a: stencil2d(a, "jacobi2d_9pt"), x, 10), 10),
        "lower_cuda_jacobi2d_9pt_10_k2": (chain(jac9, x, 10), 10),
        "jacobi1d_10_k5": (chain(jacobi1d, rows, 10), 10),
        "lower_cuda_jacobi1d_10_k5p": (chain(jac1, rows, 10), 10),
        "lower_cuda_jacobi1d_x2_5_k5p": (chain(jac1x2, rows, 5), 10),
    }
    fits = {}
    if hasattr(ir, "build_backend"):
        from repro_torch.train import (AssimilationConfig, fit_coefficient_field,
                                       synthetic_observations, true_coefficients)

        coeff_true = true_coefficients((64, 256, 256), seed=1)
        for k in (1, 2):
            cfg = AssimilationConfig(steps=5, k=k)
            obs = synthetic_observations(x, coeff_true, cfg).detach()
            fits[f"assimilate_k{k}_5"] = (
                lambda cfg=cfg, obs=obs: fit_coefficient_field(x, obs, cfg), 5)
        legs.update(fits)
    try:
        from repro_torch.serve import ForecastServer
    except ImportError:  # a tree from before the forecast path
        ForecastServer = None
    if ForecastServer is not None:
        fprog = ir.repeat(ir.hdiff_program(), 2)
        gen = torch.Generator(device="cuda").manual_seed(7)
        for grid, shape in (("paper", (64, 256, 256)), ("nowcast", (1, 64, 64))):
            members = [torch.randn(shape, generator=gen, device="cuda") for _ in range(8)]
            for n in (1, 8):
                def drain(srv=ForecastServer(backend="cuda", max_batch=n), members=members):
                    for m in members:
                        srv.submit(fprog, m)
                    srv.run_until_idle()
                    srv.completed.clear()
                legs[f"forecast_{grid}_8_b{n}"] = (drain, 8)
    samples: dict[str, list[float]] = {name: [] for name in legs}
    for fn, _ in legs.values():  # warm-up: builds, loads and first-use costs
        fn()
    for _ in range(args.repeats):
        for name, (fn, steps) in legs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) / steps * 1e6)
    device_us = {}
    for name, (fn, steps) in fits.items():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        device_us[name] = sum(e.self_device_time_total for e in prof.key_averages()
                              if e.device_type == torch.autograd.DeviceType.CUDA) / steps
    for name, us in samples.items():
        q = statistics.quantiles(us, n=4) if len(us) > 1 else [us[0]] * 3
        extra = {"device_us_per_step": device_us[name]} if name in device_us else {}
        print(json.dumps({"label": args.label, "src": args.src, "nvidia_smi": smi, "leg": name,
                          "us_per_step_median": statistics.median(us), "q1": q[0], "q3": q[2],
                          **extra, "samples": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
