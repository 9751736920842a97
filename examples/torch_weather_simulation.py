"""End-to-end coupled-system weather driver on the PyTorch port: shallow-water via the IR.

  PYTHONPATH=src python examples/torch_weather_simulation.py [--steps 50] [--devices 8]
  PYTHONPATH=src python examples/torch_weather_simulation.py --device cpu --devices 2 \
      --depth 4 --size 24

The port of ``examples/weather_simulation.py``, with the same flags,
defaults and printed lines. The linearized shallow-water system evolves
three fields per sweep,

    u <- u - g*dt * dh/dx
    v <- v - g*dt * dh/dy
    h <- h - H*dt * (du/dx + dv/dy)

declared once as ONE multi-output IR program (``shallow_water_program``).
``plan_partition`` picks the rows x cols split that minimizes the merged
exchange bytes, and ``lower_sharded`` decomposes the system over the mesh:
each shard is one N-output launch of the generated kernel (K2, offset
mode) and one stacked halo exchange a sweep. The gathered state is
verified per field against the port's ``lower_reference`` stepped on one
process (rtol 1e-4, atol 1e-5, the reference's bound).

Where the JAX driver re-execs itself with N fake host devices and works on
global arrays, this one is SPMD: ``--devices N`` spawns N ``torch.
distributed`` gloo ranks, each owning one block. With ``--device cpu`` the
ranks compute on the CPU; on the card (``--device cuda``, the default, which
raises without one) the N ranks time-share it and stage their halo bands
through host memory, so a time printed for N > 1 is not a multi-GPU figure.
``--devices 1`` runs in this process (a one-rank group).

``--inner`` takes ``cuda`` (the default: K2 on CUDA tensors, its plain
version on CPU ones) or ``reference`` (the eager evaluator, the plain
version: on the card it runs only when asked for). The JAX driver's
default, ``reference``, is XLA-compiled code on a TPU; the port's plain
version is not the path to time.

``--health`` arms the numerics watchdog: one ``HealthMonitor`` per output
field probes its field every ``--health-every`` steps. The probe is
mesh-global (the statistics all-reduced over the ranks), so every rank
sees a blow-up in one rank's block and raises at the same step. Under
``checkpoint-then-abort`` the failing field's monitor first gathers the
last healthy probed {u, v, h} and rank 0 COMMITs it to ``--ckpt-dir``;
rank 0 keeps the flight recorder (``--event-log`` / ``REPRO_EVENT_LOG``).
``--inject-nan STEP`` poisons the height field's global point
``(0, size/2, size/2)`` after STEP, in the block of the rank that owns it.
Exit code 3 signals a detected blow-up.

:func:`run` returns rank 0's result (exit code, the gathered final fields,
every rank's kernel launches and ms per step) for callers that drive the
forecast from Python.
"""

import argparse
import os
import sys
import tempfile
import time

BLOWUP_EXIT_CODE = 3
SPAWN_TIMEOUT = 3600  # seconds for all ranks, start-up included
MESH_AXES = ("rows", "cols")
GRID_SPEC = (None, *MESH_AXES)  # a rank's block of the grid: depth whole


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--devices", type=int, default=8,
                    help="gloo ranks, one block each (on the card they time-share it)")
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument(
        "--inner",
        choices=("reference", "cuda"),
        default="cuda",
        help="per-shard compute backend for the IR sharded lowering",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks compute (cuda raises without a card)")
    ap.add_argument("--health", action="store_true",
                    help="probe per-field numerics on a cadence (blow-up-safe loop)")
    ap.add_argument("--health-every", type=int, default=10,
                    help="probe cadence in steps (with --health)")
    ap.add_argument("--health-policy", default="checkpoint-then-abort",
                    choices=("warn", "abort", "checkpoint-then-abort"))
    ap.add_argument("--ckpt-dir", default="weather_ckpt",
                    help="checkpoint root for checkpoint-then-abort")
    ap.add_argument("--event-log", default="",
                    help="flight-recorder JSONL sink (or set REPRO_EVENT_LOG)")
    ap.add_argument("--inject-nan", type=int, default=-1, metavar="STEP",
                    help="poison one height-field point after STEP (blow-up drill)")
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error("--devices must be at least 1")
    return args


def main(argv=None) -> int:
    return run(parse_args(argv))["code"]


def run(args: argparse.Namespace) -> dict:
    """Runs the forecast on ``args.devices`` gloo ranks; returns rank 0's
    result: ``code`` (0, or 3 on a blow-up), ``final`` (``{field: numpy}``
    of the gathered state, clean runs only), ``ms_per_step``, and
    ``launches`` / ``rank_ms_per_step``, one entry a rank."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.spawn import run_ranks

    resolve_device(args.device)  # no quiet fallback to the CPU
    with tempfile.TemporaryDirectory(prefix="torch_weather_") as work:
        if args.devices == 1:
            results = [_rank(0, 1, os.path.join(work, "store"), args)]
        else:
            results = run_ranks(_rank, args.devices, work, args, timeout=SPAWN_TIMEOUT)
    out = dict(results[0])
    out["launches"] = [r["launches"] for r in results]
    out["rank_ms_per_step"] = [r["ms_per_step"] for r in results]
    return out


def _rank(rank: int, world: int, store: str, args) -> dict:
    import torch
    import torch.distributed as dist

    if world > 1 and args.device == "cpu":
        torch.set_num_threads(1)  # N ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        return _forecast(rank, world, args)
    finally:
        dist.destroy_process_group()


def _say(rank: int):
    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw, flush=True)
    return say


def _forecast(rank: int, world: int, args) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import make_initial_field
    from repro_torch.dist.sharding import gather_blocks, shard_param
    from repro_torch.ir import lower_reference, lower_sharded, plan_partition, shallow_water_program
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh

    say = _say(rank)
    dev = torch.device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    shared = (f" (gloo ranks time-sharing one card, {where}: not a multi-GPU figure)"
              if world > 1 and dev.type == "cuda" else
              f" (gloo ranks on the {where})" if world > 1 else "")
    say(f"devices: {world}{shared}")

    program = shallow_water_program()
    spec = program.spec()
    say(
        f"IR program: {program.name} radius={spec.radius} "
        f"outputs={'+'.join(program.outputs)} "
        f"({spec.macs} MACs + {spec.other_ops} ops, {spec.reads} reads/point)"
    )
    plan = plan_partition(program, args.depth, args.size, args.size, world)
    say(
        f"partition plan: rows x{plan.row_shards} cols x{plan.col_shards} "
        f"(merged-exchange halo={plan.halo}, "
        f"{plan.wire_bytes} wire B/round for all {len(program.outputs)} fields)"
    )
    mesh = make_mesh(plan.mesh_shape, MESH_AXES, backend="gloo", device=dev)
    step = lower_sharded(program, mesh, depth_axis=None, row_axis="rows", col_axis="cols",
                         inner=args.inner)

    # Initial state: a gaussian height anomaly at rest (u = v = 0) — the
    # classic gravity-wave adjustment problem. Each rank keeps its block.
    h0 = make_initial_field(args.depth, args.size, args.size, kind="gaussian", device=dev)
    state0 = {"u": torch.zeros_like(h0), "v": torch.zeros_like(h0), "h": h0}
    block0 = {f: shard_param(a, mesh, GRID_SPEC) for f, a in state0.items()}

    if args.health:
        code, ms = run_with_health(rank, mesh, args, program, step, block0)
        return {"code": code, "final": None, "ms_per_step": ms,
                "launches": dict(_build.LAUNCHES)}

    state = block0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = step(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ms = dt / max(args.steps, 1) * 1e3
    say(f"{args.steps} steps in {dt:.2f}s ({ms:.3f} ms/step on {where}"
        f"{', host time of ' + str(world) + ' gloo ranks' if world > 1 else ''})")

    # Verify every output field against the single-process reference.
    final = {f: gather_blocks(state[f], mesh) for f in program.outputs}
    out = {"code": 0, "final": None, "ms_per_step": ms, "launches": dict(_build.LAUNCHES)}
    if rank != 0:
        return out
    ref_step = lower_reference(program)
    ref = state0
    for _ in range(args.steps):
        ref = ref_step(ref)
    final = {f: a.detach().cpu().numpy() for f, a in final.items()}
    for f in program.outputs:
        np.testing.assert_allclose(final[f], ref[f].detach().cpu().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    say("distributed result matches single-device reference ✓ "
        f"({', '.join(program.outputs)})")
    for f in program.outputs:
        a = final[f]
        say(f"  {f} range: [{float(a.min()):.4f}, {float(a.max()):.4f}]")
    out["final"] = final
    return out


def run_with_health(rank, mesh, args, program, step, state0) -> tuple[int, float]:
    """The blow-up-safe forecast loop: cadence-chunked stepping + one
    mesh-global monitor per output field, all sharing one full-state
    checkpoint_fn. Returns ``(exit code, ms per step)``."""
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.dist.sharding import gather_blocks
    from repro_torch.obs import FlightRecorder, HealthMonitor, NumericsError, events

    say = _say(rank)
    if rank == 0:
        if args.event_log:
            events.enable(FlightRecorder(sink=args.event_log))
        # (REPRO_EVENT_LOG in the environment already installed a recorder at
        # import time; without either, probes still guard the run.)
    else:
        events.disable()  # one flight recorder, rank 0's

    checkpoint_fn = None
    if args.health_policy == "checkpoint-then-abort":
        def checkpoint_fn(healthy_step, state):
            # Every rank's monitor trips at the same probe, so every rank
            # joins the gather; rank 0 writes the global {u, v, h}.
            full = {f: gather_blocks(a, mesh) for f, a in state.items()}
            if rank != 0:
                return None
            path = save_checkpoint(
                args.ckpt_dir, healthy_step, full,
                {"step": healthy_step, "fields": list(program.outputs),
                 "reason": "pre-blow-up health snapshot"},
            )
            print(f"committed last-healthy checkpoint: {path}", flush=True)
            return path

    # One watchdog per evolving field: the blow-up names the equation that
    # went bad. Each healthy probe retains the FULL state dict (the step
    # returns new tensors, so no copy is needed), so whichever monitor trips
    # first checkpoints a consistent {u, v, h} snapshot.
    monitors = {
        f: HealthMonitor(
            cadence=args.health_every,
            policy=args.health_policy,
            name=f,
            checkpoint_fn=checkpoint_fn,
            log_fn=say,
            axis_names=MESH_AXES,
            mesh=mesh,
        )
        for f in program.outputs
    }

    def check_all(done, state, *, force=False):
        for f, monitor in monitors.items():
            monitor.check(done, state[f], state=state, force=force)

    # The drill's point, in the block of the rank that owns it.
    r_loc, c_loc = state0["h"].shape[-2:]
    mid = args.size // 2
    owner = (mid // r_loc, mid // c_loc)
    mine = tuple(mesh.coord(a) for a in MESH_AXES) == owner

    cadence = args.health_every
    state = state0
    check_all(0, state)  # step-0 baseline: the initial state is healthy
    events.record("forecast.start", steps=args.steps, cadence=cadence,
                  policy=args.health_policy, fields=list(program.outputs),
                  grid=[args.depth, args.size, args.size])
    t0 = time.perf_counter()
    try:
        done = 0
        while done < args.steps:
            n = min(cadence - done % cadence if done % cadence else cadence,
                    args.steps - done)
            for _ in range(n):
                state = step(state)
            done += n
            if 0 <= args.inject_nan <= done and args.inject_nan > done - n:
                # The drill: one poisoned HEIGHT point mid-forecast, as if
                # the dynamics blew up somewhere inside this chunk.
                if mine:
                    h = state["h"].clone()
                    h[0, mid - owner[0] * r_loc, mid - owner[1] * c_loc] = float("nan")
                    state = {**state, "h": h}
                say(f"injected NaN into h after step {args.inject_nan}")
            # force on the final boundary: when steps is not a multiple of
            # the cadence the last partial chunk is off-cadence, and a NaN
            # born there must not escape as "forecast healthy".
            check_all(done, state, force=(done == args.steps))
    except NumericsError as e:
        dump = events.crash_dump(reason=str(e))
        say(f"BLOWUP_DETECTED step={e.step} field={e.field} "
            f"nan_count={e.stats['nan_count']:.0f} inf_count={e.stats['inf_count']:.0f}")
        if dump is not None:
            say(f"flight recorder crash dump: {dump}")
        return BLOWUP_EXIT_CODE, float("nan")
    if state["h"].is_cuda:
        torch.cuda.synchronize(state["h"].device)
    dt = time.perf_counter() - t0
    events.record("forecast.end", steps=args.steps, wall_s=dt)
    probes = sum(m.probes for m in monitors.values())
    blowups = sum(m.blowups for m in monitors.values())
    say(f"{args.steps} steps in {dt:.2f}s with {probes} health probes "
        f"({args.steps / cadence:.0f} cadences x {len(monitors)} fields, "
        f"policy={args.health_policy})")
    say(f"forecast healthy: probes={probes} blowups={blowups} "
        f"fields={'+'.join(monitors)}")
    return 0, dt / max(args.steps, 1) * 1e3


if __name__ == "__main__":
    sys.exit(main())
