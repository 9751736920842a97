"""Gloo process groups for the port's distributed tests (no JAX in here).

:func:`run_ranks` spawns ``world`` CPU processes, joins them into one gloo
group through a ``FileStore`` under a test's ``tmp_path`` (never a fixed
port), runs ``fn(rank, world, *args)`` in each with one torch thread,
and returns every rank's return value. A worker's exception is re-raised
in the parent with its traceback; a spawn past its ``timeout`` is killed
and fails. The worker bodies live in this module, which imports only
torch and the port, so the children never load JAX.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import multiprocessing as mp

PROGRAM_NAMES = (
    "hdiff", "hdiff_simple", "jacobi2d_3pt", "laplacian", "jacobi2d_5pt", "jacobi2d_9pt",
    "seidel2d", "vadvc", "hdiff_coupled", "shallow_water", "advection_diffusion",
)


def program(name: str):
    """The port's program for a ``tests/conformance.py`` PROGRAMS name."""
    from repro_torch import ir

    if name == "hdiff_simple":
        return ir.hdiff_program(limit=False)
    return getattr(ir, f"{name}_program")()


def _entry(fn, rank, world, store, out, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        result = fn(rank, world, *args)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("ok", result), f)
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - carried to the parent
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        os._exit(1)


class Ranks:
    """A spawn in flight; :meth:`join` waits for it (see :func:`run_ranks`)."""

    def __init__(self, fn, world: int, tmp_dir, args, timeout: float):
        ctx = mp.get_context("spawn")
        self.store = os.path.join(str(tmp_dir), f"store.{os.getpid()}.{time.monotonic_ns()}")
        self.world, self.timeout = world, timeout
        self.procs = [ctx.Process(target=_entry, args=(fn, r, world, self.store,
                                                       self.store + ".out", args), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        return _join(self.procs, self.world, self.store + ".out", self.deadline, self.timeout)


def start_ranks(fn, world: int, tmp_dir, *args, timeout: float = 240.0) -> Ranks:
    """Starts ``fn(rank, world, *args)`` on ``world`` gloo ranks and returns
    at once, so the parent can work while they run."""
    return Ranks(fn, world, tmp_dir, args, timeout)


def run_ranks(fn, world: int, tmp_dir, *args, timeout: float = 240.0) -> list:
    """Runs ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns the
    per-rank results in rank order."""
    return start_ranks(fn, world, tmp_dir, *args, timeout=timeout).join()


def _join(procs, world, out, deadline, timeout) -> list:
    # Poll, so that one failed rank ends the spawn instead of leaving its
    # peers blocked in a collective until the deadline.
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    failed = any(p.exitcode not in (None, 0) for p in procs)
    hung = [] if failed else [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r in range(world):
        try:
            with open(f"{out}.{r}", "rb") as f:
                status, value = pickle.load(f)
        except FileNotFoundError:
            if failed:
                continue  # stopped because a peer failed
            status, value = "error", f"rank {r} wrote no result (exit {procs[r].exitcode})"
        if status != "ok":
            errors.append(f"--- rank {r} ---\n{value}")
        results.append(value)
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s\n" + "\n".join(errors))
    if errors:
        raise RuntimeError("worker failed:\n" + "\n".join(errors))
    return results


# -- worker bodies ---------------------------------------------------------------

SPEC = (None, "rows", "cols")
# The CPU matrix's meshes: (shape, axes), rows x cols and a depth x rows x cols.
MESHES = {
    "8x1": ((8, 1), ("rows", "cols")),
    "2x4": ((2, 4), ("rows", "cols")),
    "1x8": ((1, 8), ("rows", "cols")),
    "2x2x2": ((2, 2, 2), ("data", "rows", "cols")),
}
GRAD_CUDA = ("hdiff", "shallow_water", "hdiff_coupled")


def _tensors(x):
    import torch

    if isinstance(x, dict):
        return {f: torch.from_numpy(a.copy()) for f, a in x.items()}
    return torch.from_numpy(x.copy())


def _numpy(y):
    if isinstance(y, dict):
        return {f: a.detach().numpy() for f, a in y.items()}
    return y.detach().numpy()


def _shard(x, mesh, spec):
    from repro_torch.dist import shard_param

    if isinstance(x, dict):
        return {f: shard_param(a, mesh, spec) for f, a in x.items()}
    return shard_param(x, mesh, spec)


def _gather(y, mesh, spec):
    from repro_torch.dist import gather_blocks

    if isinstance(y, dict):
        return {f: gather_blocks(a, mesh, spec) for f, a in y.items()}
    return gather_blocks(y, mesh, spec)


def _equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(torch.equal(a[f], b[f]) for f in a)
    return torch.equal(a, b)


def _mesh_sent(c, mesh) -> int:
    import torch
    import torch.distributed as dist

    t = torch.tensor([c.sent_bytes], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t)


def _families(c) -> int:
    import torch.distributed as dist

    tags = [None] * dist.get_world_size()
    dist.all_gather_object(tags, sorted(c.tags))
    return len(set().union(*map(set, tags)))


def lower_sharded_suite(rank, world, inputs, weights, psi):
    """Every ``lower_sharded`` cell of the CPU matrix on 8 gloo ranks; rank 0
    returns the gathered results (numpy) and the checks' verdicts."""
    import torch

    from repro_torch import ir
    from repro_torch.dist import count_wire, gradient_halo_exchange_bytes, make_sharded_hdiff
    from repro_torch.dist import program_halo_exchange_bytes
    from repro_torch.launch.mesh import make_mesh

    out = {"fwd": {}, "overlap_equal": {}, "wire": {}, "grad": {}, "grad_wire": {},
           "merged": {}, "zero_equal": {}, "raises": {}}
    meshes = {m: make_mesh(shape, axes, backend="gloo", device="cpu")
              for m, (shape, axes) in MESHES.items()}
    depth, rows, cols = inputs["hdiff"].shape
    for m, mesh in meshes.items():
        d_ax = "data" if "data" in mesh.axis_names else None
        spec = (d_ax, "rows", "cols")
        n_row, n_col = mesh.axis_size("rows"), mesh.axis_size("cols")
        for name in PROGRAM_NAMES:
            x = _tensors(inputs[name])
            xl = _shard(x, mesh, spec)
            for k in (1, 2, 3):
                p = ir.repeat(program(name), k)
                for inner in ("reference", "cuda"):
                    fn = ir.lower_sharded(p, mesh, depth_axis=d_ax, row_axis="rows",
                                          col_axis="cols", inner=inner)
                    with count_wire() as c:
                        y = fn(xl)
                    sent = _mesh_sent(c, mesh)
                    fo = ir.lower_sharded(p, mesh, depth_axis=d_ax, row_axis="rows",
                                          col_axis="cols", inner=inner, overlap=True)
                    same = torch.tensor([int(_equal(fo(xl), y))])
                    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
                    g = _gather(y, mesh, spec)
                    if rank == 0:
                        out["fwd"][(m, name, k, inner)] = _numpy(g)
                        out["overlap_equal"][(m, name, k, inner)] = bool(same)
                        out["wire"][(m, name, k, inner)] = (
                            sent, program_halo_exchange_bytes(p, depth, rows, cols, n_row,
                                                              col_shards=n_col))
    mesh = meshes["2x4"]
    # Merged against sequential exchanges: results, bytes and message families.
    for name in ("vadvc", "hdiff_coupled", "shallow_water", "advection_diffusion"):
        xl = _shard(_tensors(inputs[name]), mesh, SPEC)
        for k in (1, 2, 3):
            p = ir.repeat(program(name), k)
            got = {}
            for merged in (True, False):
                fn = ir.lower_sharded(p, mesh, depth_axis=None, row_axis="rows",
                                      col_axis="cols", inner="cuda", merge_exchange=merged)
                with count_wire() as c:
                    y = fn(xl)
                got[merged] = (y, _mesh_sent(c, mesh), _families(c))
            same = torch.tensor([int(_equal(got[True][0], got[False][0]))])
            torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
            if rank == 0:
                out["merged"][(name, k)] = {"equal": bool(same),
                                            "bytes": (got[True][1], got[False][1]),
                                            "families": (got[True][2], got[False][2])}
    # boundary="zero" against the padded single-device evaluation.
    for name in PROGRAM_NAMES:
        p = program(name)
        x = _tensors(inputs[name])
        xl = _shard(x, mesh, SPEC)
        h = p.radius
        for inner in ("reference", "cuda"):
            fn = ir.lower_sharded(p, mesh, depth_axis=None, row_axis="rows", col_axis="cols",
                                  inner=inner, boundary="zero")
            y = _gather(fn(xl), mesh, SPEC)
            single = ir.lower_cuda(p) if inner == "cuda" else ir.lower_reference(p)
            pad = (lambda a: torch.nn.functional.pad(a, (h, h, h, h)))
            xp = {f: pad(a) for f, a in x.items()} if isinstance(x, dict) else pad(x)
            want = single(xp)
            crop = (lambda a: a[..., h:-h, h:-h]) if h else (lambda a: a)
            want = {f: crop(a) for f, a in want.items()} if isinstance(want, dict) else crop(want)
            out["zero_equal"][(name, inner)] = _equal(y, want)
    # Gradients: sharded-reference for the roster at k = 1-3, sharded-cuda for
    # three programs at k = 1-2; bytes of each value-and-grad step.
    for name in PROGRAM_NAMES:
        x = _tensors(inputs[name])
        for k in (1, 2, 3):
            p = ir.repeat(program(name), k)
            w = _tensors(weights[(name, k)])
            wl = _shard(w, mesh, SPEC)
            for backend in ("sharded-reference", "sharded-cuda"):
                if backend == "sharded-cuda" and (name not in GRAD_CUDA or k == 3):
                    continue
                fn = ir.build_backend(p, backend, mesh=mesh, differentiable=True)
                xl = _shard(x, mesh, SPEC)
                leaves = xl if isinstance(xl, dict) else {"": xl}
                for a in leaves.values():
                    a.requires_grad_(True)
                with count_wire() as c:
                    y = fn(xl)
                    if isinstance(y, dict):
                        loss = sum((wl[f] * y[f]).sum() for f in y)
                    else:
                        loss = (wl * y).sum()
                    loss.backward()
                sent = _mesh_sent(c, mesh)
                grads = {f: a.grad for f, a in leaves.items()}
                g = _gather(grads if isinstance(xl, dict) else grads[""], mesh, SPEC)
                if rank == 0:
                    out["grad"][(backend, name, k)] = _numpy(g)
                    out["grad_wire"][(backend, name, k)] = (
                        sent, gradient_halo_exchange_bytes(p, depth, rows, cols,
                                                           mesh_shape=(2, 4)))
    # Corner routing on a mesh that declares cols before rows.
    cf = make_mesh((4, 2), ("cols", "rows"), backend="gloo", device="cpu")
    x = _tensors(inputs["hdiff"])
    for k in (1, 3):
        p = ir.repeat(program("hdiff"), k)
        for inner in ("reference", "cuda"):
            fn = ir.lower_sharded(p, cf, depth_axis=None, row_axis="rows", col_axis="cols",
                                  inner=inner)
            g = _gather(fn(_shard(x, cf, SPEC)), cf, SPEC)
            if rank == 0:
                out["fwd"][("cols-first 4x2", "hdiff", k, inner)] = _numpy(g)
    # Fine meshes raise, naming the remedy: 48 rows / 8 shards = 6 >= 6 works
    # for hdiff x 3 on 8x1, so cut the grid to 40 rows (5 per shard).
    thin = _shard(x[:, :40, :], meshes["8x1"], SPEC)
    for label, p, mesh_ in (("rows", ir.repeat(program("hdiff"), 3), meshes["8x1"]),):
        fn = ir.lower_sharded(p, mesh_, depth_axis=None, row_axis="rows", col_axis="cols")
        try:
            fn(thin)
            out["raises"][label] = None
        except ValueError as e:
            out["raises"][label] = str(e)
    thin_c = _shard(x[:, :, :40], meshes["1x8"], SPEC)
    fn = ir.lower_sharded(ir.repeat(program("hdiff"), 3), meshes["1x8"], depth_axis=None,
                          row_axis="rows", col_axis="cols")
    try:
        fn(thin_c)
        out["raises"]["cols"] = None
    except ValueError as e:
        out["raises"]["cols"] = str(e)
    # make_sharded_hdiff on data x rows meshes.
    out["sharded_hdiff"] = {}
    for shape in ((8, 1), (2, 4)):
        dm = make_mesh(shape, ("data", "rows"), backend="gloo", device="cpu")
        step = make_sharded_hdiff(dm, depth_axis="data", row_axis="rows")
        spec = ("data", "rows", None)
        y = _gather(step(_shard(torch.from_numpy(psi), dm, spec)), dm, spec)
        if rank == 0:
            out["sharded_hdiff"][shape] = y.numpy()
    return out if rank == 0 else None


def halo_suite(rank, world, x, poisoned, programs):
    """The exchange, its byte counts and the mesh-global stats on a 3 x 3
    rows x cols mesh of 9 gloo ranks (rank 4 has all eight neighbours).
    Every rank returns its own findings."""
    import torch

    from repro_torch import ir
    from repro_torch.dist import (
        count_wire,
        exchange_halos_2d,
        exchange_row_halos,
        gradient_wire_drift_report,
        wire_drift_report,
    )
    from repro_torch.dist.halo import _band_halos
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.health import field_stats, host_stats

    mesh = make_mesh((3, 3), ("rows", "cols"), backend="gloo", device="cpu")
    i, j = mesh.coords
    xt = torch.from_numpy(x)
    d, rows, cols = xt.shape
    r, c = rows // 3, cols // 3
    block = _shard(xt, mesh, SPEC)
    out = {"coords": (i, j), "exchange": {}, "recv": {}, "grad_recv": {}}
    for h in (1, 2, 6):
        full = torch.nn.functional.pad(xt, (h, h, h, h))
        want2 = full[:, i * r : i * r + r + 2 * h, j * c : j * c + c + 2 * h]
        rows_only = full[:, i * r : i * r + r + 2 * h, j * c + h : j * c + c + h]
        lo, hi = _band_halos(block, mesh, "cols", h, dim=-1)
        out["exchange"][h] = (
            torch.equal(exchange_halos_2d(block, mesh, "rows", "cols", h), want2),
            torch.equal(exchange_row_halos(block, mesh, "rows", h), rows_only),
            torch.equal(lo, want2[:, h : h + r, :h]) and torch.equal(hi, want2[:, h : h + r, -h:]),
        )
    try:
        exchange_halos_2d(block[:, :4], mesh, "rows", "cols", 6)
        out["fine"] = None
    except ValueError as e:
        out["fine"] = str(e)
    for name in programs:
        for k in (1, 2, 3):
            p = ir.repeat(program(name), k)
            xs = {f: block for f in p.inputs}
            fn = ir.lower_sharded(p, mesh, depth_axis=None, row_axis="rows", col_axis="cols")
            with count_wire() as cnt:
                fn(xs if len(p.inputs) > 1 else block)
            out["recv"][(name, k)] = cnt.recv_bytes
            g = ir.build_backend(p, "sharded-reference", mesh=mesh, differentiable=True)
            leaves = {f: block.clone().requires_grad_(True) for f in p.inputs}
            with count_wire() as cnt:
                y = g(leaves if len(p.inputs) > 1 else leaves[p.inputs[0]])
                y = y if isinstance(y, dict) else {"": y}
                sum(a.sum() for a in y.values()).backward()
            out["grad_recv"][(name, k)] = cnt.recv_bytes
    p = ir.repeat(program("hdiff"), 2)
    rep = wire_drift_report(p, ir.lower_sharded(p, mesh, depth_axis=None, row_axis="rows",
                                                col_axis="cols"),
                            block, mesh=mesh, depth=d, rows=rows, cols=cols, mesh_shape=(3, 3))
    out["drift"] = (rep.measured, rep.model, rep.ok)
    hc = ir.hdiff_coupled_program()
    grad = ir.build_backend(hc, "sharded-reference", mesh=mesh, differentiable=True)

    def grad_step(x):
        leaves = {f: a.clone().requires_grad_(True) for f, a in x.items()}
        grad(leaves).sum().backward()

    rep = gradient_wire_drift_report(hc, grad_step, {"u": block, "coeff": block.abs()},
                                     mesh=mesh, depth=d, rows=rows, cols=cols,
                                     mesh_shape=(3, 3))
    out["grad_drift"] = (rep.measured, rep.model, rep.ok)
    # mesh_shape= builds the ("rows", "cols") mesh over the group; the
    # instrumented step records the per-chip model and one event a round.
    from repro_torch.obs import FlightRecorder, MetricsRegistry, events, metrics

    reg, rec = MetricsRegistry(), FlightRecorder()
    fn = ir.lower_sharded(p, mesh_shape=(3, 3), inner="reference", device="cpu")
    with metrics.using(reg), events.using(rec):
        y = fn(block)
    out["mesh_shape_equal"] = torch.equal(
        y, ir.lower_sharded(p, mesh, depth_axis=None, row_axis="rows", col_axis="cols",
                            inner="reference")(block))
    out["counters"] = dict(reg.counters)
    out["events"] = [e.kind for e in rec.events()]
    gb = ir.build_backend(p, "sharded-cuda", mesh_shape=(3, 3), device="cpu")
    out["backend_mesh_shape_equal"] = torch.equal(gb(block), y)
    pb = _shard(torch.from_numpy(poisoned), mesh, SPEC)
    out["stats"] = host_stats(field_stats(pb, axis_names=("rows", "cols"), mesh=mesh))
    out["stats_rows"] = host_stats(field_stats(pb, axis_names=("rows",), mesh=mesh))
    try:
        make_mesh((2, 4), ("rows", "cols"), backend="gloo", device="cpu")
        out["bad_mesh"] = None
    except ValueError as e:
        out["bad_mesh"] = str(e)
    return out


BATCHED_NAMES = ("hdiff", "shallow_water", "hdiff_coupled")


def lower_batched_suite(rank, world, inputs, members):
    """Every sharded ``lower_batched`` cell of the CPU matrix on 8 gloo ranks:
    ``BATCHED_NAMES`` x k = 1, 2 x both inners on the 2x4 rows x cols mesh
    (``inputs[name]`` is the global ``(members, D, R, C)`` field or mapping),
    k = 1 also on a 2x2x2 data x rows x cols mesh and through
    ``mesh_shape=(2, 4)``. Rank 0 returns, per cell, the gathered batched
    result (numpy), whether each member equals the unbatched sharded call
    on it, and the bytes sent per round summed over the ranks: batched, and
    one unbatched member's."""
    import torch

    from repro_torch import ir
    from repro_torch.dist import count_wire
    from repro_torch.launch.mesh import make_mesh

    meshes = {m: make_mesh(*MESHES[m], backend="gloo", device="cpu") for m in ("2x4", "2x2x2")}
    out = {"fwd": {}, "members_equal": {}, "wire": {}}
    cells = [("2x4", name, k, inner) for name in BATCHED_NAMES for k in (1, 2)
             for inner in ("reference", "cuda")]
    cells += [(m, name, 1, inner) for m in ("2x2x2", "mesh_shape") for name in BATCHED_NAMES
              for inner in ("reference", "cuda")]
    for m, name, k, inner in cells:
        mesh = meshes["2x4" if m == "mesh_shape" else m]
        spec = ("data", "rows", "cols") if m == "2x2x2" else SPEC
        p = ir.repeat(program(name), k)
        backend = f"sharded-{inner}"
        where = dict(mesh_shape=(2, 4), device="cpu") if m == "mesh_shape" else dict(mesh=mesh)
        fn = ir.lower_batched(p, backend=backend, **where)
        base = ir.build_backend(p, backend, **where)
        xl = _shard(_tensors(inputs[name]), mesh, spec)
        with count_wire() as c:
            y = fn(xl)
        batched_sent = _mesh_sent(c, mesh)
        same, member_sent = True, []
        for i in range(members):
            xi = {f: a[i] for f, a in xl.items()} if isinstance(xl, dict) else xl[i]
            with count_wire() as c:
                yi = base(xi)
            member_sent.append(_mesh_sent(c, mesh))
            got = {f: a[i] for f, a in y.items()} if isinstance(y, dict) else y[i]
            same = same and _equal(got, yi)
        flag = torch.tensor([int(same)])
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
        g = _gather(y, mesh, spec)
        if rank == 0:
            key = (m, name, k, inner)
            out["fwd"][key] = _numpy(g)
            out["members_equal"][key] = bool(flag)
            out["wire"][key] = (batched_sent, member_sent)
    # ForecastServer on a sharded backend: each rank submits its blocks of
    # the members; the served results are the batched lowering's.
    from repro_torch.serve import ForecastServer

    srv = ForecastServer(backend="sharded-cuda", mesh_shape=(2, 4), device="cpu")
    xl = _shard(_tensors(inputs["hdiff"]), meshes["2x4"], SPEC)
    rids = [srv.submit(program("hdiff"), xl[i]) for i in range(members)]
    done = {r.rid: r for r in srv.run_until_idle()}
    want = ir.lower_batched(program("hdiff"), backend="sharded-cuda", mesh=meshes["2x4"])(xl)
    flag = torch.tensor([int(srv.stats["batches"] == 1 and all(
        torch.equal(done[rid].result, want[i]) for i, rid in enumerate(rids)))])
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
    out["served"] = bool(flag)
    return out if rank == 0 else None


def reduce_suite(rank, world, grads):
    """``reduce_gradients`` on this rank's ``grads[rank]`` (numpy leaves) over
    the default group and over a one-rank subgroup, every method and
    reduction; returns ``{(method, mean): numpy tree}`` and the wire."""
    import torch
    import torch.distributed as dist

    from repro_torch.tree import tree_map
    from repro_torch.dist import compress_bf16, reduce_gradients

    mine = tree_map(lambda a: torch.from_numpy(a.copy()), grads[rank])
    out = {}
    for method in ("none", "bf16"):
        for mean in (True, False):
            red = reduce_gradients(mine, method=method, mean=mean)
            out[(method, mean)] = tree_map(
                lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(), red)
    # new_group is collective: every rank creates every one-rank group, in order.
    alone = [dist.new_group([r]) for r in range(world)][rank]
    out["alone"] = tree_map(lambda t: t.numpy(),
                            reduce_gradients(mine, group=alone, method="none"))
    out["wire"] = compress_bf16(mine["w"]).float().numpy()
    return out


def _moe_cfg(arch: str, overrides: dict):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **overrides)


def moe_suite(rank, world, layer_cases, lm_cases):
    """The expert-parallel MoE on gloo ranks, each case on a ``("data",
    "model")`` mesh of the world's ranks (no JAX here).

    ``layer_cases``: ``{key: (arch, config overrides, mesh shape, whole
    MoE params (numpy tree), x (B, S, D))}``: every rank holds its
    ``shard_moe_params`` pieces and its ``spec_for(batch)`` block of ``x``
    and calls ``apply_moe`` under the ambient mesh (``S > 1``: the
    expert-parallel path or its fallback; ``S == 1``: the one-token step);
    returns ``(y gathered whole, aux)``. ``lm_cases``: ``{key: (arch,
    overrides, mesh shape, JAX-layout numpy LM params, batch)}``: the
    loss, its metrics and every gradient (the MoE leaves gathered whole)
    through ``lm_loss`` with each MoE layer sharded."""
    import numpy as np
    import torch

    from repro_torch.dist.sharding import gather_blocks, shard_param, spec_for, use_mesh
    from repro_torch.interop import lm_tree_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.lm import lm_loss
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    meshes = {}

    def mesh_of(shape):
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
        return meshes[shape]

    def tensors(tree, dtype):
        return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype), tree)

    layers = {}
    for key, (arch, over, shape, params, x) in layer_cases.items():
        cfg, mesh = _moe_cfg(arch, over), mesh_of(shape)
        mine = L.shard_moe_params(cfg, tensors(params, getattr(torch, cfg.param_dtype)), mesh)
        xspec = spec_for(("batch", "seq", "embed"), mesh, x.shape)
        xl = shard_param(torch.from_numpy(x.copy()), mesh, xspec)
        with use_mesh(mesh):
            y, aux = L.apply_moe(cfg, mine, xl)
        layers[key] = (gather_blocks(y, mesh, xspec).float().numpy(), float(aux))

    lms = {}
    for key, (arch, over, shape, jtree, batch) in lm_cases.items():
        cfg, mesh = _moe_cfg(arch, over), mesh_of(shape)
        tree = tensors(lm_tree_from_numpy(cfg, jtree), getattr(torch, cfg.param_dtype))
        for blk in tree["blocks"]:
            blk["ffn"] = L.shard_moe_params(cfg, blk["ffn"], mesh)
        leaves, treedef = tree_flatten(tree)
        work = [p.requires_grad_(True) for p in leaves]
        with use_mesh(mesh):
            loss, metrics = lm_loss(cfg, tree_unflatten(treedef, work),
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = tree_unflatten(treedef, list(torch.autograd.grad(loss, work)))
        with torch.no_grad():
            for blk in grads["blocks"]:
                blk["ffn"] = L.gather_moe_params(cfg, blk["ffn"], mesh)
        lms[key] = {"loss": float(loss.detach()), "aux_loss": float(metrics["aux_loss"].detach()),
                    "grads": tree_map(lambda t: t.float().numpy(), grads)}
    return {"layers": layers, "lms": lms}


def failing_rank(rank, world, store):
    """Rank 1 raises before joining any group; rank 0 waits to be killed."""
    if rank == 1:
        raise ValueError("rank 1 failed on purpose")
    time.sleep(60)
    return rank
