"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, at smoke
configs and one full-width cell; every trace runs on meta tensors for one
rank inside a ``"fake"`` process group, and no test leaves a group behind.

* (a) The five cells of the JAX package's red dry-run check
  (``tests/multidev/_dryrun_check.py``: qwen3-moe train, starcoder2
  prefill, recurrentgemma decode, rwkv6 decode, llama-vision train; 64
  tokens, 4 rows, remat off) on a ``(2, 4)`` mesh of 8 fake ranks, at
  ranks 0 and 7: FLOPs, a peak above the arguments, collective calls on
  the train cells.
* (b) Those train cells' (one microbatch) gathered and summed bytes equal
  ``shard_wire_reckoning`` exactly, and the gathers' ring wire bytes the
  ``dist.gather.bytes`` counter; every arch's train step (remat on, two
  blocked local paths past ``FLASH_THRESHOLD``) on ``(2, 4)``, ``(1, 4)``,
  ``(4, 1)`` and ``(2, 2, 2)``: its collectives, tensor-parallel ones
  included, equal the reckoning by kind, calls and bytes.
* (c) The bytes a rank is handed equal JAX's, byte for byte, but for the
  leaves named below with their reasons: on one device against XLA's
  ``argument_size_in_bytes`` of the compiled JAX step; on ``(2, 4)``
  against the JAX spec's ``shard_shape`` bytes (``tests/torch_jax_dryrun.py``
  in an 8-device subprocess; nothing compiled).
* (d) K6's, K7's and K7's backward's meta routes give their plain
  versions' shapes and dtypes, note ``plan_launches``' count of launches
  with their work, and count no launch; a stencil wrapper's check still
  refuses a meta tensor.
* (e) Every decoding arch's decode step runs on meta; the MoE runs on
  meta, and on the CPU its expert counts (a scatter of ones since the dry
  run) equal ``bincount``'s.
* (f) The counted FLOPs over the analytic model, on one device, in the
  band :data:`FLOPS_BAND` (derived below).
* (g) ``qwen1.5-0.5b`` ``train_4k`` on the production ``(16, 16)`` mesh:
  its counted FLOPs over all ranks within :data:`FLOPS_BAND` of the
  analytic model's, and it fits a rank.
* (h) The CLI writes its JSON.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch.inputs import make_lowering_spec as jax_lowering_spec
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.configs import ARCH_IDS, applicable_cells, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import _build
from repro_torch.kernels.rglru import kernel as k6
from repro_torch.kernels.rglru.ops import rglru_reverse
from repro_torch.kernels.rglru.ref import rglru_seq_ref
from repro_torch.kernels.wkv6 import kernel as k7
from repro_torch.kernels.wkv6.ref import wkv6_backward_plain, wkv6_plain
from repro_torch.launch import dryrun
from repro_torch.models import layers as L

ROOT = Path(__file__).resolve().parents[1]
CASES = [("qwen3-moe-235b-a22b", "train"), ("starcoder2-3b", "prefill"),
         ("recurrentgemma-2b", "decode"), ("rwkv6-3b", "decode"),
         ("llama-3.2-vision-90b", "train")]
TRAIN_CASES = [arch for arch, kind in CASES if kind == "train"]
MESH = (2, 4)
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "qwen3-moe-235b-a22b", "hybrid": "recurrentgemma-2b",
            "ssm": "rwkv6-3b", "vlm": "llama-3.2-vision-90b", "audio": "hubert-xlarge"}
# Counted FLOPs over the analytic model, one device, train (remat off) and
# prefill at 128 tokens of 2 rows. Below 1 only by the analytic model's
# terms that run as no matmul (the recurrences' pointwise updates,
# RG-LRU's and RWKV-6's, counted there at a handful of FLOPs a channel):
# every matmul it counts runs, once forward and twice backward (its train
# total is 3 forwards). Above 1 by what it leaves out: the flash and dense
# paths compute causal score blocks whole where it counts half the
# context, the MoE computes its capacity slots (a capacity factor over the
# routed tokens) and the logits' backward two products of the head's size.
FLOPS_BAND = (0.95, 1.5)


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), remat=False)


def _shape(kind, seq=64, batch=4):
    return ShapeConfig("t", seq, batch, kind)


@functools.cache
def _traced(arch, kind, mesh, rank=0):
    return dryrun.trace_step(_cfg(arch), _shape(kind), mesh, rank=rank)


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# -- (a) the reference's red check, ported ------------------------------------------------


@pytest.mark.parametrize("rank", [0, 7])
@pytest.mark.parametrize("arch,kind", CASES)
def test_reference_cases_trace_on_eight_fake_ranks(arch, kind, rank):
    r = _traced(arch, kind, MESH, rank)
    mem = r["memory_analysis"]
    assert r["status"] == "ok"
    assert r["meta"]["mesh"] == {"data": 2, "model": 4} and r["meta"]["rank"] == rank
    assert r["cost_analysis"]["flops_per_device"] > 0
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0
    assert sum(mem["peak_bytes_by_category"].values()) == mem["peak_bytes"]
    calls = sum(c["calls"] for c in r["collectives"]["by_kind"].values())
    if kind == "train":
        assert calls > 0 and r["collectives"]["wire_bytes_per_device"] > 0
        assert mem["peak_bytes_by_category"]["activations"] > 0
        assert "tensor-parallel training" in r["note"] and "whole weights" not in r["note"]
    else:
        # Tensor-parallel serving: the rank's pieces, and collectives over
        # ``model`` in every serving step.
        assert r["note"] and "tensor-parallel" in r["note"] and "whole weights" not in r["note"]
        assert calls > 0 and r["collectives"]["wire_bytes_per_device"] > 0


# -- (b) collective bytes ---------------------------------------------------------------


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_collective_bytes_equal_the_reckoning(arch):
    r = _traced(arch, "train", MESH, 5)
    assert r["meta"]["microbatches"] == 1
    want = dryrun.shard_wire_reckoning(_cfg(arch), MESH, 4, 64)
    coll = r["collectives"]
    assert coll["counters"]["dist.gather.bytes"] == want["gather"]
    assert coll["counters"]["dist.grad_sum.bytes"] == want["grad_sum"]
    assert coll["by_kind"]["all_gather"]["wire_bytes"] == want["gather"]
    # Beside the gradient sums: the loss's, the norm's, aux's and the
    # tensor-parallel layers' sums.
    assert coll["by_kind"]["all_reduce"]["payload_bytes"] > want["grad_sum"]


def _by_kind(rows) -> dict:
    out: dict = {}
    for kind_c, payload, ranks in rows:
        row = out.setdefault(kind_c, {"calls": 0, "payload_bytes": 0, "wire_bytes": 0.0})
        row["calls"] += 1
        row["payload_bytes"] += payload
        row["wire_bytes"] += dryrun.ring_wire_bytes(kind_c, payload, ranks)
    return out


TRAIN_MESHES = [(2, 4), (1, 4), (4, 1), (2, 2, 2)]
# (arch, seq, config overrides): every arch with remat (the recompute's
# collectives), and past FLASH_THRESHOLD the blocked local path with its
# blocks split over model (recurrentgemma's 2 heads, starcoder2 at 6).
TRAIN_CELLS = [(a, 64, {"remat": True}) for a in ARCH_IDS]
TRAIN_CELLS += [("recurrentgemma-2b", 4096, {"remat": True}),
                ("starcoder2-3b", 4096, {"remat": True, "n_heads": 6})]


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
@pytest.mark.parametrize("arch,seq,over", TRAIN_CELLS)
def test_train_collectives_equal_the_reckoning(arch, seq, over, mesh):
    """A train step's every collective (its gathers and gradient sums, the
    tensor-parallel layers' sums and gathers, the vocabulary-parallel
    loss's, the clip's and Adafactor's) equals
    ``shard_wire_reckoning`` by kind, calls and bytes, and its byte
    counters the reckoning's."""
    cfg = dataclasses.replace(_cfg(arch), **over)
    r = dryrun.trace_step(cfg, _shape("train", seq), mesh, rank=math.prod(mesh) - 1)
    want = dryrun.shard_wire_reckoning(cfg, mesh, 4, seq, r["meta"]["microbatches"])
    coll = r["collectives"]
    assert coll["by_kind"] == _by_kind(want["collectives"])
    assert coll["counters"].get("dist.gather.bytes", 0) == want["gather"]
    assert coll["counters"].get("dist.grad_sum.bytes", 0) == want["grad_sum"]


SERVE_MESHES = [(2, 4), (1, 4), (2, 2), (2, 2, 2)]


SERVE_CELLS = [(a, k, 64) for a in ARCH_IDS for k in ("prefill", "decode")
               if k == "prefill" or "decode_32k" in applicable_cells(a)]
# Past FLASH_THRESHOLD: the blocked local path, its blocks split over model
# where the heads are not (recurrentgemma's 2 heads on 4).
SERVE_CELLS += [("recurrentgemma-2b", "prefill", 4096), ("starcoder2-3b", "prefill", 4096)]


@pytest.mark.parametrize("mesh", SERVE_MESHES)
@pytest.mark.parametrize("arch,kind,seq", SERVE_CELLS)
def test_serving_collectives_equal_the_serve_reckoning(arch, kind, seq, mesh):
    cfg = _cfg(arch)
    rank = math.prod(mesh) - 1
    r = dryrun.trace_step(cfg, _shape(kind, seq), mesh, rank=rank)
    want: dict = {}
    for kind_c, payload, ranks in dryrun.serve_wire_reckoning(cfg, kind, mesh, 4, seq, seq):
        row = want.setdefault(kind_c, {"calls": 0, "payload_bytes": 0, "wire_bytes": 0.0})
        row["calls"] += 1
        row["payload_bytes"] += payload
        row["wire_bytes"] += dryrun.ring_wire_bytes(kind_c, payload, ranks)
    assert r["collectives"]["by_kind"] == want


def test_ring_wire_model():
    assert dryrun.ring_wire_bytes("all_reduce", 800, 4) == 1200
    assert dryrun.ring_wire_bytes("all_gather", 800, 4) == 600
    assert dryrun.ring_wire_bytes("all_reduce", 800, 1) == 0


# -- (c) argument bytes against JAX's ----------------------------------------------------

# One device: XLA counts the arguments the compiled program reads. The
# port's step is handed every one of them, and its decode position is a
# Python int (no tensor).
ONE_DEVICE_DIFFERENCES = {
    # starcoder2's prefill writes its cache fresh: XLA prunes the unread
    # argument, the port's step is handed it.
    ("starcoder2-3b", "prefill"): "cache",
    # recurrentgemma's decode reads its int32 position (the local
    # attention's ring slot): 4 bytes in JAX, a Python int in the port.
    ("recurrentgemma-2b", "decode"): "pos",
    # rwkv6's decode has no position: XLA prunes it, the port passes an int.
}


@pytest.mark.parametrize("arch,kind", CASES)
def test_argument_bytes_equal_jax_on_one_device(arch, kind):
    jcfg = dataclasses.replace(jax_smoke_config(arch), remat=False)
    spec = jax_lowering_spec(jcfg, JaxShapeConfig("t", 64, 4, kind),
                             jax_make_mesh((1, 1), ("data", "model")))
    want = jax.jit(spec.fn).lower(*spec.args).compile().memory_analysis().argument_size_in_bytes
    got = _traced(arch, kind, (1, 1))["memory_analysis"]
    differs = ONE_DEVICE_DIFFERENCES.get((arch, kind))
    if differs == "cache":
        want += sum(math.prod(a.shape) * a.dtype.itemsize for a in jax.tree.leaves(spec.args[2]))
    elif differs == "pos":
        want -= 4
    assert got["argument_bytes"] == want


@pytest.fixture(scope="module")
def jax_shard_bytes():
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    cases = [[arch, "train"] for arch in TRAIN_CASES]
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_jax_dryrun.py"),
                           json.dumps(cases)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_argument_bytes_equal_jax_shard_shapes(arch, jax_shard_bytes):
    params, state, batch = jax_shard_bytes[f"{arch}:train"]
    for rank in (0, 7):
        got = _traced(arch, "train", MESH, rank)["memory_analysis"]["argument_bytes_by_kind"]
        assert got["parameters"] == params and got["optimizer_state"] == state
        # The batch differs: the port's trainer is handed the GLOBAL batch and
        # takes its rows inside the step; JAX places a rank's rows.
        assert got["batch"] == batch * MESH[0]


# -- (d) the kernels' meta routes ------------------------------------------------------


def _meta_run(fn, *args, **kw):
    _build.META_LAUNCHES.clear()
    _build.reset_launches()
    out = fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args), **kw)
    assert not _build.LAUNCHES
    return out, {k: dict(v) for k, v in _build.META_LAUNCHES.items()}


def _same(meta_out, cpu_out):
    for m, c in zip(meta_out, cpu_out):
        assert m.device.type == "meta"
        assert (tuple(m.shape), m.dtype) == (tuple(c.shape), c.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_meta_route(dtype):
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((3, 20, 12), generator=gen).to(dtype)
    b = torch.randn((3, 20, 12), generator=gen).to(dtype)
    h0 = torch.randn((3, 12), generator=gen)
    out, notes = _meta_run(k6.rglru_scan_cuda, a, b, h0)
    _same(out, rglru_seq_ref(a, b, h0))
    size = a.element_size()
    flops, nbytes = k6.launch_work(3, 20, 12, size)
    assert notes == {"rglru_scan_cuda": {"launches": 1, "flops": flops, "bytes": nbytes}}
    # Past the grid's 65535 rows: one noted launch per planned run of rows.
    rows = 70000
    big = torch.empty((rows, 2, 4), dtype=dtype, device="meta")
    _, notes = _meta_run(k6.rglru_scan_cuda, big, big,
                         torch.empty((rows, 4), device="meta"))
    plans = k6.plan_launches(rows, 2, 4, size, _build.META_SMS, vec=True)
    assert notes["rglru_scan_cuda"]["launches"] == len(plans) == 2
    assert notes["rglru_scan_cuda"]["flops"] == sum(
        k6.launch_work(nb, 2, 4, size)[0] for _, nb, _ in plans)
    # The backward's reverse scan goes through K6 on meta too.
    g, notes = _meta_run(rglru_reverse, a.float(), b.float())
    assert g.shape == a.shape and notes["rglru_scan_cuda"]["launches"] == 1


def _wkv_inputs(b, t, h, n):
    gen = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn((b, t, h, n), generator=gen) for _ in range(3))
    w = -torch.rand((b, t, h, n), generator=gen)
    return r, k, v, w, torch.randn((h, n), generator=gen), torch.randn((b, h, n, n), generator=gen)


def test_k7_meta_route():
    x = _wkv_inputs(2, 16, 3, 4)
    out, notes = _meta_run(k7.wkv6_cuda, *x, chunk=8)
    _same(out, wkv6_plain(*x, chunk=8))
    flops, nbytes = k7.call_work(2, 16, 3, 4, 8)
    assert notes == {"wkv6_cuda": {"launches": 1, "flops": flops, "bytes": nbytes}}
    # Heads past 65535: the strided runs' copies, one noted call a run.
    heads = 65537
    big = [torch.empty((1, 2, heads, 1), device="meta") for _ in range(4)]
    _, notes = _meta_run(k7.wkv6_cuda, *big, torch.empty((heads, 1), device="meta"),
                         torch.empty((1, heads, 1, 1), device="meta"), chunk=2)
    assert notes["wkv6_cuda"]["launches"] == len(k7.plan_launches(1, heads)) == 2


def test_k7_backward_meta_route():
    x = _wkv_inputs(2, 16, 3, 4)
    gen = torch.Generator().manual_seed(2)
    dy, ds = torch.randn((2, 16, 3, 4), generator=gen), torch.randn((2, 3, 4, 4), generator=gen)
    out, notes = _meta_run(k7.wkv6_bwd_cuda, *x, dy, ds, chunk=8)
    _same(out, wkv6_backward_plain(*x, dy, ds, chunk=8))
    flops, nbytes = k7.bwd_call_work(2, 16, 3, 4, 8)
    assert notes == {"wkv6_bwd_cuda": {"launches": 1, "flops": flops, "bytes": nbytes}}


def test_stencil_wrappers_take_no_meta_tensor():
    x = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        _build.check_input("hdiff_cuda", x, (torch.float32,))
    _build.check_input("rglru_scan_cuda", x, (torch.float32,), shape=(2, 8, 8), meta=True)


# -- (e) decode and the MoE on meta ------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if "decode_32k" in applicable_cells(a)])
def test_decode_spec_runs_on_meta(arch):
    r = dryrun.trace_step(get_smoke_config(arch), _shape("decode", 64, 2), (1, 1))
    assert r["meta"]["kind"] == "decode"
    assert r["cost_analysis"]["flops_per_device"] > 0
    assert r["memory_analysis"]["argument_bytes_by_kind"]["cache"] > 0


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_runs_on_meta_and_its_counts_are_bincounts(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    p = L.init_moe(cfg, L.Init(gen, L.dt(cfg), torch.device("cpu")))
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y, aux = L._apply_moe_local(cfg, p, x)
    probs, _, idx = L._route(cfg, p["router"], x.reshape(-1, cfg.d_model))
    ce = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts).to(torch.float32) / idx.numel()
    assert torch.equal(aux, cfg.n_experts * torch.sum(probs.mean(0) * ce))
    meta_p = {k: (v.to("meta") if isinstance(v, torch.Tensor) else
                  {kk: vv.to("meta") for kk, vv in v.items()}) for k, v in p.items()}
    ym, auxm = L._apply_moe_local(cfg, meta_p, x.to("meta"))
    assert ym.device.type == "meta" and ym.shape == y.shape and auxm.shape == aux.shape


# -- (f) FLOPs against the analytic model ------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_counted_flops_against_the_analytic_model(family, kind):
    r = dryrun.trace_step(_cfg(FAMILIES[family]), _shape(kind, 128, 2), (1, 1))
    ratio = r["analytic"]["counted_over_analytic"]
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    if family == "ssm":  # K7's work, noted by its meta route, is in the count
        assert r["kernels"]["wkv6_cuda"]["flops"] > 0


# -- (g) one production cell ---------------------------------------------------------


def test_production_cell_traces(tmp_path):
    r = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "single", tmp_path)
    assert r["status"] == "ok" and r["cell"] == "qwen1.5-0.5b__train_4k__single"
    assert r["meta"]["mesh"] == {"data": 16, "model": 16} and r["meta"]["microbatches"] == 1
    mem = r["memory_analysis"]
    assert isinstance(mem["fits"], bool) and mem["peak_bytes"] > mem["argument_bytes"]
    # The model axis splits the compute (tensor-parallel training): each of
    # its 16 ranks computes its share of its data rank's 16 rows, so all
    # ranks count the cell's FLOPs once, and the logits stay split by
    # vocabulary: the cell fits a rank.
    ratio = r["analytic"]["counted_over_analytic"]
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    assert mem["fits"]
    assert json.loads((tmp_path / f"{r['cell']}.json").read_text())["status"] == "ok"
    assert set(r) >= {"meta", "memory_analysis", "cost_analysis", "collectives", "analytic",
                      "roofline", "kernels", "device"}


# -- (h) the CLI, and the caller's group -------------------------------------------


def test_cli_writes_its_json(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "single",
                           "--out", str(tmp_path)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[dryrun] qwen1.5-0.5b__decode_32k__single: OK" in proc.stdout
    r = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__single.json").read_text())
    assert r["status"] == "ok" and r["roofline"]["dominant"] in ("compute", "memory",
                                                                  "collective")


def test_an_initialised_group_is_left_alone(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.trace_step(_cfg("qwen1.5-0.5b"), _shape("train"), (1, 1))
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
