"""Tensor-parallel serving (``lm_prefill`` / ``lm_decode`` under a mesh with
a ``model`` axis) on gloo ranks against one process and the JAX package,
on the CPU.

One spawn of 4 ranks (``torch_dist_harness.serve_tp_suite``, no JAX in the
children) runs every case while the parent computes the references. Each
rank takes its pieces of the parameters (``serving_shardings``: the JAX
decode-mode placements), of a fresh cache (``cache_shardings``: ``kv_seq``
on ``model`` first) and its rows of the batch, runs a prefill and 10
decode steps under ``use_mesh``, and gathers the logits and the cache.
The smoke configs at float32 (the MoEs dropless):

* qwen1.5 (every split even), glm4 (2 kv heads replicated on 4 model
  ranks, each query head reading its own kv group), recurrentgemma (2
  heads replicated on 4, the RG-LRU width split: K6's plain version on
  its channels; the window's ring of 8 slots split and wrapped by the
  decode steps), rwkv6 (the time mix whole on every rank, K7's plain
  version over a 64-token prefill; the channel mix split), llama-vision
  (the cross cache's media tokens split over ``model``, every gate 0.5)
  and qwen3-moe (the expert-parallel MoE beside tensor-parallel
  attention), on ``(1, 2)`` (a pair of ranks), ``(1, 4)`` and ``(2, 2)``;
  also arctic (64 padded heads: the head mask on each rank's heads), a
  cache of 22 positions, which ``model`` does not divide, for qwen1.5 (the
  cache split by kv heads instead) and glm4 (neither: whole), and a
  2560-token recurrentgemma prefill (past ``FLASH_THRESHOLD``: the blocked
  local path's 320 blocks split over ``model``, its heads whole).
* The logits of the prefill and of every decode step within 2e-4 (the
  sharded MoE's bound) of the port's one-process path and of the JAX
  package's one-device ``lm_prefill`` / ``lm_decode`` on the same numpy
  weights; every cache leaf, gathered from the ranks' pieces, within 2e-4
  of the one-process cache.
* The collectives of a decode step on the ranks equal
  ``serve_wire_reckoning``, row for row, and each rank holds exactly its
  pieces' bytes, less than the whole model where ``model`` splits it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_cache as jax_build_cache
from repro.models import build_lm as jax_build_lm
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_prefill as jax_lm_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.dryrun import serve_wire_reckoning
from repro_torch.models import build_cache, lm_decode, lm_prefill
from repro_torch.models.lm import lm_meta, serving_shardings
from repro_torch.tree import tree_flatten

from torch_dist_harness import serve_tp_suite, start_ranks

ARCHS = ["qwen1.5-0.5b", "glm4-9b", "recurrentgemma-2b", "rwkv6-3b", "llama-3.2-vision-90b",
         "qwen3-moe-235b-a22b"]
MESHES = [(1, 2), (1, 4), (2, 2)]
LENGTH = 24  # cache positions: model divides them
CASES = ([(arch, mesh, LENGTH) for arch in ARCHS for mesh in MESHES]
         + [("arctic-480b", (1, 4), LENGTH), ("arctic-480b", (2, 2), LENGTH),
            ("qwen1.5-0.5b", (1, 4), 22), ("glm4-9b", (1, 4), 22)])
LONG = "recurrentgemma-2b+long"  # a prefill past FLASH_THRESHOLD: the blocked local path
CASES += [(LONG, (1, 4), LENGTH), (LONG, (2, 2), LENGTH)]
TOL = 2e-4
GATE = 0.5
B, STEPS = 2, 10
# rwkv6: one chunk, K7's route; LONG: 320 blocks of 8, split over model
# (its 2 heads are not); the others 12 tokens (> window 8).
PREFILL = {"rwkv6-3b": 64, LONG: 2560}
WORLD = 4


def _arch(case):
    """The registry's arch of a case (``LONG`` is recurrentgemma)."""
    return case.split("+")[0]


def _over(arch):
    over = {"compute_dtype": "float32"}
    if arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        over["capacity_factor"] = 64.0  # dropless: every rank's tokens routed alike
    return over


def _cfgs(case):
    arch = _arch(case)
    return (dataclasses.replace(jax_smoke_config(arch), **_over(arch)),
            dataclasses.replace(get_smoke_config(arch), **_over(arch)))


def _gated(tree):
    if isinstance(tree, dict):
        return {n: (jnp.full_like(a, GATE) if n == "gate" else _gated(a)) for n, a in tree.items()}
    if isinstance(tree, list):
        return [_gated(a) for a in tree]
    return tree


@functools.cache
def _jax_params(arch):
    params, _ = jax_build_lm(jax_smoke_config(arch), jax.random.PRNGKey(3))
    params = _gated(params)
    return params, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


@functools.cache
def _inputs(case):
    cfg = get_smoke_config(_arch(case))
    rng = np.random.default_rng(11)
    p = PREFILL.get(case, 12)
    toks = rng.integers(0, cfg.vocab_size, (B, p + STEPS)).astype(np.int32)
    mem = None
    if cfg.frontend == "vision":
        mem = rng.standard_normal((B, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return toks, p, mem


def _key(arch, mesh, length):
    return f"{arch}:{mesh[0]}x{mesh[1]}:{length}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {}
    for arch, mesh, length in CASES:
        toks, p, mem = _inputs(arch)
        cases[_key(arch, mesh, length)] = (_arch(arch), _over(_arch(arch)), mesh,
                                          _jax_params(_arch(arch))[1], toks, p, length, mem)
    spawn = start_ranks(serve_tp_suite, WORLD, tmp_path_factory.mktemp("serve_tp"), cases,
                        timeout=400)
    for arch, _, length in CASES:  # the references, while the ranks run
        _one_process(arch, length)
        _jax(arch, length)
    return spawn.join()


def _t(a):
    return None if a is None else torch.from_numpy(a)


@functools.cache
def _one_process(arch, length):
    """The port's one-process logits (prefill, then each step) and cache."""
    _, cfg = _cfgs(arch)
    model = lm_params_from_numpy(cfg, _jax_params(_arch(arch))[1], device="cpu")
    toks, p, mem = _inputs(arch)
    last, cache = lm_prefill(cfg, model, _t(toks[:, :p]), build_cache(cfg, B, length,
                                                                      device="cpu"),
                             memory=_t(mem))
    steps = []
    for t in range(p, p + STEPS):
        lt, cache = lm_decode(cfg, model, _t(toks[:, t]), cache, t, memory=_t(mem))
        steps.append(lt.numpy())
    return last.numpy(), steps, [tree_flatten(c)[0] for c in cache]


@functools.cache
def _jax(arch, length):
    jcfg, _ = _cfgs(arch)
    params = _jax_params(_arch(arch))[0]
    toks, p, mem = _inputs(arch)
    jmem = None if mem is None else jnp.asarray(mem)
    jc, _ = jax_build_cache(jcfg, B, length)
    last, jc = jax_lm_prefill(jcfg, params, jnp.asarray(toks[:, :p]), jc, memory=jmem)
    steps = []
    for t in range(p, p + STEPS):
        lt, jc = jax_lm_decode(jcfg, params, jnp.asarray(toks[:, t]), jc, jnp.int32(t),
                               memory=jmem)
        steps.append(np.asarray(lt, np.float32))
    return np.asarray(last, np.float32), steps


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _results(ranks, arch, mesh, length):
    """Every rank's result of the case (the ranks of a (1, 2) mesh: both pairs)."""
    return [r[_key(arch, mesh, length)] for r in ranks]


@pytest.mark.parametrize("arch,mesh,length", CASES)
def test_logits_match_one_process_and_jax(ranks, arch, mesh, length):
    last, steps, _ = _one_process(arch, length)
    jlast, jsteps = _jax(arch, length)
    for rank, got in enumerate(_results(ranks, arch, mesh, length)):
        assert got["prefill"].shape == (B, get_smoke_config(_arch(arch)).vocab_size)
        _close(got["prefill"], last, f"rank {rank} prefill vs one process")
        _close(got["prefill"], jlast, f"rank {rank} prefill vs JAX")
        assert len(got["decode"]) == STEPS
        for i, (g, w, j) in enumerate(zip(got["decode"], steps, jsteps)):
            _close(g, w, f"rank {rank} decode step {i} vs one process")
            _close(g, j, f"rank {rank} decode step {i} vs JAX")


@pytest.mark.parametrize("arch,mesh,length", CASES)
def test_gathered_cache_pieces_equal_the_one_process_cache(ranks, arch, mesh, length):
    want = _one_process(arch, length)[2]
    for got in _results(ranks, arch, mesh, length):
        layers = [tree_flatten(c)[0] for c in got["cache"]]
        assert len(layers) == len(want)
        for g_layer, w_layer in zip(layers, want):
            for g, w in zip(g_layer, w_layer):
                assert g.shape == tuple(w.shape)
                _close(g, w.float().numpy() if w.is_floating_point() else w.numpy(), arch)


class _Shape:
    def __init__(self, shape):
        self.axis_names, self.shape = ("data", "model"), tuple(shape)


@pytest.mark.parametrize("arch,mesh,length", CASES)
def test_decode_collectives_and_pieces_equal_the_reckoning(ranks, arch, mesh, length):
    _, cfg = _cfgs(arch)
    want = sorted(serve_wire_reckoning(cfg, "decode", mesh, B, 1, length))
    shs = tree_flatten(serving_shardings(cfg, _Shape(mesh)),
                       is_leaf=lambda x: hasattr(x, "piece_shape"))[0]
    meta = tree_flatten(lm_meta(cfg))[0]
    itemsize = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    pieces = sum(int(np.prod(sh.piece_shape(t.shape))) * itemsize for sh, t in zip(shs, meta))
    whole = sum(t.numel() * itemsize for t in meta)
    for got in _results(ranks, arch, mesh, length):
        assert sorted(got["tally"]) == want
        assert got["param_bytes"] == pieces
        assert pieces < whole
