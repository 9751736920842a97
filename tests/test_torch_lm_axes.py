"""The LM's logical axes and the placement of whole trees in the port
against the JAX package, on the CPU.

* ``lm_axes`` (per layer), stacked by ``lm_stacked`` with ``stack_axes``,
  equals the JAX ``build_lm(cfg, key=None)[1]`` leaf for leaf for the 10
  architectures at their smoke and published shapes (llama-vision's
  scalar cross-attention ``gate`` included), and
  ``lm_meta`` gives the JAX abstract parameters' shapes.
* ``opt_state_axes`` equals the JAX one for AdamW and Adafactor (whose
  factored test reads the global stacked shapes).
* ``tree_shardings`` of the parameters and of the optimizer state gives
  the JAX ``spec_for`` of every leaf on ``(2, 4)``, ``(1, 4)``, ``(4, 1)``
  ``("data", "model")`` and ``(2, 16, 16)`` ``("pod", "data", "model")``
  meshes (``tests/test_dist.py``'s duck-typed mesh), and each sharding's
  piece shape times its counts is the leaf's shape.
* Tensor-parallel serving's pieces (``serving_shardings``,
  ``cache_shardings``): every parameter's and every cache leaf's piece
  shape, stacked into the JAX layout, equals the partition of the JAX
  ``spec_for(..., mode="decode")`` of that leaf on the duck-typed ``(16,
  16)`` and ``(2, 16, 16)`` production meshes, for the 10 architectures at
  published shapes (the cache of a ``prefill_32k`` and a ``decode_32k``
  cell).
* The trainer's parameter placements (train mode) equal serving's
  (decode mode) for the 10 architectures on those two meshes, and the JAX
  ``spec_for`` gives every parameter the same spec in both modes (no
  parameter has a ``kv_seq`` axis).
* Without a process group ``make_host_mesh`` is ``None`` (one device) and
  ``make_production_mesh`` raises; ``data_axes`` folds pod into data.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.dist.sharding import spec_for as jax_spec_for
from repro.models import build_cache as jax_build_cache
from repro.models import build_lm as jax_build_lm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import opt_state_axes as jax_opt_state_axes
from repro.optim import optimizer_config_from_model as jax_opt_config
from repro_torch.configs import get_config, get_shape, get_smoke_config
from repro_torch.dist.sharding import _is_axes_leaf, tree_shardings
from repro_torch.launch import mesh as M
from repro_torch.models.lm import (build_cache, cache_shardings, lm_axes, lm_meta, lm_stacked,
                                   serving_shardings, stack_axes, stack_meta)
from repro_torch.optim import make_optimizer, opt_state_axes, optimizer_config_from_model
from repro_torch.train.loop import train_shardings
from repro_torch.tree import tree_flatten, tree_map

ARCHS = ["qwen1.5-0.5b", "starcoder2-3b", "nemotron-4-15b", "glm4-9b", "recurrentgemma-2b",
         "rwkv6-3b", "qwen3-moe-235b-a22b", "arctic-480b", "llama-3.2-vision-90b",
         "hubert-xlarge"]
SCALES = ["smoke", "published"]
MESHES = {
    "dm2x4": ((2, 4), ("data", "model")),
    "dm1x4": ((1, 4), ("data", "model")),
    "dm4x1": ((4, 1), ("data", "model")),
    "pdm2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


class FakeMesh:
    """Both packages' duck type: ``axis_names`` with ``devices.shape`` (JAX)
    and ``shape`` (the port)."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = tuple(shape)
        self.devices = np.empty(shape, dtype=object)


def _configs(arch, scale):
    if scale == "smoke":
        return get_smoke_config(arch), jax_smoke_config(arch)
    return get_config(arch), jax_config(arch)


@functools.cache
def _jax_tree(arch, scale):
    """The JAX abstract parameters and their axes."""
    return jax_build_lm(_configs(arch, scale)[1], key=None)


@functools.cache
def _port(arch, scale):
    """The port's axes and global shapes in the JAX stacked layout."""
    cfg = _configs(arch, scale)[0]
    return (lm_stacked(cfg, lm_axes(cfg), stack_axes, is_leaf=_is_axes_leaf),
            lm_stacked(cfg, lm_meta(cfg), stack_meta))


def _leaves(tree):
    return tree_flatten(tree, is_leaf=_is_axes_leaf)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_axes_equal_the_jax_build_lm_axes(arch, scale):
    mine, meta = _port(arch, scale)
    params, axes = _jax_tree(arch, scale)
    a, da = _leaves(mine)
    b, db = _leaves(axes)
    assert da == db
    assert a == b
    shapes = [tuple(t.shape) for t in tree_flatten(meta)[0]]
    assert shapes == [tuple(s.shape) for s in jax.tree.leaves(params)]
    dtypes = {str(t.dtype).removeprefix("torch.") for t in tree_flatten(meta)[0]}
    assert dtypes == {str(s.dtype) for s in jax.tree.leaves(params)}


def _opt_axes(arch, scale, name):
    cfg, jcfg = _configs(arch, scale)
    opt = dataclasses.replace(optimizer_config_from_model(cfg), name=name)
    jopt = dataclasses.replace(jax_opt_config(jcfg), name=name)
    axes, meta = _port(arch, scale)
    params, jaxes = _jax_tree(arch, scale)
    return opt_state_axes(opt, axes, meta), jax_opt_state_axes(jopt, jaxes, params), opt, jopt


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_axes_equal_the_jax_ones(arch, scale, name):
    mine, ref, _, _ = _opt_axes(arch, scale, name)
    assert type(mine).__name__ == type(ref).__name__
    for f in mine._fields:
        a, da = _leaves(getattr(mine, f))
        b, db = _leaves(getattr(ref, f))
        assert da == db, f
        assert a == b, f


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_shardings_give_the_jax_specs(arch, mesh):
    fake = FakeMesh(*MESHES[mesh])
    name = get_config(arch).optimizer
    axes, meta = _port(arch, "published")
    params, jaxes = _jax_tree(arch, "published")
    state_axes, jstate_axes, opt, jopt = _opt_axes(arch, "published", name)
    state_meta = make_optimizer(opt)[0](meta)
    jstate = jax.eval_shape(jax_make_optimizer(jopt)[0], params)
    for mine_axes, shapes, ref_axes, ref_shapes in (
            (axes, meta, jaxes, params), (state_axes, state_meta, jstate_axes, jstate)):
        shs = tree_flatten(tree_shardings(mine_axes, fake, shapes))[0]
        ref_ax, _ = _leaves(ref_axes)
        ref_sh = jax.tree.leaves(ref_shapes)
        assert len(shs) == len(ref_ax) == len(ref_sh)
        for sh, ax, s, t in zip(shs, ref_ax, ref_sh, tree_flatten(shapes)[0]):
            assert sh.spec == tuple(jax_spec_for(ax, fake, s.shape)), (ax, s.shape)
            assert sh.global_shape(sh.piece_shape(t.shape)) == tuple(t.shape)
            assert sh.replicas * np.prod(sh.counts(), dtype=int) == np.prod(fake.shape)


SERVE_MESHES = {"single": ((16, 16), ("data", "model")),
                "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(e, int) for e in x)


def _jax_pieces(tree, axes, fake):
    """Each leaf's piece shape under the JAX decode-mode spec, in order."""
    out = []
    for ax, s in zip(_leaves(axes)[0], jax.tree.leaves(tree)):
        spec = jax_spec_for(ax, fake, s.shape, mode="decode")
        counts = [int(np.prod([fake.shape[fake.axis_names.index(a)] for a in
                               ((e,) if isinstance(e, str) else (e or ()))]))
                  for e in tuple(spec) + (None,) * (len(s.shape) - len(spec))]
        out.append(tuple(n // c for n, c in zip(s.shape, counts)))
    return out


def _stacked_cache(cfg, layers):
    """Per-layer piece shapes in the JAX cache layout (``scan`` stacked)."""
    width, n = len(cfg.block_pattern), cfg.n_super
    out = {"tail": layers[n * width:]}
    if n:
        out["scan"] = {f"b{i}": tree_map(lambda t: (n,) + t, layers[i], is_leaf=_is_shape)
                       for i in range(width)}
    return out


@pytest.mark.parametrize("mesh", list(SERVE_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_param_pieces_are_the_jax_decode_partition(arch, mesh):
    fake = FakeMesh(*SERVE_MESHES[mesh])
    cfg = get_config(arch)
    shs = serving_shardings(cfg, fake)
    meta = lm_meta(cfg)
    pieces = tree_map(lambda sh, t: sh.piece_shape(t.shape), shs, meta,
                      is_leaf=lambda x: hasattr(x, "piece_shape"))
    stacked = lm_stacked(cfg, pieces, lambda ts, st: ((len(ts),) if st else ()) + ts[0],
                         is_leaf=_is_shape)
    params, axes = _jax_tree(arch, "published")
    assert tree_flatten(stacked, is_leaf=_is_shape)[0] == _jax_pieces(params, axes, fake)


@pytest.mark.parametrize("mesh", list(SERVE_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_param_specs_equal_the_decode_ones(arch, mesh):
    """No parameter has a ``kv_seq`` axis, so the trainer's pieces
    (``train_shardings``: train mode) are serving's (decode mode), in the
    port and in JAX: one set of splits serves both paths."""
    fake = FakeMesh(*SERVE_MESHES[mesh])
    cfg = get_config(arch)
    train = tree_flatten(train_shardings(cfg, fake)[0], is_leaf=lambda x: hasattr(x, "spec"))[0]
    serve = tree_flatten(serving_shardings(cfg, fake), is_leaf=lambda x: hasattr(x, "spec"))[0]
    assert [sh.spec for sh in train] == [sh.spec for sh in serve]
    params, axes = _jax_tree(arch, "published")
    for ax, t in zip(_leaves(axes)[0], jax.tree.leaves(params)):
        assert "kv_seq" not in ax
        assert (tuple(jax_spec_for(ax, fake, t.shape, mode="train"))
                == tuple(jax_spec_for(ax, fake, t.shape, mode="decode")))


@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh", list(SERVE_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cache_pieces_are_the_jax_decode_partition(arch, mesh, cell):
    fake = FakeMesh(*SERVE_MESHES[mesh])
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape = get_shape(cell)
    cache = build_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    shs = cache_shardings(cfg, fake, cache)
    layers = [tree_map(lambda sh, t: sh.piece_shape(t.shape), s, c,
                       is_leaf=lambda x: hasattr(x, "piece_shape")) for s, c in zip(shs, cache)]
    jcache, jaxes = jax_build_cache(jcfg, shape.global_batch, shape.seq_len, abstract=True)
    got = tree_flatten(_stacked_cache(cfg, layers), is_leaf=_is_shape)[0]
    assert got == _jax_pieces(jcache, jaxes, fake)
    assert got and any(p != tuple(t.shape) for p, t in zip(
        tree_flatten(layers, is_leaf=_is_shape)[0], tree_flatten(cache)[0]))


def test_host_mesh_is_one_device_without_a_group():
    assert not dist.is_initialized()
    assert M.make_host_mesh(backend="gloo") is None
    assert M.n_devices(None) == 1
    with pytest.raises(RuntimeError, match="initialised process group"):
        M.make_production_mesh(backend="gloo")
    fake = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert M.data_axes(fake) == ("pod", "data")
    assert M.mesh_axis_names(fake) == ("pod", "data", "model")
