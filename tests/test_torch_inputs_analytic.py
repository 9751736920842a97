"""The port's cell inputs and analytic model against the JAX package's, on
the CPU.

* The cells: ``all_cells`` and ``applicable_cells`` equal the JAX
  registry's (32 cells; the encoder decodes nothing).
* ``cell_flops`` and ``cell_hbm_bytes`` (``repro_torch.launch.analytic``,
  a line-for-line copy) equal JAX's exactly for every cell.
* ``input_specs``: meta tensors (nothing allocated) with the JAX
  ``ShapeDtypeStruct``s' shapes and dtypes for every cell: tokens, or
  frames for the audio frontend, labels, ``memory`` for the vision one,
  and the serving cache, whose per-layer entries stacked as the JAX
  ``build_cache`` stacks its superblocks give its leaves.
* ``microbatches_for`` equals JAX's for every train cell on
  ``tests/test_torch_lm_axes.py``'s meshes.
* ``make_lowering_spec`` on the production ``(16, 16)`` mesh: every
  argument a meta tensor at the cell's global shapes, one placement a
  leaf whose pieces tile the leaf, train's ``donate`` the parameters and
  the state. Its step runs once at ``scale_for_smoke`` on the CPU for one
  smoke arch of each family (dense, MoE, hybrid, SSM, vision, audio):
  train, prefill and decode, finite results of the expected shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import all_cells as jax_all_cells
from repro.configs import applicable_cells as jax_applicable_cells
from repro.configs import get_config as jax_config
from repro.configs import get_shape as jax_shape
from repro.launch.analytic import cell_flops as jax_cell_flops
from repro.launch.analytic import cell_hbm_bytes as jax_cell_hbm_bytes
from repro.launch.inputs import input_specs as jax_input_specs
from repro.launch.inputs import microbatches_for as jax_microbatches_for
from repro_torch.configs import (ARCH_IDS, all_cells, applicable_cells, get_config, get_shape,
                                 get_smoke_config, scale_for_smoke)
from repro_torch.dist.sharding import NamedSharding
from repro_torch.launch.analytic import cell_flops, cell_hbm_bytes
from repro_torch.launch.inputs import input_specs, make_lowering_spec, microbatches_for
from repro_torch.models import build_cache
from repro_torch.train import init_train_state
from repro_torch.tree import tree_flatten, tree_leaves

CELLS = all_cells()
MESHES = [((2, 4), ("data", "model")), ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "qwen3-moe-235b-a22b", "hybrid": "recurrentgemma-2b",
            "ssm": "rwkv6-3b", "vlm": "llama-3.2-vision-90b", "audio": "hubert-xlarge"}


class FakeMesh:
    """Both packages' duck type: ``axis_names`` with ``devices.shape`` (JAX)
    and ``shape`` (the port)."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = tuple(shape)
        self.devices = np.empty(shape, dtype=object)


def _sd(t):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        assert t.device.type == "meta"
        return tuple(t.shape), str(t.dtype).removeprefix("torch.")
    return tuple(t.shape), str(t.dtype)


def _jax_cache_layout(cfg, cache):
    """The port's per-layer cache in the JAX ``build_cache`` layout, as
    (shape, dtype) leaves: superblock entries stacked, the tail as it is."""
    width, n_super = len(cfg.block_pattern), cfg.n_super

    def stack(entries):
        if isinstance(entries[0], dict):
            return {k: stack([e[k] for e in entries]) for k in entries[0]}
        shape, dtype = _sd(entries[0])
        assert all(_sd(e) == (shape, dtype) for e in entries)
        return ((len(entries),) + shape, dtype)

    out = {"tail": [_tree_sd(c) for c in cache[n_super * width:]]}
    if n_super:
        out["scan"] = {f"b{i}": stack(cache[i:n_super * width:width]) for i in range(width)}
    return out


def _tree_sd(tree):
    if isinstance(tree, dict):
        return {k: _tree_sd(v) for k, v in tree.items()}
    return _sd(tree)


def _jax_sd(tree):
    if isinstance(tree, dict):
        return {k: _jax_sd(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_sd(v) for v in tree]
    return _sd(tree)


def test_cells_equal_the_jax_registrys():
    assert CELLS == jax_all_cells() and len(CELLS) == 32
    for arch in ARCH_IDS:
        assert applicable_cells(arch) == jax_applicable_cells(arch)
    assert ("hubert-xlarge", "decode_32k") not in CELLS
    assert ("llama-3.2-vision-90b", "decode_32k") in CELLS


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_analytic_model_equals_jax(arch, shape_name):
    cfg, shape = get_config(arch), get_shape(shape_name)
    jcfg, jshape = jax_config(arch), jax_shape(shape_name)
    assert cell_flops(cfg, shape) == jax_cell_flops(jcfg, jshape)
    assert cell_hbm_bytes(cfg, shape) == jax_cell_hbm_bytes(jcfg, jshape)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_jax(arch, shape_name):
    cfg, shape = get_config(arch), get_shape(shape_name)
    got = input_specs(cfg, shape)
    want = jax_input_specs(jax_config(arch), jax_shape(shape_name))
    assert got.keys() == want.keys()
    for key in got:
        if key == "cache":
            assert _jax_cache_layout(cfg, got[key]) == _jax_sd(want[key])
        elif key == "pos":
            # The port's decode takes the position as a Python int (the
            # cell's last); JAX traces an int32 scalar.
            assert got[key] == shape.seq_len - 1 and _sd(want[key]) == ((), "int32")
        else:
            assert _sd(got[key]) == _sd(want[key]), key
    if cfg.frontend == "audio" and shape.kind == "train":
        assert got["tokens"].shape == (shape.global_batch, shape.seq_len, cfg.d_model)
    if cfg.frontend == "vision" and shape.kind != "decode":
        assert got["memory"].shape[1:] == (cfg.num_media_tokens, cfg.d_model)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_microbatches_equal_jax(mesh):
    fake = FakeMesh(*mesh)
    for arch, shape_name in CELLS:
        if get_shape(shape_name).kind != "train":
            continue
        assert (microbatches_for(get_config(arch), get_shape(shape_name), fake)
                == jax_microbatches_for(jax_config(arch), jax_shape(shape_name), fake))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_lowering_spec_places_every_meta_argument(arch, shape_name):
    cfg, shape = get_config(arch), get_shape(shape_name)
    mesh = FakeMesh((16, 16), ("data", "model"))
    spec = make_lowering_spec(cfg, shape, mesh)
    assert spec.name.startswith(f"{arch}:{shape_name}:")
    assert spec.meta["params"] == cfg.param_count()
    assert spec.meta["mesh"] == {"data": 16, "model": 16}
    for arg, sh in zip(spec.args, spec.in_shardings):
        if isinstance(arg, int):  # decode's position, a Python int
            assert shape.kind == "decode" and arg == shape.seq_len - 1 and sh is None
            continue
        leaves, treedef = tree_flatten(arg)
        shs, sh_def = tree_flatten(sh, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert treedef == sh_def and len(leaves) == len(shs)
        for t, s in zip(leaves, shs):
            assert t.device.type == "meta"
            assert s.global_shape(s.piece_shape(t.shape)) == tuple(t.shape)
    if shape.kind == "train":
        assert spec.donate == (0, 1)
        assert spec.meta["microbatches"] == microbatches_for(cfg, shape, mesh)
        batch = spec.args[2]
        lead = (spec.meta["microbatches"],) if spec.meta["microbatches"] > 1 else ()
        assert batch["labels"].shape[:len(lead)] == lead
    else:
        assert spec.donate == ()


def _fill(t, vocab, gen):
    """A meta leaf of the batch made real: ids below ``vocab``, or normals."""
    if t.dtype.is_floating_point:
        return torch.randn(tuple(t.shape), generator=gen, dtype=t.dtype)
    return torch.randint(0, vocab, tuple(t.shape), generator=gen, dtype=t.dtype)


def _same_meta(real, meta):
    for r, m in zip(tree_leaves(real), tree_leaves(meta)):
        assert (tuple(r.shape), r.dtype) == (tuple(m.shape), m.dtype)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lowering_spec_steps_run_at_smoke_scale(family):
    arch = FAMILIES[family]
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    mesh = FakeMesh((1, 1), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    for shape_name in applicable_cells(arch):
        shape = scale_for_smoke(get_shape(shape_name), seq=32, batch=2)
        spec = make_lowering_spec(cfg, shape, mesh)
        if shape.kind == "train":
            params, state = init_train_state(cfg, "cpu", seed=0)
            _same_meta((params, state), spec.args[:2])
            batch = {k: _fill(v, cfg.vocab_size, gen) for k, v in spec.args[2].items()}
            params, state, m = spec.fn(params, state, batch)
            assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
            assert int(state.step) == 1
            continue
        model_params = init_train_state(cfg, "cpu", seed=0)[0]
        _same_meta(model_params, spec.args[0])
        cache = build_cache(cfg, shape.global_batch, shape.seq_len, device="cpu")
        _same_meta(cache, spec.args[2])
        if shape.kind == "prefill":
            rest = [_fill(a, cfg.vocab_size, gen) for a in spec.args[3:]]
            logits, cache = spec.fn(model_params, _fill(spec.args[1], cfg.vocab_size, gen),
                                    cache, *rest)
        else:
            logits, cache = spec.fn(model_params, _fill(spec.args[1], cfg.vocab_size, gen),
                                    cache, torch.tensor(0, dtype=torch.int32))
        assert logits.shape == (shape.global_batch, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
