"""Moving state between the JAX package and the port.

Stencils. A stencil system has no weights: its "parameters" are the program (with
its coefficients baked into the graph — identity is
``StencilProgram.fingerprint()``, equal in both packages for the same
program) and the field state. The JAX package takes a bare array or a
``{field: array}`` mapping; :func:`fields_from_numpy` turns the same host
arrays into the port's tensors on a device, and :func:`to_numpy` turns a
result (bare tensor or ``{field: tensor}``) back into numpy. Nothing here
imports JAX: arrays cross as numpy.

Optimizers. :func:`optimizer_state_from_numpy` takes the JAX package's
``AdamWState`` / ``AdafactorState`` as numpy (``jax.tree.map(np.asarray,
state)``) and returns the port's, so one update can run from the same
state in both packages.

LMs. :func:`lm_params_from_numpy` takes the JAX ``build_lm`` parameter
pytree as numpy (``jax.tree.map(np.asarray, params)``), unstacks its
scanned superblocks (leading axis ``n_super``) and its tail into the
port's per-layer blocks (:func:`lm_tree_from_numpy`, which
``optimizer_state_from_numpy(..., cfg=...)`` applies to an LM's AdamW
moments), nested groups (arctic's MoE ``dense`` branch) kept nested and
a stacked scalar (llama-vision's cross ``gate``, ``(n_super,)``) one 0-d
tensor a layer, and returns an :class:`~repro_torch.models.LM`;
:func:`lm_cache_to_numpy` turns the port's per-layer cache back into the
JAX package's ``{"scan": ..., "tail": [...]}`` layout, for comparison.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.ir.evaluate import resolve_field_arrays
from repro_torch.ir.graph import StencilProgram
from repro_torch.tree import tree_map


def fields_from_numpy(program: StencilProgram, arrays, device=None):
    """``arrays`` (a bare array or a ``{field: array}`` mapping covering
    every input of ``program``, all on one grid) as tensors on ``device``
    (``None`` means ``"cuda"``), in the same form: a bare tensor for a bare
    array, else ``{field: tensor}`` in ``program.inputs`` order."""
    dev = resolve_device(device)
    host = resolve_field_arrays(program, arrays)
    tensors = [torch.from_numpy(np.array(a)).to(dev) for a in host]
    if isinstance(arrays, Mapping):
        return dict(zip(program.inputs, tensors))
    return tensors[0]


def to_numpy(result):
    """A lowered result as numpy: a bare ndarray, or ``{field: ndarray}``.
    bfloat16 comes back as float32 (exactly): numpy has no bfloat16."""
    if isinstance(result, Mapping):
        return {f: to_numpy(a) for f, a in result.items()}
    if result.dtype == torch.bfloat16:
        result = result.to(torch.float32)
    return result.detach().cpu().numpy()


def optimizer_state_from_numpy(state, device=None, cfg: ModelConfig | None = None):
    """The JAX package's ``AdamWState`` (``step, mu, nu``) or
    ``AdafactorState`` (``step, vr, vc``), its leaves numpy arrays (a tensor
    or a dict of them per field, bfloat16 moments as float32 or ml_dtypes
    bfloat16), as the port's state of the same name on ``device`` (``None``
    means the card). With ``cfg``, the state is an LM's: AdamW's moment
    trees are unstacked into the port's per-layer layout, as
    :func:`lm_params_from_numpy` unstacks the parameters; Adafactor's keep
    the JAX layout, which the port's LM trainer keeps for it (its factoring
    and update clipping couple the layers of a stacked leaf)."""
    from repro_torch.optim import AdafactorState, AdamWState

    dev = resolve_device(device)
    kinds = {cls._fields: cls for cls in (AdamWState, AdafactorState)}
    cls = kinds.get(tuple(getattr(state, "_fields", ())))
    if cls is None:
        raise TypeError(f"not an AdamWState or AdafactorState: {type(state).__name__}")

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    def field(name):
        tree = getattr(state, name)
        if cfg is not None and name != "step" and cls is AdamWState:
            tree = lm_tree_from_numpy(cfg, tree)
        return tree_map(tensor, tree)

    return cls(*(field(f) for f in cls._fields))


def lm_tree_from_numpy(cfg: ModelConfig, tree) -> dict:
    """A tree in the JAX package's LM parameter layout (scanned superblocks
    stacked on a leading ``n_super`` axis, then the tail) in the port's:
    ``{"embed", "blocks": [one per layer], "final_norm", "head"?}``, leaves
    left as they are."""
    blocks = []
    for s in range(cfg.n_super):
        for i in range(len(cfg.block_pattern)):
            blocks.append(tree_map(lambda a, s=s: a[s], tree["scan"][f"b{i}"]))
    blocks += list(tree["tail"])
    out = {"embed": tree["embed"], "blocks": blocks, "final_norm": tree["final_norm"]}
    if not cfg.tied_embeddings:
        out["head"] = tree["head"]
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The JAX package's LM parameters (a numpy pytree) as the port's
    :class:`~repro_torch.models.LM` on ``device`` (``None`` means the
    card). Leaves keep their dtype (bfloat16 comes as float32 numpy and is
    cast back to ``cfg.param_dtype``)."""
    from repro_torch.models.lm import LM

    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    return LM(cfg, tree_map(tensor, lm_tree_from_numpy(cfg, tree)))


def lm_cache_to_numpy(cfg: ModelConfig, cache) -> dict:
    """The port's per-layer cache in the JAX package's layout: each leaf of
    the scanned superblocks stacked over ``n_super`` under
    ``{"scan": {"b<i>": ...}}``, the remainder layers under ``"tail"``;
    float leaves as float32 numpy, ``slot_pos`` as int32."""
    def host(t):
        return t.detach().to("cpu", torch.float32 if t.is_floating_point() else t.dtype).numpy()

    layers = [tree_map(host, c) for c in cache]
    width, n_super = len(cfg.block_pattern), cfg.n_super
    out: dict = {"tail": layers[n_super * width:]}
    if n_super:
        out["scan"] = {
            f"b{i}": _tree_map_stack([layers[s * width + i] for s in range(n_super)])
            for i in range(width)
        }
    return out


def _tree_map_stack(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map_stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
