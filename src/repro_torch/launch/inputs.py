"""Meta-device stand-ins and placements for every (arch x shape) cell.

The port of ``repro/launch/inputs.py``. Where the JAX package builds
``ShapeDtypeStruct`` stand-ins for ``jit().lower()``, the port builds
tensors on the ``"meta"`` device: every shape and dtype, nothing
allocated. For each cell:

  * :func:`input_specs` — the model inputs of the cell (tokens, or frames
    ``(B, S, D)`` for the audio frontend; labels; ``memory`` ``(B, M, D)``
    for the vision one; the serving cache in the port's per-layer layout;
    the decode token), the JAX package's shapes and dtypes, and the decode
    position as the Python int ``lm_decode`` takes (the cell's last);
  * :func:`microbatches_for` — the gradient-accumulation factor that keeps
    the saved activations under a per-device budget (the JAX rule);
  * :func:`make_lowering_spec` — the step to run (the port's
    ``make_train_step``, or prefill / decode), its meta arguments at the
    cell's GLOBAL shapes, their placements on ``mesh`` by the port's
    ``tree_shardings`` and the arguments the step updates in place
    (``donate``).

``mesh`` is a :class:`~repro_torch.dist.sharding.Mesh`, or anything with
``axis_names`` and ``shape`` (enough for placements). Every step is built
for ``mesh`` when it is a ``Mesh`` of several ranks, and runs
tensor-parallel there: each rank passes its pieces of the parameters and
the state and the global batch (train: the step takes the rows its
``in_shardings`` place on the rank), or its pieces of the parameters, the
cache and the batch's rows (prefill and decode), each argument's
``in_shardings`` ``piece``. Nothing here allocates device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import Mesh, sharding_for, tree_shardings, use_mesh
from repro_torch.models.lm import (
    build_cache,
    cache_axes,
    lm_axes,
    lm_decode,
    lm_meta,
    lm_prefill,
    lm_stacked,
    stack_meta,
)
from repro_torch.optim.optimizers import make_optimizer, optimizer_config_from_model

META = torch.device("meta")


@dataclasses.dataclass
class LoweringSpec:
    """One cell's step, its meta arguments and their placements."""

    name: str
    fn: Callable
    args: tuple            # meta tensors (trees of them), global shapes
    in_shardings: tuple
    out_shardings: Any
    meta: dict
    donate: tuple = ()     # arguments the step updates in place (train: params, state)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def _batch_structs(cfg: ModelConfig, shape: ShapeConfig, mesh, microbatches: int = 1):
    b, s = shape.global_batch, shape.seq_len

    def mk(shp, dtype):
        if microbatches > 1:
            shp = (microbatches, shp[0] // microbatches) + shp[1:]
            ax = (None, "batch") + (None,) * (len(shp) - 2)
        else:
            ax = ("batch",) + (None,) * (len(shp) - 1)
        return _meta(shp, dtype), sharding_for(ax, mesh, shp)

    if cfg.frontend == "audio":
        toks, t_sh = mk((b, s, cfg.d_model), torch.float32)
    else:
        toks, t_sh = mk((b, s), torch.int32)
    labels, l_sh = mk((b, s), torch.int32)
    batch = {"tokens": toks, "labels": labels}
    shard = {"tokens": t_sh, "labels": l_sh}
    if cfg.frontend == "vision":
        batch["memory"], shard["memory"] = mk((b, cfg.num_media_tokens, cfg.d_model),
                                              torch.float32)
    return batch, shard


def _cache_structs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    cache = build_cache(cfg, shape.global_batch, shape.seq_len, device=META)
    return cache, tree_shardings(cache_axes(cfg), mesh, cache, mode="decode")


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor so remat-saved activations
    (B_micro_local x S x D x 2B x n_layers) fit the per-device budget."""
    sizes = _sizes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    b_loc = max(shape.global_batch // dp, 1)
    # RWKV's time-mix runs in f32 (decay/state numerics): 2x the bytes.
    act_bytes = 4 if cfg.family == "ssm" else 2
    per_sample = shape.seq_len * cfg.d_model * act_bytes * cfg.n_layers
    mb = 1
    while mb < b_loc and (b_loc // mb) * per_sample > budget_bytes:
        mb *= 2
    return mb


def make_lowering_spec(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       *, microbatches: int | None = None) -> LoweringSpec:
    meta = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "mesh": _sizes(mesh),
    }

    if shape.kind == "train":
        from repro_torch.train.loop import _stacked_state, make_train_step, train_shardings

        if microbatches is None:
            microbatches = microbatches_for(cfg, shape, mesh)
        meta["microbatches"] = microbatches
        opt_cfg = optimizer_config_from_model(cfg)
        params = lm_meta(cfg)
        p_sh, o_sh = train_shardings(cfg, mesh, opt_cfg)
        opt_init, _ = make_optimizer(opt_cfg)
        state = opt_init(lm_stacked(cfg, params, stack_meta) if _stacked_state(opt_cfg)
                         else params)
        batch, b_sh = _batch_structs(cfg, shape, mesh, microbatches)
        sharded = isinstance(mesh, Mesh) and mesh.size > 1
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                               mesh=mesh if sharded else None)
        return LoweringSpec(
            name=f"{cfg.name}:{shape.name}:train_step",
            fn=step,
            args=(params, state, batch),
            in_shardings=(p_sh, o_sh, b_sh),
            out_shardings=(p_sh, o_sh, None),
            meta=meta,
            donate=(0, 1),
        )

    params = lm_meta(cfg)
    p_sh = tree_shardings(lm_axes(cfg), mesh, params, mode="decode")
    cache, c_sh = _cache_structs(cfg, shape, mesh)
    b = shape.global_batch
    logits_sh = sharding_for(("batch", None), mesh, (b, cfg.vocab_size))
    # A rank of a mesh of several serves tensor-parallel on its pieces.
    ambient = mesh if isinstance(mesh, Mesh) and mesh.size > 1 else None

    if shape.kind == "prefill":
        batch, b_sh = _batch_structs(cfg, shape, mesh)

        def prefill_step(params, tokens, cache, memory=None):
            with use_mesh(ambient):
                return lm_prefill(cfg, params, tokens, cache, memory=memory)

        args = [params, batch["tokens"], cache]
        in_sh = [p_sh, b_sh["tokens"], c_sh]
        if cfg.frontend == "vision":
            args.append(batch["memory"])
            in_sh.append(b_sh["memory"])
        return LoweringSpec(
            name=f"{cfg.name}:{shape.name}:prefill_step",
            fn=prefill_step,
            args=tuple(args),
            in_shardings=tuple(in_sh),
            out_shardings=(logits_sh, c_sh),
            meta=meta,
        )

    if shape.kind == "decode":
        def serve_step(params, token, cache, pos):
            with use_mesh(ambient):
                return lm_decode(cfg, params, token, cache, pos)

        # ``pos`` is the Python int ``lm_decode`` takes: the cell's last
        # position (the JAX spec's is a traced int32 scalar).
        return LoweringSpec(
            name=f"{cfg.name}:{shape.name}:serve_step",
            fn=serve_step,
            args=(params, _meta((b,), torch.int32), cache, shape.seq_len - 1),
            in_shardings=(p_sh, sharding_for(("batch",), mesh, (b,)), c_sh, None),
            out_shardings=(logits_sh, c_sh),
            meta=meta,
        )

    raise ValueError(shape.kind)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta-device stand-ins for every model input of the cell (without
    placements; see :func:`make_lowering_spec` for those). The cache is
    the port's, one entry per layer (:func:`~repro_torch.models.build_cache`)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.frontend == "audio":
            out = {"tokens": _meta((b, s, cfg.d_model), torch.float32)}
        else:
            out = {"tokens": _meta((b, s), torch.int32)}
        out["labels"] = _meta((b, s), torch.int32)
        if cfg.frontend == "vision":
            out["memory"] = _meta((b, cfg.num_media_tokens, cfg.d_model), torch.float32)
        return out
    if shape.kind == "prefill":
        out = input_specs(cfg, dataclasses.replace(shape, kind="train"))
        out.pop("labels")
        out["cache"] = build_cache(cfg, b, s, device=META)
        return out
    if shape.kind == "decode":
        return {
            "token": _meta((b,), torch.int32),
            "cache": build_cache(cfg, b, s, device=META),
            "pos": s - 1,  # the Python int lm_decode takes
        }
    raise ValueError(shape.kind)
