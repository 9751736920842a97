"""Optimizers: AdamW (configurable moment dtypes) and Adafactor.

The PyTorch counterpart of ``repro/optim/optimizers.py``, written from the
reference's own formulas (not ``torch.optim``) so the two packages' loss
trajectories compare step for step. Parameters, gradients and moments are a
tensor or a tree of them (:mod:`repro_torch.tree`); every update is a pure
function that returns new tensors, as in the JAX package. All arithmetic is
float32 (the moments are stored in ``moment_dtype``), with the reference's
operand order.

Adafactor (Shazeer & Stern 2018) keeps a FACTORED second moment (row + col
vectors) and no first moment. :func:`optimizer_config_from_model` reads a
model config's training defaults, as in the JAX package. ``opt_state_axes``
(the optimizer state's logical sharding axes) has no counterpart while the
LM trainer runs on one device: it waits for the LM sharding slice (ROADMAP
M13b.3b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_map_split

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # adafactor
    factored_threshold: int = 2 * 128 * 128


def schedule_lr(cfg: OptimizerConfig, step: Tensor) -> Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, Tensor]:
    """``(grads scaled so their global L2 norm is at most max_norm, norm)``."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gnorm


def _first(tree) -> Tensor:
    return tree_leaves(tree)[0]


# ---------------------------------------------------------------------------
# AdamW.
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    step: Tensor
    mu: Any
    nu: Any


def adamw_init(cfg: OptimizerConfig, params: Any) -> AdamWState:
    mdt = getattr(torch, cfg.moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=_first(params).device)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return AdamWState(step, tree_map(zeros, params), tree_map(zeros, params))


def adamw_update(cfg: OptimizerConfig, grads: Any, state: AdamWState, params: Any):
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1**t
    bc2 = 1.0 - cfg.b2**t

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g32)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    new_p, new_m, new_v = tree_map_split(upd, 3, grads, state.mu, state.nu, params)
    return new_p, AdamWState(step, new_m, new_v)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment, update clipping).
# ---------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    step: Tensor
    vr: Any   # row second-moment (or full v for small/1D params)
    vc: Any   # col second-moment (or a (1,) sentinel)


def _factored(p: Tensor, threshold: int) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2 and p.numel() >= threshold


def adafactor_init(cfg: OptimizerConfig, params: Any) -> AdafactorState:
    mdt = getattr(torch, cfg.moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=_first(params).device)

    def vr_init(p):
        shape = p.shape[:-1] if _factored(p, cfg.factored_threshold) else p.shape
        return torch.zeros(shape, dtype=mdt, device=p.device)

    def vc_init(p):
        if _factored(p, cfg.factored_threshold):
            return torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=mdt, device=p.device)
        return torch.zeros((1,), dtype=mdt, device=p.device)

    return AdafactorState(step, tree_map(vr_init, params), tree_map(vc_init, params))


def adafactor_update(cfg: OptimizerConfig, grads: Any, state: AdafactorState, params: Any):
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    t = step.to(torch.float32)
    beta2 = 1.0 - t ** (-0.8)  # Shazeer-Stern decay schedule
    eps = 1e-30

    def upd(g, vr, vc, p):
        g32 = torch.square(g.to(torch.float32)) + eps
        if _factored(p, cfg.factored_threshold):
            vr32 = beta2 * vr.to(torch.float32) + (1 - beta2) * g32.mean(-1)
            vc32 = beta2 * vc.to(torch.float32) + (1 - beta2) * g32.mean(-2)
            denom = (
                vr32[..., :, None]
                / torch.clamp(vr32.mean(-1, keepdim=True), min=eps)[..., :, None]
            ) * vc32[..., None, :]
            precond = g.to(torch.float32) * torch.rsqrt(torch.clamp(denom, min=eps))
        else:
            vr32 = beta2 * vr.to(torch.float32) + (1 - beta2) * g32
            vc32 = vc.to(torch.float32)
            precond = g.to(torch.float32) * torch.rsqrt(torch.clamp(vr32, min=eps))
        # update clipping (RMS <= 1)
        rms = torch.sqrt(torch.mean(torch.square(precond)) + eps)
        precond = precond / torch.clamp(rms, min=1.0)
        new_p = p.to(torch.float32) - lr * (precond + cfg.weight_decay * p.to(torch.float32))
        return new_p.to(p.dtype), vr32.to(vr.dtype), vc32.to(vc.dtype)

    new_p, new_vr, new_vc = tree_map_split(upd, 3, grads, state.vr, state.vc, params)
    return new_p, AdafactorState(step, new_vr, new_vc)


# ---------------------------------------------------------------------------
# Uniform interface.
# ---------------------------------------------------------------------------


def make_optimizer(cfg: OptimizerConfig):
    """Returns (init_fn, update_fn). update(grads, state, params) ->
    (new_params, new_state)."""
    if cfg.name == "adamw":
        return (lambda p: adamw_init(cfg, p)), (lambda g, s, p: adamw_update(cfg, g, s, p))
    if cfg.name == "adafactor":
        return (lambda p: adafactor_init(cfg, p)), (lambda g, s, p: adafactor_update(cfg, g, s, p))
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def optimizer_config_from_model(model_cfg) -> OptimizerConfig:
    """The optimizer a model config names, with its training defaults."""
    return OptimizerConfig(
        name=model_cfg.optimizer,
        learning_rate=model_cfg.learning_rate,
        weight_decay=model_cfg.weight_decay,
        grad_clip=model_cfg.grad_clip,
        moment_dtype=model_cfg.moment_dtype,
    )
