"""Variational data assimilation on the IR: fit a coefficient field.

The PyTorch counterpart of ``repro/train/assimilate.py``, the end-to-end
consumer of the derived adjoints (:mod:`repro_torch.ir.autodiff`): recover
``hdiff_coupled_program``'s spatially-varying diffusion coefficient from
observations of the diffused state. The forward model is a
``build_backend(..., differentiable=True)`` lowering — ``cuda`` by default,
so on the card every step is the generated kernel (K2) forward, then the
augmented forward and the adjoint, one launch a sweep each; ``reference``
and ``staged`` run eagerly. The optimizer is the port's
:mod:`repro_torch.optim` stack with every loss through a
:class:`~repro_torch.train.loop.SpikeDetector`.

The 3D-Var-style setup: observations ``y = M(u0, c*)`` of a known prior
state ``u0`` under the true coefficients ``c*``; minimise ``J(c) = mean((M(
u0, c) - y)^2)`` from a flat first guess. The coefficient only enters at
interior points (the boundary ring passes through), so ring gradients are
exactly zero and the ring keeps its first-guess values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.ir.graph import repeat
from repro_torch.ir.lower_batched import build_backend
from repro_torch.ir.programs import hdiff_coupled_program
from repro_torch.optim import OptimizerConfig, clip_by_global_norm, make_optimizer
from repro_torch.train.loop import SpikeDetector

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AssimilationConfig:
    """One coefficient-field fit.

    ``backend`` chooses the differentiable lowering of the forward model
    (``reference``, ``staged`` or ``cuda``; the sharded backends are
    ROADMAP M9); ``k`` temporally blocks it
    (``repeat(p, k)``: the observation operator spans k sweeps and the
    adjoint reverses all of them)."""

    steps: int = 80
    learning_rate: float = 3e-3
    optimizer: str = "adamw"
    grad_clip: float = 1.0
    backend: str = "cuda"
    k: int = 1
    limit: bool = True


@dataclasses.dataclass
class FitResult:
    coeff: Tensor
    losses: list[float]
    spikes: list[tuple[int, float]]

    @property
    def loss_ratio(self) -> float:
        """First-to-best loss improvement factor (the acceptance metric)."""
        return self.losses[0] / min(self.losses)


def forward_model(cfg: AssimilationConfig) -> Callable:
    """The differentiable observation operator ``{u, coeff} -> u_k``."""
    p = hdiff_coupled_program(limit=cfg.limit)
    if cfg.k > 1:
        p = repeat(p, cfg.k)
    return build_backend(p, cfg.backend, differentiable=True)


def synthetic_observations(u0: Tensor, coeff_true: Tensor, cfg: AssimilationConfig) -> Tensor:
    """Noise-free observations of the true-coefficient forward model."""
    return forward_model(cfg)({"u": u0, "coeff": coeff_true})


def true_coefficients(shape: Sequence[int], seed: int = 0, device=None) -> Tensor:
    """The Smagorinsky-style target field (the formula of
    :func:`repro_torch.ir.programs.smagorinsky_coeff`: 0.025 modulated by
    +-25 % through tanh of unit noise), drawn on ``device`` (``None``: the
    card) from a ``torch.Generator`` seeded with ``seed``. The JAX package
    draws its noise from ``jax.random``, which this cannot reproduce: to
    compare the two, feed both the same numpy field."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(tuple(shape), generator=gen, device=dev)
    return 0.025 * (1.0 + 0.25 * torch.tanh(noise))


def fit_coefficient_field(
    u0: Tensor,
    observations: Tensor,
    cfg: AssimilationConfig = AssimilationConfig(),
    coeff_init: Tensor | None = None,
) -> FitResult:
    """Minimise the observation misfit over the coefficient field.

    Plain full-batch gradient descent: ``loss.backward()`` through the
    differentiable lowering (the derived adjoint sweeps), global-norm clip,
    AdamW/Adafactor update, every loss through a :class:`SpikeDetector`.
    Runs where ``u0`` lives; reading each loss synchronises the card once a
    step, as the JAX package's ``float(loss)`` does."""
    fwd = forward_model(cfg)
    if coeff_init is None:
        coeff_init = torch.full_like(u0, 0.025)
    opt_cfg = OptimizerConfig(
        name=cfg.optimizer,
        learning_rate=cfg.learning_rate,
        weight_decay=0.0,  # shrinking coefficients toward 0 is not a prior
        grad_clip=cfg.grad_clip,
        warmup_steps=0,
        total_steps=cfg.steps,
    )
    init_fn, update_fn = make_optimizer(opt_cfg)
    coeff = coeff_init
    state = init_fn(coeff)
    detector = SpikeDetector()
    losses: list[float] = []
    for step in range(cfg.steps):
        leaf = coeff.detach().requires_grad_(True)
        loss = torch.mean(torch.square(fwd({"u": u0, "coeff": leaf}) - observations))
        loss.backward()
        losses.append(float(loss.detach()))
        detector.record(step, losses[-1])
        grad, _gnorm = clip_by_global_norm(leaf.grad, cfg.grad_clip)
        coeff, state = update_fn(grad, state, coeff)
    return FitResult(coeff=coeff, losses=losses, spikes=detector.spikes)
