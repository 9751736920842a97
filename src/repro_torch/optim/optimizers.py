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
model config's training defaults and :func:`opt_state_axes` gives the
state's logical axes (the parameters' own, so FSDP shards the moments as it
shards the weights), as in the JAX package.

The LM trainer updates in place (:func:`clip_in_place`,
:func:`update_in_place`), each state leaf with its group of parameter
tensors, where each tensor may be a rank's piece of the leaf
(:class:`~repro_torch.dist.sharding.NamedSharding`) and a leaf past
:data:`SLICE_ELEMENTS` goes one leading-dim slice at a time, so no float32
copy of a whole leaf is made. AdamW is elementwise: its pieces and slices
give the whole leaf's bits. Adafactor's row and column means, the update
RMS and the global norm become sums over slices, then over the ranks
holding the other pieces; a leaf that is whole and under the budget
updates as the tree functions above do, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_map_split, tree_unflatten

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


def opt_state_axes(cfg: OptimizerConfig, param_axes: Any, params_abstract: Any) -> Any:
    """Logical axes for the optimizer state, mirroring the parameters' axes
    so FSDP shards the moments as it shards the weights.
    ``params_abstract`` (tensors, meta ones included, of the GLOBAL shapes)
    tells factored from full Adafactor leaves."""
    from repro_torch.dist.sharding import _is_axes_leaf

    if cfg.name == "adamw":
        return AdamWState((), param_axes, param_axes)
    if cfg.name == "adafactor":
        def vr_ax(ax, p):
            return ax[:-1] if _factored(p, cfg.factored_threshold) else ax

        def vc_ax(ax, p):
            return ax[:-2] + ax[-1:] if _factored(p, cfg.factored_threshold) else (None,)

        axes, treedef = tree_flatten(param_axes, is_leaf=_is_axes_leaf)
        shapes = tree_leaves(params_abstract)
        if len(shapes) != len(axes):
            raise ValueError(f"{len(axes)} axes leaves for {len(shapes)} parameters")
        return AdafactorState((), tree_unflatten(treedef, [vr_ax(a, p) for a, p in zip(axes, shapes)]),
                              tree_unflatten(treedef, [vc_ax(a, p) for a, p in zip(axes, shapes)]))
    raise ValueError(cfg.name)


# ---------------------------------------------------------------------------
# In-place updates on pieces and slices (the LM trainer's).
# ---------------------------------------------------------------------------

# A tensor of more elements than this is clipped, summed into the global
# norm and updated one leading-dim slice at a time (an expert, a block of
# embedding rows), so its float32 temporaries stay a slice's: an arctic
# expert stack is 4.46 G elements, 17.85 GB as one float32 copy.
SLICE_ELEMENTS = 1 << 26


def _slices(tensors: list, stacked: bool) -> list:
    """``(index, view)`` pairs that cover one leaf held as ``tensors`` (its
    layers when ``stacked``, else one tensor). ``index`` is a tuple of
    slices over the stacked leaf's leading dims and ``view`` the matching
    view of a tensor, with those dims kept (size 1 for a layer)."""
    out = []
    for i, t in enumerate(tensors):
        lead = (slice(i, i + 1),) if stacked else ()
        v = t.unsqueeze(0) if stacked else t
        if t.numel() <= SLICE_ELEMENTS or t.ndim < 2:
            out.append((lead, v))
            continue
        step = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
        for a in range(0, t.shape[0], step):
            b = min(t.shape[0], a + step)
            out.append((lead + (slice(a, b),), v[:, a:b] if stacked else v[a:b]))
    return out


def _sum_over(x: Tensor, sharding, axes) -> Tensor:
    """``x`` summed over the ranks of ``axes`` (none: as it is)."""
    from repro_torch.dist.sharding import all_reduce

    axes = tuple(a for a in axes if sharding.mesh.axis_size(a) > 1) if sharding else ()
    if not axes:
        return x
    mesh = sharding.mesh
    return all_reduce(x, torch.distributed.ReduceOp.SUM, mesh, mesh.axis_group(axes))


def clip_in_place(grads: list, max_norm: float, shardings: list | None = None) -> Tensor:
    """Scales ``grads`` (a list of tensors) in place so that their global L2
    norm is at most ``max_norm``; returns the norm. The clip writes the
    bits :func:`clip_by_global_norm` gives. With ``shardings`` (one
    :class:`~repro_torch.dist.sharding.NamedSharding` a tensor) each tensor
    is this rank's piece: its float32 sum of squares is divided by its
    replica count, and one sum over the mesh adds every rank's."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for i, g in enumerate(grads):
        sq = sum(torch.sum(torch.square(v.to(torch.float32))) for _, v in _slices([g], False))
        total = total + (sq / shardings[i].replicas if shardings else sq)
    if shardings:
        from repro_torch.dist.sharding import all_reduce

        total = all_reduce(total, torch.distributed.ReduceOp.SUM, shardings[0].mesh)
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in grads:
            for _, v in _slices([g], False):
                v.copy_((v.to(torch.float32) * scale).to(v.dtype))
    return gnorm


def _adamw_leaf(cfg: OptimizerConfig, state: AdamWState, ps: list, gs: list, ms: Tensor,
                vs: Tensor) -> None:
    """One AdamW leaf (one tensor, never stacked) in place, slice by slice:
    elementwise, so its bits are the whole leaf's."""
    for (_, p), (_, g), (_, m), (_, v) in zip(*(_slices(t, False) for t in (ps, gs, [ms], [vs]))):
        new_p, new_s = adamw_update(cfg, g, AdamWState(state.step, m, v), p)
        p.copy_(new_p)
        m.copy_(new_s.mu)
        v.copy_(new_s.nu)


def _adafactor_whole(cfg, state, ps, gs, stacked, vr, vc) -> None:
    """One Adafactor leaf, whole and under the budget: the tree update on
    the stacked leaf (the JAX package's layout), copied back."""
    p, g = (torch.stack(ps), torch.stack(gs)) if stacked else (ps[0], gs[0])
    new_p, new_s = adafactor_update(cfg, g, AdafactorState(state.step, vr, vc), p)
    for dst, src in zip(ps, new_p.unbind(0) if stacked else (new_p,)):
        dst.copy_(src)
    vr.copy_(new_s.vr)
    vc.copy_(new_s.vc)


def _adafactor_sliced(cfg, state, ps, gs, stacked, vr, vc, sharding) -> None:
    """One Adafactor leaf in place from its pieces (``sharding``, or None
    when the tensors are the whole leaf), slice by slice. The row and
    column means of ``g^2`` are sums over slices, then over the ranks that
    split the reduced dim, over the global length; so is the mean of ``vr``
    in the denominator; the update RMS is a first pass over slices and
    ranks, and a second pass scales and writes. ``vr``/``vc`` are written
    last, so each pass reads the step's old ones."""
    from repro_torch.dist.sharding import _entry_axes

    step = state.step + 1
    lr = schedule_lr(cfg, step)
    beta2 = 1.0 - step.to(torch.float32) ** (-0.8)
    eps = 1e-30
    f32 = torch.float32
    nd = (1 if stacked else 0) + ps[0].ndim
    local = ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
    shape = sharding.global_shape(local) if sharding else local
    spec = sharding.spec if sharding else (None,) * nd

    def axes(dim):
        return _entry_axes(spec[dim])

    g_slices, p_slices = _slices(gs, stacked), _slices(ps, stacked)
    factored = (len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2
                and math.prod(shape) >= cfg.factored_threshold)
    if factored:
        rows = torch.zeros(vr.shape, dtype=f32, device=vr.device)
        cols = torch.zeros(vc.shape, dtype=f32, device=vc.device)
        for ix, g in g_slices:
            g2 = torch.square(g.to(f32)) + eps
            rows[ix] += g2.sum(-1)
            cols[ix[:nd - 2]] += g2.sum(-2)
        rows = _sum_over(rows, sharding, axes(nd - 1))
        cols = _sum_over(cols, sharding, axes(nd - 2))
        vr32 = beta2 * vr.to(f32) + (1 - beta2) * (rows / shape[-1])
        vc32 = beta2 * vc.to(f32) + (1 - beta2) * (cols / shape[-2])
        vr_mean = torch.clamp(_sum_over(vr32.sum(-1), sharding, axes(nd - 2)) / shape[-2],
                              min=eps)
        del rows, cols

        def precond(ix, g):
            lead = ix[:nd - 2]
            denom = (vr32[ix][..., :, None] / vr_mean[lead][..., None, None]) \
                * vc32[lead][..., None, :]
            return g.to(f32) * torch.rsqrt(torch.clamp(denom, min=eps))
    else:
        def second(ix, g):
            return beta2 * vr[ix].to(f32) + (1 - beta2) * (torch.square(g.to(f32)) + eps)

        def precond(ix, g):
            return g.to(f32) * torch.rsqrt(torch.clamp(second(ix, g), min=eps))

    sq = torch.zeros((), dtype=f32, device=vr.device)
    for ix, g in g_slices:
        sq = sq + torch.sum(torch.square(precond(ix, g)))
    sq = _sum_over(sq, sharding, [a for d in range(nd) for a in axes(d)])
    rms = torch.clamp(torch.sqrt(sq / math.prod(shape) + eps), min=1.0)
    for (ix, g), (_, p) in zip(g_slices, p_slices):
        u = precond(ix, g) / rms
        p32 = p.to(f32)
        p.copy_((p32 - lr * (u + cfg.weight_decay * p32)).to(p.dtype))
        if not factored:
            vr[ix].copy_(second(ix, g).to(vr.dtype))
    if factored:
        vr.copy_(vr32.to(vr.dtype))
        vc.copy_(vc32.to(vc.dtype))


def update_in_place(cfg: OptimizerConfig, state, p_groups: list, g_groups: list,
                    shardings: list | None = None):
    """One optimizer step written into the parameters' and the state's own
    tensors; returns the state with its step advanced. ``p_groups`` and
    ``g_groups`` hold, for each leaf of the state in its flatten order,
    ``(tensors, stacked)``: the parameter's (gradient's) layers when the
    state keeps the leaf stacked, else one tensor. ``shardings`` (one a
    state leaf, the stacked parameter's placement) marks the tensors as a
    rank's pieces; ``None`` means whole tensors on one device."""
    fields = state._fields[1:]
    s_leaves = [tree_leaves(getattr(state, f)) for f in fields]
    with torch.no_grad():
        for i, ((ps, stacked), (gs, _)) in enumerate(zip(p_groups, g_groups)):
            sh = shardings[i] if shardings else None
            if cfg.name == "adamw":
                _adamw_leaf(cfg, state, ps, gs, s_leaves[0][i], s_leaves[1][i])
                continue
            vr, vc = s_leaves[0][i], s_leaves[1][i]
            whole = sh is None or sh.replicas == sh.mesh.size
            if whole and sum(t.numel() for t in ps) <= SLICE_ELEMENTS:
                _adafactor_whole(cfg, state, ps, gs, stacked, vr, vc)
            else:
                _adafactor_sliced(cfg, state, ps, gs, stacked, vr, vc, sh if not whole else None)
    return state._replace(step=state.step + 1)


def optimizer_config_from_model(model_cfg) -> OptimizerConfig:
    """The optimizer a model config names, with its training defaults."""
    return OptimizerConfig(
        name=model_cfg.optimizer,
        learning_rate=model_cfg.learning_rate,
        weight_decay=model_cfg.weight_decay,
        grad_clip=model_cfg.grad_clip,
        moment_dtype=model_cfg.moment_dtype,
    )
