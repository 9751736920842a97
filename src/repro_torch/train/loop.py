"""LM training loop: the train step, microbatch gradient accumulation,
preemption-safe checkpointing, step-time watchdog and loss monitors.

The port of ``repro/train/loop.py``, on one device or sharded over the
ranks of a :class:`~repro_torch.dist.sharding.Mesh` (``mesh=``), where
the JAX loop runs ``jit`` with shardings on a device mesh.

  * :func:`make_train_step` — ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``: the master weights are cast to
    ``cfg.compute_dtype`` inside the loss, ``microbatches`` gradients are
    accumulated in float32, then the global-norm clip and the optimizer.
    The clip and the update are written IN PLACE into the gradient,
    parameter and moment tensors, leaf by leaf (a leaf past
    ``optim.SLICE_ELEMENTS`` one slice at a time), as the JAX step donates
    its buffers: a model at published widths then needs one copy of its
    state, not two, and no float32 copy of a bfloat16 leaf. A caller that
    keeps a reference to a parameter across a step sees it change; the
    loss monitor therefore snapshots to the host (``snapshot_state=True``).
  * On a mesh (ZeRO-3 / FSDP storage; data-, tensor- and expert-parallel
    compute): a rank holds its piece of every parameter, gradient and
    moment, placed by the JAX logical-axis rules (:func:`train_shardings`:
    ``fsdp`` and ``batch`` fold the data axes,
    ``heads``/``kv_heads``/``mlp``/``experts``/``vocab`` take ``model``;
    no parameter has a ``kv_seq`` axis, so these are serving's decode-mode
    placements too), and computes its rows of the GLOBAL batch and its
    ``model`` share of them, as the JAX package's GSPMD step does: each
    block gathers its leaves' data-axis pieces inside its checkpointed
    function (``gather_param``: cast first, so the wire carries the compute
    dtype) and computes its heads, kv heads, ``mlp``, RG-LRU width and
    experts where ``model`` splits them, a replicated branch whole
    (``models/lm.py``, as serving runs); the logits stay split by
    vocabulary into a vocabulary-parallel loss (``token_nll_sharded``);
    the backward sums each gradient over the data axes. The loss is the
    global batch's: the valid-token count is summed over the data ranks
    (never over ``model``), and each rank back-propagates ``nll_r / count
    + 0.01 * aux / dp``.
  * :func:`train` — resume from the latest COMMITted checkpoint
    (:class:`~repro_torch.checkpoint.CheckpointManager`; on a mesh,
    re-sharded onto whatever mesh this run built), async saves every
    ``ckpt_every`` steps and a final synchronous one, a synchronous save on
    SIGTERM before it returns (on a mesh the flag is agreed every step, so
    every rank saves the same step), and the loss-health monitor under
    ``checkpoint-then-abort``.

Like the JAX ``train()``, the loop never calls ``reduce_gradients``, and
``TrainConfig.grad_compression`` is carried and unused.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import statistics
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (
    NamedSharding,
    _entry_axes,
    _is_axes_leaf,
    all_reduce,
    data_axes_of,
    shard_param,
    spec_for,
    tree_shardings,
    use_mesh,
)
from repro_torch.models import layers as L
from repro_torch.models.lm import (
    build_lm,
    lm_axes,
    lm_draw_order,
    lm_forward_train,
    lm_leaf_groups,
    lm_loss,
    lm_meta,
    lm_params,
    lm_stacked,
    lm_tree,
    stack_axes,
    stack_meta,
    token_nll,
    token_nll_sharded,
)
from repro_torch.obs import events, metrics
from repro_torch.obs.health import HealthMonitor
from repro_torch.optim.optimizers import (
    OptimizerConfig,
    clip_in_place,
    make_optimizer,
    opt_state_axes,
    optimizer_config_from_model,
    update_in_place,
)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1            # gradient accumulation
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = ""
    keep_last: int = 3
    watchdog_factor: float = 3.0     # flag steps slower than factor * median
    grad_compression: str = "none"   # none | bf16 (cross-pod reduce; carried, unused, as in JAX)
    spike_factor: float = 5.0        # flag losses above factor * running median
    health_every: int = 0            # probe loss health every N steps (0 = off)
    health_policy: str = "abort"     # warn | abort | checkpoint-then-abort


def _stacked_state(opt_cfg: OptimizerConfig) -> bool:
    """Whether the optimizer's state takes the JAX package's stacked LM
    layout (:func:`~repro_torch.models.lm.lm_stacked`). AdamW's moments are
    elementwise, so its per-layer state updates exactly as the stacked one
    does; Adafactor couples the layers of a scanned leaf (it factors by the
    stacked shape and clips the update over the whole leaf), so its state
    is kept stacked and each update sees the stacked leaf."""
    return opt_cfg.name == "adafactor"


def _leaf_groups(cfg: ModelConfig, opt_cfg: OptimizerConfig, tree: Any) -> list:
    """The tree's tensors that each optimizer state leaf updates, in the
    state's flatten order: ``(tensors, stacked)`` pairs."""
    if _stacked_state(opt_cfg):
        return lm_leaf_groups(cfg, tree)
    return [([t], False) for t in tree_flatten(tree)[0]]


def _saveable(state: Any) -> Any:
    """``state`` as the checkpoint store takes it: bfloat16 leaves (arctic's
    parameters, qwen3-moe's moments) widened to float32 on the host, which
    is exact; restoring into the bfloat16 template casts them back bit for
    bit. (On a mesh the store widens each gathered leaf itself.)"""
    return tree_map(lambda t: t.to("cpu", torch.float32)
                    if isinstance(t, Tensor) and t.dtype == torch.bfloat16 else t, state)


def _to_device(batch: Any, device) -> Any:
    return tree_map(lambda a: torch.as_tensor(a).to(device), batch)


def train_shardings(cfg: ModelConfig, mesh, opt_cfg: OptimizerConfig | None = None):
    """``(param shardings, state shardings)`` of ``cfg``'s training state on
    ``mesh``: the parameters in :func:`~repro_torch.models.lm.lm_params`'s
    per-layer layout by :func:`~repro_torch.models.lm.lm_axes`, the state
    by :func:`~repro_torch.optim.opt_state_axes` in the state's layout
    (stacked for Adafactor, :func:`_stacked_state`), every spec from the
    GLOBAL shapes (a layer's spec is its stacked leaf's, less the leading
    ``layers`` entry, which the rules never shard)."""
    opt_cfg = opt_cfg or optimizer_config_from_model(cfg)
    axes, meta = lm_axes(cfg), lm_meta(cfg)
    p_sh = tree_shardings(axes, mesh, meta)
    if _stacked_state(opt_cfg):
        axes = lm_stacked(cfg, axes, stack_axes, is_leaf=_is_axes_leaf)
        meta = lm_stacked(cfg, meta, stack_meta)
    opt_init, _ = make_optimizer(opt_cfg)
    state_meta = opt_init(meta)
    return p_sh, tree_shardings(opt_state_axes(opt_cfg, axes, meta), mesh, state_meta)


def _group_shardings(cfg: ModelConfig, opt_cfg: OptimizerConfig, p_sh: Any) -> list:
    """Each state leaf's parameter placement, stacked where the state keeps
    the leaf stacked (a leading ``None``)."""
    return [NamedSharding(shs[0].mesh, (None,) + shs[0].spec) if stacked else shs[0]
            for shs, stacked in _leaf_groups(cfg, opt_cfg, p_sh)]


def _rows(x: Tensor, mesh, dim: int) -> Tensor:
    """This rank's rows (dim ``dim``) of a global batch tensor: its block
    under ``spec_for(("batch", ...))``, as the JAX ``batch_sharding`` places
    it. Raises unless the batch splits over every data axis (a replicated
    batch would count its rows on several data ranks)."""
    ax = (None,) * dim + ("batch",) + (None,) * (x.ndim - dim - 1)
    spec = spec_for(ax, mesh, x.shape)
    missing = [a for a in data_axes_of(mesh) if a not in _entry_axes(spec[dim])]
    if missing:
        raise ValueError(f"batch dim {dim} of {tuple(x.shape)} does not split over the data "
                         f"axes {missing} of mesh {mesh.shape}")
    return shard_param(x, mesh, spec)


def _data_sum(x: Tensor, mesh) -> Tensor:
    """``x`` summed over the data ranks (no gradient)."""
    dp = data_axes_of(mesh)
    return all_reduce(x, dist.ReduceOp.SUM, mesh, mesh.axis_group(dp)) if dp else x


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1, mesh=None) -> Callable:
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``params`` is an LM parameter tree
    (:func:`~repro_torch.models.lm.lm_params`), updated in place; ``batch``
    ``{"tokens", "labels"}`` (B, S) (``"tokens"`` frames (B, S, D) for the
    audio frontend; ``"memory"`` (B, M, D) optionally, for vision), or
    (mb, B/mb, ...) with ``microbatches`` > 1
    (:func:`shape_for_microbatches`), numpy or tensors. On a ``mesh``
    the trees hold this rank's pieces (:func:`init_train_state`) and
    ``batch`` is the GLOBAL batch: each rank takes its rows (dim 1 of a
    microbatched one), and the metrics are the global batch's."""
    cdt = getattr(torch, cfg.compute_dtype)
    p_sh = sh_leaves = group_sh = None  # one device: whole tensors
    if mesh is not None:
        p_sh = train_shardings(cfg, mesh, opt_cfg)[0]
        sh_leaves = tree_leaves(p_sh)
        group_sh = _group_shardings(cfg, opt_cfg, p_sh)
        dp = math.prod(mesh.axis_size(a) for a in data_axes_of(mesh))

    def value_and_grad(leaves, treedef, mb):
        work = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        if mesh is None:
            # Master-weight cast inside the loss, as in the JAX package: the
            # gradients come back to the float32 masters through the cast.
            params_c = tree_unflatten(treedef, [p.to(cdt) if p.is_floating_point() else p
                                                for p in work])
            loss, aux = lm_loss(cfg, params_c, mb)
            objective = loss
        else:
            with use_mesh(mesh):
                logits, moe_aux = lm_forward_train(cfg, tree_unflatten(treedef, work),
                                                   mb["tokens"], memory=mb.get("memory"),
                                                   shardings=p_sh)
            if logits.shape[-1] < cfg.vocab_size:  # this rank's vocabulary columns
                nll, count = token_nll_sharded(logits, mb["labels"], mesh)
            else:
                nll, count = token_nll(logits, mb["labels"])
            denom = _data_sum(count, mesh).clamp_min(1)
            mine = nll / denom
            # mean_over's backward takes the objective as the SUM of every
            # data rank's: the aux term enters once over them all.
            objective = mine + 0.01 * moe_aux / dp
            glob = _data_sum(mine.detach(), mesh)
            loss = glob + 0.01 * moe_aux.detach()
            aux = {"loss": glob, "aux_loss": moe_aux, "ntokens": denom}
        # A leaf the loss never reads (the audio frontend's ``embed``) gets a
        # zero gradient, as JAX gives it.
        grads = torch.autograd.grad(objective, [p for p in work if p.requires_grad],
                                    allow_unused=True)
        it = iter(grads)

        def grad_of(p):
            g = next(it) if p.requires_grad else None
            # Contiguous: the clip and the update write into them in place.
            return torch.zeros_like(p) if g is None else g.contiguous()

        return loss.detach(), aux, [grad_of(p) for p in work]

    def local(batch):
        if mesh is None:
            return batch
        return {k: _rows(v, mesh, 1 if microbatches > 1 else 0) for k, v in batch.items()}

    def train_step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        batch = local(_to_device(batch, leaves[0].device))
        if microbatches > 1:
            gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            lacc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(microbatches):
                loss_i, _, g = value_and_grad(leaves, treedef,
                                              {k: v[i] for k, v in batch.items()})
                for a, b in zip(gacc, g):
                    a.add_(b)
                del g
                lacc = lacc + loss_i
            grads = [g.div_(microbatches) for g in gacc]
            loss = lacc / microbatches
            metrics_aux = {}
        else:
            loss, metrics_aux, grads = value_and_grad(leaves, treedef, batch)
        gnorm = clip_in_place(grads, opt_cfg.grad_clip, sh_leaves)
        opt_state = update_in_place(opt_cfg, opt_state, _leaf_groups(cfg, opt_cfg, params),
                                    _leaf_groups(cfg, opt_cfg, tree_unflatten(treedef, grads)),
                                    group_sh)
        del grads
        out = {"loss": loss, "grad_norm": gnorm}
        out.update({k: v.detach() for k, v in metrics_aux.items() if k != "loss"})
        return params, opt_state, out

    return train_step


def init_train_state(cfg: ModelConfig, device=None, seed: int = 0, mesh=None):
    """``(params, opt_state)`` of ``cfg`` on ``device`` (``None``: the mesh's
    device, or the card): the weights :func:`~repro_torch.models.build_lm`
    draws from ``seed`` and the optimizer the config names, freshly
    initialised (in the stacked layout for Adafactor,
    :func:`_stacked_state`). On a ``mesh`` each tree holds this rank's
    pieces (:func:`train_shardings`): every leaf is drawn whole from the
    same generator stream, so the weights are one device's, and cut to its
    piece at once, so no rank holds two whole leaves or the whole tree."""
    opt_cfg = optimizer_config_from_model(cfg)
    opt_init, _ = make_optimizer(opt_cfg)
    if mesh is not None:
        dev = mesh.device if device is None else resolve_device(device)
        p_sh, o_sh = train_shardings(cfg, mesh, opt_cfg)
        sh_leaves = tree_leaves(p_sh)
        order = iter(lm_draw_order(cfg))
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = lm_tree(cfg, L.Init(gen, L.dt(cfg), dev,
                                     place=lambda t: sh_leaves[next(order)].piece(t)))
        meta = lm_meta(cfg)
        if _stacked_state(opt_cfg):
            meta = lm_stacked(cfg, meta, stack_meta)
        state = tree_map(lambda sh, t: torch.zeros(sh.piece_shape(t.shape), dtype=t.dtype,
                                                   device=dev),
                         o_sh, opt_init(meta))
        return params, state
    dev = resolve_device(device)
    params = tree_map(lambda p: p.detach(), lm_params(build_lm(cfg, seed, device=dev)))
    if not _stacked_state(opt_cfg):
        return params, opt_init(params)
    # The state's shapes from the stacked layout's, then zeros on the device.
    meta = lm_stacked(cfg, params, stack_meta)
    return params, tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                            opt_init(meta))


def shape_for_microbatches(batch: Any, microbatches: int) -> Any:
    """Host-side reshape ``(B, ...) -> (mb, B/mb, ...)``."""
    if microbatches <= 1:
        return batch
    return tree_map(
        lambda t: t.reshape((microbatches, t.shape[0] // microbatches) + tuple(t.shape[1:])),
        batch)


class SpikeDetector:
    """Flags loss spikes through ``repro_torch.obs``: a loss is a spike when
    it is non-finite, or exceeds ``factor`` x the running median of the last
    ``window`` recorded losses (after ``warmup`` steps — the first losses
    of a fresh run legitimately swing). Every spike bumps the
    ``train.loss_spikes`` counter and records a structured
    ``train.loss_spike`` event carrying step/loss/threshold. Finite spikes
    still enter the history, so a genuine regime change re-centres the
    median instead of flagging forever. The median is
    ``statistics.median``, equal to the JAX package's ``np.median`` on
    float64 values; a first ``np.median`` imports ``numpy.ma``, which
    stalls the step that first reaches it."""

    def __init__(self, factor: float = 5.0, warmup: int = 5, window: int = 50):
        self.factor = factor
        self.warmup = warmup
        self.window = window
        self.losses: list[float] = []
        self.spikes: list[tuple[int, float]] = []

    def record(self, step: int, loss: float) -> bool:
        loss = float(loss)
        finite = math.isfinite(loss)
        threshold = None
        spike = not finite
        if finite and len(self.losses) > self.warmup:
            med = statistics.median(self.losses[-self.window:])
            if med > 0:
                threshold = self.factor * med
                spike = loss > threshold
        if finite:
            self.losses.append(loss)
        if spike:
            self.spikes.append((step, loss))
            metrics.inc("train.loss_spikes")
            events.record("train.loss_spike", step=step, loss=loss,
                          threshold=threshold, factor=self.factor)
        return spike


class StepWatchdog:
    """Flags steps slower than ``factor`` x the running median of the last
    50 (a straggler / interference signal for the cluster layer). The
    median is ``statistics.median``, as in :class:`SpikeDetector`."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        med = statistics.median(self.times[-50:])
        if dt > self.factor * med:
            self.flagged.append((step, dt))
            return True
        return False


def train(cfg: ModelConfig, train_cfg: TrainConfig, dataset, *, mesh=None, device=None,
          seed: int = 0, log_fn: Callable[[str], Any] = print):
    """End-to-end training driver (used by ``examples/torch_train_lm.py``):
    returns ``(params, opt_state, history)``, one history entry a step run.
    On a ``mesh`` every rank calls it (SPMD): the state is this rank's
    pieces, checkpoints are written whole by rank 0 and re-sharded onto
    this run's mesh at a resume, and the loss and SIGTERM are the mesh's."""
    from repro_torch.checkpoint.store import (
        CheckpointManager,
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    opt_cfg = optimizer_config_from_model(cfg)
    params, opt_state = init_train_state(cfg, device, seed, mesh)
    shardings = train_shardings(cfg, mesh, opt_cfg) if mesh is not None else None

    def saveable(state):
        return state if mesh is not None else _saveable(state)

    start_step = 0
    manager = None
    if train_cfg.ckpt_dir:
        manager = CheckpointManager(train_cfg.ckpt_dir, keep_last=train_cfg.keep_last,
                                    mesh=mesh)
        last = latest_step(train_cfg.ckpt_dir)
        if last is not None:
            (params, opt_state), extra = restore_checkpoint(
                train_cfg.ckpt_dir, last, (params, opt_state), shardings=shardings)
            start_step = int(extra.get("step", last)) + 1
            log_fn(f"[train] restored step {last}, resuming at {start_step}")

    def save(step):
        manager.save_async(step, saveable((params, opt_state)), {"step": step},
                           shardings=shardings)

    mb = train_cfg.microbatches
    step_fn = make_train_step(cfg, opt_cfg, microbatches=mb, mesh=mesh)

    # Preemption handling: SIGTERM -> synchronous save + return.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    def stop() -> bool:
        """Whether any rank was sent SIGTERM (a max over the mesh each step:
        a rank that stopped alone would leave the others blocked in their
        next collective)."""
        if mesh is None:
            return preempted["flag"]
        flag = torch.tensor(float(preempted["flag"]),
                            device="cpu" if mesh.backend == "gloo" else mesh.device)
        return bool(all_reduce(flag, dist.ReduceOp.MAX, mesh).item())

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    watchdog = StepWatchdog(train_cfg.watchdog_factor)
    spike_det = SpikeDetector(train_cfg.spike_factor)
    monitor = None
    if train_cfg.health_every > 0:
        # Loss-health probe on cadence: a NaN/Inf loss halts the run within
        # health_every steps. Under checkpoint-then-abort the LAST HEALTHY
        # (params, opt_state) is committed before the raise. The loss is the
        # global batch's, so every rank decides alike.
        ckpt_fn = None
        if train_cfg.health_policy == "checkpoint-then-abort":
            if not train_cfg.ckpt_dir:
                raise ValueError("health_policy='checkpoint-then-abort' needs ckpt_dir")

            def ckpt_fn(s, state):
                return save_checkpoint(train_cfg.ckpt_dir, s, saveable(state),
                                       {"step": s, "reason": "health-abort"},
                                       shardings=shardings)
        monitor = HealthMonitor(
            cadence=train_cfg.health_every,
            policy=train_cfg.health_policy,
            name="train.loss",
            checkpoint_fn=ckpt_fn,
            # The step updates (params, opt_state) in place: the tensors a
            # probe retains hold the next step's values unless copied now.
            snapshot_state=True,
            log_fn=log_fn,
        )
    history = []
    try:
        for step in range(start_step, train_cfg.steps):
            t0 = time.perf_counter()
            batch = shape_for_microbatches(dataset.batch_at(step), mb)
            params, opt_state, step_metrics = step_fn(params, opt_state, batch)
            loss = float(step_metrics["loss"])
            dt = time.perf_counter() - t0
            slow = watchdog.record(step, dt)
            spiked = spike_det.record(step, loss)
            if monitor is not None:
                monitor.check(step, loss, state=(params, opt_state))
            history.append({"step": step, "loss": loss, "dt": dt})
            if step % train_cfg.log_every == 0 or slow or spiked:
                flag = (" [SLOW-STEP]" if slow else "") + (" [LOSS-SPIKE]" if spiked else "")
                log_fn(f"[train] step {step} loss {loss:.4f} "
                       f"gnorm {float(step_metrics['grad_norm']):.3f} {dt*1e3:.0f}ms{flag}")
            if manager and step and step % train_cfg.ckpt_every == 0:
                save(step)
            if stop():
                log_fn(f"[train] SIGTERM at step {step}: sync checkpoint + exit")
                if manager:
                    manager.wait()
                    save(step)
                    manager.wait()
                break
        else:
            if manager:
                manager.wait()
                save(train_cfg.steps - 1)
                manager.wait()
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    return params, opt_state, history
