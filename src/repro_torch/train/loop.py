"""LM training loop: the train step, microbatch gradient accumulation,
preemption-safe checkpointing, step-time watchdog and loss monitors.

The port of ``repro/train/loop.py`` on one device (a device takes the
mesh's place; data-parallel training over ranks waits for the LM sharding
slice, ROADMAP M13b.3b).

  * :func:`make_train_step` — ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``: the master weights are cast to
    ``cfg.compute_dtype`` inside the loss, ``microbatches`` gradients are
    accumulated in float32, then ``clip_by_global_norm`` and the optimizer.
    The update is written IN PLACE into the parameter and moment tensors,
    leaf by leaf, as the JAX step donates its buffers: a model at published
    widths then needs one copy of its f32 state, not two. A caller that
    keeps a reference to a parameter across a step sees it change; the
    loss monitor therefore snapshots to the host (``snapshot_state=True``).
  * :func:`train` — resume from the latest COMMITted checkpoint
    (:class:`~repro_torch.checkpoint.CheckpointManager`), async saves every
    ``ckpt_every`` steps and a final synchronous one, a synchronous save on
    SIGTERM before it returns, and the loss-health monitor under
    ``checkpoint-then-abort``.

Like the JAX ``train()``, the loop never calls ``reduce_gradients``.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import build_lm, lm_leaf_groups, lm_loss, lm_params, lm_stacked
from repro_torch.obs import events, metrics
from repro_torch.obs.health import HealthMonitor
from repro_torch.optim.optimizers import (
    OptimizerConfig,
    clip_by_global_norm,
    make_optimizer,
    optimizer_config_from_model,
)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

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
    grad_compression: str = "none"   # none | bf16 (cross-rank reduce; unused on one device)
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


def _update_in_place(update: Callable, p_groups: list, g_groups: list, state):
    """``update(grads, state, params)`` applied leaf by leaf of the state,
    each on its group of parameters and gradients (stacked when the group
    is, :func:`_leaf_groups`), the results copied into the parameters' own
    tensors and the state's; returns the state with its step advanced.
    Each leaf's arithmetic is the tree update's."""
    fields = state._fields[1:]
    s_leaves = [tree_flatten(getattr(state, f))[0] for f in fields]
    step = state.step
    with torch.no_grad():
        for i, ((ps, stacked), (gs, _)) in enumerate(zip(p_groups, g_groups)):
            one = type(state)(state.step, *(leaves[i] for leaves in s_leaves))
            p, g = (torch.stack(ps), torch.stack(gs)) if stacked else (ps[0], gs[0])
            new_p, new_s = update(g, one, p)
            for dst, src in zip(ps, new_p.unbind(0) if stacked else (new_p,)):
                dst.copy_(src)
            for leaves, f in zip(s_leaves, fields):
                leaves[i].copy_(getattr(new_s, f))
            step = new_s.step
    return state._replace(step=step)


def _saveable(state: Any) -> Any:
    """``state`` as the checkpoint store takes it: bfloat16 leaves (arctic's
    parameters, qwen3-moe's moments) widened to float32 on the host, which
    is exact; restoring into the bfloat16 template casts them back bit for
    bit."""
    return tree_map(lambda t: t.to("cpu", torch.float32)
                    if isinstance(t, Tensor) and t.dtype == torch.bfloat16 else t, state)


def _to_device(batch: Any, device) -> Any:
    return tree_map(lambda a: torch.as_tensor(a).to(device), batch)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1) -> Callable:
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``params`` is an LM parameter tree
    (:func:`~repro_torch.models.lm.lm_params`), updated in place; ``batch``
    ``{"tokens", "labels"}`` (B, S), or (mb, B/mb, S) with ``microbatches``
    > 1 (:func:`shape_for_microbatches`), numpy or tensors."""
    _, update = make_optimizer(opt_cfg)
    cdt = getattr(torch, cfg.compute_dtype)

    def value_and_grad(leaves, treedef, mb):
        work = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        # Master-weight cast inside the loss, as in the JAX package: the
        # gradients come back to the float32 masters through the cast.
        params_c = tree_unflatten(treedef, [p.to(cdt) if p.is_floating_point() else p
                                            for p in work])
        loss, aux = lm_loss(cfg, params_c, mb)
        grads = torch.autograd.grad(loss, [p for p in work if p.requires_grad])
        it = iter(grads)
        return loss.detach(), aux, [next(it) if p.requires_grad else torch.zeros_like(p)
                                    for p in work]

    def train_step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        batch = _to_device(batch, leaves[0].device)
        if microbatches > 1:
            gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            lacc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(microbatches):
                loss_i, _, g = value_and_grad(leaves, treedef,
                                              {k: v[i] for k, v in batch.items()})
                gacc = [a + b for a, b in zip(gacc, g)]
                lacc = lacc + loss_i
            grads = [g / microbatches for g in gacc]
            loss = lacc / microbatches
            metrics_aux = {}
        else:
            loss, metrics_aux, grads = value_and_grad(leaves, treedef, batch)
        grads, gnorm = clip_by_global_norm(tree_unflatten(treedef, grads), opt_cfg.grad_clip)
        opt_state = _update_in_place(update, _leaf_groups(cfg, opt_cfg, params),
                                     _leaf_groups(cfg, opt_cfg, grads), opt_state)
        out = {"loss": loss, "grad_norm": gnorm}
        out.update({k: v.detach() for k, v in metrics_aux.items() if k != "loss"})
        return params, opt_state, out

    return train_step


def init_train_state(cfg: ModelConfig, device=None, seed: int = 0):
    """``(params, opt_state)`` of ``cfg`` on ``device`` (``None``: the
    card): the weights :func:`~repro_torch.models.build_lm` draws from
    ``seed`` and the optimizer the config names, freshly initialised (in
    the stacked layout for Adafactor, :func:`_stacked_state`)."""
    dev = resolve_device(device)
    params = tree_map(lambda p: p.detach(), lm_params(build_lm(cfg, seed, device=dev)))
    opt_cfg = optimizer_config_from_model(cfg)
    opt_init, _ = make_optimizer(opt_cfg)
    if not _stacked_state(opt_cfg):
        return params, opt_init(params)
    # The state's shapes from the stacked layout's, then zeros on the device.
    meta = lm_stacked(cfg, params, lambda ts, stacked: torch.empty(
        ((len(ts),) if stacked else ()) + tuple(ts[0].shape), dtype=ts[0].dtype, device="meta"))
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


def train(cfg: ModelConfig, train_cfg: TrainConfig, dataset, *, device=None, seed: int = 0,
          log_fn: Callable[[str], Any] = print):
    """End-to-end training driver (used by ``examples/torch_train_lm.py``):
    returns ``(params, opt_state, history)``, one history entry a step run."""
    from repro_torch.checkpoint.store import (
        CheckpointManager,
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    opt_cfg = optimizer_config_from_model(cfg)
    params, opt_state = init_train_state(cfg, device, seed)

    start_step = 0
    manager = None
    if train_cfg.ckpt_dir:
        manager = CheckpointManager(train_cfg.ckpt_dir, keep_last=train_cfg.keep_last)
        last = latest_step(train_cfg.ckpt_dir)
        if last is not None:
            (params, opt_state), extra = restore_checkpoint(
                train_cfg.ckpt_dir, last, (params, opt_state))
            start_step = int(extra.get("step", last)) + 1
            log_fn(f"[train] restored step {last}, resuming at {start_step}")

    mb = train_cfg.microbatches
    step_fn = make_train_step(cfg, opt_cfg, microbatches=mb)

    # Preemption handling: SIGTERM -> synchronous save + return.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    watchdog = StepWatchdog(train_cfg.watchdog_factor)
    spike_det = SpikeDetector(train_cfg.spike_factor)
    monitor = None
    if train_cfg.health_every > 0:
        # Loss-health probe on cadence: a NaN/Inf loss halts the run within
        # health_every steps. Under checkpoint-then-abort the LAST HEALTHY
        # (params, opt_state) is committed before the raise.
        ckpt_fn = None
        if train_cfg.health_policy == "checkpoint-then-abort":
            if not train_cfg.ckpt_dir:
                raise ValueError("health_policy='checkpoint-then-abort' needs ckpt_dir")

            def ckpt_fn(s, state):
                return save_checkpoint(train_cfg.ckpt_dir, s, _saveable(state),
                                       {"step": s, "reason": "health-abort"})
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
                manager.save_async(step, _saveable((params, opt_state)), {"step": step})
            if preempted["flag"]:
                log_fn(f"[train] SIGTERM at step {step}: sync checkpoint + exit")
                if manager:
                    manager.wait()
                    manager.save_async(step, _saveable((params, opt_state)), {"step": step})
                    manager.wait()
                break
        else:
            if manager:
                manager.wait()
                manager.save_async(train_cfg.steps - 1, _saveable((params, opt_state)),
                                   {"step": train_cfg.steps - 1})
                manager.wait()
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    return params, opt_state, history
