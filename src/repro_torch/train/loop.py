"""Training-loop monitors.

The counterpart of ``repro/train/loop.py``'s :class:`SpikeDetector`, which
the assimilation trainer (:mod:`repro_torch.train.assimilate`) records every
loss through. The rest of the JAX package's LM training loop (jitted steps,
microbatching, checkpoint-and-abort health) is ROADMAP M13b.
"""

from __future__ import annotations

import math
import statistics

from repro_torch.obs import events, metrics


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
