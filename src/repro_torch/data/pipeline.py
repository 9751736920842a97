"""Data pipeline: deterministic synthetic streams + binary file-backed
token datasets, with host-side sharding, packing, and prefetch.

The port's own copy of ``repro/data/pipeline.py`` (numpy only, so the port
imports nothing of the JAX package): every batch it serves is bit-equal to
the JAX package's for the same config, step and shard. Batches are numpy;
the trainer moves them to its device.

Production posture:
  * Every batch is addressed by (step, host_shard) so a restart reproduces
    the exact stream from a checkpointed step — data-parallel restore needs
    no separate data checkpoint.
  * ``TokenFileDataset`` memory-maps a flat uint16/uint32 token file and
    serves fixed-length windows (the standard pre-tokenised LM format).
  * ``pack_documents`` packs ragged documents into fixed (seq_len,) rows
    with EOS separators — loss masking uses the -100 convention.
  * ``Prefetcher`` overlaps host batch assembly with device compute via a
    background thread (depth-N queue) — the data-side analogue of the
    paper's shimDMA double buffering.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    kind: str = "synthetic"          # synthetic | file
    path: str = ""                   # for kind="file"
    eos_id: int = 0
    prefetch: int = 2


class SyntheticLM:
    """Deterministic synthetic LM stream: tokens drawn from a fixed-seed
    Philox counter keyed by (seed, step), labels = next-token shift.

    A "zipfian" skew makes the distribution non-uniform so losses actually
    decrease during the example runs (a uniform stream is unlearnable).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        probs = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
        self._probs = probs / probs.sum()

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.global_batch // n_shards
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard]))
        toks = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len + 1), p=self._probs)
        toks = toks.astype(np.int32)
        # Inject learnable structure: every token at odd position repeats the
        # previous token with p=0.5 (so next-token prediction is learnable).
        rep = rng.random((local, cfg.seq_len + 1)) < 0.5
        for j in range(1, cfg.seq_len + 1, 2):
            toks[:, j] = np.where(rep[:, j], toks[:, j - 1], toks[:, j])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class TokenFileDataset:
    """Flat binary token file (uint16 or uint32), served as fixed windows.

    Window w of step s for shard h is deterministic in (seed, s, h): restart
    = replay. Windows stride by seq_len with a seeded offset shuffle.
    """

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self._data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_windows = (len(self._data) - 1) // cfg.seq_len
        if self.n_windows <= 0:
            raise ValueError(f"{cfg.path} too small for seq_len={cfg.seq_len}")

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.global_batch // n_shards
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard]))
        idx = rng.integers(0, self.n_windows, size=(local,))
        rows = np.stack(
            [self._data[i * cfg.seq_len : i * cfg.seq_len + cfg.seq_len + 1] for i in idx]
        ).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:].copy()}


def pack_documents(
    docs: list[np.ndarray], seq_len: int, eos_id: int, pad_label: int = -100
) -> dict[str, np.ndarray]:
    """Packs ragged docs into (n_rows, seq_len) with EOS separators.
    Labels are next-token; positions crossing a document boundary get
    ``pad_label`` so loss never spans documents."""
    stream: list[int] = []
    boundaries: list[int] = []
    for d in docs:
        stream.extend(int(t) for t in d)
        stream.append(eos_id)
        boundaries.append(len(stream) - 1)
    n_rows = max(len(stream) // (seq_len + 1), 1)
    usable = n_rows * (seq_len + 1)
    while len(stream) < usable + 1:
        stream.append(eos_id)
    arr = np.asarray(stream[: usable + 1], np.int32)
    bset = set(boundaries)
    tokens = np.empty((n_rows, seq_len), np.int32)
    labels = np.empty((n_rows, seq_len), np.int32)
    for r in range(n_rows):
        base = r * (seq_len + 1)
        tokens[r] = arr[base : base + seq_len]
        labels[r] = arr[base + 1 : base + seq_len + 1]
        for j in range(seq_len):
            if base + j in bset:  # token j is an EOS: next-token crosses docs
                labels[r, j] = pad_label
    return {"tokens": tokens, "labels": labels}


class Prefetcher:
    """Depth-N background prefetch of host batches."""

    def __init__(self, make_batch, depth: int = 2, start_step: int = 0):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def make_dataset(cfg: DataConfig):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg)
    if cfg.kind == "file":
        return TokenFileDataset(cfg)
    raise ValueError(cfg.kind)
