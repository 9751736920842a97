"""Serving: prefill/decode steps + a continuous-batching scheduler.

The port of ``repro/serve/engine.py``. ``make_serve_fns`` returns the plain
prefill and decode steps (PyTorch runs eagerly: nothing to jit).
``BatchedServer`` is the same minimal continuous-batching engine: fixed
decode lanes, each holding one request in a batch-1 cache of its own;
finished lanes are refilled from the queue with a prefill. Greedy
sampling (argmax). Telemetry goes to the port's ``obs`` (metrics and the
flight recorder), under the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_cache, lm_decode, lm_prefill
from repro_torch.obs import events, metrics


def make_serve_fns(cfg: ModelConfig, *, batch: int, max_len: int, device=None):
    """Returns ``(prefill_fn, decode_fn, cache_init_fn)``:

    prefill_fn(model, tokens, cache)       -> (last_logits, cache)
    decode_fn(model, token, cache, pos)    -> (logits, cache)
    cache_init_fn()                        -> an empty cache on ``device``
    """
    def prefill(model, tokens, cache):
        return lm_prefill(cfg, model, tokens, cache)

    def decode(model, token, cache, pos):
        return lm_decode(cfg, model, token, cache, pos)

    def cache_init():
        return build_cache(cfg, batch, max_len, device=device)

    return prefill, decode, cache_init


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (p,) int32
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Telemetry, stamped by the server as the request moves through the queue.
    submitted_ts: float | None = None   # perf_counter at submit()
    prefill_ts: float | None = None     # perf_counter when a lane picked it up
    done_ts: float | None = None        # perf_counter at completion
    queue_latency_s: float | None = None   # prefill_ts - submitted_ts
    prefill_s: float | None = None         # the prefill, first token included
    items_per_sec: float | None = None     # tokens per second of THIS request


class BatchedServer:
    """Continuous batching over ``lanes`` decode slots. Lanes step in
    lock-step (one decode per active lane per step); finished lanes are
    refilled at once. Every prompt starts at position 0 of its own lane:
    one batch-1 cache per lane, so ragged requests batch correctly with a
    scalar decode position. The model's device is the server's."""

    def __init__(self, cfg: ModelConfig, model, *, lanes: int = 4, max_len: int = 512):
        self.cfg = cfg
        self.model = model
        self.lanes = lanes
        self.max_len = max_len
        self.device = model.device
        self.prefill, self.decode, self._cache_init = make_serve_fns(
            cfg, batch=1, max_len=max_len, device=self.device)
        self._lane_cache: list[Any] = [None] * lanes
        self._lane_req: list[Request | None] = [None] * lanes
        self._lane_pos: list[int] = [0] * lanes
        self._queue: list[Request] = []
        self._next_rid = 0
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0}

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, np.asarray(prompt, np.int32), max_new_tokens)
        req.submitted_ts = time.perf_counter()
        self._queue.append(req)
        metrics.inc("serve.requests_submitted")
        events.record("serve.submit", rid=rid, prompt_len=len(req.prompt),
                      max_new_tokens=max_new_tokens)
        return rid

    def _fill_lanes(self) -> None:
        for i in range(self.lanes):
            if self._lane_req[i] is None and self._queue:
                req = self._queue.pop(0)
                req.prefill_ts = time.perf_counter()
                if req.submitted_ts is not None:
                    req.queue_latency_s = req.prefill_ts - req.submitted_ts
                    metrics.observe("serve.queue_latency", req.queue_latency_s)
                tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                         device=self.device)
                with metrics.timer("serve.prefill"):
                    logits, cache = self.prefill(self.model, tokens, self._cache_init())
                    tok = int(torch.argmax(logits[0]))  # waits for the device
                req.prefill_s = time.perf_counter() - req.prefill_ts
                req.out_tokens.append(tok)
                self._lane_req[i] = req
                self._lane_cache[i] = cache
                self._lane_pos[i] = len(req.prompt)
                self.stats["prefills"] += 1
                metrics.inc("serve.prefills")
                events.record("serve.prefill", rid=req.rid, lane=i,
                              queue_latency_s=req.queue_latency_s, prefill_s=req.prefill_s)

    def step(self) -> bool:
        """One scheduler step: refill lanes, decode one token per active
        lane. Returns False when idle."""
        self._fill_lanes()
        active = [i for i in range(self.lanes) if self._lane_req[i] is not None]
        if not active:
            metrics.set_gauge("serve.batch_occupancy", 0.0)
            return False
        metrics.set_gauge("serve.batch_occupancy", len(active) / self.lanes)
        events.record("serve.decode", active_lanes=len(active), lanes=self.lanes)
        with metrics.timer("serve.decode_step"):
            for i in active:
                req = self._lane_req[i]
                last = torch.tensor([req.out_tokens[-1]], dtype=torch.long, device=self.device)
                logits, cache = self.decode(self.model, last, self._lane_cache[i],
                                            self._lane_pos[i])
                self._lane_cache[i] = cache
                self._lane_pos[i] += 1
                req.out_tokens.append(int(torch.argmax(logits[0])))
                self.stats["decode_steps"] += 1
                self.stats["tokens_out"] += 1
                metrics.inc("serve.decode_steps")
                metrics.inc("serve.tokens_out")
                if (len(req.out_tokens) >= req.max_new_tokens
                        or self._lane_pos[i] >= self.max_len - 1):
                    req.done = True
                    req.done_ts = time.perf_counter()
                    if req.prefill_ts is not None and req.done_ts > req.prefill_ts:
                        req.items_per_sec = len(req.out_tokens) / (req.done_ts - req.prefill_ts)
                    self._lane_req[i] = None
                    self._lane_cache[i] = None
                    events.record("serve.retire", rid=req.rid, lane=i,
                                  tokens_out=len(req.out_tokens),
                                  items_per_sec=req.items_per_sec)
        occupied = sum(1 for r in self._lane_req if r is not None)
        metrics.set_gauge("serve.batch_occupancy", occupied / self.lanes)
        return True

    def run_until_idle(self, max_steps: int = 10_000) -> list[Request]:
        all_reqs = list(self._queue)
        t0 = time.perf_counter()
        tokens0 = self.stats["tokens_out"]
        for _ in range(max_steps):
            if not self.step():
                break
        elapsed = time.perf_counter() - t0
        if elapsed > 0:
            metrics.set_gauge("serve.items_per_sec",
                              (self.stats["tokens_out"] - tokens0) / elapsed)
        return [r for r in all_reqs if r.done]
