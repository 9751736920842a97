#!/usr/bin/env python3
"""How far a rounding-sized change moves an LM's gradients, on the CPU.

    PYTHONPATH=src python scripts/grad_sensitivity.py [ARCH ...] [--eps 1e-7 1e-6]

For each smoke config (float32 compute, remat off, the trainer's weights
from seed 3), one ``lm_loss`` of 8 rows (128 tokens for RWKV-6, whose
chunked WKV then runs two chunks; 32 otherwise) and its gradients, then
the same with the embedding output scaled by ``1 + eps * N(0, 1)``: the
loss's relative change and the largest change of a leaf's gradient over
that leaf's largest entry. A change of the summation order (a split over
``model``) moves the residual stream by such an amount. Prints one JSON
line per (arch, eps).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as lm_module
from repro_torch.train import init_train_state
from repro_torch.tree import tree_flatten, tree_unflatten


def gradients(cfg, leaves, treedef, batch, eps: float):
    embed = lm_module._embed

    def perturbed(*args, **kwargs):
        x = embed(*args, **kwargs)
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
        return x * (1 + eps * noise)

    lm_module._embed = perturbed
    try:
        work = [p.detach().requires_grad_() for p in leaves]
        loss, _ = lm_module.lm_loss(cfg, tree_unflatten(treedef, work), batch)
        grads = torch.autograd.grad(loss, work, allow_unused=True)
    finally:
        lm_module._embed = embed
    return float(loss.detach()), grads


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=["rwkv6-3b", "recurrentgemma-2b",
                                                  "qwen1.5-0.5b"])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6])
    args = ap.parse_args()
    for arch in args.archs:
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32", remat=False)
        leaves, treedef = tree_flatten(init_train_state(cfg, "cpu", seed=3)[0])
        seq = 128 if arch == "rwkv6-3b" else 32
        toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (8, seq + 1))
        batch = {"tokens": torch.tensor(toks[:, :-1]), "labels": torch.tensor(toks[:, 1:])}
        loss0, grads0 = gradients(cfg, leaves, treedef, batch, 0.0)
        for eps in args.eps:
            loss, grads = gradients(cfg, leaves, treedef, batch, eps)
            moved = max(float((g - g0).abs().max() / g0.abs().max())
                        for g, g0 in zip(grads, grads0) if g0 is not None and g0.abs().max() > 0)
            print(json.dumps({"arch": arch, "eps": eps, "loss_rel": abs(loss - loss0) / loss0,
                              "grad_max_rel": moved}), flush=True)


if __name__ == "__main__":
    main()
