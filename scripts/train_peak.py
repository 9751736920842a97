#!/usr/bin/env python3
"""Peak device memory of the port's LM trainer at published widths on one
NVIDIA GPU, for a source tree given on the command line.

    python3 scripts/train_peak.py [--src DIR] [--arch NAME] [--steps N]

Runs ``train()`` on ``--arch`` (default ``recurrentgemma-2b``: f32 masters,
bf16 compute, remat) for ``N`` steps (default 2) of ``SyntheticLM`` at
batch 4 x seq 256 in a fresh process, and prints one JSON line: the peak
of ``torch.cuda.max_memory_allocated`` over the run, the bytes allocated
before it (none: nothing else ran), the losses, and the card's name and
power limit. ``--src`` names the ``src/`` directory whose ``repro_torch``
is imported (default: this checkout's), so two trees can be measured in
turns on one card.

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("train_peak.py needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import TrainConfig, train

    cfg = get_config(args.arch)
    data = SyntheticLM(DataConfig(seq_len=256, global_batch=4, vocab_size=cfg.vocab_size,
                                  seed=2024))
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _, _, hist = train(cfg, TrainConfig(steps=args.steps, log_every=args.steps), data,
                       device="cuda", seed=2024, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"src": args.src, "arch": args.arch, "steps": args.steps,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "held_before_gb": held / 1e9, "losses": [h["loss"] for h in hist],
                      "card": smi.strip().splitlines()[0] if smi.strip() else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
