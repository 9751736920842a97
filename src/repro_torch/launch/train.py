"""Training launcher: builds an LM from a seed and trains it on a synthetic
or file-backed token stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --steps 1000 --ckpt-dir ckpts/rg [--smoke] [--device cpu]

The port of ``repro/launch/train.py``, with the same flags and
``--device`` added (default: the card; ``--device cpu`` with ``--smoke``
is what the CPU can run). ``--arch`` takes the architectures whose blocks
the port runs (recurrent and dense); any other (MoE, cross-attention,
audio) raises and names the ROADMAP item that ports it.
The JAX launcher's collective-overlap flags and multi-host initialisation
belong to the TPU and to the LM sharding slice (ROADMAP M13b.3): this
launcher trains on one device, so ``--grad-compression`` is carried in the
config and reduces nothing.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compression", choices=["none", "bf16"], default="none")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--data", default="synthetic", help="synthetic | path to token file")
    ap.add_argument("--device", default=None, help="torch device; default: the card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, make_dataset
    from repro_torch.train import TrainConfig, train

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, remat=False)

    dc = DataConfig(
        seq_len=args.seq,
        global_batch=args.global_batch,
        vocab_size=cfg.vocab_size,
        kind="synthetic" if args.data == "synthetic" else "file",
        path="" if args.data == "synthetic" else args.data,
    )
    tc = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        grad_compression=args.grad_compression,
    )
    train(cfg, tc, make_dataset(dc), device=args.device)


if __name__ == "__main__":
    main()
