"""Training launcher: builds an LM from a seed and trains it on a synthetic
or file-backed token stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --steps 1000 --ckpt-dir ckpts/rg [--smoke] [--device cpu]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --backend nccl                       # one card a rank
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --backend gloo                       # ranks sharing one card, or --device cpu

The port of ``repro/launch/train.py``, with the same flags, ``--device``
added (default: the card; ``--device cpu`` with ``--smoke`` is what the CPU
can run) and ``--backend``. Under torchrun's environment (``WORLD_SIZE`` >
1) it initialises the process group with ``--backend`` (default
``nccl``) and trains sharded on ``make_host_mesh()``, where the JAX
launcher calls ``jax.distributed.initialize()``; without it, on one
device. The token stream feeds every text LM; llama-3.2-vision trains on
it without media (no ``memory``: its cross-attention layers read the
tokens), as the JAX launcher trains it. hubert-xlarge takes frame
embeddings, which the token stream does not make: the launcher refuses it
with a ``ValueError`` (the JAX launcher fails on the shapes).
``--grad-compression`` is carried in the config and reduces nothing, as in
the JAX launcher's ``train()``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


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
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="collectives under torchrun (gloo: ranks may share a card)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, make_dataset
    from repro_torch.train import TrainConfig, train

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend == "audio":
        raise ValueError(f"{cfg.name} trains on frame embeddings (B, S, {cfg.d_model}); the "
                         "launcher's token stream has no frames (drive train() with a "
                         "dataset that yields them)")
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
    group = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if group:
        dist.init_process_group(args.backend, init_method="env://")
    try:
        mesh = make_host_mesh(backend=args.backend, device=args.device)
        train(cfg, tc, make_dataset(dc), mesh=mesh, device=args.device)
    finally:
        if group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
