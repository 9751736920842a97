"""End-to-end LM training on the PyTorch port: a ~100M-param model for a
few hundred steps on deterministic synthetic data, with checkpoint/restart.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --scale full
  PYTHONPATH=src python examples/torch_train_lm.py --scale tiny --steps 20 --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --arch arctic-480b --smoke --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_train_lm.py --smoke \
      --device cpu --backend gloo

The port of ``examples/train_lm.py``, with the same flags, ``--device``
added (default: the card, which it raises without) and ``--smoke`` (the
arch's reduced config, in place of ``--scale``: the MoE archs keep their
128 experts at every scale, which is too much for the CPU). ``--arch``
takes the architectures whose blocks the port runs; the default is the
JAX example's, a qwen1.5-family dense config. ``recurrentgemma-2b`` trains
its RG-LRU layers through the scan kernel K6 forward and backward,
``rwkv6-3b`` its time mix through K7 and K7's backward kernel,
``qwen3-moe-235b-a22b`` and ``arctic-480b`` their MoE FFNs (plain tensor
code). Loss must drop; checkpoints land in ``--ckpt-dir`` and a rerun
resumes from the last one. Under torchrun (``WORLD_SIZE`` > 1) the ranks
join one process group on ``--backend`` (``nccl``: one card a rank;
``gloo``: ranks may share a card, or the CPU) and train sharded on
``make_host_mesh()``, as the JAX example trains on its host mesh.
"""

import argparse
import dataclasses
import os
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--scale", choices=["tiny", "100m", "full"], default="100m")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device; default: the card")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="collectives under torchrun (gloo: ranks may share a card)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import TrainConfig, train

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = get_smoke_config(args.arch)
    elif args.scale == "tiny":
        # ~5M params: a CPU-sized evidence run.
        cfg = dataclasses.replace(
            cfg, n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=0,
            d_ff=1024, vocab_size=4096, remat=False, learning_rate=1e-3,
        )
    elif args.scale == "100m":
        # ~100M params: 12 layers x 512 wide on the arch's own block family.
        cfg = dataclasses.replace(
            cfg,
            n_layers=12,
            d_model=512,
            n_heads=8,
            n_kv_heads=min(8, max(1, cfg.n_kv_heads)),
            head_dim=0,
            d_ff=2048,
            vocab_size=32768,
            remat=False,
            learning_rate=1e-3,
        )
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M")

    ds = SyntheticLM(
        DataConfig(seq_len=args.seq, global_batch=args.batch, vocab_size=cfg.vocab_size)
    )
    tc = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        log_every=10,
        ckpt_every=100,
        ckpt_dir=args.ckpt_dir,
    )
    group = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if group:
        dist.init_process_group(args.backend, init_method="env://")
    try:
        mesh = make_host_mesh(backend=args.backend, device=args.device)
        _, _, hist = train(cfg, tc, ds, mesh=mesh, device=args.device)
    finally:
        if group:
            dist.destroy_process_group()
    if hist:
        print(
            f"loss: first10={sum(h['loss'] for h in hist[:10])/max(len(hist[:10]),1):.4f} "
            f"last10={sum(h['loss'] for h in hist[-10:])/max(len(hist[-10:]),1):.4f}"
        )


if __name__ == "__main__":
    main()
