"""Serving launcher: builds an LM from a seed and runs the
continuous-batching engine over a synthetic request stream.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --requests 8 --lanes 4

Runs on the card unless ``--device cpu`` is given (with ``--smoke`` for
the reduced config, which is what the CPU can run).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device; default: the card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import build_lm
    from repro_torch.serve import BatchedServer

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_lm(cfg, args.seed, device=args.device)
    srv = BatchedServer(cfg, model, lanes=args.lanes, max_len=args.max_len)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(4, max(args.max_len // 4, 5)))
        srv.submit(rng.integers(0, cfg.vocab_size, size=(plen,)), args.max_new)
    done = srv.run_until_idle()
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {model.device}: {len(done)}/{args.requests} requests, "
          f"{srv.stats['tokens_out']} tokens, {dt:.2f}s "
          f"({srv.stats['tokens_out'] / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
