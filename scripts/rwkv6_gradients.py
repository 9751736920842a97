#!/usr/bin/env python3
"""RWKV-6 gradients on the CPU: the port against the JAX package.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/rwkv6_gradients.py accuracy
    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/rwkv6_gradients.py norms \\
        [--d-model 1024] [--layers 8] [--dtype bfloat16] [--chunk 64] [--strict-bf16]
        [--perturb 1e-7]

``accuracy``: the WKV-6 gradient at (2, 256, 4, 64), chunk 64, for decays
drawn from three ranges, from ``wkv6_backward_plain`` (the plain version of
K7's backward kernel) and from ``jax.grad`` of the JAX package's
``wkv6_chunked_ref``, both in float32, each against autograd through the
same chunked form in float64: the largest error over the largest entry, and
the median error over each entry, per gradient.

``norms``: the global gradient norm of one ``lm_loss`` of ``rwkv6-3b`` at
``--d-model`` (heads of 64, d_ff 3.5 x d_model), ``--layers`` layers, vocab
4096, 2 x 256 tokens, no remat, weights from the JAX ``build_lm`` carried
into the port, in both packages and in each leaf; ``--chunk 0`` takes the
sequential WKV form in both instead of the chunked one; ``--perturb EPS``
also prints the JAX package's norm for three draws of its weights scaled
by ``1 + EPS * N(0, 1)`` (how far rounding-sized changes move it).
``--strict-bf16`` turns
off XLA's excess precision (``--xla_allow_excess_precision=false``), so
the JAX side rounds to bfloat16 wherever its program says so, as the port's
eager PyTorch does.

Runs on the CPU only; prints one JSON line per result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def accuracy() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.kernels.wkv6.ref import wkv6_chunked_ref as jax_chunked
    from repro_torch.kernels.wkv6 import wkv6_backward_plain

    def chunked(r, k, v, w, u, s0, c):
        """The chunked form in the inputs' dtype (float64 here)."""
        b, t, h, n = r.shape
        rs, ks, vs, ws = (a.reshape(b, t // c, c, h, n) for a in (r, k, v, w))
        lower = torch.tril(torch.ones((c, c), dtype=torch.bool), -1)
        state, ys = s0, []
        for i in range(t // c):
            rc, kc, vc, wc = rs[:, i], ks[:, i], vs[:, i], ws[:, i]
            logw = torch.log(torch.clamp_min(wc, 1e-30))
            cum = torch.cumsum(logw, 1)
            total = cum[:, -1:]
            r_dec, k_dec = rc * torch.exp(cum - logw), kc * torch.exp(-cum)
            att = torch.where(lower, torch.einsum("bchk,bshk->bhcs", r_dec, k_dec), 0.0)
            bonus = torch.sum(rc * u[None, None] * kc, -1)[..., None]
            ys.append(torch.einsum("bchk,bhkv->bchv", r_dec, state)
                      + torch.einsum("bhcs,bshv->bchv", att, vc) + bonus * vc)
            state = torch.exp(total)[:, 0, :, :, None] * state + torch.einsum(
                "bshk,bshv->bhkv", kc * torch.exp(total - cum), vc)
        return torch.stack(ys, 1).reshape(b, t, h, n), state

    shape, c = (2, 256, 4, 64), 64
    b, _, h, n = shape
    rng = np.random.default_rng(0)
    for lo, hi in ((0.85, 0.9), (0.6, 1.0), (0.3, 0.99)):
        r, k, v, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
        w = (lo + (hi - lo) * rng.random(shape)).astype(np.float32)
        u = (0.5 * rng.standard_normal((h, n))).astype(np.float32)
        s0 = np.zeros((b, h, n, n), np.float32)
        xs = [torch.from_numpy(a).double().requires_grad_() for a in (r, k, v, w, u, s0)]
        y, _ = chunked(*xs, c)
        ref = torch.autograd.grad((y * torch.from_numpy(dy).double()).sum(), xs)
        plain = wkv6_backward_plain(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0, dy)),
                                    chunk=c)

        def loss(r, k, v, w, u, s0):
            return jnp.sum(jax_chunked(r, k, v, w, u, s0, chunk=c)[0] * dy)

        jgrad = jax.grad(loss, argnums=tuple(range(6)))(r, k, v, w, u, s0)
        for name, p, j, want in zip(("dr", "dk", "dv", "dw", "du"), plain, jgrad, ref):
            want = want.numpy()
            out = {"w": [lo, hi], "grad": name}
            for label, got in (("plain", p.double().numpy()), ("jax", np.asarray(j, np.float64))):
                err = np.abs(got - want)
                out[label] = {"max_rel": float(err.max() / np.abs(want).max()),
                              "median_rel": float(np.median(err / (np.abs(want) + 1e-12)))}
            print(json.dumps(out), flush=True)


def norms(d_model: int, layers: int, dtype: str, chunk: int, perturb: float) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jax_config
    from repro.models import build_lm as jax_build_lm
    from repro.models import lm_loss as jax_lm_loss
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_numpy, lm_tree_from_numpy
    from repro_torch.models import lm_loss, lm_params
    from repro_torch.tree import tree_flatten, tree_flatten_with_paths, tree_map

    over = dict(n_layers=layers, d_model=d_model, d_ff=int(3.5 * d_model), vocab_size=4096,
                compute_dtype=dtype, remat=False, rwkv_chunk=chunk)
    jcfg = dataclasses.replace(jax_config("rwkv6-3b"), **over)
    cfg = dataclasses.replace(get_config("rwkv6-3b"), **over)
    params, _ = jax_build_lm(jcfg, jax.random.PRNGKey(0))
    t = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 257)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    (jloss, _), jgrad = jax.value_and_grad(lambda p: jax_lm_loss(jcfg, p, batch),
                                           has_aux=True)(params)
    tree = tree_map(lambda x: x.detach().clone().requires_grad_(),
                    lm_params(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                                   device="cpu")))
    loss, _ = lm_loss(cfg, tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves, paths, _ = tree_flatten_with_paths(tree)
    grads = [g.float().numpy() for g in torch.autograd.grad(loss, leaves)]
    want = [np.asarray(g, np.float32) for g in
            tree_flatten(lm_tree_from_numpy(cfg, jax.tree.map(np.asarray, jgrad)))[0]]
    print(json.dumps({"d_model": d_model, "layers": layers, "dtype": dtype, "chunk": chunk,
                      "xla_flags": os.environ.get("XLA_FLAGS", ""),
                      "loss": {"port": loss.item(), "jax": float(jloss)},
                      "grad_norm": {"port": float(np.sqrt(sum((g ** 2).sum() for g in grads))),
                                    "jax": float(jnp.sqrt(sum(jnp.sum(
                                        x.astype(jnp.float32) ** 2)
                                        for x in jax.tree.leaves(jgrad))))}}), flush=True)
    grad_fn = jax.jit(jax.grad(lambda p: jax_lm_loss(jcfg, p, batch)[0]))
    rng = np.random.default_rng(1)
    for draw in range(3 if perturb else 0):
        moved = jax.tree.map(lambda x: x * (1 + perturb * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)), params)
        g = grad_fn(moved)
        print(json.dumps({"perturb": perturb, "draw": draw, "jax_grad_norm": float(jnp.sqrt(
            sum(jnp.sum(x.astype(jnp.float32) ** 2) for x in jax.tree.leaves(g))))}),
              flush=True)
    for path, g, w in sorted(zip(paths, grads, want), key=lambda x: -np.linalg.norm(x[2]))[:5]:
        print(json.dumps({"leaf": path, "port_norm": float(np.linalg.norm(g)),
                          "jax_norm": float(np.linalg.norm(w))}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["accuracy", "norms"])
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--strict-bf16", action="store_true")
    args = ap.parse_args(argv)
    if args.strict_bf16:  # read when jax initialises its backend: set before importing it
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_allow_excess_precision=false").strip()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    if args.what == "accuracy":
        accuracy()
    else:
        norms(args.d_model, args.layers, args.dtype, args.chunk, args.perturb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
