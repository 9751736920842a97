"""Cross-rank gradient reduction with optional wire compression.

The port of ``repro/dist/reduce.py`` on ``torch.distributed``: where the
JAX package psums over named mesh axes inside a ``shard_map``, every rank
here calls :func:`reduce_gradients` with its own gradients and the process
group to reduce over (``None``: the default group).

Compression (``method="bf16"``): floating gradients are cast to bfloat16
BEFORE the all-reduce, so it moves half the bytes, then the result is cast
back to the gradient's dtype and the mean finished there. bfloat16 keeps
float32's exponent range, so there is no overflow cliff, only about three
decimal digits of mantissa. Integer leaves are summed exactly and their
mean is a floor division, as in the JAX package.

Under gloo a CUDA tensor is staged through host memory for the collective
(one card may run several gloo ranks), as the stencil mesh's collectives
are.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

METHODS = ("none", "bf16")


def compress_bf16(x: torch.Tensor) -> torch.Tensor:
    """The wire format of the bf16 path (exposed for unit tests)."""
    return x.to(torch.bfloat16)


def decompress_bf16(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    staged = t.device.type != "cpu" and str(dist.get_backend(group)).lower() == "gloo"
    buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


def reduce_gradients(grads: Any, group=None, method: str = "none", mean: bool = True) -> Any:
    """All-reduces every leaf of ``grads`` (a tensor or a tree of them) over
    ``group``. Returns the mean by default (the sum with ``mean=False``).
    Every rank of the group must call it with the same tree structure."""
    if method not in METHODS:
        raise ValueError(f"unknown reduction method {method!r}; pick from {METHODS}")
    n = dist.get_world_size(group)

    def red(g: torch.Tensor) -> torch.Tensor:
        dtype = g.dtype
        if method == "bf16" and g.is_floating_point():
            total = decompress_bf16(_all_reduce_sum(compress_bf16(g), group), dtype)
        else:
            total = _all_reduce_sum(g, group)
        if not mean:
            return total
        if g.is_floating_point():
            return total / torch.tensor(n, dtype=dtype)
        return torch.div(total, n, rounding_mode="floor")

    return tree_map(red, grads)
