"""Dry run: every (arch x shape x mesh) cell traced for one rank on meta tensors.

The port of ``repro/launch/dryrun.py``. Where the JAX module lowers and
compiles each cell with XLA for a TPU pod and reads the compiler's memory
and cost analyses, the port runs the cell's step once, eagerly, on tensors
of the ``"meta"`` device (shapes and dtypes, no values, nothing allocated)
for ONE rank of the mesh, inside a ``"fake"`` process group of the mesh's
size whose collectives move nothing. It never computes a value and never
touches a card, so it runs the same on any host, as the JAX one runs on
host CPU devices. Per cell this writes ``<out>/<arch>__<shape>__<mesh>.json``:

  * ``memory_analysis`` — the bytes the rank is handed (its pieces of the
    parameters and the optimizer state, and the batch the step is given;
    serving: the weights, the cache and the batch), the step's outputs, and
    the peak of the bytes alive during the step by category: the
    arguments, ``activations`` (what an op on differentiable inputs
    allocates with autograd recording: the forward and the remat
    recompute), ``gradients`` (the tensors ``torch.autograd.grad``
    returns, from its return on; until then they count as temporaries) and
    ``temporaries`` (everything else: the backward's intermediates, the
    clip's and the optimizer's scratch, a serving step's work). ``fits``:
    the peak within the card's 80 GB. (``torch.distributed._tools``'s
    ``MemTracker`` sorts bytes by ``nn.Module`` and ``torch.optim`` hooks,
    which the port's functional steps do not have: it would call every
    byte an activation.)
  * ``cost_analysis`` — FLOPs (``torch.utils.flop_counter``: matmuls,
    convolutions, attention) and bytes (each op's tensor operands and
    results, views, allocations and collectives excepted: the eager port's
    unfused traffic, the counterpart of XLA's "bytes accessed"). The
    hand-written kernels launch from ctypes, past both counters: their
    wrappers' meta routes note each launch they skip with the FLOPs and
    bytes of its bound (``kernels/_build.py::record_meta``), listed under
    ``kernels`` and added in.
  * ``collectives`` — every all-reduce and all-gather the port's
    ``dist/sharding.py`` runs, by kind: calls, payload bytes, and the bytes
    a rank puts on the wire by the ring model of the JAX module's
    ``parse_collective_bytes`` (all-reduce ``2B(g-1)/g``, all-gather
    ``B(g-1)/g`` of a g-rank group's payload B); the port's ``dist.*``
    byte counters beside them.
  * ``analytic`` — the port's ``cell_flops`` and ``cell_hbm_bytes``
    (``launch/analytic.py``) and the counted FLOPs of all ranks over them.
  * ``roofline`` — compute, memory and collective seconds at the rates of
    an NVIDIA H100 SXM (``core/analytical.py::H100_SXM``: data-sheet dense
    rates at the 700 W board power), the dominant term, the 6ND / 2ND
    model FLOPs and their share of the counted ones.

**One link rate.** Every collective is costed at NVLink's 900 GB/s a GPU.
A mesh past 8 GPUs spans nodes, and an axis that leaves a node crosses the
network at a fraction of that, so ``collective_s`` is optimistic there.

**No unrolled variants.** The JAX module compiles 1- and 2-superblock
variants and extrapolates because XLA's cost analysis counts a ``while``
loop's body once. An eager trace runs every layer and every microbatch,
so the counts are whole as they stand.

**Cells as the port runs them.** Every cell runs tensor-parallel
(``models/lm.py``): the rank is handed its pieces of the weights (of the
optimizer state and of the cache) under the JAX placements and its rows of
the batch (a train cell: the global batch, whose rows the step takes),
each block gathers its data-axis pieces and computes its ``model`` share
(heads, kv heads, ``mlp``, vocabulary, RG-LRU's width; a train cell's
loss on its vocabulary columns; a serving cell's cache split by
``kv_seq``), and an MoE's experts take their expert-parallel path. The
JSON says so in ``note``; the collectives of a train step equal
:func:`shard_wire_reckoning`, of a serving step
:func:`serve_wire_reckoning`.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --skip-existing
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_cells, get_config, get_shape
from repro_torch.core.analytical import H100_SXM
from repro_torch.dist import sharding
from repro_torch.dist.sharding import Mesh, rank_coords
from repro_torch.kernels import _build
from repro_torch.launch.analytic import cell_flops, cell_hbm_bytes
from repro_torch.launch.inputs import make_lowering_spec
from repro_torch.models import layers as L
from repro_torch.models.lm import lm_meta, lm_stacked, shard_tree, stack_meta
from repro_torch.obs import metrics
from repro_torch.tree import tree_flatten, tree_leaves

META = torch.device("meta")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
HBM_BYTES = H100_SXM.hbm_gib * 2**30  # 80 GB (decimal)
POWER_LIMIT_W = 700  # the board power the data-sheet rates are given at
DEFAULT_OUT = "artifacts/dryrun_torch"


def ring_wire_bytes(kind: str, payload: float, ranks: int) -> float:
    """The bytes one rank of a ``ranks``-rank ring puts on the wire for a
    collective of ``payload`` bytes (the JAX module's cost model):
    all-reduce ``2B(g-1)/g``, all-gather ``B(g-1)/g`` of its result."""
    if ranks <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * payload * (ranks - 1) / ranks
    if kind == "all_gather":
        return payload * (ranks - 1) / ranks
    raise ValueError(f"no wire model for {kind!r}")


def shard_wire_reckoning(cfg, mesh_shape, batch: int, seq: int, microbatches: int = 1) -> dict:
    """Every collective one rank runs in a train step (``make_train_step``
    on a mesh) of a ``batch`` x ``seq`` global batch in ``microbatches``,
    on a ``(data, model)`` or ``(pod, data, model)`` mesh of
    ``mesh_shape``, from the shapes alone. Returns ``{"collectives":
    [(kind, payload bytes, ranks in the group)], as
    :func:`repro_torch.dist.sharding.tally_collectives` records them, "gather":
    bytes, "grad_sum": bytes}``: the last two what the ``dist.gather.bytes``
    and ``dist.grad_sum.bytes`` counters read. The rows, each microbatch:

    * each parameter, where it is read (a block's twice with remat, the
      forward's and the recompute's; a tied embedding at either end): cast
      to the compute dtype, gathered over the data axes of its spec, one
      all-gather an entry, ``model`` kept (``gather_param``); in the
      backward, once, the gathered gradient summed over each entry's data
      axes and a leaf no data axis splits summed whole (``copy_to``). An
      MoE's ``ffn`` on its expert-parallel path: the router gathered whole
      in float32, the expert and dense leaves over the data axes;
    * where ``model`` splits them, each use: the vocabulary-parallel
      embedding's sum; each attention's, FFN's, channel mix's (float32) and
      RG-LRU's output sum, RG-LRU's gate products (float32, both in one
      sum) and the MoE's expert sum, forward (twice with remat, but the
      FFN's and the MoE's output sums: the recompute stops at the block's
      last tensor saved for the backward, which comes before them); in the
      backward each ``copy_to``'s sum: the input of split query heads, k
      and v where their kv heads are replicated, of an FFN, a channel mix
      (float32), RG-LRU (and its biases and ``lam``, float32) and of the
      head, the MoE's tokens and gates (float32), and RG-LRU's gate
      products' gradients gathered (float32); the blocked local path's
      outputs gathered where its blocks are split, forward, and its q, k
      and v summed, backward;
    * the MoE's two aux statistics averaged over the data axes (forward)
      and one again (backward);
    * the loss: over a split vocabulary the row maxima (max) and two sums
      (float32); the valid-token count (int64) and the loss summed over the
      data axes;

    and once a step the clip's sum of squares over the mesh and
    Adafactor's sums over the ranks that split a leaf."""
    from repro_torch.dist.sharding import _entry_axes, _is_axes_leaf, spec_for
    from repro_torch.models.lm import lm_axes, lm_meta
    from repro_torch.optim import optimizer_config_from_model

    mesh_shape, axes = _mesh_of(None, mesh_shape)
    sizes = dict(zip(axes, mesh_shape))
    mesh = type("Shape", (), {"axis_names": axes, "shape": mesh_shape})()
    mp = sizes["model"]
    dp = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    dp_n = math.prod(sizes[a] for a in dp)
    c = 4 if cfg.compute_dtype == "float32" else 2
    b = batch // math.prod(sizes[a] for a in _entry_axes(spec_for(("batch",), mesh, (batch,))[0]))
    b //= microbatches
    s, d, t = seq, cfg.d_model, b * seq
    dh, h_all, k_all = cfg.head_dim, max(cfg.n_heads, cfg.pad_heads_to or 0), cfg.n_kv_heads
    out: list = []
    got = {"grad_sum": 0}
    fwd = 2 if cfg.remat else 1

    def rows(kind, payload, ranks, n=1, grad=False):
        """``n`` collectives; ``grad``: a gradient's sum (``_grad_sum``)."""
        out.extend([(kind, payload, ranks)] * n)
        got["grad_sum"] += grad * n * payload

    def param(ax, shape, n_fwd, width=c, keep=("model",)):
        spec = spec_for(ax, mesh, shape)
        size = math.prod(shape) * width // math.prod(
            sizes[a] for e in spec for a in _entry_axes(e))
        rest = [a for a in dp if a not in [a for e in spec for a in _entry_axes(e)]]
        if rest:
            rows("all_reduce", size, math.prod(sizes[a] for a in rest), grad=True)
        for e in spec:
            gathered = [a for a in _entry_axes(e) if a not in keep]
            count = math.prod(sizes[a] for a in gathered)
            if count == 1:
                continue
            rows("all_gather", size * count, count, n_fwd)
            size *= count
            summed = [a for a in gathered if a in dp]
            if summed:
                rows("all_reduce", size, math.prod(sizes[a] for a in summed), grad=True)

    def tree(ax_tree, m_tree, n_fwd, **kw):
        for ax, m in zip(tree_flatten(ax_tree, is_leaf=_is_axes_leaf)[0],
                         tree_flatten(m_tree)[0]):
            param(ax, tuple(m.shape), n_fwd, **kw)

    def model_sum(nbytes, n=fwd):
        """A ``sum_over`` of ``nbytes``, each forward."""
        rows("all_reduce", nbytes, mp, n)

    def model_copy(nbytes, n=1):
        """A ``copy_to``'s backward sum of ``nbytes``."""
        rows("all_reduce", nbytes, mp, n, grad=True)

    split = (lambda n: mp > 1 and n % mp == 0)
    h_split, k_split = split(h_all), split(k_all)
    ax, meta = lm_axes(cfg), lm_meta(cfg)
    head = "embed" if cfg.tied_embeddings else "head"
    for _ in range(microbatches):
        if cfg.frontend != "audio":
            tree(ax["embed"], meta["embed"], 1)
            if split(cfg.vocab_size):
                model_sum(t * d * c, 1)
        for kind, a, m in zip(cfg.layer_kinds, ax["blocks"], meta["blocks"]):
            moe = bool(cfg.n_experts) and kind != "rwkv6"
            for part in ("norm1", "mixer", "norm2", "ffn"):
                if not (part == "ffn" and moe and "model" in sizes):
                    tree(a[part], m[part], fwd)
            if kind in ("attn", "local_attn", "cross_attn"):
                kv_len = cfg.num_media_tokens if kind == "cross_attn" and cfg.frontend == \
                    "vision" else s
                if h_split:
                    model_sum(t * d * c)                      # wo's partial outputs
                    model_copy(t * d * c)                     # x into the query heads
                    if not k_split:
                        model_copy(b * kv_len * k_all * 2 * dh * c)  # k and v
                bs = (L._pick_block_size(s, cfg.window) if kind != "cross_attn" and cfg.causal
                      and cfg.window and s > L.FLASH_THRESHOLD else None)
                if bs and not h_split and split(s // bs):  # the blocked path's blocks
                    rows("all_gather", t * h_all * dh * c, mp, fwd)
                    model_copy(t * h_all * dh * c, 3)         # q, k and v
            elif kind == "rglru" and split(cfg.rnn_width):
                model_sum(t * 2 * cfg.rnn_width * 4)          # the gate products
                model_sum(t * d * c)                          # w_out's partial outputs
                model_copy(t * d * c)                         # x
                model_copy(3 * cfg.rnn_width * 4)             # b_a, b_x, lam
                rows("all_gather", t * 2 * cfg.rnn_width * 4, mp)
            if kind == "rwkv6":
                if split(cfg.d_ff):
                    model_sum(t * d * 4)
                    model_copy(t * d * 4)
            elif moe:
                e = cfg.n_experts
                if "model" in sizes and e % mp == 0:
                    param(a["ffn"]["router"], tuple(m["ffn"]["router"].shape), fwd, width=4,
                          keep=())
                    for n in ("w1", "w3", "w2"):
                        param(a["ffn"][n], tuple(m["ffn"][n].shape), fwd)
                    if "dense" in m["ffn"]:
                        tree(a["ffn"]["dense"], m["ffn"]["dense"], fwd)
                    model_sum(t * d * c, 1)                   # the experts' outputs
                    model_copy(t * d * c)                     # the tokens
                    model_copy(t * cfg.top_k * 4)             # the gates
                elif "model" in sizes:
                    tree(a["ffn"], m["ffn"], fwd, keep=())
                if dp:
                    rows("all_reduce", e * 4, dp_n, 2 * fwd + 1)
            elif split(cfg.d_ff):
                model_sum(t * d * c, 1)
                model_copy(t * d * c)
        tree(ax["final_norm"], meta["final_norm"], 1)
        tree(ax[head], meta[head], 1)
        if split(cfg.vocab_size):
            model_copy(t * d * c)                             # x into the head
            rows("all_reduce", t * 4, mp, 3)                  # the loss's max and two sums
        if dp:
            rows("all_reduce", 8, dp_n)                       # the valid-token count
            rows("all_reduce", 4, dp_n)                       # the loss
    rows("all_reduce", 4, math.prod(mesh_shape))              # the clip's sum of squares
    out.extend(_adafactor_rows(cfg, optimizer_config_from_model(cfg), mesh, sizes))
    gather = sum(p * (r - 1) // r for k, p, r in out if k == "all_gather")
    return {"collectives": out, "gather": gather, "grad_sum": got["grad_sum"]}


def _adafactor_rows(cfg, opt_cfg, mesh, sizes) -> list:
    """The sums over ranks of one Adafactor update (``optim/optimizers.py``:
    ``_adafactor_sliced``) on ``mesh``: for each leaf that ranks split or
    that is past ``SLICE_ELEMENTS``, a factored one's row and column
    sums of ``g^2`` and the mean of its row statistic over the ranks that
    split the reduced dim, then every leaf's sum of squares of its update
    over the ranks that split it (float32). None for AdamW."""
    from repro_torch.dist.sharding import _entry_axes
    from repro_torch.optim.optimizers import SLICE_ELEMENTS, make_optimizer
    from repro_torch.train.loop import _group_shardings, _leaf_groups, train_shardings

    if opt_cfg.name != "adafactor":
        return []
    p_sh, o_sh = train_shardings(cfg, mesh, opt_cfg)
    meta = lm_meta(cfg)
    state = make_optimizer(opt_cfg)[0](lm_stacked(cfg, meta, stack_meta))
    vr_sh, vc_sh = tree_leaves(o_sh.vr), tree_leaves(o_sh.vc)
    vrs, vcs = tree_leaves(state.vr), tree_leaves(state.vc)
    out = []

    def total(*entries):
        return math.prod(sizes[a] for e in entries for a in _entry_axes(e))

    def add(nbytes, ranks):
        if ranks > 1:
            out.append(("all_reduce", nbytes, ranks))

    for i, ((ps, stacked), sh) in enumerate(zip(_leaf_groups(cfg, opt_cfg, meta),
                                                _group_shardings(cfg, opt_cfg, p_sh))):
        if sh.replicas == math.prod(sizes.values()):
            continue  # whole on every rank: sliced, if at all, with no sums
        shape = ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
        spec, nd = sh.spec, len(shape)
        if (nd >= 2 and shape[-1] >= 2 and shape[-2] >= 2
                and math.prod(shape) >= opt_cfg.factored_threshold):
            vr = vr_sh[i].piece_shape(vrs[i].shape)
            vc = vc_sh[i].piece_shape(vcs[i].shape)
            add(math.prod(vr) * 4, total(spec[nd - 1]))
            add(math.prod(vc) * 4, total(spec[nd - 2]))
            add(math.prod(vr[:-1]) * 4, total(spec[nd - 2]))
        add(4, total(*spec))
    return out


def serve_wire_reckoning(cfg, kind: str, mesh_shape, batch: int, seq: int, length: int) -> list:
    """Every collective one rank runs in a tensor-parallel serving step
    (``lm_prefill`` of ``seq`` tokens, or one ``lm_decode`` token, ``kind``
    "prefill" or "decode") of a ``batch``-row batch into a cache of
    ``length`` positions, on a ``(data, model)`` or ``(pod, data, model)``
    mesh of ``mesh_shape``, from the shapes alone: ``[(kind, payload bytes,
    ranks in the group)]``, as :func:`repro_torch.dist.sharding.tally_collectives`
    records them. The rows:

    * each parameter a block (and the embedding, the head) reads, gathered
      over the data axes of its spec in the parameter dtype, ``model``
      kept, one all-gather an entry (``gather_param``); an MoE's experts
      on their expert-parallel path (the router whole in float32, the
      experts and the dense branch in the compute dtype, over the data
      axes) and its two aux statistics averaged over the data axes;
    * where ``model`` splits them: the vocabulary-parallel embedding's sum
      and the head's gather of the logits, each attention's and FFN's
      output sum (RWKV-6's channel mix in float32), RG-LRU's gate products
      (float32, both in one sum) and output sum, an MoE's expert sum; the
      blocked local path's outputs gathered where its blocks are split
      (a long prefill whose heads ``model`` does not split);
    * the caches: a prefill's keys and values gathered over the heads in
      one all-gather where the cache holds every kv head and this rank
      computed its own (a decode token's too); a decode step over slots
      split by ``model```
      gathers the query heads and all-reduces the row maxima and the
      rescaled numerators and denominators (float32)."""
    from repro_torch.dist.sharding import _entry_axes, _is_axes_leaf, spec_for
    from repro_torch.models.lm import lm_axes, lm_meta

    mesh_shape, axes = _mesh_of(None, mesh_shape)
    sizes = dict(zip(axes, mesh_shape))
    mesh = type("Shape", (), {"axis_names": axes, "shape": mesh_shape})()
    mp = sizes["model"]
    dp = tuple(a for a in ("pod", "data") if a in sizes and sizes[a] > 1)
    dp_n = math.prod(sizes[a] for a in dp)
    c = 4 if cfg.compute_dtype == "float32" else 2
    pd = 4 if cfg.param_dtype == "float32" else 2
    rows_entry = spec_for(("batch",), mesh, (batch,))[0]
    b = batch // math.prod(sizes[a] for a in _entry_axes(rows_entry))
    s = seq if kind == "prefill" else 1
    d, dh = cfg.d_model, cfg.head_dim
    h_all, k_all = max(cfg.n_heads, cfg.pad_heads_to or 0), cfg.n_kv_heads
    out: list = []

    def gather(ax, t, width=None, keep=("model",)):
        spec = spec_for(ax, mesh, t.shape)
        size = t.numel() * (width or pd) // math.prod(
            sizes[a] for e in spec for a in _entry_axes(e))
        for e in spec:
            count = math.prod(sizes[a] for a in _entry_axes(e) if a not in keep)
            if count > 1:
                out.append(("all_gather", size * count, count))
                size *= count

    def gather_tree(ax_tree, m_tree, width=None, keep=("model",)):
        for ax, t in zip(tree_flatten(ax_tree, is_leaf=_is_axes_leaf)[0],
                         tree_flatten(m_tree)[0]):
            gather(ax, t, width, keep)

    def model_sum(nbytes):
        out.append(("all_reduce", nbytes, mp))

    split = (lambda n: mp > 1 and n % mp == 0)
    h_split, k_split = split(h_all), split(k_all)

    def cache_heads(cache_len, tokens):
        """A cache holding every kv head fed by this rank's own."""
        slots = split(cache_len)
        heads_layout = not slots and k_split
        if mp > 1 and k_split and not heads_layout:
            out.append(("all_gather", b * tokens * k_all * 2 * dh * c, mp))
        return slots

    def decode_attend(slots):
        if slots:
            if h_split:
                out.append(("all_gather", b * h_all * dh * c, mp))
            out.append(("all_reduce", b * h_all * 4, mp))
            out.append(("all_reduce", b * h_all * (dh + 1) * 4, mp))

    ax, meta = lm_axes(cfg), lm_meta(cfg)
    if cfg.frontend != "audio":
        gather(ax["embed"], meta["embed"])
        if split(cfg.vocab_size):
            model_sum(b * s * d * c)
    for kind_l, a, m in zip(cfg.layer_kinds, ax["blocks"], meta["blocks"]):
        moe = bool(cfg.n_experts) and kind_l != "rwkv6"
        for part in ("norm1", "mixer", "norm2", "ffn"):
            if not (part == "ffn" and moe and "model" in sizes):
                gather_tree(a[part], m[part])
        if kind_l in ("attn", "local_attn"):
            cache_len = min(length, cfg.window or length)
            if kind == "prefill":
                cache_heads(cache_len, s)
                bs = (L._pick_block_size(s, cfg.window)
                      if cfg.causal and cfg.window and s > L.FLASH_THRESHOLD else None)
                if bs and not h_split and split(s // bs):  # the blocked path's blocks
                    out.append(("all_gather", b * s * h_all * dh * c, mp))
            else:
                decode_attend(cache_heads(cache_len, 1))
            if h_split:
                model_sum(b * s * d * c)
        elif kind_l == "cross_attn":
            if kind == "prefill":
                cache_heads(cfg.num_media_tokens, cfg.num_media_tokens)
            else:
                decode_attend(split(cfg.num_media_tokens))
            if h_split:
                model_sum(b * s * d * c)
        elif kind_l == "rglru" and split(cfg.rnn_width):
            model_sum(b * s * 2 * cfg.rnn_width * 4)
            model_sum(b * s * d * c)
        if kind_l == "rwkv6":
            if split(cfg.d_ff):
                model_sum(b * s * d * 4)
        elif moe:
            e = cfg.n_experts
            if "model" in sizes and e % mp == 0:
                gather(a["ffn"]["router"], m["ffn"]["router"], width=4, keep=())
                for n in ("w1", "w3", "w2"):
                    gather(a["ffn"][n], m["ffn"][n], width=c)
                if "dense" in m["ffn"]:
                    gather_tree(a["ffn"]["dense"], m["ffn"]["dense"], width=c)
            elif "model" in sizes:
                gather_tree(a["ffn"], m["ffn"], keep=())
            if dp:
                out.extend([("all_reduce", e * 4, dp_n)] * 2)
            if "model" in sizes and e % mp == 0:
                model_sum(b * s * d * c)
        elif split(cfg.d_ff):
            model_sum(b * s * d * c)
    head = "embed" if cfg.tied_embeddings else "head"
    gather(ax[head], meta[head])
    if split(cfg.vocab_size):
        out.append(("all_gather", b * cfg.vocab_size * c, mp))
    return out


# -- counters ------------------------------------------------------------------------

# Ops that move no bytes: allocations without a write (views are told apart
# by their schema, ``OpOverload.is_view``).
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_local_scalar_dense"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_tensors(xs, found: list) -> list:
    """The tensors among an op's arguments or results (tensors, and lists
    and tuples of them): a flat scan, cheaper than a tree walk on every op."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, (list, tuple)):
            _op_tensors(x, found)
    return found


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _StepCounter(TorchDispatchMode):
    """Live bytes by category with their peak, and each op's traffic.

    A storage is counted from the op that creates it until it is freed (a
    weak reference's callback). Arguments are registered up front under
    their own categories; a new storage is an ``activations`` one when its
    op reads a tensor that requires grad with grad mode on, else a
    ``temporaries`` one; :meth:`relabel` moves a storage to another
    category (the gradients, when ``torch.autograd.grad`` returns them)."""

    def __init__(self):
        super().__init__()
        self.live: dict[str, int] = {}
        self.peak: dict[str, int] = {}
        self.peak_total = 0
        self.traffic = 0
        self._refs: dict[int, tuple] = {}

    def track(self, t: torch.Tensor, category: str) -> None:
        st = t.untyped_storage()
        if id(st) in self._refs:
            return
        n = st.nbytes()
        key = id(st)

        def freed(_ref, key=key):
            _, cat, nb = self._refs.pop(key)
            self.live[cat] -= nb

        self._refs[key] = (weakref.ref(st, freed), category, n)
        self.live[category] = self.live.get(category, 0) + n
        self._update_peak()

    def relabel(self, t: torch.Tensor, category: str) -> None:
        key = id(t.untyped_storage())
        if key not in self._refs:
            return
        ref, old, n = self._refs[key]
        self.live[old] -= n
        self.live[category] = self.live.get(category, 0) + n
        self._refs[key] = (ref, category, n)

    def _update_peak(self) -> None:
        total = sum(self.live.values())
        if total > self.peak_total:
            self.peak_total = total
            self.peak = dict(self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            return out
        ins = _op_tensors(args, _op_tensors((kwargs or {}).values(), []))
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,), [])
        if not func.is_view and func._opname not in _NO_TRAFFIC:
            self.traffic += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        cat = ("activations" if torch.is_grad_enabled() and any(t.requires_grad for t in ins)
               else "temporaries")
        for t in outs:
            self.track(t, cat)
        return out


@contextmanager
def _labelled_gradients(counter: _StepCounter):
    """``torch.autograd.grad`` relabels what it returns as ``gradients``."""
    grad = torch.autograd.grad

    def labelled(*args, **kwargs):
        out = grad(*args, **kwargs)
        for g in out:
            if isinstance(g, torch.Tensor):
                counter.relabel(g, "gradients")
        return out

    torch.autograd.grad = labelled
    try:
        yield
    finally:
        torch.autograd.grad = grad


@contextmanager
def fake_group(world: int, rank: int):
    """A ``"fake"`` process group of ``world`` ranks as rank ``rank``, torn
    down on exit. Raises if a group is already initialised: the caller's is
    never replaced."""
    if dist.is_initialized():
        raise RuntimeError("the dry run emulates its rank in a process group of its own; "
                           "one is already initialised in this process")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_of(mesh_kind: str | None, mesh_shape) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``(shape, axes)``: the production mesh of ``mesh_kind``, or
    ``mesh_shape`` over the axes of its length."""
    if mesh_shape is None:
        return MESHES[mesh_kind]
    mesh_shape = tuple(int(n) for n in mesh_shape)
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(mesh_shape))
    if axes is None:
        raise ValueError(f"mesh shape {mesh_shape}: want (data, model) or (pod, data, model)")
    return mesh_shape, axes


def _rank_step(cfg, shape, mesh: Mesh):
    """``(spec, args, labels, note)``: the cell's step, the arguments this
    rank hands it with a category for each, and how a serving cell runs."""
    spec = make_lowering_spec(cfg, shape, mesh)
    experts = "; the experts split over model (expert-parallel)" if cfg.n_experts else ""
    if shape.kind == "train":
        params, state = (shard_tree(a, s) for a, s in zip(spec.args[:2], spec.in_shardings[:2]))
        note = ("tensor-parallel training: the rank's pieces of the weights and the optimizer "
                "state under the train-mode placements (heads, kv heads, mlp and vocab over "
                "model, fsdp over the data axes), its rows of the global batch, its model "
                "share of each block and a vocabulary-parallel loss" + experts)
        return spec, (params, state, spec.args[2]), ("parameters", "optimizer_state",
                                                     "batch"), note
    spec.meta["rank_rows"] = spec.in_shardings[1].piece_shape((shape.global_batch,))[0]
    args = tuple(a if sh is None else shard_tree(a, sh)
                 for a, sh in zip(spec.args, spec.in_shardings))
    labels = ("parameters", "batch", "cache") + ("batch",) * (len(spec.args) - 3)
    if shape.kind == "decode":
        labels = ("parameters", "batch", "cache", None)
    note = ("tensor-parallel serving: the rank's pieces of the weights and the cache under "
            "the decode-mode placements (heads, kv heads, mlp, vocab and the cache's kv_seq "
            "over model, fsdp over the data axes) and its rows of the batch" + experts)
    return spec, args, labels, note


def _storages_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _roofline(cfg, flops: float, nbytes: float, wire: float) -> dict:
    peak = H100_SXM.peak_flops_bf16 if cfg.compute_dtype == "bfloat16" else H100_SXM.peak_flops_f32
    terms = {"compute": flops / peak, "memory": nbytes / H100_SXM.hbm_bw,
             "collective": wire / H100_SXM.ici_bw}
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"], "dominant": max(terms, key=terms.get)}


def trace_step(cfg, shape, mesh_shape, *, rank: int = 0) -> dict:
    """The dry run of ``cfg``'s step on ``shape`` for rank ``rank`` of a mesh
    of ``mesh_shape`` (``(data, model)`` or ``(pod, data, model)``): the
    JSON blocks of :func:`run_cell`, without ``cell``, and nothing written."""
    mesh_shape, axes = _mesh_of(None, mesh_shape)
    n_dev = math.prod(mesh_shape)
    with fake_group(n_dev, rank):
        mesh = Mesh(axes, mesh_shape, rank_coords(rank, mesh_shape), META, "nccl",
                    dist.group.WORLD)
        spec, args, labels, note = _rank_step(cfg, shape, mesh)
        counter = _StepCounter()
        arg_bytes = {}
        for arg, label in zip(args, labels):
            if label is None:
                continue
            ts = _tensors(arg)
            arg_bytes[label] = arg_bytes.get(label, 0) + _storages_bytes(ts)
            for t in ts:
                counter.track(t, label)
        _build.META_LAUNCHES.clear()
        flops = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with metrics.using() as reg, sharding.tally_collectives() as tally, flops, counter, \
                _labelled_gradients(counter):
            out = spec.fn(*args)
        t_trace = time.perf_counter() - t0
        kernels = {k: dict(v) for k, v in _build.META_LAUNCHES.items()}
        outs = _tensors(out)
        arg_ids = {id(t.untyped_storage()) for a in args for t in _tensors(a)}
        out_bytes = _storages_bytes(outs)
        aliased = _storages_bytes([t for t in outs if id(t.untyped_storage()) in arg_ids])
        peak, peak_by = counter.peak_total, counter.peak
        counters = {k: v for k, v in reg.snapshot()["counters"].items() if k.startswith("dist.")}
        del out, outs, args

    coll: dict[str, dict] = {}
    for kind, payload, ranks in tally:
        row = coll.setdefault(kind, {"calls": 0, "payload_bytes": 0, "wire_bytes": 0.0})
        row["calls"] += 1
        row["payload_bytes"] += payload
        row["wire_bytes"] += ring_wire_bytes(kind, payload, ranks)
    wire = sum(r["wire_bytes"] for r in coll.values())
    k_flops = sum(k["flops"] for k in kernels.values())
    k_bytes = sum(k["bytes"] for k in kernels.values())
    flops_dev = flops.get_total_flops() + k_flops
    bytes_dev = counter.traffic + k_bytes
    ana = cell_flops(cfg, shape)
    counted_total = flops_dev * n_dev
    roof = _roofline(cfg, flops_dev, bytes_dev, wire)
    roof.update(model_flops=ana["reference_nd"], counted_flops_total=counted_total,
                useful_flops_ratio=ana["reference_nd"] / counted_total if counted_total else None)
    meta = dict(spec.meta, rank=rank, coords=list(rank_coords(rank, mesh_shape)),
                mesh_axes=list(axes), n_devices=n_dev, depth=cfg.n_layers)
    return {
        "meta": meta,
        "status": "ok",
        "note": note,
        "device": {"name": "NVIDIA H100 SXM (data sheet)", "power_limit_w": POWER_LIMIT_W,
                   "peak_flops_bf16": H100_SXM.peak_flops_bf16,
                   "peak_flops_f32": H100_SXM.peak_flops_f32,
                   "hbm_bytes_per_s": H100_SXM.hbm_bw, "link_bytes_per_s": H100_SXM.ici_bw,
                   "hbm_bytes": HBM_BYTES},
        "timings_s": {"trace": t_trace},
        "memory_analysis": {
            "argument_bytes": sum(arg_bytes.values()),
            "argument_bytes_by_kind": arg_bytes,
            "output_bytes": out_bytes,
            "aliased_output_bytes": aliased,
            "peak_bytes": peak,
            "peak_bytes_by_category": peak_by,
            "fits": peak <= HBM_BYTES,
        },
        "cost_analysis": {"flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
                          "counted_flops": flops.get_total_flops(),
                          "counted_bytes": counter.traffic},
        "kernels": kernels,
        "collectives": {"by_kind": coll, "wire_bytes_per_device": wire, "counters": counters},
        "analytic": {"flops_global": ana["analytic"],
                     "hbm_bytes_global": cell_hbm_bytes(cfg, shape),
                     "flops_per_device": ana["analytic"] / n_dev,
                     "counted_over_analytic": (counted_total / ana["analytic"]
                                               if ana["analytic"] else None)},
        "roofline": roof,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path, *, overrides=None,
             tag_suffix: str = "", mesh_shape=None, rank: int = 0) -> dict:
    """Traces one cell for rank ``rank`` of the ``mesh_kind`` production mesh
    (``mesh_shape``, e.g. ``(2, 4)`` over ``("data", "model")``, in its
    place), writes its JSON under ``out_dir`` and returns it. ``overrides``
    replace config fields (``n_layers`` to cut depth)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = get_shape(shape_name)
    tag = f"{arch}__{shape_name}__{mesh_kind}{tag_suffix}"
    result = {"cell": tag, **trace_step(cfg, shape, _mesh_of(mesh_kind, mesh_shape)[0],
                                        rank=rank)}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = all_cells() if args.all else [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            tag = f"{arch}__{shape}__{mk}"
            path = out_dir / f"{tag}.json"
            if args.skip_existing and path.exists():
                try:
                    if json.loads(path.read_text()).get("status") == "ok":
                        print(f"[dryrun] {tag}: exists, skipping", flush=True)
                        continue
                except (OSError, ValueError):
                    pass
            try:
                r = run_cell(arch, shape, mk, out_dir)
                rf, mem = r["roofline"], r["memory_analysis"]
                print(
                    f"[dryrun] {tag}: OK trace={r['timings_s']['trace']:.1f}s "
                    f"compute={rf['compute_s']:.3e}s memory={rf['memory_s']:.3e}s "
                    f"coll={rf['collective_s']:.3e}s dom={rf['dominant']} "
                    f"useful={rf['useful_flops_ratio']:.2f} "
                    f"peak={mem['peak_bytes'] / 1e9:.2f}GB fits={mem['fits']}",
                    flush=True,
                )
            except Exception as e:
                failures += 1
                err = {"cell": tag, "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()}
                out_dir.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(err, indent=1))
                print(f"[dryrun] {tag}: FAIL {e!r}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
