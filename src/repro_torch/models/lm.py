"""The LMs as one composable decoder/encoder: the recurrent ones (RWKV-6,
RecurrentGemma), the dense ones (qwen1.5, starcoder2, nemotron-4, glm4),
the MoE ones (qwen3-moe, arctic), llama-3.2-vision and hubert.

The port of ``repro/models/lm.py`` for every block kind (``attn``,
``local_attn``, ``cross_attn``, ``rglru``, ``rwkv6``, each with the MoE in
place of its FFN when the config has experts) and both media frontends:
``frontend="vision"`` reads ``memory`` (``(B, num_media_tokens, D)``
image-patch embeddings) in its ``cross_attn`` layers, and
``frontend="audio"`` takes precomputed frame embeddings ``(B, S, D)`` in
place of tokens (its ``embed`` table is built and never read, as in the
JAX package; the trainer gives it a zero gradient). :func:`build_lm` returns an
:class:`LM` module whose blocks stand in layer order, the block pattern
cycled to ``n_layers``; the JAX package's scan over stacked superblocks
becomes a plain loop over an ``nn.ModuleList``, and its sharding
constraints are dropped: the port has no partitioner to steer, and on a
mesh its layers carry out the placements themselves.

Logical axes and shapes: :func:`lm_axes` gives every parameter's JAX
logical axes in the per-layer layout (from each block kind's table beside
its init), :func:`lm_meta` every leaf's global shape on the meta device,
and :func:`lm_tree` draws a tree leaf by leaf through an
:class:`~repro_torch.models.layers.Init`, whose ``place`` lets the sharded
trainer keep a rank's piece of each leaf.

Serving entry points (functions of ``(cfg, model, ...)``, as in the JAX
package; ``cfg`` may differ from ``model.cfg`` in its compute dtype), all
without gradients and all taking ``memory=`` (vision):

  * :func:`lm_forward` — tokens (or frames) -> (logits (B, S, V), aux: the
    MoE loss summed over layers)
  * :func:`lm_prefill` — runs the prompt, fills the cache -> (last logits, cache)
  * :func:`lm_decode`  — one token with the cache at position ``pos``

**Tensor-parallel serving.** Called under an ambient mesh
(:func:`~repro_torch.dist.sharding.use_mesh`), :func:`lm_prefill` and
:func:`lm_decode` take this rank's pieces: of the parameters by
:func:`serving_shardings` (the JAX decode-mode placements: heads, kv
heads, ``mlp`` and ``vocab`` on ``model``, ``fsdp`` on the data axes), of
the cache by :func:`cache_shardings` (``kv_seq`` on ``model`` first), and
of the batch's rows over the data axes. Each block gathers its data-axis
pieces (``gather_param(..., keep=("model",))``; an MoE's experts gather
their own) and computes its ``model`` share (``layers`` and
``recurrent``); the embedding is a masked local lookup summed over
``model``, the head gives this rank's vocabulary columns, gathered into
the ``(B, V)`` logits both steps return. The logits equal the one-process
path's; each rank stores and computes its share.

**Tensor-parallel training** runs the same blocks (:func:`_run_blocks`,
one block function for both) on the trainer's pieces
(:func:`lm_forward_train` with ``shardings``), under autograd: each
replicated activation enters a split region through ``copy_to``, and the
logits stay this rank's vocabulary columns, which
:func:`token_nll_sharded` turns into the loss without a ``(B, S, V)``
tensor on any rank.

A cache (:func:`build_cache`) is a list with one entry per layer; a
``cross_attn`` layer's holds the media keys and values ``{"k", "v"}``
(``(B, num_media_tokens, K, Dh)``), written by the prefill and read by
every decode step. A prefill without ``memory`` takes them from the prompt
itself and REPLACES the entry with the prompt's ``(B, S, K, Dh)``, as the
JAX package does (its server never passes ``memory``).

Training works on a parameter TREE, as the JAX package's does:
:func:`lm_params` gives a model's ``{"embed", "blocks": [per layer
{"norm1", "mixer", "norm2", "ffn"}], "final_norm", "head"?}`` (the
module's own tensors, no copies), :func:`lm_forward_train` runs it under
autograd (each block under ``torch.utils.checkpoint`` when ``cfg.remat``,
where the JAX package uses ``jax.checkpoint``; ``remat_policy="dots"``
keeps the matmuls' outputs and recomputes the rest, as ``dots_saveable``
does), and :func:`lm_loss` is the
JAX package's cross-entropy. The serving functions take the module or a
tree alike: both are read as ``params["name"]``.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (
    NamedSharding,
    _ambient_mesh,
    _is_axes_leaf,
    all_reduce,
    copy_to,
    gather_dim,
    gather_param,
    spec_for,
    sum_over,
    use_mesh,
)
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


class Block(nn.Module):
    """One layer: norm1, the token mixer, norm2, the FFN (channel mix)."""

    PARTS = ("norm1", "mixer", "norm2", "ffn")

    def __init__(self, kind: str, params: dict[str, dict[str, Tensor]]):
        super().__init__()
        self.kind = kind
        for part in self.PARTS:
            setattr(self, part, L.Params(params[part]))

    def __getitem__(self, part: str):
        return getattr(self, part)


class LM(nn.Module):
    """Embedding, blocks in layer order, final norm and (untied) head."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        if len(params["blocks"]) != cfg.n_layers:
            raise ValueError(f"{len(params['blocks'])} blocks for {cfg.n_layers} layers")
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(kind, p) for kind, p in zip(cfg.layer_kinds, params["blocks"]))
        self.final_norm = L.Params(params["final_norm"])
        self.head = (None if cfg.tied_embeddings
                     else nn.Parameter(params["head"], requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def __getitem__(self, name: str):
        return getattr(self, name)


def lm_params(model: LM) -> dict:
    """``model``'s parameter tree: the module's own tensors (shared storage,
    no copies), in the layout :func:`lm_forward_train` and :func:`lm_loss`
    read and ``LM(cfg, tree)`` builds a module from."""
    tree = {"embed": model.embed,
            "blocks": [{part: b[part].tree() for part in Block.PARTS} for b in model.blocks],
            "final_norm": model.final_norm.tree()}
    if model.head is not None:
        tree["head"] = model.head
    return tree


def lm_stacked(cfg: ModelConfig, tree: dict, fn, is_leaf=None) -> dict:
    """``tree`` (the per-layer layout of :func:`lm_params`) in the JAX
    package's layout: ``{"embed", "scan": {"b<i>": ...}, "tail": [...],
    "final_norm", "head"?}``, the scanned superblocks' leaves stacked on a
    leading ``n_super`` axis there. Each leaf is ``fn(tensors, stacked)``:
    the per-layer tensors of one JAX leaf and whether the JAX package
    stacks them. ``is_leaf`` as in :func:`~repro_torch.tree.tree_map`
    (a tree of logical axes: :func:`stack_axes`)."""
    width, n_super = len(cfg.block_pattern), cfg.n_super
    blocks = tree["blocks"]

    def one(t):
        return fn([t], False)

    out = {"embed": one(tree["embed"]),
           "final_norm": tree_map(one, tree["final_norm"], is_leaf=is_leaf),
           "tail": [tree_map(one, b, is_leaf=is_leaf) for b in blocks[n_super * width:]]}
    if n_super:
        out["scan"] = {f"b{i}": tree_map(lambda *ts: fn(list(ts), True),
                                         *blocks[i:n_super * width:width], is_leaf=is_leaf)
                       for i in range(width)}
    if "head" in tree:
        out["head"] = one(tree["head"])
    return out


def stack_axes(axes: list, stacked: bool) -> tuple:
    """One JAX leaf's logical axes from its layers' (an ``fn`` of
    :func:`lm_stacked`): ``("layers",) + ax`` on a scanned leaf, as the
    JAX ``build_lm`` writes them."""
    return ("layers",) + axes[0] if stacked else axes[0]


def stack_meta(tensors: list, stacked: bool) -> Tensor:
    """One JAX leaf's global shape and dtype from its layers' (an ``fn`` of
    :func:`lm_stacked`), on the meta device."""
    t = tensors[0]
    return torch.empty(((len(tensors),) if stacked else ()) + tuple(t.shape), dtype=t.dtype,
                       device="meta")


def lm_leaf_groups(cfg: ModelConfig, tree: dict) -> list[tuple[list, bool]]:
    """The leaves of ``tree`` grouped by the JAX layout's leaves, in its
    flatten order: ``(per-layer tensors, stacked)`` each (see
    :func:`lm_stacked`)."""
    groups: list = []

    def note(tensors, stacked):
        groups.append((tensors, stacked))
        return len(groups) - 1

    return [groups[i] for i in tree_leaves(lm_stacked(cfg, tree, note))]


def _init_block(cfg: ModelConfig, kind: str, ini: L.Init) -> dict:
    mixer = {"attn": L.init_attention, "local_attn": L.init_attention,
             "cross_attn": lambda cfg, ini: L.init_attention(cfg, ini, cross=True),
             "rglru": R.init_rglru, "rwkv6": R.init_rwkv_tmix}[kind]
    if kind == "rwkv6":
        ffn = R.init_rwkv_cmix
    else:
        ffn = L.init_moe if cfg.n_experts else L.init_ffn
    return {"norm1": L.init_norm(cfg, ini), "mixer": mixer(cfg, ini),
            "norm2": L.init_norm(cfg, ini), "ffn": ffn(cfg, ini)}


def lm_tree(cfg: ModelConfig, ini: L.Init) -> dict:
    """A parameter tree of ``cfg`` (:func:`lm_params`'s layout) drawn leaf by
    leaf from ``ini``: :func:`build_lm`'s weights, or with ``ini.place`` a
    rank's pieces of them (the sharded trainer)."""
    params = {"embed": ini.fan_in((cfg.vocab_size, cfg.d_model), fan_axes=(1,))}
    params["blocks"] = [_init_block(cfg, kind, ini) for kind in cfg.layer_kinds]
    params["final_norm"] = L.init_norm(cfg, ini)
    if not cfg.tied_embeddings:
        params["head"] = ini.fan_in((cfg.d_model, cfg.vocab_size))
    return params


class _Shapes:
    """An :class:`~repro_torch.models.layers.Init` stand-in that gives each
    leaf's shape (a tuple) and makes no tensor."""

    def fan_in(self, shape, **_) -> tuple:
        return tuple(shape)

    def const(self, shape, value) -> tuple:
        return tuple(shape)

    def zeros(self, shape) -> tuple:
        return tuple(shape)

    ones = zeros


def lm_shapes(cfg: ModelConfig) -> dict:
    """``cfg``'s parameter tree with each leaf's global shape (a tuple) in
    its place: what :func:`lm_meta` gives, without making a tensor (the
    dry run counts every tensor a serving step makes, meta ones too)."""
    return lm_tree(cfg, _Shapes())


def lm_meta(cfg: ModelConfig) -> dict:
    """``cfg``'s parameter tree on the meta device: every leaf's global shape
    and dtype, nothing allocated."""
    return lm_tree(cfg, L.Init(None, L.dt(cfg), "meta"))


def lm_draw_order(cfg: ModelConfig) -> list[int]:
    """The flatten-order index of each leaf :func:`lm_tree` draws, in the
    order it draws them."""
    drawn: list = []
    meta = lm_tree(cfg, L.Init(None, L.dt(cfg), "meta", place=lambda t: drawn.append(t) or t))
    index = {id(t): i for i, t in enumerate(tree_leaves(meta))}
    return [index[id(t)] for t in drawn]


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    mixer = {"attn": L.ATTENTION_AXES, "local_attn": L.ATTENTION_AXES,
             "cross_attn": L.ATTENTION_AXES, "rglru": R.RGLRU_AXES, "rwkv6": R.RWKV_TMIX_AXES}[kind]
    if kind == "rwkv6":
        ffn = R.RWKV_CMIX_AXES
    else:
        ffn = L.MOE_AXES if cfg.n_experts else L.FFN_AXES
    return {"norm1": L.NORM_AXES, "mixer": mixer, "norm2": L.NORM_AXES, "ffn": ffn}


def _pick(table: dict, tree: dict) -> dict:
    """The entries of ``table`` (nested groups nested) that ``tree`` has."""
    return {k: _pick(table[k], v) if isinstance(v, dict) else table[k] for k, v in tree.items()}


def lm_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter of ``cfg``'s LM, in
    :func:`lm_params`'s per-layer layout: the JAX ``build_lm``'s axes tree,
    read from each block kind's table. ``lm_stacked(cfg, lm_axes(cfg),
    stack_axes, is_leaf=...)`` gives it in the JAX layout."""
    meta = lm_shapes(cfg)
    out = {"embed": ("vocab", "fsdp"),
           "blocks": [_pick(_block_axes(cfg, kind), b)
                      for kind, b in zip(cfg.layer_kinds, meta["blocks"])],
           "final_norm": _pick(L.NORM_AXES, meta["final_norm"])}
    if "head" in meta:
        out["head"] = ("fsdp", "vocab")
    return out


def build_lm(cfg: ModelConfig, seed: int = 0, *, device=None) -> LM:
    """A model of ``cfg``'s published shapes with random weights drawn from
    ``seed`` (fan-in init, as the JAX package's ``build_lm``), made
    directly on ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, lm_tree(cfg, L.Init(gen, L.dt(cfg), dev)))


# ---------------------------------------------------------------------------
# Cache init (serving).
# ---------------------------------------------------------------------------


def _block_cache(cfg: ModelConfig, kind: str, batch: int, length: int, device):
    if kind in ("attn", "local_attn"):
        return L.init_cache(cfg, batch, min(length, cfg.window or length), device=device)
    if kind == "cross_attn":
        # The media keys and values, filled at prefill, read by every decode.
        shape = (batch, cfg.num_media_tokens, cfg.n_kv_heads, cfg.head_dim)
        return {"k": L.make_buf(shape, L.dt(cfg, "compute"), device),
                "v": L.make_buf(shape, L.dt(cfg, "compute"), device)}
    if kind == "rglru":
        return R.rglru_cache_init(cfg, batch, device=device)
    if kind == "rwkv6":
        return R.rwkv_cache_init(cfg, batch, device=device)
    raise ValueError(kind)


def build_cache(cfg: ModelConfig, batch: int, length: int, *, device=None) -> list:
    """Empty serving caches, one per layer. ``length`` is the max context;
    local attention clamps its ring to the window. On ``device="meta"``:
    the shapes and dtypes alone."""
    dev = resolve_device(device)
    return [_block_cache(cfg, kind, batch, length, dev) for kind in cfg.layer_kinds]


def cache_axes(cfg: ModelConfig) -> list:
    """The logical axes of every leaf of :func:`build_cache`'s cache, one
    entry per layer (the JAX ``build_cache``'s axes, per layer)."""
    table = {"attn": L.CACHE_AXES, "local_attn": L.CACHE_AXES,
             "cross_attn": {k: L.CACHE_AXES[k] for k in ("k", "v")},
             "rglru": R.RGLRU_CACHE_AXES, "rwkv6": R.RWKV_CACHE_AXES}
    return [table[kind] for kind in cfg.layer_kinds]


@functools.lru_cache(maxsize=32)
def _serving_specs(cfg: ModelConfig, axis_names: tuple, shape: tuple) -> tuple:
    """The decode-mode spec of every parameter (flattened) and the tree's
    structure, for a mesh of ``axis_names`` and ``shape``."""
    mesh = _MeshShape(axis_names, shape)
    axes = tree_flatten(lm_axes(cfg), is_leaf=_is_axes_leaf)[0]
    shapes, treedef = tree_flatten(lm_shapes(cfg), is_leaf=_is_shape)
    return tuple(spec_for(a, mesh, shp, mode="decode") for a, shp in zip(axes, shapes)), treedef


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, int) for e in x)


class _MeshShape:
    """A mesh's axis names and shape: all a spec needs."""

    def __init__(self, axis_names, shape):
        self.axis_names, self.shape = tuple(axis_names), tuple(shape)


def serving_shardings(cfg: ModelConfig, mesh) -> dict:
    """The placement of every parameter of ``cfg``'s LM for tensor-parallel
    serving on ``mesh`` (:func:`lm_params`' layout, :class:`NamedSharding`
    leaves): ``tree_shardings(lm_axes(cfg), mesh, lm_meta(cfg),
    mode="decode")``. ``.piece`` of each gives a rank's share."""
    specs, treedef = _serving_specs(cfg, tuple(mesh.axis_names), tuple(mesh.shape))
    return tree_unflatten(treedef, [NamedSharding(mesh, sp) for sp in specs])


def cache_shardings(cfg: ModelConfig, mesh, cache: list) -> list:
    """The placement of every leaf of ``cache`` (:func:`build_cache`'s,
    whole, or its meta shapes) for tensor-parallel serving on ``mesh``."""
    axes = tree_flatten(cache_axes(cfg), is_leaf=_is_axes_leaf)[0]
    leaves, treedef = tree_flatten(cache)
    return tree_unflatten(treedef, [NamedSharding(mesh, spec_for(a, mesh, t.shape, mode="decode"))
                                    for a, t in zip(axes, leaves)])


def build_lm_pieces(cfg: ModelConfig, mesh, seed: int = 0, *, device=None) -> dict:
    """This rank's pieces, for tensor-parallel serving on ``mesh``
    (:func:`serving_shardings`), of the weights :func:`build_lm` draws
    from ``seed`` on ``device`` (``None``: the mesh's): every leaf drawn
    whole from the same generator stream and cut to its piece at once, so
    no rank holds two whole leaves. A tree in :func:`lm_params`' layout."""
    dev = resolve_device(mesh.device if device is None else device)
    shardings = tree_leaves(serving_shardings(cfg, mesh))
    order = iter(lm_draw_order(cfg))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lm_tree(cfg, L.Init(gen, L.dt(cfg), dev,
                               place=lambda t: shardings[next(order)].piece(t)))


def shard_tree(tree, shardings):
    """This rank's piece of every leaf of ``tree`` (whole tensors) under
    ``shardings`` (a tree of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [sh.piece(t) for t, sh in zip(leaves, tree_leaves(shardings))])


# ---------------------------------------------------------------------------
# Apply.
# ---------------------------------------------------------------------------


def _apply_block(cfg, kind: str, p, x: Tensor, *, cache, pos, prefill, memory=None, mesh=None):
    """One block of ``kind`` with parameters ``p`` (a :class:`Block` or its
    tree; with ``mesh``, this rank's ``model`` share of them). Returns
    ``(x, new cache, aux)``, ``aux`` the MoE loss (None without experts, so
    other blocks add no work)."""
    aux = None
    h = L.apply_norm(cfg, p["norm1"], x)
    new_cache = cache
    if kind in ("attn", "local_attn"):
        if cache is not None and not prefill:
            y, new_cache = L.attention_apply(cfg, p["mixer"], h, window=cfg.window,
                                             cache=cache, pos=pos, mesh=mesh)
        else:
            y, _ = L.attention_apply(cfg, p["mixer"], h, window=cfg.window, mesh=mesh)
            if prefill:
                _, k, v = L._project_qkv(cfg, p["mixer"], h, mesh=mesh)
                if cfg.rope:
                    k = L.rope_rotate(k, torch.arange(h.shape[1], device=h.device),
                                      cfg.rope_theta)
                new_cache = L.cache_fill_from_prefill(cfg, cache, k, v, mesh=mesh)
    elif kind == "cross_attn":
        if cache is not None and not prefill:
            y = _cross_attn_cached(cfg, p["mixer"], h, cache, mesh)
        else:
            y, _ = L.attention_apply(cfg, p["mixer"], h, cross=True, memory=memory, mesh=mesh)
            if prefill:
                # Without memory the keys and values are the prompt's: the
                # entry is replaced, shape and all, as in the JAX package.
                _, k, v = L._project_qkv(cfg, p["mixer"], h, memory, mesh)
                new_cache = L.cross_cache_fill(cfg, cache, k, v, mesh=mesh)
    elif kind == "rglru":
        y, c2 = R.apply_rglru(cfg, p["mixer"], h, cache=None if prefill else cache, mesh=mesh)
        if cache is not None:
            new_cache = c2
    else:  # rwkv6
        y, c2 = R.apply_rwkv_tmix(cfg, p["mixer"], h,
                                  cache=None if (prefill or cache is None) else cache["tmix"])
        if cache is not None:
            new_cache = {**cache, "tmix": c2}
    x = x + y

    h = L.apply_norm(cfg, p["norm2"], x)
    if kind == "rwkv6":
        y, c3 = R.apply_rwkv_cmix(cfg, p["ffn"], h,
                                  cache=None if (prefill or cache is None) else cache["cmix"],
                                  mesh=mesh)
        if cache is not None:
            new_cache = {**new_cache, "cmix": c3}
    elif cfg.n_experts:
        y, aux = L.apply_moe(cfg, p["ffn"], h)
    else:
        y = L.apply_ffn(cfg, p["ffn"], h, mesh)
    return x + y, new_cache, aux


def _cross_attn_cached(cfg, p, x: Tensor, cache: dict, mesh=None) -> Tensor:
    """A decode step's cross-attention against the media keys and values
    the prefill wrote (the cache is read, never written)."""
    cdt = L.dt(cfg, "compute")
    q = torch.einsum("bsd,dhk->bshk", x.to(cdt), p["wq"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    h_off = L._heads(cfg, p, mesh)[0]
    out = L.attend_cache(cfg, q, cache, None, h_off=h_off, mesh=mesh)
    return L.attention_out(cfg, p, out, h_off=h_off, mesh=mesh, cross=True)


def _gathered(tree, shardings, dtype=None):
    """``tree`` (this rank's pieces: a tensor or a dict of them) with its
    data-axis pieces gathered and its ``model`` pieces kept
    (:func:`~repro_torch.dist.sharding.gather_param`, cast to ``dtype``
    first where given)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [gather_param(t, sh, dtype, keep=("model",))
                                    for t, sh in zip(leaves, tree_leaves(shardings))])


def _rank_block(cfg, kind: str, p, shardings: dict, mesh, dtype=None) -> dict:
    """Block ``p`` (this rank's pieces) with its data-axis pieces gathered
    and its ``model`` pieces kept: what the block computes with (cast to
    ``dtype`` before the wire where given: the trainer's compute dtype).
    Under a ``model`` axis an MoE's parameters stay pieces (``apply_moe``
    gathers them on its expert-parallel path)."""
    out = {}
    for part in Block.PARTS:
        tree = p[part].tree() if isinstance(p[part], L.Params) else p[part]
        if part == "ffn" and cfg.n_experts and kind != "rwkv6" and "model" in mesh.axis_names:
            out[part] = tree if dtype is None else tree_map(lambda t: t.to(dtype), tree)
        else:
            out[part] = _gathered(tree, shardings[part], dtype)
    return out


def _run_blocks(cfg, params, x: Tensor, *, memory=None, cache=None, pos=None, prefill=False,
                shardings=None, dtype=None, remat=False):
    """Every block in layer order -> ``(x, new cache, aux summed over
    layers)``; with ``shardings`` (:func:`serving_shardings`, or the
    trainer's placements) tensor-parallel on this rank's pieces, each
    block's gathered inside its own function (:func:`_rank_block`, cast to
    ``dtype``), so the remat recompute gathers again and no gathered block
    outlives its use. ``remat``: each block under ``torch.utils.checkpoint``
    (:func:`lm_forward_train`)."""
    mesh = shardings["embed"].mesh if shardings is not None else None
    # The backward's recompute runs after the caller's ``use_mesh`` block
    # has exited: each block re-installs the mesh it ran under.
    ambient = _ambient_mesh()
    context = _remat_context(cfg) if remat else None
    new_cache = [] if cache is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, p) in enumerate(zip(cfg.layer_kinds, params["blocks"])):
        def block(x, memory, i=i, kind=kind, p=p):
            with use_mesh(ambient):
                if mesh is not None:
                    p = _rank_block(cfg, kind, p, shardings["blocks"][i], mesh, dtype)
                return _apply_block(cfg, kind, p, x, cache=None if cache is None else cache[i],
                                    pos=pos, prefill=prefill, memory=memory, mesh=mesh)

        x, c, aux = (checkpoint(block, x, memory, use_reentrant=False, context_fn=context)
                     if remat else block(x, memory))
        if aux is not None:
            aux_total = aux_total + aux
        if cache is not None:
            new_cache.append(c)
    return x, new_cache, aux_total


def _table(params, name: str, shardings, dtype=None):
    """``params[name]``, its data-axis pieces gathered under ``shardings``."""
    t = params[name]
    return t if shardings is None else _gathered(t, shardings[name], dtype)


def _embed(cfg, params, tokens: Tensor, shardings=None, dtype=None) -> Tensor:
    if cfg.frontend == "audio":
        # Precomputed frame embeddings (the conv feature extractor is a stub).
        return tokens.to(L.dt(cfg, "compute"))
    table = _table(params, "embed", shardings, dtype)
    n = table.shape[0]
    if n == cfg.vocab_size:
        # Gather, then cast: the same values as casting the table first.
        return table[tokens.to(torch.long)].to(L.dt(cfg, "compute"))
    # Vocabulary-parallel: this rank's rows looked up, the others zero, and
    # the one non-zero row of each token summed over ``model``.
    mesh = shardings["embed"].mesh
    ids = tokens.to(torch.long) - L.model_split(mesh)[1] * n
    mine = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)].to(L.dt(cfg, "compute"))
    return sum_over(torch.where(mine[..., None], rows, 0), mesh, ("model",))


def _logits(cfg, params, x: Tensor, shardings=None, dtype=None) -> Tensor:
    """The logits of ``x``: this rank's vocabulary columns where ``model``
    splits the head (``x`` entering through ``copy_to``)."""
    cdt = L.dt(cfg, "compute")
    name = "embed" if cfg.tied_embeddings else "head"
    w = _table(params, name, shardings, dtype).to(cdt)
    if shardings is not None and w.numel() < cfg.vocab_size * cfg.d_model:
        x = copy_to(x, shardings[name].mesh, ("model",))
    if cfg.tied_embeddings:
        return torch.einsum("bsd,vd->bsv", x, w)
    return torch.einsum("bsd,dv->bsv", x, w)


def _whole_vocab(cfg, logits: Tensor, shardings) -> Tensor:
    """Serving's logits over the whole vocabulary: this rank's columns
    gathered over ``model`` where they are a share."""
    if logits.shape[-1] < cfg.vocab_size:
        return gather_dim(logits, shardings["embed"].mesh, ("model",), logits.ndim - 1)
    return logits


def _serving(cfg):
    """:func:`serving_shardings` on the ambient mesh, or None without one."""
    mesh = _ambient_mesh()
    return None if mesh is None else serving_shardings(cfg, mesh)


@torch.no_grad()
def lm_forward(cfg: ModelConfig, model: LM, tokens: Tensor, *, memory: Tensor | None = None):
    """Plain forward (no cache): ``(logits (B, S, V), aux)``; ``aux`` is the
    MoE load-balancing loss summed over layers (zero without experts).
    ``tokens`` are frames ``(B, S, D)`` for the audio frontend; ``memory``
    the media tokens the ``cross_attn`` layers read."""
    x = _embed(cfg, model, tokens)
    x, _, aux = _run_blocks(cfg, model, x, memory=memory)
    x = L.apply_norm(cfg, model["final_norm"], x)
    return _logits(cfg, model, x), aux


@torch.no_grad()
def lm_prefill(cfg: ModelConfig, model: LM, tokens: Tensor, cache: list, *,
               memory: Tensor | None = None):
    """Runs the full prompt ``tokens (B, S)`` and fills the cache (the
    ``cross_attn`` layers' from ``memory``). Returns ``(last logits (B, V),
    cache)``. Under an ambient mesh: tensor-parallel on this rank's pieces
    of ``model``, ``cache`` and the rows of ``tokens`` and ``memory`` (the
    module docstring), returning its rows' logits and its cache pieces."""
    sh = _serving(cfg)
    x = _embed(cfg, model, tokens, sh)
    x, cache, _ = _run_blocks(cfg, model, x, memory=memory, cache=cache, prefill=True,
                              shardings=sh)
    x = L.apply_norm(cfg, model["final_norm"], x)
    return _whole_vocab(cfg, _logits(cfg, model, x[:, -1:, :], sh)[:, 0], sh), cache


@torch.no_grad()
def lm_decode(cfg: ModelConfig, model: LM, token: Tensor, cache: list, pos: int, *,
              memory: Tensor | None = None):
    """One decode step. ``token`` (B,) (or (B, D) frames), ``pos`` the
    scalar absolute position. Returns ``(logits (B, V), new cache)``. The
    ``cross_attn`` layers read the cache's media keys and values, so
    ``memory`` changes nothing here (taken for the JAX signature). Under an
    ambient mesh: tensor-parallel, as :func:`lm_prefill`."""
    sh = _serving(cfg)
    x = _embed(cfg, model, token[:, None] if token.ndim == 1 else token[:, None, :], sh)
    x, cache, _ = _run_blocks(cfg, model, x, memory=memory, cache=cache, pos=int(pos),
                              shardings=sh)
    x = L.apply_norm(cfg, model["final_norm"], x)
    return _whole_vocab(cfg, _logits(cfg, model, x, sh)[:, 0], sh), cache


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


# The matmuls whose outputs ``remat_policy="dots"`` keeps (every dense
# product an einsum, ``@`` or a linear map dispatches to).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: ModelConfig):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat_policy``: ``"full"``
    keeps nothing of a block, ``"dots"`` keeps its matmuls' outputs (the
    JAX ``dots_saveable``)."""
    if cfg.remat_policy == "full":
        return noop_context_fn
    if cfg.remat_policy == "dots":
        return lambda: create_selective_checkpoint_contexts(_save_dots)
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def lm_forward_train(cfg: ModelConfig, params, tokens: Tensor, *, memory: Tensor | None = None,
                     shardings=None):
    """The forward under autograd: ``(logits (B, S, V), aux)``, gradients
    flowing to every tensor of ``params`` (a tree, :func:`lm_params`) that
    requires them (the audio frontend never reads ``embed``: no gradient
    reaches it). With ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward,
    the collectives with them, on every rank in one order);
    ``remat_policy="dots"`` keeps the outputs of its matmuls and recomputes
    the rest (:func:`_remat_context`).

    ``shardings`` (the sharded trainer's placements of ``params``, which
    then holds this rank's pieces, under the ambient mesh): tensor-parallel
    on the pieces, as serving runs (the module docstring). Each piece is
    cast to the compute dtype and its data-axis pieces gathered where it is
    read (a block's inside its checkpointed function, a tied embedding at
    either end); the logits are this rank's vocabulary columns where
    ``model`` splits them (:func:`token_nll_sharded` takes them)."""
    dtype = L.dt(cfg, "compute") if shardings is not None else None
    x = _embed(cfg, params, tokens, shardings, dtype)
    x, _, aux = _run_blocks(cfg, params, x, memory=memory, shardings=shardings, dtype=dtype,
                            remat=cfg.remat)
    norm = params["final_norm"]
    x = L.apply_norm(cfg, norm if shardings is None else
                     _gathered(norm, shardings["final_norm"], dtype), x)
    return _logits(cfg, params, x, shardings, dtype), aux


def token_nll(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """``(sum of the valid tokens' negative log-likelihoods, their count)``:
    labels ``-100`` where padded. Written as logsumexp minus a one-hot
    contraction, as the JAX package's loss is."""
    valid = labels >= 0
    labels_safe = labels.clamp_min(0).to(torch.long)

    logits32 = logits.to(torch.float32)
    lse = torch.logsumexp(logits32, dim=-1)                            # (B, S)
    onehot = torch.zeros_like(logits).scatter_(-1, labels_safe[..., None], 1.0)
    label_logit = torch.einsum("bsv,bsv->bs", logits32, onehot.to(torch.float32))
    nll = torch.where(valid, lse - label_logit, 0.0)
    return nll.sum(), valid.sum()


def token_nll_sharded(logits: Tensor, labels: Tensor, mesh) -> tuple[Tensor, Tensor]:
    """:func:`token_nll` of logits whose vocabulary ``model`` splits:
    ``logits`` (B, S, V/mp) this rank's columns, ``labels`` (B, S) the same
    on every model rank. The row maximum is all-reduced (max, no
    gradient), the sums of ``exp(l - max)`` and the label's logit (from the
    rank that holds its column, zero elsewhere) through ``sum_over``; no
    rank builds a (B, S, V) tensor. The result is the same on every model
    rank, its gradient this rank's columns'."""
    valid = labels >= 0
    n = logits.shape[-1]
    ids = labels.to(torch.long) - L.model_split(mesh)[1] * n
    mine = valid & (ids >= 0) & (ids < n)
    logits32 = logits.to(torch.float32)
    m = all_reduce(logits32.detach().amax(-1), torch.distributed.ReduceOp.MAX, mesh,
                   mesh.axis_group(("model",)))
    sums = sum_over(torch.exp(logits32 - m[..., None]).sum(-1), mesh, ("model",))
    picked = torch.gather(logits32, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    label_logit = sum_over(torch.where(mine, picked, 0.0), mesh, ("model",))
    nll = torch.where(valid, m + torch.log(sums) - label_logit, 0.0)
    return nll.sum(), valid.sum()


def lm_loss(cfg: ModelConfig, params, batch) -> tuple[Tensor, dict]:
    """Cross-entropy train loss, the JAX package's: ``batch`` holds
    ``"tokens"`` (B, S) (frames (B, S, D) for the audio frontend),
    ``"labels"`` (B, S), labels ``-100`` where padded (:func:`token_nll`),
    and optionally ``"memory"`` (vision). Returns ``(loss + 0.01 * aux,
    {"loss", "aux_loss", "ntokens"})``."""
    logits, aux = lm_forward_train(cfg, params, batch["tokens"], memory=batch.get("memory"))
    nll, count = token_nll(logits, batch["labels"])
    denom = count.clamp_min(1)
    loss = nll / denom
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "ntokens": denom}
