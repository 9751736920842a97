"""The LMs as one composable decoder: the recurrent ones (RWKV-6,
RecurrentGemma) and the dense ones (qwen1.5, starcoder2, nemotron-4, glm4).

The port of ``repro/models/lm.py`` for the block kinds ported so far
(``attn``, ``local_attn``, ``rglru``, ``rwkv6``); MoE, cross-attention
and media frontends are not (ROADMAP M13b.3-4). :func:`build_lm` returns an
:class:`LM` module whose blocks stand in layer order, the block pattern
cycled to ``n_layers``; the JAX package's scan over stacked superblocks
becomes a plain loop over an ``nn.ModuleList``, and its sharding
constraints (no-ops on one device) are dropped.

Serving entry points (functions of ``(cfg, model, ...)``, as in the JAX
package; ``cfg`` may differ from ``model.cfg`` in its compute dtype), all
without gradients:

  * :func:`lm_forward` — tokens -> (logits (B, S, V), aux)
  * :func:`lm_prefill` — runs the prompt, fills the cache -> (last logits, cache)
  * :func:`lm_decode`  — one token with the cache at position ``pos``

A cache (:func:`build_cache`) is a list with one entry per layer.

Training works on a parameter TREE, as the JAX package's does:
:func:`lm_params` gives a model's ``{"embed", "blocks": [per layer
{"norm1", "mixer", "norm2", "ffn"}], "final_norm", "head"?}`` (the
module's own tensors, no copies), :func:`lm_forward_train` runs it under
autograd (each block under ``torch.utils.checkpoint`` when ``cfg.remat``,
where the JAX package uses ``jax.checkpoint``), and :func:`lm_loss` is the
JAX package's cross-entropy. The serving functions take the module or a
tree alike: both are read as ``params["name"]``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

Tensor = torch.Tensor
PORTED_KINDS = ("attn", "local_attn", "rglru", "rwkv6")


def _check_kinds(cfg: ModelConfig) -> None:
    missing = sorted(set(cfg.block_pattern) - set(PORTED_KINDS))
    if missing or cfg.n_experts or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {missing or cfg.block_pattern}, MoE and media frontends "
            f"are not ported yet (ROADMAP M13); ported kinds: {PORTED_KINDS}")


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
        _check_kinds(cfg)
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
    def group(p) -> dict[str, Tensor]:
        return dict(p.named_parameters())

    tree = {"embed": model.embed,
            "blocks": [{part: group(b[part]) for part in Block.PARTS} for b in model.blocks],
            "final_norm": group(model.final_norm)}
    if model.head is not None:
        tree["head"] = model.head
    return tree


def _init_block(cfg: ModelConfig, kind: str, ini: L.Init) -> dict:
    mixer = {"attn": L.init_attention, "local_attn": L.init_attention,
             "rglru": R.init_rglru, "rwkv6": R.init_rwkv_tmix}[kind]
    ffn = R.init_rwkv_cmix if kind == "rwkv6" else L.init_ffn
    return {"norm1": L.init_norm(cfg, ini), "mixer": mixer(cfg, ini),
            "norm2": L.init_norm(cfg, ini), "ffn": ffn(cfg, ini)}


def build_lm(cfg: ModelConfig, seed: int = 0, *, device=None) -> LM:
    """A model of ``cfg``'s published shapes with random weights drawn from
    ``seed`` (fan-in init, as the JAX package's ``build_lm``), made
    directly on ``device`` (``None`` means the card)."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ini = L.Init(gen, L.dt(cfg), dev)
    params = {"embed": ini.fan_in((cfg.vocab_size, cfg.d_model), fan_axes=(1,))}
    params["blocks"] = [_init_block(cfg, kind, ini) for kind in cfg.layer_kinds]
    params["final_norm"] = L.init_norm(cfg, ini)
    if not cfg.tied_embeddings:
        params["head"] = ini.fan_in((cfg.d_model, cfg.vocab_size))
    return LM(cfg, params)


# ---------------------------------------------------------------------------
# Cache init (serving).
# ---------------------------------------------------------------------------


def _block_cache(cfg: ModelConfig, kind: str, batch: int, length: int, device):
    if kind in ("attn", "local_attn"):
        return L.init_cache(cfg, batch, min(length, cfg.window or length), device=device)
    if kind == "rglru":
        return R.rglru_cache_init(cfg, batch, device=device)
    if kind == "rwkv6":
        return R.rwkv_cache_init(cfg, batch, device=device)
    raise ValueError(kind)


def build_cache(cfg: ModelConfig, batch: int, length: int, *, device=None) -> list:
    """Empty serving caches, one per layer. ``length`` is the max context;
    local attention clamps its ring to the window."""
    dev = resolve_device(device)
    return [_block_cache(cfg, kind, batch, length, dev) for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# Apply.
# ---------------------------------------------------------------------------


def _apply_block(cfg, kind: str, p, x: Tensor, *, cache, pos, prefill):
    """One block of ``kind`` with parameters ``p`` (a :class:`Block` or its
    tree). Returns ``(x, new cache)``."""
    h = L.apply_norm(cfg, p["norm1"], x)
    new_cache = cache
    if kind in ("attn", "local_attn"):
        if cache is not None and not prefill:
            y, new_cache = L.attention_apply(cfg, p["mixer"], h, window=cfg.window,
                                             cache=cache, pos=pos)
        else:
            y, _ = L.attention_apply(cfg, p["mixer"], h, window=cfg.window)
            if prefill:
                _, k, v = L._project_qkv(cfg, p["mixer"], h)
                if cfg.rope:
                    k = L.rope_rotate(k, torch.arange(h.shape[1], device=h.device),
                                      cfg.rope_theta)
                new_cache = L.cache_fill_from_prefill(cfg, cache, k, v)
    elif kind == "rglru":
        y, c2 = R.apply_rglru(cfg, p["mixer"], h, cache=None if prefill else cache)
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
                                  cache=None if (prefill or cache is None) else cache["cmix"])
        if cache is not None:
            new_cache = {**new_cache, "cmix": c3}
    else:
        y = L.apply_ffn(cfg, p["ffn"], h)
    return x + y, new_cache


def _run_blocks(cfg, params, x: Tensor, *, cache=None, pos=None, prefill=False):
    new_cache = [] if cache is not None else None
    for i, (kind, p) in enumerate(zip(cfg.layer_kinds, params["blocks"])):
        x, c = _apply_block(cfg, kind, p, x, cache=None if cache is None else cache[i],
                            pos=pos, prefill=prefill)
        if cache is not None:
            new_cache.append(c)
    return x, new_cache


def _embed(cfg, params, tokens: Tensor) -> Tensor:
    # Gather, then cast: the same values as casting the table first.
    return params["embed"][tokens.to(torch.long)].to(L.dt(cfg, "compute"))


def _logits(cfg, params, x: Tensor) -> Tensor:
    cdt = L.dt(cfg, "compute")
    if cfg.tied_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"].to(cdt))
    return torch.einsum("bsd,dv->bsv", x, params["head"].to(cdt))


@torch.no_grad()
def lm_forward(cfg: ModelConfig, model: LM, tokens: Tensor):
    """Plain forward (no cache): ``(logits (B, S, V), aux)``; ``aux`` (the
    MoE loss of the JAX package) is zero for every ported kind."""
    x = _embed(cfg, model, tokens)
    x, _ = _run_blocks(cfg, model, x)
    x = L.apply_norm(cfg, model["final_norm"], x)
    return _logits(cfg, model, x), torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def lm_prefill(cfg: ModelConfig, model: LM, tokens: Tensor, cache: list):
    """Runs the full prompt ``tokens (B, S)`` and fills the cache. Returns
    ``(last logits (B, V), cache)``."""
    x = _embed(cfg, model, tokens)
    x, cache = _run_blocks(cfg, model, x, cache=cache, prefill=True)
    x = L.apply_norm(cfg, model["final_norm"], x)
    return _logits(cfg, model, x[:, -1:, :])[:, 0], cache


@torch.no_grad()
def lm_decode(cfg: ModelConfig, model: LM, token: Tensor, cache: list, pos: int):
    """One decode step. ``token`` (B,), ``pos`` the scalar absolute
    position. Returns ``(logits (B, V), new cache)``."""
    x = _embed(cfg, model, token[:, None])
    x, cache = _run_blocks(cfg, model, x, cache=cache, pos=int(pos))
    x = L.apply_norm(cfg, model["final_norm"], x)
    return _logits(cfg, model, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


def lm_forward_train(cfg: ModelConfig, params, tokens: Tensor):
    """The forward under autograd: ``(logits (B, S, V), aux)``, gradients
    flowing to every tensor of ``params`` (a tree, :func:`lm_params`) that
    requires them. With ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward;
    only ``remat_policy="full"`` is ported)."""
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported; the port rematerialises "
            "whole blocks (remat_policy='full')")
    x = _embed(cfg, params, tokens)
    for kind, p in zip(cfg.layer_kinds, params["blocks"]):
        def block(x, kind=kind, p=p):
            return _apply_block(cfg, kind, p, x, cache=None, pos=None, prefill=False)[0]

        x = checkpoint(block, x, use_reentrant=False) if cfg.remat else block(x)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(cfg: ModelConfig, params, batch) -> tuple[Tensor, dict]:
    """Cross-entropy train loss, the JAX package's: ``batch`` holds
    ``"tokens"`` and ``"labels"`` (B, S) tensors, labels ``-100`` where
    padded. Written as logsumexp minus a one-hot contraction, as there.
    Returns ``(loss + 0.01 * aux, {"loss", "aux_loss", "ntokens"})``."""
    logits, aux = lm_forward_train(cfg, params, batch["tokens"])
    labels = batch["labels"]
    valid = labels >= 0
    labels_safe = labels.clamp_min(0).to(torch.long)

    logits32 = logits.to(torch.float32)
    lse = torch.logsumexp(logits32, dim=-1)                            # (B, S)
    onehot = torch.zeros_like(logits).scatter_(-1, labels_safe[..., None], 1.0)
    label_logit = torch.einsum("bsv,bsv->bs", logits32, onehot.to(torch.float32))
    nll = torch.where(valid, lse - label_logit, 0.0)
    denom = valid.sum().clamp_min(1)
    loss = nll.sum() / denom
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "ntokens": denom}
