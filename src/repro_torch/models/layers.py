"""Transformer building blocks: norms, RoPE, GQA self-attention (full,
sliding-window, flash-style for long prefills, blocked local, bidirectional
for the encoder) with a ring cache, tanh-gated cross-attention over media
tokens, the dense FFN and the MoE (local and expert-parallel).

The port of ``repro/models/layers.py``, for every LM of the registry: the
recurrent ones (RWKV-6, RecurrentGemma), the dense ones (qwen1.5,
starcoder2, nemotron-4, glm4), the MoE ones (qwen3-moe, arctic),
llama-3.2-vision's cross-attention and hubert's encoder. Conventions, as
there:

* A parameter group is a :class:`Params` module of named tensors and
  nested groups (the JAX package's dict leaves, same names and shapes). Tensors are stored in
  ``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at use; softmax and
  norms run in float32.
* Attention caches are dicts ``{"k", "v"}`` of shape ``(B, L, K, Dh)`` plus
  a ``slot_pos (L,)`` table of absolute positions (-1 = empty): a ring of
  ``L = min(max_len, window)`` slots, ``slot = pos % L``. Unlike the JAX
  package, a decode step writes its slot IN PLACE and returns the same
  dict (one lane's cache is never read again after the step).

* A prefill longer than ``FLASH_THRESHOLD`` (or ``force_flash=True``)
  runs the JAX package's chunked online-softmax scan (:func:`_flash_fwd_scan`,
  ``FLASH_CHUNK`` keys a step) with its recompute backward
  (:class:`_FlashCore`), or, for causal sliding-window attention whose
  window and length share a block size, the blocked local path
  (:func:`_local_attention_blocked`). Both are plain tensor code, as the
  jnp is: no library attention kernel, the same ``-1e30`` fill and the
  same output (zero) on a row with no visible key. The JAX package's
  sharding constraints are dropped: there is no partitioner to steer.

* Tensor-parallel serving and training (``mesh=``, which ``lm_prefill``,
  ``lm_decode`` and the sharded trainer's ``lm_forward_train`` pass): the
  layers take this rank's pieces of their weights under the JAX package's
  placements (train and decode mode place every parameter alike) and
  carry out the ``model`` splits themselves. A dim split over ``model``
  shows as a local size below the config's (the data axes are gathered
  before a block runs); a dim the rules replicate stays whole and its
  branch is computed whole on every model rank, never summed over
  ``model``, so its weights' gradients come out equal there. Query heads,
  kv heads and the FFN's hidden dim take their local slice: a replicated
  activation enters through :func:`~repro_torch.dist.sharding.copy_to`
  (Megatron's f: identity forward, its gradient summed over ``model``),
  ``wo`` and ``w2`` contract over the slice and
  :func:`~repro_torch.dist.sharding.sum_over` combines the partial
  outputs (Megatron's g). The caches split by the same rules
  (:func:`cache_split`): ``kv_seq`` takes ``model`` before ``kv_heads``,
  so a rank holds a contiguous block of slots for every kv head, writes a
  slot only when it owns it, and a decode step combines the ranks'
  partial attention over their slots by the log-sum-exp rule
  (:func:`_lse_attention`). A long prefill's blocked local path whose
  heads ``model`` does not split splits its blocks instead (the JAX
  package's ``blocks`` constraint).

* The MoE (:func:`apply_moe`) is the JAX package's sort-based capacity
  dispatch in plain tensor code: a float32 router, a stable sort, an
  (E, C, D) buffer, three einsums and a float32 scatter-add combine
  (``index_add``, whose atomics on the card make a token's sum order, and
  so its last bits, vary from run to run). Its expert-parallel form
  (:func:`apply_moe_sharded`) runs over the ranks of a
  :class:`~repro_torch.dist.sharding.Mesh` with gradient-carrying
  collectives.

* Cross-attention (``attention_apply(..., cross=True, memory=...)``) takes
  its keys and values from ``memory`` (``(B, M, D)`` media embeddings; from
  ``x`` itself when ``memory`` is None, as the JAX package does), with no
  rotation and no mask, and scales its output by ``tanh(gate)``: a scalar
  parameter initialised to zero, so at init the layer adds nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import all_reduce, copy_to, gather_dim, spec_for, sum_over
from repro_torch.tree import tree_map

Tensor = torch.Tensor

# Prefill length above which the no-cache path switches to the chunked
# online-softmax (flash-style) scan, and the keys it takes a step.
FLASH_THRESHOLD = 2048
FLASH_CHUNK = 512


def dt(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    return getattr(torch, cfg.param_dtype if kind == "param" else cfg.compute_dtype)


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------


class Params(nn.Module):
    """One parameter group: named tensors and nested groups (the MoE's
    ``dense`` branch), read as ``p["name"]``. Inference only, so the
    parameters carry no gradient."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, value in tensors.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> dict:
        """The group as a dict of its own tensors (no copies), nested
        groups as nested dicts: the JAX package's layout."""
        return {**self._parameters, **{n: m.tree() for n, m in self._modules.items()}}


class Init:
    """Fan-in scaled initialiser on a :class:`torch.Generator`, mirroring
    the JAX package's ``PBuilder``: a normal draw in float32 scaled by
    ``scale / sqrt(fan_in)`` (fan-in over every axis but the last, unless
    ``fan_axes`` says otherwise), then cast to the parameter dtype.

    Every leaf it makes passes through ``place`` (default: kept as it is)
    before the init function sees it: the sharded trainer keeps a rank's
    piece there and frees the rest, so a rank never holds two whole leaves.
    On the ``"meta"`` device (``generator=None``) it draws nothing and
    gives the shapes alone."""

    def __init__(self, generator: torch.Generator | None, dtype: torch.dtype, device,
                 place=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.place = place if place is not None else (lambda t: t)

    def fan_in(self, shape, *, scale: float = 1.0, fan_axes=None) -> Tensor:
        fan = 1
        for i in fan_axes if fan_axes is not None else range(len(shape) - 1):
            fan *= shape[i]
        std = scale / math.sqrt(max(fan, 1))
        x = torch.randn(tuple(shape), generator=self.generator, dtype=torch.float32,
                        device=self.device)
        # In place: the same bits as ``x * std`` without a second float32
        # copy (an arctic expert stack draws 4.46 G values).
        return self.place(x.mul_(std).to(self.dtype))

    def const(self, shape, value: float) -> Tensor:
        return self.place(torch.full(tuple(shape), value, dtype=self.dtype, device=self.device))

    def zeros(self, shape) -> Tensor:
        return self.const(shape, 0.0)

    def ones(self, shape) -> Tensor:
        return self.const(shape, 1.0)


# ---------------------------------------------------------------------------
# Norms and RoPE.
# ---------------------------------------------------------------------------


# The logical axes of each parameter group's tensors (the JAX ``init_*``'s),
# one table per group kind beside its init; ``spec_for`` maps them to a
# mesh and :func:`repro_torch.models.lm.lm_axes` assembles an LM's.
NORM_AXES = {"scale": (None,), "bias": (None,)}


def init_norm(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    p = {"scale": ini.ones((cfg.d_model,))}
    if cfg.norm == "layernorm":
        p["bias"] = ini.zeros((cfg.d_model,))
    return p


def apply_norm(cfg: ModelConfig, p, x: Tensor) -> Tensor:
    x32 = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        var = (x32**2).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + 1e-6) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rope_rotate(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding. x: (B, S, H, Dh); positions: (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs           # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (causal self-attention, sliding window, GQA, ring cache).
# ---------------------------------------------------------------------------


ATTENTION_AXES = {
    "wq": ("fsdp", "heads", "head_dim"),
    "wk": ("fsdp", "kv_heads", "head_dim"),
    "wv": ("fsdp", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "fsdp"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "gate": (),
}


def init_attention(cfg: ModelConfig, ini: Init, *, cross: bool = False) -> dict[str, Tensor]:
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.pad_heads_to:
        # Padded heads are drawn like the rest and killed by a mask at use
        # (attention_apply): zero output, zero gradient to their weights.
        h = max(h, cfg.pad_heads_to)
    p = {
        "wq": ini.fan_in((d, h, dh)),
        "wk": ini.fan_in((d, k, dh)),
        "wv": ini.fan_in((d, k, dh)),
        "wo": ini.fan_in((h, dh, d)),
    }
    if cfg.qkv_bias:
        p.update(bq=ini.zeros((h, dh)), bk=ini.zeros((k, dh)), bv=ini.zeros((k, dh)))
    if cross:
        p["gate"] = ini.zeros(())  # tanh-gated cross-attention (llama-vision)
    return p


def _project_qkv(cfg: ModelConfig, p, x: Tensor, memory: Tensor | None = None, mesh=None):
    """q from ``x``; k and v from ``memory`` when given (cross-attention),
    else from ``x``. Where ``model`` splits the query heads (``p`` this
    rank's pieces), the projections enter the split region through
    :func:`~repro_torch.dist.sharding.copy_to` (Megatron's f): the input of
    the query heads and, where the kv heads split too, of the kv heads;
    where they do not, k and v are projected whole, a replicated branch,
    and enter the region after it (each rank's query heads read some of
    them, so their gradients sum over ``model``)."""
    cdt = dt(cfg, "compute")
    x = x.to(cdt)
    src = x if memory is None else memory.to(cdt)
    h_split = p["wq"].shape[1] < max(cfg.n_heads, cfg.pad_heads_to or 0)
    k_split = p["wk"].shape[1] < cfg.n_kv_heads
    xq = copy_to(x, mesh, ("model",)) if h_split else x
    if k_split:
        src = xq if memory is None else copy_to(src, mesh, ("model",))
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if h_split and not k_split:
        kv = copy_to(torch.cat([k, v], dim=-1), mesh, ("model",))
        k, v = kv[..., :k.shape[-1]], kv[..., k.shape[-1]:]
    return q, k, v


def model_split(mesh) -> tuple[int, int]:
    """``(mp, j)``: the size of ``mesh``'s ``model`` axis and this rank's
    coordinate on it; ``(1, 0)`` without a mesh or a ``model`` axis."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1, 0
    return mesh.axis_size("model"), mesh.coord("model")


def _heads(cfg: ModelConfig, p, mesh) -> tuple[int, int, int, int]:
    """``(h_off, h_all, k_off, k_all)``: the first global query head and kv
    head of this rank's ``wq`` and ``wk`` and their global counts (query
    heads padded to ``pad_heads_to``); offsets 0 where a count is whole."""
    _, j = model_split(mesh)
    h_all, k_all = max(cfg.n_heads, cfg.pad_heads_to or 0), cfg.n_kv_heads
    h_n, k_n = p["wq"].shape[1], p["wk"].shape[1]
    return (j * h_n if h_n < h_all else 0, h_all, j * k_n if k_n < k_all else 0, k_all)


def _kv_for_heads(kv: Tensor, h_off: int, h_n: int, group: int, k_off: int) -> Tensor:
    """The kv heads of ``kv`` (``(B, L, K', Dh)``, global heads from
    ``k_off``) that query heads ``[h_off, h_off + h_n)`` read, laid out so
    :func:`_gqa_scores` pairs them (``group`` query heads a kv head): a
    slice of whole groups, the one head a run of query heads inside a group
    shares, or else one kv head a query head."""
    lo, hi = h_off // group, (h_off + h_n - 1) // group
    if h_off % group == 0 and h_n % group == 0:
        return kv[:, :, lo - k_off:hi + 1 - k_off]
    if lo == hi:
        return kv[:, :, lo - k_off:lo - k_off + 1]
    idx = torch.div(h_off + torch.arange(h_n, device=kv.device), group,
                    rounding_mode="floor") - k_off
    return kv.index_select(2, idx)


def _gqa_scores(q: Tensor, k: Tensor) -> Tensor:
    """q: (B,S,H,Dh), k: (B,L,K,Dh) -> scores (B, H, S, L) with GQA groups."""
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, s, kheads, h // kheads, dh)
    return torch.einsum("bskgd,blkd->bkgsl", qg, k).reshape(b, h, s, k.shape[1])


def _gqa_out(w: Tensor, v: Tensor) -> Tensor:
    """w: (B,H,S,L), v: (B,L,K,Dh) -> (B,S,H,Dh)."""
    b, h, s, length = w.shape
    kheads = v.shape[2]
    wg = w.reshape(b, kheads, h // kheads, s, length)
    return torch.einsum("bkgsl,blkd->bskgd", wg, v).reshape(b, s, h, v.shape[-1])


def _self_mask(s: int, *, causal: bool, window: int, device) -> Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    return mask


# -- flash-style and blocked local attention (long prefills) -----------------


def _chunk_mask(rows: Tensor, i: int, chunk: int, causal: bool, window: int) -> Tensor:
    cols = i * chunk + torch.arange(chunk, device=rows.device)
    mask = torch.ones((rows.shape[0], chunk), dtype=torch.bool, device=rows.device)
    if causal:
        mask &= cols[None, :] <= rows[:, None]
    if window:
        mask &= cols[None, :] > rows[:, None] - window
    return mask


def _flash_fwd_scan(q, k, v, *, causal: bool, window: int, scale: float, chunk: int,
                    unroll: bool = False, row_offset: int = 0):
    """Returns ``(out (B,H,Sq,Dh) f32, lse (B,H,Sq) f32)``: one step per
    ``chunk`` keys, folding each into a running (max, denominator,
    accumulator). ``k``/``v`` may be longer than ``q``; ``row_offset``
    places q's rows at absolute positions ``row_offset + arange(Sq)`` of
    the key axis. ``unroll`` (the JAX package's choice between ``lax.scan``
    and an unrolled loop) has no effect: the steps are a Python loop."""
    b, s, h, dh = q.shape
    n_chunks = k.shape[1] // chunk
    rows = row_offset + torch.arange(s, device=q.device)
    f32 = torch.float32
    m = torch.full((b, h, s), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((b, h, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, s, dh), dtype=f32, device=q.device)
    for i in range(n_chunks):
        ks, vs = k[:, i * chunk:(i + 1) * chunk], v[:, i * chunk:(i + 1) * chunk]
        sc = torch.einsum("bshd,bchd->bhsc", q, ks).to(f32) * scale
        mask = _chunk_mask(rows, i, chunk, causal, window)[None, None]
        sc = torch.where(mask, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhsc,bchd->bhsd", p.to(vs.dtype), vs).to(f32)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


class _FlashCore(torch.autograd.Function):
    """Flash attention with the JAX package's recompute backward
    (``_flash_core`` and its ``custom_vjp``): the S x S scores never exist
    whole; the backward recomputes each chunk's probabilities from the
    saved log-sum-exp and folds in the row term ``delta = sum(dOut * Out)``.
    q: (B,Sq,H,Dh); k/v: (B,Skv,H,Dh), KV already repeated to H heads;
    returns (B,Sq,H,Dh) in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, chunk, unroll, row_offset):
        out, lse = _flash_fwd_scan(q, k, v, causal=causal, window=window, scale=scale,
                                   chunk=chunk, unroll=unroll, row_offset=row_offset)
        out = out.transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, chunk, row_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, chunk, row_offset = ctx.args
        f32 = torch.float32
        rows = row_offset + torch.arange(q.shape[1], device=q.device)
        g32 = g.to(f32)
        delta = torch.einsum("bshd,bshd->bhs", g32, out.to(f32))
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dks, dvs = [], []
        for i in range(k.shape[1] // chunk):
            ks, vs = k[:, i * chunk:(i + 1) * chunk], v[:, i * chunk:(i + 1) * chunk]
            sc = torch.einsum("bshd,bchd->bhsc", q, ks).to(f32) * scale
            mask = _chunk_mask(rows, i, chunk, causal, window)[None, None]
            p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
            dvs.append(torch.einsum("bhsc,bshd->bchd", p, g32))
            dp = torch.einsum("bshd,bchd->bhsc", g32, vs.to(f32))
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhsc,bchd->bshd", ds, ks.to(f32))
            dks.append(torch.einsum("bhsc,bshd->bchd", ds, q.to(f32)))
        dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None, None


def _flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, window: int,
                     scale: float, chunk: int = FLASH_CHUNK, unroll: bool = False,
                     mesh=None) -> Tensor:
    """Repeats GQA KV heads to H, then runs :class:`_FlashCore`; causal
    sliding-window attention whose window and length share a block size
    takes :func:`_local_attention_blocked` instead (its blocks split over
    ``mesh``'s ``model`` axis when given)."""
    h, kheads = q.shape[2], k.shape[2]
    if kheads != h:
        k = torch.repeat_interleave(k, h // kheads, dim=2)
        v = torch.repeat_interleave(v, h // kheads, dim=2)
    s = q.shape[1]
    if causal and window and _pick_block_size(s, window):
        return _local_attention_blocked(q, k, v, window=window, scale=scale, mesh=mesh)
    if s % chunk:
        raise ValueError(f"flash attention: sequence length {s} is not a multiple of its "
                         f"chunk {chunk}")
    return _FlashCore.apply(q, k, v, causal, window, scale, chunk, unroll, 0)


def _pick_block_size(s: int, window: int, target_blocks: int = 16) -> int | None:
    """Sub-block size for windowed attention: the largest divisor of both
    ``window`` and ``s`` that still yields >= ``target_blocks`` blocks;
    else the smallest feasible divisor, or None if blocking is impossible."""
    min_bs = min(128, max(window // 2, 1))
    cands = [b for b in range(min_bs, window + 1)
             if window % b == 0 and s % b == 0 and s // b >= 2]
    if not cands:
        return None
    good = [b for b in cands if s // b >= target_blocks]
    return max(good) if good else min(cands)


def blocks_split(mesh, n_blocks: int) -> bool:
    """Whether the blocked local path splits its ``n_blocks`` blocks over
    ``mesh``'s ``model`` axis (the JAX rules' ``blocks``: where it divides)."""
    mp, _ = model_split(mesh)
    return mp > 1 and n_blocks % mp == 0


def _local_attention_blocked(q: Tensor, k: Tensor, v: Tensor, *, window: int,
                             scale: float, mesh=None) -> Tensor:
    """Causal sliding-window attention by sub-blocks and their halo: each
    block of ``bs`` queries attends to the ``window // bs`` blocks before it
    and its own (zeros before the sequence start, masked), O(S * window)
    work instead of a masked S x S pass. q/k/v: (B,S,H,Dh), KV repeated.
    With ``mesh`` (whose ``model`` axis splits no head), the blocks are a
    free batch dim split over ``model``, as the JAX package constrains
    them: each rank attends its contiguous run of blocks (every rank holds
    the whole sequence's keys and values) and the outputs are gathered."""
    b, s, h, dh = q.shape
    bs = _pick_block_size(s, window)
    r = window // bs  # halo radius in blocks
    nb = s // bs
    qb, kb, vb = (x.reshape(b, nb, bs, h, dh) for x in (q, k, v))
    lo, hi = 0, nb
    if blocks_split(mesh, nb):
        mp, j = model_split(mesh)
        lo, hi = j * nb // mp, (j + 1) * nb // mp
        # Each rank's blocks read a part of q, k and v: they enter the
        # split region through copy_to, and the gather below returns each
        # rank its blocks' gradient.
        qb, kb, vb = (copy_to(t, mesh, ("model",)) for t in (qb, kb, vb))

    def shift(x, by):
        """Blocks ``[lo - by, hi - by)`` of ``x``, zeros before the start."""
        zeros = min(max(by - lo, 0), hi - lo)
        real = x[:, max(lo - by, 0):max(hi - by, 0)]
        return torch.cat([torch.zeros_like(x[:, :zeros]), real], dim=1) if zeros else real

    # context = (prev_r ++ ... ++ prev_1 ++ cur): (B, nb, (r+1)*bs, H, Dh)
    kk = torch.cat([shift(kb, i) for i in range(r, -1, -1)], dim=2)
    vv = torch.cat([shift(vb, i) for i in range(r, -1, -1)], dim=2)
    sc = torch.einsum("bnqhd,bnkhd->bnhqk", qb[:, lo:hi], kk).to(torch.float32) * scale
    dev = q.device
    rows = torch.arange(bs, device=dev)[:, None]            # q position within block
    cols = torch.arange((r + 1) * bs, device=dev)[None, :]  # position within halo context
    rel = cols - r * bs - rows                              # kv offset relative to q
    mask = (rel <= 0) & (rel > -window)
    blk = torch.arange(lo, hi, device=dev)[:, None, None]
    glob_col = (blk - r) * bs + cols[None]
    m = mask[None] & (glob_col >= 0)
    sc = torch.where(m[None, :, None], sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", w.to(vv.dtype), vv)
    if hi - lo < nb:
        out = gather_dim(out, mesh, ("model",), 1)
    return out.reshape(b, s, h, dh)


def attention_apply(cfg: ModelConfig, p, x: Tensor, *, window: int = 0,
                    cross: bool = False, memory: Tensor | None = None,
                    cache: dict | None = None, pos: int | None = None,
                    force_flash: bool | None = None, mesh=None):
    """Self- or cross-attention, plain tensor code.

    Prefill: ``x (B,S,D)``, ``cache=None`` -> ``(y, None)``: a masked
    softmax up to ``FLASH_THRESHOLD`` tokens (causal, or bidirectional when
    ``cfg.causal`` is False), the flash-style scan (or the blocked local
    path) above it or when ``force_flash`` says so. Decode: ``x (B,1,D)``
    with ``cache`` and the absolute position ``pos`` -> ``(y, cache)``, the
    cache updated in place. ``cross``: keys and values from ``memory`` (from
    ``x`` when it is None), no rotation, no mask, the output scaled by
    ``tanh(gate)`` -> ``(y, cache)``, the cache untouched. With ``mesh``,
    ``p`` and ``cache`` are this rank's pieces (the module docstring).
    """
    cdt = dt(cfg, "compute")
    _, s, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _project_qkv(cfg, p, x, memory if cross else None, mesh)
    h_off, h_all, k_off, k_all = _heads(cfg, p, mesh)
    group = h_all // k_all
    h_n = q.shape[2]

    if cache is not None and not cross:
        if s != 1 or pos is None:
            raise ValueError("a decode step takes one token and its position")
        if cfg.rope:
            at = torch.full((1,), int(pos), device=x.device)
            q = rope_rotate(q, at, cfg.rope_theta)
            k = rope_rotate(k, at, cfg.rope_theta)
        cache = cache_write(cache, k[:, 0], v[:, 0], pos, mesh=mesh)
        slot_pos = cache["slot_pos"]
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        if window:
            valid &= slot_pos > pos - window
        out = attend_cache(cfg, q, cache, valid, h_off=h_off, mesh=mesh)
    else:
        k, v = (_kv_for_heads(t, h_off, h_n, group, k_off) for t in (k, v))
        if cross:
            # No positional rotation, no mask: memory is a set of media tokens.
            scores = _gqa_scores(q, k).to(torch.float32) * scale
            w = torch.softmax(scores, dim=-1).to(cdt)
            out = _gqa_out(w, v)
        else:
            if cfg.rope:
                positions = torch.arange(s, device=x.device)
                q = rope_rotate(q, positions, cfg.rope_theta)
                k = rope_rotate(k, positions, cfg.rope_theta)
            use_flash = force_flash if force_flash is not None else s > FLASH_THRESHOLD
            if use_flash:
                # Heads the rules replicate: the blocked local path splits
                # its blocks over ``model`` instead.
                out = _flash_attention(q, k, v, causal=cfg.causal, window=window, scale=scale,
                                       chunk=min(FLASH_CHUNK, s), unroll=cfg.flash_unroll,
                                       mesh=mesh if h_n == h_all else None)
            else:
                scores = _gqa_scores(q, k).to(torch.float32) * scale
                mask = _self_mask(s, causal=cfg.causal, window=window, device=x.device)
                scores = torch.where(mask, scores, -1e30)
                w = torch.softmax(scores, dim=-1).to(cdt)
                out = _gqa_out(w, v)
    return attention_out(cfg, p, out, h_off=h_off, mesh=mesh, cross=cross), cache


def attention_out(cfg: ModelConfig, p, out: Tensor, *, h_off: int = 0, mesh=None,
                  cross: bool = False) -> Tensor:
    """The output projection of ``out`` (``(B, S, H', Dh)``, global heads
    from ``h_off``): padded heads masked, ``wo``, the cross gate, and the
    sum over ``model`` where the heads are split."""
    cdt = dt(cfg, "compute")
    h_all = max(cfg.n_heads, cfg.pad_heads_to or 0)
    if cfg.pad_heads_to and cfg.pad_heads_to > cfg.n_heads:
        # Kill padded heads exactly (zero output, zero gradient to their
        # weights). Group-major: each of the n_kv groups holds g_new heads,
        # of which the last g_new - g_real are dead, so every real head
        # keeps its KV group.
        g_new, g_real = h_all // cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        heads = h_off + torch.arange(out.shape[2], device=out.device)
        head_mask = ((heads % g_new) < g_real).to(out.dtype)
        out = out * head_mask[None, None, :, None]
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))
    if out.shape[2] < h_all:
        y = sum_over(y, mesh, ("model",))
    if cross and "gate" in p:  # after the sum: the gate's gradient reads the whole output
        y = torch.tanh(p["gate"].to(torch.float32)).to(cdt) * y
    return y


def attend_cache(cfg: ModelConfig, q: Tensor, cache: dict, valid: Tensor | None, *,
                 h_off: int = 0, mesh=None) -> Tensor:
    """One decode step's attention of ``q`` (``(B, 1, H', Dh)``, global
    heads from ``h_off``) over the keys and values of ``cache`` (this
    rank's piece; ``valid`` masks the whole cache's slots, None: all) ->
    ``(B, 1, H', Dh)``. Where the slots are split over ``model`` the query
    heads are gathered, each rank attends over its slots and the partial
    results are combined (:func:`_lse_attention`); else the rank attends
    over the kv heads its query heads read."""
    cdt = dt(cfg, "compute")
    scale = 1.0 / math.sqrt(cfg.head_dim)
    h_all = max(cfg.n_heads, cfg.pad_heads_to or 0)
    group = h_all // cfg.n_kv_heads
    h_n = q.shape[2]
    length = valid.shape[0] if valid is not None else cfg.num_media_tokens
    slots, heads = cache_split(cfg, mesh, length)
    ck, cv = cache["k"].to(cdt), cache["v"].to(cdt)
    if slots:
        n = ck.shape[1]
        lo = model_split(mesh)[1] * n
        qa = gather_dim(q, mesh, ("model",), 2) if h_n < h_all else q
        out = _lse_attention(qa, ck, cv, None if valid is None else valid[lo:lo + n],
                             scale, mesh)
        return out[:, :, h_off:h_off + h_n].to(cdt)
    # Split by kv heads, the query heads are split too (K | H): this rank's
    # kv heads are those its query heads read.
    k_off = h_off // group if heads else 0
    ck, cv = (_kv_for_heads(t, h_off, h_n, group, k_off) for t in (ck, cv))
    scores = _gqa_scores(q, ck).to(torch.float32) * scale
    if valid is not None:
        scores = torch.where(valid[None, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(cdt)
    return _gqa_out(w, cv)


def _lse_attention(q: Tensor, k: Tensor, v: Tensor, valid: Tensor | None, scale: float,
                   mesh) -> Tensor:
    """Attention of every query head over this rank's block of slots,
    combined over ``model`` by the log-sum-exp rule in float32: the row
    maxima all-reduced (max), then the rescaled denominators and numerators
    summed in one all-reduce. ``q (B, 1, H, Dh)``, ``k``/``v`` ``(B, L', K,
    Dh)`` -> ``(B, 1, H, Dh)`` float32."""
    f32 = torch.float32
    sc = _gqa_scores(q, k).to(f32) * scale                          # (B, H, 1, L')
    if valid is not None:
        sc = torch.where(valid[None, None, None, :], sc, -1e30)
    m = all_reduce(sc.amax(-1), torch.distributed.ReduceOp.MAX, mesh,
                   mesh.axis_group(("model",)))
    p = torch.exp(sc - m[..., None])
    if valid is not None:
        p = torch.where(valid[None, None, None, :], p, 0.0)
    acc = _gqa_out(p, v.to(f32))                                    # (B, 1, H, Dh)
    tot = sum_over(torch.cat([acc, p.sum(-1).transpose(1, 2)[..., None]], dim=-1), mesh,
                   ("model",))
    return tot[..., :-1] / tot[..., -1:]


# -- cache ---------------------------------------------------------------


# The logical axes of an attention cache's leaves (a cross-attention cache
# has no ``slot_pos``).
CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "slot_pos": (None,),
}


def cache_split(cfg: ModelConfig, mesh, length: int) -> tuple[bool, bool]:
    """``(slots, heads)``: whether ``model`` splits an attention cache of
    ``length`` slots by its slots (``kv_seq``) or by its kv heads, by the
    decode-mode rules (``kv_seq`` first; neither where neither divides)."""
    mp, _ = model_split(mesh)
    if mp == 1:
        return False, False
    spec = spec_for(CACHE_AXES["k"], mesh, (1, length, cfg.n_kv_heads, cfg.head_dim),
                    mode="decode")
    return spec[1] == "model", spec[2] == "model"


def make_buf(shape, dtype, device, fill=0) -> Tensor:
    return torch.full(tuple(shape), fill, dtype=dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, length: int, *, device) -> dict:
    """Empty attention cache of ``length`` slots (window ring or full)."""
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": make_buf(shape, dt(cfg, "compute"), device),
        "v": make_buf(shape, dt(cfg, "compute"), device),
        "slot_pos": make_buf((length,), torch.int32, device, fill=-1),
    }


def _cache_heads(cache: dict, k: Tensor, v: Tensor, mesh, dim: int) -> tuple[Tensor, Tensor]:
    """``k`` and ``v`` with every kv head where the cache holds them all and
    this rank computed its own (gathered over ``model`` along ``dim``, both
    in one all-gather)."""
    if k.shape[dim] < cache["k"].shape[2]:
        kv = gather_dim(torch.cat([k, v.to(k.dtype)], dim=-1), mesh, ("model",), dim)
        return kv[..., :k.shape[-1]], kv[..., k.shape[-1]:]
    return k, v


def cache_write(cache: dict, k_t: Tensor, v_t: Tensor, pos: int, *, mesh=None) -> dict:
    """Writes one timestep (B,K,Dh) at slot ``pos % L``, in place (with
    ``mesh``: on the rank whose block of slots holds it; every rank's
    whole ``slot_pos`` is updated)."""
    length = cache["slot_pos"].shape[0]
    n = cache["k"].shape[1]
    k_t, v_t = _cache_heads(cache, k_t, v_t, mesh, 1)
    slot = int(pos) % length
    lo = model_split(mesh)[1] * n if n < length else 0
    if lo <= slot < lo + n:
        cache["k"][:, slot - lo] = k_t.to(cache["k"].dtype)
        cache["v"][:, slot - lo] = v_t.to(cache["v"].dtype)
    cache["slot_pos"][slot] = int(pos)
    return cache


def cache_fill_from_prefill(cfg: ModelConfig, cache: dict, k: Tensor, v: Tensor, *,
                            mesh=None) -> dict:
    """A new cache holding a prefill's (B,S,K,Dh) keys and values: all of
    them when S <= L, else the last L, ring-aligned so ``slot = pos % L``
    (with ``mesh``: this rank's block of the slots, its kv heads gathered
    first where the cache holds every head)."""
    length = cache["slot_pos"].shape[0]
    n = cache["k"].shape[1]
    k, v = _cache_heads(cache, k, v, mesh, 2)
    lo = model_split(mesh)[1] * n if n < length else 0
    s = k.shape[1]
    if s <= length:
        kk, vv, slot_pos = cache["k"].clone(), cache["v"].clone(), cache["slot_pos"].clone()
        m = max(0, min(s - lo, n))
        kk[:, :m] = k[:, lo:lo + m].to(kk.dtype)
        vv[:, :m] = v[:, lo:lo + m].to(vv.dtype)
        slot_pos[:s] = torch.arange(s, dtype=torch.int32, device=k.device)
        return {"k": kk, "v": vv, "slot_pos": slot_pos}
    start = s - length
    positions = torch.arange(start, s, dtype=torch.int32, device=k.device)
    order = torch.argsort(positions % length)
    mine = order[lo:lo + n]
    return {"k": k[:, start:][:, mine].to(cache["k"].dtype),
            "v": v[:, start:][:, mine].to(cache["v"].dtype),
            "slot_pos": positions[order]}


def cross_cache_fill(cfg: ModelConfig, cache: dict, k: Tensor, v: Tensor, *,
                     mesh=None) -> dict:
    """A cross-attention cache of the media keys and values ``(B, M, K,
    Dh)`` (with ``mesh``: this rank's piece by :func:`cache_split` of
    ``M = cfg.num_media_tokens``)."""
    if model_split(mesh)[0] > 1:
        if k.shape[1] != cfg.num_media_tokens:
            raise ValueError(f"a cross_attn prefill under a model-split mesh takes "
                             f"memory of {cfg.num_media_tokens} media tokens")
        k, v = _cache_heads(cache, k, v, mesh, 2)
        if cache_split(cfg, mesh, k.shape[1])[0]:
            n = cache["k"].shape[1]
            lo = model_split(mesh)[1] * n
            k, v = k[:, lo:lo + n], v[:, lo:lo + n]
    return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


# ---------------------------------------------------------------------------
# FFN.
# ---------------------------------------------------------------------------


FFN_AXES = {"w1": ("fsdp", "mlp"), "w3": ("fsdp", "mlp"), "w2": ("mlp", "fsdp")}


def init_ffn(cfg: ModelConfig, ini: Init) -> dict[str, Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": ini.fan_in((d, f))}
    if cfg.activation in ("swiglu", "geglu"):
        p["w3"] = ini.fan_in((d, f))
    p["w2"] = ini.fan_in((f, d))
    return p


def apply_ffn(cfg: ModelConfig, p, x: Tensor, mesh=None) -> Tensor:
    """The dense FFN; with ``mesh``, ``w1``/``w3`` this rank's columns and
    ``w2`` its rows where ``model`` splits the hidden dim: ``x`` enters
    through ``copy_to`` and the partial outputs are summed over
    ``model``."""
    cdt = dt(cfg, "compute")
    x = x.to(cdt)
    if p["w2"].shape[0] < cfg.d_ff:
        x = copy_to(x, mesh, ("model",))
    h = x @ p["w1"].to(cdt)
    if cfg.activation == "swiglu":
        h = F.silu(h) * (x @ p["w3"].to(cdt))
    elif cfg.activation == "geglu":
        h = gelu(h) * (x @ p["w3"].to(cdt))
    elif cfg.activation == "gelu":
        h = gelu(h)
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.activation)
    y = h @ p["w2"].to(cdt)
    if p["w2"].shape[0] < cfg.d_ff:
        y = sum_over(y, mesh, ("model",))
    return y


# ---------------------------------------------------------------------------
# MoE: top-k routing with sort-based capacity dispatch (no T*E*C one-hots).
# ---------------------------------------------------------------------------

# The logical axes of the MoE's parameters (the JAX ``init_moe``'s), which
# spec_for maps to a mesh; ``dense`` is arctic's residual FFN.
MOE_AXES = {
    "router": ("fsdp", "experts"),
    "w1": ("experts", "fsdp", "mlp"),
    "w3": ("experts", "fsdp", "mlp"),
    "w2": ("experts", "mlp", "fsdp"),
    "dense": FFN_AXES,
}


def moe_shapes(cfg: ModelConfig) -> dict:
    """The global shapes of one MoE layer's parameters, in :data:`MOE_AXES`'s
    layout (``dense`` only with ``moe_dense_residual``)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"router": (d, e), "w1": (e, d, f), "w3": (e, d, f), "w2": (e, f, d)}
    if cfg.moe_dense_residual:
        shapes["dense"] = {"w1": (d, f), "w3": (d, f), "w2": (f, d)}
    return shapes


def init_moe(cfg: ModelConfig, ini: Init) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": ini.fan_in((d, e), scale=0.1),
         "w1": ini.fan_in((e, d, f)),
         "w3": ini.fan_in((e, d, f)),
         "w2": ini.fan_in((e, f, d))}
    if cfg.moe_dense_residual:
        p["dense"] = init_ffn(cfg, ini)
    return p


def _capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: the JAX expression, in its order."""
    k, e = cfg.top_k, cfg.n_experts
    return min(max(int(math.ceil(k * t / e * cfg.capacity_factor)), 4), t)


def _route(cfg: ModelConfig, router: Tensor, xt: Tensor):
    """float32 router, softmax, top-k and gate normalisation -> ``(probs,
    gate, idx)``; ``idx`` in ``torch.topk``'s order (largest first)."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)                 # (T, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, idx


def _aux_loss(probs: Tensor, idx: Tensor, e: int, mesh=None) -> Tensor:
    """The Switch load-balancing loss ``E * sum_e f_e * P_e``: ``P_e`` the
    mean router probability, ``f_e`` the share of assignments (a count, so
    it carries no gradient). On a mesh with data axes both are averaged
    over the data ranks BEFORE their product, so the loss is the estimator
    over the whole batch (mean-of-products != product-of-means)."""
    from repro_torch.dist.sharding import data_axes_of, mean_over

    me = probs.mean(0)
    # A scatter of ones, not ``bincount``: the same counts, and it runs on
    # meta tensors (the dry run), which ``bincount`` does not.
    flat = idx.reshape(-1)
    counts = torch.zeros(e, dtype=flat.dtype, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    ce = counts.to(torch.float32) / idx.numel()
    dp = data_axes_of(mesh) if mesh is not None else ()
    if dp:
        me, ce = mean_over(me, mesh, dp), mean_over(ce, mesh, dp)
    return e * torch.sum(me * ce)


def _experts(xe: Tensor, w, cdt: torch.dtype) -> Tensor:
    """SwiGLU on an ``(E, C, D)`` buffer, three einsums, each weight of
    ``w`` cast to ``cdt`` just before its einsum (so at most one cast of an
    expert stack is alive outside autograd)."""
    h = torch.einsum("ecd,edf->ecf", xe, w["w1"].to(cdt))
    g = torch.einsum("ecd,edf->ecf", xe, w["w3"].to(cdt))
    return torch.einsum("ecf,efd->ecd", F.silu(h) * g, w["w2"].to(cdt))


def _combine(yexp: Tensor, buf_tok: Tensor, buf_gate: Tensor, t: int) -> Tensor:
    """``(T, D)`` float32: each slot's output times its gate, added into its
    token's row (empty slots point at row ``t``, which is cut off). Out of
    place, so it is differentiable; on the card its atomics make the sum
    order of a token's k terms vary from run to run."""
    d = yexp.shape[-1]
    yflat = yexp.reshape(-1, d).to(torch.float32) * buf_gate[:, None]
    y = torch.zeros((t + 1, d), dtype=torch.float32, device=yexp.device)
    return y.index_add(0, buf_tok, yflat)[:t]


def _dispatch_local(xt: Tensor, gate: Tensor, idx: Tensor, e_lo: int, e_hi: int,
                    capacity: int, e_loc: int, cdt: torch.dtype):
    """``(E_loc, C, D)`` buffers and the slot -> token / gate maps for experts
    ``[e_lo, e_hi)``: assignments sorted (stably) by local expert, foreign
    ones last; each expert keeps its first ``capacity`` tokens; overflow
    and foreign assignments go to the sentinel slot ``E_loc * C``, cut off
    after the scatter (so duplicate writes there are harmless)."""
    t, d = xt.shape
    k = idx.shape[-1]
    dev = xt.device
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    flat_gate = gate.reshape(-1)
    mine = (flat_e >= e_lo) & (flat_e < e_hi)
    key = torch.where(mine, flat_e - e_lo, e_loc)  # foreign -> overflow group
    order = torch.argsort(key, stable=True)
    se, stok, sgate = key[order], flat_tok[order], flat_gate[order]
    group_start = torch.searchsorted(se, torch.arange(e_loc, device=dev), side="left")
    pos_in_grp = torch.arange(t * k, device=dev) - group_start[torch.clamp_max(se, e_loc - 1)]
    keep = (se < e_loc) & (pos_in_grp < capacity)
    slot = torch.where(keep, se * capacity + pos_in_grp, e_loc * capacity)

    n = e_loc * capacity + 1
    buf_tok = torch.full((n,), t, dtype=torch.long, device=dev).index_put((slot,), stok)
    buf_gate = torch.zeros((n,), dtype=torch.float32, device=dev).index_put((slot,), sgate)
    buf_tok, buf_gate = buf_tok[:-1], buf_gate[:-1]
    xpad = torch.cat([xt.to(cdt), torch.zeros((1, d), dtype=cdt, device=dev)], dim=0)
    xe = xpad[buf_tok].reshape(e_loc, capacity, d)
    return xe, buf_tok, buf_gate


def apply_moe(cfg: ModelConfig, p, x: Tensor) -> tuple[Tensor, Tensor]:
    """MoE dispatcher: under an ambient mesh with a ``model`` axis every
    step, a one-token decode step included, takes the expert-parallel path
    (:func:`apply_moe_sharded`): each rank runs its ``E / mp`` experts on
    the tokens, and only the tokens' combined outputs cross ``model``. (The
    JAX package sends a one-token step to its local path, whose sharded
    weights GSPMD then gathers: the port has no partitioner, and gathering
    a layer's pieces whole would move 9.8 GB a qwen3-moe layer for each
    token; :func:`gather_moe_params` stays for tests.) Anything else takes
    the local path. Under a mesh without ``model`` (the trainer's data-only
    meshes) the local path runs on this rank's tokens with the weights its
    caller gathered, and ``aux`` is still taken over every data rank's
    tokens."""
    from repro_torch.dist.sharding import _ambient_mesh

    mesh = _ambient_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        return apply_moe_sharded(cfg, p, x)
    return _apply_moe_local(cfg, p, x, mesh=mesh)


def _apply_moe_local(cfg: ModelConfig, p, x: Tensor, mesh=None) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Sort-based dropping dispatch: tokens
    are sorted by assigned expert; each expert processes up to
    ``capacity`` tokens in a dense (E, C, D) buffer (overflow tokens are
    dropped, GShard-style). Memory is O(E*C*D), never O(T*E*C). With a
    ``mesh``, ``x`` is this rank's block of the batch and ``aux`` is taken
    over every data rank's tokens (:func:`_aux_loss`)."""
    cdt = dt(cfg, "compute")
    b_, s, d = x.shape
    t = b_ * s
    e = cfg.n_experts
    xt = x.reshape(t, d)

    probs, gate, idx = _route(cfg, p["router"], xt)
    aux = _aux_loss(probs, idx, e, mesh)

    capacity = _capacity(cfg, t)
    xe, buf_tok, buf_gate = _dispatch_local(xt, gate, idx, 0, e, capacity, e, cdt)
    y = _combine(_experts(xe, p, cdt), buf_tok, buf_gate, t).to(cdt)
    if cfg.moe_dense_residual:
        y = y + apply_ffn(cfg, p["dense"], xt)
    return y.reshape(b_, s, d), aux


# ---------------------------------------------------------------------------
# Expert-parallel MoE over the ranks of a mesh.
#
# Every (data, model) rank routes ITS tokens to ITS 1/mp slice of the
# experts, computes locally, and one sum over ``model`` combines. Wire cost
# per MoE layer: one (T_loc, D) sum plus the fsdp weight gathers,
# independent of n_experts.
# ---------------------------------------------------------------------------


def _is_tuple(x) -> bool:
    """Shapes and specs are tuples, and leaves of the MoE's trees."""
    return isinstance(x, tuple)


def _tree(p) -> dict:
    return p.tree() if isinstance(p, Params) else p


def moe_specs(cfg: ModelConfig, mesh) -> dict:
    """The spec of each MoE parameter on ``mesh`` (``spec_for`` of its
    :data:`MOE_AXES` entry and global shape, train mode)."""
    from repro_torch.dist.sharding import spec_for

    shapes = moe_shapes(cfg)
    return tree_map(lambda shape, axes: spec_for(axes, mesh, shape, mode="train"),
                    shapes, {n: MOE_AXES[n] for n in shapes}, is_leaf=_is_tuple)


def _gather(w: Tensor, spec, mesh, dtype, keep: tuple = ("model",)) -> Tensor:
    """``w`` cast to ``dtype``, its sharded dims gathered back but those over
    ``keep`` (:func:`~repro_torch.dist.sharding.gather_param`)."""
    from repro_torch.dist.sharding import NamedSharding, gather_param

    return gather_param(w, NamedSharding(mesh, spec), dtype, keep=keep)


def gather_moe_params(cfg: ModelConfig, p, mesh) -> dict:
    """This rank's pieces of one MoE layer gathered whole (every sharded dim,
    ``model`` too), in the parameter dtype: what the local path reads."""
    return tree_map(lambda spec, w: _gather(w, spec, mesh, w.dtype, keep=()),
                    moe_specs(cfg, mesh), _tree(p), is_leaf=_is_tuple)


def shard_moe_params(cfg: ModelConfig, p, mesh) -> dict:
    """This rank's pieces of a whole MoE layer's parameters (``shard_param``
    under :func:`moe_specs`): what :func:`apply_moe_sharded` reads."""
    from repro_torch.dist.sharding import shard_param

    return tree_map(lambda spec, w: shard_param(w, mesh, spec), moe_specs(cfg, mesh), _tree(p),
                    is_leaf=_is_tuple)


def apply_moe_sharded(cfg: ModelConfig, p, x: Tensor) -> tuple[Tensor, Tensor]:
    """Expert-parallel MoE on the ambient mesh
    (:func:`repro_torch.dist.sharding.use_mesh`), which has a ``model``
    axis and optionally ``data`` and ``pod``.

    ``p`` holds this rank's pieces (``shard_param`` of each global tensor
    under :func:`moe_specs`), ``x`` this rank's block of the batch (split
    over the data axes, the same on every model rank). The rank gathers
    the router whole and every other sharded dim but the experts, routes
    its tokens, runs its ``E / mp`` experts, and one sum over ``model``
    combines the partial outputs (in the compute dtype, as the JAX
    ``psum`` does). ``aux`` averages the per-expert statistics over the
    data axes before their product, so it equals the estimator over the
    whole batch. Gradients follow the Megatron pattern: the tokens and
    gates enter the expert region through :func:`copy_to` (gradient summed
    over ``model``) and the combine is :func:`sum_over` (identity
    backward), so on a ``(1, mp)`` mesh each rank's gradients, gathered,
    are the local path's. With ``E % mp != 0`` the pieces are gathered
    whole and the local path runs, as the JAX package falls back."""
    from repro_torch.dist.sharding import _ambient_mesh, copy_to, sum_over

    mesh = _ambient_mesh()
    cdt = dt(cfg, "compute")
    b_, s, d = x.shape
    e = cfg.n_experts
    mp = mesh.axis_size("model")
    if e % mp:
        return _apply_moe_local(cfg, gather_moe_params(cfg, p, mesh), x, mesh=mesh)
    e_loc = e // mp
    specs = moe_specs(cfg, mesh)

    t_loc = b_ * s
    xt = x.reshape(t_loc, d)
    router = _gather(p["router"], specs["router"], mesh, torch.float32, keep=())
    probs, gate, idx = _route(cfg, router, xt)
    aux = _aux_loss(probs, idx, e, mesh)

    j = mesh.coord("model")
    capacity = _capacity(cfg, t_loc)
    xt_in = copy_to(xt, mesh, ("model",))
    xe, buf_tok, buf_gate = _dispatch_local(xt_in, copy_to(gate, mesh, ("model",)), idx,
                                            j * e_loc, (j + 1) * e_loc, capacity, e_loc, cdt)
    w = {n: _gather(p[n], specs[n], mesh, cdt) for n in ("w1", "w3", "w2")}
    y = _combine(_experts(xe, w, cdt), buf_tok, buf_gate, t_loc)

    dense = None
    if cfg.moe_dense_residual:
        # TP dense branch: where ``model`` splits the mlp dim, the sum that
        # combines the experts combines the dense partials. Where it does
        # not, every model rank holds the whole branch: it is computed
        # whole, outside that sum (the JAX shard_map sums the replicated
        # outputs there, mp times the branch).
        split = "model" in specs["dense"]["w2"]
        dw = {n: _gather(p["dense"][n], specs["dense"][n], mesh, cdt)
              for n in ("w1", "w3", "w2")}
        xc = (xt_in if split else xt).to(cdt)
        hd = F.silu(xc @ dw["w1"]) * (xc @ dw["w3"])
        if split:
            y = y + (hd @ dw["w2"]).to(torch.float32)
        else:
            dense = hd @ dw["w2"]
    y = sum_over(y.to(cdt), mesh, ("model",))
    if dense is not None:
        y = y + dense
    return y.reshape(b_, s, d), aux
