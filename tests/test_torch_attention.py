"""The port's dense attention against the JAX package's on the CPU.

The flash-style scan with its recompute backward, GQA, the blocked local
path, head padding and ``qkv_bias``, under the statements and tolerances
of the JAX package's own tests: ``tests/test_flash_attention.py`` (values
within 2e-5, gradients within rtol 5e-4 / atol 5e-5),
``tests/test_attention_properties.py`` (flash equals the masked full
softmax within 3e-5 for the sizes, windows and causality hypothesis
draws; batch rows independent; every blocked halo radius) and
``tests/test_head_padding.py`` (a padded model is exactly the unpadded one
and its dead heads get zero gradients). Each port result is held both to
the port's own full-softmax path and to the JAX function on the same
weights (``init_attention``'s, carried across as numpy), float32 compute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

VAL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def _setup(arch="qwen1.5-0.5b", bias_seed=None, **over):
    """(JAX cfg, port cfg, JAX params, port params as a dict of tensors).
    With ``bias_seed`` the zero-initialised q/k/v biases get random values,
    so the bias path carries something."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32", **over)
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32", **over)
    jp, _ = JL.init_attention(jcfg, jax.random.PRNGKey(0))
    if bias_seed is not None and "bq" in jp:
        rng = np.random.default_rng(bias_seed)
        jp = {n: (jnp.asarray(0.1 * rng.standard_normal(a.shape), jnp.float32)
                  if n.startswith("b") else a) for n, a in jp.items()}
    return jcfg, cfg, jp, {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().numpy()


def _both(jcfg, cfg, jp, tp, x, **kw):
    want, _ = JL.attention_apply(jcfg, jp, jnp.asarray(x), **kw)
    got, _ = L.attention_apply(cfg, tp, torch.from_numpy(x), **kw)
    return _np(got), np.asarray(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_matches_full_and_jax(causal, window):
    jcfg, cfg, jp, tp = _setup(causal=causal, bias_seed=1)
    x = _x((2, 32, cfg.d_model), 1)
    flash, want = _both(jcfg, cfg, jp, tp, x, window=window, force_flash=True)
    full, _ = _both(jcfg, cfg, jp, tp, x, window=window, force_flash=False)
    np.testing.assert_allclose(flash, full, rtol=VAL, atol=VAL)
    np.testing.assert_allclose(flash, want, rtol=VAL, atol=VAL)


def test_flash_gqa_groups():
    jcfg, cfg, jp, tp = _setup("glm4-9b")  # kv=2 < heads=4
    x = _x((1, 64, cfg.d_model), 2)
    flash, want = _both(jcfg, cfg, jp, tp, x, force_flash=True)
    full, _ = _both(jcfg, cfg, jp, tp, x, force_flash=False)
    np.testing.assert_allclose(flash, full, rtol=VAL, atol=VAL)
    np.testing.assert_allclose(flash, want, rtol=VAL, atol=VAL)


def _grads(jcfg, cfg, jp, tp, x, **kw):
    """Gradients of sum(y * y) over every parameter: the port's (flash
    path and full path) and the JAX package's (flash path)."""
    def port(flash):
        p = {n: t.clone().requires_grad_() for n, t in tp.items()}
        y, _ = L.attention_apply(cfg, p, torch.from_numpy(x), force_flash=flash, **kw)
        g = torch.autograd.grad((y * y).sum(), list(p.values()))
        return dict(zip(p, (_np(a) for a in g)))

    def jloss(p):
        y, _ = JL.attention_apply(jcfg, p, jnp.asarray(x), force_flash=True, **kw)
        return jnp.sum(y * y)

    return port(True), port(False), {n: np.asarray(a) for n, a in jax.grad(jloss)(jp).items()}


@pytest.mark.parametrize("arch,window", [("qwen1.5-0.5b", 0), ("glm4-9b", 0),
                                         ("qwen1.5-0.5b", 8), ("starcoder2-3b", 4)])
def test_flash_and_blocked_grads_match(arch, window):
    """Gradients through the flash core's recompute backward (window 0) and
    through the blocked local path (causal with a window) against the full
    path's and the JAX package's."""
    jcfg, cfg, jp, tp = _setup(arch, bias_seed=2)
    x = _x((1, 32, cfg.d_model), 3)
    flash, full, want = _grads(jcfg, cfg, jp, tp, x, window=window)
    assert flash.keys() == full.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(flash[name], full[name], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(flash[name], want[name], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_blocked_local_matches_full_mask():
    """Sliding-window blocked path (S >> window) == masked full softmax."""
    jcfg, cfg, jp, tp = _setup()
    x = _x((2, 64, cfg.d_model), 5)
    blocked, want = _both(jcfg, cfg, jp, tp, x, window=8, force_flash=True)
    full, _ = _both(jcfg, cfg, jp, tp, x, window=8, force_flash=False)
    np.testing.assert_allclose(blocked, full, rtol=VAL, atol=VAL)
    np.testing.assert_allclose(blocked, want, rtol=VAL, atol=VAL)


@pytest.mark.parametrize("s,window", [(64, 32), (64, 16), (128, 16), (128, 8)])
def test_blocked_window_radius_sweep(s, window):
    """Halo radii 1, 2, 4 and 8 blocks (``_pick_block_size`` as the JAX
    package's), each equal to the masked full softmax within 3e-5."""
    assert L._pick_block_size(s, window) == JL._pick_block_size(s, window)
    jcfg, cfg, jp, tp = _setup()
    x = _x((1, s, cfg.d_model), s + window)
    blocked, want = _both(jcfg, cfg, jp, tp, x, window=window, force_flash=True)
    full, _ = _both(jcfg, cfg, jp, tp, x, window=window, force_flash=False)
    np.testing.assert_allclose(blocked, full, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(blocked, want, rtol=3e-5, atol=3e-5)


def test_pick_block_size_is_the_jax_packages():
    for s in (8, 24, 64, 96, 512, 2560, 4096):
        for window in (1, 3, 8, 16, 100, 256, 4096):
            assert L._pick_block_size(s, window) == JL._pick_block_size(s, window), (s, window)


@pytest.mark.parametrize("row_offset", [-8, 0, 16])
def test_flash_core_with_row_offset_and_rows_without_keys(row_offset):
    """``_FlashCore`` on keys longer than the queries, the queries placed at
    ``row_offset``: values, log-sum-exp and gradients as the JAX
    ``_flash_core`` and ``_flash_fwd_scan``. At a negative offset the first
    rows see no key: their output is zero, as there (the ``-1e30`` fill,
    the denominator clamped at 1e-30)."""
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((1, 16, 2, 8), (1, 32, 2, 8), (1, 32, 2, 8), (1, 16, 2, 8)))
    args = dict(causal=True, window=0, scale=0.35, chunk=8, unroll=False,
                row_offset=row_offset)
    out, lse = L._flash_fwd_scan(*(torch.from_numpy(a) for a in (q, k, v)), **args)
    jout, jlse = JL._flash_fwd_scan(*(jnp.asarray(a) for a in (q, k, v)), **args)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=VAL, atol=VAL)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), rtol=VAL, atol=VAL)
    if row_offset < 0:
        assert not _np(out)[:, :, :-row_offset].any()

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y = L._FlashCore.apply(*ts, True, 0, 0.35, 8, False, row_offset)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), ts)

    def jloss(q, k, v):
        return jnp.sum(JL._flash_core(q, k, v, True, 0, 0.35, 8, False, row_offset)
                       * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_flash_needs_a_whole_number_of_chunks():
    _, cfg, _, tp = _setup()
    x = torch.from_numpy(_x((1, 24, cfg.d_model), 9))
    with pytest.raises(ValueError, match="multiple of its chunk"):
        L._flash_attention(*L._project_qkv(cfg, tp, x), causal=True, window=0, scale=0.1,
                           chunk=16)


@settings(max_examples=20, deadline=None)
@given(s=st.sampled_from([16, 32, 48, 64]), window=st.sampled_from([0, 4, 8, 16]),
       causal=st.booleans(), seed=st.integers(0, 10_000))
def test_flash_equals_full_softmax(s, window, causal, seed):
    """The chunked online-softmax path (or the blocked one) equals the
    masked full softmax for every (length, window, causality) drawn."""
    _, cfg, _, tp = _setup(causal=causal)
    x = torch.from_numpy(_x((1, s, cfg.d_model), seed))
    full, _ = L.attention_apply(cfg, tp, x, window=window, force_flash=False)
    flash, _ = L.attention_apply(cfg, tp, x, window=window, force_flash=True)
    np.testing.assert_allclose(_np(flash), _np(full), rtol=3e-5, atol=3e-5)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_attention_permutation_of_batch(seed):
    """Batch rows are independent: permuting inputs permutes outputs."""
    _, cfg, _, tp = _setup()
    x = torch.from_numpy(_x((4, 16, cfg.d_model), seed))
    perm = torch.tensor([2, 0, 3, 1])
    y, _ = L.attention_apply(cfg, tp, x)
    y_perm, _ = L.attention_apply(cfg, tp, x[perm])
    np.testing.assert_allclose(_np(y_perm), _np(y[perm]), rtol=1e-5, atol=1e-6)


def _padded(pad):
    over = dict(n_heads=6, n_kv_heads=2, head_dim=16, pad_heads_to=pad)
    jcfg = dataclasses.replace(jax_smoke_config("glm4-9b"), compute_dtype="float32", **over)
    cfg = dataclasses.replace(get_smoke_config("glm4-9b"), compute_dtype="float32", **over)
    return jcfg, cfg


@pytest.mark.parametrize("force_flash", [False, True])
def test_pad_heads_exact_and_dead(force_flash):
    """A model padded from 6 to 8 heads is exactly the unpadded one (the
    group-major layout: KV head 0 serves heads 0-2 and dead 3, KV head 1
    serves 4-6 and dead 7), its dead heads get zero gradients, and it
    agrees with the JAX package's padded attention."""
    jcfg1, cfg1 = _padded(8)
    _, cfg0 = _padded(0)
    jp1, _ = JL.init_attention(jcfg1, jax.random.PRNGKey(0))
    p1 = {n: torch.from_numpy(np.array(a)) for n, a in jp1.items()}
    assert p1["wq"].shape[1] == 8 and p1["wo"].shape[0] == 8
    real = torch.tensor([0, 1, 2, 4, 5, 6])
    p0 = {**p1, "wq": p1["wq"][:, real], "wo": p1["wo"][real]}
    x = _x((2, 32, cfg1.d_model), 1)
    y1, _ = L.attention_apply(cfg1, p1, torch.from_numpy(x), force_flash=force_flash)
    y0, _ = L.attention_apply(cfg0, p0, torch.from_numpy(x), force_flash=force_flash)
    np.testing.assert_allclose(_np(y1), _np(y0), rtol=1e-5, atol=1e-6)
    want, _ = JL.attention_apply(jcfg1, jp1, jnp.asarray(x), force_flash=force_flash)
    np.testing.assert_allclose(_np(y1), np.asarray(want), rtol=VAL, atol=VAL)

    p = {n: t.clone().requires_grad_() for n, t in p1.items()}
    y, _ = L.attention_apply(cfg1, p, torch.from_numpy(x), force_flash=force_flash)
    g = dict(zip(p, torch.autograd.grad((y ** 2).sum(), list(p.values()))))
    dead = torch.tensor([3, 7])
    assert float(g["wq"][:, dead].abs().max()) == 0.0
    assert float(g["wo"][dead].abs().max()) == 0.0
    assert float(g["wq"][:, real].abs().max()) > 0.0


def test_init_attention_shapes_bias_and_padding():
    """``init_attention`` draws the JAX package's leaves: q/k/v biases
    (zeros) where ``qkv_bias`` is set, padded heads in wq and wo."""
    for arch in ("qwen1.5-0.5b", "starcoder2-3b", "nemotron-4-15b", "glm4-9b"):
        jcfg = jax_smoke_config(arch)
        cfg = get_smoke_config(arch)
        jp, _ = JL.init_attention(jcfg, jax.random.PRNGKey(0))
        gen = torch.Generator().manual_seed(0)
        tp = L.init_attention(cfg, L.Init(gen, torch.float32, "cpu"))
        assert {n: tuple(a.shape) for n, a in jp.items()} == {
            n: tuple(t.shape) for n, t in tp.items()}, arch
        for n in ("bq", "bk", "bv"):
            if n in tp:
                assert not tp[n].any()
    jcfg, cfg = _padded(8)
    jp, _ = JL.init_attention(jcfg, jax.random.PRNGKey(0))
    tp = L.init_attention(cfg, L.Init(torch.Generator().manual_seed(0), torch.float32, "cpu"))
    assert {n: tuple(a.shape) for n, a in jp.items()} == {n: tuple(t.shape) for n, t in tp.items()}


def test_decode_against_prefill_with_bias():
    """With non-zero q/k/v biases, a prefill's cache followed by decode
    steps equals the JAX package's step for step (qwen1.5 smoke widths)."""
    jcfg, cfg, jp, tp = _setup(bias_seed=4)
    x = _x((2, 12, cfg.d_model), 6)
    jc = JL.init_cache(jcfg, 2, 16)
    tc = L.init_cache(cfg, 2, 16, device="cpu")
    for pos in range(12):
        want, jc = JL.attention_apply(jcfg, jp, jnp.asarray(x[:, pos:pos + 1]), cache=jc,
                                      pos=jnp.int32(pos))
        got, tc = L.attention_apply(cfg, tp, torch.from_numpy(x[:, pos:pos + 1]), cache=tc,
                                    pos=pos)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=VAL, atol=VAL,
                                   err_msg=f"step {pos}")
