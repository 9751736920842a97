"""The port's derived adjoints (``repro_torch.ir.autodiff``) against the JAX
package's, on the CPU.

Four layers:
  * structure — for every conformance program and k, each chain sweep's
    ``adjoint`` and ``augmented_forward`` fingerprint, cache fields and
    radii, and ``pad_widths``, equal the JAX package's;
  * gradients — ``build_backend(p, b, differentiable=True)`` for ``b`` in
    reference, staged and cuda (its plain version on CPU tensors) against
    ``jax.grad`` of the JAX ``lower_reference`` on the conformance loss,
    within ``GRAD_TOL`` (1e-5 relative, ``tests/conformance.py``); ring
    cotangents of the coefficient are exactly zero;
  * ``hdiff_fused_ad`` (K1 forward, adjoint backward) against the JAX
    package's and ``jax.vjp`` of the hdiff oracle;
  * the generated kernel's emitters for the ops adjoints create: each
    ``emit`` string, evaluated over float32 scalars with Python stand-ins
    for the CUDA helpers, equals its ``compute`` bit for bit, and an op
    made by the generic rule has no emitter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ir as jir
import repro_torch.ir as tir
from conformance import (
    GRID,
    KS,
    PROGRAMS,
    SEED,
    assert_grad_close,
    grad_oracle,
    make_fields,
    make_loss_weights,
)
from repro.core.hdiff import hdiff as hdiff_ref
from repro.core.hdiff import hdiff_simple as hdiff_simple_ref
from repro.kernels.hdiff.ops import hdiff_fused_ad as jax_hdiff_fused_ad
from repro_torch.ir.codegen_cuda import render
from repro_torch.ir.graph import OpCost, Read, StencilOp, StencilProgram
from repro_torch.ir.lower_cuda import tile_for
from repro_torch.kernels.hdiff import hdiff_fused, hdiff_fused_ad
from test_torch_ir_graph import TORCH_PROGRAMS

ROSTER = sorted(PROGRAMS)
BACKENDS = ("reference", "staged", "cuda")


def _pair(name, k):
    return jir.repeat(PROGRAMS[name](), k), tir.repeat(TORCH_PROGRAMS[name](), k)


def _tensors(x):
    if isinstance(x, dict):
        return {f: torch.from_numpy(np.array(a)) for f, a in x.items()}
    return torch.from_numpy(np.array(x))


# -- structure ----------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ROSTER)
def test_adjoint_structure_matches_jax(name, k):
    jp, tp = _pair(name, k)
    assert tir.adjoint(tp).fingerprint() == jir.adjoint(jp).fingerprint()
    for jq, tq in zip(jp.chain, tp.chain):
        ja, ta = jir.adjoint(jq), tir.adjoint(tq)
        jg, tg = jir.augmented_forward(jq), tir.augmented_forward(tq)
        assert ta.fingerprint() == ja.fingerprint()
        assert tg.fingerprint() == jg.fingerprint()
        assert ta.inputs == ja.inputs and dict(ta.outputs) == dict(ja.outputs)
        assert tir.cache_fields(tq) == jir.cache_fields(jq)
        assert ta.radius == ja.radius == tq.radius
        assert tg.radius == jg.radius == tq.radius
        assert ta.exchange_radii() == ja.exchange_radii()
        assert tir.pad_widths(tq, GRID) == jir.pad_widths(jq, GRID)


def test_cache_fields_only_for_nonlinear():
    assert tir.cache_fields(tir.hdiff_program()) == ("lap",)
    assert tir.cache_fields(tir.hdiff_program(limit=False)) == ()
    assert tir.cache_fields(tir.vadvc_program()) == ("wbar", "grad")
    assert tir.augmented_forward(tir.laplacian_program()) == tir.laplacian_program()


# -- gradients ----------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ROSTER)
def test_grad_matches_jax_reference(name, k, backend):
    """The port's gradient through ``build_backend(..., differentiable=True)``
    against ``jax.grad(lower_reference)`` (computed once per program and
    k), on the conformance loss ``sum(w * y)``."""
    _, tp = _pair(name, k)
    x = _tensors(make_fields(name))
    leaves = x if isinstance(x, dict) else {"": x}
    for t in leaves.values():
        t.requires_grad_(True)
    w = _tensors(make_loss_weights(name, k))
    y = tir.build_backend(tp, backend, differentiable=True)(x)
    loss = sum((w[f] * y[f]).sum() for f in y) if isinstance(y, dict) else (w * y).sum()
    loss.backward()
    got = {f: t.grad.numpy() for f, t in x.items()} if isinstance(x, dict) else x.grad.numpy()
    assert_grad_close(got, grad_oracle(name, k), err_msg=f"port/{name}/{backend}/k={k}")


@pytest.mark.parametrize("k", [1, 2])
def test_grad_zero_on_ring(k):
    """The coefficient enters only at interior points, so its cotangent is
    exactly zero on the boundary ring, in every backend."""
    p = tir.repeat(tir.hdiff_coupled_program(), k)
    r = p.chain[0].radius
    ring = np.ones(GRID[-2:], bool)
    ring[r:-r, r:-r] = False
    for backend in BACKENDS:
        x = _tensors(make_fields("hdiff_coupled"))
        x["coeff"].requires_grad_(True)
        w = _tensors(make_loss_weights("hdiff_coupled", k))
        (w * tir.build_backend(p, backend, differentiable=True)(x)).sum().backward()
        gc = x["coeff"].grad.numpy()
        assert np.all(gc[..., ring] == 0.0)
        assert np.abs(gc[..., ~ring]).max() > 0.0


def test_make_vjp_mirrors_its_input():
    """Bare tensor in, bare tensor out; a mapping in, a cotangent per
    declared input out; and the same values the autograd Function gives."""
    p = tir.repeat(tir.hdiff_program(), 2)
    x = _tensors(make_fields("hdiff"))
    g = torch.ones_like(x)
    vjp = tir.make_vjp(p, lambda q: tir.build_backend(q, "cuda"))
    cot = vjp(x, g)
    assert isinstance(cot, torch.Tensor) and cot.shape == x.shape
    assert torch.equal(vjp({"psi": x}, g)["psi"], cot)
    xg = x.clone().requires_grad_(True)
    tir.build_backend(p, "cuda", differentiable=True)(xg).sum().backward()
    assert torch.equal(xg.grad, cot)
    pc = tir.hdiff_coupled_program()
    xc = _tensors(make_fields("hdiff_coupled"))
    assert set(tir.make_vjp(pc, tir.lower_reference)(xc, g)) == set(pc.inputs)


def test_build_zero_waits_for_lower_sharded():
    p = tir.hdiff_coupled_program()
    with pytest.raises(NotImplementedError, match="M9"):
        tir.make_vjp(p, tir.lower_reference, build_zero=tir.lower_reference)
    with pytest.raises(NotImplementedError, match="M9"):
        tir.differentiable_lowering(
            p, tir.lower_reference(p), tir.lower_reference, build_zero=tir.lower_reference
        )


def test_build_backend_rejects_unported_and_unknown_backends():
    p = tir.hdiff_program()
    for name in ("sharded-reference", "sharded-cuda"):
        with pytest.raises(NotImplementedError, match="M9"):
            tir.build_backend(p, name, differentiable=True)
    with pytest.raises(ValueError, match="unknown backend"):
        tir.build_backend(p, "pallas")


# -- hdiff_fused_ad: K1 forward + derived-adjoint backward --------------------


@pytest.mark.parametrize("limit", [True, False], ids=["limit", "simple"])
def test_hdiff_fused_ad_matches_jax(limit):
    """``dpsi`` within 1e-5 of the JAX package's ``hdiff_fused_ad`` and of
    ``jax.vjp`` of the oracle. ``dcoeff`` is a sum over the grid whose terms
    cancel (0.64 from magnitudes adding up to 393 with the limiter): the
    port sums in float64, so it is held within 1e-5 of the float64 sums of
    two per-point coefficient cotangent fields, ``jax.vjp`` of the oracle
    with the coefficient as a field and the JAX package's own derived
    adjoint. Beside those, it is within 2e-5 of the float32 sums JAX returns
    for a scalar coefficient (its ``hdiff_fused_ad`` and the oracle's),
    whose order of summation moves them by up to 1.3e-5."""
    rng = np.random.default_rng(SEED)
    psi_np = rng.standard_normal((2, 24, 24)).astype(np.float32)
    g_np = rng.standard_normal(psi_np.shape).astype(np.float32)
    psi, coeff = jnp.asarray(psi_np), jnp.float32(0.03)

    _, pull = jax.vjp(lambda p, c: jax_hdiff_fused_ad(p, c, limit), psi, coeff)
    dpsi_jax, dcoeff_jax = pull(jnp.asarray(g_np))
    ref = hdiff_ref if limit else hdiff_simple_ref
    _, pull_ref = jax.vjp(lambda p, c: ref(p, c), psi, coeff)
    dpsi_ref, dcoeff_ref = pull_ref(jnp.asarray(g_np))
    _, pull_field = jax.vjp(ref, psi, jnp.full(psi.shape, coeff))
    oracle = float(np.asarray(pull_field(jnp.asarray(g_np))[1], np.float64).sum())
    # The per-point coefficient cotangent, before its broadcast is summed.
    from repro.kernels.hdiff.ops import _coupled_vjp

    field = _coupled_vjp(limit)({"u": psi, "coeff": jnp.full(psi.shape, coeff)},
                                jnp.asarray(g_np))["coeff"]
    exact = float(np.asarray(field, np.float64).sum())

    p = torch.from_numpy(psi_np).requires_grad_(True)
    c = torch.tensor(0.03, requires_grad=True)
    y = hdiff_fused_ad(p, c, limit)
    assert torch.equal(y.detach(), hdiff_fused(torch.from_numpy(psi_np), 0.03, limit=limit))
    y.backward(torch.from_numpy(g_np))
    for want in (dpsi_jax, dpsi_ref):
        want = np.asarray(want)
        rel = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
        assert rel < 1e-5, f"dpsi relative error {rel:.3e}"
    got = float(c.grad)
    for want in (oracle, exact):
        assert abs(got - want) / abs(want) < 1e-5, (got, want)
    for want in (float(dcoeff_jax), float(dcoeff_ref)):
        assert abs(got - want) / abs(want) < 2e-5, (got, want)


def test_hdiff_fused_ad_python_coefficient_is_a_constant():
    psi = torch.randn((1, 12, 12), generator=torch.Generator().manual_seed(SEED),
                      requires_grad=True)
    hdiff_fused_ad(psi, 0.025).sum().backward()
    assert psi.grad is not None and torch.isfinite(psi.grad).all()


# -- emitters of the ops adjoints create ----------------------------------------


def _f32_bits(bits):
    return np.array(bits, np.uint32).view(np.float32)[()]


_STANDINS = {
    "__int_as_float": _f32_bits,
    "limit_flux": lambda d, g: d if d * g <= 0 else np.float32(0.0),
    "limit_gate": lambda g, d, gg: g if d * gg <= 0 else np.float32(0.0),
}


def _adjoint_ops():
    """Every distinct op tag of the roster's adjoint and augmented programs
    (k = 1; chains repeat the same sweeps), one op each, plus the gate's
    own adjoint term."""
    ops = {}
    for name in ROSTER:
        q = TORCH_PROGRAMS[name]()
        for prog in (tir.adjoint(q), tir.augmented_forward(q)):
            for op in prog.ops:
                ops.setdefault(op.tag, op)
    gate = next(op for tag, op in ops.items() if tag.endswith(":gate"))
    (_, term), = gate.vjp(gate, "g2", lambda base: base)
    ops.setdefault(f"{term.tag}/d", term)
    return ops


ADJ_OPS = _adjoint_ops()


def test_adjoint_ops_use_only_ruled_tags():
    """The roster's adjoints use only explicit rules: no generic term."""
    kinds = {tag.split(":")[0] + (":" + tag.split(":")[1] if tag.startswith("adj") else "")
             for tag in ADJ_OPS}
    assert not any("generic" in k for k in kinds)
    assert {"adj:sum", "adj:flux", "adj:product", "adj:weighted_residual"} <= kinds


@pytest.mark.parametrize("tag", sorted(ADJ_OPS))
def test_emit_equals_compute_bit_for_bit(tag):
    """Each emitter's C expression, evaluated over float32 scalars with
    Python stand-ins for ``__int_as_float``, ``limit_flux`` and
    ``limit_gate`` (numpy float32 rounds every operation as ``-fmad=false``
    CUDA does), equals ``compute`` on the same values, bit for bit —
    including points where the gate's ``d * gg`` sits at zero."""
    op = ADJ_OPS[tag]
    names = [f"a{i}" for i in range(len(op.reads))]
    expr = op.emit(*names)
    rng = np.random.default_rng(SEED)
    vals = rng.standard_normal((500, len(names))).astype(np.float32)
    vals[:50, 1:] = vals[:50, 1:2]  # equal neighbours: differences exactly zero
    vals[50:60] = 0.0
    for row in vals:
        env = dict(_STANDINS, **{n: np.float32(v) for n, v in zip(names, row)})
        got = np.float32(eval(expr, {}, env))
        want = op.compute(*(torch.tensor(v) for v in row)).numpy()
        assert np.array_equal(np.array(got).view(np.uint32), want.view(np.uint32)), (
            f"{tag}: {expr} gives {got}, compute {want} at {row}")


def _custom_program():
    """A one-op program whose op has no adjoint rule: ``u * u`` at offset 0
    plus a shifted read, so the generic rule builds its adjoint terms."""
    op = StencilOp("sq", (Read("u", (0, 0)), Read("u", (0, 1))), lambda a, b: a * b,
                   OpCost(macs=1), tag="custom-sq")
    return StencilProgram("custom", ["u"], [op], ndim=2)


def test_generic_rule_runs_eagerly_and_has_no_cuda_emitter():
    p = _custom_program()
    adj = tir.adjoint(p)
    assert any(op.tag.startswith("adj:generic") and op.emit is None for op in adj.ops)
    x = torch.randn((1, 6, 7), generator=torch.Generator().manual_seed(SEED),
                    requires_grad=True)
    y = tir.build_backend(p, "reference", differentiable=True)(x)
    y.sum().backward()
    xx = x.detach().clone().requires_grad_(True)
    tir.lower_reference(p)(xx).sum().backward()
    torch.testing.assert_close(x.grad, xx.grad, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="has no CUDA emitter"):
        render(adj, ("float32",) * len(adj.inputs), tile_for(adj, 6, 7))


def test_gate_helper_is_imported_only_where_used():
    q = tir.hdiff_coupled_program()
    adj = tir.adjoint(q)
    src = render(adj, ("float32",) * len(adj.inputs), tile_for(adj, 256, 256))
    assert "using repro_torch::limit_gate;" in src and "limit_gate(" in src
    src = render(q, ("float32",) * len(q.inputs), tile_for(q, 256, 256))
    assert "limit_gate" not in src
