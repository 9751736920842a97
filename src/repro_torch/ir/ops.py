"""Combinator library: the reusable node builders programs are made of.

The PyTorch counterpart of ``repro/ir/ops.py``. Each combinator constructs a
:class:`~repro_torch.ir.graph.StencilOp` with the JAX package's ``tag``,
:class:`~repro_torch.ir.graph.OpCost` and adjoint rule, so programs built
here fingerprint identically. Two things are the port's own:

  * ``compute`` is an elementwise torch function over aligned shifted views,
    with the JAX combinator's tap order and :func:`_tree_sum` association,
    so the eager lowering reproduces the reference's float32 rounding.
  * ``emit`` renders the same arithmetic as a CUDA C++ float expression for
    the generated fused kernel (:mod:`repro_torch.ir.codegen_cuda`): same
    association, every constant written as its exact float32 bit pattern
    (``__int_as_float(0x...)``) — a decimal literal at too few digits would
    round differently and move the flux limiter's ``d * g <= 0`` decision.

Cost conventions (matching SPARTA §3.1):
  * ``affine``            — one MAC per tap (Eq. 5 counts a 5-point Laplacian
                            as 5 MACs).
  * ``flux``              — 1 sub for the stencil difference, plus 3 ops
                            (mul, cmp, select) when the Eq. 2-3 limiter is on.
  * ``scaled_residual``   — one accumulate per term plus a single MAC for the
                            shared scale against the base field.
  * ``product``           — one MAC (elementwise field x field multiply).
  * ``weighted_residual`` — ``scaled_residual`` with the scale promoted from
                            a baked-in scalar to a *field* read at offset zero.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.ir.graph import Offset, OpCost, Read, StencilOp


def _tree_sum(vals):
    """Balanced pairwise sum — matches the hand-written kernels' grouping
    of ``(a + b) + (c + d)`` so lowered programs stay bitwise-comparable.
    Works on tensors and on C++ expression strings alike."""
    vals = list(vals)
    while len(vals) > 1:
        vals = [
            _add(vals[i], vals[i + 1]) if i + 1 < len(vals) else vals[i]
            for i in range(0, len(vals), 2)
        ]
    return vals[0]


def _add(a, b):
    if isinstance(a, str):
        return f"({a} + {b})"
    return a + b


def f32_literal(value: float) -> str:
    """``value`` rounded to float32 (round to nearest even, as JAX rounds a
    weakly typed Python scalar against a float32 array) and written as its
    exact bit pattern for CUDA C++."""
    bits = int(np.array(value, np.float32).view(np.uint32))
    return f"__int_as_float(0x{bits:08x})"


def _neg(o: Offset) -> Offset:
    return tuple(-c for c in o)


def _sub(a: Offset, b: Offset) -> Offset:
    return tuple(x - y for x, y in zip(a, b))


def _signed(vals, signs):
    if vals and isinstance(vals[0], str):
        return [v if s > 0 else f"(-{v})" for v, s in zip(vals, signs)]
    return [v if s > 0 else -v for v, s in zip(vals, signs)]


# ---------------------------------------------------------------------------
# Adjoint (vjp) rules, carried over from the JAX package unchanged in
# structure; :mod:`repro_torch.ir.autodiff` builds the adjoint programs from
# them. Every op a rule creates carries an ``emit`` with its ``compute``'s
# operand order and association, so adjoint programs lower to the generated
# kernel too. The transposition convention: a read of field f at offset o
# contributes to f's cotangent at offset -o.
# ---------------------------------------------------------------------------


def affine(name: str, field: str, taps: Mapping[Offset, float]) -> StencilOp:
    """Weighted stencil sum: ``out = sum_k w_k * field[offset_k]``.

    Tap order is preserved (it fixes floating-point association). A
    uniform-weight stencil is factored as ``w * (v_0 + v_1 + ...)``, the
    form the jacobi family uses.
    """
    offsets = tuple(taps)
    weights = tuple(float(taps[o]) for o in offsets)
    uniform = len(set(weights)) == 1

    def compute(*views):
        if uniform:
            acc = views[0]
            for v in views[1:]:
                acc = acc + v
            return weights[0] * acc
        acc = weights[0] * views[0]
        for w, v in zip(weights[1:], views[1:]):
            acc = acc + w * v
        return acc

    def emit(*views):
        if uniform:
            acc = views[0]
            for v in views[1:]:
                acc = f"({acc} + {v})"
            return f"({f32_literal(weights[0])} * {acc})"
        acc = f"({f32_literal(weights[0])} * {views[0]})"
        for w, v in zip(weights[1:], views[1:]):
            acc = f"({acc} + ({f32_literal(w)} * {v}))"
        return acc

    def rule(op, gbar, fresh):
        src = op.reads[0].field
        adj_taps = {_neg(r.offset): w for r, w in zip(op.reads, weights)}
        if adj_taps == {_neg(op.reads[0].offset): 1.0} and not any(
            c for c in op.reads[0].offset
        ):
            return [(src, gbar)]
        return [(src, affine(fresh(f"{op.name}.d_{src}"), gbar, adj_taps))]

    reads = tuple(Read(field, o) for o in offsets)
    tag = "affine:" + ",".join(f"{o}={w!r}" for o, w in zip(offsets, weights))
    return StencilOp(
        name, reads, compute, OpCost(macs=len(offsets)), tag=tag, vjp=rule,
        emit=emit,
    )


def flux(
    name: str,
    of: str,
    lo: Offset,
    hi: Offset,
    *,
    limiter: str | None = None,
) -> StencilOp:
    """Finite difference ``of[hi] - of[lo]``, optionally flux-limited.

    With ``limiter=g`` the result is zeroed when it points up-gradient of
    ``g`` across the same pair of points (Eq. 2-3):
    ``F = d if d * (g[hi] - g[lo]) <= 0 else 0``.
    """
    reads = [Read(of, hi), Read(of, lo)]
    if limiter is not None:
        reads += [Read(limiter, hi), Read(limiter, lo)]

    def compute(a_hi, a_lo, *grad):
        d = a_hi - a_lo
        if not grad:
            return d
        g = grad[0] - grad[1]
        return torch.where(d * g <= 0, d, torch.zeros_like(d))

    def emit(a_hi, a_lo, *grad):
        if not grad:
            return f"({a_hi} - {a_lo})"
        # limit_flux (csrc/stencil_common.cuh): d if d * g <= 0 else 0.
        return f"limit_flux({a_hi} - {a_lo}, {grad[0]} - {grad[1]})"

    def rule(op, gbar, fresh):
        src = op.reads[0].field
        if hi == lo:
            return []
        if len(op.reads) == 2:
            return [
                (src, affine(fresh(f"{op.name}.d_{src}"),
                             gbar, {_neg(hi): 1.0, _neg(lo): -1.0}))
            ]
        # Limited: the gate carries no gradient into the limiter field; it
        # is evaluated once at the flux position and distributed by a
        # transposed affine, keeping the adjoint at the primal bandwidth.
        lim = op.reads[2].field
        zero = tuple(0 for _ in hi)
        gate_reads = (
            Read(gbar, zero),
            Read(src, hi), Read(src, lo),
            Read(lim, hi), Read(lim, lo),
        )

        def gate(g, a_hi, a_lo, l_hi, l_lo):
            d = a_hi - a_lo
            gg = l_hi - l_lo
            return torch.where(d * gg <= 0, g, torch.zeros_like(g))

        def gate_emit(g, a_hi, a_lo, l_hi, l_lo):
            # limit_gate (csrc/stencil_common.cuh): g if d * gg <= 0 else 0.
            return f"limit_gate({g}, {a_hi} - {a_lo}, {l_hi} - {l_lo})"

        def gate_rule(gop, gbar2, fresh2):
            reads2 = (Read(gbar2, gop.reads[0].offset),) + gop.reads[1:]
            return [(gop.reads[0].field, StencilOp(
                fresh2(f"{gop.name}.d"), reads2, gate, gop.cost,
                tag=gop.tag, vjp=gate_rule, emit=gate_emit,
            ))]

        gate_op = StencilOp(
            fresh(f"{op.name}.dgate"), gate_reads, gate,
            OpCost(other_ops=4), tag=f"adj:{op.tag}:gate", vjp=gate_rule,
            emit=gate_emit,
        )
        return [
            (None, gate_op),
            (src, affine(fresh(f"{op.name}.d_{src}"),
                         gate_op.name, {_neg(hi): 1.0, _neg(lo): -1.0})),
        ]

    cost = OpCost(other_ops=1 + (3 if limiter is not None else 0))
    tag = f"flux:lo={lo},hi={hi},limited={limiter is not None}"
    return StencilOp(name, tuple(reads), compute, cost, tag=tag, vjp=rule, emit=emit)


def product(
    name: str,
    a: str,
    b: str,
    *,
    a_offset: Offset | None = None,
    b_offset: Offset | None = None,
    ndim: int = 2,
) -> StencilOp:
    """Elementwise field product ``out = a[a_offset] * b[b_offset]``."""
    zero = (0,) * ndim
    reads = (
        Read(a, a_offset if a_offset is not None else zero),
        Read(b, b_offset if b_offset is not None else zero),
    )

    def compute(va, vb):
        return va * vb

    def emit(va, vb):
        return f"({va} * {vb})"

    def rule(op, gbar, fresh):
        (ra, rb) = op.reads
        out = []
        for mine, other, label in ((ra, rb, "a"), (rb, ra, "b")):
            reads_t = (
                Read(gbar, _neg(mine.offset)),
                Read(other.field, _sub(other.offset, mine.offset)),
            )
            out.append((mine.field, StencilOp(
                fresh(f"{op.name}.d_{mine.field}.{label}"), reads_t,
                lambda g, v: g * v, OpCost(macs=1),
                tag=f"adj:product:{label}", emit=emit,
            )))
        return out

    return StencilOp(
        name, reads, compute, OpCost(macs=1), tag="product", vjp=rule, emit=emit
    )


def weighted_residual(
    name: str,
    base: str,
    weight: str,
    terms: Sequence[tuple[str, int]],
    *,
    ndim: int = 2,
) -> StencilOp:
    """``out = base - weight * sum(sign_i * term_i)`` with a *field* weight.

    Term grouping matches :func:`scaled_residual` exactly, so a constant
    weight field reproduces the scalar kernel bit-for-bit.
    """
    for f, s in terms:
        if s not in (1, -1):
            raise ValueError(f"sign for {f!r} must be +1/-1, got {s}")
    signs = tuple(s for _, s in terms)

    def compute(b, w, *ts):
        return b - w * _tree_sum(_signed(ts, signs))

    def emit(b, w, *ts):
        return f"({b} - ({w} * {_tree_sum(_signed(ts, signs))}))"

    def rule(op, gbar, fresh):
        base_f, w_f = op.reads[0].field, op.reads[1].field
        t_fields = tuple(r.field for r in op.reads[2:])
        zero_o = op.reads[0].offset
        out = [(base_f, gbar)]

        def w_term(g, *ts):
            return -g * _tree_sum(_signed(ts, signs))

        def w_emit(g, *ts):
            return f"((-{g}) * {_tree_sum(_signed(ts, signs))})"

        out.append((w_f, StencilOp(
            fresh(f"{op.name}.d_{w_f}"),
            (Read(gbar, zero_o),) + tuple(Read(f, zero_o) for f in t_fields),
            w_term, OpCost(macs=1, other_ops=len(signs)),
            tag=f"adj:{op.tag}:w", emit=w_emit,
        )))
        for i, (tf, s) in enumerate(zip(t_fields, signs)):
            out.append((tf, StencilOp(
                fresh(f"{op.name}.d_{tf}"),
                (Read(gbar, zero_o), Read(w_f, zero_o)),
                (lambda g, w: -(w * g)) if s > 0 else (lambda g, w: w * g),
                OpCost(macs=1), tag=f"adj:{op.tag}:t{i}",
                emit=(lambda g, w: f"(-({w} * {g}))") if s > 0
                else (lambda g, w: f"({w} * {g})"),
            )))
        return out

    zero = (0,) * ndim
    reads = (Read(base, zero), Read(weight, zero)) + tuple(
        Read(f, zero) for f, _ in terms
    )
    tag = "weighted_residual:signs=" + ",".join(str(s) for _, s in terms)
    return StencilOp(
        name, reads, compute, OpCost(macs=1, other_ops=len(terms)), tag=tag,
        vjp=rule, emit=emit,
    )


def scaled_residual(
    name: str,
    base: str,
    terms: Sequence[tuple[str, int]],
    scale: float,
    *,
    ndim: int = 2,
) -> StencilOp:
    """``out = base - scale * sum(sign_i * term_i)`` at offset zero.

    The hdiff output stage (Eq. 4) and any explicit-Euler update take this
    shape. The signed terms are combined pairwise, matching the hand-written
    ``(F_r - F_rm) + (G_c - G_cm)`` grouping.
    """
    for f, s in terms:
        if s not in (1, -1):
            raise ValueError(f"sign for {f!r} must be +1/-1, got {s}")
    signs = tuple(s for _, s in terms)

    def compute(b, *ts):
        return b - scale * _tree_sum(_signed(ts, signs))

    def emit(b, *ts):
        return f"({b} - ({f32_literal(scale)} * {_tree_sum(_signed(ts, signs))}))"

    def rule(op, gbar, fresh):
        base_f = op.reads[0].field
        zero_o = op.reads[0].offset
        out = [(base_f, gbar)]
        for r, s in zip(op.reads[1:], signs):
            out.append((r.field, affine(
                fresh(f"{op.name}.d_{r.field}"),
                gbar, {zero_o: -float(scale) * s},
            )))
        return out

    zero = (0,) * ndim
    reads = (Read(base, zero),) + tuple(Read(f, zero) for f, _ in terms)
    tag = (
        f"scaled_residual:scale={float(scale)!r},signs="
        + ",".join(str(s) for _, s in terms)
    )
    return StencilOp(
        name, reads, compute, OpCost(macs=1, other_ops=len(terms)), tag=tag,
        vjp=rule, emit=emit,
    )
