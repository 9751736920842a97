"""Derived adjoint stencils: autodiff as a graph transform on the IR.

The PyTorch counterpart of ``repro/ir/autodiff.py``. The adjoint of a
stencil is another stencil with transposed access offsets: a read of field
``f`` at offset ``o`` contributes to ``f``'s cotangent at ``-o``.
:func:`adjoint` derives that program from a
:class:`~repro_torch.ir.graph.StencilProgram`'s DAG — reverse the op chain,
negate every linear tap, and linearize the nonlinear combinators (flux
limiters, products) around the saved primal — so the backward pass of every
lowering is ITSELF an IR program: on the card it goes through ``lower_cuda``
as its own generated fused kernel (K2), like any forward program.

Structure of ``adjoint(p)`` for a single sweep ``p``:

  * inputs — one ``g~f`` cotangent seed per output field, every primal
    input, one ``c~op`` SAVED-VALUE slot per primal intermediate the
    linearization needs (produced by :func:`augmented_forward`; reading the
    saved value keeps every adjoint access a mirrored primal access, so the
    adjoint's radii EQUAL the primal's), and one ``d~c`` running-cotangent
    accumulator per non-evolving input;
  * ops — walking the primal DAG in reverse, a cotangent-sum per primal op
    followed by the op's per-read adjoint terms (the
    :attr:`~repro_torch.ir.graph.StencilOp.vjp` rule, or the generic
    ``torch.func.vjp``-per-point fallback for custom ops, which has no CUDA
    emitter);
  * outputs — ``{g~f: ...}`` (the cotangent of each evolving input) and
    ``{d~c: d~c + contributions}`` (aux cotangents accumulate across
    sweeps), so the adjoint of a composed chain is the reversed chain of
    per-sweep adjoints.

Boundary exactness (the gradient of ``lower_reference`` is the contract): a
full-shape application computes the square radius-``r`` interior and passes
the ring through, so the true input cotangent is ``ring_mask * g +
f^T(interior_mask * g)``, with ``f^T`` evaluated AT ring points too under
zero extension beyond the grid. On one device (``build``): mask the ring of
the output cotangent, zero-PAD every adjoint input by the radius per side,
run the ring-semantics lowering of the adjoint program on the padded grid,
CROP back and add the ring passthrough term. Any pad >= r is exact.
Sharded (``build_zero``): lower the adjoint and augmented sweeps with
``lower_sharded(..., boundary="zero")``, which computes every owned point
under zero extension from the exchanged block, so nothing is padded or
cropped. The sharded step is SPMD (each rank holds its block), so the ring
masks take each block's global placement (``placement``).

Temporal blocking reverses sweep by sweep: the forward pass saves only the
INPUT tensors, the backward recomputes the k-1 intermediate states with the
per-sweep forward lowerings (or the augmented forwards, which yield them),
then runs the k adjoint sweeps in reverse — all through the backend the
caller picked (``build_backend(..., differentiable=True)``), where
:func:`differentiable_lowering` attaches the backward as a
``torch.autograd.Function``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Mapping

import torch

from repro_torch.ir.evaluate import resolve_field_arrays
from repro_torch.ir.graph import OpCost, Read, StencilOp, StencilProgram
from repro_torch.ir.ops import _neg, _sub, _tree_sum, affine

Tensor = torch.Tensor

#: Prefixes of the derived cotangent/cache fields. "~" cannot appear in any
#: name the combinator builders or compose() mint.
_SEED = "g~"
_ACC = "d~"
_CACHE = "c~"


def seed_field(field: str) -> str:
    """The adjoint program's input holding ``field``'s output cotangent
    (and its output holding ``field``'s input cotangent)."""
    return _SEED + field


def acc_field(field: str) -> str:
    """The adjoint program's running-cotangent accumulator for a
    non-evolving input ``field``."""
    return _ACC + field


def cache_field(op_name: str) -> str:
    """The adjoint program's input holding primal op ``op_name``'s saved
    value (the linearization point of the nonlinear combinators)."""
    return _CACHE + op_name


def cache_fields(program: StencilProgram) -> tuple[str, ...]:
    """Primal op names whose values single-sweep ``program``'s adjoint
    linearizes around — the fields :func:`augmented_forward` must save."""
    return tuple(
        f[len(_CACHE):]
        for f in adjoint(program).inputs
        if f.startswith(_CACHE)
    )


@functools.lru_cache(maxsize=None)
def augmented_forward(program: StencilProgram) -> StencilProgram:
    """Single-sweep ``program`` with its adjoint's linearization caches as
    EXTRA OUTPUTS (``c~op``): the same op DAG and per-input radii; the cache
    slots are declared as zero-read dummy inputs purely to give the extra
    outputs a base ring. Returns ``program`` itself when the adjoint is
    linear (nothing to cache)."""
    caches = cache_fields(program)
    if not caches:
        return program
    inputs = list(program.inputs)
    outputs = dict(program.outputs)
    for n in caches:
        inputs.append(cache_field(n))
        outputs[cache_field(n)] = n
    return StencilProgram(
        f"{program.name}.aug",
        inputs,
        program.ops,
        ndim=program.ndim,
        passthrough=program.passthrough,
        outputs=outputs,
    )


def _sum_fields(name: str, fields, zero) -> StencilOp:
    """Offset-0 sum of cotangent contribution fields (balanced pairwise,
    like every combinator). Its own adjoint is the identity fan-out."""
    reads = tuple(Read(f, zero) for f in fields)

    def compute(*views):
        return _tree_sum(views)

    def emit(*views):
        return _tree_sum(views)

    def rule(op, gbar, fresh):
        return [(r.field, gbar) for r in op.reads]

    return StencilOp(
        name, reads, compute, OpCost(other_ops=max(len(reads) - 1, 0)),
        tag="adj:sum", vjp=rule, emit=emit,
    )


def _generic_rule(op: StencilOp, gbar: str, fresh) -> list:
    """Fallback adjoint rule for ops without an explicit
    :attr:`~repro_torch.ir.graph.StencilOp.vjp`: one term per read,
    evaluating ``torch.func.vjp`` of the op's elementwise compute at the
    consumer position (offset ``-o_j``), with every primal read re-aligned
    to ``o_i - o_j``. Its terms have no ``emit``: they run in the eager
    lowerings, and the generated kernel refuses them."""
    out = []
    for j, rj in enumerate(op.reads):
        reads = (Read(gbar, _neg(rj.offset)),) + tuple(
            Read(r.field, _sub(r.offset, rj.offset)) for r in op.reads
        )

        def term(g, *views, _j=j, _f=op.compute):
            _, pullback = torch.func.vjp(lambda *vs: _f(*vs), *views)
            return pullback(g)[_j]

        out.append((rj.field, StencilOp(
            fresh(f"{op.name}.d{j}"), reads, term, op.cost,
            tag=f"adj:generic:{j}:{op.tag or op.name}",
        )))
    return out


def _adjoint_single(p: StencilProgram) -> StencilProgram:
    nd = p.ndim
    zero = (0,) * nd
    aux = tuple(f for f in p.inputs if f not in p.outputs)
    seeds = {f: seed_field(f) for f in p.outputs}
    accs = {c: acc_field(c) for c in aux}
    taken = set(p.inputs) | {op.name for op in p.ops}
    minted = list(seeds.values()) + list(accs.values())
    clash = [n for n in minted if n in taken]
    if clash or len(set(minted)) != len(minted):
        raise ValueError(
            f"program {p.name!r} has fields colliding with the adjoint "
            f"name mangling: {clash or minted}"
        )
    inputs = (
        [seeds[f] for f in p.outputs] + list(p.inputs) + [accs[c] for c in aux]
    )

    used = set(inputs) | {op.name for op in p.ops}

    def fresh(base: str) -> str:
        n, i = base, 0
        while n in used:
            i += 1
            n = f"{base}~{i}"
        used.add(n)
        return n

    seed_of_op = {op_name: seeds[f] for f, op_name in p.outputs.items()}
    contribs: dict[str, list[str]] = {}
    adj_ops: list[StencilOp] = []

    def add(field: str | None, term) -> None:
        # A rule may emit (None, op) helpers (e.g. a flux gate) that
        # contribute to no field directly; strings contribute an EXISTING
        # field at offset zero.
        if field is None:
            adj_ops.append(term)
        elif isinstance(term, str):
            contribs.setdefault(field, []).append(term)
        else:
            adj_ops.append(term)
            contribs.setdefault(field, []).append(term.name)

    # Reverse sweep over the primal DAG: when op X is visited, every
    # consumer of X was already processed, so X's full output cotangent is
    # the sum of the terms they emitted (plus the seed if X is an output).
    for op in reversed(p.ops):
        cs: list[str] = []
        if op.name in seed_of_op:
            cs.append(seed_of_op[op.name])
        cs.extend(contribs.get(op.name, ()))
        if not cs:
            continue  # op does not influence any output: no adjoint work
        if len(cs) == 1:
            gbar = cs[0]
        else:
            sop = _sum_fields(fresh(f"{op.name}.gsum"), cs, zero)
            adj_ops.append(sop)
            gbar = sop.name
        rule = op.vjp if op.vjp is not None else _generic_rule
        for field, term in rule(op, gbar, fresh):
            add(field, term)

    out_ops: list[StencilOp] = []
    outputs: dict[str, str] = {}
    for f in p.outputs:
        cs = contribs.get(f, [])
        name = fresh(f"{f}.dsum")
        if cs:
            out_ops.append(_sum_fields(name, cs, zero))
        else:  # output never differentiably reads this state: zero cotangent
            out_ops.append(affine(name, seeds[f], {zero: 0.0}))
        outputs[seeds[f]] = name
    for c in aux:
        name = fresh(f"{c}.dsum")
        out_ops.append(_sum_fields(name, [accs[c]] + contribs.get(c, []), zero))
        outputs[accs[c]] = name

    # Primal intermediates the linearization needs become CACHE INPUTS
    # (``c~op``), not recompute ops: recomputing e.g. a Laplacian inside the
    # adjoint DAG would widen the adjoint's radius past the primal's.
    adj_all = adj_ops + out_ops
    primal_order = {op.name: i for i, op in enumerate(p.ops)}
    roots = sorted(
        {
            r.field
            for op in adj_all
            for r in op.reads
            if r.field in primal_order
        },
        key=primal_order.__getitem__,
    )
    rename = {n: cache_field(n) for n in roots}
    adj_all = [
        dataclasses.replace(
            op,
            reads=tuple(
                Read(rename.get(r.field, r.field), r.offset) for r in op.reads
            ),
        )
        if any(r.field in rename for r in op.reads)
        else op
        for op in adj_all
    ]
    inputs = (
        [seeds[f] for f in p.outputs]
        + list(p.inputs)
        + [rename[n] for n in roots]
        + [accs[c] for c in aux]
    )

    return StencilProgram(
        f"{p.name}.adj",
        inputs,
        adj_all,
        ndim=nd,
        passthrough=seeds[p.passthrough],
        outputs=outputs,
    )


@functools.lru_cache(maxsize=None)
def adjoint(program: StencilProgram) -> StencilProgram:
    """The adjoint IR program of ``program``.

    For a single sweep this is the transposed-offset reverse DAG (see the
    module docstring). For a composed chain it is the REVERSED chain of
    per-sweep adjoints (``adjoint(p_k) >> ... >> adjoint(p_1)``), composed
    through the ordinary threading convention; numerically each reverse
    sweep must be linearized at ITS OWN primal state, which :func:`make_vjp`
    feeds per sweep (it never builds the composed object)."""
    if program.steps == 1:
        return _adjoint_single(program)
    parts = [adjoint(q) for q in reversed(program.chain)]
    acc = parts[0]
    for i, q in enumerate(parts[1:]):
        name = f"{program.name}.adj" if i == len(parts) - 2 else None
        acc = acc.compose(q, name=name)
    return acc


def pad_widths(
    program: StencilProgram,
    grid: tuple[int, ...],
) -> tuple[tuple[int, int], ...]:
    """Per-trailing-dim ``(lo, hi)`` zero-pad for one single-device
    backward sweep of single-sweep ``program`` on ``grid``: ``pad >=
    max(radius, adjoint radius)`` per side puts the whole original grid
    (ring included) in the padded evaluation's computed interior."""
    pr = max(program.radius, adjoint(program).radius)
    return tuple((pr, pr) for _ in grid)


def _interior_mask(shape: tuple[int, ...], r: int, device, placement=None) -> Tensor:
    """Boolean mask of ``shape`` that is True on the radius-``r`` interior,
    from per-dim index compares (elementwise: no slice-and-scatter).
    ``placement(shape) -> (offsets, global extents)`` puts a shard block in
    its global grid, whose ring the mask then marks."""
    offsets, extents = placement(shape) if placement else ((0,) * len(shape), shape)
    ok = None
    for d, s in enumerate(shape):
        i = offsets[d] + torch.arange(s, device=device).view((s,) + (1,) * (len(shape) - d - 1))
        c = (i >= r) & (i < extents[d] - r)
        ok = c if ok is None else ok & c
    return ok


def _mask_interior(g: Tensor, r: int, nd: int, placement=None) -> Tensor:
    """Zeroes the square radius-``r`` boundary ring of ``g``."""
    if r == 0:
        return g
    m = _interior_mask(tuple(g.shape[-nd:]), r, g.device, placement)
    return torch.where(m, g, torch.zeros_like(g))


def _ring_swap(prev: Tensor, new: Tensor, r: int, nd: int, placement=None) -> Tensor:
    """``new`` on the radius-``r`` interior, ``prev`` on the ring — the
    full-shape sweep convention, reconstructed elementwise."""
    if r == 0:
        return new
    m = _interior_mask(tuple(new.shape[-nd:]), r, new.device, placement)
    return torch.where(m, new, prev)


def _pad(a: Tensor, pads, nd: int) -> Tensor:
    if all(lo == 0 and hi == 0 for lo, hi in pads):
        return a
    flat = [w for lo_hi in reversed(pads) for w in lo_hi]  # last dim first
    return torch.nn.functional.pad(a, flat)


def _crop(a: Tensor, pads, nd: int, grid) -> Tensor:
    idx = (Ellipsis,) + tuple(
        slice(lo, lo + s) for (lo, _hi), s in zip(pads, grid)
    )
    return a[idx]


def _apply_sweep(q: StencilProgram, step, state, shared):
    """One forward chain entry, mirroring ``thread_chain``'s convention."""
    if isinstance(state, Mapping):
        sub = {f: shared[f] for f in q.inputs if f not in q.outputs}
        sub.update(state)
        return dict(step(sub))
    if len(q.inputs) == 1:
        return step(state)
    sub = {f: shared[f] for f in q.inputs if f != q.passthrough}
    sub[q.passthrough] = state
    return step(sub)


def _sweep_bwd(q, adj_fn, state, shared, gbar, acc, cache, zero, placement):
    """One reverse sweep: mask ring, run the lowered adjoint, re-add the
    ring passthrough. ``state``/``gbar`` are ``{field: tensor}`` over
    ``q.outputs``; ``acc`` holds the running aux cotangents; ``cache`` maps
    primal op name -> saved value in the sweep's layout (or None). With
    ``zero=False`` (one device) every adjoint input is zero-padded and the
    result cropped, which emulates the zero boundary; with ``zero=True``
    ``adj_fn`` is a ``boundary="zero"`` sharded lowering and the blocks pass
    through unpadded."""
    nd = q.ndim
    r = q.radius
    adj = adjoint(q)
    grid = tuple(next(iter(gbar.values())).shape[-nd:])
    pads = None if zero else pad_widths(q, grid)

    def lift(a):
        return a if zero else _pad(a, pads, nd)

    def unlift(a):
        return a if zero else _crop(a, pads, nd, grid)

    g_int = {f: _mask_interior(g, r, nd, placement) for f, g in gbar.items()}
    args = {}
    for f in q.outputs:
        args[seed_field(f)] = lift(g_int[f])
        args[f] = lift(state[f])
    q_aux = tuple(f for f in q.inputs if f not in q.outputs)
    for c in q_aux:
        args[c] = lift(shared[c])
        args[acc_field(c)] = lift(acc[c])
    if cache:
        for n, a in cache.items():
            args[cache_field(n)] = a
    res = adj_fn(args if len(adj.inputs) > 1 else args[adj.inputs[0]])
    if not isinstance(res, Mapping):
        res = {adj.passthrough: res}
    new_g = {
        f: unlift(res[seed_field(f)]) + (gbar[f] - g_int[f])
        for f in q.outputs
    }
    new_acc = dict(acc)
    for c in q_aux:
        new_acc[c] = unlift(res[acc_field(c)])
    return new_g, new_acc


def make_vjp(
    program: StencilProgram,
    build: Callable[[StencilProgram], Callable],
    *,
    build_zero: Callable[[StencilProgram], Callable] | None = None,
    placement: Callable | None = None,
) -> Callable:
    """``(x, g) -> input cotangents`` for ``program``, with every sweep —
    forward recompute and reverse adjoint — lowered through ``build`` (a
    ``StencilProgram -> callable`` factory, e.g. a ``build_backend``
    partial). The cotangent mirrors ``x``: bare tensor in, bare tensor out;
    ``{field: tensor}`` in, a cotangent per declared input out.

    ``build_zero`` switches the adjoint and augmented sweeps to
    zero-boundary evaluation on the UNPADDED blocks: pass a
    ``lower_sharded(..., boundary="zero")`` factory for the sharded
    backends, with ``placement`` (a block's trailing shape -> ``(offsets,
    global extents)``, :func:`repro_torch.ir.lower_sharded.block_placement`)
    so that the ring masks mark the GLOBAL ring of each rank's block. Leave
    both ``None`` on one device, where the zero boundary is emulated by a
    local pad, the ring-semantics lowering and a crop. Forward
    state-recompute sweeps always use ``build``."""
    chain = program.chain
    multi = len(program.outputs) > 1
    nd = program.ndim
    zero = build_zero is not None
    zbuild = build_zero if zero else build
    adj_fns: dict[str, Callable] = {}
    aug_fns: dict[str, Callable] = {}
    fwd_fns: dict[str, Callable] = {}
    for q in chain:
        fp = q.fingerprint()
        if fp not in adj_fns:
            adj_fns[fp] = zbuild(adjoint(q))
            if cache_fields(q):
                aug_fns[fp] = zbuild(augmented_forward(q))
    # Whether the backward needs the primal state at all: linear sweeps
    # cache nothing and their adjoints never read a primal field, so the
    # whole forward-recompute pass is skipped (the adjoint args still carry
    # a state tensor for signature uniformity; it is dead).
    needs_state = any(
        cache_fields(q)
        or any(
            r.field in q.inputs for op in adjoint(q).ops for r in op.reads
        )
        for q in chain
    )
    if needs_state:
        for q in chain[:-1]:
            fp = q.fingerprint()
            if fp not in aug_fns and fp not in fwd_fns:
                fwd_fns[fp] = build(q)

    def vjp_fn(x, g):
        arrays = resolve_field_arrays(program, x)
        env = dict(zip(program.inputs, arrays))
        shared = {f: env[f] for f in program.inputs if f not in program.outputs}
        if multi:
            state = {f: env[f] for f in program.outputs}
        else:
            state = env[program.passthrough]
        # Forward: thread the chain, saving the (unpadded) entry state of
        # every sweep plus the linearization caches. Sweeps with caches run
        # the augmented forward in the layout the adjoint consumes and
        # recover the next true state by swapping the computed interior into
        # the entry state's ring.
        states, caches = [], []
        for i, q in enumerate(chain):
            states.append(state)
            fp = q.fingerprint()
            cf = cache_fields(q)
            if needs_state and cf:
                sd = state if multi else {q.passthrough: state}
                grid = tuple(next(iter(sd.values())).shape[-nd:])
                pads = None if zero else pad_widths(q, grid)

                def lift(a, pads=pads):
                    return a if zero else _pad(a, pads, nd)

                args = {f: lift(sd[f]) for f in q.outputs}
                for c in q.inputs:
                    if c not in q.outputs:
                        args[c] = lift(shared[c])
                for n in cf:
                    args[cache_field(n)] = torch.zeros_like(args[q.passthrough])
                out = aug_fns[fp](args)
                caches.append({n: out[cache_field(n)] for n in cf})
                if i < len(chain) - 1:
                    new = {}
                    for f in q.outputs:
                        swept = out[f] if zero else _crop(out[f], pads, nd, grid)
                        new[f] = _ring_swap(sd[f], swept, q.radius, nd, placement)
                    state = new if multi else new[q.passthrough]
            else:
                caches.append(None)
                if needs_state and i < len(chain) - 1:
                    state = _apply_sweep(q, fwd_fns[fp], state, shared)
        gbar = dict(g) if multi else g
        acc = {c: torch.zeros_like(a) for c, a in shared.items()}
        for i in range(len(chain) - 1, -1, -1):
            q = chain[i]
            st = states[i]
            g_d, acc = _sweep_bwd(
                q,
                adj_fns[q.fingerprint()],
                st if multi else {q.passthrough: st},
                shared,
                gbar if multi else {q.passthrough: gbar},
                acc,
                caches[i],
                zero,
                placement,
            )
            gbar = g_d if multi else g_d[q.passthrough]
        if isinstance(x, Mapping):
            out = {}
            for f in program.inputs:
                if f in program.outputs:
                    out[f] = gbar[f] if multi else gbar
                else:
                    out[f] = acc[f]
            return out
        return gbar

    return vjp_fn


class _Lowered(torch.autograd.Function):
    """A lowered forward with the derived adjoint as its backward. ``spec``
    is ``(program, fwd_fn, vjp_fn, mapping)``; the tensors are the inputs in
    ``program.inputs`` order (one, bare, when ``mapping`` is False). Saves
    only the inputs, as the JAX package's ``custom_vjp`` saves ``x``."""

    @staticmethod
    def forward(ctx, spec, *arrays):
        program, fwd_fn, _, mapping = spec
        ctx.spec = spec
        ctx.save_for_backward(*arrays)
        out = fwd_fn(dict(zip(program.inputs, arrays)) if mapping else arrays[0])
        if len(program.outputs) > 1:
            return tuple(out[f] for f in program.outputs)
        return out

    @staticmethod
    def backward(ctx, *grads):
        program, _, vjp_fn, mapping = ctx.spec
        arrays = ctx.saved_tensors
        x = dict(zip(program.inputs, arrays)) if mapping else arrays[0]
        g = dict(zip(program.outputs, grads)) if len(program.outputs) > 1 else grads[0]
        with torch.no_grad():
            cot = vjp_fn(x, g)
        if mapping:
            return (None, *(cot[f] for f in program.inputs))
        return None, cot


def differentiable_lowering(
    program: StencilProgram,
    fwd_fn: Callable,
    build: Callable[[StencilProgram], Callable],
    *,
    build_zero: Callable[[StencilProgram], Callable] | None = None,
    placement: Callable | None = None,
) -> Callable:
    """Attaches the derived adjoint to a lowered forward callable as a
    ``torch.autograd.Function``. The primal path is ``fwd_fn`` unchanged;
    the backward is :func:`make_vjp` through the same backend, run under
    ``torch.no_grad()``. ``Function.apply`` takes positional tensors, so a
    ``{field: tensor}`` input goes in flattened in ``program.inputs`` order
    and a multi-output result is rebuilt as ``{field: tensor}`` here; a
    bare tensor in gives a bare tensor out. ``build_zero`` and
    ``placement`` are as in :func:`make_vjp`."""
    vjp_fn = make_vjp(program, build, build_zero=build_zero, placement=placement)

    def fn(x):
        if isinstance(x, Mapping):
            arrays = resolve_field_arrays(program, x)
            out = _Lowered.apply((program, fwd_fn, vjp_fn, True), *arrays)
        else:
            out = _Lowered.apply((program, fwd_fn, vjp_fn, False), x)
        if len(program.outputs) > 1:
            return dict(zip(program.outputs, out))
        return out

    return fn
