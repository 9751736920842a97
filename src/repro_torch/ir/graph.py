"""Stencil program IR: a dataflow DAG of stencil ops with offset analysis.

This is the repo's analogue of SPARTA's MLIR dataflow lowering (§3.2-§3.4)
and StencilFlow's program graphs: a compound stencil is expressed ONCE as a
DAG of :class:`StencilOp` nodes, each declaring the *access offsets* it reads
from its input fields, and everything the hand-written paths used to hard-code
is derived from the graph:

  * **halo / radius** — forward-composed per-dimension margins
    (:meth:`StencilProgram.margins`, :meth:`StencilProgram.halo`); composed
    radii add, which the property tests check.
  * **op / byte accounting** — the paper's §3.1 streaming model
    (:meth:`StencilProgram.spec`): each op is charged once per *distinct
    composed offset* at which an output consumes it (e.g. hdiff's Laplacian
    is consumed at the 5 star offsets, hence "5 Laplacians x 5 MACs" in
    Eq. 5), and ``reads`` is the size of the program's composed access
    footprint on its source fields.
  * **per-field analysis** — every input field's composed access radius and
    footprint size derive separately (:meth:`StencilProgram.field_radii`,
    :meth:`StencilProgram.reads_by_field`) and SUM to the program totals,
    so multi-field programs (velocity + scalar advection, coefficient-field
    diffusion) get per-field halos and per-field wire accounting for free.
  * **multi-OUTPUT programs** — a program may declare
    ``outputs={field: op_name, ...}``: several evolving fields per sweep
    (the coupled-PDE systems real weather timesteps run — shallow-water's
    {u, v, h}). Each output gets its own derived margins / radius
    (:meth:`output_radii`, :meth:`output_footprints`); the program-level
    ``halo``/``radius`` are the elementwise/overall max over outputs, and
    every evolving field exchanges the full chain radius
    (:meth:`exchange_radii`) because the fused sweeps advance all evolving
    slabs together. A single-output program is the strict degenerate case
    (``outputs == {passthrough: ops[-1].name}`` by default — identical
    analysis, identical fingerprint).
  * **temporal blocking** — :meth:`StencilProgram.compose` / :func:`repeat`
    fuse k sequential sweeps into one program (the §1 "pipelining different
    timesteps" insight): the merged DAG drives the analysis (radii add, so
    ``repeat(p, k).radius == k * p.radius``), while :attr:`chain` records the
    per-sweep decomposition the lowerings execute with the boundary-ring
    passthrough applied between sweeps. For multi-output programs each
    output op feeds the MATCHING evolving input of the next sweep (outputs
    bind by field name). HBM / wire traffic per *simulated* step then
    divides by k (:meth:`fused_bytes_per_step`).
  * **structural identity** — :meth:`StencilProgram.fingerprint` is a
    canonical SHA-256 over the graph structure (inputs, outputs, per-op
    reads/offsets/costs and the combinator :attr:`StencilOp.tag`), stable
    across processes/sessions — the compile-cache key the serving path
    needs. ``__eq__``/``__hash__`` delegate to it.

This module is the PyTorch port's own copy of ``repro/ir/graph.py`` (which
imports no JAX): the port imports nothing of ``repro``. The copy differs
only in :attr:`StencilOp.emit`, the CUDA C++ expression emitter the
generated fused kernel (:mod:`repro_torch.ir.codegen_cuda`) is built from;
like ``compute`` it is excluded from ``tag`` and :meth:`fingerprint`, so a
program's fingerprint here equals the JAX package's. Nothing under
``repro_torch.ir`` imports other ``repro_torch`` modules at import time, so
``repro_torch.core`` / ``repro_torch.kernels`` derive their constants from
the IR without import cycles. The lowerings live in the sibling
``lower_*`` modules.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Mapping, Sequence

Offset = tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Per-evaluation cost of one op, in the paper's Eq. 5-7 accounting.

    ``macs`` counts multiply-accumulates (one per stencil tap, the Eq. 5
    convention); ``other_ops`` counts non-MAC vector ops (add/sub/cmp/select).
    Costs are attached by the combinator builders in :mod:`repro_torch.ir.ops` —
    they are properties of the *combinator*, never of a particular program.
    """

    macs: int = 0
    other_ops: int = 0

    @property
    def flops(self) -> int:
        return 2 * self.macs + self.other_ops


@dataclasses.dataclass(frozen=True)
class Read:
    """One access: ``field`` sampled at relative grid ``offset``."""

    field: str
    offset: Offset


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """One node of the DAG: produces field ``name`` from its reads.

    ``compute`` is an elementwise combinator: it receives one aligned array
    per entry of ``reads`` (all the same shape — the op's output region) and
    returns the output array. All spatial structure lives in the offsets, so
    every lowering can evaluate the op by slicing differently-shifted views.

    ``tag`` is a canonical description of the combinator INCLUDING its baked
    numeric parameters (tap weights, scales) — the part of the op's identity
    that lives inside the ``compute`` closure and is invisible to the read
    structure. The :mod:`repro_torch.ir.ops` builders always set it; it feeds
    :meth:`StencilProgram.fingerprint` so two programs differing only in a
    coefficient hash differently.

    ``vjp`` is the op's adjoint rule, kept from the JAX package for the
    adjoint port (ROADMAP M8): called as ``vjp(op, gbar_field, fresh)`` it
    returns ``[(read_field, term)]`` where each ``term`` is a
    :class:`StencilOp` computing that read field's cotangent contribution
    (or a bare field name contributing directly). Like ``compute`` it is
    excluded from the fingerprint: the rule is derived from the combinator
    the ``tag`` already names.

    ``emit`` renders the op as a CUDA C++ float expression: called with one
    C++ expression string per entry of ``reads`` it returns the expression
    for the op's value, with the same association as ``compute`` and every
    constant as an exact float32 literal. ``None`` means the op cannot be
    lowered to the generated CUDA kernel.
    """

    name: str
    reads: tuple[Read, ...]
    compute: Callable[..., object]
    cost: OpCost
    tag: str | None = None
    vjp: Callable[..., object] | None = dataclasses.field(
        default=None, compare=False
    )
    emit: Callable[..., str] | None = dataclasses.field(
        default=None, compare=False
    )

    def fields(self) -> tuple[str, ...]:
        """Distinct fields read, in first-read order."""
        seen: dict[str, None] = {}
        for r in self.reads:
            seen.setdefault(r.field, None)
        return tuple(seen)


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """Graph-derived per-output-point accounting (mirrors core's StencilSpec)."""

    name: str
    macs: int
    other_ops: int
    reads: int
    radius: int
    ndim: int = 2

    @property
    def flops(self) -> int:
        return 2 * self.macs + self.other_ops


class StencilProgram:
    """An ordered DAG of :class:`StencilOp` over named fields.

    ``ops`` must be topologically ordered: each op may read only source
    ``inputs`` or earlier ops' outputs.

    ``outputs`` maps each EVOLVING input field to the op that produces its
    next value — the coupled-system schema (shallow-water updates
    ``{u: "u_new", v: "v_new", h: "h_new"}`` in one sweep). When omitted the
    program is single-output: the :attr:`passthrough` field evolves into the
    last op, exactly the pre-multi-output convention. Every lowering carries
    each evolving field's boundary ring through unchanged (the paper
    computes interior points only) on the UNIFORM square radius-``r`` ring,
    ``r = self.radius`` — one shared ring keeps all evolving slabs on one
    aligned grid through the chain's sweeps.

    ``passthrough`` names the primary evolving field (must be one of the
    ``outputs`` keys); it defaults to the first declared input that evolves.
    Single-output code paths keep reading :attr:`passthrough` /
    :attr:`output` and see exactly the old behaviour.
    """

    def __init__(
        self,
        name: str,
        inputs: Sequence[str],
        ops: Sequence[StencilOp],
        *,
        ndim: int = 2,
        passthrough: str | None = None,
        outputs: Mapping[str, str] | None = None,
    ):
        if not ops:
            raise ValueError("program needs at least one op")
        self.name = name
        self.inputs = tuple(inputs)
        self.ops = tuple(ops)
        self.ndim = ndim

        known = set(self.inputs)
        op_names = set()
        for op in self.ops:
            if op.name in self.inputs:
                # The silently-renamed-DAG hazard: an op named like a source
                # field would shadow it for every later reader (and compose's
                # rename map would pick up the wrong identity). Name BOTH
                # colliding identities so the fix is obvious.
                raise ValueError(
                    f"op {op.name!r} collides with source input {op.name!r}: "
                    f"op names and input field names share one namespace — "
                    f"rename the op (program {name!r}, inputs {self.inputs})"
                )
            if op.name in op_names:
                raise ValueError(f"duplicate field name {op.name!r}")
            for read in op.reads:
                if read.field not in known:
                    raise ValueError(
                        f"op {op.name!r} reads {read.field!r} before it is defined"
                    )
                if len(read.offset) != ndim:
                    raise ValueError(
                        f"op {op.name!r} offset {read.offset} is not {ndim}-D"
                    )
            known.add(op.name)
            op_names.add(op.name)

        if outputs is None:
            self.passthrough = (
                passthrough if passthrough is not None else self.inputs[0]
            )
            if self.passthrough not in self.inputs:
                raise ValueError(
                    f"passthrough {self.passthrough!r} is not a program input"
                )
            self.outputs: dict[str, str] = {self.passthrough: self.ops[-1].name}
        else:
            if not outputs:
                raise ValueError("outputs mapping must not be empty")
            cleaned: dict[str, str] = {}
            for f in self.inputs:  # canonical order: declared input order
                if f in outputs:
                    cleaned[f] = outputs[f]
            unknown = [f for f in outputs if f not in self.inputs]
            if unknown:
                raise ValueError(
                    f"outputs key(s) {unknown} are not program inputs "
                    f"(inputs: {self.inputs}); each output evolves one input field"
                )
            for f, op_name in cleaned.items():
                if op_name not in op_names:
                    raise ValueError(
                        f"outputs[{f!r}] = {op_name!r} names no op of program "
                        f"{name!r} (ops: {[op.name for op in self.ops]})"
                    )
            vals = list(cleaned.values())
            if len(set(vals)) != len(vals):
                raise ValueError(
                    f"outputs {dict(outputs)} map two evolving fields to one "
                    f"op; each output field needs its own producing op"
                )
            self.outputs = cleaned
            self.passthrough = (
                passthrough if passthrough is not None else next(iter(cleaned))
            )
            if self.passthrough not in self.outputs:
                raise ValueError(
                    f"passthrough {self.passthrough!r} must be one of the "
                    f"evolving output fields {tuple(self.outputs)}"
                )

    @property
    def output(self) -> str:
        """The op producing the :attr:`passthrough` field's next value (the
        sole output op for single-output programs — the legacy accessor)."""
        return self.outputs[self.passthrough]

    # -- analysis: composed footprints (reverse) ------------------------------

    def _footprints_from(self, seeds) -> dict[str, frozenset[Offset]]:
        fp: dict[str, set[Offset]] = {f: set() for f in self.inputs}
        fp.update({op.name: set() for op in self.ops})
        for s in seeds:
            fp[s].add((0,) * self.ndim)
        for op in reversed(self.ops):
            at = fp[op.name]
            for read in op.reads:
                fp[read.field].update(
                    tuple(a + b for a, b in zip(o, read.offset)) for o in at
                )
        return {f: frozenset(s) for f, s in fp.items()}

    def footprints(self) -> dict[str, frozenset[Offset]]:
        """For every field, the set of composed offsets (relative to one
        output point) at which ANY output depends on it. Composition is the
        Minkowski sum of per-op offset sets along each consumer path, unioned
        over paths (and over the program's outputs) — StencilFlow's
        access-footprint inference."""
        return self._footprints_from(set(self.outputs.values()))

    def output_footprints(self, field: str) -> dict[str, frozenset[Offset]]:
        """:meth:`footprints` seeded from ONE output field's producing op:
        what that output alone reads, at which composed offsets."""
        if field not in self.outputs:
            raise ValueError(
                f"{field!r} is not an output of program {self.name!r} "
                f"(outputs: {tuple(self.outputs)})"
            )
        return self._footprints_from({self.outputs[field]})

    def evaluations(self) -> dict[str, int]:
        """Streaming-model evaluation count per op: one evaluation per
        distinct composed offset the outputs consume it at (§3.1)."""
        fp = self.footprints()
        return {op.name: len(fp[op.name]) for op in self.ops}

    # -- analysis: materialisation margins (forward) --------------------------

    def margins(self) -> dict[str, tuple[Offset, Offset]]:
        """Per-field ``(lo, hi)`` margins: how far the field's valid region
        is inset from the source grid on the low/high side of each dim when
        every field is materialised on its maximal valid region."""
        m: dict[str, tuple[Offset, Offset]] = {
            f: ((0,) * self.ndim, (0,) * self.ndim) for f in self.inputs
        }
        for op in self.ops:
            lo = [0] * self.ndim
            hi = [0] * self.ndim
            for read in op.reads:
                in_lo, in_hi = m[read.field]
                for d in range(self.ndim):
                    lo[d] = max(lo[d], in_lo[d] + max(0, -read.offset[d]))
                    hi[d] = max(hi[d], in_hi[d] + max(0, read.offset[d]))
            m[op.name] = (tuple(lo), tuple(hi))
        return m

    def halo(self) -> tuple[Offset, Offset]:
        """The program's ``(lo, hi)`` boundary margins: the inferred halo —
        the elementwise max over the output ops' margins (a single-output
        program reduces to its sole output's margins exactly)."""
        m = self.margins()
        per_out = [m[op_name] for op_name in self.outputs.values()]
        lo = tuple(max(p[0][d] for p in per_out) for d in range(self.ndim))
        hi = tuple(max(p[1][d] for p in per_out) for d in range(self.ndim))
        return lo, hi

    def output_margins(self, field: str) -> tuple[Offset, Offset]:
        """One output field's own ``(lo, hi)`` margins (its producing op's
        valid-region inset) — what :func:`~repro_torch.ir.evaluate.ring_crop`
        aligns per output."""
        if field not in self.outputs:
            raise ValueError(
                f"{field!r} is not an output of program {self.name!r} "
                f"(outputs: {tuple(self.outputs)})"
            )
        return self.margins()[self.outputs[field]]

    @property
    def radius(self) -> int:
        lo, hi = self.halo()
        return max(max(lo, default=0), max(hi, default=0))

    def output_radii(self) -> dict[str, int]:
        """Per-OUTPUT derived radius: each evolving field's own producing-op
        margin radius. ``max(output_radii().values()) == radius``; under
        ``repeat(p, k)`` each output's radius scales as ``k * r_out``
        (property-tested). The §3.1 accounting per coupled equation."""
        m = self.margins()
        out = {}
        for f, op_name in self.outputs.items():
            lo, hi = m[op_name]
            out[f] = max(max(lo, default=0), max(hi, default=0))
        return out

    # -- analysis: per-field access radii / reads -----------------------------

    def field_radii(self) -> dict[str, int]:
        """Per-input composed access radius: the max |component| over the
        field's composed footprint (0 for an input no output ever reads).

        This is what sizes each field's halo independently: a coefficient
        field read only at offset zero needs NO halo exchange even when the
        state field's radius is 2, and under ``repeat(p, k)`` the per-field
        radii compose separately (the state grows by r per sweep; a
        zero-offset auxiliary grows by r per *earlier* sweep, i.e. to
        ``(k-1) * r``). ``max(field_radii().values()) == radius`` — the
        program radius is the widest field's reach.
        """
        fp = self.footprints()
        return {
            f: max((max(abs(c) for c in o) for o in fp[f]), default=0)
            for f in self.inputs
        }

    def field_radius(self, field: str) -> int:
        if field not in self.inputs:
            raise ValueError(
                f"{field!r} is not an input of program {self.name!r} "
                f"(inputs: {self.inputs})"
            )
        return self.field_radii()[field]

    def exchange_radii(self) -> dict[str, int]:
        """Per-field EXCHANGED halo depth — the ONE home of the rule every
        lowering and wire model shares: every EVOLVING (``outputs``) field
        moves the program's full chain radius (its ring rows must carry true
        passthrough values, and all evolving slabs advance together through
        the chain's sweeps on one aligned grid), every other input only its
        own composed access radius (0 means no exchange at all). The merged
        multi-output wire model — ``program_halo_exchange_bytes`` — is the
        sum over these values."""
        radii = self.field_radii()
        for f in self.outputs:
            radii[f] = self.radius
        return radii

    def reads_by_field(self) -> dict[str, int]:
        """Per-input composed footprint size — the §3.1 ``reads`` term,
        split per field. ``sum(reads_by_field().values()) == spec().reads``
        (the property tests pin this): multi-field op/byte accounting is
        the per-field sum, and a single-input program degenerates to the
        scalar accounting exactly."""
        fp = self.footprints()
        return {f: len(fp[f]) for f in self.inputs}

    # -- temporal composition -------------------------------------------------

    @property
    def chain(self) -> tuple["StencilProgram", ...]:
        """The sequential-sweep decomposition of this program.

        A directly-constructed program is its own 1-chain. A program built by
        :meth:`compose` / :func:`repeat` chains the single-sweep programs that
        are applied in order, with the boundary-ring passthrough applied
        *between* sweeps (the convention of every full-shape lowering). The
        merged DAG this object holds is the analysis view — exact on points
        at least :attr:`radius` from the boundary; near the boundary the
        lowerings follow the chain, not the DAG.
        """
        return getattr(self, "_chain", (self,))

    @property
    def steps(self) -> int:
        """Number of simulated timesteps one application performs."""
        return len(self.chain)

    def compose(self, other: "StencilProgram", *, name: str | None = None) -> "StencilProgram":
        """Sequential composition: apply ``self``, then feed its outputs to
        ``other``'s *evolving* fields (same ndim).

        The evolving fields are ``other``'s :attr:`outputs` keys — the state
        the sweep updates. Every other input of ``other`` is a SHARED field
        (a coefficient, a velocity): it must also be an input of ``self``
        and is read from the same source array in both sweeps.

        Output-to-input binding: when both programs are single-output the
        classic positional rule applies (the sole output feeds the sole
        evolving input; names may differ — ``hdiff`` composes with
        ``vadvc``-shaped sweeps). When either side is multi-output the
        outputs bind BY FIELD NAME — ``other`` must evolve exactly the same
        field set, and each field's producing op in ``self`` feeds the
        matching evolving input of ``other`` (shallow-water's u update reads
        the PREVIOUS sweep's u, v reads v, h reads h).

        The returned program's DAG inlines ``other`` after ``self`` with
        the evolving inputs bound to ``self``'s output ops (op fields
        renamed to stay unique), so offsets compose by Minkowski sum and the
        inferred radii ADD — per field AND per output (see
        :meth:`field_radii` / :meth:`output_radii`). Its :attr:`chain`
        concatenates both chains — the lowerings use it to apply the
        per-sweep boundary passthrough to the evolving fields only.
        """
        if self.ndim != other.ndim:
            raise ValueError(f"ndim mismatch: {self.ndim} vs {other.ndim}")
        shared = [f for f in other.inputs if f not in other.outputs]
        missing = [f for f in shared if f not in self.inputs]
        if missing:
            raise ValueError(
                f"compose: {other.name!r} reads shared field(s) {missing} that "
                f"are not inputs of {self.name!r} (inputs: {self.inputs}); "
                "shared (non-evolving) fields must be common source inputs"
            )
        shadowed = [f for f in shared if f in self.outputs]
        if shadowed:
            # The slab lowerings overwrite the evolving fields in place
            # sweep-to-sweep, so a later sweep cannot also read their ORIGINAL
            # (pre-sweep) values as shared inputs — reject rather than let
            # backends disagree (the full-shape reference could thread it,
            # the slab and fused-kernel paths cannot).
            raise ValueError(
                f"compose: {other.name!r} reads the evolving field(s) "
                f"{shadowed} as shared (non-evolving) input(s); a "
                "downstream sweep only sees the UPDATED state, never the "
                "original field — restructure the program so the original "
                "values flow through a distinct source input"
            )
        if len(self.outputs) == 1 and len(other.outputs) == 1:
            # Classic positional rule: sole output feeds sole evolving input.
            pairs = [(self.passthrough, next(iter(other.outputs)))]
        else:
            if set(other.outputs) != set(self.outputs):
                raise ValueError(
                    f"compose: multi-output programs bind outputs by FIELD "
                    f"NAME, but {self.name!r} evolves {sorted(self.outputs)} "
                    f"while {other.name!r} evolves {sorted(other.outputs)}; "
                    "each sweep must update the same evolving field set"
                )
            pairs = [(f, f) for f in self.outputs]
        taken = {*self.inputs, *(op.name for op in self.ops)}
        tag = self.steps
        while any(f"{op.name}@{tag}" in taken for op in other.ops):
            tag += 1
        rename = {f_other: self.outputs[f_self] for f_self, f_other in pairs}
        rename.update({op.name: f"{op.name}@{tag}" for op in other.ops})
        appended = tuple(
            StencilOp(
                name=rename[op.name],
                reads=tuple(Read(rename.get(r.field, r.field), r.offset) for r in op.reads),
                compute=op.compute,
                cost=op.cost,
                tag=op.tag,
                vjp=op.vjp,
                emit=op.emit,
            )
            for op in other.ops
        )
        merged_outputs = {
            f_self: rename[other.outputs[f_other]] for f_self, f_other in pairs
        }
        prog = StencilProgram(
            name if name is not None else f"{self.name}>>{other.name}",
            self.inputs,
            self.ops + appended,
            ndim=self.ndim,
            passthrough=self.passthrough,
            outputs=merged_outputs,
        )
        prog._chain = self.chain + other.chain
        return prog

    # -- structural identity --------------------------------------------------

    def fingerprint(self) -> str:
        """Canonical structural SHA-256 of the program, stable across
        sessions — the compile-cache key groundwork (ROADMAP).

        Covers ndim, input order, the outputs binding, passthrough, and
        every op's (name, combinator :attr:`~StencilOp.tag`, reads with
        offsets, cost), plus the per-sweep chain fingerprints for composed
        programs (two programs with one merged DAG but different sweep
        decompositions evaluate differently near the boundary, so they must
        hash differently). The display ``name`` is cosmetic and excluded.
        No Python ``hash()``/``id()`` anywhere, so the digest is
        reproducible across processes and sessions.

        Ops built outside :mod:`repro_torch.ir.ops` may carry ``tag=None``; their
        numeric closure parameters are then invisible to the hash (structure
        only) — set :attr:`StencilOp.tag` to restore full identity.
        """
        cached = getattr(self, "_fingerprint", None)
        if cached is not None:
            return cached
        payload = {
            "ndim": self.ndim,
            "inputs": list(self.inputs),
            "outputs": [[f, self.outputs[f]] for f in self.outputs],
            "passthrough": self.passthrough,
            "ops": [
                [
                    op.name,
                    op.tag or "",
                    [[r.field, list(r.offset)] for r in op.reads],
                    [op.cost.macs, op.cost.other_ops],
                ]
                for op in self.ops
            ],
        }
        if self.steps > 1:
            payload["chain"] = [p.fingerprint() for p in self.chain]
        digest = hashlib.sha256(
            json.dumps(payload, separators=(",", ":")).encode()
        ).hexdigest()
        self._fingerprint = digest
        return digest

    def __eq__(self, other) -> bool:
        if not isinstance(other, StencilProgram):
            return NotImplemented
        return self.fingerprint() == other.fingerprint()

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return int(self.fingerprint()[:16], 16)

    # -- derived accounting ---------------------------------------------------

    def spec(self) -> ProgramSpec:
        """Per-output-point op/byte accounting, fully derived from the graph
        (replaces the hand-written ``StencilSpec`` constants). Multi-output
        programs charge each op once per distinct composed offset ANY output
        consumes it at, and ``reads`` sums the per-field footprints."""
        fp = self.footprints()
        evals = self.evaluations()
        return ProgramSpec(
            name=self.name,
            macs=sum(evals[op.name] * op.cost.macs for op in self.ops),
            other_ops=sum(evals[op.name] * op.cost.other_ops for op in self.ops),
            reads=sum(len(fp[f]) for f in self.inputs),
            radius=self.radius,
            ndim=self.ndim,
        )

    def staged_bytes(self, points: int, itemsize: int = 4) -> int:
        """HBM traffic when every op materialises to memory (Eq. 8-9
        analogue): each op reads one element per declared access and writes
        its output once, per grid point."""
        return sum((len(op.reads) + 1) * points * itemsize for op in self.ops)

    def fused_bytes(self, points: int, itemsize: int = 4) -> int:
        """Compulsory traffic under fusion: each source in once, each output
        once (the on-chip-residency / B-block broadcast analogue). For a
        composed program this is the traffic of one fused k-sweep
        application."""
        return (len(self.inputs) + len(self.outputs)) * points * itemsize

    def fused_bytes_per_step(self, points: int, itemsize: int = 4) -> float:
        """Compulsory HBM traffic per *simulated* timestep under the fused
        k-sweep lowering — :meth:`fused_bytes` amortised over the chain, the
        ~k-fold cut temporal blocking buys."""
        return self.fused_bytes(points, itemsize) / self.steps

    def __repr__(self) -> str:
        outs = (
            f"outputs={self.outputs}"
            if len(self.outputs) > 1
            else f"ops={[op.name for op in self.ops]}"
        )
        return (
            f"StencilProgram({self.name!r}, inputs={self.inputs}, "
            f"{outs}, radius={self.radius}, "
            f"steps={self.steps})"
        )


def repeat(program: StencilProgram, k: int) -> StencilProgram:
    """``k`` fused sequential sweeps of ``program`` (temporal blocking).

    ``repeat(p, k)`` composes ``p`` with itself ``k`` times: the merged DAG
    gives the analysis (``repeat(p, k).radius == k * p.radius``) and the
    chain gives the lowerings their per-sweep structure — one HBM / wire
    round-trip then serves ``k`` simulated timesteps. ``k == 1`` returns
    ``program`` unchanged.

    Multi-field programs repeat too: the :attr:`StencilProgram.outputs`
    fields evolve sweep-to-sweep (each output op feeding the matching
    evolving input of the next sweep, by name) while the remaining inputs
    (coefficients, velocities) are shared across sweeps, so e.g. a
    zero-offset coefficient field's composed radius grows to ``(k-1) *
    p.radius`` (read through ``k-1`` downstream sweeps) while each evolving
    field's grows to ``k * p.radius``.
    """
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ValueError(f"k must be a positive int, got {k!r}")
    out = program
    for i in range(2, k + 1):
        out = out.compose(program, name=f"{program.name}_x{i}")
    return out
