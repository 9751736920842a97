"""K2 and K5', the generated fused CUDA kernels: their plain versions (the
CPU path of ``lower_cuda``) against the JAX ``lower_pallas`` in interpret
mode, text-level checks of the generated CUDA source, which need no nvcc,
and K5''s generated sweeps run over numpy float32 arrays by the kernel's
own spans, frames and stores (:func:`_emulate_1d`) against the plain
version, bit for bit.

Tolerance ``TOL`` (1e-6, rtol and atol) per output field.
"""

import hashlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ir as jir
import repro_torch.ir as tir
from conformance import GRID, KS, PROGRAMS, SEED, TOL, assert_close, make_fields, to_host
from repro_torch.interop import fields_from_numpy, to_numpy
from repro_torch.ir.codegen_cuda import frame_plan, kernel_name, render
from repro_torch.ir.lower_cuda import kernel_source, tile_for
from repro_torch.ir.ops import f32_literal
from repro_torch.ir.plan import (PROGRAM_TILES, SMEM_BLOCK_LIMIT, SMEM_SM,
                                 program_tile_bytes)
from test_torch_ir_graph import TORCH_PROGRAMS

ELEMENTARY_2D = ["jacobi2d_3pt", "laplacian", "jacobi2d_5pt", "jacobi2d_9pt", "seidel2d"]
CASES = [("hdiff", 1), ("hdiff", 2), ("hdiff", 3), ("hdiff_coupled", 1),
         ("hdiff_coupled", 2), ("vadvc", 1), ("vadvc", 2), ("shallow_water", 1),
         ("shallow_water", 2), ("advection_diffusion", 1), ("advection_diffusion", 2)]
CASES += [(name, k) for name in ELEMENTARY_2D for k in (1, 2, 3)]


def _port(name, k):
    return tir.repeat(TORCH_PROGRAMS[name](), k)


@pytest.mark.parametrize("name,k", CASES)
def test_plain_path_matches_pallas(name, k):
    x = to_host(make_fields(name))
    want = to_host(jir.lower_pallas(jir.repeat(PROGRAMS[name](), k), interpret=True)(
        make_fields(name)))
    prog = _port(name, k)
    got = to_numpy(tir.lower_cuda(prog)(fields_from_numpy(prog, x, device="cpu")))
    assert_close(got, want, err_msg=f"{name}/k={k}")


def test_plain_path_bf16_matches_pallas():
    """Both sides run every sweep in float32 and round to bfloat16 once."""
    x = to_host(make_fields("hdiff"))
    want = jir.lower_pallas(jir.repeat(jir.hdiff_program(), 2), interpret=True)(
        jnp.asarray(x).astype(jnp.bfloat16))
    prog = _port("hdiff", 2)
    got = tir.lower_cuda(prog)(torch.tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=TOL, atol=TOL,
    )


def test_plain_path_equals_apply_program_on_float32():
    prog = _port("advection_diffusion", 3)
    x = fields_from_numpy(prog, to_host(make_fields("advection_diffusion")), device="cpu")
    fused = tir.lower_cuda(prog)(x)
    eager = tir.apply_program(prog, x)
    for f in fused:
        torch.testing.assert_close(fused[f], eager[f], rtol=0, atol=0)


def test_block_rows_validation_matches_lower_pallas():
    prog = _port("hdiff", 2)
    x = torch.zeros(GRID)
    with pytest.raises(ValueError, match="not divisible"):
        tir.lower_cuda(prog, block_rows=7)(x)
    with pytest.raises(ValueError, match="halo"):
        tir.lower_cuda(prog, block_rows=2)(x)


def _rows(n, seed=SEED):
    return np.random.default_rng(seed).standard_normal((4, n)).astype(np.float32)


@pytest.mark.parametrize("n", [8, 33, 256])
@pytest.mark.parametrize("k", KS)
def test_one_dimensional_programs_match_pallas(k, n):
    """K5''s plain path against ``lower_pallas``'s 1-D kernel: k sweeps of
    jacobi1d in one call."""
    x = _rows(n)
    want = jir.lower_pallas(jir.repeat(jir.jacobi1d_program(), k), interpret=True)(
        jnp.asarray(x))
    got = tir.lower_cuda(tir.repeat(tir.jacobi1d_program(), k))(torch.from_numpy(x))
    assert_close(to_numpy(got), to_host(want), err_msg=f"jacobi1d/k={k}/n={n}")


def test_one_dimensional_k_sweeps_equal_k_single_sweeps():
    """The port's promise for K5': one call of ``repeat(p, k)`` equals k
    calls of ``p``, bit for bit in float32."""
    x = torch.from_numpy(_rows(37, seed=3))
    one = tir.lower_cuda(tir.jacobi1d_program())
    want = one(one(one(x)))
    got = tir.lower_cuda(tir.repeat(tir.jacobi1d_program(), 3))(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_one_dimensional_bf16_matches_pallas():
    """Both sides run the sweeps in float32 and round to bfloat16 once."""
    x = _rows(40, seed=4)
    want = jir.lower_pallas(jir.repeat(jir.jacobi1d_program(), 2), interpret=True)(
        jnp.asarray(x).astype(jnp.bfloat16))
    got = tir.lower_cuda(tir.repeat(tir.jacobi1d_program(), 2))(
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _jax_hdiff1d():
    import repro.ir.ops as jops

    ops = [
        jops.affine("lap", "psi", {(0,): 2.0, (1,): -1.0, (-1,): -1.0}),
        jops.flux("flx", "lap", lo=(0,), hi=(1,), limiter="psi"),
        jops.flux("flx_m", "lap", lo=(-1,), hi=(0,), limiter="psi"),
        jops.scaled_residual("out", "psi", [("flx", 1), ("flx_m", -1)], 0.025, ndim=1),
    ]
    return jir.StencilProgram("hdiff1d", ["psi"], ops, ndim=1)


def _jax_smooth1d():
    import repro.ir.ops as jops

    ops = [
        jops.affine("blur", "x", {(-1,): 0.25, (0,): 0.5, (1,): 0.25}),
        jops.affine("out", "blur", {(-1,): -0.125, (0,): 1.25, (1,): -0.125}),
    ]
    return jir.StencilProgram("smooth1d", ["x"], ops, ndim=1)


# The 1-D chains beside jacobi1d: (JAX program, port program). The JAX
# package has no such programs; its combinators build the same DAGs.
CHAINS_1D = {"hdiff1d": (_jax_hdiff1d, tir.hdiff1d_program),
             "smooth1d": (_jax_smooth1d, tir.smooth1d_program)}


@pytest.mark.parametrize("name", sorted(CHAINS_1D))
def test_one_dimensional_chains_are_the_jax_combinators_dags(name):
    jax_prog, port_prog = (make() for make in CHAINS_1D[name])
    assert port_prog.fingerprint() == jax_prog.fingerprint()
    assert port_prog.radius == jax_prog.radius == 2
    assert port_prog.margins() == jax_prog.margins()
    # The intermediate is read at non-zero offsets: no kernel can compute
    # it at its reader's point alone.
    first = port_prog.ops[0].name
    assert any(r.field == first and r.offset != (0,) for op in port_prog.ops for r in op.reads)


@pytest.mark.parametrize("n", [1, 5, 37, 256])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(CHAINS_1D))
def test_one_dimensional_chains_match_pallas(name, k, n):
    """K5''s plain path on the two chains whose intermediates are read at
    non-zero offsets, against ``lower_pallas``'s 1-D kernel one sweep at a
    time and against the JAX package's oracle, ``lower_reference`` of the
    k-sweep program. (``lower_pallas`` of the k-sweep program itself runs
    its sweeps' row updates as scatters, which Pallas interpret mode gets
    wrong on this JAX for some of these cells: ROADMAP Queue 3.) A row too
    short for the ops' margins (n = 1) raises the same error in both
    packages, and so does the CUDA path's planner (``tile_for``)."""
    x = _rows(n, seed=5)
    jax_make, port_make = CHAINS_1D[name]
    port_prog = tir.repeat(port_make(), k)
    one = jir.lower_pallas(jax_make(), interpret=True)
    try:
        want = jnp.asarray(x)
        for _ in range(k):
            want = one(want)
    except ValueError as e:
        for fn in (lambda: tir.lower_cuda(port_prog)(torch.from_numpy(x)),
                   lambda: tile_for(port_prog, 1, n)):
            with pytest.raises(ValueError) as got:
                fn()
            assert str(got.value) == str(e)
        return
    got = to_numpy(tir.lower_cuda(port_prog)(torch.from_numpy(x)))
    assert_close(got, to_host(want), err_msg=f"{name}/k={k}/n={n}")
    oracle = jir.lower_reference(jir.repeat(jax_make(), k))(jnp.asarray(x))
    assert_close(got, to_host(oracle), err_msg=f"{name}/k={k}/n={n} vs lower_reference")


@pytest.mark.parametrize("name", sorted(CHAINS_1D))
def test_one_dimensional_chains_k_sweeps_equal_k_single_sweeps(name):
    x = torch.from_numpy(_rows(37, seed=6))
    prog = CHAINS_1D[name][1]()
    one = tir.lower_cuda(prog)
    np.testing.assert_array_equal(tir.lower_cuda(tir.repeat(prog, 3))(x).numpy(),
                                  one(one(one(x))).numpy())


@pytest.mark.parametrize("name", sorted(CHAINS_1D))
def test_one_dimensional_chains_bf16_match_pallas(name):
    """Both sides run the sweep in float32 and round to bfloat16 once."""
    x = _rows(40, seed=7)
    jax_make, port_make = CHAINS_1D[name]
    want = jir.lower_pallas(jax_make(), interpret=True)(jnp.asarray(x).astype(jnp.bfloat16))
    got = tir.lower_cuda(port_make())(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=TOL, atol=TOL)


def _two_input_1d(ir, ops):
    return ir.StencilProgram("pair1d", ["x", "w"], [ops.product("out", "x", "w", ndim=1)],
                             ndim=1, passthrough="x")


def test_one_dimensional_errors_match_lower_pallas():
    import repro.ir.ops as jops
    import repro_torch.ir.ops as tops

    with pytest.raises(ValueError, match="single-input"):
        jir.lower_pallas(_two_input_1d(jir, jops), interpret=True)
    with pytest.raises(ValueError, match="single-input"):
        tir.lower_cuda(_two_input_1d(tir, tops))
    x = _rows(8)[None]
    with pytest.raises(ValueError, match=r"expected \(batch, n\)"):
        jir.lower_pallas(jir.jacobi1d_program(), interpret=True)(jnp.asarray(x))
    with pytest.raises(ValueError, match=r"expected \(batch, n\)"):
        tir.lower_cuda(tir.jacobi1d_program())(torch.from_numpy(x))


# -- the generated source ------------------------------------------------------


def _source(prog, dtype="float32", grid=GRID):
    return kernel_source(prog, (dtype,) * len(prog.inputs), tile_for(prog, *grid[1:]))


def test_source_is_deterministic_and_keyed_by_fingerprint():
    a = _source(_port("hdiff", 2))
    assert a == _source(_port("hdiff", 2))
    renamed = tir.StencilProgram("other_name", ["psi"], tir.hdiff_program().ops)
    assert _source(renamed) == _source(tir.hdiff_program())
    assert renamed.fingerprint() == tir.hdiff_program().fingerprint()
    other = _source(tir.hdiff_program(0.05))
    assert other[0] != a[0] and other[1] != a[1]
    assert a[0] == kernel_name(_port("hdiff", 2))
    assert _port("hdiff", 2).fingerprint() in a[1]
    assert _source(_port("hdiff", 2), "bfloat16")[1] != a[1]


@pytest.mark.parametrize("name", ["hdiff", "vadvc", "shallow_water", "advection_diffusion"])
def test_one_store_per_output(name):
    prog = _port(name, 2)
    src = _source(prog)[1]
    stores = re.findall(r"^\s*O(\d+)\[g\] = from_f32<\w+>\(n\d+\);", src, re.M)
    assert sorted(int(s) for s in stores) == list(range(len(prog.outputs)))
    assert len(re.findall(r"\bO\d+\[", src)) == len(prog.outputs)


def test_coefficients_are_exact_float32_literals():
    src = _source(_port("hdiff", 1))[1]
    lits = {int(h, 16) for h in re.findall(r"__int_as_float\(0x([0-9a-f]{8})\)", src)}
    want = {np.array(v, np.float32).view(np.uint32).item() for v in (4.0, -1.0, 0.025)}
    assert lits == want
    code = re.sub(r"//[^\n]*", "", src)  # op tags in comments spell the decimals
    assert not re.search(r"\b0\.025", code)
    ninth = re.sub(r"//[^\n]*", "", _source(tir.jacobi2d_9pt_program())[1])
    assert f32_literal(1.0 / 9.0) in ninth and "0.111" not in ninth
    assert f32_literal(1.0 / 9.0) == "__int_as_float(0x3de38e39)"


def test_frames_are_reused_across_ops_and_sweeps():
    """hdiff keeps its input and the Laplacian in frames; the four fluxes
    are inlined into the update, whose last sweep stores from registers. A
    chain of sweeps adds one state frame (the two take turns) and reuses
    the Laplacian's frame in every sweep. Barriers: one after the loads,
    then one after each Laplacian and each update but the last."""
    assert frame_plan(tir.hdiff_program()).n_frames == 2
    assert frame_plan(_port("hdiff", 2)).n_frames == 3
    assert frame_plan(_port("hdiff", 3)).n_frames == 3
    for k, barriers in ((1, 2), (2, 4), (3, 6)):
        assert _source(_port("hdiff", k))[1].count("__syncthreads()") == barriers
    sw = frame_plan(_port("shallow_water", 2))
    assert sw.input_frames == {"u": 0, "v": 1, "h": 2}
    assert all(len(s.updates) == 3 for s in sw.sweeps)
    assert [new for *_, new in sw.sweeps[0].updates] == [3, 4, 5]
    assert [new for *_, new in sw.sweeps[1].updates] == [None] * 3


CONFORMANCE_2D = [(name, k) for name in sorted(TORCH_PROGRAMS) if name != "jacobi1d"
                  for k in KS]


def _expected_inlined(sweep):
    """Ops that exactly one later op reads, only at offset zero, and that
    produce no evolving field's next value."""
    readers = {op.name: [] for op in sweep.ops}
    for op in sweep.ops:
        for r in op.reads:
            if r.field in readers:
                readers[r.field].append((op.name, r.offset))
    return tuple(
        name for name, rs in readers.items()
        if name not in sweep.outputs.values() and len({n for n, _ in rs}) == 1
        and all(o == (0, 0) for _, o in rs)
    )


@pytest.mark.parametrize("name,k", CONFORMANCE_2D)
def test_frame_plan_inlines_single_zero_offset_readers_only(name, k):
    prog = _port(name, k)
    plan = frame_plan(prog)
    assert len(plan.sweeps) == k
    for sweep in plan.sweeps:
        p = sweep.program
        assert sweep.inlined == _expected_inlined(p)
        for op in p.ops:
            reads = [(o.name, r.offset) for o in p.ops for r in o.reads if r.field == op.name]
            if any(off != (0, 0) for _, off in reads) or len({n for n, _ in reads}) > 1:
                assert op.name not in sweep.inlined
            if op.name in sweep.inlined:
                assert op.name not in sweep.env and op.name not in sweep.materialized
    if name == "hdiff":
        assert all(s.inlined == ("flx_r", "flx_rm", "flx_c", "flx_cm") for s in plan.sweeps)
        assert all(s.materialized == ("lap",) for s in plan.sweeps)


@pytest.mark.parametrize("name,k", CONFORMANCE_2D)
def test_source_is_deterministic_and_tile_fits(name, k):
    """Two renders are the same text, and the planned tile is the largest
    of ``PROGRAM_TILES`` whose frames leave room for two blocks per SM on
    the paper grid (64x64 for hdiff x 1-3)."""
    prog = _port(name, k)
    for dtype in ("float32", "bfloat16"):
        assert _source(prog, dtype) == _source(prog, dtype)
    tile = tile_for(prog, 256, 256)
    need = program_tile_bytes(tile.rows, tile.cols, tile.halo, tile.buffers)
    assert tile.buffers == frame_plan(prog).n_frames
    assert need <= SMEM_BLOCK_LIMIT and 2 * (need + 1024) <= SMEM_SM
    larger = PROGRAM_TILES[:PROGRAM_TILES.index((tile.rows, tile.cols))]
    assert all(2 * (program_tile_bytes(tr, tc, tile.halo, tile.buffers) + 1024) > SMEM_SM
               for tr, tc in larger)
    if name == "hdiff":
        assert (tile.rows, tile.cols) == (64, 64)
    assert (f"// tile: {tile.rows}x{tile.cols}  chain halo: {prog.radius}  "
            f"frames: {tile.buffers}") in _source(prog, grid=(1, 256, 256))[1]


def test_radius_zero_field_fetches_no_halo():
    prog = _port("hdiff_coupled", 1)
    src = _source(prog)[1]
    assert "// load 'coeff': halo 0" in src and "// load 'u': halo 2" in src


@pytest.mark.parametrize("name,k", [("hdiff", 2), ("hdiff_coupled", 2), ("shallow_water", 2),
                                    ("advection_diffusion", 3)])
def test_column_slab_ring_equals_full_width_ring(name, k):
    """The generated kernel applies the ring by ABSOLUTE row and column
    index (``slab_sweep``'s column-slab form); over a whole grid, zero-padded
    by the chain radius on every side, that equals the full-width form the
    plain version uses, bit for bit."""
    prog = _port(name, k)
    h = prog.radius
    arrays = tir.resolve_field_arrays(
        prog, fields_from_numpy(prog, to_host(make_fields(name)), device="cpu"))
    _, rows, cols = arrays[0].shape
    padded = {f: torch.nn.functional.pad(a, (h, h, h, h)) for f, a in zip(prog.inputs, arrays)}
    states = {f: padded.pop(f) for f in prog.outputs}
    state = states[prog.passthrough] if len(states) == 1 else states
    slab = tir.slab_sweep(prog, state, -h, rows, -h, cols, extras=padded or None)
    plain = tir.stencil_program_plain(prog, arrays)
    if not isinstance(plain, dict):
        slab, plain = {"": slab}, {"": plain}
    for f in plain:
        torch.testing.assert_close(slab[f], plain[f], rtol=0, atol=0)


# -- the generated 1-D source (K5') ------------------------------------------------


def _source_1d(k, n=256, dtype="float32", make=tir.jacobi1d_program):
    prog = tir.repeat(make(), k)
    return kernel_source(prog, (dtype,), tile_for(prog, 1, n))


def _code(src):
    return re.sub(r"//[^\n]*", "", src)


@pytest.mark.parametrize("k", KS)
def test_1d_source_has_one_store_exact_literals_and_a_k_r_halo(k):
    """One store site, whole 16-byte vectors or words; the coefficient as
    its float32 bit pattern; a chain halo of k * r rounded up to whole
    vectors at each end of a span. One sweep takes a block span (one frame,
    one barrier after the load); a chain of sweeps, warp spans: the
    neighbours by shuffles, no frame and no barrier."""
    name, src = _source_1d(k)
    assert name == kernel_name(tir.repeat(tir.jacobi1d_program(), k))
    assert "stencil_program_1d(" in src and "stencil_program(" not in src
    code = _code(src)
    assert len(re.findall(r"store_vector\(O0, f \+ u \* V, total, aligned & 2", code)) == 1
    assert len(re.findall(r"\bO0\b", code)) == 5  # parameters, alignment, the store site
    assert len(re.findall(r"\*reinterpret_cast<float4\*>\(out \+ g\) =", code)) == 1
    assert len(re.findall(r"\bout\[g \+ e\] =", code)) == 1
    assert f32_literal(1.0 / 3.0) in code and "0.333" not in code
    assert re.search(rf"constexpr int H = {k};", code)
    assert "constexpr int HP = 4;" in code and "constexpr int V = 4;" in code
    if k == 1:
        assert code.count("__syncthreads()") == 1 and "__shfl" not in code
        assert "constexpr int SPANS = 1;" in code and "constexpr int NFRAMES = 1;" in code
    else:
        assert "__syncthreads()" not in code and "__shared__" not in code and "F0" not in code
        assert "constexpr int SPANS = 8;" in code and "constexpr int NFRAMES = 0;" in code
        assert code.count("__shfl_up_sync(0xffffffffu, x[3], 1)") == k
        assert code.count("__shfl_down_sync(0xffffffffu, x[0], 1)") == k
    assert len(re.findall(r"c\[\d\] >= n - 1\)", code)) == 4 * k
    assert len(re.findall(r"__int_as_float\(0x3eaaaaab\) \* \(\(", code)) == 4 * k


def test_1d_source_tiles_long_rows_and_keys_dtype():
    """The span does not depend on the row length; bfloat16 holds 8 points a
    thread, widened as it loads and rounded once, at the store."""
    assert _source_1d(2, n=4_194_307) == _source_1d(2, n=3) == _source_1d(2)
    bf16 = _source_1d(2, dtype="bfloat16")[1]
    assert bf16 != _source_1d(2)[1]
    assert "constexpr int V = 8;" in bf16 and "constexpr int P = 8;" in bf16
    assert "from_f32<__nv_bfloat16>" in bf16 and "__bfloat162float" in bf16


def _jacobi_r300():
    return tir.StencilProgram(
        "far1d", ["x"], [tir.affine("out", "x", {(-300,): 0.5, (0,): 0.25, (300,): 0.25})],
        ndim=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(CHAINS_1D))
def test_1d_chain_sources(name, k, dtype):
    """The chains with intermediates at non-zero offsets: one store site,
    exact literals, a k * r halo, no more barriers than one a sweep (none
    with warp spans, for two sweeps), every intermediate in registers (no
    frame of its own) at exactly the positions its readers need."""
    prog = tir.repeat(CHAINS_1D[name][1](), k)
    src = kernel_source(prog, (dtype,), tile_for(prog, 1, 256))[1]
    code = _code(src)
    assert len(re.findall(r"store_vector\(O0,", code)) == 1
    assert len(re.findall(r"\bO0\b", code)) == 5
    assert len(re.findall(r"\*reinterpret_cast<(float4|uint4)\*>\(out \+ g\) =", code)) == 1
    assert len(re.findall(r"\bout\[g \+ e\] =", code)) == 1
    assert re.search(rf"constexpr int H = {2 * k};", code)
    frames = {1: 1, 2: 0, 3: 2}[k]  # a halo of 4 fits warp spans, one of 6 does not
    assert f"constexpr int NFRAMES = {frames};" in code
    assert code.count("__syncthreads()") == (k if frames else 0)
    lits = {int(h, 16) for h in re.findall(r"__int_as_float\(0x([0-9a-f]{8})\)", code)}
    weights = {"hdiff1d": (2.0, -1.0, 0.025), "smooth1d": (0.25, 0.5, -0.125, 1.25)}[name]
    assert lits == {np.array(w, np.float32).view(np.uint32).item() for w in weights}
    points = 4 if dtype == "float32" else 8
    # The first op (read at -1, 0, +1) at P + 2 positions a sweep, the
    # neighbours two a side.
    assert len(re.findall(r"const float v0_m?\d+ = ", code)) == (points + 2) * k
    assert code.count("const float l2 = ") == k and len(re.findall(r"\br2 = ", code)) == k


def test_1d_deep_chain_takes_wider_spans():
    """A radius-300 op needs more than one vector a thread, so that a span
    stores at least half of what it loads."""
    tile = tile_for(_jacobi_r300(), 1, 1000)
    assert tile.cols == 2 and tile.buffers == 1
    code = _code(kernel_source(_jacobi_r300(), ("float32",), tile)[1])
    assert "constexpr int P = 8;" in code and "constexpr int HP = 300;" in code
    assert "constexpr int PAD = 300;" in code


def _emulate_1d(src, x):
    """Runs K5''s generated source over a float32 numpy ``(batch, n)`` field
    the way the card runs it, on arrays over every thread of every block:
    the source's own span and store formulas, the threads' points in
    registers (zero outside the field), the frames of block spans (their
    pads zeroed) or the shuffles of warp spans (a lane past the warp's edge
    keeps its own value), and each sweep's generated statements evaluated
    in order in float32. Returns the float32 field before the store's
    rounding."""
    const = {"kThreads": 256}
    for name, value in re.findall(r"constexpr int (\w+) = (.*?);", src):
        const[name] = eval(value.replace("/", "//"), dict(const))
    P, V, HP, PAD, S, SPANS = (const[k] for k in ("P", "V", "HP", "PAD", "S", "SPANS"))
    batch, n = x.shape
    total, flat = x.size, x.reshape(-1)
    blocks = -(-(-(-total // (S - 2 * HP))) // SPANS)

    def c_expr(text, **names):  # an int C expression of the source, over numpy arrays
        text = re.sub(r"static_cast<[\w ]+>", "", text).replace("/", "//")
        text = text.replace("threadIdx.x", "tx").replace("blockIdx.x", "bx")
        if "&&" in text:
            text = " & ".join(f"({part})" for part in text.split("&&"))
        return eval(text, {**const, **names})

    tx, bx = np.arange(256)[None, :], np.arange(blocks)[:, None]
    b = c_expr(re.search(r"const int b = (.*?);", src).group(1), tx=tx)
    span = c_expr(re.search(r"const long long span =\s*(.*?);", src, re.S).group(1), tx=tx,
                  bx=bx)
    f = c_expr(re.search(r"const long long f = (.*?);", src).group(1), span=span, b=b)
    pos = f[..., None] + np.arange(P)  # (blocks, threads, P)
    inside = (pos >= 0) & (pos < total)
    xs = np.where(inside, flat[np.clip(pos, 0, total - 1)], np.float32(0))
    env = {"x": [xs[..., j] for j in range(P)], "c": [pos[..., j] % n for j in range(P)],
           "n": n, "np": np, "limit_flux": lambda d, g: np.where(d * g <= 0, d, np.float32(0))}
    frames = {k: np.zeros((blocks, S + 2 * PAD), np.float32) for k in range(const["NFRAMES"])}

    def put(k):
        frames[k][:, PAD:PAD + S] = np.stack(env["x"], axis=-1).reshape(blocks, S)

    def shuffle(value, lanes):  # each lane's value from lane + lanes of its warp
        w = value.reshape(blocks, 8, 32)
        out = w.copy()
        if lanes > 0:
            out[..., :32 - lanes] = w[..., lanes:]
        else:
            out[..., -lanes:] = w[..., :32 + lanes]
        return out.reshape(blocks, 256)

    def expr(text):
        text = re.sub(r"__int_as_float\((0x[0-9a-f]{8})\)",
                      lambda m: f"np.uint32({m.group(1)}).view(np.float32)", text)
        return eval(text, env)

    if frames:
        put(0)
    for line in src[src.index("  {  // sweep 0"):src.index("  // store:")].splitlines():
        line = line.strip()
        if m := re.fullmatch(r"put_frame\(F(\d) \+ b, x\);", line):
            put(int(m.group(1)))
        elif line.startswith("const float ") and "= F" in line:
            for name, k, sign, d in re.findall(r"(\w+) = F(\d)\[b ([-+]) (\d+)\]", line):
                env[name] = frames[int(k)][:, PAD + b[0] + (int(d) if sign == "+" else -int(d))]
        elif m := re.fullmatch(r"const float (\w+) = __shfl_(up|down)_sync\(0xffffffffu, "
                               r"x\[(\d+)\], (\d+)\);", line):
            name, way, i, d = m.groups()
            env[name] = shuffle(env["x"][int(i)], int(d) if way == "down" else -int(d))
        elif m := re.fullmatch(r"const float (\w+) = (.*);", line):
            env[m.group(1)] = expr(m.group(2))
        elif m := re.fullmatch(r"x\[(\d+)\] = (?:\((.*)\) \? (.*) : )?(.*);", line):
            j, cond, keep, new = m.groups()
            value = expr(new)
            if cond:
                c, r, c2, r2 = re.fullmatch(r"c\[(\d+)\] < (\d+) \|\| c\[(\d+)\] >= n - (\d+)",
                                            cond).groups()
                assert c == c2 == j and r == r2 and keep == f"x[{j}]"
                col = env["c"][int(j)]
                value = np.where((col < int(r)) | (col >= n - int(r)), expr(keep), value)
            env["x"] = env["x"][:int(j)] + [np.asarray(value, np.float32)] + env["x"][int(j) + 1:]
        else:
            assert line in ("__syncthreads();", "}") or line.startswith("{  // sweep"), line
    out = np.full(total, np.nan, np.float32)
    ys = np.stack(env["x"], axis=-1)
    cond = re.search(r"if \((b \+ u \* V .*)\) \{\n\s*store_vector", src).group(1)
    stored = np.stack([np.broadcast_to(c_expr(cond, b=b, u=u), tx.shape)
                       for u in range(P // V)], axis=-1)
    keep = np.repeat(stored, V, axis=-1) & inside
    out[pos[keep]] = ys[keep]
    return out.reshape(batch, n)


EMULATED = [("jacobi1d", tir.jacobi1d_program), ("hdiff1d", tir.hdiff1d_program),
            ("smooth1d", tir.smooth1d_program)]


@pytest.mark.parametrize("shape", [(4, 37), (3, 256), (700, 9), (300, 5), (2, 3000),
                                   (1, 2100)])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name,make", EMULATED)
def test_1d_generated_sweeps_equal_plain(name, make, k, shape):
    """K5''s design, held on the CPU: spans that cross rows (many short
    rows, rows shorter than the chain halo, rows longer than a span) store
    exactly what the plain version computes, bit for bit, float32 and the
    bfloat16 path (widened as it loads, rounded once as it stores)."""
    prog = tir.repeat(make(), k)
    x = np.random.default_rng(SEED + k).standard_normal(shape).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        src = kernel_source(prog, (str(dtype)[6:],), tile_for(prog, *shape))[1]
        got = torch.from_numpy(_emulate_1d(src, xt.to(torch.float32).numpy())).to(dtype)
        want = tir.stencil_program_1d_plain(prog, xt)
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_1d_deep_chain_emulated_equals_plain():
    x = np.random.default_rng(SEED).standard_normal((3, 1500)).astype(np.float32)
    prog = _jacobi_r300()
    src = kernel_source(prog, ("float32",), tile_for(prog, *x.shape))[1]
    want = tir.stencil_program_1d_plain(prog, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_emulate_1d(src, x), want)


# sha256 (first 32 hex digits) of render() for every 2-D conformance program,
# k = 1-3, float32 and bfloat16, at the 256x256 tile: the values before K5''s
# redesign, which left the 2-D generator (K2) as it was.
RENDER_2D = {
    'advection_diffusion/1/float32': '484df2a6210bea7ce41d843bdaedba0a',
    'advection_diffusion/1/bfloat16': '98fcbd3770a38375cdc86a77d2433975',
    'advection_diffusion/2/float32': '717ebeefc5226a4a7e055e2b25a380c5',
    'advection_diffusion/2/bfloat16': '1d49614c5e7fbad930db9fd674808207',
    'advection_diffusion/3/float32': '79f45006d75fd7cae5852a209200230a',
    'advection_diffusion/3/bfloat16': '8b1e956f038fee7bd171edb3223d6fa5',
    'hdiff/1/float32': 'ff7a8474430515010c840558fa7026f0',
    'hdiff/1/bfloat16': 'f25c97e4a5003b3473f75563756d42a0',
    'hdiff/2/float32': '0ed2566902557aca4efbfa190b2c2bd8',
    'hdiff/2/bfloat16': '817e917ef3f2bafb439d3132d72027ec',
    'hdiff/3/float32': '71429385024e44c771e8c94b357e9ab4',
    'hdiff/3/bfloat16': 'bdf7bb32920e7cd23709a7eaa14464cf',
    'hdiff_coupled/1/float32': '6c393d5b1458b428a52cad1153ebf185',
    'hdiff_coupled/1/bfloat16': '3aad509ea04637ff5794a8b207feca93',
    'hdiff_coupled/2/float32': '40c12ce2203dde54e943c0f448a2171c',
    'hdiff_coupled/2/bfloat16': '97e9f1316bc97c5f13da1cff3c0a7e72',
    'hdiff_coupled/3/float32': '600b66ce71c4bcb045f70ebc219ae67e',
    'hdiff_coupled/3/bfloat16': '0f6990186352e2e9ce1707ec7e6d6c72',
    'hdiff_simple/1/float32': '43701350e0693626dd3a6890df8fe831',
    'hdiff_simple/1/bfloat16': '7e190715c615f87f32f2bfadcb860936',
    'hdiff_simple/2/float32': 'e793a175ac8d8d76c05090f32a9ce67c',
    'hdiff_simple/2/bfloat16': '5a4fab90f1e1a23bde3a18a64e406fcc',
    'hdiff_simple/3/float32': '8fe46821aedf825f96c064c478b11763',
    'hdiff_simple/3/bfloat16': '27cf250ebb7ad81bafce422c5f5ff7ef',
    'jacobi2d_3pt/1/float32': '0a9ec8b887b98c9ecef7d03954ee80ac',
    'jacobi2d_3pt/1/bfloat16': '138490ae53db17cf1554e9094a7cec22',
    'jacobi2d_3pt/2/float32': 'b71564e4b4d8b34ad21d8e9f63d68f3a',
    'jacobi2d_3pt/2/bfloat16': 'b934ad5693889004389b09b66fdc8ddf',
    'jacobi2d_3pt/3/float32': 'df57e127b85f6d2473c10f4df226e49a',
    'jacobi2d_3pt/3/bfloat16': 'b2db5e44037270879e059ba6b0d685b1',
    'jacobi2d_5pt/1/float32': 'fa5e7fdf01c10ca3ad57cfbff158bf55',
    'jacobi2d_5pt/1/bfloat16': 'a467d1a2e7b314096f57e8ed35fc8d9c',
    'jacobi2d_5pt/2/float32': 'c39d2aeeb18619a6ebb254da3f5ae9d9',
    'jacobi2d_5pt/2/bfloat16': '3b934bda02a0fdfdec2dbe6e80aa6bb7',
    'jacobi2d_5pt/3/float32': '2a46ef00ca824334bde5310ac0bbc924',
    'jacobi2d_5pt/3/bfloat16': '1d052ecaf0fa1e3d2838fe6d9b61277f',
    'jacobi2d_9pt/1/float32': '397aef8cd0680223439d12da4064b665',
    'jacobi2d_9pt/1/bfloat16': '63767730d0b669a302f718ea1b5fcf74',
    'jacobi2d_9pt/2/float32': 'f9b5042af53fcc64044c49ceb8d62e08',
    'jacobi2d_9pt/2/bfloat16': 'b77b66472500cc25aebaa81c541cf14c',
    'jacobi2d_9pt/3/float32': '13e93adabbbf177495865e44567a7bec',
    'jacobi2d_9pt/3/bfloat16': '3bdcf7e5ffcabf7f0814acb5b56b0612',
    'laplacian/1/float32': '8b3fcf79f2183b15876e0c098cd3ef9a',
    'laplacian/1/bfloat16': 'c6d5f08ea0ad44e2b11b79b885d49a5a',
    'laplacian/2/float32': '23869a0e9af645e5ee2acda37a69f7c4',
    'laplacian/2/bfloat16': '9e8fedca3c71a879f2c5502c420b3053',
    'laplacian/3/float32': '693a785c4fad13a953ea7a9d28c19078',
    'laplacian/3/bfloat16': 'f42cb34724701c81b31b01a5726d9902',
    'seidel2d/1/float32': '397aef8cd0680223439d12da4064b665',
    'seidel2d/1/bfloat16': '63767730d0b669a302f718ea1b5fcf74',
    'seidel2d/2/float32': 'f9b5042af53fcc64044c49ceb8d62e08',
    'seidel2d/2/bfloat16': 'b77b66472500cc25aebaa81c541cf14c',
    'seidel2d/3/float32': '13e93adabbbf177495865e44567a7bec',
    'seidel2d/3/bfloat16': '3bdcf7e5ffcabf7f0814acb5b56b0612',
    'shallow_water/1/float32': '47d8e87f0e4084c2a29ee4d179edecc3',
    'shallow_water/1/bfloat16': '54da4d3eb1241cbc166eaa29261d6f61',
    'shallow_water/2/float32': '13a7f8b5306718cb04de0ea60986ee05',
    'shallow_water/2/bfloat16': '392e1174ce6cc082b228db5738e76ff0',
    'shallow_water/3/float32': 'db7c615016b5089860cdc6311f84f4fc',
    'shallow_water/3/bfloat16': '2da21ae44c5a0292ba67b8da3816bad3',
    'vadvc/1/float32': 'ef9f85974c3ec489b5ee474acd8d2326',
    'vadvc/1/bfloat16': 'ec03c7a2d96c4c5d60a150468f6990b9',
    'vadvc/2/float32': '50664a16034b8792353c422817c94948',
    'vadvc/2/bfloat16': 'c72d7b99f775068c4729e04c552ec20b',
    'vadvc/3/float32': 'b663f6a8724165b5f002ef649d607259',
    'vadvc/3/bfloat16': 'b108f99de20bd3c529cf06171044748b',
}


@pytest.mark.parametrize("cell", sorted(RENDER_2D))
def test_2d_render_is_unchanged(cell):
    name, k, dtype = cell.split("/")
    prog = _port(name, int(k))
    src = render(prog, (dtype,) * len(prog.inputs), tile_for(prog, 256, 256))
    assert hashlib.sha256(src.encode()).hexdigest()[:32] == RENDER_2D[cell]
