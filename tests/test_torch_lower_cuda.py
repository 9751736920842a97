"""K2 and K5', the generated fused CUDA kernels: their plain versions (the
CPU path of ``lower_cuda``) against the JAX ``lower_pallas`` in interpret
mode, and text-level checks of the generated CUDA source, which need no
nvcc.

Tolerance ``TOL`` (1e-6, rtol and atol) per output field.
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ir as jir
import repro_torch.ir as tir
from conformance import GRID, KS, PROGRAMS, SEED, TOL, assert_close, make_fields, to_host
from repro_torch.interop import fields_from_numpy, to_numpy
from repro_torch.ir.codegen_cuda import frame_plan, kernel_name
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


def _source_1d(k, n=256, dtype="float32"):
    prog = tir.repeat(tir.jacobi1d_program(), k)
    return kernel_source(prog, (dtype,), tile_for(prog, 1, n))


@pytest.mark.parametrize("k", KS)
def test_1d_source_has_one_store_exact_literals_and_a_k_r_halo(k):
    name, src = _source_1d(k)
    assert name == kernel_name(tir.repeat(tir.jacobi1d_program(), k))
    assert "stencil_program_1d(" in src and "stencil_program(" not in src
    code = re.sub(r"//[^\n]*", "", src)
    assert len(re.findall(r"\bO0\[", code)) == 1
    assert re.search(r"^\s*O0\[row \+ gc\] = from_f32<float>\(F\d+\[q \+ H\]\);", code, re.M)
    assert f32_literal(1.0 / 3.0) in code and "0.333" not in code
    assert re.search(rf"constexpr int TC = 256, H = {k};", code)
    assert code.count("* ((F0[p-1] + F0[p]) + F0[p+1])") == k
    assert len(re.findall(r"gc >= n - 1", code)) == k


def test_1d_source_tiles_long_rows_and_keys_dtype():
    _, src = _source_1d(2, n=4_194_307)
    assert "constexpr int TC = 1024, H = 2;" in src
    assert _source_1d(2, dtype="bfloat16")[1] != _source_1d(2)[1]
    assert "from_f32<__nv_bfloat16>" in _source_1d(2, dtype="bfloat16")[1]
