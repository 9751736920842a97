"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels have no
CPU mode): they carry the ``gpu`` marker and skip without a card. Run them
on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

They import neither JAX nor the JAX package, so they run where only the
port is installed. Ragged grids (tiles that do not divide the grid) and
explicit tile rows are covered here; ``chip_smoke.py`` covers the paper
grid and the main path.
"""

import pytest
import torch

import repro_torch.ir as ir
from repro_torch.ir.lower_cuda import KERNEL_N_OUT
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff import hdiff_fixed, hdiff_fixed_point_ref, hdiff_fused, hdiff_twostep
from repro_torch.kernels.hdiff import kernel as k13
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_cuda, rglru_seq_ref
from repro_torch.kernels.stencil2d import (
    jacobi1d,
    jacobi1d_cuda,
    jacobi1d_plain,
    stencil2d,
    stencil2d_cuda,
    stencil2d_plain,
    weights_for,
)
from repro_torch.kernels.wkv6 import (wkv6, wkv6_backward_plain, wkv6_bwd_cuda, wkv6_cuda,
                                      wkv6_plain, wkv6_ref)

pytestmark = pytest.mark.gpu
SHAPES = [(1, 8, 8), (2, 37, 70), (3, 65, 129)]
K2_PROGRAMS = {
    "hdiff_x3": lambda: ir.repeat(ir.hdiff_program(), 3),
    "jacobi2d_3pt": ir.jacobi2d_3pt_program,
    "seidel2d_x2": lambda: ir.repeat(ir.seidel2d_program(), 2),
    "vadvc_x2": lambda: ir.repeat(ir.vadvc_program(), 2),
    "hdiff_coupled_x3": lambda: ir.repeat(ir.hdiff_coupled_program(), 3),
    "advection_diffusion_x3": lambda: ir.repeat(ir.advection_diffusion_program(), 3),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def _equal(a, b):
    torch.cuda.synchronize()
    if isinstance(a, dict):
        assert set(a) == set(b)
        for f in a:
            assert torch.equal(a[f], b[f]), f
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_bit_equal_to_plain(cuda, shape, dtype):
    x = _rand(shape, cuda).to(dtype)
    for limit in (True, False):
        _equal(k13.hdiff_cuda(x, 0.025, limit=limit), k13.hdiff_plain(x, 0.025, limit=limit))


@pytest.mark.parametrize("block_rows", [4, 16, 64])
def test_k1_explicit_tile_rows(cuda, block_rows):
    x = _rand((2, 64, 96), cuda, seed=1)
    _equal(hdiff_fused(x, 0.05, block_rows=block_rows), k13.hdiff_plain(x, 0.05))


def _bits_equal(got, want):
    """Equal dtype and shape, NaN at the same points, and every other value
    equal bit for bit (so +0 and -0 differ)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[want.dtype]
    assert torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


def _offset_by_one(x):
    """A contiguous copy of ``x`` one element into its storage, so its
    pointer is not 16-byte aligned and the frame loads go word by word."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = base[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 and y.is_contiguous()
    return y


def _nonfinite(x, seed):
    """``x`` with NaN, +-Inf, -0 and values whose differences' products
    underflow (to subnormals and to +-0) scattered through it."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    x = x.clone()
    flat = x.view(-1)
    picks = torch.randint(0, flat.numel(), (6, max(1, flat.numel() // 50)), generator=g,
                          device=x.device)
    flat[picks[0]] = float("nan")
    flat[picks[1]] = float("inf")
    flat[picks[2]] = float("-inf")
    flat[picks[3]] = -0.0
    flat[picks[4]] = 1e-21 * torch.randn(picks.shape[1], generator=g, device=x.device).to(x.dtype)
    flat[picks[5]] = 1e-25 * torch.randn(picks.shape[1], generator=g, device=x.device).to(x.dtype)
    return x


# Widths that are not whole 16-byte groups in float32 (33, 102) or bfloat16
# (33, 102, 36), and a grid of several tiles each way.
UNALIGNED_SHAPES = [(2, 37, 33), (1, 70, 102), (2, 9, 36), (1, 130, 136)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", UNALIGNED_SHAPES)
def test_k1_unaligned_widths_and_pointers_bit_equal(cuda, shape, dtype):
    x = _rand(shape, cuda, seed=21).to(dtype)
    for limit in (True, False):
        want = k13.hdiff_plain(x, 0.025, limit=limit)
        _bits_equal(k13.hdiff_cuda(x, 0.025, limit=limit), want)
        _bits_equal(k13.hdiff_cuda(_offset_by_one(x), 0.025, limit=limit), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_rows", [4, 16, 64])
def test_k1_explicit_tile_rows_bf16_and_unaligned_pointer(cuda, block_rows, dtype):
    x = _rand((2, 64, 96), cuda, seed=22).to(dtype)
    want = k13.hdiff_plain(x, 0.05)
    _bits_equal(hdiff_fused(x, 0.05, block_rows=block_rows), want)
    _bits_equal(hdiff_fused(_offset_by_one(x), 0.05, block_rows=block_rows), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 37, 33)])
def test_k1_nonfinite_and_underflowing_inputs(cuda, shape, dtype):
    """NaN and Inf inputs, -0, and fluxes whose products with the gradient
    underflow: the multiply-compare limiter keeps a flux whose product is
    +-0 and zeroes one whose product is NaN, as the plain version does."""
    x = _nonfinite(_rand(shape, cuda, seed=23).to(dtype), seed=24)
    for limit in (True, False):
        _bits_equal(k13.hdiff_cuda(x, 0.025, limit=limit), k13.hdiff_plain(x, 0.025, limit=limit))
    tiny = (1e-20 * _rand(shape, cuda, seed=25)).to(dtype)  # every product underflows
    _bits_equal(k13.hdiff_cuda(tiny, 0.025), k13.hdiff_plain(tiny, 0.025))


def test_k1_replayed_from_a_cuda_graph_equals_eager(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        x = _rand((4, 130, 102), cuda, seed=26).to(dtype)
        eager = k13.hdiff_cuda(x, 0.025)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = k13.hdiff_cuda(x, 0.025)
        for _ in range(2):
            graph.replay()
        _bits_equal(replayed, eager)
        _bits_equal(replayed, k13.hdiff_plain(x, 0.025))


@pytest.mark.parametrize("shape", SHAPES)
def test_k3_bit_equal_to_plain_with_wraparound(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(-(2**30), 2**30, shape, generator=g, device=cuda, dtype=torch.int32)
    _equal(hdiff_fixed(x), hdiff_fixed_point_ref(x, 26, 10))
    _equal(hdiff_fixed(x, coeff_num=3, coeff_shift=2), hdiff_fixed_point_ref(x, 3, 2))


def _int32(shape, device, seed, lo=-(2**31), hi=2**31):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int64).to(
        torch.int32)


def _sign_edges(shape, device, seed):
    """int32 values chosen for the flux limiter's sign test: zeros,
    INT32_MIN and INT32_MAX, values near +-2**30 whose Laplacian and fluxes
    wrap, and runs of equal neighbours (zero fluxes and zero gradients)."""
    pool = torch.tensor([0, -(2**31), 2**31 - 1, 2**30, -(2**30), 2**30 - 1, -(2**30) + 1, 1, -1,
                         7], dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = pool[torch.randint(0, len(pool), shape, generator=g, device=device)]
    x[..., ::3, :] = x[..., ::3, :1]  # every third row constant along the row
    x[..., :, 1::4] = x[..., :, :1]  # and runs of equal values down columns
    return x.contiguous()


K3_COEFFS = [(26, 10), (3, 2), (-7, 31), (1, 0)]


@pytest.mark.parametrize("shape", [(3, 250, 190), (2, 67, 129), (1, 130, 66), (2, 5, 9)])
def test_k3_ragged_grids_bit_equal(cuda, shape):
    """Grids that cross tile edges both ways, with widths that are not a
    multiple of 4 words (the word-by-word loads) and ones that are."""
    for seed, x in enumerate((_int32(shape, cuda, 1), _int32(shape, cuda, 2, -1000, 1000),
                              _sign_edges(shape, cuda, 3))):
        for num, shift in K3_COEFFS:
            _equal(hdiff_fixed(x, coeff_num=num, coeff_shift=shift),
                   hdiff_fixed_point_ref(x, num, shift))


@pytest.mark.parametrize("shape", [(64, 256, 256), (2, 64, 96)])
def test_k3_sign_test_edge_cases(cuda, shape):
    x = _sign_edges(shape, cuda, 4)
    for num, shift in K3_COEFFS:
        _equal(k13.hdiff_fixed_cuda(x, coeff_num=num, coeff_shift=shift),
               hdiff_fixed_point_ref(x, num, shift))


@pytest.mark.parametrize("block_rows", [4, 16, 32, 64])
def test_k3_explicit_tile_rows_and_unaligned_pointer(cuda, block_rows):
    x = _int32((2, 64, 96), cuda, 5)
    want = hdiff_fixed_point_ref(x, 26, 10)
    _equal(hdiff_fixed(x, block_rows=block_rows), want)
    # A contiguous view one word into its storage: the loads go word by word.
    base = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda)
    y = base[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 and y.is_contiguous()
    _equal(hdiff_fixed(y, block_rows=block_rows), want)


@pytest.mark.parametrize("name", sorted(K2_PROGRAMS))
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_k2_bit_equal_to_plain(cuda, name, shape):
    prog = K2_PROGRAMS[name]()
    arrays = tuple(_rand(shape, cuda, seed=i) for i in range(len(prog.inputs)))
    _equal(ir.stencil_program_cuda(prog, arrays), ir.stencil_program_plain(prog, arrays))


CONFORMANCE_2D = {
    "hdiff": ir.hdiff_program, "hdiff_simple": lambda: ir.hdiff_program(limit=False),
    "jacobi2d_3pt": ir.jacobi2d_3pt_program, "laplacian": ir.laplacian_program,
    "jacobi2d_5pt": ir.jacobi2d_5pt_program, "jacobi2d_9pt": ir.jacobi2d_9pt_program,
    "seidel2d": ir.seidel2d_program, "vadvc": ir.vadvc_program,
    "hdiff_coupled": ir.hdiff_coupled_program, "shallow_water": ir.shallow_water_program,
    "advection_diffusion": ir.advection_diffusion_program,
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CONFORMANCE_2D))
def test_k2_conformance_programs_bit_equal_to_plain(cuda, name, k, dtype):
    """Every 2-D conformance program, k fused sweeps, on a ragged grid whose
    rows are not a multiple of 4 words (element-wise loads) and on one of
    several tiles each way whose rows are (16-byte copies)."""
    prog = ir.repeat(CONFORMANCE_2D[name](), k)
    for shape in ((2, 37, 70), (1, 130, 152)):
        arrays = tuple(_rand(shape, cuda, seed=i).to(dtype) for i in range(len(prog.inputs)))
        _equal(ir.stencil_program_cuda(prog, arrays), ir.stencil_program_plain(prog, arrays))


def _kept(out, fields, index):
    out = out if isinstance(out, dict) else {fields[0]: out}
    return {f: out[f][index] for f in fields}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CONFORMANCE_2D))
def test_k2_offset_mode_shards_bit_equal_to_plain_and_unsharded(cuda, name, k, dtype):
    """K2's offset mode on every shard of a 2x4 split (column mode) and a
    2x1 split (row mode) of a ragged 2x134x268 grid (67-row, 67-column
    shards: tiles that do not divide them, rows not a multiple of 4 words):
    each shard's halo-padded block, zeros past the grid edge, launched with
    its global offsets. The kept region is bit-equal to the plain version
    with the same offsets and to the same region of the unsharded launch.
    Every block is at least a tile each way, so the shards share the
    unsharded launch's kernel."""
    prog = ir.repeat(CONFORMANCE_2D[name](), k)
    h = prog.radius
    shape = (2, 134, 268)
    _, rows, cols = shape
    arrays = tuple(_rand(shape, cuda, seed=i).to(dtype) for i in range(len(prog.inputs)))
    whole = ir.stencil_program_cuda(prog, arrays)
    outs = tuple(prog.outputs) if len(prog.outputs) > 1 else (prog.passthrough,)
    for n_row, n_col in ((2, 4), (2, 1)):
        col_mode = n_col > 1
        r, c = rows // n_row, cols // n_col
        pad = (h, h, h, h) if col_mode else (0, 0, h, h)
        padded = [torch.nn.functional.pad(a, pad) for a in arrays]
        for i in range(n_row):
            for j in range(n_col):
                cs = slice(j * c, j * c + c + 2 * h) if col_mode else slice(None)
                block = tuple(a[:, i * r : i * r + r + 2 * h, cs].contiguous() for a in padded)
                kw = dict(row_offset=i * r - h, rows_global=rows)
                if col_mode:
                    kw.update(col_offset=j * c - h, cols_global=cols)
                keep = (Ellipsis, slice(h, h + r), slice(h, h + c) if col_mode else slice(None))
                got = _kept(ir.stencil_program_cuda(prog, block, **kw), outs, keep)
                _equal(got, _kept(ir.stencil_program_plain(prog, block, **kw), outs, keep))
                crop = (Ellipsis, slice(i * r, i * r + r),
                        slice(j * c, j * c + c) if col_mode else slice(None))
                _equal(got, _kept(whole, outs, crop))


def test_k2_bf16_and_twostep(cuda):
    x = _rand((2, 64, 48), cuda, seed=5)
    _equal(hdiff_twostep(x, 0.05, block_rows=16), hdiff_fused(hdiff_fused(x, 0.05), 0.05))
    xb = x.to(torch.bfloat16)
    prog = ir.repeat(ir.hdiff_program(0.05), 2)
    _equal(ir.stencil_program_cuda(prog, (xb,)), ir.stencil_program_plain(prog, (xb,)))


MASKS = ["jacobi2d_3pt", "laplacian", "jacobi2d_5pt", "jacobi2d_9pt", "seidel2d"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k4_bit_equal_to_plain(cuda, shape, dtype):
    x = _rand(shape, cuda, seed=7).to(dtype)
    g = torch.Generator().manual_seed(8)
    for w in [weights_for(n) for n in MASKS] + [torch.randn(3, 3, generator=g).numpy()]:
        _equal(stencil2d_cuda(x, w), stencil2d_plain(x, w))


@pytest.mark.parametrize("block_rows", [1, 4, 16, 64])
def test_k4_explicit_tile_rows_and_nonfinite_input(cuda, block_rows):
    x = _rand((2, 64, 96), cuda, seed=9)
    x[0, 10, 10], x[1, 20, 30] = float("inf"), float("nan")
    got = stencil2d(x, "jacobi2d_3pt", block_rows=block_rows)
    want = stencil2d_plain(x, weights_for("jacobi2d_3pt"))
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def _k4_masks():
    g = torch.Generator().manual_seed(27)
    return [weights_for(n) for n in MASKS] + [torch.randn(3, 3, generator=g).numpy()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", UNALIGNED_SHAPES)
def test_k4_unaligned_widths_and_pointers_bit_equal(cuda, shape, dtype):
    x = _rand(shape, cuda, seed=28).to(dtype)
    y = _offset_by_one(x)
    for w in _k4_masks():
        want = stencil2d_plain(x, w)
        _bits_equal(stencil2d_cuda(x, w), want)
        _bits_equal(stencil2d_cuda(y, w), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_rows", [1, 4, 16, 64])
def test_k4_tile_rows_every_mask_and_nonfinite_input(cuda, block_rows, dtype):
    """NaN, +-Inf and -0 inputs under every mask: a zero tap on an Inf
    makes NaN, and 0 + -0 is +0, as the plain version's sum gives."""
    x = _nonfinite(_rand((2, 64, 96), cuda, seed=29).to(dtype), seed=30)
    for w in _k4_masks():
        _bits_equal(stencil2d_cuda(x, w, block_rows=block_rows), stencil2d_plain(x, w))
    neg0 = torch.full((1, 16, 40), -0.0, device=cuda, dtype=dtype)
    _bits_equal(stencil2d(neg0, "laplacian", block_rows=block_rows),
                stencil2d_plain(neg0, weights_for("laplacian")))


def test_k4_replayed_from_a_cuda_graph_equals_eager(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        x = _rand((4, 130, 102), cuda, seed=31).to(dtype)
        w = weights_for("jacobi2d_9pt")
        eager = stencil2d_cuda(x, w)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = stencil2d_cuda(x, w)
        for _ in range(2):
            graph.replay()
        _bits_equal(replayed, eager)
        _bits_equal(replayed, stencil2d_plain(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (5, 37), (70000, 3), (2, 100_003)])
def test_k5_bit_equal_to_plain(cuda, shape, dtype):
    x = _rand(shape, cuda, seed=10).to(dtype)
    _equal(jacobi1d_cuda(x), jacobi1d_plain(x))
    _equal(jacobi1d_cuda(x, 0.3), jacobi1d_plain(x, 0.3))
    _equal(jacobi1d(x[0]), jacobi1d_plain(x[:1])[0])


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("shape", [(1, 5), (7, 33), (70000, 9), (3, 5000)])
def test_k5_prime_bit_equal_to_plain(cuda, shape, k):
    prog = ir.repeat(ir.jacobi1d_program(), k)
    x = _rand(shape, cuda, seed=11)
    _equal(ir.stencil_program_1d_cuda(prog, x), ir.stencil_program_1d_plain(prog, x))
    xb = x.to(torch.bfloat16)
    _equal(ir.stencil_program_1d_cuda(prog, xb), ir.stencil_program_1d_plain(prog, xb))


def test_k5_prime_k_sweeps_equal_k_single_sweeps(cuda):
    x = _rand((9, 3000), cuda, seed=12)
    one = ir.lower_cuda(ir.jacobi1d_program())
    _equal(ir.lower_cuda(ir.repeat(ir.jacobi1d_program(), 3))(x), one(one(one(x))))


CHAINS_1D = {"jacobi1d": ir.jacobi1d_program, "hdiff1d": ir.hdiff1d_program,
             "smooth1d": ir.smooth1d_program}


def _k5_prime_check(prog, x):
    """K5' against its plain version, bit for bit; a row too short for the
    program raises the same error on both paths."""
    try:
        want = ir.stencil_program_1d_plain(prog, x)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ir.stencil_program_1d_cuda(prog, x)
        assert str(got.value) == str(e)
        return
    _bits_equal(ir.stencil_program_1d_cuda(prog, x), want)


# Spans that cross many rows, rows shorter than the chain halo (hdiff1d x 3:
# 6) or than one sweep's margins (n = 1, 3), odd flat lengths, a row longer
# than a span, the paper's rows.
K5P_SHAPES = [(70000, 9), (16384, 3), (5, 1), (7, 5), (3, 6), (1, 3), (4, 4097),
              (16384, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CHAINS_1D))
@pytest.mark.parametrize("shape", K5P_SHAPES)
def test_k5_prime_chains_bit_equal_to_plain(cuda, shape, name, k, dtype):
    prog = ir.repeat(CHAINS_1D[name](), k)
    _k5_prime_check(prog, _rand(shape, cuda, seed=13).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CHAINS_1D))
def test_k5_prime_misaligned_base_and_nonfinite_inputs(cuda, name, k, dtype):
    """A contiguous (b, n) view one element into its buffer takes the word
    path for its loads (the output, a new tensor, still stores by
    vectors); NaN, +-Inf, -0 and underflowing values land as in the plain
    version."""
    prog = ir.repeat(CHAINS_1D[name](), k)
    x = _rand((37, 101), cuda, seed=14).to(dtype)
    _k5_prime_check(prog, _offset_by_one(x))
    _k5_prime_check(prog, _offset_by_one(_nonfinite(x, seed=15)))
    _k5_prime_check(prog, _nonfinite(x, seed=16))
    _k5_prime_check(prog, (1e-20 * _rand((37, 101), cuda, seed=17)).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2])
def test_k5_prime_deep_chain_takes_wider_spans(cuda, k, dtype):
    """A radius-300 op: two (k = 1) or four (k = 2) vectors a thread."""
    far = ir.StencilProgram(
        "far1d", ["x"], [ir.affine("out", "x", {(-300,): 0.5, (0,): 0.25, (300,): 0.25})],
        ndim=1)
    _k5_prime_check(ir.repeat(far, k), _rand((5, 2000), cuda, seed=18).to(dtype))


def test_k5_prime_replayed_from_a_cuda_graph_equals_eager(cuda):
    prog = ir.repeat(ir.hdiff1d_program(), 3)
    for dtype in (torch.float32, torch.bfloat16):
        x = _rand((300, 257), cuda, seed=19).to(dtype)
        eager = ir.stencil_program_1d_cuda(prog, x)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = ir.stencil_program_1d_cuda(prog, x)
        for _ in range(2):
            graph.replay()
        _bits_equal(replayed, eager)
        _bits_equal(replayed, ir.stencil_program_1d_plain(prog, x))


def test_wrappers_count_launches_and_reject_bad_input(cuda):
    x = _rand((1, 16, 16), cuda)
    _build.reset_launches()
    hdiff_fused(x)
    hdiff_twostep(x)
    assert _build.LAUNCHES == {"hdiff_cuda": 1, "stencil_program_cuda": 1}
    with pytest.raises(TypeError):
        k13.hdiff_cuda(x.double(), 0.025)
    with pytest.raises(ValueError, match="contiguous"):
        k13.hdiff_cuda(x.transpose(1, 2), 0.025)
    assert _build.LAUNCHES == {"hdiff_cuda": 1, "stencil_program_cuda": 1}


def test_elementary_wrappers_count_launches(cuda):
    x, y = _rand((1, 16, 16), cuda), _rand((2, 40), cuda)
    _build.reset_launches()
    stencil2d(x, "laplacian")
    jacobi1d(y)
    ir.lower_cuda(ir.jacobi1d_program())(y)
    stencil2d_plain(x, weights_for("laplacian"))
    assert _build.LAUNCHES == {"stencil2d_cuda": 1, "jacobi1d_cuda": 1,
                               "stencil_program_1d_cuda": 1}
    with pytest.raises(ValueError, match="contiguous"):
        jacobi1d_cuda(y.t())
    with pytest.raises(TypeError):
        stencil2d_cuda(x.double(), weights_for("laplacian"))


def _wkv_inputs(shape, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    b, t, h, n = shape

    def randn(*s):
        return torch.randn(s, generator=g, device=device)

    r, k, v = 0.5 * randn(b, t, h, n), 0.5 * randn(b, t, h, n), randn(b, t, h, n)
    w = 0.6 + 0.399 * torch.rand((b, t, h, n), generator=g, device=device)
    return r, k, v, w, 0.3 * randn(h, n), 0.1 * randn(b, h, n, n)


# Head sizes that are not a multiple of the 16-wide mma tile (24, 8), B > 1,
# chunks from 8 to 64, and many chunks with B > 1.
K7_CASES = [((1, 128, 3, 64), 64), ((2, 128, 3, 16), 32), ((1, 96, 2, 24), 32),
            ((3, 40, 2, 8), 8), ((2, 64, 5, 32), 16), ((2, 1024, 4, 64), 64)]


@pytest.mark.parametrize("shape,chunk", K7_CASES)
def test_k7_matches_plain_and_sequential(cuda, shape, chunk):
    r, k, v, w, u, s0 = _wkv_inputs(shape, cuda, seed=sum(shape))
    for state in (s0, torch.zeros_like(s0)):
        y, s = wkv6_cuda(r, k, v, w, u, state, chunk=chunk)
        y_p, s_p = wkv6_plain(r, k, v, w, u, state, chunk=chunk)
        y_o, s_o = wkv6_ref(r, k, v, w, u, state)
        torch.cuda.synchronize()
        for got, plain, oracle in ((y, y_p, y_o), (s, s_p, s_o)):
            # Summation order differs in the four products of a chunk.
            bound = 1e-5 * plain.abs().max().item() + 1e-6
            assert (got - plain).abs().max().item() <= bound
            torch.testing.assert_close(got, oracle, rtol=3e-4, atol=3e-4)


def test_k7_entry_clamps_chunk_and_rejects_bad_input(cuda):
    r, k, v, w, u, s0 = _wkv_inputs((1, 16, 2, 16), cuda, seed=1)
    y, s = wkv6(r, k, v, w, u, chunk=64)  # chunk clamped to T = 16; zero state
    torch.testing.assert_close(y, wkv6_ref(r, k, v, w, u)[0], rtol=3e-4, atol=3e-4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv6_cuda(r, k, v, w, u, s0, chunk=6)
    with pytest.raises(TypeError):
        wkv6_cuda(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_cuda(r, k, v.transpose(2, 3).contiguous().transpose(2, 3), w, u, s0)
    with pytest.raises(ValueError, match="shape"):
        wkv6_cuda(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="device"):
        wkv6_cuda(r, k, v, w, u.cpu(), s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 512, 2560), (3, 64, 128), (2, 37, 100), (4, 1, 7)])
def test_k6_bit_equal_to_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    a = (0.5 + 0.499 * torch.rand(shape, generator=g, device=cuda)).to(dtype)
    b = torch.randn(shape, generator=g, device=cuda).to(dtype)
    h0 = torch.randn((shape[0], shape[2]), generator=g, device=cuda)
    h, last = rglru_scan_cuda(a, b, h0)
    h_p, last_p = rglru_seq_ref(a, b, h0)
    _equal(h, h_p)
    _equal(last, last_p)


def _k6_inputs(shape, device, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    a = (0.5 + 0.499 * torch.rand(shape, generator=g, device=device)).to(dtype)
    b = torch.randn(shape, generator=g, device=device).to(dtype)
    return a, b, torch.randn((shape[0], shape[2]), generator=g, device=device)


# The channel tile against the width (2564 = 128 tiles of 20 and one of 4),
# float32 rows that are not whole 16-byte groups (102, 33: one-word copies),
# T = 1, T not a multiple of the 64-step stage (200, 65), B = 8 with
# T = 4096 (32-channel tiles, 640 blocks).
K6_SHAPES = [(1, 70, 2564), (2, 37, 102), (3, 20, 33), (4, 1, 2560), (2, 200, 256),
             (1, 65, 2560), (8, 4096, 2560)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_k6_new_paths_bit_equal_to_plain(cuda, shape, dtype):
    a, b, h0 = _k6_inputs(shape, cuda, dtype, sum(shape))
    h, last = rglru_scan_cuda(a, b, h0)
    h_p, last_p = rglru_seq_ref(a, b, h0)
    _equal(h, h_p)
    _equal(last, last_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_unaligned_pointers_take_the_word_path(cuda, dtype):
    """Contiguous views one element into their storage: the width is a
    multiple of 4 but the copies cannot be 4-channel groups."""
    a, b, h0 = _k6_inputs((2, 130, 256), cuda, dtype, 6)
    views = []
    for x in (a, b):
        base = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        views.append(base[1:].view(x.shape))
        views[-1].copy_(x)
    assert views[0].data_ptr() % 8 and views[0].is_contiguous()
    want = rglru_seq_ref(a, b, h0)
    got = rglru_scan_cuda(*views, h0)
    _equal(got[0], want[0])
    _equal(got[1], want[1])


def test_k6_replayed_from_a_cuda_graph_equals_eager(cuda):
    a, b, h0 = _k6_inputs((1, 512, 2560), cuda, torch.float32, 7)
    eager = rglru_scan_cuda(a, b, h0)
    rglru_scan_cuda(a, b, h0)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = rglru_scan_cuda(a, b, h0)
    for _ in range(2):
        graph.replay()
    _equal(replayed[0], eager[0])
    _equal(replayed[1], eager[1])


def test_k6_entry_and_bad_input(cuda):
    a = torch.rand((2, 9, 33), device=cuda)
    b = torch.randn((2, 9, 33), device=cuda)
    h, last = rglru_scan(a, b)
    _equal(h, rglru_seq_ref(a, b, torch.zeros((2, 33), device=cuda))[0])
    with pytest.raises(TypeError):
        rglru_scan_cuda(a, b.to(torch.bfloat16), torch.zeros((2, 33), device=cuda))
    with pytest.raises(TypeError):
        rglru_scan_cuda(a, b, torch.zeros((2, 33), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_cuda(a, b.transpose(0, 1).contiguous().transpose(0, 1),
                        torch.zeros((2, 33), device=cuda))


def test_recurrent_wrappers_count_launches(cuda):
    r, k, v, w, u, s0 = _wkv_inputs((1, 16, 1, 8), cuda, seed=2)
    a, b = torch.rand((1, 4, 8), device=cuda), torch.randn((1, 4, 8), device=cuda)
    _build.reset_launches()
    wkv6(r, k, v, w, u, s0, chunk=8)
    rglru_scan(a, b)
    wkv6_plain(r, k, v, w, u, s0)
    rglru_seq_ref(a, b, torch.zeros((1, 8), device=cuda))
    assert _build.LAUNCHES == {"wkv6_cuda": 1, "rglru_scan_cuda": 1}


# -- K2 on the gradient path: adjoint and augmented programs ----------------------


def _gradient_programs():
    """Every distinct adjoint and augmented program of the conformance
    chains (k = 1..3 repeat the same sweeps, so k = 1 covers them)."""
    progs = {}
    for name, make in CONFORMANCE_2D.items():
        q = make()
        progs[f"{name}.adj"] = ir.adjoint(q)
        if ir.cache_fields(q):
            progs[f"{name}.aug"] = ir.augmented_forward(q)
    return progs


GRADIENT_PROGRAMS = sorted(_gradient_programs())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", GRADIENT_PROGRAMS)
def test_k2_gradient_programs_bit_equal_to_plain(cuda, name, dtype):
    """Each adjoint and augmented program (up to 9 inputs and 6 outputs),
    on a ragged grid and on one of several tiles each way, unaligned
    pointers too."""
    prog = _gradient_programs()[name]
    for shape in ((2, 37, 70), (1, 130, 152)):
        arrays = tuple(_rand(shape, cuda, seed=i).to(dtype) for i in range(len(prog.inputs)))
        want = ir.stencil_program_plain(prog, arrays)
        _equal(ir.stencil_program_cuda(prog, arrays), want)
    arrays = tuple(_offset_by_one(a) for a in arrays)
    _equal(ir.stencil_program_cuda(prog, arrays), ir.stencil_program_plain(prog, arrays))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CONFORMANCE_2D))
def test_make_vjp_on_the_card_equals_the_cpu(cuda, name, k):
    """The whole backward through K2 on the card, bit for bit against the
    same call on the CPU (plain K2; pad, mask, crop and add are
    elementwise)."""
    prog = ir.repeat(CONFORMANCE_2D[name](), k)
    shape = (2, 37, 70)
    x = {f: _rand(shape, cuda, seed=i) for i, f in enumerate(prog.inputs)}
    if "coeff" in x:
        x["coeff"] = 0.025 * (1.0 + 0.25 * torch.tanh(x["coeff"]))
    g = {f: _rand(shape, cuda, seed=40 + i) for i, f in enumerate(prog.outputs)}
    g = g if len(prog.outputs) > 1 else g[prog.passthrough]
    vjp = ir.make_vjp(prog, lambda p: ir.build_backend(p, "cuda"))
    got = vjp(x, g)
    host = {f: a.cpu() for f, a in x.items()}
    want = vjp(host, {f: a.cpu() for f, a in g.items()} if isinstance(g, dict) else g.cpu())
    _equal({f: a.cpu() for f, a in got.items()}, want)


def test_assimilation_steps_launch_k2_exactly(cuda):
    from repro_torch.train import (AssimilationConfig, fit_coefficient_field,
                                   synthetic_observations, true_coefficients)

    shape = (2, 40, 48)
    u0 = _rand(shape, cuda, seed=7)
    for k, per_step in ((1, 3), (2, 5)):
        cfg = AssimilationConfig(steps=3, k=k)
        obs = synthetic_observations(u0, true_coefficients(shape, seed=1), cfg).detach()
        _build.reset_launches()
        res = fit_coefficient_field(u0, obs, cfg)
        assert _build.LAUNCHES == {"stencil_program_cuda": 3 * per_step,
                                   KERNEL_N_OUT: 3 * (per_step - 1)}
        host = fit_coefficient_field(u0.cpu(), obs.cpu(), AssimilationConfig(steps=1, k=k))
        assert host.losses[0] == res.losses[0] or abs(host.losses[0] - res.losses[0]) <= (
            1e-6 * host.losses[0])  # the mean is a reduction
        assert torch.equal(res.coeff[..., :2, :].cpu(), torch.full((2, 2, 48), 0.025))


def test_hdiff_fused_ad_launches_and_matches_the_cpu(cuda):
    from repro_torch.kernels.hdiff import hdiff_fused_ad

    psi = _rand((2, 40, 48), cuda, seed=8)
    g = _rand((2, 40, 48), cuda, seed=9)
    grads = []
    for dev in (cuda, "cpu"):
        p = psi.detach().to(dev).requires_grad_(True)
        c = torch.tensor(0.03, device=dev, requires_grad=True)
        _build.reset_launches()
        hdiff_fused_ad(p, c).backward(g.to(dev))
        if dev is cuda:
            assert _build.LAUNCHES == {"hdiff_cuda": 1, "stencil_program_cuda": 2,
                                       KERNEL_N_OUT: 2}
        grads.append((p.grad.cpu(), c.grad.cpu()))
    assert torch.equal(grads[0][0], grads[1][0])
    assert abs(float(grads[0][1]) - float(grads[1][1])) <= 1e-5 * abs(float(grads[1][1]))


def test_generic_rule_op_has_no_cuda_emitter(cuda):
    from repro_torch.ir.graph import OpCost, Read, StencilOp, StencilProgram

    # The forward op lowers (it has an emitter) but has no adjoint rule, so
    # its adjoint's terms come from the generic rule, which K2 refuses.
    op = StencilOp("sq", (Read("u", (0, 0)), Read("u", (0, 1))), lambda a, b: a * b,
                   OpCost(macs=1), tag="custom-sq", emit=lambda a, b: f"({a} * {b})")
    prog = StencilProgram("custom", ["u"], [op], ndim=2)
    fn = ir.build_backend(prog, "cuda", differentiable=True)
    x = _rand((1, 16, 16), cuda).requires_grad_(True)
    y = fn(x)
    with pytest.raises(ValueError, match="has no CUDA emitter"):
        y.sum().backward()


# -- the member axis (lower_batched) and grids deeper than 65535 planes --------

BATCHED = {
    "hdiff": ir.hdiff_program,
    "hdiff_x2": lambda: ir.repeat(ir.hdiff_program(), 2),
    "shallow_water": ir.shallow_water_program,
    "hdiff_coupled": ir.hdiff_coupled_program,
}


def _members(prog, n, shape, device, dtype=torch.float32, seed=0):
    out = {}
    for i, f in enumerate(prog.inputs):
        a = _rand((n, *shape), device, seed=seed + i)
        out[f] = (0.025 * (1.0 + 0.25 * torch.tanh(a)) if f == "coeff" else a).to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name", sorted(BATCHED))
def test_k2_batched_one_launch_bit_equal_to_plain_and_unbatched(cuda, name, n, dtype):
    """A batched step of the cuda backend is ONE K2 launch over n*D planes
    (an N-output one for shallow_water), bit-equal to the plain version on
    the folded fields and, member by member, to n unbatched launches."""
    prog = BATCHED[name]()
    shape = (2, 37, 70)
    x = _members(prog, n, shape, cuda, dtype)
    arg = x if len(prog.inputs) > 1 else x[prog.inputs[0]]
    fn = ir.lower_batched(prog, backend="cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    got = fn(arg)
    torch.cuda.synchronize()
    want = {"stencil_program_cuda": 1}
    if len(prog.outputs) > 1:
        want[KERNEL_N_OUT] = 1
    assert _build.LAUNCHES == want
    folded = tuple(a.reshape(-1, *shape[1:]) for a in x.values())
    plain = ir.stencil_program_plain(prog, folded)
    as_dict = (lambda y: y if isinstance(y, dict) else {prog.passthrough: y})
    got, plain = as_dict(got), as_dict(plain)
    _equal(got, {f: v.reshape(n, *shape) for f, v in plain.items()})
    for i in range(n):
        single = as_dict(ir.lower_cuda(prog)({f: a[i] for f, a in x.items()}
                                             if len(prog.inputs) > 1 else x[prog.inputs[0]][i]))
        _equal({f: v[i] for f, v in got.items()}, single)


DEEP = (65537, 12, 12)  # two launches: 65535 planes, then 2


@pytest.mark.parametrize("kernel", ["k1", "k2_hdiff", "k2_shallow_water", "k3", "k4"])
def test_grids_deeper_than_the_grid_limit_bit_equal_to_plain(cuda, kernel):
    """K1-K4 map depth to a grid dimension of at most 65535 blocks: a deeper
    field goes in consecutive launches, each counted, bit-equal to the
    plain version (the last planes included)."""
    x = _rand(DEEP, cuda, seed=3)
    torch.cuda.synchronize()
    _build.reset_launches()
    if kernel == "k1":
        got, want, key = k13.hdiff_cuda(x, 0.025), k13.hdiff_plain(x, 0.025), "hdiff_cuda"
    elif kernel == "k3":
        xq = (x * 2**16).to(torch.int32)
        got, want = k13.hdiff_fixed_cuda(xq), hdiff_fixed_point_ref(xq, 26, 10)
        key = "hdiff_fixed_cuda"
    elif kernel == "k4":
        w = weights_for("jacobi2d_9pt")
        got, want, key = stencil2d_cuda(x, w), stencil2d_plain(x, w), "stencil2d_cuda"
    else:
        prog = ir.hdiff_program() if kernel == "k2_hdiff" else ir.shallow_water_program()
        arrays = tuple(_rand(DEEP, cuda, seed=i) for i in range(len(prog.inputs)))
        got = ir.stencil_program_cuda(prog, arrays)
        want, key = ir.stencil_program_plain(prog, arrays), "stencil_program_cuda"
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == 2
    if kernel == "k2_shallow_water":
        assert _build.LAUNCHES[KERNEL_N_OUT] == 2
    _equal(got, want)


# -- batches past the grid's 65535 blocks (K6, K7) and K6's backward --------------


def test_k6_batch_past_the_grid_limit_bit_equal_to_plain(cuda):
    """K6 maps the batch to the grid's y dimension: 65537 rows go in two
    launches with offset pointers, each counted, bit-equal to the plain
    version (the last rows included)."""
    a, b, h0 = _k6_inputs((65537, 4, 32), cuda, torch.float32, 11)
    _build.reset_launches()
    h, last = rglru_scan_cuda(a, b, h0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"rglru_scan_cuda": 2}
    h_p, last_p = rglru_seq_ref(a, b, h0)
    _equal(h, h_p)
    _equal(last, last_p)


@pytest.mark.parametrize("shape", [(65537, 16, 1, 8), (1, 16, 65537, 4)])
def test_k7_batch_and_heads_past_the_grid_limit_match_plain(cuda, shape):
    """K7's grid is (chunks, heads, batch): a batch or a head count past
    65535 goes in two calls, each counted; within K7's bound of its plain
    version."""
    r, k, v, w, u, s0 = _wkv_inputs(shape, cuda, seed=5)
    _build.reset_launches()
    y, s = wkv6_cuda(r, k, v, w, u, s0, chunk=16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"wkv6_cuda": 2}
    y_p, s_p = wkv6_plain(r, k, v, w, u, s0, chunk=16)
    for got, plain in ((y, y_p), (s, s_p)):
        assert (got - plain).abs().max().item() <= 1e-5 * plain.abs().max().item() + 1e-6


@pytest.mark.parametrize("shape", [(4, 256, 2560), (2, 37, 102), (3, 1, 8)])
def test_k6_backward_bit_equal_to_plain_reverse_and_near_autograd(cuda, shape):
    """K6's backward runs K6 on the reversed, shifted time axis: one launch
    a backward, bit-equal to the plain reverse recurrence, within GRAD_TOL
    (relative) of autograd through the plain forward."""
    from repro_torch.kernels.rglru import rglru_backward, rglru_reverse_ref

    a, b, h0 = _k6_inputs(shape, cuda, torch.float32, 12)
    a, b, h0 = (x.requires_grad_() for x in (a, b, h0))
    g = torch.Generator(device=cuda).manual_seed(13)
    dh = torch.randn(shape, generator=g, device=cuda)
    dlast = torch.randn((shape[0], shape[2]), generator=g, device=cuda)
    h, last = rglru_scan(a, b, h0)
    _build.reset_launches()
    got = torch.autograd.grad((h * dh).sum() + (last * dlast).sum(), (a, b, h0))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"rglru_scan_cuda": 1}
    # The plain reverse recurrence on the same glue.
    d = torch.cat([dh[:, :-1], (dh[:, -1] + dlast)[:, None]], dim=1)
    a_next = torch.cat([a.detach()[:, 1:], torch.zeros_like(a.detach()[:, :1])], dim=1)
    g_ref = rglru_reverse_ref(a_next, d)
    _equal(got[1], g_ref)
    for x, y in zip(got, rglru_backward(a.detach(), h.detach(), h0.detach(), dh, dlast)):
        _equal(x, y)
    h_p, last_p = rglru_seq_ref(a, b, h0)
    want = torch.autograd.grad((h_p * dh).sum() + (last_p * dlast).sum(), (a, b, h0))
    for x, y in zip(got, want):
        assert (x - y).abs().max().item() <= 1e-5 * y.abs().max().item()


def test_trainer_step_on_the_card_matches_the_cpu(cuda):
    """One RecurrentGemma and one RWKV-6 smoke-config train step (f32
    compute) on the card against the same step on the CPU, within 2e-4: K6
    runs forward and backward, K7 forward and its backward kernel."""
    import dataclasses

    from repro_torch.tree import tree_flatten, tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import optimizer_config_from_model
    from repro_torch.train import init_train_state, make_train_step

    for arch, seq, launches in (("recurrentgemma-2b", 32, {"rglru_scan_cuda": 4}),
                                ("rwkv6-3b", 128, {"wkv6_cuda": 2, "wkv6_bwd_cuda": 2})):
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
        batch = SyntheticLM(DataConfig(seq_len=seq, global_batch=4, vocab_size=cfg.vocab_size)
                            ).batch_at(0)
        step = make_train_step(cfg, optimizer_config_from_model(cfg))
        host = init_train_state(cfg, "cpu", seed=3)
        card = tree_map(lambda t: t.to(cuda), host)
        _build.reset_launches()
        _, _, m_card = step(*card, batch)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == launches  # two layers, forward + backward
        _, _, m_host = step(*host, batch)
        assert abs(float(m_card["loss"]) - float(m_host["loss"])) <= 2e-4
        for x, y in zip(tree_flatten(card)[0], tree_flatten(host)[0]):
            assert (x.cpu() - y).abs().max().item() <= 2e-4


# -- K7's backward -------------------------------------------------------------------


def _wkv_bwd_inputs(shape, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    b, _, h, n = shape
    return (*_wkv_inputs(shape, device, seed),
            torch.randn(shape, generator=g, device=device),
            torch.randn((b, h, n, n), generator=g, device=device))


@pytest.mark.parametrize("shape,chunk", [((1, 512, 40, 64), 64), ((4, 256, 40, 64), 64),
                                         ((2, 128, 3, 16), 16), ((3, 96, 2, 24), 32),
                                         ((65537, 16, 1, 8), 16)])
def test_k7_backward_matches_plain_and_autograd(cuda, shape, chunk):
    """wkv6_bwd_cuda against its plain version (every gradient within
    1e-5 * max|g| + 1e-6: the scans and the dlogw sums run in other
    orders), one counted call per launch plan (two past 65535 batch rows);
    the plain version within GRAD_TOL (relative) of autograd through
    wkv6_plain on the card."""
    r, k, v, w, u, s0, dy, ds = _wkv_bwd_inputs(shape, cuda, seed=sum(shape))
    _build.reset_launches()
    got = wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"wkv6_bwd_cuda": 1 if shape[0] <= 65535 else 2}
    plain = wkv6_backward_plain(r, k, v, w, u, s0, dy, ds, chunk=chunk)
    for x, y in zip(got, plain):
        assert x.shape == y.shape
        assert (x - y).abs().max().item() <= 1e-5 * y.abs().max().item() + 1e-6
    if shape[0] > 65535:
        return
    xs = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = wkv6_plain(*xs, chunk=chunk)
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), xs)
    for x, z in zip(plain, want):
        assert (x - z).abs().max().item() <= 1e-5 * z.abs().max().item()


def test_k7_backward_through_autograd_and_bad_input(cuda):
    """``wkv6`` under gradients runs K7 and its backward once each; the
    backward takes head sizes and chunks up to 64 and raises past them."""
    r, k, v, w, u, s0, dy, _ = _wkv_bwd_inputs((2, 64, 3, 16), cuda, seed=4)
    xs = [x.requires_grad_() for x in (r, k, v, w, u)]
    _build.reset_launches()
    y, _ = wkv6(*xs, s0, chunk=32)
    got = torch.autograd.grad((y * dy).sum(), xs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"wkv6_cuda": 1, "wkv6_bwd_cuda": 1}
    want = wkv6_backward_plain(*(x.detach() for x in xs), s0, dy, None, chunk=32)
    for x, z in zip(got, want):
        assert (x - z).abs().max().item() <= 1e-5 * z.abs().max().item() + 1e-6
    r2, k2, v2, w2, u2, s2, dy2, _ = _wkv_bwd_inputs((1, 128, 1, 96), cuda, seed=5)
    with pytest.raises(ValueError, match="at most 64"):
        wkv6_bwd_cuda(r2, k2, v2, w2, u2, s2, dy2, chunk=64)
    r3, k3, v3, w3, u3, s3, dy3, _ = _wkv_bwd_inputs((1, 128, 1, 8), cuda, seed=6)
    with pytest.raises(ValueError, match="at most 64"):
        wkv6_bwd_cuda(r3, k3, v3, w3, u3, s3, dy3, chunk=128)
    with pytest.raises(ValueError, match="device"):
        wkv6_bwd_cuda(r.detach(), k.detach(), v.detach(), w.detach(), u.detach(), s0,
                      dy.cpu())


@pytest.mark.parametrize("devices", [1, 2])
def test_weather_driver_inner_cuda_equals_lower_cuda(cuda, devices, tmp_path):
    """The port's weather driver with --inner cuda on the card: one N-output
    K2 launch a step on each rank, the gathered fields bit-equal to
    lower_cuda stepped in this process."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import torch_weather_simulation as drv

    from repro_torch.core import make_initial_field

    steps, depth, size = 5, 4, 64
    _build.reset_launches()
    res = drv.run(drv.parse_args(["--steps", str(steps), "--devices", str(devices),
                                  "--depth", str(depth), "--size", str(size)]))
    assert res["code"] == 0
    for launches in res["launches"]:
        assert launches["stencil_program_cuda"] == steps
        assert launches[KERNEL_N_OUT] == steps
    h0 = make_initial_field(depth, size, size, kind="gaussian", device=cuda)
    state = {"u": torch.zeros_like(h0), "v": torch.zeros_like(h0), "h": h0}
    step = ir.lower_cuda(ir.shallow_water_program())
    for _ in range(steps):
        state = step(state)
    _equal({f: torch.from_numpy(a) for f, a in res["final"].items()},
           {f: a.cpu() for f, a in state.items()})
