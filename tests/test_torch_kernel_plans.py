"""The launch planners of K6 (``rglru_scan_cuda``), of the one-frame
stencil kernels K3 (``hdiff_fixed_cuda``), K1 (``hdiff_cuda``) and K4
(``stencil2d_cuda``) and of K5''s spans (``stencil_program_1d_cuda``), on
the CPU: what grid and shared memory they ask of
the card, how they treat tiny and huge shapes, and that the constants they
share with the CUDA sources agree with those sources."""

import re

import pytest

from repro_torch.ir.plan import (
    FIXED_SHIFT,
    FIXED_TILE_COLS,
    SMEM_BLOCK_LIMIT,
    TilePlan,
    THREADS,
    VECTORS_1D,
    fixed_tile_bytes,
    frame_layout,
    plan_fixed_tile,
    plan_tile_1d,
)
from repro_torch.kernels import _build
from repro_torch.kernels.hdiff import kernel as k13
from repro_torch.kernels.rglru import kernel as k6
from repro_torch.kernels.stencil2d import kernel as k45
from repro_torch.kernels.wkv6 import kernel as k7

H100_SMS = 132


@pytest.mark.parametrize("itemsize", [4, 2])
def test_k6_serving_shape_fills_the_card_in_one_wave(itemsize):
    plan = k6.plan_scan(1, 512, 2560, itemsize, H100_SMS, vec=True)
    assert plan.tile == 20 and plan.tile % k6.GROUP == 0
    assert plan.blocks == 128 and 0.9 * H100_SMS <= plan.blocks <= H100_SMS
    assert plan.stage_steps == k6.STAGE_STEPS
    assert plan.smem == k6.STAGES * 2 * 64 * k6.MAX_TILE * itemsize


@pytest.mark.parametrize("shape", [(1, 512, 2560), (8, 4096, 2560), (4, 1, 7), (3, 200, 33),
                                   (2, 37, 100), (1, 1, 1), (64, 64, 4096), (1, 100_000, 4)])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("vec", [True, False])
def test_k6_plan_fits_shared_memory_and_covers_the_width(shape, itemsize, vec):
    batch, steps, width = shape
    if vec and width % k6.GROUP:
        with pytest.raises(ValueError, match="multiple of 4"):
            k6.plan_scan(batch, steps, width, itemsize, H100_SMS, vec=vec)
        return
    plan = k6.plan_scan(batch, steps, width, itemsize, H100_SMS, vec=vec)
    assert 1 <= plan.tile <= k6.MAX_TILE
    assert not vec or plan.tile % k6.GROUP == 0
    assert 1 <= plan.stage_steps <= min(k6.STAGE_STEPS, steps)
    assert plan.smem == k6.STAGES * 2 * plan.stage_steps * k6.MAX_TILE * itemsize
    assert plan.smem <= SMEM_BLOCK_LIMIT
    assert plan.blocks == batch * -(-width // plan.tile)
    # About one wave: a smaller tile would not cut the grid below the SMs'
    # count, unless the tile is already the smallest the path allows.
    unit = k6.GROUP if vec else 1
    assert plan.tile == k6.MAX_TILE or plan.tile == unit or \
        batch * -(-width // (plan.tile - unit)) > H100_SMS


def test_k6_large_batch_takes_full_warp_tiles():
    plan = k6.plan_scan(8, 4096, 2560, 4, H100_SMS, vec=True)
    assert (plan.tile, plan.blocks, plan.smem) == (32, 640, 65536)


def test_k6_plan_clamps_tiny_shapes_and_rejects_huge_ones():
    assert k6.plan_scan(1, 0, 8, 4, H100_SMS, vec=True).stage_steps == 1
    assert k6.plan_scan(1, 3, 2, 4, H100_SMS, vec=False).tile == 1
    assert k6.plan_scan(1, 3, 8, 4, 1, vec=False).tile == 8  # one SM: one block
    with pytest.raises(ValueError, match="grid"):
        k6.plan_scan(65536, 1, 4, 4, H100_SMS, vec=True)
    with pytest.raises(ValueError, match="int32 indexing"):
        k6.plan_scan(1, 2**20, 2**11, 4, H100_SMS, vec=True)
    with pytest.raises(ValueError, match="no lanes"):
        k6.plan_scan(1, 4, 4, 4, 0, vec=True)
    with pytest.raises(ValueError, match="no lanes"):
        k6.plan_scan(1, 4, 4, 8, H100_SMS, vec=True)


@pytest.mark.parametrize("batch,cuts", [(1, [(0, 1)]), (65535, [(0, 65535)]),
                                        (65537, [(0, 65535), (65535, 2)]),
                                        (131071, [(0, 65535), (65535, 65535), (131070, 1)])])
def test_k6_cuts_a_batch_past_the_grid_into_launches(batch, cuts):
    """The batch is the grid's y dimension (at most 65535 blocks): the
    wrapper launches consecutive runs of rows, each planned alone."""
    launches = k6.plan_launches(batch, 4, 32, 4, H100_SMS, vec=True)
    assert [(b0, nb) for b0, nb, _ in launches] == cuts
    for _, nb, plan in launches:
        assert plan == k6.plan_scan(nb, 4, 32, 4, H100_SMS, vec=True)
    with pytest.raises(ValueError, match="int32 indexing"):
        k6.plan_launches(65537, 2**20, 2**11, 4, H100_SMS, vec=True)


def test_k7_cuts_batch_and_heads_past_the_grid_into_calls():
    """K7's grid is (chunks, heads, batch): each of batch and heads is cut
    into runs of at most 65535, every pair one call."""
    assert k7.plan_launches(4, 40) == [(0, 4, 0, 40)]
    assert k7.plan_launches(65537, 40) == [(0, 65535, 0, 40), (65535, 2, 0, 40)]
    assert k7.plan_launches(1, 65537) == [(0, 1, 0, 65535), (0, 1, 65535, 2)]
    assert len(k7.plan_launches(65536, 65536)) == 4


def test_k6_constants_match_the_cuda_source():
    text = k6.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kStages"]) == k6.STAGES
    assert int(consts["kMaxTile"]) == k6.MAX_TILE
    assert int(consts["kStageSteps"]) == k6.STAGE_STEPS
    # Every argument the wrapper passes is bound: 5 pointers, 6 ints, the stream.
    assert text.count("int batch, int steps, int width, int tile, int stage_steps, int vec") == 3


@pytest.mark.parametrize("rows,cols,want", [
    (256, 256, (64, 64)), (1024, 1024, (64, 64)), (250, 190, (64, 64)), (67, 129, (64, 64)),
    (8, 8, (8, 8)), (37, 30, (37, 32)), (70, 12, (64, 16)), (5, 9, (5, 16)), (3, 64, (3, 64)),
])
def test_k3_default_tiles(rows, cols, want):
    plan = plan_fixed_tile(rows, cols)
    assert (plan.rows, plan.cols) == want
    assert plan.cols in FIXED_TILE_COLS and plan.buffers == 1
    assert fixed_tile_bytes(plan.rows, plan.cols) <= SMEM_BLOCK_LIMIT
    # 64x64: one 18.5 KB frame, so eight 256-thread blocks share an SM.
    assert fixed_tile_bytes(64, 64) == 18_512


@pytest.mark.parametrize("block_rows", [4, 16, 64, 256, 1024, 4096])
def test_k3_block_rows_fix_the_rows_and_shrink_the_columns(block_rows):
    plan = plan_fixed_tile(4096, 4096, block_rows=block_rows)
    assert plan.rows == block_rows
    assert fixed_tile_bytes(plan.rows, plan.cols) <= SMEM_BLOCK_LIMIT
    wider = [c for c in FIXED_TILE_COLS if c > plan.cols]
    assert all(fixed_tile_bytes(block_rows, c) > SMEM_BLOCK_LIMIT for c in wider)


def test_k3_plan_raises_when_no_tile_fits():
    with pytest.raises(ValueError, match="fewer block rows"):
        plan_fixed_tile(10**6, 64, block_rows=10**5)
    with pytest.raises(ValueError, match="no points"):
        plan_fixed_tile(0, 64)
    with pytest.raises(ValueError, match="at least one row"):
        plan_fixed_tile(64, 64, block_rows=0)


def test_k3_column_tiles_match_the_cuda_source():
    text = k13.SOURCE.read_text()
    cases = [int(c) for c in re.findall(r"case (\d+): return launch_fixed<\1>", text)]
    assert sorted(cases) == sorted(FIXED_TILE_COLS)
    assert all(c % 4 == 0 for c in FIXED_TILE_COLS)
    assert re.search(rf"constexpr int kFixedShift = {FIXED_SHIFT};", text)


@pytest.mark.parametrize("rows,cols,block_rows,want", [
    (256, 256, None, TilePlan(64, 64, 2, 1)),  # the paper grid
    (1024, 1024, None, TilePlan(64, 64, 2, 1)),
    (250, 190, None, TilePlan(64, 64, 2, 1)),  # ragged both ways
    (8, 8, None, TilePlan(8, 8, 2, 1)),  # tiny: rows clipped, narrowest columns
    (5, 9, None, TilePlan(5, 16, 2, 1)),
    (37, 30, None, TilePlan(37, 32, 2, 1)),
    (64, 96, 16, TilePlan(16, 64, 2, 1)),  # explicit block_rows fix the rows
    (4096, 64, 2048, TilePlan(2048, 16, 2, 1)),  # ... and shrink the columns
    (10**5, 64, 4838, TilePlan(4838, 8, 2, 1)),  # the largest tile that fits
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_tile_plan(rows, cols, block_rows, want, dtype):
    """K1 holds one float32 frame per 64x64 tile (bfloat16 widened as it
    loads), planned as K3's; a tile one row taller than the largest raises."""
    import torch

    assert plan_fixed_tile(rows, cols, block_rows=block_rows) == want
    x = torch.empty((1, rows, cols), dtype=getattr(torch, dtype))
    assert k13._tile(x, block_rows) == want
    assert fixed_tile_bytes(want.rows, want.cols) <= SMEM_BLOCK_LIMIT
    with pytest.raises(ValueError, match="fewer block rows"):
        k13._tile(x, 4839)


@pytest.mark.parametrize("rows,cols,block_rows,want", [
    (256, 256, None, TilePlan(64, 64, 1, 1)),
    (250, 190, None, TilePlan(64, 64, 1, 1)),
    (3, 3, None, TilePlan(3, 8, 1, 1)),
    (70, 12, None, TilePlan(64, 16, 1, 1)),
    (64, 96, 1, TilePlan(1, 64, 1, 1)),  # one-row tiles still plan
    (4096, 96, 4096, TilePlan(4096, 8, 1, 1)),
    (10**5, 64, 4840, TilePlan(4840, 8, 1, 1)),  # the largest tile that fits
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_tile_plan(rows, cols, block_rows, want, dtype):
    """K4 holds one float32 frame with a radius-1 halo per 64x64 tile."""
    import torch

    assert plan_fixed_tile(rows, cols, halo=1, block_rows=block_rows) == want
    x = torch.empty((2, rows, cols), dtype=getattr(torch, dtype))
    assert k45._tile(x, block_rows) == want
    assert fixed_tile_bytes(want.rows, want.cols, halo=1) <= SMEM_BLOCK_LIMIT
    with pytest.raises(ValueError, match="fewer block rows"):
        k45._tile(x, 4841)


@pytest.mark.parametrize("halo,ld,shift,tile_bytes", [(2, 68, 2, 18_512), (1, 68, 3, 17_968)])
def test_frame_layout_of_a_64x64_tile(halo, ld, shift, tile_bytes):
    assert frame_layout(64, halo) == (ld, shift)
    assert fixed_tile_bytes(64, 64, halo) == tile_bytes
    # Frame column `halo`, grid column c0, starts a 16-byte group.
    assert (shift + halo) % 4 == 0 and ld % 4 == 0


@pytest.mark.parametrize("module,launcher,halo_name", [
    (k13, "launch_hdiff", "HALO"), (k45, "launch_stencil2d", "R"),
])
def test_k1_k4_column_tiles_and_frame_shifts_match_the_cuda_source(module, launcher, halo_name):
    text = module.SOURCE.read_text()
    cases = [int(c) for c in re.findall(rf"case (\d+): return {launcher}<T, \1>", text)]
    assert sorted(cases) == sorted(FIXED_TILE_COLS)
    halo = int(re.search(rf"constexpr int {halo_name} = (\d+);", text).group(1))
    assert halo == module.HALO
    tc, shift = re.search(rf"static_assert\(Frame<{halo_name}, (\d+)>::kShift == (\d+)",
                          text).groups()
    assert frame_layout(int(tc), halo)[1] == int(shift)
    # The shared header lays frames out by frame_layout's formula.
    common = (_build.CSRC / "stencil_common.cuh").read_text()
    assert "kShift = (4 - H % 4) % 4;" in common
    assert "kLd = (TC + 2 * H + 3) / 4 * 4;" in common


def test_k3_block_rows_validation_is_unchanged_on_the_cpu():
    import torch

    from repro_torch.kernels.hdiff import hdiff_fixed

    x = torch.zeros((1, 30, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        hdiff_fixed(x, block_rows=8)
    with pytest.raises(ValueError, match=">= 4"):
        hdiff_fixed(x, block_rows=2)
    _build.reset_launches()
    assert torch.equal(hdiff_fixed(x, block_rows=15), x)
    assert _build.LAUNCHES == {}


@pytest.mark.parametrize("halo,steps,vectors,buffers", [
    (0, 1, 1, 1), (1, 1, 1, 1), (4, 1, 1, 1), (2, 2, 1, 0), (3, 3, 1, 0), (4, 2, 1, 0),
    (5, 2, 1, 2), (6, 3, 1, 2), (256, 1, 1, 1), (257, 1, 2, 1), (300, 2, 2, 2),
    (513, 4, 4, 2), (1024, 1, 4, 1)])
def test_k5_prime_span_plan(halo, steps, vectors, buffers):
    """A chain of sweeps whose halo fits one float32 vector takes warp spans
    (no frame); anything else block spans: the fewest 16-byte vectors a
    thread whose float32 span keeps the halo, in whole vectors, to a
    quarter of the span at each end (so in bfloat16, whose vectors hold
    twice the points, too), with one frame, or two for a chain of sweeps."""
    plan = plan_tile_1d(halo=halo, steps=steps)
    assert plan == TilePlan(1, vectors, halo, buffers)
    threads = THREADS if buffers else 32
    for points in (4, 8):  # float32, bfloat16
        span, ends = threads * points * vectors, -(-halo // points) * points
        assert 4 * ends <= span
    assert vectors == VECTORS_1D[0] or 4 * -(-halo // 4) * 4 > THREADS * 4 * (vectors // 2)


def test_k5_prime_span_plan_rejects_what_no_span_holds():
    with pytest.raises(ValueError, match="deeper than"):
        plan_tile_1d(halo=1025, steps=1)
    with pytest.raises(ValueError, match="steps"):
        plan_tile_1d(halo=1, steps=0)
    with pytest.raises(ValueError, match="halo"):
        plan_tile_1d(halo=-1, steps=1)


SM_SHARED = 228 * 1024  # shared memory of one H100 SM
BLOCK_RESERVED = 1024  # the runtime keeps 1 KB of it a block


def test_k7_backward_takes_two_blocks_an_sm_at_the_trainer_shape():
    """At head size and chunk 64 (rwkv6-3b) a block of K7's backward takes
    112,896 bytes, so two blocks share an SM."""
    assert k7.bwd_smem_bytes(64, 64) == 112_896
    assert 2 * (k7.bwd_smem_bytes(64, 64) + BLOCK_RESERVED) <= SM_SHARED
    assert 3 * (k7.bwd_smem_bytes(64, 64) + BLOCK_RESERVED) > SM_SHARED


@pytest.mark.parametrize("n", [1, 8, 15, 16, 17, 24, 32, 40, 48, 63, 64])
def test_k7_backward_fits_one_block_at_every_size(n):
    for chunk in range(1, k7.MAX_BWD_DIM + 1):
        smem = k7.bwd_smem_bytes(n, chunk)
        assert 0 < smem <= k7.MAX_SMEM
        assert smem <= k7.bwd_smem_bytes(k7.MAX_BWD_DIM, k7.MAX_BWD_DIM)
        assert smem % 16 == 0  # every region starts a 16-byte cp.async group


@pytest.mark.parametrize("name,pattern,value", [
    ("kMaxDim", r"constexpr int kMaxDim = (\d+);", k7.MAX_BWD_DIM),
    ("padding", r"np\(\(n \+ (\d+)\) / 16 \* 16\)", k7.PAD - 1),
    ("padding", r"np\(\(n \+ 15\) / (\d+) \* 16\)", k7.PAD),
])
def test_k7_backward_constants_match_the_cuda_source(name, pattern, value):
    text = k7.BWD_SOURCE.read_text()
    assert int(re.search(pattern, text).group(1)) == value, name


def test_k7_backward_shared_memory_formula_matches_the_cuda_source():
    """``bwd_smem_bytes`` mirrors ``Geometry`` of ``csrc/wkv6_bwd.cu``; the
    block size is the shared header's."""
    text = k7.BWD_SOURCE.read_text()
    common = (_build.CSRC / "wkv6_common.cuh").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", common).group(1)) == k7.THREADS
    assert '#include "wkv6_common.cuh"' in text
    assert '#include "wkv6_common.cuh"' in k7.SOURCE.read_text()
    assert "lr(np + 4), lv(np + 8), lt(cp + 8)" in text
    assert "int region() const { return d * (d + 8); }" in text
    assert "int chunk_floats() const { return 4 * cp * lv + np; }" in text
    assert "return 6 * region() + kThreads + 2 * cp + 3 * np;" in text
