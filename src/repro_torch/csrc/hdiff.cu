// K1 hdiff_cuda and K3 hdiff_fixed_cuda: fused COSMO horizontal diffusion
// (Eq. 1-4) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  repro/kernels/hdiff/kernel.py::hdiff_pallas
//       (_hdiff_kernel, _hdiff_tile_math): float32 / bfloat16 in, float32 math;
//   K3  repro/kernels/hdiff/kernel.py::hdiff_fixed_pallas
//       (_hdiff_fixed_kernel): the paper's int32 fixed-point datapath.
//
// What bounds them on an H100: device-memory bytes. Each launch must read
// the (D, R, C) field once and write it once, 2 * D*R*C * itemsize bytes; at
// the COSMO 64x256x256 grid that is 33.6 MB, 10.0 us at 3.35 TB/s, against
// 72 operations per interior point = 0.29 G, 4.4 us at 67 TFLOP/s FP32 (K1).
// K3's operations are integer ones, and the SM has half as many INT32
// lanes as FP32 lanes (64 per clock): there the instructions per point
// (index arithmetic included) come close to the bytes.
//
// K1's and K3's design. A block owns a 64x64 output tile (a TC-column tile,
// TC in 64/32/16/8, from the planner for narrow grids or explicit tile
// rows) and loads it with its radius-2 halo into ONE shared-memory frame of
// 4-byte words (stencil_common.cuh, Frame): 16-byte cp.async copies of the
// aligned groups of float32 / int32 words, 16-byte loads of 8 bfloat16
// widened exactly to float32 as they are stored, word by word at the grid's
// unaligned edges and for unaligned inputs, zero outside the grid (those
// cells feed only ring outputs, which copy the input through).
// After the block's one barrier every thread walks a run of rows down one
// column: x's five-row window of its column, the three-row windows beside
// it and the Laplacian's three-row window live in registers, so a point
// costs five shared-memory reads, the Laplacian at (i + 1, j) and at
// (i, j -+ 1), the four (limited) fluxes and one store straight from
// registers. There is no Laplacian frame and no division inside a loop;
// the tile's column count (and, for K1, whether the limiter runs) is a
// template constant. Halo cells of neighbouring tiles come mostly from L2,
// so device memory sees the compulsory traffic and little more. The Pallas
// kernel's three-slab halo and full-width row blocks existed only because
// Pallas lacks overlapping BlockSpecs; here each block reads its own
// overlapping window and masks the ragged grid edge itself, so tiles need
// not divide the grid.
//
// K1's first form made three block-strided passes over a 32x64 tile (the
// frame loaded word by word, a Laplacian frame, the outputs) with a runtime
// / or % per word and per point: 34.7-35.2 us at 64x256x256 f32 and
// 617-619 us at 80x1024x1024. K3 had the same form until it took this
// design. The float kernel holds at most 32 registers (__launch_bounds__ with
// 8 blocks per SM; 40 otherwise), so eight blocks share an SM and the paper
// grid's 1024 tiles run in one wave.
//
// What bounds them now, on an H100 80GB HBM3 at 700 W (scripts/kernel_bench.py):
// K1 16.5-17.2 us at 64x256x256 f32, 58-61 % of its 10.0 us bytes bound,
// and 301-304 us at 80x1024x1024 (66 % of 200 us); bf16 13.8-14.4 us and
// 241-242 us. Its row loop is 49.5 SASS instructions a point (--sass): 29.75
// FP32 adds and multiplies, 6.75 limiter compares and selects, 5 shared
// loads and a store; about 6 us of issue on the paper grid. Copies of K1 with the work
// cut out show the two phases of a one-wave launch taking about 10 us each
// and overlapping only in part: the frame load with a copy-through store
// 10.2-10.4 us, the row walk and its stores without the load 9.6-9.9 us. K3
// 14.3-14.9 us (294-295 us), 67-70 % of the same bound; its row loop is 48.25
// instructions a point: 42 integer ones, 18 of them IMADs, which go to the
// FMA pipe, and 24 to the 64-lane ALU pipe; 5 shared loads and a store.
//
// Arithmetic order is _hdiff_tile_math's, compiled with -fmad=false, so a
// launch is bit-identical to the plain PyTorch version beside its wrapper
// (repro_torch/kernels/hdiff/kernel.py): the Laplacian 4*c - down - up -
// right - left at every point, the fluxes lap[+] - lap_c and lap_c -
// lap[-], the multiply-compare limiter (limit_flux: a product that
// underflows to +-0 keeps the flux, a NaN product zeroes it) and
// psi - coeff*((flx_r - flx_rm) + (flx_c - flx_cm)). K3 does every add, subtract and multiply
// in uint32 (wrapping as the JAX int32 datapath does; signed overflow is
// undefined in CUDA; wrapping arithmetic is associative, so any order gives
// the oracle's bits) and shifts the reinterpreted int32 arithmetically.
#include "stencil_common.cuh"

namespace {

using repro_torch::Frame;
using repro_torch::from_f32;
using repro_torch::kThreads;
using repro_torch::limit_flux;
using repro_torch::WordOf;

constexpr int HALO = 2;

// The frame shift, in words, of K1's and K3's frames (ir/plan.py::frame_layout).
static_assert(Frame<HALO, 64>::kShift == 2, "frame shift");

// At most 32 registers a thread, so eight 256-thread blocks share an SM and
// the paper grid's 1024 tiles run in one wave (40 registers would allow six).
template <typename T, int TC, bool LIMIT>
__global__ void __launch_bounds__(kThreads, 8)
hdiff_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int cols, int tile_r,
             int run, float coeff, int aligned) {
  using F = Frame<HALO, TC>;
  constexpr int LD = F::kLd;
  extern __shared__ __align__(16) uint32_t hdiff_smem[];
  uint32_t* const x = hdiff_smem + F::kShift;
  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * TC;
  F::load(reinterpret_cast<const typename WordOf<T>::type*>(in) + plane, x, rows, cols, r0, c0,
          tile_r, aligned);
  __syncthreads();

  // Each thread walks `run` rows down one column (as K3 below).
  const int j = threadIdx.x % TC, seg = threadIdx.x / TC;
  const int gc = c0 + j;
  const int i0 = seg * run, i1 = min(min(i0 + run, tile_r), rows - r0);
  if (gc >= cols || i0 >= i1) return;
  const bool col_in = gc >= HALO && gc < cols - HALO;
  const float* p = reinterpret_cast<const float*>(x) + (i0 + HALO) * LD + j + HALO;
  float c_m2 = p[-2 * LD], c_m1 = p[-LD], c_0 = p[0], c_p1 = p[LD];
  float l_m1 = p[-LD - 1], l_0 = p[-1], r_m1 = p[-LD + 1], r_0 = p[1];
  float lap_m1 = 4.0f * c_m1 - c_0 - c_m2 - r_m1 - l_m1;
  float lap_0 = 4.0f * c_0 - c_p1 - c_m1 - r_0 - l_0;
  int gr = r0 + i0;
  T* o = out + plane + static_cast<long long>(gr) * cols + gc;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const float c_p2 = p[2 * LD], l_p1 = p[LD - 1], r_p1 = p[LD + 1];
    const float ll = p[-2], rr = p[2];
    const float lap_p1 = 4.0f * c_p1 - c_p2 - c_0 - r_p1 - l_p1;
    const float lap_l = 4.0f * l_0 - l_p1 - l_m1 - c_0 - ll;
    const float lap_r = 4.0f * r_0 - r_p1 - r_m1 - rr - c_0;
    float flx_r = lap_p1 - lap_0, flx_rm = lap_0 - lap_m1;
    float flx_c = lap_r - lap_0, flx_cm = lap_0 - lap_l;
    if (LIMIT) {
      flx_r = limit_flux(flx_r, c_p1 - c_0);
      flx_rm = limit_flux(flx_rm, c_0 - c_m1);
      flx_c = limit_flux(flx_c, r_0 - c_0);
      flx_cm = limit_flux(flx_cm, c_0 - l_0);
    }
    const float val = c_0 - coeff * ((flx_r - flx_rm) + (flx_c - flx_cm));
    const bool interior = col_in && gr >= HALO && gr < rows - HALO;
    *o = from_f32<T>(interior ? val : c_0);
    c_m2 = c_m1, c_m1 = c_0, c_0 = c_p1, c_p1 = c_p2;
    l_m1 = l_0, l_0 = l_p1, r_m1 = r_0, r_0 = r_p1;
    lap_m1 = lap_0, lap_0 = lap_p1;
    p += LD, o += cols, ++gr;
  }
}

template <typename T, int TC>
int launch_hdiff(const void* in, void* out, int depth, int rows, int cols, int tile_r,
                 float coeff, int limit, cudaStream_t stream) {
  static size_t reserved[2] = {0, 0};
  const size_t smem = Frame<HALO, TC>::bytes(tile_r);
  const auto kernel = limit ? &hdiff_kernel<T, TC, true> : &hdiff_kernel<T, TC, false>;
  const int err = repro_torch::reserve_smem(kernel, smem, reserved[limit ? 1 : 0]);
  if (err) return err;
  constexpr int kSegments = kThreads / TC;
  const int run = (tile_r + kSegments - 1) / kSegments;
  const int aligned = repro_torch::rows_aligned<typename WordOf<T>::type>(in, cols);
  const dim3 grid((cols + TC - 1) / TC, (rows + tile_r - 1) / tile_r, depth);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(in), static_cast<T*>(out),
                                           rows, cols, tile_r, run, coeff, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hdiff(const void* in, void* out, int depth, int rows, int cols, int tile_r,
                   int tile_c, float coeff, int limit, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (tile_c) {  // the planner's column tiles (repro_torch/ir/plan.py FIXED_TILE_COLS)
    case 64: return launch_hdiff<T, 64>(in, out, depth, rows, cols, tile_r, coeff, limit, st);
    case 32: return launch_hdiff<T, 32>(in, out, depth, rows, cols, tile_r, coeff, limit, st);
    case 16: return launch_hdiff<T, 16>(in, out, depth, rows, cols, tile_r, coeff, limit, st);
    case 8: return launch_hdiff<T, 8>(in, out, depth, rows, cols, tile_r, coeff, limit, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- K3 -----------------------------------------------------------------------

// The Eq. 2-3 limiter of the int32 datapath: keep the flux d where d * g <= 0
// in exact arithmetic, i.e. where g is zero or the signs differ. The JAX
// oracle spells it d == 0 || g == 0 || (d > 0) != (g > 0); a zero d gives a
// zero either way, and for non-zero d and g the signs differ exactly when
// the sign bit of d ^ g is set. Same truth table, three operations.
__device__ __forceinline__ uint32_t limit_fixed(uint32_t d, uint32_t g) {
  return (g == 0u || static_cast<int32_t>(d ^ g) < 0) ? d : 0u;
}

// K3's frame: int32 words, shifted so grid column c0 starts a 16-byte group.
constexpr int kFixedShift = 2;  // (-HALO) mod 4
static_assert(kFixedShift == Frame<HALO, 8>::kShift, "K3's frame shift");

template <int TC>
__global__ void __launch_bounds__(kThreads)
hdiff_fixed_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int rows,
                   int cols, int tile_r, int run, int coeff_num, int coeff_shift,
                   int aligned) {
  using F = Frame<HALO, TC>;
  constexpr int LD = F::kLd;  // frame row stride, a multiple of 4 words
  extern __shared__ __align__(16) uint32_t fixed_smem_raw[];
  uint32_t* const x = fixed_smem_raw + kFixedShift;
  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * TC;
  F::load(reinterpret_cast<const uint32_t*>(in) + plane, x, rows, cols, r0, c0, tile_r,
          aligned);
  __syncthreads();

  // Each thread walks `run` rows down one column: x's five-row window of its
  // column, the three-row windows of the columns beside it and the
  // Laplacian's three-row window stay in registers; per row it reads five
  // frame words and computes the Laplacian at (i + 1, j) and at (i, j -+ 1).
  const int j = threadIdx.x % TC, seg = threadIdx.x / TC;
  const int gc = c0 + j;
  const int i0 = seg * run, i1 = min(min(i0 + run, tile_r), rows - r0);
  if (gc >= cols || i0 >= i1) return;
  const bool col_in = gc >= HALO && gc < cols - HALO;
  const uint32_t num = static_cast<uint32_t>(coeff_num);
  const uint32_t* p = x + (i0 + HALO) * LD + j + HALO;
  uint32_t c_m2 = p[-2 * LD], c_m1 = p[-LD], c_0 = p[0], c_p1 = p[LD];
  uint32_t l_m1 = p[-LD - 1], l_0 = p[-1], r_m1 = p[-LD + 1], r_0 = p[1];
  uint32_t lap_m1 = 4u * c_m1 - c_0 - c_m2 - r_m1 - l_m1;
  uint32_t lap_0 = 4u * c_0 - c_p1 - c_m1 - r_0 - l_0;
  int gr = r0 + i0;
  int32_t* o = out + plane + static_cast<long long>(gr) * cols + gc;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const uint32_t c_p2 = p[2 * LD], l_p1 = p[LD - 1], r_p1 = p[LD + 1];
    const uint32_t ll = p[-2], rr = p[2];
    const uint32_t lap_p1 = 4u * c_p1 - c_p2 - c_0 - r_p1 - l_p1;
    const uint32_t lap_l = 4u * l_0 - l_p1 - l_m1 - c_0 - ll;
    const uint32_t lap_r = 4u * r_0 - r_p1 - r_m1 - rr - c_0;
    const uint32_t flx_r = limit_fixed(lap_p1 - lap_0, c_p1 - c_0);
    const uint32_t flx_rm = limit_fixed(lap_0 - lap_m1, c_0 - c_m1);
    const uint32_t flx_c = limit_fixed(lap_r - lap_0, r_0 - c_0);
    const uint32_t flx_cm = limit_fixed(lap_0 - lap_l, c_0 - l_0);
    const uint32_t total = (flx_r - flx_rm) + (flx_c - flx_cm);
    const int32_t scaled = static_cast<int32_t>(total * num) >> coeff_shift;
    const bool interior = col_in && gr >= HALO && gr < rows - HALO;
    *o = static_cast<int32_t>(interior ? c_0 - static_cast<uint32_t>(scaled) : c_0);
    c_m2 = c_m1, c_m1 = c_0, c_0 = c_p1, c_p1 = c_p2;
    l_m1 = l_0, l_0 = l_p1, r_m1 = r_0, r_0 = r_p1;
    lap_m1 = lap_0, lap_0 = lap_p1;
    p += LD, o += cols, ++gr;
  }
}

template <int TC>
int launch_fixed(const int32_t* in, int32_t* out, int depth, int rows, int cols, int tile_r,
                 int coeff_num, int coeff_shift, cudaStream_t stream) {
  static size_t reserved = 0;
  const size_t smem = Frame<HALO, TC>::bytes(tile_r);
  const int err = repro_torch::reserve_smem(hdiff_fixed_kernel<TC>, smem, reserved);
  if (err) return err;
  constexpr int kSegments = kThreads / TC;
  const int run = (tile_r + kSegments - 1) / kSegments;
  const int aligned = repro_torch::rows_aligned<uint32_t>(in, cols);
  const dim3 grid((cols + TC - 1) / TC, (rows + tile_r - 1) / tile_r, depth);
  hdiff_fixed_kernel<TC><<<grid, kThreads, smem, stream>>>(
      in, out, rows, cols, tile_r, run, coeff_num, coeff_shift, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/hdiff/kernel.py.
// Each returns the CUDA error code of the launch (0 on success).
extern "C" int hdiff_f32(const void* in, void* out, int depth, int rows, int cols,
                         int tile_r, int tile_c, float coeff, int limit, void* stream) {
  return dispatch_hdiff<float>(in, out, depth, rows, cols, tile_r, tile_c, coeff, limit,
                               stream);
}

extern "C" int hdiff_bf16(const void* in, void* out, int depth, int rows, int cols,
                          int tile_r, int tile_c, float coeff, int limit, void* stream) {
  return dispatch_hdiff<__nv_bfloat16>(in, out, depth, rows, cols, tile_r, tile_c, coeff,
                                       limit, stream);
}

extern "C" int hdiff_fixed_i32(const void* in, void* out, int depth, int rows, int cols,
                               int tile_r, int tile_c, int coeff_num, int coeff_shift,
                               void* stream) {
  const auto* i = static_cast<const int32_t*>(in);
  auto* o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (tile_c) {  // the planner's column tiles (repro_torch/ir/plan.py FIXED_TILE_COLS)
    case 64: return launch_fixed<64>(i, o, depth, rows, cols, tile_r, coeff_num, coeff_shift, st);
    case 32: return launch_fixed<32>(i, o, depth, rows, cols, tile_r, coeff_num, coeff_shift, st);
    case 16: return launch_fixed<16>(i, o, depth, rows, cols, tile_r, coeff_num, coeff_shift, st);
    case 8: return launch_fixed<8>(i, o, depth, rows, cols, tile_r, coeff_num, coeff_shift, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
