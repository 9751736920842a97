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
// K1's design: one block per (plane, row tile, column tile) loads its tile
// plus a radius-2 halo into shared memory once (halo cells of neighbouring
// tiles come mostly from L2), computes the Laplacian once per point into a
// second shared-memory frame, and writes each output once, so device memory
// sees the compulsory traffic and little more. The Pallas kernel's
// three-slab halo and full-width row blocks existed only because Pallas
// lacks overlapping BlockSpecs; here each block reads its own overlapping
// window and masks the ragged grid edge itself, so tiles need not divide
// the grid. Out-of-grid halo cells are zero-filled: they feed only
// boundary-ring outputs, which copy the input through.
//
// K3's design. Its first form was K1's with int32 words: three block-strided
// passes (load, Laplacian frame, output) with a runtime integer / and % per
// point in each, about as many instructions as the stencil itself. Now a
// block owns a 64x64 tile (a TC-column tile, TC in 64/32/16/8, from the
// planner for narrow grids or explicit tile rows), loads the tile and its
// halo into ONE int32 frame by 16-byte cp.async copies of the aligned
// 4-column groups (word by word at the grid's unaligned edges), and after
// one barrier every thread walks a run of rows down one column: x's
// five-row window of its column, the three-row windows beside it and the
// Laplacian's three-row window live in registers, so a point costs five
// shared-memory reads, the Laplacian at (i + 1, j) and at (i, j -+ 1), the
// four limited fluxes and one store straight from registers. There is no
// Laplacian frame and no division inside a loop; the tile's column count
// is a template constant.
//
// What bounds K3 now, on an H100 80GB HBM3 at 700 W (scripts/kernel_bench.py):
// 14.6-15.0 us at 64x256x256 (36.2-36.7 before), 67-68 % of its 10.0 us
// bytes bound; 295 us at 80x1024x1024 (638-643 before), 68 % of 200 us.
// Its row loop is 48.25 SASS instructions a point (--sass): 42 integer
// ones, 18 of them IMADs, which issue to the FMA pipe, and 24 to the
// 64-lane ALU pipe; 5 shared loads and a store. At 64 INT32 lanes per SM
// and clock the 42 would take 10.5 us on the paper grid, split across the
// two pipes about 6 us; the rest (the load phase before the block's one
// barrier, the windows' set-up per run) is not measured apart.
//
// Arithmetic order is _hdiff_tile_math's, compiled with -fmad=false, so a
// launch is bit-identical to the plain PyTorch version beside its wrapper
// (repro_torch/kernels/hdiff/kernel.py). K3 does every add, subtract and
// multiply in uint32 (wrapping as the JAX int32 datapath does; signed
// overflow is undefined in CUDA; wrapping arithmetic is associative, so
// any order gives the oracle's bits) and shifts the reinterpreted int32
// arithmetically.
#include "stencil_common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::kThreads;
using repro_torch::to_f32;

constexpr int HALO = 2;

__device__ __forceinline__ bool in_ring(int gr, int gc, int rows, int cols) {
  return gr < HALO || gr >= rows - HALO || gc < HALO || gc >= cols - HALO;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hdiff_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int cols,
             int tile_r, int tile_c, float coeff, int limit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fr = tile_r + 2 * HALO, fc = tile_c + 2 * HALO;
  float* const x = reinterpret_cast<float*>(smem_raw);  // tile + radius-2 halo
  float* const lap = x + fr * fc;                       // Laplacian, same frame
  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * tile_c;

  for (int q = threadIdx.x; q < fr * fc; q += blockDim.x) {
    const int i = q / fc, j = q - i * fc;
    const int gr = r0 + i - HALO, gc = c0 + j - HALO;
    x[q] = (gr >= 0 && gr < rows && gc >= 0 && gc < cols)
               ? to_f32(in[plane + static_cast<long long>(gr) * cols + gc])
               : 0.0f;
  }
  __syncthreads();

  // Laplacian on frame rows/cols [1, f-1): 4*c - down - up - right - left.
  const int lr = fr - 2, lc = fc - 2;
  for (int q = threadIdx.x; q < lr * lc; q += blockDim.x) {
    const int i = 1 + q / lc, j = 1 + q % lc;
    const int p = i * fc + j;
    lap[p] = 4.0f * x[p] - x[p + fc] - x[p - fc] - x[p + 1] - x[p - 1];
  }
  __syncthreads();

  for (int q = threadIdx.x; q < tile_r * tile_c; q += blockDim.x) {
    const int ti = q / tile_c, tj = q - ti * tile_c;
    const int gr = r0 + ti, gc = c0 + tj;
    if (gr >= rows || gc >= cols) continue;
    const int p = (ti + HALO) * fc + tj + HALO;
    const float psi_c = x[p];
    float val = psi_c;
    if (!in_ring(gr, gc, rows, cols)) {
      const float lap_c = lap[p];
      float flx_r = lap[p + fc] - lap_c;
      float flx_rm = lap_c - lap[p - fc];
      float flx_c = lap[p + 1] - lap_c;
      float flx_cm = lap_c - lap[p - 1];
      if (limit) {
        flx_r = (flx_r * (x[p + fc] - psi_c) <= 0.0f) ? flx_r : 0.0f;
        flx_rm = (flx_rm * (psi_c - x[p - fc]) <= 0.0f) ? flx_rm : 0.0f;
        flx_c = (flx_c * (x[p + 1] - psi_c) <= 0.0f) ? flx_c : 0.0f;
        flx_cm = (flx_cm * (psi_c - x[p - 1]) <= 0.0f) ? flx_cm : 0.0f;
      }
      val = psi_c - coeff * ((flx_r - flx_rm) + (flx_c - flx_cm));
    }
    out[plane + static_cast<long long>(gr) * cols + gc] = from_f32<T>(val);
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

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The int32 frame of a TR x TC tile: (TR + 4) rows of TC + 4 words (TC a
// multiple of 4), shifted by kFixedShift words so frame column HALO, grid
// column c0 (a multiple of 4), starts a 16-byte group.
constexpr int kFixedShift = 2;  // (-HALO) mod 4

inline size_t fixed_smem(int tile_r, int tile_c) {
  const size_t words = kFixedShift + static_cast<size_t>(tile_r + 2 * HALO) * (tile_c + 2 * HALO);
  return (words + 3) / 4 * 16;
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
hdiff_fixed_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int rows,
                   int cols, int tile_r, int run, int coeff_num, int coeff_shift,
                   int aligned) {
  constexpr int LD = TC + 2 * HALO;  // frame row stride, a multiple of 4 words
  constexpr int NQ = TC / 4;         // aligned 4-word groups per frame row
  constexpr int PER_ROW = NQ + 4;    // ... plus two edge words on each side
  extern __shared__ __align__(16) uint32_t fixed_smem_raw[];
  uint32_t* const x = fixed_smem_raw + kFixedShift;
  const int fr = tile_r + 2 * HALO;
  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * TC;

  // The tile plus its radius-2 halo; zero outside the grid (those cells
  // feed only ring outputs, which copy the input through).
  for (int q = threadIdx.x; q < fr * PER_ROW; q += kThreads) {
    const int i = q / PER_ROW, u = q - i * PER_ROW;
    const int gr = r0 + i - HALO;
    const bool row_ok = gr >= 0 && gr < rows;
    const int32_t* const src = in + plane + static_cast<long long>(row_ok ? gr : 0) * cols;
    if (u < NQ) {
      const int gc = c0 + 4 * u;
      uint32_t* const dst = x + i * LD + HALO + 4 * u;
      if (aligned && row_ok && gc + 4 <= cols) {
        copy16(dst, src + gc);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[e] = row_ok && gc + e < cols ? static_cast<uint32_t>(src[gc + e]) : 0u;
        }
      }
    } else {
      const int v = u - NQ, j = v < 2 ? v : TC + v;  // frame columns 0, 1, TC+2, TC+3
      const int gc = c0 + j - HALO;
      x[i * LD + j] = row_ok && gc >= 0 && gc < cols ? static_cast<uint32_t>(src[gc]) : 0u;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
  const size_t smem = fixed_smem(tile_r, TC);
  const int err = repro_torch::reserve_smem(hdiff_fixed_kernel<TC>, smem, reserved);
  if (err) return err;
  constexpr int kSegments = kThreads / TC;
  const int run = (tile_r + kSegments - 1) / kSegments;
  const int aligned = cols % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const dim3 grid((cols + TC - 1) / TC, (rows + tile_r - 1) / tile_r, depth);
  hdiff_fixed_kernel<TC><<<grid, kThreads, smem, stream>>>(
      in, out, rows, cols, tile_r, run, coeff_num, coeff_shift, aligned);
  return static_cast<int>(cudaGetLastError());
}

inline size_t tile_smem(int tile_r, int tile_c) {
  return 2 * static_cast<size_t>(tile_r + 2 * HALO) * (tile_c + 2 * HALO) * 4;
}

inline dim3 tile_grid(int depth, int rows, int cols, int tile_r, int tile_c) {
  return dim3((cols + tile_c - 1) / tile_c, (rows + tile_r - 1) / tile_r, depth);
}

template <typename T>
int launch_hdiff(const void* in, void* out, int depth, int rows, int cols, int tile_r,
                 int tile_c, float coeff, int limit, void* stream) {
  static size_t reserved = 0;
  const size_t smem = tile_smem(tile_r, tile_c);
  const int err = repro_torch::reserve_smem(hdiff_kernel<T>, smem, reserved);
  if (err) return err;
  hdiff_kernel<T><<<tile_grid(depth, rows, cols, tile_r, tile_c), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, cols, tile_r, tile_c, coeff,
      limit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/hdiff/kernel.py.
// Each returns the CUDA error code of the launch (0 on success).
extern "C" int hdiff_f32(const void* in, void* out, int depth, int rows, int cols,
                         int tile_r, int tile_c, float coeff, int limit, void* stream) {
  return launch_hdiff<float>(in, out, depth, rows, cols, tile_r, tile_c, coeff, limit,
                             stream);
}

extern "C" int hdiff_bf16(const void* in, void* out, int depth, int rows, int cols,
                          int tile_r, int tile_c, float coeff, int limit, void* stream) {
  return launch_hdiff<__nv_bfloat16>(in, out, depth, rows, cols, tile_r, tile_c, coeff,
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
