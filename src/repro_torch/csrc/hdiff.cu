// K1 hdiff_cuda and K3 hdiff_fixed_cuda: fused COSMO horizontal diffusion
// (Eq. 1-4) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  repro/kernels/hdiff/kernel.py::hdiff_pallas
//       (_hdiff_kernel, _hdiff_tile_math): float32 / bfloat16 in, float32 math;
//   K3  repro/kernels/hdiff/kernel.py::hdiff_fixed_pallas
//       (_hdiff_fixed_kernel): the paper's int32 fixed-point datapath.
//
// What bounds it on an H100: device-memory bytes. Each launch must read the
// (D, R, C) field once and write it once, 2 * D*R*C * itemsize bytes; at the
// COSMO 64x256x256 f32 grid that is 33.6 MB, 10.0 us at 3.35 TB/s, against
// 72 flops per interior point = 0.29 GFLOP, 4.4 us at 67 TFLOP/s FP32.
//
// What the design does about it: one block per (plane, row tile, column
// tile) loads its tile plus a radius-2 halo into shared memory once (halo
// cells of neighbouring tiles come mostly from L2), computes the Laplacian
// once per point into a second shared-memory frame, and writes each output
// once, so device memory sees the compulsory traffic and little more. The
// Pallas kernel's three-slab halo and full-width row blocks existed only
// because Pallas lacks overlapping BlockSpecs; here each block reads its own
// overlapping window and masks the ragged grid edge itself, so tiles need
// not divide the grid. Out-of-grid halo cells are zero-filled: they feed
// only boundary-ring outputs, which copy the input through.
//
// Arithmetic order is _hdiff_tile_math's, compiled with -fmad=false, so a
// launch is bit-identical to the plain PyTorch version beside its wrapper
// (repro_torch/kernels/hdiff/kernel.py). K3 does every add, subtract and
// multiply in uint32 (wrapping as the JAX int32 datapath does; signed
// overflow is undefined in CUDA) and shifts the reinterpreted int32
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

__device__ __forceinline__ bool keep_flux(uint32_t a, uint32_t b) {
  const int32_t sa = static_cast<int32_t>(a), sb = static_cast<int32_t>(b);
  return sa == 0 || sb == 0 || ((sa > 0) != (sb > 0));
}

__global__ void __launch_bounds__(kThreads)
hdiff_fixed_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int rows,
                   int cols, int tile_r, int tile_c, int coeff_num, int coeff_shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fr = tile_r + 2 * HALO, fc = tile_c + 2 * HALO;
  uint32_t* const x = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* const lap = x + fr * fc;
  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * tile_c;

  for (int q = threadIdx.x; q < fr * fc; q += blockDim.x) {
    const int i = q / fc, j = q - i * fc;
    const int gr = r0 + i - HALO, gc = c0 + j - HALO;
    x[q] = (gr >= 0 && gr < rows && gc >= 0 && gc < cols)
               ? static_cast<uint32_t>(in[plane + static_cast<long long>(gr) * cols + gc])
               : 0u;
  }
  __syncthreads();

  const int lr = fr - 2, lc = fc - 2;
  for (int q = threadIdx.x; q < lr * lc; q += blockDim.x) {
    const int i = 1 + q / lc, j = 1 + q % lc;
    const int p = i * fc + j;
    lap[p] = 4u * x[p] - x[p + fc] - x[p - fc] - x[p + 1] - x[p - 1];
  }
  __syncthreads();

  const uint32_t num = static_cast<uint32_t>(coeff_num);
  for (int q = threadIdx.x; q < tile_r * tile_c; q += blockDim.x) {
    const int ti = q / tile_c, tj = q - ti * tile_c;
    const int gr = r0 + ti, gc = c0 + tj;
    if (gr >= rows || gc >= cols) continue;
    const int p = (ti + HALO) * fc + tj + HALO;
    const uint32_t psi_c = x[p];
    uint32_t val = psi_c;
    if (!in_ring(gr, gc, rows, cols)) {
      const uint32_t lap_c = lap[p];
      uint32_t flx_r = lap[p + fc] - lap_c;
      uint32_t flx_rm = lap_c - lap[p - fc];
      uint32_t flx_c = lap[p + 1] - lap_c;
      uint32_t flx_cm = lap_c - lap[p - 1];
      flx_r = keep_flux(flx_r, x[p + fc] - psi_c) ? flx_r : 0u;
      flx_rm = keep_flux(flx_rm, psi_c - x[p - fc]) ? flx_rm : 0u;
      flx_c = keep_flux(flx_c, x[p + 1] - psi_c) ? flx_c : 0u;
      flx_cm = keep_flux(flx_cm, psi_c - x[p - 1]) ? flx_cm : 0u;
      const uint32_t total = (flx_r - flx_rm) + (flx_c - flx_cm);
      const int32_t scaled = static_cast<int32_t>(total * num) >> coeff_shift;
      val = psi_c - static_cast<uint32_t>(scaled);
    }
    out[plane + static_cast<long long>(gr) * cols + gc] = static_cast<int32_t>(val);
  }
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
  static size_t reserved = 0;
  const size_t smem = tile_smem(tile_r, tile_c);
  const int err = repro_torch::reserve_smem(hdiff_fixed_kernel, smem, reserved);
  if (err) return err;
  hdiff_fixed_kernel<<<tile_grid(depth, rows, cols, tile_r, tile_c), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), rows, cols, tile_r,
      tile_c, coeff_num, coeff_shift);
  return static_cast<int>(cudaGetLastError());
}
