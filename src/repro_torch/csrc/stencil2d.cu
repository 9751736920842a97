// K4 stencil2d_cuda and K5 jacobi1d_cuda: the paper's §3.5 elementary
// stencils for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels
//   K4  repro/kernels/stencil2d/kernel.py::stencil2d_pallas
//       (_stencil2d_kernel): correlation of a (depth, rows, cols) float32 /
//       bfloat16 field with a runtime 3x3 float32 mask on the interior,
//       float32 accumulation, the radius-1 ring passed through;
//   K5  repro/kernels/stencil2d/kernel.py::jacobi1d_pallas
//       (_jacobi1d_kernel): coeff * ((x[i-1] + x[i]) + x[i+1]) over a
//       (batch, n) field, the two end points passed through.
//
// What bounds them on an H100: device-memory bytes. Each launch must read
// the field once and write it once, 2 * elements * itemsize bytes; K4 at
// the paper's 64x256x256 float32 grid moves 33.6 MB, 10.0 us at 3.35 TB/s,
// against 18 flops per interior point (1.1 us at 67 TFLOP/s FP32); K5 does
// 4 flops per point on as many bytes.
//
// What the design does about it. K4: one block per (plane, row tile,
// column tile) loads its tile plus a radius-1 halo into shared memory once
// (halo cells of neighbouring tiles come mostly from L2) and writes each
// output once. The nine mask values arrive by value in a kernel parameter
// (the constant bank), so one compiled kernel serves every mask of the
// suite, as the SMEM mask did in Pallas. Each block masks the ragged grid
// edge itself, so tiles need not divide the grid. K5: a point reads only
// its two row neighbours, which the neighbouring threads of its warp load
// anyway, so it reads through L1/L2 with no shared-memory staging; the row
// is tiled across blocks (Pallas held a whole row per program), so a row of
// any length and a batch of any size fill the card.
//
// Summation order is the parity contract. K4 accumulates all nine taps,
// the zero-weight ones included (0 * Inf is NaN, and 0 + -0 is +0), in
// row-major (dr, dc) order from 0.0f as acc = acc + w * x, exactly as the
// Pallas kernel and stencil2d_ref do; compiled with -fmad=false, a launch is
// bit-identical to the plain PyTorch versions beside the wrappers
// (repro_torch/kernels/stencil2d/kernel.py).
#include "stencil_common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::kThreads;
using repro_torch::to_f32;

constexpr int R = 1;  // radius of both stencils

struct Mask {
  float w[9];  // row-major (dr, dc), dr and dc in {-1, 0, 1}
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int cols,
                 int tile_r, int tile_c, Mask mask) {
  extern __shared__ __align__(16) float x[];  // tile + radius-1 halo
  const int fr = tile_r + 2 * R, fc = tile_c + 2 * R;
  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * tile_c;

  for (int q = threadIdx.x; q < fr * fc; q += blockDim.x) {
    const int i = q / fc, j = q - i * fc;
    const int gr = r0 + i - R, gc = c0 + j - R;
    x[q] = (gr >= 0 && gr < rows && gc >= 0 && gc < cols)
               ? to_f32(in[plane + static_cast<long long>(gr) * cols + gc])
               : 0.0f;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < tile_r * tile_c; q += blockDim.x) {
    const int ti = q / tile_c, tj = q - ti * tile_c;
    const int gr = r0 + ti, gc = c0 + tj;
    if (gr >= rows || gc >= cols) continue;
    const int p = (ti + R) * fc + tj + R;
    float val = x[p];
    if (gr >= R && gr < rows - R && gc >= R && gc < cols - R) {
      float acc = 0.0f;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          acc = acc + mask.w[dr * 3 + dc] * x[p + (dr - R) * fc + (dc - R)];
        }
      }
      val = acc;
    }
    out[plane + static_cast<long long>(gr) * cols + gc] = from_f32<T>(val);
  }
}

// Rows of a (batch, n) field map to blockIdx.z * gridDim.y + blockIdx.y, so
// a batch beyond the 65535-block y limit needs no loop; blocks past the
// last row (at most gridDim.y - 1 of them) return at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi1d_kernel(const T* __restrict__ in, T* __restrict__ out, int batch, int n,
                float coeff) {
  const int b = blockIdx.z * gridDim.y + blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch || i >= n) return;
  const long long g = static_cast<long long>(b) * n + i;
  float val = to_f32(in[g]);
  if (i > 0 && i < n - 1) {
    val = coeff * ((to_f32(in[g - 1]) + val) + to_f32(in[g + 1]));
  }
  out[g] = from_f32<T>(val);
}

template <typename T>
int launch_stencil2d(const void* in, void* out, int depth, int rows, int cols, int tile_r,
                     int tile_c, const float* weights, void* stream) {
  static size_t reserved = 0;
  const size_t smem = sizeof(float) * (tile_r + 2 * R) * (tile_c + 2 * R);
  const int err = repro_torch::reserve_smem(stencil2d_kernel<T>, smem, reserved);
  if (err) return err;
  Mask mask;
  for (int k = 0; k < 9; ++k) mask.w[k] = weights[k];
  const dim3 grid((cols + tile_c - 1) / tile_c, (rows + tile_r - 1) / tile_r, depth);
  stencil2d_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, cols, tile_r, tile_c, mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_jacobi1d(const void* in, void* out, int batch, int n, float coeff, void* stream) {
  const unsigned gz = (batch + 65534) / 65535;
  const dim3 grid((n + kThreads - 1) / kThreads, (batch + gz - 1) / gz, gz);
  jacobi1d_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), batch, n, coeff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/stencil2d/kernel.py.
// Each returns the CUDA error code of the launch (0 on success). ``weights``
// is a host array of nine float32 values, read before the launch.
extern "C" int stencil2d_f32(const void* in, void* out, int depth, int rows, int cols,
                             int tile_r, int tile_c, const float* weights, void* stream) {
  return launch_stencil2d<float>(in, out, depth, rows, cols, tile_r, tile_c, weights, stream);
}

extern "C" int stencil2d_bf16(const void* in, void* out, int depth, int rows, int cols,
                              int tile_r, int tile_c, const float* weights, void* stream) {
  return launch_stencil2d<__nv_bfloat16>(in, out, depth, rows, cols, tile_r, tile_c, weights,
                                         stream);
}

extern "C" int jacobi1d_f32(const void* in, void* out, int batch, int n, float coeff,
                            void* stream) {
  return launch_jacobi1d<float>(in, out, batch, n, coeff, stream);
}

extern "C" int jacobi1d_bf16(const void* in, void* out, int batch, int n, float coeff,
                             void* stream) {
  return launch_jacobi1d<__nv_bfloat16>(in, out, batch, n, coeff, stream);
}
