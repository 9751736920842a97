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
// What the design does about it. K4: a block owns a 64x64 output tile (a
// TC-column tile, TC in 64/32/16/8, from the planner for narrow grids or
// explicit tile rows) and loads it with its radius-1 halo into one
// shared-memory frame of float32 words (stencil_common.cuh, Frame: 16-byte
// cp.async copies of the aligned groups, a bfloat16 input widened as it is
// stored, rows padded to whole groups, word by word at the grid's unaligned
// edges and for unaligned inputs; halo cells of neighbouring tiles come
// mostly from L2). After the
// block's one barrier each thread walks a run of rows down one column with
// the 3x3 window in registers, so a point costs three new shared reads,
// nine multiplies, nine adds and one store; no division inside a loop, the
// column tile a template constant. Its first form loaded the frame word by
// word with a division per word and read all nine taps from shared memory
// with a division per point: 25.8-26.2 us at 64x256x256 f32 on an H100 80GB
// HBM3 at 700 W; now 12.7-13.0 us (77-79 % of the bytes bound; bf16 10.4-
// 10.5 us) and 262-264 us at 80x1024x1024 (76 %), with a row loop of 28.5 SASS
// instructions a point (9 FMUL, 9 FADD, 3 LDS, a store and the loop's
// integer work; scripts/kernel_bench.py). The nine mask values arrive by value in a kernel
// parameter (the constant bank), so one compiled kernel serves every mask
// of the suite, as the SMEM mask did in Pallas. Each block masks the ragged
// grid edge itself, so tiles need not divide the grid. K5: a point reads only
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

using repro_torch::Frame;
using repro_torch::from_f32;
using repro_torch::kThreads;
using repro_torch::to_f32;
using repro_torch::WordOf;

constexpr int R = 1;  // radius of both stencils

// The frame shift, in words, of K4's frames (ir/plan.py::frame_layout).
static_assert(Frame<R, 64>::kShift == 3, "frame shift");

struct Mask {
  float w[9];  // row-major (dr, dc), dr and dc in {-1, 0, 1}
};

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int cols,
                 int tile_r, int run, int aligned, Mask mask) {
  using F = Frame<R, TC>;
  constexpr int LD = F::kLd;
  extern __shared__ __align__(16) uint32_t stencil2d_smem[];
  uint32_t* const x = stencil2d_smem + F::kShift;
  const long long plane = static_cast<long long>(blockIdx.z) * rows * cols;
  const int r0 = blockIdx.y * tile_r, c0 = blockIdx.x * TC;
  F::load(reinterpret_cast<const typename WordOf<T>::type*>(in) + plane, x, rows, cols, r0, c0,
          tile_r, aligned);
  __syncthreads();

  // Each thread walks `run` rows down one column; rows i - 1 (a), i (b) and
  // i + 1 (c) of its three columns stay in registers.
  const int j = threadIdx.x % TC, seg = threadIdx.x / TC;
  const int gc = c0 + j;
  const int i0 = seg * run, i1 = min(min(i0 + run, tile_r), rows - r0);
  if (gc >= cols || i0 >= i1) return;
  const bool col_in = gc >= R && gc < cols - R;
  const float* p = reinterpret_cast<const float*>(x) + (i0 + R) * LD + j + R;
  float a0 = p[-LD - 1], a1 = p[-LD], a2 = p[-LD + 1];
  float b0 = p[-1], b1 = p[0], b2 = p[1];
  int gr = r0 + i0;
  T* o = out + plane + static_cast<long long>(gr) * cols + gc;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const float c0_ = p[LD - 1], c1 = p[LD], c2 = p[LD + 1];
    float acc = 0.0f;
    acc = acc + mask.w[0] * a0;
    acc = acc + mask.w[1] * a1;
    acc = acc + mask.w[2] * a2;
    acc = acc + mask.w[3] * b0;
    acc = acc + mask.w[4] * b1;
    acc = acc + mask.w[5] * b2;
    acc = acc + mask.w[6] * c0_;
    acc = acc + mask.w[7] * c1;
    acc = acc + mask.w[8] * c2;
    const bool interior = col_in && gr >= R && gr < rows - R;
    *o = from_f32<T>(interior ? acc : b1);
    a0 = b0, a1 = b1, a2 = b2, b0 = c0_, b1 = c1, b2 = c2;
    p += LD, o += cols, ++gr;
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

template <typename T, int TC>
int launch_stencil2d(const void* in, void* out, int depth, int rows, int cols, int tile_r,
                     const Mask& mask, cudaStream_t stream) {
  static size_t reserved = 0;
  const size_t smem = Frame<R, TC>::bytes(tile_r);
  const int err = repro_torch::reserve_smem(stencil2d_kernel<T, TC>, smem, reserved);
  if (err) return err;
  constexpr int kSegments = kThreads / TC;
  const int run = (tile_r + kSegments - 1) / kSegments;
  const int aligned = repro_torch::rows_aligned<typename WordOf<T>::type>(in, cols);
  const dim3 grid((cols + TC - 1) / TC, (rows + tile_r - 1) / tile_r, depth);
  stencil2d_kernel<T, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, cols, tile_r, run, aligned, mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_stencil2d(const void* in, void* out, int depth, int rows, int cols, int tile_r,
                       int tile_c, const float* weights, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  Mask mask;
  for (int k = 0; k < 9; ++k) mask.w[k] = weights[k];
  switch (tile_c) {  // the planner's column tiles (repro_torch/ir/plan.py FIXED_TILE_COLS)
    case 64: return launch_stencil2d<T, 64>(in, out, depth, rows, cols, tile_r, mask, st);
    case 32: return launch_stencil2d<T, 32>(in, out, depth, rows, cols, tile_r, mask, st);
    case 16: return launch_stencil2d<T, 16>(in, out, depth, rows, cols, tile_r, mask, st);
    case 8: return launch_stencil2d<T, 8>(in, out, depth, rows, cols, tile_r, mask, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return dispatch_stencil2d<float>(in, out, depth, rows, cols, tile_r, tile_c, weights,
                                  stream);
}

extern "C" int stencil2d_bf16(const void* in, void* out, int depth, int rows, int cols,
                              int tile_r, int tile_c, const float* weights, void* stream) {
  return dispatch_stencil2d<__nv_bfloat16>(in, out, depth, rows, cols, tile_r, tile_c,
                                          weights, stream);
}

extern "C" int jacobi1d_f32(const void* in, void* out, int batch, int n, float coeff,
                            void* stream) {
  return launch_jacobi1d<float>(in, out, batch, n, coeff, stream);
}

extern "C" int jacobi1d_bf16(const void* in, void* out, int batch, int n, float coeff,
                             void* stream) {
  return launch_jacobi1d<__nv_bfloat16>(in, out, batch, n, coeff, stream);
}
