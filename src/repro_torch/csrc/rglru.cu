// K6 rglru_scan_cuda: the RG-LRU linear recurrence for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
//   repro/kernels/rglru/kernel.py::rglru_scan_pallas (_rglru_kernel):
//   h_t = a_t * h_{t-1} + b_t, elementwise over the width, per batch row,
// with a, b (B, T, W) float32 or bfloat16 and h0 (B, W) float32; it writes
// every h_t (B, T, W) and the last one (B, W) in float32.
//
// What bounds it on an H100: device-memory bytes. Each launch reads a and b
// once and writes h once (plus h0 and h_last); at RecurrentGemma's prefill
// shape (1, 512, 2560) float32 that is 15.7 MB, 4.7 us at 3.35 TB/s, against
// two flops per element.
//
// What the design does about it. One thread owns one (batch, channel) lane
// for the whole sequence and keeps h in a register, as the TPU kernel keeps
// its (block_w,) vector in VMEM; neighbouring threads own neighbouring
// channels, so every load and store is coalesced across the width. The loop
// over T is a dependent chain, so the loads of kUnroll steps are issued
// together before their multiply-adds, which keeps several DRAM requests in
// flight per thread. At B = 1 and W = 2560 there are only 2560 lanes (40
// blocks of 64), so the kernel cannot fill the card's 132 SMs and is expected
// to run far from its bound; that is a later PR's problem.
//
// Parity: the arithmetic is a float32 multiply, rounded, then an add, rounded
// (compiled with -fmad=false), exactly as the plain sequential version
// beside the wrapper (repro_torch/kernels/rglru/ref.py::rglru_seq_ref), which
// a launch equals bit for bit.
#include "stencil_common.cuh"

namespace {

using repro_torch::to_f32;

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
             float* __restrict__ h, float* __restrict__ h_last, int steps, int width) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  const long long row = blockIdx.y;
  const long long base = row * steps * width + c;
  float hv = h0[row * width + c];
  int t = 0;
  for (; t + kUnroll <= steps; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long long g = base + static_cast<long long>(t + q) * width;
      av[q] = to_f32(a[g]);
      bv[q] = to_f32(b[g]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      hv = av[q] * hv + bv[q];
      h[base + static_cast<long long>(t + q) * width] = hv;
    }
  }
  for (; t < steps; ++t) {
    const long long g = base + static_cast<long long>(t) * width;
    hv = to_f32(a[g]) * hv + to_f32(b[g]);
    h[g] = hv;
  }
  h_last[row * width + c] = hv;
}

template <typename T>
int launch_rglru(const void* a, const void* b, const void* h0, void* h, void* h_last,
                 int batch, int steps, int width, void* stream) {
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<float*>(h), static_cast<float*>(h_last), steps, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/rglru/kernel.py.
// Each returns the CUDA error code of the launch (0 on success).
extern "C" int rglru_f32(const void* a, const void* b, const void* h0, void* h, void* h_last,
                         int batch, int steps, int width, void* stream) {
  return launch_rglru<float>(a, b, h0, h, h_last, batch, steps, width, stream);
}

extern "C" int rglru_bf16(const void* a, const void* b, const void* h0, void* h, void* h_last,
                          int batch, int steps, int width, void* stream) {
  return launch_rglru<__nv_bfloat16>(a, b, h0, h, h_last, batch, steps, width, stream);
}
