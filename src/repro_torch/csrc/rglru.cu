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
// two flops per element. The recurrence is a dependent chain per channel of
// T steps, a multiply then an add, each rounded: about 3.3 us at T = 512
// however many channels run beside it. The first design (one thread per
// channel, 64-thread blocks, 8 loads unrolled ahead) lacked SM coverage and
// bytes in flight: at B = 1 it ran 40 blocks on 132 SMs with ~160 KB in
// flight for the whole card, where streaming at 3.35 TB/s needs about 2 MB.
//
// What the design does about it. One block per (batch row, tile of
// channels), the tile chosen by the wrapper so the grid fills the card in
// about one wave (20 channels at W = 2560 and B = 1: 128 blocks; 32 and 640
// blocks at B = 8). a and b stream through a ring of kStages slots in shared
// memory, kStageSteps steps x kMaxTile channels x 2 arrays per slot, filled
// by cp.async from warps 1-3: 4 channels per copy (16 bytes of float32, 8
// of bfloat16) when the width is a multiple of 4 and both pointers are
// aligned, else one float32 word per copy (bfloat16: plain loads). While
// the chain runs on one slot, the copies of the next two are in flight (at
// the serving shape 20 KB a block, 2.6 MB for the card), and one barrier
// per stage both publishes a slot and frees the one the chain left. Warp 0
// is the chain: one lane per channel keeps h in a register, reads a and b
// only from shared memory, at constant offsets in a fully unrolled stage,
// and stores h straight to device memory, coalesced across the tile; h_last
// is written once.
//
// What bounds it now, on an H100 80GB HBM3 at 700 W (scripts/kernel_bench.py,
// scripts/k6_phase_probe.py): 8.3-8.4 us at the serving shape (28.4-29.0
// before), 1.8x its bound. The chain is the limit there: a block spends
// 0.86 us filling the ring and then 11 ns per step (22 cycles) on the
// chain, its reads of a and b and its stores of h included; no barrier
// waits for a copy. At (8, 4096, 2560) 352-353 us (706-708 before), 85 %
// of its 300 us bytes bound.
//
// Parity: the arithmetic is a float32 multiply, rounded, then an add, rounded
// (compiled with -fmad=false), in time order, exactly as the plain
// sequential version beside the wrapper
// (repro_torch/kernels/rglru/ref.py::rglru_seq_ref), which a launch equals
// bit for bit; no step is reassociated.
#include "stencil_common.cuh"

namespace {

using repro_torch::to_f32;

constexpr int kThreads = 128;  // warps 1-3 copy; warp 0 runs the chain
constexpr int kStages = 4;     // ring slots (repro_torch/kernels/rglru/kernel.py STAGES)
constexpr int kMaxTile = 32;   // channels per block: at most one warp of chain lanes
constexpr int kStageSteps = 64;  // steps per slot (STAGE_STEPS; shorter only when T is)

template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(kBytes));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kVec: copies move 4 channels (tile and width multiples of 4, pointers
// aligned to 4 elements); else one element each.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
             float* __restrict__ h, float* __restrict__ h_last, int steps, int width,
             int tile, int stage_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // kStages x {a, b} x stage_steps x kMaxTile
  const int c0 = blockIdx.x * tile;
  const int tc = min(tile, width - c0);  // channels of this block's tile
  const long long row0 = static_cast<long long>(blockIdx.y) * steps;
  const int slot = stage_steps * kMaxTile;  // elements of one array in one slot
  const int nstage = (steps + stage_steps - 1) / stage_steps;
  constexpr int kGroup = kVec ? 4 : 1;
  constexpr int kBytes = static_cast<int>(kGroup * sizeof(T));
  constexpr int kCopiers = kThreads - 32;  // warps 1-3

  // A copier owns one group of kGroup channels and every rows_per_pass-th
  // step of a stage (no division in the loop; the threads past the last
  // whole pass idle).
  const int per_row = tc / kGroup;
  const int copier = threadIdx.x - 32;
  const int rows_per_pass = kCopiers / per_row;  // >= 1: per_row <= 32
  const int copy_i = copier % per_row * kGroup, copy_t = copier / per_row;
  const bool copies = copier >= 0 && copy_t < rows_per_pass;

  // Copier threads start copying stage s (steps [s * stage_steps, ...)) of
  // a and b into slot s % kStages; each commits one group per call, empty
  // past the last stage.
  auto issue = [&](int s) {
    if (copies && s < nstage) {
      const int t0 = s * stage_steps, ts = min(stage_steps, steps - t0);
      T* const sa = ring + (s % kStages) * 2 * slot + copy_i;
      T* const sb = sa + slot;
      const long long g0 = (row0 + t0) * width + c0 + copy_i;
      for (int t = copy_t; t < ts; t += rows_per_pass) {
        const long long g = g0 + static_cast<long long>(t) * width;
        if constexpr (kVec || sizeof(T) == 4) {
          copy_async<kBytes>(sa + t * kMaxTile, a + g);
          copy_async<kBytes>(sb + t * kMaxTile, b + g);
        } else {
          sa[t * kMaxTile] = a[g];
          sb[t * kMaxTile] = b[g];
        }
      }
    }
    copy_commit();
  };

  // The chain lanes of warp 0, one per channel. A whole stage runs fully
  // unrolled, so its reads of a and b (at constant offsets: the slot's row
  // stride is kMaxTile) are issued ahead of the chain that needs them.
  const int c = threadIdx.x;
  const bool lane = c < tc;
  float hv = lane ? h0[static_cast<long long>(blockIdx.y) * width + c0 + c] : 0.0f;
  float* hp = h + row0 * width + c0 + c;
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < nstage; ++s) {
    copy_wait<kStages - 2>();  // this thread's copies of stage s have landed
    __syncthreads();  // everyone's have, and the chain has left slot (s - 1) % kStages
    if (threadIdx.x >= 32) {
      issue(s + kStages - 1);  // into slot (s - 1) % kStages
    } else if (lane) {
      const T* const pa = ring + (s % kStages) * 2 * slot + c;
      const T* const pb = pa + slot;
      auto step = [&](int t) {
        hv = to_f32(pa[t * kMaxTile]) * hv + to_f32(pb[t * kMaxTile]);
        *hp = hv;
        hp += width;
      };
      const int ts = min(stage_steps, steps - s * stage_steps);
      if (ts == kStageSteps) {
#pragma unroll
        for (int t = 0; t < kStageSteps; ++t) step(t);
      } else {
#pragma unroll 8
        for (int t = 0; t < ts; ++t) step(t);
      }
    }
  }
  if (lane) h_last[static_cast<long long>(blockIdx.y) * width + c0 + c] = hv;
}

template <typename T>
int launch_rglru(const void* a, const void* b, const void* h0, void* h, void* h_last,
                 int batch, int steps, int width, int tile, int stage_steps, int vec,
                 void* stream) {
  if (tile < 1 || tile > kMaxTile || stage_steps < 1 || (vec && tile % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kStages) * 2 * stage_steps * kMaxTile * sizeof(T);
  const dim3 grid((width + tile - 1) / tile, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ta = static_cast<const T*>(a);
  const auto* tb = static_cast<const T*>(b);
  const auto* th0 = static_cast<const float*>(h0);
  auto* th = static_cast<float*>(h);
  auto* tl = static_cast<float*>(h_last);
  int err;
  if (vec) {
    static size_t reserved = 0;
    err = repro_torch::reserve_smem(rglru_kernel<T, true>, smem, reserved);
    if (err) return err;
    rglru_kernel<T, true><<<grid, kThreads, smem, s>>>(ta, tb, th0, th, tl, steps, width,
                                                       tile, stage_steps);
  } else {
    static size_t reserved = 0;
    err = repro_torch::reserve_smem(rglru_kernel<T, false>, smem, reserved);
    if (err) return err;
    rglru_kernel<T, false><<<grid, kThreads, smem, s>>>(ta, tb, th0, th, tl, steps, width,
                                                        tile, stage_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/rglru/kernel.py,
// which plans tile (channels per block, <= 32; a multiple of 4 when vec) and
// stage_steps. Each returns the CUDA error code of the launch (0 on success).
extern "C" int rglru_f32(const void* a, const void* b, const void* h0, void* h, void* h_last,
                         int batch, int steps, int width, int tile, int stage_steps, int vec,
                         void* stream) {
  return launch_rglru<float>(a, b, h0, h, h_last, batch, steps, width, tile, stage_steps,
                             vec, stream);
}

extern "C" int rglru_bf16(const void* a, const void* b, const void* h0, void* h, void* h_last,
                          int batch, int steps, int width, int tile, int stage_steps, int vec,
                          void* stream) {
  return launch_rglru<__nv_bfloat16>(a, b, h0, h, h_last, batch, steps, width, tile,
                                     stage_steps, vec, stream);
}
