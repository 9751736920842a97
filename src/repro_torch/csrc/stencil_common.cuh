// Helpers shared by the hand-written hdiff kernels (hdiff.cu) and the
// kernels that repro_torch.ir.codegen_cuda generates for IR programs.
//
// Every source that includes this header is compiled with -fmad=false: the
// port's float32 results must round exactly like its plain PyTorch versions
// (and, through them, like the JAX reference), and a contracted a*b+c
// rounds once where the reference rounds twice. The flux limiter turns a
// one-ulp difference into a coeff*|flux| jump, so no contraction anywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;  // threads per block of every stencil kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// The Eq. 2-3 flux limiter: keep the flux d only where it points down the
// gradient g (d * g <= 0). A NaN product compares false and zeroes the flux,
// as jnp.where / torch.where do.
__device__ __forceinline__ float limit_flux(float d, float g) {
  return (d * g <= 0.0f) ? d : 0.0f;
}

// The limiter's gate in an adjoint program (ir/ops.py, flux's vjp rule): the
// cotangent g passes where the primal flux d was kept (d * gg <= 0, the same
// test, rounded the same way) and is zero where it was cut.
__device__ __forceinline__ float limit_gate(float g, float d, float gg) {
  return (d * gg <= 0.0f) ? g : 0.0f;
}

// The raw word of an input of type T: the type its frame loader reads.
template <typename T> struct WordOf { using type = uint32_t; };  // float32, int32
template <> struct WordOf<__nv_bfloat16> { using type = uint16_t; };

// An input word as a frame word: float32 and int32 as they are, bfloat16
// widened exactly to the float32 with the same value (its top half).
__device__ __forceinline__ uint32_t widen(uint32_t w) { return w; }
__device__ __forceinline__ uint32_t widen(uint16_t w) { return static_cast<uint32_t>(w) << 16; }

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The shared-memory frame of a block's TR x TC output tile (TC in 64/32/16/8)
// plus its radius-H halo, in 4-byte words: float32 (a bfloat16 input
// widened) or int32, zero outside the grid. Rows are kLd words, the tile's
// width plus the halo padded to whole 16-byte groups, and the frame starts
// kShift words into the block's buffer, so that frame column H, grid column
// c0 (a multiple of 8), starts a group. ir/plan.py::frame_layout computes
// the same numbers for the planner.
template <int H, int TC>
struct Frame {
  static constexpr int kShift = (4 - H % 4) % 4;
  static constexpr int kLd = (TC + 2 * H + 3) / 4 * 4;
  static_assert(TC % 8 == 0, "a tile's width is whole 16-byte groups of bfloat16");

  static size_t bytes(int tile_r) {
    const size_t words = kShift + static_cast<size_t>(tile_r + 2 * H) * kLd;
    return (words * 4 + 15) / 16 * 16;
  }

  // Loads the frame of the tile whose top-left output is (r0, c0) from the
  // (rows, cols) plane of words S (uint32_t, or uint16_t for bfloat16) at
  // ``in``; ``x`` is the buffer plus kShift words. When ``aligned`` (the
  // plane's rows are whole 16-byte groups and the pointer is 16-byte
  // aligned) the tile's groups go by one 16-byte cp.async each (4 words),
  // or, for bfloat16, by one 16-byte load widened into two 16-byte shared
  // stores (8 words); the grid's ragged edge, the halo columns and unaligned
  // inputs go word by word. Waits for its copies; the caller puts the
  // block's barrier after it.
  template <typename S>
  static __device__ __forceinline__ void load(const S* __restrict__ in, uint32_t* x, int rows,
                                              int cols, int r0, int c0, int tile_r,
                                              bool aligned) {
    constexpr int G = 16 / static_cast<int>(sizeof(S));  // input words per 16 bytes
    constexpr int NQ = TC / G;                           // aligned groups per frame row
    constexpr int PER_ROW = NQ + 2 * H;                  // ... plus H edge words each side
    const int fr = tile_r + 2 * H;
    for (int q = threadIdx.x; q < fr * PER_ROW; q += kThreads) {
      const int i = q / PER_ROW, u = q - i * PER_ROW;
      const int gr = r0 + i - H;
      const bool row_ok = gr >= 0 && gr < rows;
      const S* const src = in + static_cast<long long>(row_ok ? gr : 0) * cols;
      if (u < NQ) {
        const int gc = c0 + G * u;
        uint32_t* const dst = x + i * kLd + H + G * u;
        if (aligned && row_ok && gc + G <= cols) {
          if constexpr (G == 4) {
            copy16(dst, src + gc);
          } else {
            const uint4 v = *reinterpret_cast<const uint4*>(src + gc);
            reinterpret_cast<uint4*>(dst)[0] =
                make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u);
            reinterpret_cast<uint4*>(dst)[1] =
                make_uint4(v.z << 16, v.z & 0xffff0000u, v.w << 16, v.w & 0xffff0000u);
          }
        } else {
#pragma unroll
          for (int e = 0; e < G; ++e) dst[e] = row_ok && gc + e < cols ? widen(src[gc + e]) : 0u;
        }
      } else {
        const int v = u - NQ, j = v < H ? v : TC + v;  // frame columns [0, H), [TC + H, TC + 2H)
        const int gc = c0 + j - H;
        x[i * kLd + j] = row_ok && gc >= 0 && gc < cols ? widen(src[gc]) : 0u;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

// Whether a plane of ``cols`` words S at ``in`` loads by 16-byte groups.
template <typename S>
inline bool rows_aligned(const void* in, int cols) {
  return cols % (16 / sizeof(S)) == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
}

// Opts a kernel into more than 48 KB of dynamic shared memory when its tile
// plan needs it; returns the CUDA error code (0 on success). ``reserved`` is
// the launcher's own record of what it already set, so steady-state launches
// (and launches captured into a CUDA graph) make no attribute call.
template <typename Kernel>
inline int reserve_smem(Kernel kernel, size_t bytes, size_t& reserved) {
  if (bytes <= 48 * 1024 || bytes <= reserved) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) reserved = bytes;
  return static_cast<int>(err);
}

}  // namespace repro_torch
