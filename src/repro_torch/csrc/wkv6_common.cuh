// Helpers shared by K7 (wkv6.cu) and its backward (wkv6_bwd.cu): 3xTF32
// products on the tensor cores, cp.async chunk loads, programmatic dependent
// launch, and the block-wide running sum of log w over a chunk.
//
// Both sources are compiled with -fmad=false (see stencil_common.cuh); the
// mma instructions below are not affected by it.
#pragma once

#include "stencil_common.cuh"

namespace repro_torch {
namespace wkv6 {

constexpr int kThreads = 256;  // threads per block of every WKV-6 pass
constexpr int kWarps = kThreads / 32;

// ---- 3xTF32 products on the tensor cores ------------------------------------

// x = big + small with both halves TF32, for finite x: big is x rounded to
// the nearest TF32, ties away from zero (as cvt.rna.tf32.f32 rounds), and x
// - big is exact in FP32; small is that rest rounded the same way but not
// masked, since mma reads only the top 19 bits of a .tf32 operand. Four
// instructions where two cvt.rna and a subtraction take six.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[q] += A[m0 : m0 + 16, k0 : k1] B[k0 : k1, n0 + 8q : n0 + 8q + 8]
// for q < kNq. a(m, k) and b(k, n) read shared memory inside the
// zero-padded arrays; k1 - k0 is a multiple of 8. Fragment layouts are
// PTX's for m16n8k8 .tf32: lane = 4 g + tq. A k-step loads and splits all
// its fragments, then runs the three mma passes over the kNq tiles in turn,
// so that independent mma instructions issue back to back; each acc[q] sums
// a_small b_big + a_big b_small + a_big b_big in that order.
template <int kNq, typename FA, typename FB>
__device__ __forceinline__ void warp_product(float (&acc)[4][4], FA a, FB b, int m0, int n0,
                                             int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  for (int kk = k0; kk < k1; kk += 8) {
    float av[4], bv[kNq][2];
    av[0] = a(m0 + g, kk + tq);
    av[1] = a(m0 + g + 8, kk + tq);
    av[2] = a(m0 + g, kk + tq + 4);
    av[3] = a(m0 + g + 8, kk + tq + 4);
#pragma unroll
    for (int q = 0; q < kNq; ++q) {
      bv[q][0] = b(kk + tq, n0 + 8 * q + g);
      bv[q][1] = b(kk + tq + 4, n0 + 8 * q + g);
    }
    uint32_t ab[4], as[4], bb[kNq][2], bs[kNq][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(av[e], ab[e], as[e]);
#pragma unroll
    for (int q = 0; q < kNq; ++q) {
      split(bv[q][0], bb[q][0], bs[q][0]);
      split(bv[q][1], bb[q][1], bs[q][1]);
    }
#pragma unroll
    for (int q = 0; q < kNq; ++q) mma_tf32(acc[q], as, bb[q]);
#pragma unroll
    for (int q = 0; q < kNq; ++q) mma_tf32(acc[q], ab, bs[q]);
#pragma unroll
    for (int q = 0; q < kNq; ++q) mma_tf32(acc[q], ab, bb[q]);
  }
}

// One warp's product into its 16 x 32 (nq = 4) or 16 x 16 (nq = 2) output
// tile: with N and C padded to multiples of 16, every tile of both WKV-6
// sources is one or the other.
template <typename FA, typename FB>
__device__ __forceinline__ void product(float (&acc)[4][4], FA a, FB b, int m0, int n0, int nq,
                                        int k0, int k1) {
  if (nq == 4) {
    warp_product<4>(acc, a, b, m0, n0, k0, k1);
  } else {
    warp_product<2>(acc, a, b, m0, n0, k0, k1);
  }
}

// Row and column of accumulator element e (0..3) of n-tile q.
__device__ __forceinline__ int acc_row(int m0, int e) { return m0 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int acc_col(int n0, int q, int e) {
  return n0 + 8 * q + 2 * (threadIdx.x & 3) + (e & 1);
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// ---- loads and the running sum ------------------------------------------------

// Starts copying a rows x cols block (row stride src_ld) into dst (row stride
// ld) and zeroes the rest of the padded prows x pcols block. With vec (cols,
// src_ld and both addresses multiples of 4 words) every 4 words go by one
// 16-byte cp.async that the caller waits for; else word by word.
__device__ __forceinline__ void load_block(float* dst, int ld, const float* src,
                                           long long src_ld, int rows, int cols, int prows,
                                           int pcols, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int q = threadIdx.x; q < rows * c4; q += kThreads) {
      const int t = q / c4, i = (q - t * c4) * 4;
      copy16(dst + t * ld + i, src + t * src_ld + i);
    }
  } else {
    for (int q = threadIdx.x; q < rows * cols; q += kThreads) {
      const int t = q / cols, i = q - t * cols;
      dst[t * ld + i] = src[t * src_ld + i];
    }
  }
  if (rows < prows || cols < pcols) {
    for (int q = threadIdx.x; q < prows * pcols; q += kThreads) {
      const int t = q / pcols, i = q - t * pcols;
      if (t >= rows || i >= cols) dst[t * ld + i] = 0.0f;
    }
  }
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// Closes the group of the copies started since the last one; copy_wait_but
// <n>() waits for every closed group but the n closed last.
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void copy_wait_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Programmatic dependent launch (sm_90): the next kernel of the stream, when
// launched with cudaLaunchAttributeProgrammaticStreamSerialization, may start
// once every block of this one has allowed it; it must wait before it reads
// anything this one writes.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The running sum of log w = log(max(w, 1e-30)) over the chunk for every
// channel, by the whole block: channel i's C steps are cut into runs, one
// thread each (thread q takes channel q % np, run q / np); a thread sums its
// run, then adds the totals of the runs before it while it walks the run
// again. W holds w on entry and log w on exit; tot holds kThreads floats.
// Calls f(t, i, cum, logw, total) for every step t < C of every channel
// i < N, in order of t within each thread's run. Contains a __syncthreads().
template <typename F>
__device__ __forceinline__ void chunk_scan(float* W, int ld, float* tot, int N, int C, int np,
                                           F f) {
  const int nseg = np < kThreads ? kThreads / np : 1, len = (C + nseg - 1) / nseg;
  for (int q = threadIdx.x; q < np * nseg; q += kThreads) {
    const int seg = q / np, i = q - seg * np;
    float acc = 0.0f;
    if (i < N) {
      for (int t = seg * len; t < min(C, seg * len + len); ++t) {
        const float lw = logf(fmaxf(W[t * ld + i], 1e-30f));
        W[t * ld + i] = lw;
        acc = acc + lw;
      }
    }
    tot[q] = acc;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < np * nseg; q += kThreads) {
    const int seg = q / np, i = q - seg * np;
    if (i >= N) continue;
    float cum = 0.0f, total = 0.0f;
    for (int r = 0; r < nseg; ++r) {
      if (r == seg) cum = total;
      total = total + tot[r * np + i];
    }
    for (int t = seg * len; t < min(C, seg * len + len); ++t) {
      const float lw = W[t * ld + i];
      cum = cum + lw;
      f(t, i, cum, lw, total);
    }
  }
}

// Launches kernel on stream st so that it may start while the kernel before it
// runs (programmatic stream serialization); it calls wait_for_prerequisite().
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t st,
                     Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...));
}

}  // namespace wkv6
}  // namespace repro_torch
