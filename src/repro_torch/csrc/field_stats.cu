// field_stats: a field's health accumulators in one read, for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves field_stats
// (src/repro/obs/health.py) to XLA, which fuses its reductions. The port's
// probe first chained PyTorch reductions over the field (masks, their int32
// copies, where-copies, seven sums and extrema: some twenty passes) and read
// each statistic to the host apart. This kernel reads every element once and
// writes the seven accumulators the statistics are made of, in this order
// (repro_torch/kernels/stats/kernel.py, ACC_KEYS): NaN count, Inf count,
// finite count, sum and sum of squares of the finite values, their min and
// their max, each a double.
//
// What bounds it on an H100: device-memory bytes, one read of the field. A
// served COSMO-E member, (301, 390, 582) float32, is 273.3 MB: 81.6 us at
// 3.35 TB/s. Its arithmetic, a float32-to-float64 conversion and three
// float64 operations an element, hides under the loads: a copy with the sums
// cut out ran 94.1 us against 94.8. Measured on an H100 80GB HBM3 at 700 W
// (CUDA-graph replays, nothing of the field left in L2): 92.1-93.8 us at the
// served member, 87-89 % of the bound (2.9-3.0 TB/s); bfloat16 and float16
// 50.5-51.5 us (81 % of 40.8), float64 177-179 us (92 % of 163), bool 45.4-
// 45.8 us (45 % of 20.4: sixteen conversions a load).
//
// Design. A persistent grid of at most four blocks of kThreads threads per
// SM (the wrapper's launch_grid) walks the field with a grid stride; each
// thread keeps kUnroll 16-byte loads in flight (non-coherent, no L1
// allocation, L2 fetching 256-byte sectors: the field is read once), 64 KB
// an SM, several times what covers HBM's latency at full rate. The elements
// before the first 16-byte boundary of a view
// that starts inside a vector, and those after the last whole vector, are
// read one by one by the grid's first threads. A thread accumulates in
// registers: the NaN and Inf counts as 64-bit integers (the finite count is
// what is left of the size), the sums in float64 (a float32 value's square
// is exact there, and the sums are far more exact than a float32 cascade)
// and min and max in float32. A warp reduces with shuffles, the block through
// shared memory into one partial a block; the last block to finish reduces
// the partials in block order and writes the accumulators. It is told by a
// ticket, a 4-byte counter that each block bumps with atomicInc wrapping at
// the grid's size, so every launch leaves it at 0 for the next on its
// stream: zeroing it on the stream before each launch cost 2.2 us of 94.8 at
// the served member. Ticket and partials live in a scratch buffer the
// wrapper keeps for each stream (launches in stream order never share it);
// the seven outputs go to a buffer of their own. Every order is fixed by the
// grid, which the wrapper derives from the field's size and the card: two
// launches on one input give the same bits. Nothing is allocated here.
//
// Each element is rounded to float32 first, as the plain version's
// .to(torch.float32): NaN and Inf are told on the input's own type (an
// integer or bool has neither), so min and max are those of the plain
// version bit for bit. Compiled with -fmad=false like every source here.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecBytes = 16;
constexpr unsigned kAll = 0xffffffffu;

// One thread's, one block's or the field's accumulators.
struct Acc {
  unsigned long long nan, inf;
  double sum, sumsq;
  float mn, mx;
};
static_assert(sizeof(Acc) == 40, "kernel.py's PARTIAL_WORDS: five doubles a partial");

__device__ __forceinline__ Acc identity() { return Acc{0ull, 0ull, 0.0, 0.0, INFINITY, -INFINITY}; }

__device__ __forceinline__ void keep(Acc& a, float v) {
  const double d = v;
  a.sum += d;
  a.sumsq += d * d;
  a.mn = fminf(a.mn, v);
  a.mx = fmaxf(a.mx, v);
}

__device__ __forceinline__ void add(Acc& a, float v) {
  if (isfinite(v)) {
    keep(a, v);
  } else if (isnan(v)) {
    ++a.nan;
  } else {
    ++a.inf;
  }
}

// A float64 is told finite on its own type, then rounded: one beyond
// float32's range is finite and adds +-inf, as in the plain version.
__device__ __forceinline__ void add(Acc& a, double v) {
  if (isfinite(v)) {
    keep(a, static_cast<float>(v));
  } else if (isnan(v)) {
    ++a.nan;
  } else {
    ++a.inf;
  }
}

__device__ __forceinline__ void add(Acc& a, __nv_bfloat16 v) { add(a, __bfloat162float(v)); }
__device__ __forceinline__ void add(Acc& a, __half v) { add(a, __half2float(v)); }

// Integers (bool as its byte, 0 or 1): all finite, rounded to nearest.
template <typename T>
__device__ __forceinline__ typename std::enable_if<std::is_integral<T>::value>::type add(Acc& a,
                                                                                         T v) {
  keep(a, static_cast<float>(v));
}

template <typename T>
__device__ __forceinline__ void add_vector(Acc& a, const uint4& w) {
  constexpr int kPer = kVecBytes / sizeof(T);
  T v[kPer];
  memcpy(v, &w, kVecBytes);
#pragma unroll
  for (int k = 0; k < kPer; ++k) add(a, v[k]);
}

__device__ __forceinline__ void merge(Acc& a, const Acc& b) {
  a.nan += b.nan;
  a.inf += b.inf;
  a.sum += b.sum;
  a.sumsq += b.sumsq;
  a.mn = fminf(a.mn, b.mn);
  a.mx = fmaxf(a.mx, b.mx);
}

__device__ __forceinline__ void warp_reduce(Acc& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Acc b{__shfl_down_sync(kAll, a.nan, o), __shfl_down_sync(kAll, a.inf, o),
                __shfl_down_sync(kAll, a.sum, o), __shfl_down_sync(kAll, a.sumsq, o),
                __shfl_down_sync(kAll, a.mn, o), __shfl_down_sync(kAll, a.mx, o)};
    merge(a, b);
  }
}

// The block's accumulators, in thread 0. Callers separate two calls by a
// barrier: warp 0 reads the shared slots the next call's lanes 0 write.
__device__ __forceinline__ void block_reduce(Acc& a) {
  __shared__ Acc warps[kThreads / 32];
  warp_reduce(a);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warps[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? warps[lane] : identity();
    warp_reduce(a);
  }
}

// A 16-byte load that bypasses L1 and asks L2 for the whole 256-byte
// sector group (0.6-0.9 us of ~95 faster than __ldcs at the served member).
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// Another block's partial, read past L1 (it was written after this block
// started).
__device__ __forceinline__ Acc load_partial(const Acc* p) {
  return Acc{__ldcg(&p->nan), __ldcg(&p->inf), __ldcg(&p->sum), __ldcg(&p->sumsq),
             __ldcg(&p->mn), __ldcg(&p->mx)};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    field_stats_kernel(const T* __restrict__ x, long long n, double* __restrict__ out,
                       Acc* __restrict__ parts, unsigned* __restrict__ ticket) {
  constexpr int kPer = kVecBytes / sizeof(T);
  Acc a = identity();
  // The scalar head (up to the first 16-byte boundary) and tail (after the
  // last whole vector): fewer than kPer elements each, one a thread.
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long skew = (kVecBytes - reinterpret_cast<uintptr_t>(x) % kVecBytes) % kVecBytes;
  const long long head = min(n, skew / static_cast<long long>(sizeof(T)));
  const long long vectors = (n - head) / kPer;
  const long long body_end = head + vectors * kPer;
  if (g < head) add(a, x[g]);
  if (g < n - body_end) add(a, x[body_end + g]);
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       i < vectors; i += stride) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * kThreads < vectors) w[u] = load_stream(v + i + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * kThreads < vectors) add_vector<T>(a, w[u]);
    }
  }

  block_reduce(a);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = a;
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;  // and back to 0
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  a = identity();
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    merge(a, load_partial(parts + b));
  }
  block_reduce(a);
  if (threadIdx.x == 0) {
    out[0] = static_cast<double>(a.nan);
    out[1] = static_cast<double>(a.inf);
    out[2] = static_cast<double>(n - static_cast<long long>(a.nan + a.inf));
    out[3] = a.sum;
    out[4] = a.sumsq;
    out[5] = a.mn;
    out[6] = a.mx;
  }
}

template <typename T>
int launch(const void* x, long long n, int grid, void* out, void* scratch, void* stream) {
  if (grid < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* words = static_cast<double*>(scratch);
  field_stats_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, static_cast<double*>(out), reinterpret_cast<Acc*>(words + 1),
      reinterpret_cast<unsigned*>(words));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/stats/kernel.py,
// one per element type (bool takes the uint8 one). Each returns the CUDA
// error code of the launch (0 on success). out takes the 7 accumulators;
// scratch holds 1 + 5 * grid doubles, the first word's low 4 bytes the
// ticket, which reads 0 (every launch leaves it so), then the partials.
#define FIELD_STATS_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* x, long long n, int grid, void* out, void* scratch, \
                      void* stream) {                                                 \
    return launch<T>(x, n, grid, out, scratch, stream);                               \
  }

FIELD_STATS_ENTRY(field_stats_f32, float)
FIELD_STATS_ENTRY(field_stats_f64, double)
FIELD_STATS_ENTRY(field_stats_f16, __half)
FIELD_STATS_ENTRY(field_stats_bf16, __nv_bfloat16)
FIELD_STATS_ENTRY(field_stats_u8, uint8_t)
FIELD_STATS_ENTRY(field_stats_i8, int8_t)
FIELD_STATS_ENTRY(field_stats_i16, int16_t)
FIELD_STATS_ENTRY(field_stats_i32, int32_t)
FIELD_STATS_ENTRY(field_stats_i64, int64_t)
