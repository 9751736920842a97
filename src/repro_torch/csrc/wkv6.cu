// K7 wkv6_cuda: the chunked RWKV-6 WKV recurrence for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
//   repro/kernels/wkv6/kernel.py::wkv6_pallas (_wkv6_kernel):
// per (batch, head) stream, with an (N, N) float32 state S[k_dim][v_dim],
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
// computed CHUNK steps at a time: the cumulative log-decay of the chunk, the
// inter-chunk term r_dec @ S, the strictly-lower intra-chunk term
// (r_dec k_dec^T) @ v, the bonus sum(r * u * k) * v, and the state update
// S <- diag(exp(total)) S + k_tail^T v. r, k, v, w are (B, T, H, N) float32,
// u is (H, N), the state (B, H, N, N); y and the final state come out in
// float32. T is a multiple of the chunk.
//
// What bounds it on an H100. Each launch must read r, k, v, w and the state
// once and write y and the state once; at the serving shape (1, 512, 40, 64)
// that is 27.5 MB, 8.2 us at 3.35 TB/s. Per chunk and head, r_dec @ S and
// k_tail^T v are C N^2 multiply-adds each and the two strictly-lower
// products C (C - 1) / 2 * N each: 0.50 GFLOP in all, 7.5 us at 67 TFLOP/s
// FP32 on the CUDA cores, 1 us on the tensor cores. It is bytes-bound.
//
// What the design does about it. Only the (N, N) state recurrence between
// chunks is sequential; everything else is independent per chunk. So one
// call is three launches on the caller's stream, two of them with one block
// per (chunk, head, batch) (8 x 40 = 320 blocks at the serving shape):
//   (a) wkv6_chunk_state: the chunk's k_tail^T v and exp(total) into scratch;
//   (b) wkv6_state_scan: per state element, S_c = exp(total_{c-1}) S_{c-1} +
//       (k_tail^T v)_{c-1} over the chunks, written over the scratch (slot c
//       then holds the state entering chunk c + 1), and the final state;
//   (c) wkv6_chunk_output: y = (r_dec S_c + tril(r_dec k_dec^T, -1) v) + bonus v.
// Each block computes its chunk's decay factors and its C x C attention once.
// A chunk arrives by 16-byte cp.async copies, all in flight at once; the
// running sum of log w is split into runs of steps, one thread each, so the
// whole block scans. The three products of (c) and the one of (a) run on the
// tensor cores as mma.sync m16n8k8 TF32 in the 3xTF32 split: x = big +
// small, both TF32, and a b = a_small b_big + a_big b_small + a_big b_big
// summed in FP32, which keeps FP32-level error where plain TF32 keeps about
// three digits. N and C are padded to multiples of 16 with zeros in shared
// memory (exact for these products); row strides of N + 4 / N + 8 words make
// every fragment load conflict-free. In (c) the entering state is loaded into
// k_dec's buffer once the attention is done, so one block takes 73 KB and
// three share an SM. (b) and (c) are launched as programmatic dependents of
// the launch before them: (c) loads its chunk, scans and computes its
// attention while (b) runs, and waits for (b) only before it reads the state. The passes re-read r/k/v/w and move the scratch
// (k_tail^T v written, read, the entering states written, read): at the
// serving shape about 63 MB instead of the compulsory 27.5 MB, most of it
// from L2.
//
// What bounds it now, on an H100 80GB HBM3 at 700 W (scripts/kernel_bench.py):
// 43 us a call at the serving shape, 5.2x its 8.2 us bound; (c) takes 29
// us of it, (a) 16, (b) 12, partly overlapped. All resident blocks
// of a pass run the same phase at once (load, scan, products), so within a
// pass the phases do not overlap: the 3xTF32 products at mma.sync rates,
// then the loads, are the largest. A persistent, warp-specialised kernel,
// or wgmma, is the next step.
//
// Numerics follow the Pallas kernel's order: logw = log(max(w, 1e-30)), cum a
// running sum over the chunk, r_dec = r exp(cum - logw), k_dec = k exp(-cum),
// k_tail = k exp(total - cum), y = (y_inter + y_intra) + y_bonus, the state
// update exp(total) * S + k_tail^T v; compiled with -fmad=false (mma is not
// affected). The plain version beside the wrapper
// (repro_torch/kernels/wkv6/ref.py::wkv6_plain) runs the same three passes
// in PyTorch and sums in another order: the two agree to a tolerance.
#include "wkv6_common.cuh"

using namespace repro_torch::wkv6;

namespace {

// Padded sizes and row strides (in floats) of one chunk's arrays.
struct Geometry {
  int np, cp;  // N and C rounded up to 16
  int lr;      // rows read as A[m][k] or as a "col" B[n][k]: np + 4
  int lv;      // rows read as B[k][n] or as a transposed A[k][m]: np + 8
  int la;      // the attention matrix, read as A[t][s]: cp + 4
  __host__ __device__ Geometry(int n, int c)
      : np((n + 15) / 16 * 16), cp((c + 15) / 16 * 16), lr(np + 4), lv(np + 8), la(cp + 4) {}
  __host__ __device__ int x1() const { return cp * (lr > la ? lr : la); }
  __host__ __device__ int state_floats() const { return 2 * cp * lv + cp * lr + kThreads; }
  __host__ __device__ int x2() const { return cp * lr > np * lv ? cp * lr : np * lv; }
  __host__ __device__ int output_floats() const {
    return cp * lr + x2() + cp * lv + x1() + cp + np + kThreads;
  }
};

// (a) Per (chunk, head, batch): kv = k_tail^T v (N x N) and decay = exp(total) (N).
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_state(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ w, float* __restrict__ kv, float* __restrict__ decay,
                 int T, int H, int N, int C, int vec) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo(N, C);
  float* Kt = smem;                    // [cp][lv]  k, then k_tail
  float* V = Kt + geo.cp * geo.lv;     // [cp][lv]
  float* W = V + geo.cp * geo.lv;      // [cp][lr]  w, then log w
  float* tot = W + geo.cp * geo.lr;    // [kThreads]  run totals of the running sum
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nch = gridDim.x;
  allow_dependents();  // the scan may be scheduled; it waits for this grid
  const int warp = threadIdx.x >> 5;
  const long long tstride = static_cast<long long>(H) * N;
  const long long base = (static_cast<long long>(b) * T + static_cast<long long>(c) * C) * tstride +
                         static_cast<long long>(h) * N;
  load_block(Kt, geo.lv, k + base, tstride, C, N, geo.cp, geo.np, vec);
  load_block(V, geo.lv, v + base, tstride, C, N, geo.cp, geo.np, vec);
  load_block(W, geo.lr, w + base, tstride, C, N, geo.cp, geo.np, vec);
  copy_wait();
  __syncthreads();
  const long long bhc = (static_cast<long long>(b) * H + h) * nch + c;
  chunk_scan(W, geo.lr, tot, N, C, geo.np, [&](int t, int i, float cum, float, float total) {
    Kt[t * geo.lv + i] = Kt[t * geo.lv + i] * expf(total - cum);
    if (t == C - 1) decay[bhc * N + i] = expf(total);
  });
  __syncthreads();

  // kv[i][j] = sum_s k_tail[s][i] v[s][j]: 16 x 32 output tiles, one per warp item.
  const int ng = (geo.np + 31) / 32;
  float* out = kv + bhc * N * N;
  for (int item = warp; item < (geo.np / 16) * ng; item += kWarps) {
    const int m0 = item / ng * 16, n0 = item % ng * 32, nq = min(4, (geo.np - n0) / 8);
    float acc[4][4] = {};
    product(
        acc, [&](int m, int s) { return Kt[s * geo.lv + m]; },
        [&](int s, int n) { return V[s * geo.lv + n]; }, m0, n0, nq, 0, geo.cp);
    for (int q = 0; q < nq; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = acc_row(m0, e), j = acc_col(n0, q, e);
        if (i < N && j < N) out[i * N + j] = acc[q][e];
      }
    }
  }
}

// (b) Per state element: the recurrence over chunks. kv slot c is replaced by
// the state entering chunk c + 1; the last chunk's result is the final state.
__global__ void __launch_bounds__(kThreads)
wkv6_state_scan(const float* __restrict__ s0, float* __restrict__ kv,
                const float* __restrict__ decay, float* __restrict__ s_out, long long elems,
                int N, int nch) {
  allow_dependents();      // the output pass may start its state-free phases
  wait_for_prerequisite();  // every chunk's k_tail^T v and exp(total) are written
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= elems) return;
  const long long nn = static_cast<long long>(N) * N;
  const long long bh = e / nn, ij = e - bh * nn;
  float* slot = kv + bh * nch * nn + ij;
  const float* d = decay + bh * nch * N + ij / N;
  float s = s0[e];
#pragma unroll 8
  for (int c = 0; c < nch; ++c) {
    s = d[static_cast<long long>(c) * N] * s + slot[c * nn];
    if (c + 1 < nch) slot[c * nn] = s;
  }
  s_out[e] = s;
}

// (c) Per (chunk, head, batch): y = (r_dec S + att v) + bonus v, S the state
// entering the chunk (s0 for the first, else scan slot c - 1).
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_output(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  const float* __restrict__ states, float* __restrict__ y, int T, int H, int N,
                  int C, int vec) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo(N, C);
  float* R = smem;                       // [cp][lr]  r, then r_dec
  float* Kd = R + geo.cp * geo.lr;       // [cp][lr]  k, then k_dec, then
  float* S = Kd;                         // [np][lv]  the state entering the chunk
  float* V = Kd + geo.x2();              // [cp][lv]
  float* X1 = V + geo.cp * geo.lv;       // [cp][lr] w, then [cp][la] attention
  float* bonus = X1 + geo.x1();          // [cp]
  float* us = bonus + geo.cp;            // [np]
  float* tot = us + geo.np;              // [kThreads]  run totals of the running sum
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nch = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tstride = static_cast<long long>(H) * N;
  const long long base = (static_cast<long long>(b) * T + static_cast<long long>(c) * C) * tstride +
                         static_cast<long long>(h) * N;
  const long long nn = static_cast<long long>(N) * N;
  const long long bh = static_cast<long long>(b) * H + h;
  load_block(R, geo.lr, r + base, tstride, C, N, geo.cp, geo.np, vec);
  load_block(Kd, geo.lr, k + base, tstride, C, N, geo.cp, geo.np, vec);
  load_block(V, geo.lv, v + base, tstride, C, N, geo.cp, geo.np, vec);
  load_block(X1, geo.lr, w + base, tstride, C, N, geo.cp, geo.np, vec);
  for (int i = threadIdx.x; i < geo.np; i += kThreads) us[i] = i < N ? u[h * N + i] : 0.0f;
  copy_wait();
  __syncthreads();

  // bonus[t] = sum_i (r u) k, one warp per step, from the raw r and k; then
  // the decay factors in place.
  for (int t = warp; t < C; t += kWarps) {
    float acc = 0.0f;
    for (int i = lane; i < N; i += 32) acc = acc + (R[t * geo.lr + i] * us[i]) * Kd[t * geo.lr + i];
#pragma unroll
    for (int off = 16; off; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) bonus[t] = acc;
  }
  chunk_scan(X1, geo.lr, tot, N, C, geo.np, [&](int t, int i, float cum, float lw, float) {
    const int p = t * geo.lr + i;
    R[p] = R[p] * expf(cum - lw);
    Kd[p] = Kd[p] * expf(-cum);
  });
  __syncthreads();

  // att = tril(r_dec k_dec^T, -1) into X1.
  const int mt = geo.cp / 16, cg = (geo.cp + 31) / 32;
  for (int item = warp; item < mt * cg; item += kWarps) {
    const int m0 = item / cg * 16, n0 = item % cg * 32;
    const int width = min(geo.cp, m0 + 16) - n0;  // only columns s < t can be nonzero
    if (width <= 0) continue;
    const int nq = min(4, (width + 7) / 8);
    float acc[4][4] = {};
    product(
        acc, [&](int t, int i) { return R[t * geo.lr + i]; },
        [&](int i, int s) { return Kd[s * geo.lr + i]; }, m0, n0, nq, 0, geo.np);
    for (int q = 0; q < nq; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(m0, e), s = acc_col(n0, q, e);
        X1[t * geo.la + s] = s < t ? acc[q][e] : 0.0f;
      }
    }
  }
  __syncthreads();
  // k_dec is dead: the entering state takes its place (so three blocks share an
  // SM). Everything above overlaps the scan over chunks; the state waits for it.
  wait_for_prerequisite();
  load_block(S, geo.lv, c == 0 ? s0 + bh * nn : states + (bh * nch + c - 1) * nn, N, N, N,
             geo.np, geo.np, vec);
  copy_wait();
  __syncthreads();

  // y[t][j] = (sum_i r_dec[t][i] S[i][j] + sum_{s <= t} att[t][s] v[s][j]) + bonus[t] v[t][j]
  const int ng = (geo.np + 31) / 32;
  for (int item = warp; item < mt * ng; item += kWarps) {
    const int m0 = item / ng * 16, n0 = item % ng * 32, nq = min(4, (geo.np - n0) / 8);
    float acc[4][4] = {};
    product(
        acc, [&](int t, int i) { return R[t * geo.lr + i]; },
        [&](int i, int j) { return S[i * geo.lv + j]; }, m0, n0, nq, 0, geo.np);
    product(
        acc, [&](int t, int s) { return X1[t * geo.la + s]; },
        [&](int s, int j) { return V[s * geo.lv + j]; }, m0, n0, nq, 0, min(geo.cp, m0 + 16));
    for (int q = 0; q < nq; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = acc_row(m0, e), j = acc_col(n0, q, e);
        if (t < C && j < N) y[base + t * tstride + j] = acc[q][e] + bonus[t] * V[t * geo.lv + j];
      }
    }
  }
}

}  // namespace

// Dynamic shared memory the larger of the two chunk passes needs per block
// for head size n and chunk c (the wrapper checks it against the card's limit).
extern "C" int wkv6_smem_bytes(int n, int c) {
  const Geometry geo(n, c);
  const int floats = geo.output_floats() > geo.state_floats() ? geo.output_floats()
                                                              : geo.state_floats();
  return static_cast<int>(sizeof(float)) * floats;
}

// C entry point, bound with ctypes by repro_torch/kernels/wkv6/kernel.py:
// launches the three passes back to back on ``stream``. ``kv`` (B*H*nch*N*N
// floats) and ``decay`` (B*H*nch*N) are scratch the wrapper allocates.
// Returns the first CUDA error code of the launches (0 on success). The
// wrapper checks shapes, dtypes and contiguity, and that chunk divides t.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out, void* kv,
                        void* decay, int batch, int t, int heads, int n, int chunk,
                        void* stream) {
  static size_t reserved_state = 0, reserved_output = 0;
  const Geometry geo(n, chunk);
  const size_t smem_state = sizeof(float) * geo.state_floats();
  const size_t smem_output = sizeof(float) * geo.output_floats();
  int err = repro_torch::reserve_smem(wkv6_chunk_state, smem_state, reserved_state);
  if (err) return err;
  err = repro_torch::reserve_smem(wkv6_chunk_output, smem_output, reserved_output);
  if (err) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nch = t / chunk;
  const dim3 grid(nch, heads, batch);
  // 16-byte copies when every row and base address is a multiple of 4 words.
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = n % 4 == 0 && al(r) && al(k) && al(v) && al(w) && al(s0) && al(kv);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  wkv6_chunk_state<<<grid, kThreads, smem_state, st>>>(kf, vf, wf, static_cast<float*>(kv),
                                                      static_cast<float*>(decay), t, heads, n,
                                                      chunk, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long elems = static_cast<long long>(batch) * heads * n * n;
  err = launch_dependent(wkv6_state_scan, dim3(static_cast<unsigned>((elems + kThreads - 1) /
                                                                     kThreads)),
                         0, st, s0, kv, decay, s_out, elems, n, nch);
  if (err) return err;
  return launch_dependent(wkv6_chunk_output, grid, smem_output, st, r, kf, vf, wf, u, s0, kv, y,
                          t, heads, n, chunk, vec);
}
