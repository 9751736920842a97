// wkv6_bwd_cuda: the gradient of K7's chunked RWKV-6 WKV recurrence, for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp chunked
// form (repro/kernels/wkv6/ref.py::wkv6_chunked_ref, the prefill and train
// path of repro/models/recurrent.py) with jax.grad, and has no backward
// kernel to port. The port's forward is K7 (csrc/wkv6.cu), so its backward
// is a hand-written kernel too: running the plain chunked form under
// autograd on the card would put a plain version on the training path.
//
// What it computes, per (batch, head) stream and chunk of C steps, with
// logw = log(max(w, 1e-30)), cum its running sum over the chunk, total the
// chunk's sum, r~ = r exp(cum - logw), k~ = k exp(-cum), k^ = k exp(total -
// cum), A = tril(r~ k~^T, -1), P = dy v^T, S the state entering the chunk
// and G the cotangent of the state leaving it:
//   G entering the previous chunk = diag(exp(total)) G + r~^T dy (a reverse
//     scan over the chunks from dS_T; what leaves chunk 0 is dstate0);
//   dv = A^T dy + bonus dy + k^ G,   bonus_t = sum_i r_ti u_i k_ti;
//   dr~ = dy S^T + tril(P, -1) k~,   dr = dr~ exp(cum - logw) + P_tt u k_t;
//   dk~ = tril(P, -1)^T r~, dk^ = v G^T,
//   dk = dk~ exp(-cum) + dk^ exp(total - cum) + P_ss u r_s;
//   du = sum over batch and steps of P_tt r_t k_t;
//   dlogw_tau = sum_{t>tau} dr~ r~ - sum_{s>=tau} dk~ k~ + sum_{s<tau} dk^ k^
//     + exp(total) sum_j G_ij S_ij,   dw = dlogw / w where w > 1e-30.
// r, k, v, w, dy are (B, T, H, N) float32, u (H, N), the states (B, H, N, N);
// C and N are at most 64.
//
// What bounds it on an H100. It must read r, k, v, w, dy, u, state0 and
// dS_T once and write dr, dk, dv, dw, du and dstate0 once: at the trainer's
// shape (4, 256, 40, 64) 102 MB, 31 us at 3.35 TB/s. Per (chunk, head,
// batch) it needs 5 C N^2 multiply-adds (k^T v, r~^T dy, k^ G, dy S^T,
// v G^T) and about 2.5 C^2 N for the triangular products (A, P, A^T dy,
// tril(P) k~, tril(P)^T r~): 2.5 GFLOP there, 38 us at 67 TFLOP/s FP32 on
// the CUDA cores. It is operation-bound, by a little.
//
// What the design does about it: the same split as the forward. Only the
// (N, N) recurrences between chunks are sequential, so one call is three
// launches on the caller's stream, counted as one:
//   (a') wkv6_bwd_chunk, one block per (chunk, head, batch): the chunk's
//        k^T v, r~^T dy and exp(total) into scratch;
//   (b') wkv6_bwd_scan, one thread per state element: the forward scan,
//        leaving in each k^T v slot the state entering that chunk (the
//        states are recomputed, not saved by the forward: the forward's
//        scratch is freed with its call, and this costs one more pass over
//        k, v, w); then the reverse scan of G, leaving in each r~^T dy slot
//        the cotangent of the state leaving that chunk, and dstate0;
//   (c') wkv6_bwd_grad, one block per (chunk, head, batch): the chunk's
//        decay factors, A and P, then dv, dr, dk, the dlogw scan (one
//        thread per channel) and dw, and the chunk's partial du, which the
//        wrapper sums over batch and chunks in a fixed order (no atomics).
// Every product runs on the CUDA cores in FP32 with explicit fused
// multiply-adds: each thread keeps a 4 x 4 register tile of a <= 64 x 64
// output (rows ty + 16 i, columns tx + 16 j) and walks the inner dimension
// through shared memory. Every buffer has an odd row stride (max(C, N) + 1
// floats), so row and column walks alike are free of bank conflicts. The
// triangular products run in full and are masked. (c') holds eleven C x N
// or N x N buffers, 184 KB at C = N = 64: one block of 256 threads per SM.
// Shared-memory loads bound the products (8 loads per 16 multiply-adds),
// so they run at about a quarter of the FP32 peak; tensor cores (the
// forward's 3xTF32 mma.sync), vector loads and a smaller footprint are for
// a later change.
//
// Numerics follow the plain version's order
// (repro_torch/kernels/wkv6/ref.py::wkv6_backward_plain), which sums the
// products and scans in other orders: the two agree to a tolerance.
// Compiled with -fmad=false; the products' fmaf is explicit.
#include "stencil_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 64;  // C and N: one 64 x 64 register-tiled product per block

// Every 2-D buffer of a block: max(C, N) rows of max(C, N) + 1 floats.
struct Geometry {
  int d, ld;
  __host__ __device__ Geometry(int n, int c) : d(n > c ? n : c), ld((n > c ? n : c) + 1) {}
  __host__ __device__ int buf() const { return d * ld; }
  __host__ __device__ int chunk_floats() const { return 5 * buf(); }
  __host__ __device__ int grad_floats() const { return 11 * buf() + 5 * d; }
};

// acc[i][j] += sum_{k < K} a(m_i, k) b(k, n_j) for this thread's outputs
// m_i = ty + 16 i, n_j = tx + 16 j of an M x Nn product (indices past M or
// Nn are clamped to the last row or column; each_output skips their results).
template <typename FA, typename FB>
__device__ __forceinline__ void product(float (&acc)[4][4], int M, int Nn, int K, FA a, FB b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int mi[4], nj[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    mi[q] = min(ty + 16 * q, M - 1);
    nj[q] = min(tx + 16 * q, Nn - 1);
  }
  for (int kk = 0; kk < K; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      av[q] = a(mi[q], kk);
      bv[q] = b(kk, nj[q]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Calls f(m, n, i, j) for each of this thread's outputs inside M x Nn.
template <typename F>
__device__ __forceinline__ void each_output(int M, int Nn, F f) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = ty + 16 * i, n = tx + 16 * j;
      if (m < M && n < Nn) f(m, n, i, j);
    }
  }
}

// rows x cols floats of row stride src_ld into dst (row stride ld).
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          long long src_ld, int rows, int cols) {
  for (int q = threadIdx.x; q < rows * cols; q += kThreads) {
    const int t = q / cols, i = q - t * cols;
    dst[t * ld + i] = src[t * src_ld + i];
  }
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// (a') Per (chunk, head, batch): kv = k^^T v, rdy = r~^T dy (N x N each) and
// decay = exp(total) (N).
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ dy, float* __restrict__ kv, float* __restrict__ rdy,
               float* __restrict__ decay, int T, int H, int N, int C) {
  extern __shared__ float smem[];
  const Geometry geo(N, C);
  const int ld = geo.ld;
  float* Rd = smem;             // r, then r~
  float* Kt = Rd + geo.buf();   // k, then k^
  float* V = Kt + geo.buf();
  float* DY = V + geo.buf();
  float* W = DY + geo.buf();    // w, then log w
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nch = gridDim.x;
  const long long tstride = static_cast<long long>(H) * N;
  const long long base = (static_cast<long long>(b) * T + static_cast<long long>(c) * C) * tstride +
                         static_cast<long long>(h) * N;
  load_rows(Rd, ld, r + base, tstride, C, N);
  load_rows(Kt, ld, k + base, tstride, C, N);
  load_rows(V, ld, v + base, tstride, C, N);
  load_rows(DY, ld, dy + base, tstride, C, N);
  load_rows(W, ld, w + base, tstride, C, N);
  __syncthreads();
  const long long bhc = (static_cast<long long>(b) * H + h) * nch + c;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float total = 0.0f;
    for (int t = 0; t < C; ++t) {
      const float lw = logf(fmaxf(W[t * ld + i], 1e-30f));
      W[t * ld + i] = lw;
      total = total + lw;
    }
    float cum = 0.0f;
    for (int t = 0; t < C; ++t) {
      const float lw = W[t * ld + i];
      cum = cum + lw;
      Rd[t * ld + i] = Rd[t * ld + i] * expf(cum - lw);
      Kt[t * ld + i] = Kt[t * ld + i] * expf(total - cum);
    }
    decay[bhc * N + i] = expf(total);
  }
  __syncthreads();
  float acc[4][4] = {}, acc2[4][4] = {};
  product(acc, N, N, C, [&](int i, int s) { return Kt[s * ld + i]; },
          [&](int s, int j) { return V[s * ld + j]; });
  product(acc2, N, N, C, [&](int i, int t) { return Rd[t * ld + i]; },
          [&](int t, int j) { return DY[t * ld + j]; });
  float* kv_out = kv + bhc * N * N;
  float* rdy_out = rdy + bhc * N * N;
  each_output(N, N, [&](int i, int j, int a, int e) {
    kv_out[i * N + j] = acc[a][e];
    rdy_out[i * N + j] = acc2[a][e];
  });
}

// (b') Per state element (b, h, i, j): the forward scan over chunks, slot c
// of kv becoming the state entering chunk c; then the reverse scan from
// dS_T, slot c of rdy becoming the cotangent of the state leaving chunk c,
// and what leaves chunk 0 the cotangent of state0.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_scan(const float* __restrict__ s0, const float* __restrict__ ds_t,
              float* __restrict__ kv, float* __restrict__ rdy, const float* __restrict__ decay,
              float* __restrict__ ds0, long long elems, int N, int nch) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= elems) return;
  const long long nn = static_cast<long long>(N) * N;
  const long long bh = e / nn, ij = e - bh * nn;
  float* ks = kv + bh * nch * nn + ij;
  float* gs = rdy + bh * nch * nn + ij;
  const float* d = decay + bh * nch * N + ij / N;
  float s = s0[e];
  for (int c = 0; c < nch; ++c) {
    const float x = ks[c * nn];
    ks[c * nn] = s;
    s = d[static_cast<long long>(c) * N] * s + x;
  }
  float g = ds_t[e];
  for (int c = nch - 1; c >= 0; --c) {
    const float x = gs[c * nn];
    gs[c * nn] = g;
    g = d[static_cast<long long>(c) * N] * g + x;
  }
  ds0[e] = g;
}

// (c') Per (chunk, head, batch): dv, dr, dk and dw of the chunk, and its
// partial du (dupart[b][c][h][:]).
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_grad(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ dy,
              const float* __restrict__ states, const float* __restrict__ cotangents,
              float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
              float* __restrict__ dw, float* __restrict__ dupart, int T, int H, int N, int C) {
  extern __shared__ float smem[];
  const Geometry geo(N, C);
  const int ld = geo.ld;
  float* Rd = smem;              // r, then r~
  float* Kd = Rd + geo.buf();    // k, then k~
  float* Kt = Kd + geo.buf();    // k, then k^
  float* V = Kt + geo.buf();
  float* DY = V + geo.buf();     // dy, then dk~ k~
  float* Lw = DY + geo.buf();    // w, then log w
  float* Cm = Lw + geo.buf();    // the running sum of log w
  float* S = Cm + geo.buf();     // the state entering the chunk, then dk^ k^
  float* G = S + geo.buf();      // the cotangent of the state leaving it
  float* At = G + geo.buf();     // tril(r~ k~^T, -1), then dr~ r~
  float* Pl = At + geo.buf();    // tril(dy v^T, -1)
  float* bonus = Pl + geo.buf(); // [C] sum_i r u k
  float* pdiag = bonus + geo.d;  // [C] dy_t . v_t
  float* us = pdiag + geo.d;     // [N] u of this head
  float* tot = us + geo.d;       // [N] total log w
  float* z = tot + geo.d;        // [N] exp(total) sum_j G S
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nch = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tstride = static_cast<long long>(H) * N;
  const long long base = (static_cast<long long>(b) * T + static_cast<long long>(c) * C) * tstride +
                         static_cast<long long>(h) * N;
  const long long nn = static_cast<long long>(N) * N;
  const long long bhc = (static_cast<long long>(b) * H + h) * nch + c;
  load_rows(Rd, ld, r + base, tstride, C, N);
  load_rows(Kd, ld, k + base, tstride, C, N);
  load_rows(Kt, ld, k + base, tstride, C, N);
  load_rows(V, ld, v + base, tstride, C, N);
  load_rows(DY, ld, dy + base, tstride, C, N);
  load_rows(Lw, ld, w + base, tstride, C, N);
  load_rows(S, ld, states + bhc * nn, N, N, N);
  load_rows(G, ld, cotangents + bhc * nn, N, N, N);
  for (int i = threadIdx.x; i < N; i += kThreads) us[i] = u[h * N + i];
  __syncthreads();

  // bonus_t from the raw r and k, one warp per step; then the decay factors
  // in place, one thread per channel.
  for (int t = warp; t < C; t += kWarps) {
    float acc = 0.0f;
    for (int i = lane; i < N; i += 32) acc = acc + (Rd[t * ld + i] * us[i]) * Kd[t * ld + i];
    acc = warp_sum(acc);
    if (lane == 0) bonus[t] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float total = 0.0f;
    for (int t = 0; t < C; ++t) {
      const float lw = logf(fmaxf(Lw[t * ld + i], 1e-30f));
      Lw[t * ld + i] = lw;
      total = total + lw;
    }
    float cum = 0.0f;
    for (int t = 0; t < C; ++t) {
      const int p = t * ld + i;
      const float lw = Lw[p];
      cum = cum + lw;
      Cm[p] = cum;
      Rd[p] = Rd[p] * expf(cum - lw);
      Kd[p] = Kd[p] * expf(-cum);
      Kt[p] = Kt[p] * expf(total - cum);
    }
    tot[i] = total;
  }
  __syncthreads();

  // A = tril(r~ k~^T, -1) and P = dy v^T (its strict lower part and its
  // diagonal); z from G and S, one warp per row.
  {
    float acc[4][4] = {}, acc2[4][4] = {};
    product(acc, C, C, N, [&](int t, int i) { return Rd[t * ld + i]; },
            [&](int i, int s) { return Kd[s * ld + i]; });
    product(acc2, C, C, N, [&](int t, int j) { return DY[t * ld + j]; },
            [&](int j, int s) { return V[s * ld + j]; });
    each_output(C, C, [&](int t, int s, int a, int e) {
      At[t * ld + s] = s < t ? acc[a][e] : 0.0f;
      Pl[t * ld + s] = s < t ? acc2[a][e] : 0.0f;
      if (s == t) pdiag[t] = acc2[a][e];
    });
  }
  for (int i = warp; i < N; i += kWarps) {
    float acc = 0.0f;
    for (int j = lane; j < N; j += 32) acc = acc + G[i * ld + j] * S[i * ld + j];
    acc = warp_sum(acc);
    if (lane == 0) z[i] = expf(tot[i]) * acc;
  }
  __syncthreads();

  // dv[s][j] = (sum_t A[t][s] dy[t][j] + bonus[s] dy[s][j]) + sum_i k^[s][i] G[i][j]
  {
    float acc[4][4] = {}, acc2[4][4] = {};
    product(acc, C, N, C, [&](int s, int t) { return At[t * ld + s]; },
            [&](int t, int j) { return DY[t * ld + j]; });
    product(acc2, C, N, N, [&](int s, int i) { return Kt[s * ld + i]; },
            [&](int i, int j) { return G[i * ld + j]; });
    each_output(C, N, [&](int s, int j, int a, int e) {
      dv[base + s * tstride + j] = (acc[a][e] + bonus[s] * DY[s * ld + j]) + acc2[a][e];
    });
  }
  __syncthreads();  // A is dead: dr~ r~ takes its place

  // dr~[t][i] = sum_j dy[t][j] S[i][j] + sum_s tril(P)[t][s] k~[s][i]
  {
    float acc[4][4] = {}, acc2[4][4] = {};
    product(acc, C, N, N, [&](int t, int j) { return DY[t * ld + j]; },
            [&](int j, int i) { return S[i * ld + j]; });
    product(acc2, C, N, C, [&](int t, int s) { return Pl[t * ld + s]; },
            [&](int s, int i) { return Kd[s * ld + i]; });
    each_output(C, N, [&](int t, int i, int a, int e) {
      const int p = t * ld + i;
      const float drd = acc[a][e] + acc2[a][e];
      At[p] = drd * Rd[p];
      dr[base + t * tstride + i] =
          drd * expf(Cm[p] - Lw[p]) + (pdiag[t] * us[i]) * k[base + t * tstride + i];
    });
  }
  __syncthreads();  // dy and S are dead: dk~ k~ and dk^ k^ take their places

  // dk~[s][i] = sum_t tril(P)[t][s] r~[t][i], dk^[s][i] = sum_j v[s][j] G[i][j]
  {
    float acc[4][4] = {}, acc2[4][4] = {};
    product(acc, C, N, C, [&](int s, int t) { return Pl[t * ld + s]; },
            [&](int t, int i) { return Rd[t * ld + i]; });
    product(acc2, C, N, N, [&](int s, int j) { return V[s * ld + j]; },
            [&](int j, int i) { return G[i * ld + j]; });
    each_output(C, N, [&](int s, int i, int a, int e) {
      const int p = s * ld + i;
      DY[p] = acc[a][e] * Kd[p];
      S[p] = acc2[a][e] * Kt[p];
      dk[base + s * tstride + i] =
          (acc[a][e] * expf(-Cm[p]) + acc2[a][e] * expf(tot[i] - Cm[p])) +
          (pdiag[s] * us[i]) * r[base + s * tstride + i];
    });
  }
  __syncthreads();

  // dlogw and dw, then the chunk's du, one thread per channel.
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float before = 0.0f;
    for (int t = 0; t < C; ++t) {  // sum_{s<t} dk^ k^, in place
      const float x = S[t * ld + i];
      S[t * ld + i] = before;
      before = before + x;
    }
    float after_q = 0.0f, from_p = 0.0f, du_acc = 0.0f;
    for (int t = C - 1; t >= 0; --t) {
      const int p = t * ld + i;
      const long long gi = base + t * tstride + i;
      from_p = from_p + DY[p];
      const float dlogw = ((after_q - from_p) + S[p]) + z[i];
      const float wt = w[gi];
      dw[gi] = wt > 1e-30f ? dlogw / wt : 0.0f;
      after_q = after_q + At[p];
      du_acc = du_acc + (pdiag[t] * r[gi]) * k[gi];
    }
    dupart[((static_cast<long long>(b) * nch + c) * H + h) * N + i] = du_acc;
  }
}

}  // namespace

// C entry point, bound with ctypes by repro_torch/kernels/wkv6/kernel.py:
// launches the three passes back to back on ``stream``. ``kv`` and ``rdy``
// (B*H*nch*N*N floats), ``decay`` (B*H*nch*N) are scratch and ``dupart``
// (B*nch*H*N) the per-chunk du the wrapper allocates. Returns the first CUDA
// error code of the launches (0 on success). The wrapper checks shapes,
// dtypes and contiguity, that chunk divides t, and that n and chunk are at
// most 64 (then (c') takes at most 184 KB of shared memory a block).
extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s0, const void* dy, const void* ds_t,
                            void* dr, void* dk, void* dv, void* dw, void* dupart, void* ds0,
                            void* kv, void* rdy, void* decay, int batch, int t, int heads,
                            int n, int chunk, void* stream) {
  static size_t reserved_chunk = 0, reserved_grad = 0;
  if (n > kMaxDim || chunk > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo(n, chunk);
  const size_t smem_chunk = sizeof(float) * geo.chunk_floats();
  const size_t smem_grad = sizeof(float) * geo.grad_floats();
  int err = repro_torch::reserve_smem(wkv6_bwd_chunk, smem_chunk, reserved_chunk);
  if (err) return err;
  err = repro_torch::reserve_smem(wkv6_bwd_grad, smem_grad, reserved_grad);
  if (err) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nch = t / chunk;
  const dim3 grid(nch, heads, batch);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* dyf = static_cast<const float*>(dy);
  float* kvf = static_cast<float*>(kv);
  float* rdyf = static_cast<float*>(rdy);
  float* decf = static_cast<float*>(decay);
  wkv6_bwd_chunk<<<grid, kThreads, smem_chunk, st>>>(rf, kf, vf, wf, dyf, kvf, rdyf, decf, t,
                                                      heads, n, chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long elems = static_cast<long long>(batch) * heads * n * n;
  wkv6_bwd_scan<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(s0), static_cast<const float*>(ds_t), kvf, rdyf, decf,
      static_cast<float*>(ds0), elems, n, nch);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  wkv6_bwd_grad<<<grid, kThreads, smem_grad, st>>>(
      rf, kf, vf, wf, static_cast<const float*>(u), dyf, kvf, rdyf, static_cast<float*>(dr),
      static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dw),
      static_cast<float*>(dupart), t, heads, n, chunk);
  return static_cast<int>(cudaGetLastError());
}
