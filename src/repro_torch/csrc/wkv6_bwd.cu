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
// shape (4, 256, 40, 64) 102 MB, 30.5 us at 3.35 TB/s. Per (chunk, head,
// batch) it needs 5 C N^2 multiply-adds (k^T v, r~^T dy, k^ G, dy S^T,
// v G^T) and about 2.5 C^2 N for the triangular products (A, P, A^T dy,
// tril(P) k~, tril(P)^T r~): 2.5 GFLOP there. On the tensor cores in 3xTF32
// (three TF32 multiply-adds a product term, 495 TFLOP/s) that is about
// 15 us, so it is bytes-bound.
//
// What the design does about it. Only the (N, N) recurrences between chunks
// are sequential, so one call is three launches on the caller's stream,
// counted as one:
//   (a') wkv6_bwd_chunk, one block per (chunk, head, batch): the chunk's
//        k^T v, r~^T dy and exp(total) into scratch; four C x N arrays,
//        dy arriving in v's place once k^T v is done, so three blocks
//        share an SM;
//   (b') wkv6_bwd_scan, one thread per state element: the forward scan,
//        leaving in each k^T v slot the state entering that chunk (the
//        states are recomputed, not saved by the forward: the forward's
//        scratch is freed with its call, and this costs one more pass over
//        k, v, w); then the reverse scan of G, leaving in each r~^T dy slot
//        the cotangent of the state leaving that chunk, and dstate0. Both
//        run at once, their loads batched kScanRun chunks at a time;
//   (c') wkv6_bwd_grad, one block per (chunk, head, batch): dv, dr, dk, dw
//        and the chunk's partial du, which the wrapper sums over batch and
//        chunks in a fixed order (no atomics).
// The three run in stream order: launched as programmatic dependents, so
// that (c')'s state-free phases overlap (b'), they were no faster. The
// products run on the tensor cores as mma.sync m16n8k8 in 3xTF32
// (wkv6_common.cuh: x = big + small, both TF32, three products summed in
// FP32), one 16 x 32 output tile a warp, N and C padded to multiples of 16
// with zeros in shared memory, row strides of N + 4 / N + 8 / C + 8 words
// so that the fragment loads of an array read one way are free of bank
// conflicts. The triangular products skip the tiles and k-steps that lie
// wholly above the diagonal. Chunks arrive by 16-byte cp.async copies, w
// first, so that its logs start while the rest arrives.
//
// The exceptions are P, tril(P)^T r~ and tril(P) k~, which make q = dr~ r~
// and pk = dk~ k~: they run in FP32 on the CUDA cores, k in order, as the
// plain version's matmuls sum. At strong decay (w down to 0.05) dlogw is a
// small difference of sums of q and pk, and dw = dlogw / w; the plain
// version's own dw is about its tolerance (1e-5 max|dw| + 1e-6) away from
// a float64 sum there, so the kernel has to round as it does, not merely
// as well. With those three products in 3xTF32, dw left the plain version
// by up to 1.23 times its tolerance on 10 seeds at (2, 128, 3, 64); as
// built, by at most 0.16 times (scripts/k7_bwd_variants.py).
//
// (c') keeps its footprint to six C x N regions (112,896 bytes at C = N =
// 64), so two blocks share an SM: buffers whose lives do not overlap share a
// region, and what (c') needs late arrives late. r, k, v, dy and w load
// first; the scan turns them into r~, k~ and cum in place (and the chunk's
// du); A, then tril(P), take the sixth region in turn; the state-free
// products A^T dy (+ bonus dy), tril(P)^T r~ and tril(P) k~ go into
// registers that each warp keeps for its tile. S arrives in v's region
// while the triangular products run, and k in the sixth after them. dr~
// = dy S^T + tril(P) k~; dr, q = dr~ r~ and pk = dk~ k~ (over r~ and k~)
// follow.
// Then G takes dy's region, v returns to its own, k becomes k^ = k
// exp(total - cum) in place, dv = (A^T dy + bonus dy) + k^ G and dk^ = v G^T
// finish dv and dk, and hk = dk^ k^ goes over k^. dw comes from the running
// sums of q, pk and hk, with w loaded into v's region meanwhile.
//
// What bounds it now, on an H100 80GB HBM3 at 700 W (scripts/kernel_bench.py
// --cold --profile, scripts/k7_phase_probe.py, scripts/k7_bwd_variants.py):
// 336-337 us a call cold at (4, 256, 40, 64), 11 times its 30.5 us bound,
// and 202-203 us at (1, 512, 40, 64); (c') takes 252-254 and 155 us of
// it, (a') 46 and 24, (b') 21 and 7. A (c') block runs ~15 phases between
// barriers (87 us), in lock-step with the other block on its SM: the
// chunk's first loads, the FP32 products, the dr epilogue and the 3xTF32
// products at mma.sync rates are the largest. One block alone on an SM
// would run more phases at once but leave the SM idler (383 us at (4, 256,
// 40, 64) with one block an SM), and the 640 blocks fill 2.42 rounds of
// the 264 places, so three rounds run. More warps an SM (fewer registers a
// thread), wgmma, or a footprint small enough for three blocks an SM are
// the next steps.
//
// Numerics follow the plain version's order
// (repro_torch/kernels/wkv6/ref.py::wkv6_backward_plain) in every
// elementwise step and in the running sums: cum, cum - log w and total are
// its bits, the sums of q, pk and hk behind dw run step by step as its
// cumsums do, and dr~ adds dy S^T to tril(P) k~ as it does. It sums in other
// orders in the 3xTF32 products (the two halves of dv accumulate in one
// sum), the diagonal of P and the bonus (a warp's dot products), z (four
// threads a row) and du (each thread's steps, then the threads); the two
// agree to a tolerance. Compiled with -fmad=false; the mma instructions are
// not affected by it.
#include "wkv6_common.cuh"

using namespace repro_torch::wkv6;

namespace {

constexpr int kMaxDim = 64;   // C and N: one 16 x 32 output tile per warp covers a 64 x 64 product
constexpr int kScanRun = 8;   // chunks whose loads (b') issues together
constexpr int kScanWarps = kMaxDim / 32;  // warps holding the threads of one sequential sum
constexpr int kBatch = 8;     // steps a sequential sum loads ahead

// Padded sizes and row strides (in floats) of a block's arrays.
struct Geometry {
  int np, cp;  // N and C rounded up to 16
  int lr;      // C x N or N x N rows read along the product's k: np + 4
  int lv;      // C x N or N x N rows read across k: np + 8
  int lt;      // the C x C matrices, read across k: cp + 8
  int d;       // max(np, cp)
  __host__ __device__ Geometry(int n, int c)
      : np((n + 15) / 16 * 16), cp((c + 15) / 16 * 16), lr(np + 4), lv(np + 8), lt(cp + 8),
        d(np > cp ? np : cp) {}
  // One region of (c'): any of its occupants, d rows of d + 8 floats.
  __host__ __device__ int region() const { return d * (d + 8); }
  __host__ __device__ int chunk_floats() const { return 4 * cp * lv + np; }
  __host__ __device__ int grad_floats() const { return 6 * region() + kThreads + 2 * cp + 3 * np; }
};

// The same tile in FP32 on the CUDA cores: each lane its 4 kNq outputs in
// the mma accumulator layout, k in order, one fmaf a term. b2(k, n) gives
// the pair b(k, n), b(k, n + 1) (n even).
template <int kNq, typename FA, typename FB2>
__device__ __forceinline__ void warp_product_f32(float (&acc)[4][4], FA a, FB2 b2, int m0, int n0,
                                                 int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  for (int kk = k0; kk < k1; ++kk) {
    const float a0 = a(m0 + g, kk), a1 = a(m0 + g + 8, kk);
#pragma unroll
    for (int q = 0; q < kNq; ++q) {
      const float2 bq = b2(kk, n0 + 8 * q + 2 * tq);
      acc[q][0] = fmaf(a0, bq.x, acc[q][0]);
      acc[q][1] = fmaf(a0, bq.y, acc[q][1]);
      acc[q][2] = fmaf(a1, bq.x, acc[q][2]);
      acc[q][3] = fmaf(a1, bq.y, acc[q][3]);
    }
  }
}

// product() (wkv6_common.cuh) in FP32 on the CUDA cores.
template <typename FA, typename FB2>
__device__ __forceinline__ void product_f32(float (&acc)[4][4], FA a, FB2 b2, int m0, int n0,
                                            int nq, int k0, int k1) {
  if (nq == 4) {
    warp_product_f32<4>(acc, a, b2, m0, n0, k0, k1);
  } else {
    warp_product_f32<2>(acc, a, b2, m0, n0, k0, k1);
  }
}

// Calls f(t, i) for every step t < C of every channel i < N, by the whole
// block: thread q takes channel q % np and steps t = q / np (mod kThreads /
// np), so a warp's threads take consecutive channels.
template <typename F>
__device__ __forceinline__ void each_step(int N, int C, int np, F f) {
  const int nseg = kThreads / np, s = threadIdx.x / np, i = threadIdx.x - s * np;
  if (i < N && s < nseg) {
    for (int t = s; t < C; t += nseg) f(t, i);
  }
}

// log w = log(max(w, 1e-30)) in place, by the whole block.
__device__ __forceinline__ void log_decay(float* W, int ld, int N, int C, int np) {
  each_step(N, C, np, [&](int t, int i) { W[t * ld + i] = logf(fmaxf(W[t * ld + i], 1e-30f)); });
}

// The running sum of log w over the chunk, added step by step per channel
// as the plain version's cumsum adds, so that cum, cum - log w and total
// are its bits (a sum in runs rounds otherwise, and at strong decay, cum ~
// -50, an ulp of cum moves exp(cum) by 1e-5 of itself). W holds log w on
// entry and cum on exit, total[i] gets the chunk's sum, and the thread that
// adds step t of channel i calls h(t * ld + i, cum - log w). While the
// first kScanWarps warps add, the others call g(). Then the block calls
// f(t, i) for every step (each_step). Contains a __syncthreads().
template <typename G, typename H, typename F>
__device__ __forceinline__ void ordered_scan(float* W, int ld, float* total, int N, int C, int np,
                                             G g, H h, F f) {
  if (threadIdx.x < N) {
    float cum = 0.0f;
    for (int t0 = 0; t0 < C; t0 += kBatch) {  // loads a batch ahead of its sums
      float lw[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (t0 + j < C) lw[j] = W[(t0 + j) * ld + threadIdx.x];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (t0 + j < C) {
          const int p = (t0 + j) * ld + threadIdx.x;
          cum = cum + lw[j];
          W[p] = cum;
          h(p, cum - lw[j]);
        }
      }
    }
    total[threadIdx.x] = cum;
  } else if (threadIdx.x >= 32 * kScanWarps) {
    g();
  }
  __syncthreads();
  each_step(N, C, np, f);
}

// Calls f(m, n, q, e) for each accumulator element of this warp's 16 x 32
// tile at (m0, n0) that lies inside M x Nn.
template <typename F>
__device__ __forceinline__ void each_acc(int m0, int n0, int nq, int M, int Nn, F f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = acc_row(m0, e), n = acc_col(n0, q, e);
      if (q < nq && m < M && n < Nn) f(m, n, q, e);
    }
  }
}

// Global loads and stores of this warp's tile in the accumulator layout,
// at(m, n) the element's offset: with pairs (rows of an even count and an
// 8-byte aligned base, so that every pair is aligned) a lane's two adjacent
// columns by one 8-byte access, else word by word.
template <typename At>
__device__ __forceinline__ void load_tile(float (&v)[4][4], const float* __restrict__ g, At at,
                                          int m0, int n0, int nq, int M, int Nn, bool pairs) {
  if (pairs) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int m = acc_row(m0, e), n = acc_col(n0, q, e);
        if (q < nq && m < M && n < Nn) {
          const float2 x = *reinterpret_cast<const float2*>(g + at(m, n));
          v[q][e] = x.x;
          v[q][e + 1] = x.y;
        }
      }
    }
  } else {
    each_acc(m0, n0, nq, M, Nn, [&](int m, int n, int q, int e) { v[q][e] = g[at(m, n)]; });
  }
}
template <typename At>
__device__ __forceinline__ void store_tile(float* __restrict__ g, At at, const float (&v)[4][4],
                                           int m0, int n0, int nq, int M, int Nn, bool pairs) {
  if (pairs) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int m = acc_row(m0, e), n = acc_col(n0, q, e);
        if (q < nq && m < M && n < Nn) {
          *reinterpret_cast<float2*>(g + at(m, n)) = make_float2(v[q][e], v[q][e + 1]);
        }
      }
    }
  } else {
    each_acc(m0, n0, nq, M, Nn, [&](int m, int n, int q, int e) { g[at(m, n)] = v[q][e]; });
  }
}

// (a') Per (chunk, head, batch): kv = k^^T v, rdy = r~^T dy (N x N each) and
// decay = exp(total) (N). Four C x N arrays (74 KB at C = N = 64, so three
// blocks share an SM): dy arrives in v's place once k^^T v is done.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ dy, float* __restrict__ kv, float* __restrict__ rdy,
               float* __restrict__ decay, int T, int H, int N, int C, int vec, int pairs) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo(N, C);
  const int lv = geo.lv, cl = geo.cp * lv;
  float* Kt = smem;        // [cp][lv]  k, then k^
  float* VD = Kt + cl;     // [cp][lv]  v, then dy
  float* Rd = VD + cl;     // [cp][lv]  r, then r~
  float* W = Rd + cl;      // [cp][lv]  w, then cum
  float* total = W + cl;   // [np]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nch = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const long long tstride = static_cast<long long>(H) * N;
  const long long base = (static_cast<long long>(b) * T + static_cast<long long>(c) * C) * tstride +
                         static_cast<long long>(h) * N;
  load_block(W, lv, w + base, tstride, C, N, geo.cp, geo.np, vec);
  copy_commit();
  load_block(Kt, lv, k + base, tstride, C, N, geo.cp, geo.np, vec);
  load_block(VD, lv, v + base, tstride, C, N, geo.cp, geo.np, vec);
  load_block(Rd, lv, r + base, tstride, C, N, geo.cp, geo.np, vec);
  copy_commit();
  copy_wait_but<1>();  // w; the logs overlap the rest
  __syncthreads();
  log_decay(W, lv, N, C, geo.np);
  copy_wait();
  __syncthreads();
  const long long bhc = (static_cast<long long>(b) * H + h) * nch + c;
  ordered_scan(
      W, lv, total, N, C, geo.np, [] {}, [&](int p, float e) { Rd[p] = Rd[p] * expf(e); },
      [&](int t, int i) {
        const int p = t * lv + i;
        Kt[p] = Kt[p] * expf(total[i] - W[p]);
        if (t == C - 1) decay[bhc * N + i] = expf(total[i]);
      });
  __syncthreads();

  // kv[i][j] = sum_s k^[s][i] v[s][j], then rdy[i][j] = sum_t r~[t][i]
  // dy[t][j]: 16 x 32 output tiles, one per warp item.
  const int ng = (geo.np + 31) / 32, items = geo.np / 16 * ng;
  const int m0 = warp / ng * 16, n0 = warp % ng * 32, nq = min(4, (geo.np - n0) / 8);
  if (warp < items) {
    float acc[4][4] = {};
    product(
        acc, [&](int m, int s) { return Kt[s * lv + m]; },
        [&](int s, int n) { return VD[s * lv + n]; }, m0, n0, nq, 0, geo.cp);
    store_tile(kv + bhc * N * N, [&](int i, int j) { return i * N + j; }, acc, m0, n0, nq, N,
               N, pairs);
  }
  __syncthreads();  // v is dead: dy takes its place
  load_block(VD, lv, dy + base, tstride, C, N, geo.cp, geo.np, vec);
  copy_wait();
  __syncthreads();
  if (warp < items) {
    float acc[4][4] = {};
    product(
        acc, [&](int m, int t) { return Rd[t * lv + m]; },
        [&](int t, int n) { return VD[t * lv + n]; }, m0, n0, nq, 0, geo.cp);
    store_tile(rdy + bhc * N * N, [&](int i, int j) { return i * N + j; }, acc, m0, n0, nq, N,
               N, pairs);
  }
}

// (b') Per state element (b, h, i, j): the forward scan over chunks, slot c
// of kv becoming the state entering chunk c; and the reverse scan from dS_T,
// slot c of rdy becoming the cotangent of the state leaving chunk c, and
// what leaves chunk 0 the cotangent of state0. The two are independent and
// run side by side.
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
  float s = s0[e], g = ds_t[e];
  for (int c0 = 0; c0 < nch; c0 += kScanRun) {
    float x[kScanRun], y[kScanRun], df[kScanRun], db[kScanRun];
#pragma unroll
    for (int q = 0; q < kScanRun; ++q) {
      if (c0 + q < nch) {
        const long long cf = c0 + q, cb = nch - 1 - c0 - q;
        x[q] = ks[cf * nn];
        df[q] = d[cf * N];
        y[q] = gs[cb * nn];
        db[q] = d[cb * N];
      }
    }
#pragma unroll
    for (int q = 0; q < kScanRun; ++q) {
      if (c0 + q < nch) {
        const long long cf = c0 + q, cb = nch - 1 - c0 - q;
        ks[cf * nn] = s;
        s = df[q] * s + x[q];
        gs[cb * nn] = g;
        g = db[q] * g + y[q];
      }
    }
  }
  ds0[e] = g;
}

// (c') Per (chunk, head, batch): dv, dr, dk and dw of the chunk, and its
// partial du (dupart[b][c][h][:]). The C x N outputs are cut into at most
// kWarps tiles of 16 x 32, one per warp, whose accumulators the warp keeps
// in registers from the state-free products to the end.
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_grad(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ dy,
              const float* __restrict__ states, const float* __restrict__ cotangents,
              float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
              float* __restrict__ dw, float* __restrict__ dupart, int T, int H, int N, int C,
              int vec, int pairs) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo(N, C);
  const int lr = geo.lr, lv = geo.lv, lt = geo.lt, np = geo.np, cp = geo.cp;
  float* X0 = smem;                  // r, then r~, then q = dr~ r~         [cp][lv]
  float* X1 = X0 + geo.region();     // k, then k~, then pk = dk~ k~        [cp][lr]
  float* X2 = X1 + geo.region();     // v, S [np][lr], v again, then w       [cp][lr]
  float* X3 = X2 + geo.region();     // dy [cp][lr], then G [np][lv]
  float* X4 = X3 + geo.region();     // w, then log w, then cum             [cp][lr]
  float* X5 = X4 + geo.region();     // cum - log w [cp][lr]; A, tril(P) [cp][lt]; k,
                                     // then k^, then hk = dk^ k^ [cp][lr]
  float* dus = X5 + geo.region();    // [kThreads]  du over each thread's steps
  float* bonus = dus + kThreads;     // [cp]  sum_i r u k
  float* pdiag = bonus + cp;         // [cp]  dy_t . v_t
  float* us = pdiag + cp;            // [np]  u of this head
  float* total = us + np;            // [np]  total log w
  float* z = total + np;             // [np]  exp(total) sum_j G S
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nch = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tstride = static_cast<long long>(H) * N;
  const long long base = (static_cast<long long>(b) * T + static_cast<long long>(c) * C) * tstride +
                         static_cast<long long>(h) * N;
  const long long nn = static_cast<long long>(N) * N;
  const long long bhc = (static_cast<long long>(b) * H + h) * nch + c;
  const auto at = [&](int t, int i) { return base + t * tstride + i; };
  load_block(X4, lr, w + base, tstride, C, N, cp, np, vec);
  copy_commit();
  load_block(X0, lv, r + base, tstride, C, N, cp, np, vec);
  load_block(X1, lr, k + base, tstride, C, N, cp, np, vec);
  load_block(X2, lr, v + base, tstride, C, N, cp, np, vec);
  load_block(X3, lr, dy + base, tstride, C, N, cp, np, vec);
  copy_commit();
  for (int i = threadIdx.x; i < np; i += kThreads) us[i] = i < N ? u[h * N + i] : 0.0f;
  copy_wait_but<1>();  // w; the logs overlap the rest
  __syncthreads();
  log_decay(X4, lr, N, C, np);
  copy_wait();
  __syncthreads();

  // The decay scan; meanwhile bonus_t and P_tt from the raw r, k, dy and v,
  // one warp per step (the padded steps come out zero). Then the decay
  // factors in place, and the chunk's du over each thread's steps.
  float du_run = 0.0f;
  ordered_scan(
      X4, lr, total, N, C, np,
      [&] {
        for (int t = warp - kScanWarps; t < cp; t += kWarps - kScanWarps) {
          float acc = 0.0f, acc2 = 0.0f;
          for (int i = lane; i < np; i += 32) {
            acc = acc + (X0[t * lv + i] * us[i]) * X1[t * lr + i];
            acc2 = acc2 + X3[t * lr + i] * X2[t * lr + i];
          }
          acc = warp_sum(acc);
          acc2 = warp_sum(acc2);
          if (lane == 0) {
            bonus[t] = acc;
            pdiag[t] = acc2;
          }
        }
      },
      [&](int p, float e) { X5[p] = e; },
      [&](int t, int i) {
        const int p = t * lr + i, p0 = t * lv + i;
        const float rr = X0[p0], kk = X1[p];
        du_run = du_run + (pdiag[t] * rr) * kk;
        X0[p0] = rr * expf(X5[p]);
        X1[p] = kk * expf(-X4[p]);
      });
  dus[threadIdx.x] = du_run;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += kThreads) {  // thread q took channel q % np
    float acc = 0.0f;
    for (int q = i; q < kThreads; q += np) acc = acc + dus[q];
    dupart[((static_cast<long long>(b) * nch + c) * H + h) * N + i] = acc;
  }

  // This warp's tile of the C x N outputs, and the C x C items.
  const int ng = (np + 31) / 32, items = cp / 16 * ng;
  const bool mine = warp < items;
  const int m0 = warp / ng * 16, n0 = warp % ng * 32, nq = min(4, (np - n0) / 8);
  const int cg = (cp + 31) / 32;
  const int am0 = warp / cg * 16, an0 = warp % cg * 32;
  const int awidth = warp < cp / 16 * cg ? min(cp, am0 + 16) - an0 : 0;  // columns s < t only
  const int anq = min(4, (awidth + 7) / 8);

  // A = tril(r~ k~^T, -1) into X5 (cum - log w is dead).
  if (awidth > 0) {
    float acc[4][4] = {};
    product(
        acc, [&](int t, int i) { return X0[t * lv + i]; },
        [&](int i, int s) { return X1[s * lr + i]; }, am0, an0, anq, 0, np);
    each_acc(am0, an0, anq, cp, cp, [&](int t, int s, int q, int e) {
      X5[t * lt + s] = s < t ? acc[q][e] : 0.0f;
    });
  }
  __syncthreads();

  // dv = A^T dy + bonus dy, kept in registers; only steps t > s add.
  float dva[4][4] = {}, dra[4][4] = {}, dka[4][4] = {};
  if (mine) {
    product(
        dva, [&](int s, int t) { return X5[t * lt + s]; },
        [&](int t, int j) { return X3[t * lr + j]; }, m0, n0, nq, m0, cp);
    each_acc(m0, n0, nq, cp, np, [&](int s, int j, int q, int e) {
      dva[q][e] = dva[q][e] + bonus[s] * X3[s * lr + j];
    });
  }
  __syncthreads();  // A is dead: tril(P) takes its place

  // tril(P, -1) = tril(dy v^T, -1) into X5.
  if (awidth > 0) {
    float acc[4][4] = {};
    product_f32(
        acc, [&](int t, int j) { return X3[t * lr + j]; },
        [&](int j, int s) { return make_float2(X2[s * lr + j], X2[(s + 1) * lr + j]); }, am0, an0,
        anq, 0, np);
    each_acc(am0, an0, anq, cp, cp, [&](int t, int s, int q, int e) {
      X5[t * lt + s] = s < t ? acc[q][e] : 0.0f;
    });
  }
  __syncthreads();  // v is dead until v G^T, which loads it again

  // S arrives in v's region while the triangular products run.
  load_block(X2, lr, states + bhc * nn, N, N, N, np, np, vec);
  copy_commit();

  // dk~ = tril(P)^T r~ (steps t > s) and tril(P) k~ (steps s < t), kept.
  if (mine) {
    product_f32(
        dka, [&](int s, int t) { return X5[t * lt + s]; },
        [&](int t, int i) { return *reinterpret_cast<const float2*>(X0 + t * lv + i); }, m0, n0,
        nq, m0, cp);
    product_f32(
        dra, [&](int t, int s) { return X5[t * lt + s]; },
        [&](int s, int i) { return *reinterpret_cast<const float2*>(X1 + s * lr + i); }, m0, n0,
        nq, 0, min(cp, m0 + 16));
  }
  __syncthreads();  // tril(P) is dead: k takes its place, for dr and k^
  load_block(X5, lr, k + base, tstride, C, N, cp, np, vec);
  copy_commit();
  float wr[4][4];  // this tile's w for dr, in flight meanwhile
  if (mine) load_tile(wr, w, at, m0, n0, nq, C, N, pairs);
  copy_wait_but<1>();  // S
  __syncthreads();

  // z = exp(total) sum_j G S, G read from the scratch; dr~ = dy S^T +
  // tril(P) k~; then dr, q = dr~ r~ over r~, pk = dk~ k~ over k~, and dk~
  // exp(-cum), the first term of dk.
  {  // four threads a row (N <= 64), their loads issued together
    const int i = threadIdx.x >> 2, j0 = threadIdx.x & 3;
    float acc = 0.0f;
    if (i < N) {
      const float* g_row = cotangents + bhc * nn + static_cast<long long>(i) * N;
#pragma unroll 16
      for (int j = j0; j < N; j += 4) acc = acc + g_row[j] * X2[i * lr + j];
    }
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, 1);
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, 2);
    if (i < N && j0 == 0) z[i] = expf(total[i]) * acc;
  }
  float dsa[4][4] = {};  // dy S^T, added to tril(P) k~ as the plain version adds the two
  if (mine) {
    product(
        dsa, [&](int t, int j) { return X3[t * lr + j]; },
        [&](int j, int i) { return X2[i * lr + j]; }, m0, n0, nq, 0, np);
  }
  copy_wait();  // k
  __syncthreads();
  if (mine) {
    each_acc(m0, n0, nq, C, N, [&](int t, int i, int q, int e) {
      const int p = t * lr + i, p0 = t * lv + i;
      const float cum = X4[p], lw = logf(fmaxf(wr[q][e], 1e-30f));
      const float drd = dsa[q][e] + dra[q][e];
      X0[p0] = drd * X0[p0];
      X1[p] = dka[q][e] * X1[p];
      dra[q][e] = drd * expf(cum - lw) + (pdiag[t] * us[i]) * X5[p];
      dka[q][e] = dka[q][e] * expf(-cum);
    });
    store_tile(dr, at, dra, m0, n0, nq, C, N, pairs);
  }
  __syncthreads();  // dy and S are dead: G and v take their places; k^ meanwhile

  load_block(X3, lv, cotangents + bhc * nn, N, N, N, np, np, vec);
  load_block(X2, lr, v + base, tstride, C, N, cp, np, vec);
  each_step(N, C, np, [&](int t, int i) {
    const int p = t * lr + i;
    X5[p] = X5[p] * expf(total[i] - X4[p]);
  });
  copy_wait();
  __syncthreads();

  // dv += k^ G, written; dk^ = v G^T.
  float dkh[4][4] = {}, rr[4][4];  // rr: this tile's r for dk, in flight meanwhile
  if (mine) {
    load_tile(rr, r, at, m0, n0, nq, C, N, pairs);
    product(
        dva, [&](int s, int i) { return X5[s * lr + i]; },
        [&](int i, int j) { return X3[i * lv + j]; }, m0, n0, nq, 0, np);
    store_tile(dv, at, dva, m0, n0, nq, C, N, pairs);
    product(
        dkh, [&](int s, int j) { return X2[s * lr + j]; },
        [&](int j, int i) { return X3[i * lv + j]; }, m0, n0, nq, 0, np);
  }
  __syncthreads();  // k^ is read: hk = dk^ k^ takes its place; v and G are dead: w, for dw
  load_block(X2, lr, w + base, tstride, C, N, cp, np, vec);

  // dk = (dk~ exp(-cum) + dk^ exp(total - cum)) + P_ss u r_s.
  if (mine) {
    each_acc(m0, n0, nq, C, N, [&](int s, int i, int q, int e) {
      const int p = s * lr + i;
      const float dki = (dka[q][e] + dkh[q][e] * expf(total[i] - X4[p])) + (pdiag[s] * us[i]) * rr[q][e];
      X5[p] = dkh[q][e] * X5[p];
      dkh[q][e] = dki;
    });
    store_tile(dk, at, dkh, m0, n0, nq, C, N, pairs);
  }
  copy_wait();
  __syncthreads();

  // dlogw = ((sum_{t>tau} q - sum_{s>=tau} pk) + sum_{s<tau} hk) + z and
  // dw, in the plain version's order: each running sum step by step, one
  // thread a channel (sum_{t>tau} q as the sum to tau less q_tau, sum_{s<tau}
  // hk likewise), the prefix of hk and the suffixes of q and pk on other
  // warps at once; then dlogw and dw by the whole block. At strong decay
  // dlogw is a small difference of sums of ~100, and dw = dlogw / w with w
  // down to 0.05: summed in another order, the two differ by more than their
  // tolerance where both are within it of a float64 sum.
  if (threadIdx.x < N) {  // sum_{s<t} hk, over hk
    const int i = threadIdx.x;
    float hsum = 0.0f;
    for (int t0 = 0; t0 < C; t0 += kBatch) {
      float x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (t0 + j < C) x[j] = X5[(t0 + j) * lr + i];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (t0 + j < C) {
          hsum = hsum + x[j];
          X5[(t0 + j) * lr + i] = hsum - x[j];
        }
      }
    }
  } else if (threadIdx.x >= 32 * kScanWarps && threadIdx.x - 32 * kScanWarps < N) {
    const int i = threadIdx.x - 32 * kScanWarps;  // (sum_{t'>=t} q - q) - sum_{t'>=t} pk, over q
    float qsum = 0.0f, psum = 0.0f;
    for (int t1 = C - 1; t1 >= 0; t1 -= kBatch) {
      float xq[kBatch], xp[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (t1 - j >= 0) {
          xq[j] = X0[(t1 - j) * lv + i];
          xp[j] = X1[(t1 - j) * lr + i];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (t1 - j >= 0) {
          qsum = qsum + xq[j];
          psum = psum + xp[j];
          X0[(t1 - j) * lv + i] = (qsum - xq[j]) - psum;
        }
      }
    }
  }
  __syncthreads();
  each_step(N, C, np, [&](int t, int i) {
    const int p = t * lr + i;
    const float dlogw = (X0[t * lv + i] + X5[p]) + z[i], wt = X2[p];
    dw[at(t, i)] = wt > 1e-30f ? dlogw / wt : 0.0f;
  });
}

}  // namespace

// Dynamic shared memory the larger of the two chunk passes needs per block
// for head size n and chunk c (kernel.py::bwd_smem_bytes mirrors it).
extern "C" int wkv6_bwd_smem_bytes(int n, int c) {
  const Geometry geo(n, c);
  const int floats = geo.grad_floats() > geo.chunk_floats() ? geo.grad_floats()
                                                            : geo.chunk_floats();
  return static_cast<int>(sizeof(float)) * floats;
}

// C entry point, bound with ctypes by repro_torch/kernels/wkv6/kernel.py:
// launches the three passes back to back on ``stream``. ``kv`` and ``rdy`` (B*H*nch*N*N floats),
// ``decay`` (B*H*nch*N) are scratch and ``dupart`` (B*nch*H*N) the
// per-chunk du the wrapper allocates. Returns the first CUDA error code of
// the launches (0 on success). The wrapper checks shapes, dtypes and
// contiguity, that chunk divides t, that n and chunk are at most 64 and
// that wkv6_bwd_smem_bytes fits a block.
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
  // 16-byte copies when every row and base address is a multiple of 4 words.
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = n % 4 == 0 && al(r) && al(k) && al(v) && al(w) && al(dy) && al(kv) && al(rdy);
  // 8-byte accesses of a tile's column pairs when rows are even and every
  // array read or written so is 8-byte aligned.
  const auto al8 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  const int pairs = n % 2 == 0 && al8(r) && al8(w) && al8(dr) && al8(dk) && al8(dv) && al8(kv) &&
                    al8(rdy);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  wkv6_bwd_chunk<<<grid, kThreads, smem_chunk, st>>>(f(r), f(k), f(v), f(w), f(dy), o(kv), o(rdy),
                                                     o(decay), t, heads, n, chunk, vec, pairs);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long elems = static_cast<long long>(batch) * heads * n * n;
  wkv6_bwd_scan<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      f(s0), f(ds_t), o(kv), o(rdy), f(decay), o(ds0), elems, n, nch);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  wkv6_bwd_grad<<<grid, kThreads, smem_grad, st>>>(f(r), f(k), f(v), f(w), f(u), f(dy), f(kv),
                                                    f(rdy), o(dr), o(dk), o(dv), o(dw), o(dupart),
                                                    t, heads, n, chunk, vec, pairs);
  return static_cast<int>(cudaGetLastError());
}
