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
// products C (C - 1) / 2 * N each: 1.6 MFLOP at C = N = 64, 0.50 GFLOP in
// all, 7.5 us at 67 TFLOP/s FP32 on the CUDA cores. It is bytes-bound.
//
// What the design does about it. The state of a (batch, head) stays in
// shared memory for the whole sequence, as the TPU kernel keeps it in VMEM;
// r/k/v/w stream in once and y and the state stream out once. The TPU grid
// (B, H) is only 40 blocks at B = 1 on 132 SMs, so the value columns are
// split as well: y[:, j] needs only S[:, j] and v[:, j], and the update scales
// rows and adds k_tail^T v[:, j], so a grid of (N / V_TILE, H, B) blocks is
// exact. Each block recomputes the chunk's decay factors and the (C x C)
// attention matrix for its columns (cheap next to the products it splits).
// One chunk's r, k, log w, cum, att, v tile and state tile take ~92 KB of
// dynamic shared memory at N = C = 64, so two blocks share an SM. Arrays of
// the chunk are kept transposed ([channel][step], row stride C + 1) so that a
// warp's loads are consecutive or broadcast, never bank-conflicted.
//
// Numerics follow the Pallas kernel's order: logw = log(max(w, 1e-30)), cum a
// running sum over the chunk, r_dec = r exp(cum - logw), k_dec = k exp(-cum),
// k_tail = k exp(total - cum), y = (y_inter + y_intra) + y_bonus. exp(-cum)
// grows to about e^8.7 over 64 steps of the initial decay, so sums are taken in
// full float32 on the CUDA cores (no TF32, no tensor cores), compiled with
// -fmad=false; the plain version beside the wrapper
// (repro_torch/kernels/wkv6/ref.py::wkv6_plain) sums in another order, and the
// two agree to a tolerance, not bit for bit.
#include "stencil_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVTile = 16;  // value columns per block

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int T, int H, int N, int C) {
  extern __shared__ __align__(16) float smem[];
  const int CP = C + 1;               // padded row stride of the [N][C] and [C][C] arrays
  float* rT = smem;                   // [N][CP]  r, then r_dec
  float* kT = rT + N * CP;            // [N][CP]  k, then k_dec
  float* lT = kT + N * CP;            // [N][CP]  log w, then k_tail
  float* cT = lT + N * CP;            // [N][CP]  running sum of log w
  float* att = cT + N * CP;           // [C][CP]  strictly-lower r_dec k_dec^T
  float* vs = att + C * CP;           // [C][kVTile]  this block's value columns
  float* S = vs + C * kVTile;         // [N][kVTile]  this block's state columns
  float* bonus = S + N * kVTile;      // [C]
  float* us = bonus + C;              // [N]

  const int j0 = blockIdx.x * kVTile, h = blockIdx.y, b = blockIdx.z;
  const int vt = min(kVTile, N - j0);
  const int tid = threadIdx.x;
  const long long tstride = static_cast<long long>(H) * N;            // one time step
  const long long seq = static_cast<long long>(b) * T * tstride + static_cast<long long>(h) * N;
  const long long state = (static_cast<long long>(b) * H + h) * N * N;

  for (int i = tid; i < N; i += kThreads) us[i] = u[h * N + i];
  for (int q = tid; q < N * vt; q += kThreads) {
    const int i = q / vt, j = q - i * vt;
    S[i * kVTile + j] = s0[state + static_cast<long long>(i) * N + j0 + j];
  }

  for (int t0 = 0; t0 < T; t0 += C) {
    __syncthreads();  // the previous chunk is done with every buffer
    for (int q = tid; q < C * N; q += kThreads) {
      const int t = q / N, i = q - t * N;
      const long long g = seq + (t0 + t) * tstride + i;
      rT[i * CP + t] = r[g];
      kT[i * CP + t] = k[g];
      lT[i * CP + t] = logf(fmaxf(w[g], 1e-30f));
    }
    for (int q = tid; q < C * vt; q += kThreads) {
      const int t = q / vt, j = q - t * vt;
      vs[t * kVTile + j] = v[seq + (t0 + t) * tstride + j0 + j];
    }
    __syncthreads();

    // cum: a running sum over the chunk per channel; bonus: sum_i (r u) k per step.
    for (int i = tid; i < N; i += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) {
        acc = acc + lT[i * CP + t];
        cT[i * CP + t] = acc;
      }
    }
    for (int t = tid; t < C; t += kThreads) {
      float acc = 0.0f;
      for (int i = 0; i < N; ++i) acc = acc + (rT[i * CP + t] * us[i]) * kT[i * CP + t];
      bonus[t] = acc;
    }
    __syncthreads();

    // Decay factors, in place (bonus above read the raw r and k).
    for (int q = tid; q < N * C; q += kThreads) {
      const int i = q / C, t = q - i * C, p = i * CP + t;
      const float cum = cT[p], total = cT[i * CP + C - 1], kk = kT[p];
      rT[p] = rT[p] * expf(cum - lT[p]);
      kT[p] = kk * expf(-cum);
      lT[p] = kk * expf(total - cum);
    }
    __syncthreads();

    for (int q = tid; q < C * C; q += kThreads) {
      const int t = q / C, s = q - t * C;
      float acc = 0.0f;
      if (s < t) {
        for (int i = 0; i < N; ++i) acc = acc + rT[i * CP + t] * kT[i * CP + s];
      }
      att[t * CP + s] = acc;
    }
    __syncthreads();

    for (int q = tid; q < C * vt; q += kThreads) {
      const int t = q / vt, j = q - t * vt;
      float inter = 0.0f, intra = 0.0f;
      for (int i = 0; i < N; ++i) inter = inter + rT[i * CP + t] * S[i * kVTile + j];
      for (int s = 0; s < t; ++s) intra = intra + att[t * CP + s] * vs[s * kVTile + j];
      y[seq + (t0 + t) * tstride + j0 + j] = (inter + intra) + bonus[t] * vs[t * kVTile + j];
    }
    __syncthreads();  // every y of the chunk has read the old state

    for (int q = tid; q < N * vt; q += kThreads) {
      const int i = q / vt, j = q - i * vt;
      float acc = 0.0f;
      for (int s = 0; s < C; ++s) acc = acc + lT[i * CP + s] * vs[s * kVTile + j];
      S[i * kVTile + j] = expf(cT[i * CP + C - 1]) * S[i * kVTile + j] + acc;
    }
  }
  __syncthreads();
  for (int q = tid; q < N * vt; q += kThreads) {
    const int i = q / vt, j = q - i * vt;
    s_out[state + static_cast<long long>(i) * N + j0 + j] = S[i * kVTile + j];
  }
}

}  // namespace

// Dynamic shared memory one block needs for head size n and chunk c.
extern "C" int wkv6_smem_bytes(int n, int c) {
  const int cp = c + 1;
  return static_cast<int>(sizeof(float)) *
         (4 * n * cp + c * cp + c * kVTile + n * kVTile + c + n);
}

// C entry point, bound with ctypes by repro_torch/kernels/wkv6/kernel.py.
// Returns the CUDA error code of the launch (0 on success). The wrapper
// checks shapes, dtypes and contiguity, and that chunk divides t.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out, int batch, int t,
                        int heads, int n, int chunk, void* stream) {
  static size_t reserved = 0;
  const size_t smem = static_cast<size_t>(wkv6_smem_bytes(n, chunk));
  const int err = repro_torch::reserve_smem(wkv6_kernel, smem, reserved);
  if (err) return err;
  const dim3 grid((n + kVTile - 1) / kVTile, heads, batch);
  wkv6_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), t, heads, n, chunk);
  return static_cast<int>(cudaGetLastError());
}
