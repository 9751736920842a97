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
