// Small helpers shared by the port's kernels: bf16 <-> f32 conversion,
// warp reductions, exact GELU, and the error-string export every library
// carries so the Python wrappers can report a failed launch by name.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
// Round an f32 value to the nearest bf16 and back (one cast point).
__device__ __forceinline__ float rbf(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return bf2f(*p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exact (erf) GELU, as torch.nn.GELU() and the JAX oracles compute it.
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Eight consecutive bf16 values (16 bytes, 16-byte aligned) into floats.
__device__ __forceinline__ void load8(const bf16* p, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

#define PMCE_EXPORT_ERROR_STRING(name)                       \
  extern "C" const char* name(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
