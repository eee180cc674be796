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

// ---------------------------------------------------------------------------
// Tensor-core fragments (mma.sync m16n8k16, bf16 operands, f32 sums).
// Accumulator c[0..3] of a 16 x 8 tile: c[0], c[1] at row lane / 4,
// columns 2 * (lane % 4) + {0, 1}; c[2], c[3] the same columns 8 rows down.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The four 8 x 8 bf16 matrices whose rows lanes 0-7, 8-15, 16-23 and 24-31
// point at. With row = r0 + lane % 16 and column = c0 + lane / 16 * 8 over
// a row-major [rows, cols] tile this is the A fragment of the 16 x 16
// block at (r0, c0); with .trans over a row-major [k, n] matrix it is the
// B fragments of the n8 tiles at c0 and c0 + 8 for k16 at r0
// (r[0], r[1] and r[2], r[3]).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to a bf16 pair (lo in the low half), as one register.
__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

#define PMCE_EXPORT_ERROR_STRING(name)                       \
  extern "C" const char* name(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
