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

// The same for two 8 x 8 matrices (rows at lanes 0-7 and 8-15): the head
// width 8's A fragment (m16n8k8) and B fragments of two n8 tiles.
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
// d += a (16 x 8, row) * b (8 x 8, col): the head width 8's products.
__device__ __forceinline__ void mma_k8(float (&d)[4], const unsigned (&a)[2],
                                       unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// cp.async as the bf16 sources use it (namespace pmce; tc32's below are the
// f32 sources'): a 16-byte global -> shared copy that does not hold up the
// thread, which with pred false writes zeros and reads nothing; commit a
// group; wait until at most one, or none, of the thread's groups is in
// flight.
namespace pmce {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_none() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace pmce

// Two floats rounded to a bf16 pair (lo in the low half), as one register.
__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// 3xTF32 products (mma.sync m16n8k8, tf32 operands, f32 sums). An f32 value
// v is split as hi = tf32(v), rounded to nearest with ties away from zero
// (cvt.rna's rounding, done as an integer add and mask: finite v), and lo =
// v - hi, exact in f32, of which the tensor cores read the top 19 bits; a
// product sums a_lo b_hi + a_hi b_lo + a_hi b_hi. Fragments of the 16 x 8 A
// tile (row): a[0] at (lane / 4, lane % 4), a[1] 8 rows down, a[2] and a[3]
// 4 columns right of those; of the 8 x 8 B tile (col): b0 at (k = lane % 4,
// n = lane / 4), b1 4 rows down; the accumulator as the bf16 product's
// above.
// (Namespace tc32: the bf16 sources' pmce:: has cp.async helpers of the
// same names.)
// ---------------------------------------------------------------------------
namespace tc32 {

__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), one tf32 product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory to shared memory, asynchronously (cp.async,
// cached in L2 only); a thread's copies since its last commit form a group,
// and cp_async_wait_all waits for all of its groups (then a block barrier
// makes every thread's copies visible). The source goes as a global-space
// address and the copy is a compiler memory barrier: without both, a
// precomputed-offset copy loop faulted on the H100.
__device__ __forceinline__ void cp_async16(void* smem, const void* global) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(smem)), "l"(__cvta_generic_to_global(global))
               : "memory");
}
// 4 bytes the same way (cached in L1 and L2), for rows too short for 16.
__device__ __forceinline__ void cp_async4(void* smem, const void* global) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :
               : "r"(smem_addr(smem)), "l"(__cvta_generic_to_global(global))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait until at most N of the thread's groups are still in flight (a ring
// of N + 1 stages: the oldest has landed).
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc32

// ---------------------------------------------------------------------------
// Thread block clusters (sm_90): the CTA's rank in its cluster, a barrier of
// every thread of the cluster (arrive with release, wait with acquire: what
// any of them wrote before it, in shared or device memory, is seen by what
// any of them reads after it), and the generic address of the same
// shared-memory location in the CTA of rank r (distributed shared memory,
// read with ordinary loads). Every thread of the cluster reaches each sync.
// ---------------------------------------------------------------------------
namespace clu {

__device__ __forceinline__ int rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <class T>
__device__ __forceinline__ T* peer(T* p, int r) {
  unsigned long long a;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(a)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(r));
  return reinterpret_cast<T*>(a);
}

}  // namespace clu

#define PMCE_EXPORT_ERROR_STRING(name)                       \
  extern "C" const char* name(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
