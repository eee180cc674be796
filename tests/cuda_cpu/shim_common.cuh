// A CPU stand-in for csrc/common.cuh, so that a CUDA source of the port
// can be compiled by g++ and run on the host (tests/test_torch_port_f32_cpu_build.py):
// a launch runs its thread blocks one after the other, each as blockDim.x
// OS threads sharing one buffer as the block's shared memory (filled with
// NaN bytes, so a read of what nothing wrote shows), std::barrier for
// __syncthreads / __syncwarp, a per-warp exchange for the shuffles. A
// launch with a cluster dimension (cudaLaunchKernelEx) runs the S blocks of
// a cluster at once as one group of threads: the cluster barrier is a
// barrier of all of them, a peer's shared-memory address the same offset
// into that block's buffer. The bf16 sources' types and tensor-core
// fragments are here too: bf16 rounded to nearest even, ldmatrix (plain
// and transposed) and mma.sync m16n8k16 as scalar loops over the
// documented fragment layouts, the products' sums in f32. Only what the
// sources use is here: 1-D blocks of whole warps and 1-D clusters,
// full-mask shuffles reached by all 32 lanes, dynamic shared memory, and
// (csrc/ada_block.cu's launch sequences, over transformer_ops.cuh)
// statically sized __shared__ arrays as static storage, which holds for
// launches whose blocks run one after the other, and WMMA's 16 x 16 x 16
// fragments as whole tiles in every lane.
#pragma once
#include <math.h>
#include <stdint.h>
#include <stddef.h>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
#include <memory>
#include <cstring>
#include <cstdlib>
#include <type_traits>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize,
                         cudaFuncAttributeNonPortableClusterSizeAllowed };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "shim error"; }
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, const void*, const cudaLaunchConfig_t*) { *n = 1; return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class K> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return 0; }
// The grid's and block's sizes as variables (the launch configuration's
// members have the same names).
inline thread_local dim3 gridDim, blockDim;
namespace shim {
struct Warp { std::barrier<> bar{32}; float buf[32]; unsigned fa[32][4], fb[32][2]; const void* ptr[32]; };
struct Block { std::barrier<>* bar; Warp* warps; unsigned char* smem; };
struct Cluster { int size; std::barrier<>* bar; Block* blocks; };
inline thread_local dim3 tIdx, bIdx;
inline thread_local Block* blk = nullptr;
inline thread_local Cluster* clu = nullptr;
// The grid's clusters one after another, the S blocks of each at once.
template <class K, class... A>
void launch_clusters(K kernel, dim3 grid, dim3 block, size_t smem, int S, A... args) {
  const int nt = block.x;
  for (unsigned c = 0; c < grid.x / S; ++c) {
    std::barrier<> cbar(S * nt);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::vector<Warp>> warps(S);
    std::vector<Block> blocks(S);
    for (int r = 0; r < S; ++r) {
      unsigned char* mem = static_cast<unsigned char*>(aligned_alloc(64, (smem + 64) / 64 * 64));
      memset(mem, 0xFF, smem);  // NaN: a read of what nothing wrote shows
      bars.emplace_back(new std::barrier<>(nt));
      warps[r] = std::vector<Warp>(nt / 32);
      blocks[r] = Block{bars.back().get(), warps[r].data(), mem};
    }
    Cluster cl{S, &cbar, blocks.data()};
    std::vector<std::thread> ts;
    ts.reserve(S * nt);
    for (int r = 0; r < S; ++r)
      for (int t = 0; t < nt; ++t)
        ts.emplace_back([&, r, t] {
          tIdx = dim3(t); bIdx = dim3(c * S + r); ::gridDim = grid; ::blockDim = block;
          blk = &blocks[r]; clu = &cl;
          kernel(args...);
        });
    for (auto& t : ts) t.join();
    for (auto& b : blocks) free(b.smem);
  }
}
template <class K, class... A>
void launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  const int nt = block.x;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      unsigned char* mem = static_cast<unsigned char*>(aligned_alloc(64, (smem + 64) / 64 * 64));
      memset(mem, 0xFF, smem);  // NaN: a read of what nothing wrote shows
      std::barrier<> bar(nt);
      std::vector<Warp> warps(nt / 32);
      Block b{&bar, warps.data(), mem};
      std::vector<std::thread> ts;
      ts.reserve(nt);
      for (int t = 0; t < nt; ++t)
        ts.emplace_back([&, t] { tIdx = dim3(t); bIdx = dim3(bx, by); ::gridDim = grid; ::blockDim = block; blk = &b; kernel(args...); });
      for (auto& t : ts) t.join();
      free(mem);
    }
}
}  // namespace shim
template <class... E, class... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(E...), A&&... args) {
  int S = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) S = cfg->attrs[i].val.clusterDim.x;
  shim::launch_clusters(kernel, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, S, static_cast<E>(args)...);
  return 0;
}
#define threadIdx (shim::tIdx)
#define blockIdx (shim::bIdx)
inline void __syncthreads() { shim::blk->bar->arrive_and_wait(); }
inline void __syncwarp() { shim::blk->warps[threadIdx.x / 32].bar.arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
  auto& w = shim::blk->warps[threadIdx.x / 32];
  w.buf[threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  const float r = w.buf[src & 31];
  w.bar.arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned m, float v, int o) { return __shfl_sync(m, v, (threadIdx.x & 31) ^ o); }
inline float __shfl_down_sync(unsigned m, float v, int d) {
  const int lane = threadIdx.x & 31;
  return __shfl_sync(m, v, lane + d < 32 ? lane + d : lane);
}
inline long long clock64() { return 0; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline float rsqrtf(float v) { return 1.0f / sqrtf(v); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
inline float gelu_erf(float v) { return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f)); }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }

// bf16 (the bf16 sources: csrc/common.cuh's helpers, over cuda_bf16.h).
struct alignas(2) __nv_bfloat16 { unsigned short x; };
typedef __nv_bfloat16 bf16;
struct alignas(4) __nv_bfloat162 { __nv_bfloat16 x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return uint4{a, b, c, d}; }
inline float __bfloat162float(bf16 v) { return __uint_as_float(static_cast<unsigned>(v.x) << 16); }
inline bf16 __float2bfloat16(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return bf16{static_cast<unsigned short>((u >> 16) | 0x40)};
  return bf16{static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline unsigned short __bfloat16_as_ushort(bf16 v) { return v.x; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return __nv_bfloat162{__float2bfloat16(a), __float2bfloat16(b)}; }
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return make_float2(__bfloat162float(v.x), __bfloat162float(v.y)); }
inline float bf2f(bf16 v) { return __bfloat162float(v); }
inline bf16 f2bf(float v) { return __float2bfloat16(v); }
inline float rbf(float v) { return bf2f(f2bf(v)); }
inline float ldf(const float* p) { return *p; }
inline float ldf(const bf16* p) { return bf2f(*p); }
inline void load8(const bf16* p, float* dst) { for (int i = 0; i < 8; ++i) dst[i] = bf2f(p[i]); }
inline unsigned pack_bf2(float lo, float hi) {
  return static_cast<unsigned>(f2bf(lo).x) | static_cast<unsigned>(f2bf(hi).x) << 16;
}
// ldmatrix .x4 (.x2: the first two matrices): matrix i's rows at the
// addresses of lanes 8i .. 8i + 7; lane l gets row l / 4, columns 2 (l % 4)
// and + 1 of each (.trans: rows 2 (l % 4) and + 1 of column l / 4).
template <int NM>
inline void ldsm_any(unsigned (&r)[NM], const void* p, bool trans) {
  auto& w = shim::blk->warps[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  w.ptr[lane] = p;
  w.bar.arrive_and_wait();
  for (int i = 0; i < NM; ++i) {
    unsigned short lo, hi;
    if (!trans) {
      const auto* row = static_cast<const unsigned short*>(w.ptr[8 * i + lane / 4]);
      lo = row[2 * (lane % 4)];
      hi = row[2 * (lane % 4) + 1];
    } else {
      lo = static_cast<const unsigned short*>(w.ptr[8 * i + 2 * (lane % 4)])[lane / 4];
      hi = static_cast<const unsigned short*>(w.ptr[8 * i + 2 * (lane % 4) + 1])[lane / 4];
    }
    r[i] = static_cast<unsigned>(lo) | static_cast<unsigned>(hi) << 16;
  }
  w.bar.arrive_and_wait();
}
inline void ldsm_x4(unsigned (&r)[4], const void* p) { ldsm_any(r, p, false); }
inline void ldsm_x4_t(unsigned (&r)[4], const void* p) { ldsm_any(r, p, true); }
inline void ldsm_x2(unsigned (&r)[2], const void* p) { ldsm_any(r, p, false); }
inline void ldsm_x2_t(unsigned (&r)[2], const void* p) { ldsm_any(r, p, true); }
// mma.sync m16n8k16 bf16 (row, col), f32 sums: A's a[0] at (g, 2t .. 2t +
// 1), a[1] 8 rows down, a[2], a[3] 8 columns right of those; B's b0 at (k =
// 2t .. 2t + 1, n = g), b1 8 rows down; the products summed in k order.
inline void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  auto& w = shim::blk->warps[threadIdx.x / 32];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.fa[lane][i] = a[i];
  w.fb[lane][0] = b0;
  w.fb[lane][1] = b1;
  w.bar.arrive_and_wait();
  auto half = [](unsigned u, int k) { return __uint_as_float((k & 1 ? u >> 16 : u & 0xffffu) << 16); };
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >> 1) * 8, col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 16; ++k) {
      const int kk = k & 7;  // within the 8-column half
      const float av = half(w.fa[(row & 7) * 4 + kk / 2][(row >> 3) + (k >> 3) * 2], kk);
      const float bv = half(w.fb[col * 4 + kk / 2][k >> 3], kk);
      s += av * bv;
    }
    d[i] = s;
  }
  w.bar.arrive_and_wait();
}
// mma.sync m16n8k8 bf16 (row, col), f32 sums: A's a[0] at (g, 2t .. 2t +
// 1), a[1] 8 rows down; B's b0 at (k = 2t .. 2t + 1, n = g).
inline void mma_k8(float (&d)[4], const unsigned (&a)[2], unsigned b0) {
  auto& w = shim::blk->warps[threadIdx.x / 32];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 2; ++i) w.fa[lane][i] = a[i];
  w.fb[lane][0] = b0;
  w.bar.arrive_and_wait();
  auto half = [](unsigned u, int k) { return __uint_as_float((k & 1 ? u >> 16 : u & 0xffffu) << 16); };
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >> 1) * 8, col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = half(w.fa[(row & 7) * 4 + k / 2][row >> 3], k);
      const float bv = half(w.fb[col * 4 + k / 2][0], k);
      s += av * bv;
    }
    d[i] = s;
  }
  w.bar.arrive_and_wait();
}
// cp.async as the bf16 sources use it (csrc/common.cuh's pmce::): a plain
// copy (zeros with pred false); the waits are then the barriers after them.
namespace pmce {
inline void cp_async16(void* smem, const void* gmem, bool pred) {
  if (pred) memcpy(smem, gmem, 16); else memset(smem, 0, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_one() {}
inline void cp_async_wait_none() {}
}  // namespace pmce
// WMMA's bf16 16 x 16 x 16 products (transformer_ops.cuh's GEMMs): every
// lane holds the whole tile, loads read all of it, a product sums in k
// order, a store writes the elements e with e % 32 == lane.
namespace nvcuda {
namespace wmma {
struct row_major {};
struct col_major {};
struct matrix_a {};
struct matrix_b {};
struct accumulator {};
enum layout_t { mem_row_major, mem_col_major };
template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment { float v[256]; };
template <class F> inline void fill_fragment(F& f, float x) { for (auto& e : f.v) e = x; }
inline float wval(float v) { return v; }
inline float wval(bf16 v) { return bf2f(v); }
template <class Use, class T, class L>
inline void load_matrix_sync(fragment<Use, 16, 16, 16, T, L>& f, const T* p, unsigned ld) {
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c)
      f.v[r * 16 + c] = wval(std::is_same<L, col_major>::value ? p[c * ld + r] : p[r * ld + c]);
}
template <class A, class B, class C, class D>
inline void mma_sync(D& d, const A& a, const B& b, const C& c) {
  float out[256];
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 16; ++n) {
      float s = c.v[r * 16 + n];
      for (int k = 0; k < 16; ++k) s += a.v[r * 16 + k] * b.v[k * 16 + n];
      out[r * 16 + n] = s;
    }
  memcpy(d.v, out, sizeof out);
}
template <class F>
inline void store_matrix_sync(float* p, const F& f, unsigned ld, layout_t) {
  for (int e = threadIdx.x & 31; e < 256; e += 32) p[(e / 16) * ld + e % 16] = f.v[e];
}
}  // namespace wmma
}  // namespace nvcuda
namespace tc32 {
// The kernels' 3xTF32 split (csrc/common.cuh): hi to nearest TF32, ties
// away from zero, lo = v - hi with all its bits (the mma reads the top 19).
inline void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
// mma.sync m16n8k8 tf32 as a scalar loop over the documented fragment
// layout: the warp's 32 fragments gathered, each lane's four sums from the
// 16 x 8 A and 8 x 8 B tiles (operands' low 13 bits ignored, as the tensor
// cores do), f32 products added in k order.
inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  auto& w = shim::blk->warps[threadIdx.x / 32];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.fa[lane][i] = a[i];
  w.fb[lane][0] = b0;
  w.fb[lane][1] = b1;
  w.bar.arrive_and_wait();
  auto tf = [](unsigned u) { return __uint_as_float(u & ~0x1fffu); };
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >> 1) * 8, col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = tf(w.fa[(row & 7) * 4 + (k & 3)][(row >> 3) + (k >> 2) * 2]);
      const float bv = tf(w.fb[col * 4 + (k & 3)][k >> 2]);
      s += av * bv;
    }
    d[i] = s;
  }
  w.bar.arrive_and_wait();
}
// cp.async as a plain copy: the wait is then the block barrier after it.
inline void cp_async16(void* smem, const void* global) { memcpy(smem, global, 16); }
inline void cp_async4(void* smem, const void* global) { memcpy(smem, global, 4); }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
template <int N> inline void cp_async_wait_group() {}
}  // namespace tc32
namespace clu {
inline int rank() { return blockIdx.x % shim::clu->size; }
inline void sync() { shim::clu->bar->arrive_and_wait(); }
template <class T> inline T* peer(T* p, int r) {
  const auto* b = reinterpret_cast<const unsigned char*>(p);
  return reinterpret_cast<T*>(shim::clu->blocks[r].smem + (b - shim::blk->smem));
}
}  // namespace clu
#define PMCE_EXPORT_ERROR_STRING(name) \
  extern "C" const char* name(int code) { return "shim error"; }
