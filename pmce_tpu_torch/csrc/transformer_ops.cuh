// Device pieces shared by the lifter trunk (lifter_trunk.cu), the training
// block (block.cu) and the decoder's attention blocks (attention_ops.cuh):
// row LayerNorm, the WMMA GEMM with fused epilogues, the split-K weight
// gradient product with its fixed-order reduce, column sums, and grouped
// self-attention over short token groups.
//
// All of them run over every row of a [M, C] token matrix whose rows are
// grouped into clips by index arithmetic; nothing here pads rows or builds
// masks.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace pmce {

using namespace nvcuda;

// ---------------------------------------------------------------------------
// Row LayerNorm: one warp per row of C = 256 (8 values a lane), f32 stats.
// out = bf16(LN(x)); with tpe: out = bf16(f32(bf16(LN(x))) + tpe[t]),
// t = (row % R) / J -- the cast points of the JAX trunk.
// ---------------------------------------------------------------------------
constexpr int LN_C = 256;

template <typename Tin>
__global__ void ln_rows_kernel(const Tin* x, bf16* out, const float* g,
                               const float* b, const float* tpe, int M,
                               int R, int J, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const Tin* xr = x + (size_t)row * LN_C;
  float v[LN_C / 32];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_C / 32; ++i) {
    v[i] = ldf(xr + lane + 32 * i);
    s += v[i];
  }
  const float mean = warp_sum(s) * (1.0f / LN_C);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_C / 32; ++i) {
    v[i] -= mean;
    q += v[i] * v[i];
  }
  const float var = fmaxf(warp_sum(q) * (1.0f / LN_C), 0.f);
  const float inv = rsqrtf(var + eps);
  const float* tp = tpe ? tpe + (size_t)((row % R) / J) * LN_C : nullptr;
  bf16* orow = out + (size_t)row * LN_C;
#pragma unroll
  for (int i = 0; i < LN_C / 32; ++i) {
    const int c = lane + 32 * i;
    float y = v[i] * inv * g[c] + b[c];
    if (tp) y = rbf(y) + tp[c];
    orow[c] = f2bf(y);
  }
}

static inline int launch_ln_rows(const void* x, int x_is_f32, void* out,
                                 const float* g, const float* b,
                                 const float* tpe, int M, int R, int J,
                                 float eps, cudaStream_t s) {
  const int threads = 256, rows_per_block = threads / 32;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block);
  if (x_is_f32)
    ln_rows_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<bf16*>(out), g, b, tpe, M,
        R, J, eps);
  else
    ln_rows_kernel<bf16><<<grid, threads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(out), g, b, tpe, M,
        R, J, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// out[M, N] = epilogue(A[M, K] @ W[K, N] (+ bias)), bf16 operands, f32 sums.
// ---------------------------------------------------------------------------
enum {
  EPI_QKV = 0,    // columns < qcols scaled by qscale in f32, then stored
  EPI_RES = 1,    // out = res + s_row * v  (s_row = rowscale[r / rps] or 1)
  EPI_GELU = 2,   // out = gelu(v)
  EPI_DGELU = 3,  // out = v * gelu'(aux)
  EPI_STORE = 4,  // out = v
};

// Parameters of the fused epilogue; v = acc (+ bias) is the product's value.
struct GemmEpi {
  const float* bias = nullptr;      // [N] or null
  const void* res = nullptr;        // EPI_RES residual [M, N] or null
  int res_f32 = 0;                  // residual stored as f32 (else bf16)
  const float* rowscale = nullptr;  // EPI_RES per-clip branch scale or null
  int rows_per_scale = 1;
  int qcols = 0;                    // EPI_QKV
  float qscale = 1.f;
  float* save = nullptr;            // f32 copy of v (EPI_RES, EPI_GELU) or null
  const float* aux = nullptr;       // EPI_DGELU: gelu's input [M, N]
};

__device__ __forceinline__ void st(bf16* p, float v) { *p = f2bf(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// d gelu(h) / dh of the exact (erf) GELU.
__device__ __forceinline__ float gelu_erf_grad(float h) {
  const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));
  const float pdf = expf(-0.5f * h * h) * 0.39894228040143268f;
  return cdf + h * pdf;
}

constexpr int BM = 128, BK = 32, PAD = 8, GEMM_THREADS = 256;

// 128 x BN_ tiles (BN_ = 128 or 64), 8 warps of 32 x BN_/2, two k-tiles in
// flight: tile kt+1 is copied (cp.async) while the tensor cores work on
// tile kt.
template <int EPI, typename Tout, int BN_>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const bf16* A, const bf16* W, int M, int N, int K,
                GemmEpi e, Tout* out) {
  constexpr int NJ = BN_ / 32;  // 16-column fragments per warp
  __shared__ __align__(32) bf16 As[2][BM][BK + PAD];
  __shared__ __align__(32) bf16 Bs[2][BK][BN_ + PAD];
  __shared__ __align__(32) float stage[GEMM_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN_;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int buf, int k0) {
    for (int c = tid; c < BM * (BK / 8); c += GEMM_THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gr = min(m0 + r, M - 1);
      cp_async16(&As[buf][r][cc], A + (size_t)gr * K + k0 + cc, m0 + r < M);
    }
    for (int c = tid; c < BK * (BN_ / 8); c += GEMM_THREADS) {
      const int r = c / (BN_ / 8), cc = (c % (BN_ / 8)) * 8;
      cp_async16(&Bs[buf][r][cc], W + (size_t)(k0 + r) * N + n0 + cc, true);
    }
  };

  const int KT = K / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_tile((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_one();  // tile kt has landed; tile kt+1 may be in flight
    __syncthreads();
    const int buf = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[NJ];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[buf][wm * 32 + i * 16][kk],
                               BK + PAD);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[buf][kk][wn * (BN_ / 2) + j * 16],
                               BN_ + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  float* stg = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::store_matrix_sync(stg, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int el = lane; el < 256; el += 32) {
        const int gr = m0 + wm * 32 + i * 16 + el / 16;
        const int gc = n0 + wn * (BN_ / 2) + j * 16 + el % 16;
        if (gr < M) {
          const size_t o = (size_t)gr * N + gc;
          float v = stg[el] + (e.bias ? e.bias[gc] : 0.f);
          if (EPI == EPI_QKV) {
            if (gc < e.qcols) v *= e.qscale;
            st(out + o, v);
          } else if (EPI == EPI_RES) {
            if (e.save) e.save[o] = v;
            const float s = e.rowscale ? e.rowscale[gr / e.rows_per_scale]
                                       : 1.f;
            float r = 0.f;
            if (e.res)
              r = e.res_f32 ? static_cast<const float*>(e.res)[o]
                            : bf2f(static_cast<const bf16*>(e.res)[o]);
            st(out + o, r + s * v);
          } else if (EPI == EPI_GELU) {
            if (e.save) e.save[o] = v;
            st(out + o, gelu_erf(v));
          } else if (EPI == EPI_DGELU) {
            st(out + o, v * gelu_erf_grad(e.aux[o]));
          } else {
            st(out + o, v);
          }
        }
      }
      __syncwarp();
    }
  }
}

// Launch one GEMM; N must be a multiple of 64 (128-column tiles where N
// allows) and K of 32.
static inline int launch_gemm(int epi, int out_f32, const bf16* A,
                              const bf16* W, int M, int N, int K,
                              const GemmEpi& e, void* out, cudaStream_t s) {
  if (N % 64 || K % BK || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = N % 128 == 0;
  const dim3 grid(N / (wide ? 128 : 64), (M + BM - 1) / BM);
#define PMCE_GEMM_BN(E, BNV)                                              \
  if (out_f32)                                                            \
    gemm_kernel<E, float, BNV><<<grid, GEMM_THREADS, 0, s>>>(             \
        A, W, M, N, K, e, static_cast<float*>(out));                      \
  else                                                                    \
    gemm_kernel<E, bf16, BNV><<<grid, GEMM_THREADS, 0, s>>>(              \
        A, W, M, N, K, e, static_cast<bf16*>(out));
#define PMCE_GEMM(E)              \
  if (wide) {                     \
    PMCE_GEMM_BN(E, 128)          \
  } else {                        \
    PMCE_GEMM_BN(E, 64)           \
  }
  switch (epi) {
    case EPI_QKV: PMCE_GEMM(EPI_QKV) break;
    case EPI_RES: PMCE_GEMM(EPI_RES) break;
    case EPI_GELU: PMCE_GEMM(EPI_GELU) break;
    case EPI_DGELU: PMCE_GEMM(EPI_DGELU) break;
    case EPI_STORE: PMCE_GEMM(EPI_STORE) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PMCE_GEMM
#undef PMCE_GEMM_BN
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Weight gradient: part[z][m][n] = sum over rows k of split z of
// A[k, m] * G[k, n], A [Kr, Mo] and G [Kr, N] bf16, f32 sums.
// Grid (N / BN_, Mo / BM_, splits); rows past Kr read as zeros. Tiles of
// BM_ x BN_ (each 128 or 64), 8 warps of BM_/4 x BN_/2.
// ---------------------------------------------------------------------------
template <int BM_, int BN_>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_tn_kernel(const bf16* A, const bf16* G, int Kr, int Mo, int N,
                   int kt_per_split, float* part, long long ld,
                   long long off) {
  constexpr int FI = BM_ / 64, FJ = BN_ / 32;
  __shared__ __align__(32) bf16 As[2][BK][BM_ + PAD];
  __shared__ __align__(32) bf16 Bs[2][BK][BN_ + PAD];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM_, n0 = blockIdx.x * BN_;
  const int kt_total = (Kr + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, kt_total);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FI][FJ];
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int buf, int k0) {
    for (int c = tid; c < BK * (BM_ / 8); c += GEMM_THREADS) {
      const int r = c / (BM_ / 8), cc = (c % (BM_ / 8)) * 8;
      const int gr = min(k0 + r, Kr - 1);
      cp_async16(&As[buf][r][cc], A + (size_t)gr * Mo + m0 + cc,
                 k0 + r < Kr);
    }
    for (int c = tid; c < BK * (BN_ / 8); c += GEMM_THREADS) {
      const int r = c / (BN_ / 8), cc = (c % (BN_ / 8)) * 8;
      const int gr = min(k0 + r, Kr - 1);
      cp_async16(&Bs[buf][r][cc], G + (size_t)gr * N + n0 + cc, k0 + r < Kr);
    }
  };

  if (kt0 < kt1) {
    load_tile(0, kt0 * BK);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_tile(buf ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // Aᵀ tile: element (m, k) sits at As[k][m], a column-major operand.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[FI];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FJ];
#pragma unroll
      for (int i = 0; i < FI; ++i)
        wmma::load_matrix_sync(af[i], &As[buf][kk][wm * (BM_ / 4) + i * 16],
                               BM_ + PAD);
#pragma unroll
      for (int j = 0; j < FJ; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[buf][kk][wn * (BN_ / 2) + j * 16],
                               BN_ + PAD);
#pragma unroll
      for (int i = 0; i < FI; ++i)
#pragma unroll
        for (int j = 0; j < FJ; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.z * ld + off;
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j)
      wmma::store_matrix_sync(
          dst + (size_t)(m0 + wm * (BM_ / 4) + i * 16) * N + n0 +
              wn * (BN_ / 2) + j * 16,
          acc[i][j], N, wmma::mem_row_major);
}

// Launch the weight-gradient product over `splits` row ranges; Mo and N
// must be multiples of 64.
static inline int launch_gemm_tn(const bf16* A, const bf16* G, int Kr, int Mo,
                                 int N, int splits, float* part,
                                 long long ld, long long off,
                                 cudaStream_t s) {
  if (Mo % 64 || N % 64 || splits <= 0 || Kr <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kt_total = (Kr + BK - 1) / BK;
  const int per = (kt_total + splits - 1) / splits;
  const bool wm = Mo % 128 == 0, wn = N % 128 == 0;
  const dim3 grid(N / (wn ? 128 : 64), Mo / (wm ? 128 : 64), splits);
#define PMCE_TN(BMV, BNV)                                                  \
  gemm_tn_kernel<BMV, BNV><<<grid, GEMM_THREADS, 0, s>>>(A, G, Kr, Mo, N,  \
                                                         per, part, ld, off)
  if (wm && wn) PMCE_TN(128, 128);
  else if (wm) PMCE_TN(128, 64);
  else if (wn) PMCE_TN(64, 128);
  else PMCE_TN(64, 64);
#undef PMCE_TN
  return static_cast<int>(cudaGetLastError());
}

// Per-block column sums of a bf16 [M, N] matrix over blocks of
// COLSUM_ROWS rows: part[block][off + c].
constexpr int COLSUM_ROWS = 64;

__global__ void colsum_kernel(const bf16* a, int M, int N, float* part,
                              long long ld, int off) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.x * COLSUM_ROWS, r1 = min(r0 + COLSUM_ROWS, M);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += bf2f(a[(size_t)r * N + c]);
  part[(size_t)blockIdx.x * ld + off + c] = s;
}

static inline int launch_colsum(const bf16* a, int M, int N, float* part,
                                long long ld, int off, cudaStream_t s) {
  const dim3 grid((M + COLSUM_ROWS - 1) / COLSUM_ROWS, (N + 255) / 256);
  colsum_kernel<<<grid, 256, 0, s>>>(a, M, N, part, ld, off);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum_s part[s * size + i], s in order: the fixed-order second
// pass of every split sum, so that two runs agree bit for bit.
__global__ void reduce_kernel(const float* part, int S, long long size,
                              float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * size + i];
  out[i] = s;
}

static inline int launch_reduce(const float* part, int S, long long size,
                                float* out, cudaStream_t s) {
  const int threads = 256;
  const dim3 grid((unsigned)((size + threads - 1) / threads));
  reduce_kernel<<<grid, threads, 0, s>>>(part, S, size, out);
  return static_cast<int>(cudaGetLastError());
}

// The C interface's GEMM (pmce_trunk_gemm, pmce_block_gemm): null pointers
// switch the optional epilogue inputs off.
static inline int gemm_entry(const void* A, const void* W, int M, int N,
                             int K, int epi, int out_f32, const float* bias,
                             const void* res, int res_f32,
                             const float* rowscale, int rps, int qcols,
                             float qscale, float* save, const float* aux,
                             void* out, void* stream) {
  GemmEpi e;
  e.bias = bias;
  e.res = res;
  e.res_f32 = res_f32;
  e.rowscale = rowscale;
  e.rows_per_scale = rps;
  e.qcols = qcols;
  e.qscale = qscale;
  e.save = save;
  e.aux = aux;
  return launch_gemm(epi, out_f32, static_cast<const bf16*>(A),
                     static_cast<const bf16*>(W), M, N, K, e, out,
                     static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Grouped self-attention over qkv [B*T*J, 3C] (q pre-scaled) -> out [.., C].
// Grid (B * groups, heads), one block each of 32 threads per 32 tokens
// (at most 256); thread t owns queries t, t + blockDim, ... of the group, so
// a group of any size runs (a group of at most 32 tokens is one warp, a
// lane per query). A spatial group is the J rows of one frame, a temporal
// group the T rows of one joint. Contiguous clips of N rows are the
// spatial case T = 1, J = N.
// ---------------------------------------------------------------------------
constexpr int DH = 32;

__global__ void group_attn_kernel(const bf16* qkv, bf16* out, int T, int J,
                                  int C, int temporal) {
  const int G = temporal ? J : T;   // groups per clip
  const int n = temporal ? T : J;   // tokens per group
  const int b = blockIdx.x / G, g = blockIdx.x % G, h = blockIdx.y;
  const size_t base = (size_t)b * T * J;
  const int ld = 3 * C;
  // Row of group member i: frame g's joints, or joint g's frames.
#define PMCE_ROW(i) (base + (temporal ? (size_t)(g + (i) * J) \
                                      : (size_t)(g * J + (i))))
  for (int qi = threadIdx.x; qi < n; qi += blockDim.x) {
    float q[DH], o[DH];
    const bf16* qp = qkv + PMCE_ROW(qi) * ld + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(qp + d, q + d);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < n; ++j) {
      const bf16* kp = qkv + PMCE_ROW(j) * ld + C + h * DH;
      float kv[DH];
#pragma unroll
      for (int d = 0; d < DH; d += 8) load8(kp + d, kv + d);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s += q[d] * kv[d];
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), p = expf(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < DH; d += 8) load8(kp + C + d, kv + d);
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = o[d] * corr + p * kv[d];
      m = mn;
    }
    const float inv = 1.0f / l;
    bf16* op = out + PMCE_ROW(qi) * C + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = f2bf(o[d] * inv);
  }
#undef PMCE_ROW
}

static inline int launch_group_attn(const bf16* qkv, bf16* out, int B,
                                    int T, int J, int C, int heads,
                                    int temporal, cudaStream_t s) {
  if (C != heads * DH) return static_cast<int>(cudaErrorInvalidValue);
  const int n = temporal ? T : J;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * (((n < 256 ? n : 256) + 31) / 32);
  const dim3 grid(B * (temporal ? J : T), heads);
  group_attn_kernel<<<grid, threads, 0, s>>>(qkv, out, T, J, C, temporal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pmce
