// Stage-1 lifter trunk for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_lifter_trunk_kernel` (entry
// `fused_lifter_trunk`), the Pallas kernel that runs all depth x (spatial,
// temporal) pre-norm blocks of one clip's [T*J = 304, C = 256] tokens in
// VMEM, with the shared norm_s / norm_t and the temporal pos-embed.
//
// What bounds it on this card: a clip's f32 stream is 304 x 256 x 4 B =
// 311 KB, over the 227 KB of shared memory one block may use, so the TPU's
// one-program-per-clip design does not carry over. At batch 256 the four
// projections of the six blocks are 490 GFLOP of bf16 products (tensor-core
// work) and the activations they read and write are about 1.2 GB per block
// (device-memory work); neither fits on chip across a block.
//
// Design: a short sequence of launches per block, each over all B*T*J rows:
//   ln_rows      row LayerNorm, f32 statistics, bf16 out (the temporal
//                pos-embed add is fused into the first norm_s);
//   gemm         128x128 bf16 tiles on the tensor cores (WMMA 16x16x16,
//                f32 accumulation), the next k-tile copied with cp.async
//                while the current one is multiplied, and the epilogue
//                fused: +bias, the 1/sqrt(dh) q scale in f32 before the
//                one bf16 rounding, erf-GELU, and the f32 residual adds;
//   group_attn   one warp per (clip, group, head); a spatial group is the
//                J rows of one frame, a temporal group the T rows of one
//                joint, found by index arithmetic: no [R, R] mask exists.
//                Each lane owns one query and runs a max-stabilised online
//                softmax in f32 over the group's keys. (Eight head-warps in
//                one block measured slower on an H100 at 700 W: with 96
//                registers a thread, fewer warps stay resident than with
//                32-thread blocks.)
// Fusing these launches (and keeping x1 on chip) is later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

// ---------------------------------------------------------------------------
// Row LayerNorm: one warp per row of C = 256 (8 values a lane).
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

// ---------------------------------------------------------------------------
// out[M, N] = epilogue(A[M, K] @ W[K, N] + bias), bf16 operands, f32 sums.
// ---------------------------------------------------------------------------
enum {
  EPI_QKV = 0,         // bf16 out; columns < qcols scaled by qscale in f32
  EPI_RES_BF16 = 1,    // f32 out = f32(res_bf16) + (acc + bias)
  EPI_GELU = 2,        // bf16 out = gelu(acc + bias)
  EPI_RES_F32 = 3,     // bf16 out = bf16(res_f32 + (acc + bias))
};

constexpr int BM = 128, BN = 128, BK = 32, PAD = 8, GEMM_THREADS = 256;

// 16-byte global -> shared copy that does not hold up the thread (cp.async);
// with pred false it writes zeros and reads nothing.
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

// Two k-tiles in flight: tile kt+1 is copied (cp.async) while the tensor
// cores work on tile kt.
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const bf16* A, const bf16* W, const float* bias,
                const void* res, void* out, int M, int N, int K, int qcols,
                float qscale) {
  __shared__ __align__(32) bf16 As[2][BM][BK + PAD];
  __shared__ __align__(32) bf16 Bs[2][BK][BN + PAD];
  __shared__ __align__(32) float stage[GEMM_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 64 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int buf, int k0) {
    for (int c = tid; c < BM * (BK / 8); c += GEMM_THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gr = min(m0 + r, M - 1);
      cp_async16(&As[buf][r][cc], A + (size_t)gr * K + k0 + cc, m0 + r < M);
    }
    for (int c = tid; c < BK * (BN / 8); c += GEMM_THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[buf][wm * 32 + i * 16][kk],
                               BK + PAD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[buf][kk][wn * 64 + j * 16],
                               BN + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = m0 + wm * 32 + i * 16 + e / 16;
        const int gc = n0 + wn * 64 + j * 16 + e % 16;
        if (gr < M) {
          const size_t o = (size_t)gr * N + gc;
          float v = st[e] + bias[gc];
          if (EPI == EPI_QKV) {
            if (gc < qcols) v *= qscale;
            static_cast<bf16*>(out)[o] = f2bf(v);
          } else if (EPI == EPI_RES_BF16) {
            static_cast<float*>(out)[o] =
                bf2f(static_cast<const bf16*>(res)[o]) + v;
          } else if (EPI == EPI_GELU) {
            static_cast<bf16*>(out)[o] = f2bf(gelu_erf(v));
          } else {
            static_cast<bf16*>(out)[o] =
                f2bf(static_cast<const float*>(res)[o] + v);
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Grouped self-attention over qkv [B*T*J, 3C] (q pre-scaled) -> out [.., C].
// Grid (B * groups, heads), one warp each; lane i is query i of the group.
// ---------------------------------------------------------------------------
constexpr int DH = 32;

__global__ void group_attn_kernel(const bf16* qkv, bf16* out, int T, int J,
                                  int C, int temporal) {
  const int G = temporal ? J : T;   // groups per clip
  const int n = temporal ? T : J;   // tokens per group
  const int b = blockIdx.x / G, g = blockIdx.x % G, h = blockIdx.y;
  const int lane = threadIdx.x;
  if (lane >= n) return;
  const size_t base = (size_t)b * T * J;
  const int ld = 3 * C;
  // Row of group member i: frame g's joints, or joint g's frames.
#define PMCE_ROW(i) (base + (temporal ? (size_t)(g + (i) * J) \
                                      : (size_t)(g * J + (i))))
  float q[DH], o[DH];
  const bf16* qp = qkv + PMCE_ROW(lane) * ld + h * DH;
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
  bf16* op = out + PMCE_ROW(lane) * C + h * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) op[d] = f2bf(o[d] * inv);
#undef PMCE_ROW
}

// ---------------------------------------------------------------------------
// C interface (ctypes). Every function returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" int pmce_trunk_ln(const void* x, int x_is_f32, void* out,
                             const float* g, const float* b, const float* tpe,
                             int M, int R, int J, float eps, void* stream) {
  const int threads = 256, rows_per_block = threads / 32;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

extern "C" int pmce_trunk_gemm(const void* A, const void* W,
                               const float* bias, const void* res, void* out,
                               int M, int N, int K, int epi, int qcols,
                               float qscale, void* stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* w = static_cast<const bf16*>(W);
  switch (epi) {
    case EPI_QKV:
      gemm_kernel<EPI_QKV><<<grid, GEMM_THREADS, 0, s>>>(
          a, w, bias, res, out, M, N, K, qcols, qscale);
      break;
    case EPI_RES_BF16:
      gemm_kernel<EPI_RES_BF16><<<grid, GEMM_THREADS, 0, s>>>(
          a, w, bias, res, out, M, N, K, qcols, qscale);
      break;
    case EPI_GELU:
      gemm_kernel<EPI_GELU><<<grid, GEMM_THREADS, 0, s>>>(
          a, w, bias, res, out, M, N, K, qcols, qscale);
      break;
    case EPI_RES_F32:
      gemm_kernel<EPI_RES_F32><<<grid, GEMM_THREADS, 0, s>>>(
          a, w, bias, res, out, M, N, K, qcols, qscale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmce_trunk_attn(const void* qkv, void* out, int B, int T,
                               int J, int C, int heads, int temporal,
                               void* stream) {
  if (C != heads * DH) return static_cast<int>(cudaErrorInvalidValue);
  if ((temporal ? T : J) > 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * (temporal ? J : T), heads);
  group_attn_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, J, C,
      temporal);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_trunk_error_string)
