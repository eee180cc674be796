// Pre-norm transformer block, forward and backward, for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_block_kernel` (entry
// `fused_transformer_block`) and `_block_bwd_kernel` (via
// `_fused_block_bwd`), the Pallas kernels of the lifter's training step:
//
//   x1 = x + m1 * MHSA(LN1(x));  y = x1 + m2 * MLP(LN2(x1));  [PostLN(y)]
//
// over contiguous clips of N <= 64 rows, with per-clip branch scales m1, m2
// (stochastic depth) and the lifter's shared post-norm.
//
// What bounds it on this card: at batch 64 a lifter block is 1,088 or
// 1,024 clips of 16 or 17 tokens, M = 17,408 rows of C = 256. Its
// products are 18.6 GFLOP forward and twice that backward (bf16 tensor-core
// work, ~19 and ~38 us at 989 TFLOP/s); the activations it must read and
// write are 17.8 MB (~5 us at 3.35 TB/s). Tensor cores bound it.
//
// Design (simple first; wgmma and TMA come later):
// - forward: the trunk's launches (transformer_ops.cuh) over all M rows:
//   LayerNorm, WMMA GEMMs with fused epilogues (bias, q scale, exact GELU,
//   masked f32 residuals), grouped attention with a clip's rows found by
//   index arithmetic. The intermediates the backward needs stay in device
//   memory (h1, qkv, o, x1, h2, hh, ge, y: ~150 MB a block at batch 64)
//   instead of being recomputed as the TPU kernel does in VMEM.
// - backward: one launch per stage, each over all rows. Activation
//   gradients come from the same NN GEMM (weights pre-transposed by the
//   wrapper; the GELU derivative fused into its epilogue). Weight gradients
//   are Xᵀ·dY products with K = M = 17,408: the TPU accumulated them over its
//   sequential grid, but Hopper's blocks run in no order, so each weight
//   tile's K range is split over 16 blocks that write f32 partial tiles,
//   and one more launch adds the partials in a fixed order. LayerNorm
//   backward runs one warp per row, adding dγ, dβ and the branch's bias
//   gradient per block of 64 rows; those partials, and the column sums of
//   the other bias gradients, are added the same way. No float atomics: two
//   runs give the same gradients bit for bit.
// - attention backward: one block of 32 threads (N <= 32) or 64 (N <= 64,
//   the JAX kernel's own limit) per (clip, head). Thread i recomputes row i
//   of the scores and the softmax, keeps P and dS in shared memory, and
//   forms dq; then thread j forms dk and dv from column j.

#include "transformer_ops.cuh"

using namespace pmce;

namespace {

// ---------------------------------------------------------------------------
// LayerNorm backward (or the identity when g is null), one warp per row of
// C = 256, 64 rows a block:
//   dx = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)) [+ res]
// with xhat recomputed from x as the forward computed it. Optional outputs:
// dx (f32), dxs = bf16(dx * s_row), rowdot = sum_c dx * dot, and per-block
// column partials of dy*xhat (dγ), dy (dβ) and dx * s_row (a bias grad).
// ---------------------------------------------------------------------------
// Row blocks shared with colsum_kernel: both write one partial buffer.
constexpr int LNB_ROWS = COLSUM_ROWS, LNB_THREADS = 256;

template <typename Tdy, typename Tx>
__global__ void __launch_bounds__(LNB_THREADS)
    ln_bwd_kernel(const Tdy* dy, const Tx* x, const float* g, float eps,
                  const float* res, const float* rowscale, int rps,
                  float* dx, bf16* dxs, const float* dot, float* rowdot,
                  float* part, long long ld, int off_g, int off_b, int off_s,
                  int M) {
  constexpr int C = LN_C, PER = C / 32;
  __shared__ float red[LNB_THREADS / 32][C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ag[PER], ab[PER], as[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) ag[i] = ab[i] = as[i] = 0.f;

  const int r0 = blockIdx.x * LNB_ROWS;
  const int r1 = min(r0 + LNB_ROWS, M);
  for (int r = r0 + warp; r < r1; r += LNB_THREADS / 32) {
    const size_t base = (size_t)r * C;
    float dyv[PER], dxv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) dyv[i] = ldf(dy + base + lane + 32 * i);
    if (g) {
      float xv[PER], s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        xv[i] = ldf(x + base + lane + 32 * i);
        s += xv[i];
      }
      const float mean = warp_sum(s) * (1.0f / C);
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        xv[i] -= mean;
        q += xv[i] * xv[i];
      }
      const float inv = rsqrtf(fmaxf(warp_sum(q) * (1.0f / C), 0.f) + eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        xv[i] *= inv;  // xhat
        const float dyg = dyv[i] * g[lane + 32 * i];
        s1 += dyg;
        s2 += dyg * xv[i];
        ag[i] += dyv[i] * xv[i];
        ab[i] += dyv[i];
      }
      const float mean1 = warp_sum(s1) * (1.0f / C);
      const float mean2 = warp_sum(s2) * (1.0f / C);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        dxv[i] = inv * (dyv[i] * g[lane + 32 * i] - mean1 - xv[i] * mean2);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) dxv[i] = dyv[i];
    }
    const float sc = rowscale ? rowscale[r / rps] : 1.f;
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const size_t o = base + lane + 32 * i;
      if (res) dxv[i] += res[o];
      as[i] += dxv[i] * sc;
      if (dx) dx[o] = dxv[i];
      if (dxs) dxs[o] = f2bf(dxv[i] * sc);
      if (rowdot) d += dxv[i] * dot[o];
    }
    if (rowdot) {
      d = warp_sum(d);
      if (lane == 0) rowdot[r] = d;
    }
  }

  // Column partials of this block's rows, added over warps in fixed order.
  const int offs[3] = {off_g, off_b, off_s};
  float* accs[3] = {ag, ab, as};
  for (int k = 0; k < 3; ++k) {
    if (offs[k] < 0) continue;
#pragma unroll
    for (int i = 0; i < PER; ++i) red[warp][lane + 32 * i] = accs[k][i];
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < LNB_THREADS / 32; ++w) s += red[w][threadIdx.x];
    part[(size_t)blockIdx.x * ld + offs[k] + threadIdx.x] = s;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Attention backward over contiguous clips of N <= NMAX rows (NMAX = 32 or
// 64), one block of NMAX threads per (clip, head). qkv [M, 3C] holds q
// pre-scaled by qscale (then rounded); dout [M, C] is dL/d(head outputs).
// Writes dqkv [M, 3C] in qkv's layout, the q part in unscaled terms
// (dq' * qscale).
// ---------------------------------------------------------------------------
constexpr int AB_N = 64;

template <int NMAX>
__device__ __forceinline__ void ab_sync() {
  if constexpr (NMAX <= 32) __syncwarp(); else __syncthreads();
}

template <int NMAX>
__global__ void __launch_bounds__(NMAX)
    attn_bwd_kernel(const bf16* qkv, const bf16* dout, bf16* dqkv, int N,
                    int C, float qscale) {
  __shared__ float P[NMAX][NMAX + 1];
  __shared__ float DS[NMAX][NMAX + 1];
  const int b = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  const bool active = lane < N;
  const int i = active ? lane : N - 1;
  const size_t base = (size_t)b * N;
  const int ld = 3 * C;

  float q[DH], dov[DH], t[DH], acc[DH];
  const bf16* qp = qkv + (base + i) * ld + h * DH;
  const bf16* dp = dout + (base + i) * C + h * DH;
#pragma unroll
  for (int d = 0; d < DH; d += 8) {
    load8(qp + d, q + d);
    load8(dp + d, dov + d);
  }
  // Row i of the scores and of dP = dO Vᵀ.
  float mx = -INFINITY;
  for (int j = 0; j < N; ++j) {
    const bf16* kp = qkv + (base + j) * ld + C + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(kp + d, t + d);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) s += q[d] * t[d];
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(kp + C + d, t + d);
    float dpv = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) dpv += dov[d] * t[d];
    if (active) {
      P[i][j] = s;
      DS[i][j] = dpv;
    }
    mx = fmaxf(mx, s);
  }
  ab_sync<NMAX>();
  // Softmax of the row, then dS = P * (dP - sum_j P dP).
  float l = 0.f;
  for (int j = 0; j < N; ++j) l += expf(P[i][j] - mx);
  const float inv = 1.0f / l;
  float D = 0.f;
  for (int j = 0; j < N; ++j) D += expf(P[i][j] - mx) * inv * DS[i][j];
  ab_sync<NMAX>();
  if (active) {
    for (int j = 0; j < N; ++j) {
      const float p = expf(P[i][j] - mx) * inv;
      DS[i][j] = p * (DS[i][j] - D);
      P[i][j] = p;
    }
  }
  ab_sync<NMAX>();
  // dq'_i = sum_j dS_ij k_j.
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int j = 0; j < N; ++j) {
    const bf16* kp = qkv + (base + j) * ld + C + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(kp + d, t + d);
    const float w = DS[i][j];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] += w * t[d];
  }
  if (active) {
    bf16* o = dqkv + (base + i) * ld + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = f2bf(acc[d] * qscale);
  }
  // Lane j: dk_j = sum_i dS_ij q'_i and dv_j = sum_i P_ij dO_i.
  const int j = i;
  float dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = dv[d] = 0.f;
  for (int r = 0; r < N; ++r) {
    const float w = DS[r][j], p = P[r][j];
#pragma unroll
    for (int d = 0; d < DH; d += 8)
      load8(qkv + (base + r) * ld + h * DH + d, t + d);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] += w * t[d];
#pragma unroll
    for (int d = 0; d < DH; d += 8)
      load8(dout + (base + r) * C + h * DH + d, t + d);
#pragma unroll
    for (int d = 0; d < DH; ++d) dv[d] += p * t[d];
  }
  if (active) {
    bf16* o = dqkv + (base + j) * ld + C + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      o[d] = f2bf(acc[d]);
      o[C + d] = f2bf(dv[d]);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes). Every function returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" int pmce_block_ln(const void* x, int x_is_f32, void* out,
                             const float* g, const float* b, int M, float eps,
                             void* stream) {
  return launch_ln_rows(x, x_is_f32, out, g, b, nullptr, M, 1, 1, eps,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int pmce_block_gemm(const void* A, const void* W, int M, int N,
                               int K, int epi, int out_f32,
                               const float* bias, const void* res,
                               int res_f32, const float* rowscale, int rps,
                               int qcols, float qscale, float* save,
                               const float* aux, void* out, void* stream) {
  return gemm_entry(A, W, M, N, K, epi, out_f32, bias, res, res_f32,
                    rowscale, rps, qcols, qscale, save, aux, out, stream);
}

extern "C" int pmce_block_attn(const void* qkv, void* out, int clips, int N,
                               int C, int heads, void* stream) {
  return launch_group_attn(static_cast<const bf16*>(qkv),
                           static_cast<bf16*>(out), clips, 1, N, C, heads, 0,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int pmce_block_gemm_tn(const void* A, const void* G, int Kr,
                                  int Mo, int N, int splits, float* part,
                                  long long ld, long long off, void* stream) {
  return launch_gemm_tn(static_cast<const bf16*>(A),
                        static_cast<const bf16*>(G), Kr, Mo, N, splits, part,
                        ld, off, static_cast<cudaStream_t>(stream));
}

extern "C" int pmce_block_ln_bwd(const void* dy, int dy_f32, const void* x,
                                 int x_f32, const float* g, float eps,
                                 const float* res, const float* rowscale,
                                 int rps, float* dx, void* dxs,
                                 const float* dot, float* rowdot,
                                 float* part, long long ld, int off_g,
                                 int off_b, int off_s, int M, void* stream) {
  const dim3 grid((M + LNB_ROWS - 1) / LNB_ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* xs = static_cast<bf16*>(dxs);
#define PMCE_LNB(TDY, TX)                                                 \
  ln_bwd_kernel<TDY, TX><<<grid, LNB_THREADS, 0, s>>>(                    \
      static_cast<const TDY*>(dy), static_cast<const TX*>(x), g, eps, res, \
      rowscale, rps, dx, xs, dot, rowdot, part, ld, off_g, off_b, off_s, M)
  if (dy_f32 && x_f32) PMCE_LNB(float, float);
  else if (dy_f32) PMCE_LNB(float, bf16);
  else if (x_f32) PMCE_LNB(bf16, float);
  else PMCE_LNB(bf16, bf16);
#undef PMCE_LNB
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmce_block_colsum(const void* a, int M, int N, float* part,
                                 long long ld, int off, void* stream) {
  return launch_colsum(static_cast<const bf16*>(a), M, N, part, ld, off,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int pmce_block_reduce(const float* part, int S, long long size,
                                 float* out, void* stream) {
  return launch_reduce(part, S, size, out, static_cast<cudaStream_t>(stream));
}

extern "C" int pmce_block_attn_bwd(const void* qkv, const void* dout,
                                   void* dqkv, int clips, int N, int C,
                                   int heads, float qscale, void* stream) {
  if (C != heads * DH || N > AB_N || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(clips, heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMCE_AB(NMAX)                                                    \
  attn_bwd_kernel<NMAX><<<grid, NMAX, 0, s>>>(                           \
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),     \
      static_cast<bf16*>(dqkv), N, C, qscale)
  if (N <= 32) PMCE_AB(32);
  else PMCE_AB(64);
#undef PMCE_AB
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_block_error_string)
