// Device pieces and launch sequences shared by the decoder's attention
// blocks (mhsa.cu, ada_block.cu, ca_block.cu): AdaLayerNorm forward and
// backward with per-clip gamma/beta, multi-head attention over any token
// count with its two-pass backward, and the host-side sequences the three
// blocks have in common (self-attention forward and backward, the AdaLN'd
// MLP half forward and backward, weight gradients by split-K partials and a
// fixed-order reduce).
//
// Tokens are the rows of [clips * N, C] matrices; a row's clip is row / N.
// Attention never pads: each clip's keys are its own Nk rows, so the
// vertex stream's 431 tokens and the joint stream's 17 need no masks.
#pragma once

#include <algorithm>

#include "transformer_ops.cuh"

namespace pmce {

#define PMCE_TRY(call)          \
  do {                          \
    const int _e = (call);      \
    if (_e) return _e;          \
  } while (0)

// ---------------------------------------------------------------------------
// AdaLayerNorm forward (the reference's: unbiased sigma, eps outside the
// sqrt, f32 statistics), one warp per row of CW channels; gamma/beta are
// per-clip [clips, CW] f32 rows. out = bf16(gamma * (x - mean) /
// (sigma + eps) + beta).
// ---------------------------------------------------------------------------
template <int CW, typename Tin>
__global__ void adaln_fwd_kernel(const Tin* x, bf16* out,
                                 const float* gamma, const float* beta,
                                 int M, int rows_per_clip, float eps) {
  constexpr int PER = CW / 32;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const Tin* xr = x + (size_t)row * CW;
  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = ldf(xr + lane + 32 * i);
    s += v[i];
  }
  const float mean = warp_sum(s) * (1.0f / CW);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] -= mean;
    q += v[i] * v[i];
  }
  const float var = warp_sum(q) * (1.0f / (CW - 1));
  const float inv = 1.0f / (sqrtf(var) + eps);
  const size_t cb = (size_t)(row / rows_per_clip) * CW;
  bf16* o = out + (size_t)row * CW;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    o[c] = f2bf(gamma[cb + c] * (v[i] * inv) + beta[cb + c]);
  }
}

constexpr int ADA_C = 64;  // the decoder streams' width

template <typename Tin>
static inline int launch_adaln(const Tin* x, bf16* out, const float* gamma,
                               const float* beta, int M, int rpc, int C,
                               float eps, cudaStream_t s) {
  if (C != ADA_C) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256, rows = threads / 32;
  adaln_fwd_kernel<ADA_C, Tin><<<(M + rows - 1) / rows, threads, 0, s>>>(
      x, out, gamma, beta, M, rpc, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// AdaLayerNorm backward (JAX `_adaln_bwd_from_stats`), one block per clip,
// a warp per row. With u = x - mean, inv = 1/(sigma + eps):
//   du = g*dy*inv - u * inv^2 * sum(g*dy*u) / ((C-1) * max(sigma, 1e-20))
//   dx = du - mean(du) [+ res]
// Writes dx (f32) and/or bf16(dx * rowscale[clip]), and the clip's
// dgamma = sum dy*u*inv and dbeta = sum dy, summed over its rows by warps
// and then over warps in a fixed order (no atomics).
// ---------------------------------------------------------------------------
constexpr int ADB_THREADS = 512;

template <int CW, typename Tx>
__global__ void __launch_bounds__(ADB_THREADS)
    adaln_bwd_kernel(const float* dy, const Tx* x, const float* gamma,
                     float eps, const void* res, int res_f32,
                     const float* rowscale, int N, float* dx, bf16* dxs,
                     float* dgamma, float* dbeta) {
  constexpr int PER = CW / 32, W = ADB_THREADS / 32;
  __shared__ float red[2][W][CW];
  const int clip = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* g = gamma + (size_t)clip * CW;
  const float sc = rowscale ? rowscale[clip] : 1.f;
  float ag[PER], ab[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) ag[i] = ab[i] = 0.f;
  for (int r = warp; r < N; r += W) {
    const size_t base = ((size_t)clip * N + r) * CW;
    float u[PER], d[PER], s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      u[i] = ldf(x + base + lane + 32 * i);
      s += u[i];
    }
    const float mean = warp_sum(s) * (1.0f / CW);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      u[i] -= mean;
      q += u[i] * u[i];
    }
    const float sigma = sqrtf(warp_sum(q) * (1.0f / (CW - 1)));
    const float inv = 1.0f / (sigma + eps);
    float sp = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      d[i] = dy[base + lane + 32 * i];
      sp += d[i] * g[lane + 32 * i] * u[i];
      ag[i] += d[i] * (u[i] * inv);
      ab[i] += d[i];
    }
    const float coef = inv * inv * warp_sum(sp) * (1.0f / (CW - 1)) /
                       fmaxf(sigma, 1e-20f);
    float sd = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      d[i] = d[i] * g[lane + 32 * i] * inv - u[i] * coef;
      sd += d[i];
    }
    const float mdu = warp_sum(sd) * (1.0f / CW);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const size_t o = base + lane + 32 * i;
      float v = d[i] - mdu;
      if (res)
        v += res_f32 ? static_cast<const float*>(res)[o]
                     : bf2f(static_cast<const bf16*>(res)[o]);
      if (dx) dx[o] = v;
      if (dxs) dxs[o] = f2bf(v * sc);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    red[0][warp][lane + 32 * i] = ag[i];
    red[1][warp][lane + 32 * i] = ab[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * CW) {
    const int k = threadIdx.x / CW, c = threadIdx.x % CW;
    float t = 0.f;
    for (int w = 0; w < W; ++w) t += red[k][w][c];
    (k ? dbeta : dgamma)[(size_t)clip * CW + c] = t;
  }
}

template <typename Tx>
static inline int launch_adaln_bwd(const float* dy, const Tx* x,
                                   const float* gamma, float eps,
                                   const void* res, int res_f32,
                                   const float* rowscale, int clips, int N,
                                   int C, float* dx, bf16* dxs,
                                   float* dgamma, float* dbeta,
                                   cudaStream_t s) {
  if (C != ADA_C) return static_cast<int>(cudaErrorInvalidValue);
  adaln_bwd_kernel<ADA_C, Tx><<<clips, ADB_THREADS, 0, s>>>(
      dy, x, gamma, eps, res, res_f32, rowscale, N, dx, dxs, dgamma, dbeta);
  return static_cast<int>(cudaGetLastError());
}

// out[r, c] = bf16(a[r, c] * scale[r / rps]) over [M, C].
__global__ void scale_rows_kernel(const bf16* a, const float* scale, int rps,
                                  int C, long long n, bf16* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = f2bf(bf2f(a[i]) * scale[(i / C) / rps]);
}

// ---------------------------------------------------------------------------
// Multi-head attention over clips: q [clips*Nq, .] (pre-scaled by
// 1/sqrt(D)), k and v [clips*Nk, .], head h at columns h*D..h*D+D of each
// (row strides ldq, ldk, ldv). One thread per query, ATT_T queries a block
// (grid: query tiles x heads x clips); keys stream through shared memory in
// tiles of ATT_T, so no score matrix is ever held (the vertex stream's
// 431 x 431 f32 scores per head would not fit a block's shared memory).
// Two passes over the keys: the max and sum of the f32 softmax, then
// o = sum_j bf16(p_ij) v_j with p_ij = exp(s_ij - m_i) / l_i, the plain
// version's cast point. m and l are kept for the backward.
// ---------------------------------------------------------------------------
constexpr int ATT_T = 64;

template <int D>
__device__ __forceinline__ void load_row(const bf16* p, float* dst) {
#pragma unroll
  for (int d = 0; d < D; d += 8) load8(p + d, dst + d);
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// Stage rows [r0, r0 + n) of a head's D columns into shared f32 [ATT_T][D].
template <int D>
__device__ __forceinline__ void stage_rows(const bf16* src, int ld, int r0,
                                           int n, float (*dst)[D]) {
  for (int e = threadIdx.x; e < n * (D / 8); e += blockDim.x) {
    const int r = e / (D / 8), d = (e % (D / 8)) * 8;
    load8(src + (size_t)(r0 + r) * ld + d, &dst[r][d]);
  }
}

template <int D>
__global__ void __launch_bounds__(ATT_T)
    attn_fwd_kernel(const bf16* q, int ldq, const bf16* k, int ldk,
                    const bf16* v, int ldv, bf16* o, int ldo, float* stat_m,
                    float* stat_l, int Nq, int Nk, int H) {
  __shared__ float Ks[ATT_T][D];
  __shared__ float Vs[ATT_T][D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < Nq;
  const bf16* kb = k + (size_t)b * Nk * ldk + h * D;
  const bf16* vb = v + (size_t)b * Nk * ldv + h * D;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = acc[d] = 0.f;
  if (active) load_row<D>(q + ((size_t)b * Nq + i) * ldq + h * D, qr);
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < Nk; j0 += ATT_T) {
    const int n = min(ATT_T, Nk - j0);
    __syncthreads();
    stage_rows<D>(kb, ldk, j0, n, Ks);
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float s = dot<D>(qr, Ks[j]);
        const float mn = fmaxf(m, s);
        l = l * expf(m - mn) + expf(s - mn);
        m = mn;
      }
    }
  }
  const float inv = 1.0f / l;
  for (int j0 = 0; j0 < Nk; j0 += ATT_T) {
    const int n = min(ATT_T, Nk - j0);
    __syncthreads();
    stage_rows<D>(kb, ldk, j0, n, Ks);
    stage_rows<D>(vb, ldv, j0, n, Vs);
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float p = rbf(expf(dot<D>(qr, Ks[j]) - m) * inv);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += p * Vs[j][d];
      }
    }
  }
  if (!active) return;
  bf16* op = o + ((size_t)b * Nq + i) * ldo + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = f2bf(acc[d]);
  const size_t si = ((size_t)b * H + h) * Nq + i;
  stat_m[si] = m;
  stat_l[si] = l;
}

// Backward, query pass: per query i, Dsum_i = sum_j p_ij dp_ij (dp =
// dO_i . v_j, p recomputed from the saved m, l), then
// dq_i = qscale * sum_j bf16(p_ij (dp_ij - Dsum_i)) k_j, in unscaled-q terms.
template <int D>
__global__ void __launch_bounds__(ATT_T)
    attn_bwd_q_kernel(const bf16* q, int ldq, const bf16* k, int ldk,
                      const bf16* v, int ldv, const bf16* dout, int ldd,
                      const float* stat_m, const float* stat_l, float* dsum,
                      bf16* dq, int lddq, float qscale, int Nq, int Nk,
                      int H) {
  __shared__ float Ks[ATT_T][D];
  __shared__ float Vs[ATT_T][D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < Nq;
  const bf16* kb = k + (size_t)b * Nk * ldk + h * D;
  const bf16* vb = v + (size_t)b * Nk * ldv + h * D;
  const size_t si = ((size_t)b * H + h) * Nq + (active ? i : 0);
  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = dor[d] = acc[d] = 0.f;
  float m = 0.f, inv = 0.f;
  if (active) {
    load_row<D>(q + ((size_t)b * Nq + i) * ldq + h * D, qr);
    load_row<D>(dout + ((size_t)b * Nq + i) * ldd + h * D, dor);
    m = stat_m[si];
    inv = 1.0f / stat_l[si];
  }
  float Dacc = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < Nk; j0 += ATT_T) {
      const int n = min(ATT_T, Nk - j0);
      __syncthreads();
      stage_rows<D>(kb, ldk, j0, n, Ks);
      stage_rows<D>(vb, ldv, j0, n, Vs);
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < n; ++j) {
        const float p = expf(dot<D>(qr, Ks[j]) - m) * inv;
        const float dp = dot<D>(dor, Vs[j]);
        if (pass == 0) {
          Dacc += p * dp;
        } else {
          const float ds = rbf(p * (dp - Dacc));
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += ds * Ks[j][d];
        }
      }
    }
  }
  if (!active) return;
  dsum[si] = Dacc;
  bf16* o = dq + ((size_t)b * Nq + i) * lddq + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = f2bf(acc[d] * qscale);
}

// Backward, key pass: per key j, over all queries i of its clip,
// dk_j = sum_i bf16(ds_ij) q'_i and dv_j = sum_i bf16(p_ij) dO_i. Keys are
// the outer loop (one thread each), so dk and dv sum within a thread.
template <int D>
__global__ void __launch_bounds__(ATT_T)
    attn_bwd_kv_kernel(const bf16* q, int ldq, const bf16* k, int ldk,
                       const bf16* v, int ldv, const bf16* dout, int ldd,
                       const float* stat_m, const float* stat_l,
                       const float* dsum, bf16* dk, int lddk, bf16* dv,
                       int lddv, int Nq, int Nk, int H) {
  __shared__ float Qs[ATT_T][D];
  __shared__ float Os[ATT_T][D];
  __shared__ float Ms[ATT_T], Ls[ATT_T], Ds[ATT_T];
  const int b = blockIdx.z, h = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < Nk;
  const bf16* qb = q + (size_t)b * Nq * ldq + h * D;
  const bf16* ob = dout + (size_t)b * Nq * ldd + h * D;
  const size_t sb = ((size_t)b * H + h) * Nq;
  float kr[D], vr[D], ak[D], av[D];
#pragma unroll
  for (int d = 0; d < D; ++d) kr[d] = vr[d] = ak[d] = av[d] = 0.f;
  if (active) {
    load_row<D>(k + ((size_t)b * Nk + j) * ldk + h * D, kr);
    load_row<D>(v + ((size_t)b * Nk + j) * ldv + h * D, vr);
  }
  for (int i0 = 0; i0 < Nq; i0 += ATT_T) {
    const int n = min(ATT_T, Nq - i0);
    __syncthreads();
    stage_rows<D>(qb, ldq, i0, n, Qs);
    stage_rows<D>(ob, ldd, i0, n, Os);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      Ms[e] = stat_m[sb + i0 + e];
      Ls[e] = 1.0f / stat_l[sb + i0 + e];
      Ds[e] = dsum[sb + i0 + e];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const float p = expf(dot<D>(Qs[i], kr) - Ms[i]) * Ls[i];
      const float dp = dot<D>(Os[i], vr);
      const float ds = rbf(p * (dp - Ds[i]));
      const float pb = rbf(p);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        ak[d] += ds * Qs[i][d];
        av[d] += pb * Os[i][d];
      }
    }
  }
  if (!active) return;
  bf16* kp = dk + ((size_t)b * Nk + j) * lddk + h * D;
  bf16* vp = dv + ((size_t)b * Nk + j) * lddv + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kp[d] = f2bf(ak[d]);
    vp[d] = f2bf(av[d]);
  }
}

static inline int att_threads(int n) { return n <= 32 ? 32 : ATT_T; }

// The attention's operand pointers and row strides.
struct AttnIO {
  const bf16 *q, *k, *v;
  int ldq, ldk, ldv;
};

static inline int launch_attn_fwd(const AttnIO& a, bf16* o, int ldo,
                                  float* sm, float* sl, int clips, int Nq,
                                  int Nk, int H, int D, cudaStream_t s) {
  const int t = att_threads(Nq);
  const dim3 grid((Nq + t - 1) / t, H, clips);
#define PMCE_ATTF(DV)                                                      \
  attn_fwd_kernel<DV><<<grid, t, 0, s>>>(a.q, a.ldq, a.k, a.ldk, a.v,      \
                                         a.ldv, o, ldo, sm, sl, Nq, Nk, H)
  switch (D) {
    case 8: PMCE_ATTF(8); break;
    case 16: PMCE_ATTF(16); break;
    case 32: PMCE_ATTF(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PMCE_ATTF
  return static_cast<int>(cudaGetLastError());
}

static inline int launch_attn_bwd(const AttnIO& a, const bf16* dout,
                                  int ldd, const float* sm, const float* sl,
                                  float* dsum, bf16* dq, int lddq, bf16* dk,
                                  int lddk, bf16* dv, int lddv, float qscale,
                                  int clips, int Nq, int Nk, int H, int D,
                                  cudaStream_t s) {
  const int tq = att_threads(Nq), tk = att_threads(Nk);
  const dim3 gq((Nq + tq - 1) / tq, H, clips), gk((Nk + tk - 1) / tk, H,
                                                   clips);
#define PMCE_ATTB(DV)                                                       \
  attn_bwd_q_kernel<DV><<<gq, tq, 0, s>>>(a.q, a.ldq, a.k, a.ldk, a.v,      \
                                          a.ldv, dout, ldd, sm, sl, dsum,   \
                                          dq, lddq, qscale, Nq, Nk, H);     \
  attn_bwd_kv_kernel<DV><<<gk, tk, 0, s>>>(a.q, a.ldq, a.k, a.ldk, a.v,     \
                                           a.ldv, dout, ldd, sm, sl, dsum,  \
                                           dk, lddk, dv, lddv, Nq, Nk, H)
  switch (D) {
    case 8: PMCE_ATTB(8); break;
    case 16: PMCE_ATTB(16); break;
    case 32: PMCE_ATTB(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PMCE_ATTB
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Host-side pieces of the launch sequences.
// ---------------------------------------------------------------------------

// Scratch carved from one workspace the wrapper allocates; with a null base
// only the size is counted (the *_workspace entry points).
struct Carve {
  char* base;
  size_t off = 0;
  explicit Carve(void* b) : base(static_cast<char*>(b)) {}
  template <typename T>
  T* take(size_t n) {
    T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (n * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

static inline int gemm(int epi, const bf16* A, const bf16* W, int M, int N,
                       int K, void* out, int out_f32, const float* bias,
                       cudaStream_t s, const void* res = nullptr,
                       int res_f32 = 0, const float* rowscale = nullptr,
                       int rps = 1, int qcols = 0, float qscale = 1.f,
                       float* save = nullptr, const float* aux = nullptr) {
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
  return launch_gemm(epi, out_f32, A, W, M, N, K, e, out, s);
}

// Splits of a weight-gradient product's K = M rows: about two waves of
// blocks on the card's 132 SMs.
static inline int tn_splits(int Kr, int Mo, int N) {
  const int tiles = (Mo / (Mo % 128 ? 64 : 128)) * (N / (N % 128 ? 64 : 128));
  const int kt = (Kr + BK - 1) / BK;
  return max(1, min(kt, (2 * 132 + tiles - 1) / tiles));
}

static inline size_t tn_part_elems(int Kr, int Mo, int N) {
  return (size_t)tn_splits(Kr, Mo, N) * Mo * N;
}

static inline size_t colsum_part_elems(int M, int N) {
  return (size_t)((M + COLSUM_ROWS - 1) / COLSUM_ROWS) * N;
}

// out[N] = column sums of bf16 a [M, N] (partials, then a fixed-order sum).
static inline int colsum_to(const bf16* a, int M, int N, float* part,
                            float* out, cudaStream_t s) {
  PMCE_TRY(launch_colsum(a, M, N, part, N, 0, s));
  return launch_reduce(part, (M + COLSUM_ROWS - 1) / COLSUM_ROWS, N, out, s);
}

// out[Mo, N] = Aᵀ G over Kr rows (split-K partials, then a fixed-order sum).
static inline int wgrad_to(const bf16* A, const bf16* G, int Kr, int Mo,
                           int N, float* part, float* out, cudaStream_t s) {
  const int sp = tn_splits(Kr, Mo, N);
  PMCE_TRY(launch_gemm_tn(A, G, Kr, Mo, N, sp, part, (long long)Mo * N, 0,
                          s));
  return launch_reduce(part, sp, (long long)Mo * N, out, s);
}

// Self-attention forward up to the output projection: qkv = h @ Wqkv +
// bqkv with q scaled by 1/sqrt(D) in f32 before its bf16 rounding, then
// the attention of each clip's N rows into o.
static inline int self_attn_fwd(const bf16* h, int clips, int N, int C,
                                int H, const bf16* wqkv, const float* bqkv,
                                bf16* qkv, bf16* o, float* sm, float* sl,
                                cudaStream_t s) {
  const int M = clips * N, D = C / H;
  PMCE_TRY(gemm(EPI_QKV, h, wqkv, M, 3 * C, C, qkv, 0, bqkv, s, nullptr, 0,
                nullptr, 1, C, 1.0f / sqrtf(static_cast<float>(D))));
  const AttnIO io{qkv, qkv + C, qkv + 2 * C, 3 * C, 3 * C, 3 * C};
  return launch_attn_fwd(io, o, C, sm, sl, clips, N, N, H, D, s);
}

// Self-attention backward from ga = dL/d(attention output) (bf16):
// dbproj, dWproj = oᵀ ga, do = ga @ Wprojᵀ, the attention backward into
// dqkv, dbqkv, dWqkv = hᵀ dqkv and dh = dqkv @ Wqkvᵀ (f32 or bf16). The
// scratch dout, dqkv, dsum and the partial buffers come from the caller.
struct SelfAttnGrads {
  float *dwqkv, *dbqkv, *dwproj, *dbproj;
};

static inline int self_attn_bwd(const bf16* h, const bf16* ga, int clips,
                                int N, int C, int H, const bf16* qkv,
                                const bf16* o, const float* sm,
                                const float* sl, const bf16* wqkv_t,
                                const bf16* wproj_t, bf16* dout, bf16* dqkv,
                                float* dsum, float* colpart, float* tnpart,
                                const SelfAttnGrads& g, void* dh,
                                int dh_f32, cudaStream_t s) {
  const int M = clips * N, D = C / H;
  PMCE_TRY(colsum_to(ga, M, C, colpart, g.dbproj, s));
  PMCE_TRY(wgrad_to(o, ga, M, C, C, tnpart, g.dwproj, s));
  PMCE_TRY(gemm(EPI_STORE, ga, wproj_t, M, C, C, dout, 0, nullptr, s));
  const AttnIO io{qkv, qkv + C, qkv + 2 * C, 3 * C, 3 * C, 3 * C};
  PMCE_TRY(launch_attn_bwd(io, dout, C, sm, sl, dsum, dqkv, 3 * C,
                           dqkv + C, 3 * C, dqkv + 2 * C, 3 * C,
                           1.0f / sqrtf(static_cast<float>(D)), clips, N, N,
                           H, D, s));
  PMCE_TRY(colsum_to(dqkv, M, 3 * C, colpart, g.dbqkv, s));
  PMCE_TRY(wgrad_to(h, dqkv, M, C, 3 * C, tnpart, g.dwqkv, s));
  return gemm(EPI_STORE, dqkv, wqkv_t, M, C, 3 * C, dh, dh_f32, nullptr, s);
}

// The AdaLN'd MLP half of both decoder blocks, forward:
// h2 = bf16(AdaLN(x1; gamma2, beta2)), hh = h2 @ W1 + b1 (kept f32),
// ge = bf16(gelu(hh)), out = bf16(x1 + m2[clip] * mo), mo = ge @ W2 + b2
// (kept f32 in `mo` when set: the mask's gradient reads it).
static inline int ada_mlp_fwd(const float* x1, int clips, int N, int C,
                              int hid, const float* gamma2,
                              const float* beta2, float eps, const bf16* w1,
                              const float* bb1, const bf16* w2,
                              const float* bb2, const float* m2, bf16* h2,
                              float* hh, bf16* ge, bf16* out,
                              cudaStream_t s, float* mo = nullptr) {
  const int M = clips * N;
  PMCE_TRY(launch_adaln(x1, h2, gamma2, beta2, M, N, C, eps, s));
  PMCE_TRY(gemm(EPI_GELU, h2, w1, M, hid, C, ge, 0, bb1, s, nullptr, 0,
                nullptr, 1, 0, 1.f, hh));
  return gemm(EPI_RES, ge, w2, M, C, hid, out, 0, bb2, s, x1, 1, m2, N, 0,
              1.f, mo);
}

// Its backward from g = dL/d(out) (bf16): dW2, db2, dW1, db1, the clip's
// dgamma2 / dbeta2, dx1 = g + AdaLN backward (f32) and da = bf16(dx1 *
// m1[clip]), the gradient the attention half's output receives.
struct MlpGrads {
  float *dw1, *dbb1, *dw2, *dbb2, *dgamma2, *dbeta2;
};

static inline int ada_mlp_bwd(const bf16* g, const float* x1,
                              const bf16* h2, const float* hh,
                              const bf16* ge, int clips, int N, int C,
                              int hid, const float* gamma2, float eps,
                              const bf16* w1_t, const bf16* w2_t,
                              const float* m1, const float* m2, bf16* m2g,
                              bf16* dhh, float* dh2, float* dx1, bf16* da,
                              float* colpart, float* tnpart,
                              const MlpGrads& mg, cudaStream_t s) {
  const int M = clips * N;
  const long long n = (long long)M * C;
  const bf16* gs = g;
  if (m2) {
    scale_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        g, m2, N, C, n, m2g);
    PMCE_TRY(static_cast<int>(cudaGetLastError()));
    gs = m2g;
  }
  PMCE_TRY(colsum_to(gs, M, C, colpart, mg.dbb2, s));
  PMCE_TRY(wgrad_to(ge, gs, M, hid, C, tnpart, mg.dw2, s));
  PMCE_TRY(gemm(EPI_DGELU, gs, w2_t, M, hid, C, dhh, 0, nullptr, s, nullptr,
                0, nullptr, 1, 0, 1.f, nullptr, hh));
  PMCE_TRY(colsum_to(dhh, M, hid, colpart, mg.dbb1, s));
  PMCE_TRY(wgrad_to(h2, dhh, M, C, hid, tnpart, mg.dw1, s));
  PMCE_TRY(gemm(EPI_STORE, dhh, w1_t, M, C, hid, dh2, 1, nullptr, s));
  return launch_adaln_bwd(dh2, x1, gamma2, eps, g, 0, m1, clips, N, C, dx1,
                          da, mg.dgamma2, mg.dbeta2, s);
}

}  // namespace pmce
