// Device pieces of the decoder's AdaLN tile programs: the CA block's
// forward (row 10) and backward (row 11) in ca_block.cu, the AdaLN
// self-attention block's forward (row 8) and backward (row 9) in
// ada_block.cu; and of the self-attention forward's and backward's tile
// programs (rows 4 and 5) in mhsa.cu (the two-pass attention of a tile of
// whole clips, and its backward, which row 9 shares).
//
// Clusters of CL = 4 CTAs a clip (rows 9-11), or 4 ordinary CTAs a clip
// (row 8), each walking its quarter of the clip's rows (rows 10 / 11: of
// its long side) in passes of up to RT rows, as many as it takes; 8 warps
// a CTA, C = 64 channels. A warp
// owns 16 rows and keeps them in the mma.sync m16n8k16 accumulator layout
// ([8][4] floats a lane: n8 tile j, rows g = lane / 4 (e < 2) and g + 8,
// columns 8 j + 2 (lane % 4) + (e & 1)) from one product to the next; the
// AdaLN statistics of a row are quad sums of that layout. Products read W
// from its own [in, out] rows: ldmatrix without .trans gives W^T's B
// fragments (gemm16x64), with .trans W's own (mma_aw, mma_sw): no
// transposed copy is ever made.
#pragma once

#include "transformer_ops.cuh"

namespace tile {

using namespace pmce;

constexpr int CL = 4;          // CTAs of a clip's cluster
constexpr int NTH = 256;       // 8 warps
constexpr int NW = NTH / 32;
constexpr int CW = 64;         // C
constexpr int LD = CW + 8;     // bf16 row stride of the [rows, 64] tiles
constexpr int RT = 128;        // long-side rows of a CTA's pass (16 a warp)
constexpr int ST = 64;         // short-side rows
constexpr int MAX_HID = 256;
constexpr int MAXH = 8;        // heads (head width 8)

// Rows [l0, l1) of a clip's n rows that cluster rank `rank` owns: quarters
// of whole 16-row blocks.
__host__ __device__ inline int rank_rows(int n) {
  return ((n + CL - 1) / CL + 15) / 16 * 16;
}

// clock64() stamps of a program's N stages, summed over its visits; one
// row of N int64 a CTA (ON = false compiles to nothing).
template <bool ON, int N>
struct StageClock {
  long long acc[N];
  long long last;
  __device__ __forceinline__ void start() {
    if constexpr (ON) {
      for (int i = 0; i < N; ++i) acc[i] = 0;
      last = clock64();
    }
  }
  __device__ __forceinline__ void operator()(int kind) {
    if constexpr (ON) {
      __syncthreads();
      const long long t = clock64();
      acc[kind] += t - last;
      last = t;
    }
  }
  __device__ __forceinline__ void write(long long* out) {
    if constexpr (ON) {
      if (threadIdx.x == 0)
        for (int i = 0; i < N; ++i) out[(size_t)blockIdx.x * N + i] = acc[i];
    }
  }
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// acc[16, 64] += A[16, 64] @ W^T for W a [64 (n), 64 (k)] block at row
// stride ldw: W^T's B fragments read from W's own rows (no .trans).
__device__ __forceinline__ void gemm16x64(float (&acc)[8][4], const bf16* A,
                                          int lda, const bf16* W, int ldw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < CW; kk += 16) {
    unsigned af[4];
    ldsm_x4(af, A + (lane & 15) * lda + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      unsigned bf[4];
      ldsm_x4(bf, W + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldw +
                      kk + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nb], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16, 64] += A @ W for A's fragments over k = 64 (af[kk / 16]) and W a
// [64 (k), 64 (n)] block at row stride ldw (ldmatrix .trans: W's own rows).
__device__ __forceinline__ void mma_aw(float (&acc)[8][4],
                                       const unsigned (&af)[4][4],
                                       const bf16* W, int ldw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      unsigned bf[4];
      ldsm_x4_t(bf, W + (kb * 16 + (lane & 15)) * ldw + nb * 16 +
                        (lane >> 4) * 8);
      mma_bf16(acc[2 * nb], af[kb], bf[0], bf[1]);
      mma_bf16(acc[2 * nb + 1], af[kb], bf[2], bf[3]);
    }
}

// The A fragments (k = 64) of 16 rows in shared memory at row stride lda.
__device__ __forceinline__ void load_a(unsigned (&af)[4][4], const bf16* A,
                                       int lda) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    ldsm_x4(af[kb], A + (lane & 15) * lda + kb * 16 + (lane >> 4) * 8);
}

// The same as mma_aw with A's 16 rows in shared memory at row stride lda.
__device__ __forceinline__ void mma_sw(float (&acc)[8][4], const bf16* A,
                                       int lda, const bf16* W, int ldw) {
  unsigned af[4][4];
  load_a(af, A, lda);
  mma_aw(acc, af, W, ldw);
}

__device__ __forceinline__ void zero(float (&v)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
}

// The A fragments of a warp's 16 rows of a head's D columns (row stride
// lda), kept in registers across the key blocks they meet (head width 8:
// the m16n8k8 fragment in r[0][0..1]).
template <int D>
struct QFrag {
  unsigned r[D == 8 ? 1 : D / 16][4];
};

template <int D>
__device__ __forceinline__ void load_q(QFrag<D>& q, const bf16* A, int lda) {
  const int lane = threadIdx.x & 31;
  if constexpr (D == 8) {
    unsigned t[2];
    ldsm_x2(t, A + (lane & 15) * lda);
    q.r[0][0] = t[0];
    q.r[0][1] = t[1];
  } else {
#pragma unroll
    for (int s = 0; s < D; s += 16)
      ldsm_x4(q.r[s / 16], A + (lane & 15) * lda + s + (lane >> 4) * 8);
  }
}

// acc[t] (keys or queries n0 + 8t ..) += q . B[16, D]^T: B rows of a
// head's D columns at row stride ldb.
template <int D>
__device__ __forceinline__ void dot_q(float (&acc)[2][4], const QFrag<D>& q,
                                      const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (D == 8) {
    unsigned bf[2];
    ldsm_x2(bf, B + (lane & 15) * ldb);
    const unsigned a[2] = {q.r[0][0], q.r[0][1]};
    mma_k8(acc[0], a, bf[0]);
    mma_k8(acc[1], a, bf[1]);
  } else {
#pragma unroll
    for (int s = 0; s < D; s += 16) {
      unsigned bf[4];
      ldsm_x4(bf, B + ((lane & 7) + ((lane >> 4) << 3)) * ldb + s +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[0], q.r[s / 16], bf[0], bf[1]);
      mma_bf16(acc[1], q.r[s / 16], bf[2], bf[3]);
    }
  }
}

// acc[t] (keys or queries n0 + 8t ..) += A[16, D] . B[16, D]^T: A and B rows
// of a head's D columns at row strides lda, ldb.
template <int D>
__device__ __forceinline__ void dot_nt(float (&acc)[2][4], const bf16* A,
                                       int lda, const bf16* B, int ldb) {
  QFrag<D> q;
  load_q(q, A, lda);
  dot_q(acc, q, B, ldb);
}

// acc[base .. base + D / 8) (a [16, D] block of a [16, 64] accumulator) +=
// P (the A fragments of a 16 x 16 block) @ B[16, D], B rows at row stride
// ldb ([k, n] order: ldmatrix .trans).
template <int D, int N>
__device__ __forceinline__ void dot_pn(float (&acc)[N][4], int base,
                                       const unsigned (&pa)[4], const bf16* B,
                                       int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (D == 8) {
    unsigned bf[2];
    ldsm_x2_t(bf, B + (lane & 15) * ldb);
    mma_bf16(acc[base], pa, bf[0], bf[1]);
  } else {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned bf[4];
      ldsm_x4_t(bf, B + (lane & 15) * ldb + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[base + 2 * dp], pa, bf[0], bf[1]);
      mma_bf16(acc[base + 2 * dp + 1], pa, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ void pack_a(unsigned (&pa)[4],
                                       const float (&v)[2][4]) {
  pa[0] = pack_bf2(v[0][0], v[0][1]);
  pa[1] = pack_bf2(v[0][2], v[0][3]);
  pa[2] = pack_bf2(v[1][0], v[1][1]);
  pa[3] = pack_bf2(v[1][2], v[1][3]);
}

// The A fragments (k = 64) of a warp's [16, 64] accumulator rounded to bf16.
__device__ __forceinline__ void frag_a(unsigned (&af)[4][4],
                                       const float (&v)[8][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    af[kb][0] = pack_bf2(v[2 * kb][0], v[2 * kb][1]);
    af[kb][1] = pack_bf2(v[2 * kb][2], v[2 * kb][3]);
    af[kb][2] = pack_bf2(v[2 * kb + 1][0], v[2 * kb + 1][1]);
    af[kb][3] = pack_bf2(v[2 * kb + 1][2], v[2 * kb + 1][3]);
  }
}

// v[j][e] += p[column] for a vector p of 64 columns (a bias or a clip's
// row).
__device__ __forceinline__ void add_cols(float (&v)[8][4], const float* p) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(p + j * 8 + 2 * tq);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      v[j][2 * hf] += b.x;
      v[j][2 * hf + 1] += b.y;
    }
  }
}

// AdaLN forward of a warp's 16 rows in accumulator layout, in place (the
// plain version's adaln_f32: unbiased sigma, eps outside the sqrt, f32):
// x = gamma * (x - mean) / (sigma + eps) + beta with the clip's gamma,
// beta rows.
__device__ __forceinline__ void adaln_fwd_frag(float (&x)[8][4],
                                               const float* gam,
                                               const float* bet, float eps) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += x[j][2 * hf] + x[j][2 * hf + 1];
    const float mean = quad_sum(s) * (1.0f / CW);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float u = x[j][2 * hf + e] - mean;
        x[j][2 * hf + e] = u;
        q += u * u;
      }
    const float den = sqrtf(quad_sum(q) * (1.0f / (CW - 1))) + eps;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * tq + e;
        x[j][2 * hf + e] = gam[c] * (x[j][2 * hf + e] / den) + bet[c];
      }
  }
}

// AdaLN backward (attention_ops.cuh's adaln_bwd_kernel) of a warp's 16
// rows held in accumulator layout: x (f32, overwritten by x - mean), dy (the
// gradient of the norm's output, overwritten by dx without a residual), gm
// the clip's gamma at the lane's columns; the lane's dgamma (dy * xhat) and
// dbeta (dy) terms of its valid rows added to cg, cb.
__device__ __forceinline__ void adaln_bwd_frag(float (&dy)[8][4],
                                               float (&x)[8][4],
                                               const float (&gm)[8][2],
                                               float eps, bool v0, bool v1,
                                               float (&cg)[8][2],
                                               float (&cb)[8][2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool valid = hf ? v1 : v0;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += x[j][2 * hf] + x[j][2 * hf + 1];
    const float mean = quad_sum(s) * (1.0f / CW);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float u = x[j][2 * hf + e] - mean;
        x[j][2 * hf + e] = u;
        q += u * u;
      }
    const float sigma = sqrtf(quad_sum(q) * (1.0f / (CW - 1)));
    const float inv = 1.0f / (sigma + eps);
    float sp = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sp += dy[j][2 * hf + e] * gm[j][e] * x[j][2 * hf + e];
    const float coef = inv * inv * quad_sum(sp) * (1.0f / (CW - 1)) /
                       fmaxf(sigma, 1e-20f);
    float sd = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = dy[j][2 * hf + e], u = x[j][2 * hf + e];
        if (valid) {
          cg[j][e] += d * (u * inv);
          cb[j][e] += d;
        }
        const float du = d * gm[j][e] * inv - u * coef;
        dy[j][2 * hf + e] = du;
        sd += du;
      }
    const float mdu = quad_sum(sd) * (1.0f / CW);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dy[j][2 * hf] -= mdu;
      dy[j][2 * hf + 1] -= mdu;
    }
  }
}

// Column sums of the lane's per-column terms over the warp's rows, into
// dst[64] (lanes 0-3 write).
__device__ __forceinline__ void warp_cols(const float (&v)[8][2], float* dst) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[j][e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) dst[j * 8 + 2 * lane + e] = s;
    }
}

// The warps' column partials (wpt [warp][2][64]) added in warp order into
// vp[idx], vp[idx + 1] (64 each); the warps' scalar partials (wpm
// [warp][2]) into vp[mslot], vp[mslot + 1] when `masks`.
__device__ __forceinline__ void fold(float* vp, const float* wpt,
                                     const float* wpm, int idx, bool masks,
                                     int mslot) {
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < 2 * CW) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += wpt[(w * 2 + tid / CW) * CW + tid % CW];
    vp[idx * CW + tid] += s;
  } else if (masks && tid < 2 * CW + 2) {
    const int i = tid - 2 * CW;
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += wpm[w * 2 + i];
    vp[mslot + i] += s;
  }
  __syncthreads();
}

// Values of an [rows, ld] matrix's 64 columns from col0 at the accumulator
// positions of a warp's 16 rows from row0 (zeros past `valid` rows): f32
// or bf16 sources.
__device__ __forceinline__ void load_frag(float (&v)[8][4], const float* p,
                                          size_t row0, bool v0, bool v1,
                                          int ld = CW, int col0 = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool ok = hf ? v1 : v0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 x = make_float2(0.f, 0.f);
      if (ok)
        x = *reinterpret_cast<const float2*>(
            p + (row0 + g + 8 * hf) * ld + col0 + j * 8 + 2 * tq);
      v[j][2 * hf] = x.x;
      v[j][2 * hf + 1] = x.y;
    }
  }
}
__device__ __forceinline__ void load_frag(float (&v)[8][4], const bf16* p,
                                          size_t row0, bool v0, bool v1,
                                          int ld = CW, int col0 = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool ok = hf ? v1 : v0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 x = make_float2(0.f, 0.f);
      if (ok)
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            p + (row0 + g + 8 * hf) * ld + col0 + j * 8 + 2 * tq));
      v[j][2 * hf] = x.x;
      v[j][2 * hf + 1] = x.y;
    }
  }
}

// A clip's gamma at the lane's columns.
__device__ __forceinline__ void load_gamma(float (&gm)[8][2], const float* p) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gm[j][0] = p[j * 8 + 2 * tq];
    gm[j][1] = p[j * 8 + 2 * tq + 1];
  }
}

// The bf16 rounding of a warp's accumulator rows into the tile `t` (row
// stride LD) and, for valid rows, into dst's rows row0 .. (null: none).
// EF: dst written evict-first (st.global.cs): state only a backward reads,
// which would otherwise push what the program reads again out of L2.
template <bool EF = false>
__device__ __forceinline__ void store_bf(const float (&v)[8][4], bf16* t,
                                         bf16* dst, size_t row0, bool v0,
                                         bool v1, int ld = CW, int col0 = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * tq;
      const unsigned pk = pack_bf2(v[j][2 * hf], v[j][2 * hf + 1]);
      if (t) *reinterpret_cast<unsigned*>(t + (g + 8 * hf) * LD + c) = pk;
      if (dst && (hf ? v1 : v0)) {
        unsigned* p = reinterpret_cast<unsigned*>(
            dst + (row0 + g + 8 * hf) * ld + col0 + c);
        if constexpr (EF)
          __stcs(p, pk);
        else
          *p = pk;
      }
    }
}

// A warp's accumulator rows, f32, into dst's valid rows row0 .. (row
// stride ld, columns col0 ..); EF as store_bf's.
template <bool EF = false>
__device__ __forceinline__ void store_f32(const float (&v)[8][4], float* dst,
                                          size_t row0, bool v0, bool v1,
                                          int ld = CW, int col0 = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!(hf ? v1 : v0)) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2* p = reinterpret_cast<float2*>(dst + (row0 + g + 8 * hf) * ld +
                                            col0 + j * 8 + 2 * tq);
      const float2 x = make_float2(v[j][2 * hf], v[j][2 * hf + 1]);
      if constexpr (EF)
        __stcs(p, x);
      else
        *p = x;
    }
  }
}

// ---------------------------------------------------------------------------
// The softmax of the plain version (f32 scores, P rounded to bf16 after
// normalising) in two passes over the keys: the row max and sum, then P.V.
// Scores come in 16 x 16 blocks of mma accumulators (rows g: index 0 of m,
// l; g + 8: index 1; key column t * 8 + 2 * (lane % 4) + (e & 1) of block
// sc[t][e]); in(hf, column) says which keys a row attends to.
// ---------------------------------------------------------------------------

// exp(x) as one ex2 of x log2(e) (x = s - m <= 0; within a few f32 ulps of
// expf, far below the bf16 rounding of P).
__device__ __forceinline__ float exp_s(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// Folds a score block into the lane's running max m and sum l of exp(s -
// m) over the keys it holds (softmax_merge combines the quad's lanes).
template <typename In>
__device__ __forceinline__ void softmax_fold(const float (&sc)[2][4], In in,
                                             float (&m)[2], float (&l)[2]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float bm = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (in(hf, t * 8 + 2 * tq + e)) bm = fmaxf(bm, sc[t][2 * hf + e]);
    const float mn = fmaxf(m[hf], bm);
    if (mn == -INFINITY) continue;  // no key of the row yet
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (in(hf, t * 8 + 2 * tq + e)) s += exp_s(sc[t][2 * hf + e] - mn);
    l[hf] = l[hf] * (m[hf] == mn ? 1.f : exp_s(m[hf] - mn)) + s;
    m[hf] = mn;
  }
}

// The rows' max and sum over the quad's lanes (a row without keys keeps
// -inf and 0).
__device__ __forceinline__ void softmax_merge(float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float mx = quad_max(m[hf]);
    l[hf] = quad_sum(m[hf] == -INFINITY ? 0.f : l[hf] * exp_s(m[hf] - mx));
    m[hf] = mx;
  }
}

// A score block into probabilities exp(s - m) * li (0 for keys not
// attended to), ready for pack_a: the bf16 rounding after normalising.
template <typename In>
__device__ __forceinline__ void softmax_probs(float (&sc)[2][4], In in,
                                              const float (&m)[2],
                                              const float (&li)[2]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      sc[t][e] = in(hf, t * 8 + 2 * tq + (e & 1))
                     ? exp_s(sc[t][e] - m[hf]) * li[hf]
                     : 0.f;
    }
}

// The key (or query) blocks that a warp's 16 rows r0 .. of a tile of whole
// clips of n rows (nrows of them valid, r0 < nrows) meet: the 16-row blocks
// [beg, end) their clips span, and the clip [lo, hi) of each of the lane's
// two rows (empty past nrows).
struct ClipSpan {
  int beg, end, lo[2], hi[2];
  __device__ __forceinline__ ClipSpan(int r0, int n, int nrows) {
    const int g = (threadIdx.x & 31) >> 2;
    beg = r0 / n * n / 16 * 16;
    end = (min(r0 + 15, nrows - 1) / n + 1) * n;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
      lo[hf] = r < nrows ? r / n * n : 0;
      hi[hf] = r < nrows ? lo[hf] + n : 0;
    }
  }
  __device__ __forceinline__ bool operator()(int hf, int i) const {
    return i >= lo[hf] && i < hi[hf];
  }
};

// One head's attention for a warp's 16 query rows q0 .. of a tile of whole
// clips of n rows (nrows of them valid, q0 < nrows), each query over its
// own clip's keys: q, k, v the head's D columns of the tile's rows (row
// stride ld, rows up to nrows rounded to 16 finite). Two passes over the
// key blocks its clips span: the max m and sum l of each row (kept for the
// backward), then o += P V with P = bf16(exp(s - m) / l). UNROLL key blocks
// at a time give the products' independent work to the scheduler.
template <int D, int UNROLL = 4>
__device__ __forceinline__ void clip_attention(const bf16* q, const bf16* k,
                                               const bf16* v, int ld, int q0,
                                               int n, int nrows,
                                               float (&o)[D / 8][4],
                                               float (&m)[2], float (&l)[2]) {
  const ClipSpan sp(q0, n, nrows);
  QFrag<D> qf;
  load_q(qf, q + q0 * ld, ld);
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll UNROLL
  for (int kb = sp.beg; kb < sp.end; kb += 16) {
    const auto in = [&](int hf, int c) { return sp(hf, kb + c); };
    float sc[2][4] = {};
    dot_q<D>(sc, qf, k + kb * ld, ld);
    softmax_fold(sc, in, m, l);
  }
  softmax_merge(m, l);
  const float li[2] = {l[0] > 0.f ? 1.0f / l[0] : 0.f,
                       l[1] > 0.f ? 1.0f / l[1] : 0.f};
#pragma unroll UNROLL
  for (int kb = sp.beg; kb < sp.end; kb += 16) {
    const auto in = [&](int hf, int c) { return sp(hf, kb + c); };
    float sc[2][4] = {};
    dot_q<D>(sc, qf, k + kb * ld, ld);
    softmax_probs(sc, in, m, li);
    unsigned pa[4];
    pack_a(pa, sc);
    dot_pn<D>(o, 0, pa, v + kb * ld, ld);
  }
}

// ---------------------------------------------------------------------------
// The attention backward at the plain version's cast points, shared by the
// self-attention backward (row 5, mhsa.cu) and the AdaLN block's (row 9,
// ada_block.cu): P recomputed from the forward's saved max m and sum (li =
// 1 / l) as clip_attention forms it, dP = dO V^T, dS = P (dP - D) with D =
// dO . O over the head's columns (the caller's), dS and P rounded to bf16
// before their products, f32 sums. A row's statistics: index 0 of m, li,
// Dq for row g, 1 for g + 8.
// ---------------------------------------------------------------------------

// dq += dS K (a [16, D] block of a [16, 8 NA] accumulator from n8 tile
// base; not scaled) of a warp's 16 query rows, whose q and dO A fragments
// are qf, df, over the key blocks [k_beg, k_end) of K and V (a head's D
// columns at row stride ld); in(hf, key): the keys a row attends to.
template <int D, int NA, typename In>
__device__ __forceinline__ void attn_bwd_dq(
    float (&dq)[NA][4], int base, const QFrag<D>& qf, const QFrag<D>& df,
    const bf16* K, const bf16* V, int ld, int k_beg, int k_end, In in,
    const float (&m)[2], const float (&li)[2], const float (&Dq)[2]) {
  const int tq = threadIdx.x & 3;
  for (int kb = k_beg; kb < k_end; kb += 16) {
    float sc[2][4] = {}, dp[2][4] = {};
    dot_q<D>(sc, qf, K + kb * ld, ld);
    dot_q<D>(dp, df, V + kb * ld, ld);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float p = in(hf, kb + t * 8 + 2 * tq + (e & 1))
                            ? exp_s(sc[t][e] - m[hf]) * li[hf]
                            : 0.f;
        sc[t][e] = p * (dp[t][e] - Dq[hf]);
      }
    unsigned pa[4];
    pack_a(pa, sc);
    dot_pn<D>(dq, base, pa, K + kb * ld, ld);
  }
}

// dv += P^T dO and dk += dS^T Q (blocks of [16, 8 NA] accumulators from n8
// tile base) of a warp's 16 key rows, whose k and v A fragments are kf, vf,
// over the query blocks [q_beg, q_end) of Q and DO (a head's D columns at
// row strides ldq, ldd), query q's statistics at sm[q * ss], sl[q * ss],
// sd[q * ss] (read only where in(hf, q): query q attends key row hf).
template <int D, int NA, typename In>
__device__ __forceinline__ void attn_bwd_dkdv(
    float (&dk)[NA][4], float (&dv)[NA][4], int base, const QFrag<D>& kf,
    const QFrag<D>& vf, const bf16* Q, int ldq, const bf16* DO, int ldd,
    int q_beg, int q_end, In in, const float* sm, const float* sl,
    const float* sd, int ss) {
  const int tq = threadIdx.x & 3;
  for (int qb = q_beg; qb < q_end; qb += 16) {
    float st[2][4] = {}, dpt[2][4] = {}, ds[2][4];
    dot_q<D>(st, kf, Q + qb * ldq, ldq);
    dot_q<D>(dpt, vf, DO + qb * ldd, ldd);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qb + t * 8 + 2 * tq + (e & 1);
        const bool ok = in(e >> 1, q);
        const float p = ok ? exp_s(st[t][e] - sm[q * ss]) * sl[q * ss] : 0.f;
        ds[t][e] = ok ? p * (dpt[t][e] - sd[q * ss]) : 0.f;
        st[t][e] = p;
      }
    unsigned pa[4], pb[4];
    pack_a(pa, st);
    pack_a(pb, ds);
    dot_pn<D>(dv, base, pa, DO + qb * ldd, ldd);
    dot_pn<D>(dk, base, pb, Q + qb * ldq, ldq);
  }
}

// ---------------------------------------------------------------------------
// The AdaLN blocks' tail after their attention (rows 8 and 10), a warp's 16
// rows from row r0 (rows g, g + 8 valid as v0, v1), all in registers:
//   a  = bf16(O) @ Wproj + bproj,  x1 = x + s1 * a,
//   h2 = bf16(AdaLN(x1; gamma2, beta2)),
//   per block of 64 hidden units: hh = h2 @ W1 + b1, ge = bf16(gelu(hh)),
//     mo += ge @ W2,
//   out = bf16(x1 + s2 * (mo + b2)).
// a, x1, h2, hh, ge and mo are stored where their pointers are set,
// evict-first: only the backward reads them.
// ---------------------------------------------------------------------------
struct Tail {
  const bf16* x;                        // [M, 64] the block's input
  bf16* out;
  const bf16 *wp, *w1, *w2;             // shared: [64, LD], [64, hid + 8],
                                        // [hid, LD]
  const float *bproj, *bb1, *bb2;
  const float *gamma2, *beta2;          // the clip's rows
  float *a, *x1, *hh, *mo;              // or null
  bf16 *h2, *ge;                        // or null
  int hid;
  float eps;
};

__device__ __forceinline__ void ada_tail(const Tail& t,
                                         const unsigned (&of)[4][4],
                                         size_t r0, bool v0, bool v1,
                                         float s1, float s2) {
  const int ldw1 = t.hid + 8;
  float x1[8][4], br[8][4];
  zero(br);
  mma_aw(br, of, t.wp, LD);
  add_cols(br, t.bproj);
  if (t.a) store_f32<true>(br, t.a, r0, v0, v1);
  load_frag(x1, t.x, r0, v0, v1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x1[j][e] += s1 * br[j][e];
      br[j][e] = x1[j][e];
    }
  if (t.x1) store_f32<true>(x1, t.x1, r0, v0, v1);
  unsigned af[4][4];
  adaln_fwd_frag(br, t.gamma2, t.beta2, t.eps);
  frag_a(af, br);
  if (t.h2) store_bf<true>(br, nullptr, t.h2, r0, v0, v1);
  float mo[8][4];
  zero(mo);
  for (int blk = 0; blk < t.hid / CW; ++blk) {
    float hv[8][4];
    zero(hv);
    mma_aw(hv, af, t.w1 + blk * CW, ldw1);
    add_cols(hv, t.bb1 + blk * CW);
    if (t.hh) store_f32<true>(hv, t.hh, r0, v0, v1, t.hid, blk * CW);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hv[j][e] = gelu_erf(hv[j][e]);
    unsigned gf[4][4];
    frag_a(gf, hv);
    if (t.ge) store_bf<true>(hv, nullptr, t.ge, r0, v0, v1, t.hid, blk * CW);
    mma_aw(mo, gf, t.w2 + blk * CW * LD, LD);
  }
  add_cols(mo, t.bb2);
  if (t.mo) store_f32<true>(mo, t.mo, r0, v0, v1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mo[j][e] = x1[j][e] + s2 * mo[j][e];
  store_bf(mo, nullptr, t.out, r0, v0, v1);
}

// Rows [0, n) of an [*, ld] bf16 matrix's 64 columns from col0, from row
// r0, into a tile (row stride LD) by cp.async, zeros up to the next
// multiple of 16; threads [t0, t0 + nt) issue.
__device__ __forceinline__ void load_rows(bf16* t, const bf16* src, size_t r0,
                                          int n, int ld = CW, int col0 = 0,
                                          int t0 = 0, int nt = NTH) {
  const int n16 = (n + 15) / 16 * 16;
  for (int c = threadIdx.x - t0; c < n16 * 8; c += nt) {
    const int r = c / 8, cc = c % 8 * 8;
    cp_async16(t + r * LD + cc,
               src + (r0 + (r < n ? r : 0)) * ld + col0 + cc, r < n);
  }
}

// The configuration of a launch of `ctas` CTAs of NTH threads and `smem`
// bytes on clusters of CL (the dimension as the launch's attribute, in the
// caller's `attr`, which a kernel built with __cluster_dims__(CL) admits
// too).
inline cudaLaunchConfig_t cluster_config(int ctas, int smem, cudaStream_t s,
                                         cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of CL CTAs of `kernel` (NTH threads, `smem` bytes each) the card
// holds at once (cudaOccupancyMaxActiveClusters), or minus the error code.
template <typename K>
inline int max_active_clusters(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(32 * CL, smem, 0, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kernel), &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// One launch of `kernel(args)` on clusters of CL CTAs (cudaLaunchKernelEx).
template <typename K, typename A>
inline int launch_clusters(K kernel, int ctas, int smem, cudaStream_t s,
                           const A& args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, s, attr);
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace tile
