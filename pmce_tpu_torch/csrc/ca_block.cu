// The decoder's AdaLayerNorm cross-attention block, forward and backward,
// for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_ca_block_kernel` (entry
// `fused_ca_block`) and `_ca_block_bwd_kernel` (via `_fused_ca_block_bwd`),
// the co-evolution block's CA+FFN halves:
//
//   x1 = xq + m1 * CA(AdaLN(xq), AdaLN(xk), AdaLN(xv));
//   y  = x1 + m2 * MLP(AdaLN(x1))
//
// with per-clip AdaLN vectors for all four norms and per-clip branch
// scales. Both orientations run at the training shapes: joints attending
// to vertices (32 clips, 17 queries over 431 keys, 8 heads of 8) and
// vertices attending to joints (431 queries over 17 keys, 2 heads of 32).
//
// What bounds it on this card: the products are ~0.4 GFLOP per direction
// at these shapes and the activations ~4 MB: microseconds at the bf16
// tensor-core peak or the HBM rate. Launches, host work and latency bound
// it.
//
// Forward (simple first), as ada_block.cu: one launch per stage over all
// rows; three AdaLNs, the q / k / v projections as WMMA GEMMs (q scaled in
// f32 before its bf16 rounding), attention_ops.cuh's attention with each
// clip's keys its own Nk rows (no padding, so no key mask: the TPU kernel
// pads 17 keys to a tile and masks them), the projection with its masked
// residual, the AdaLN'd MLP; the branches a and mo saved where the mask
// gradients are owed.
//
// Backward, two launches:
// - the tile program (cab::ca_bwd_tile_kernel): a cluster of CL = 4 CTAs a
//   clip (128 CTAs at batch 32, one wave on 132 SMs; one CTA a clip would
//   leave 100 SMs idle). The CTAs split the long side (the vertices' 431
//   rows: queries in one orientation, keys in the other) into quarters of
//   at most 128 rows; every CTA holds the short side (at most 64 rows)
//   whole. A CTA runs, a warp per 16 query rows: m2 * g; the MLP's
//   backward (fc2^T, gelu'(hh), fc1^T per block of 64 hidden units, all on
//   the tensor cores, mma.sync m16n8k16, B fragments read from the weights'
//   own [in, out] layout by ldmatrix without .trans: no transposed copy);
//   the norm2 AdaLN backward from the accumulator's fragments plus the
//   residual; da = m1 * dx1; proj^T. Then the attention backward on the
//   tensor cores from the forward's saved q, k, v, o and softmax
//   statistics (D = dO . O, P recomputed from the saved max and sum; head
//   width 8 by mma m16n8k8): dq by (query tile, head), dk and dv by (key
//   tile, head), each block of the result owned by one warp. Then q / k /
//   v proj^T and the three AdaLN backwards. The short side's sums over the
//   long side (dk, dv of the 17 joints as keys; dq of the 17 joints as
//   queries) and the per-clip sums (the four norms' dgamma / dbeta, the
//   mask gradients) are added across the cluster through distributed
//   shared memory by the cluster's rank 0, in rank order: no float
//   atomics, reruns bit-identical. It writes dxq, dxk, dxv, the per-clip
//   vectors and the weight products' bf16 dY operands.
// - the weight gradients (wgrad.cuh, shared with block.cu): the six
//   X^T dY products (dWq, dWk, dWv, dWproj, dW1, dW2) over a list of
//   64 x 64 output tiles, each cut into fixed K ranges; the CTA that
//   finishes a tile's last range (an integer counter, zeroed by the tile
//   program) adds the ranges' partials and column sums (the six bias
//   gradients) in range order.

#include <cooperative_groups.h>

#include "attention_ops.cuh"
#include "wgrad.cuh"

using namespace pmce;
namespace cg = cooperative_groups;

// P: xq [Mq,C], xk, xv [Mk,C] bf16; gq, bq, gk, bk, gv, bv, g2, b2 [clips,C]
// f32; m1, m2 [clips] or null; wq, bq, wk, bk, wv, bv, wproj, bproj, w1,
// bb1, w2, bb2; saved nq, nk, nv, q, k, v, o, stat_m, stat_l, x1, h2, hh,
// ge; out; the branches a, mo [Mq, C] f32 or null (saved for the mask
// gradients).
extern "C" int pmce_ca_block_fwd(void* const* P, int clips, int Nq, int Nk,
                                 int C, int hid, int H, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  const int Mq = clips * Nq, Mk = clips * Nk, D = C / H;
  PMCE_TRY(launch_adaln(b(0), b(25), f(3), f(4), Mq, Nq, C, eps, s));
  PMCE_TRY(launch_adaln(b(1), b(26), f(5), f(6), Mk, Nk, C, eps, s));
  PMCE_TRY(launch_adaln(b(2), b(27), f(7), f(8), Mk, Nk, C, eps, s));
  PMCE_TRY(gemm(EPI_QKV, b(25), b(13), Mq, C, C, b(28), 0, f(14), s,
                nullptr, 0, nullptr, 1, C,
                1.0f / sqrtf(static_cast<float>(D))));
  PMCE_TRY(gemm(EPI_STORE, b(26), b(15), Mk, C, C, b(29), 0, f(16), s));
  PMCE_TRY(gemm(EPI_STORE, b(27), b(17), Mk, C, C, b(30), 0, f(18), s));
  const AttnIO io{b(28), b(29), b(30), C, C, C};
  PMCE_TRY(launch_attn_fwd(io, b(31), C, f(32), f(33), clips, Nq, Nk, H, D,
                           s));
  PMCE_TRY(gemm(EPI_RES, b(31), b(19), Mq, C, C, f(34), 1, f(20), s, b(0), 0,
                f(11), Nq, 0, 1.f, f(39)));
  // The MLP half (attention_ops.cuh's ada_mlp_fwd, with mo saved).
  PMCE_TRY(launch_adaln(f(34), b(35), f(9), f(10), Mq, Nq, C, eps, s));
  PMCE_TRY(gemm(EPI_GELU, b(35), b(21), Mq, hid, C, b(37), 0, f(22), s,
                nullptr, 0, nullptr, 1, 0, 1.f, f(36)));
  return gemm(EPI_RES, b(37), b(23), Mq, C, hid, b(38), 0, f(24), s, f(34),
              1, f(12), Nq, 0, 1.f, f(40));
}

namespace cab {

constexpr int CL = 4;          // CTAs of a clip's cluster
constexpr int NTH = 256;       // 8 warps
constexpr int NW = NTH / 32;
constexpr int CW = 64;         // C
constexpr int LD = CW + 8;     // bf16 row stride of the [rows, 64] tiles
constexpr int RT = 128;        // long-side rows of a CTA (a warp's 16 each)
constexpr int ST = 64;         // short-side rows
constexpr int MAX_HID = 256;
constexpr int MAXH = 8;        // heads (head width 8)
constexpr int NSTAMP = 8;      // loads, MLP^T, norm2, proj^T, dq, dk dv,
                               // q/k/v^T + norms, cluster sums

// Shared-memory plan, bytes. Region M holds W2 and W1 for the MLP's
// backward; after it (a block-wide barrier) the cluster partials (dk | dv
// f32 when the queries are split; dq f32 and the bf16 dk, dv tiles when the
// keys are) and dx1 f32. T2 holds the warps' dhh blocks, then the softmax
// statistics, then (rank 0, queries split) dv.
constexpr int TILE = RT * LD * 2;                     // [128, 72] bf16
constexpr int WSQ = CW * LD * 2;                      // [64, 72] bf16
constexpr int OFF_WP = 0, OFF_WQ = WSQ, OFF_WK = 2 * WSQ, OFF_WV = 3 * WSQ;
constexpr int OFF_M = 4 * WSQ;
constexpr int OFF_W1 = OFF_M + MAX_HID * LD * 2;      // W2: [hid, 72]
constexpr int M_BYTES = MAX_HID * LD * 2 + CW * (MAX_HID + 8) * 2;
constexpr int OFF_QS = OFF_M + M_BYTES;
constexpr int OFF_DO = OFF_QS + TILE;
constexpr int OFF_KS = OFF_DO + TILE;
constexpr int OFF_VS = OFF_KS + TILE;
constexpr int OFF_T1 = OFF_VS + TILE;
constexpr int OFF_T2 = OFF_T1 + TILE;
constexpr int OFF_VP = OFF_T2 + TILE;                 // [8 * 64 + 2] f32
constexpr int VP_LEN = 8 * CW + 2;
constexpr int OFF_WPT = OFF_VP + 2560;                // [8 warps][2][64]
constexpr int OFF_WPM = OFF_WPT + NW * 2 * CW * 4;    // [8 warps][2]
constexpr int SMEM = OFF_WPM + NW * 2 * 4;
// Region M after the MLP: queries split: DKV [64, 128] f32, dx1 [128, 64];
// keys split: DQP [64, 64] f32, DK, DV [128, 72] bf16, dx1 [64, 64] f32.
constexpr int M_DKV = 0, M_DX1_Q = ST * 2 * CW * 4;
constexpr int M_DQP = 0, M_DK = ST * CW * 4, M_DV = M_DK + TILE,
              M_DX1_K = M_DV + TILE;
static_assert(M_DX1_Q + RT * CW * 4 <= M_BYTES &&
                  M_DX1_K + ST * CW * 4 <= M_BYTES,
              "region M's second use over its first");
static_assert(3 * RT * MAXH * 4 <= TILE, "the statistics over T2");
static_assert(SMEM <= 232448, "over the opt-in shared memory");
// Per-clip vectors in VP: dgq, dbq, dgk, dbk, dgv, dbv, dg2, db2, dm1, dm2.
enum { V_Q = 0, V_K = 2, V_V = 4, V_2 = 6 };

struct Args {
  const bf16 *xq, *xk, *xv, *g;         // inputs [Mq | Mk, 64], dL/d out
  const float *gq, *gk, *gv, *g2;       // AdaLN gammas [clips, 64]
  const float *m1, *m2;                 // [clips] or null
  const bf16 *wq, *wk, *wv, *wproj, *w1, *w2;  // [in, out]
  const bf16 *q, *k, *v, *o;            // saved, q pre-scaled
  const float *sm, *sl;                 // [clips, H, Nq] softmax max, sum
  const float *x1, *hh;                 // [Mq, 64], [Mq, hid]
  const float *a, *mo;                  // [Mq, 64] or null
  bf16 *dxq, *dxk, *dxv;
  bf16 *m2g, *dhh, *da, *dq, *dk, *dv;  // the weight products' dY
  float* dgb;                           // [8, clips, 64]
  float *dm1, *dm2;                     // [clips] or null
  int* counters;                        // the weight launch's, zeroed here
  int ncounters, clips, Nq, Nk, hid;
  float eps, qscale;
  long long* stamps;                    // [clips * CL, NSTAMP] or null
};

template <bool ON>
struct StageClock {
  long long acc[NSTAMP];
  long long last;
  __device__ __forceinline__ void start() {
    if constexpr (ON) {
      for (int i = 0; i < NSTAMP; ++i) acc[i] = 0;
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
        for (int i = 0; i < NSTAMP; ++i) out[i] = acc[i];
    }
  }
};

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

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc[16, 64] += A[16, 64] @ W^T for W a [64 (n), 64 (k)] block at row
// stride ldw: W^T's B fragments read from W's own rows (no .trans).
// Accumulator layout: acc[j][e], n8 tile j, rows g (e < 2) and g + 8,
// columns j * 8 + 2 tq + (e & 1).
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

__device__ __forceinline__ void zero(float (&v)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
}

// acc[t] (keys or queries n0 + 8t ..) += A[16, D] . B[16, D]^T: A and B rows
// of a head's D columns at row strides lda, ldb.
template <int D>
__device__ __forceinline__ void dot_nt(float (&acc)[2][4], const bf16* A,
                                       int lda, const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (D == 8) {
    unsigned af[2], bf[2];
    ldsm_x2(af, A + (lane & 15) * lda);
    ldsm_x2(bf, B + (lane & 15) * ldb);
    mma_k8(acc[0], af, bf[0]);
    mma_k8(acc[1], af, bf[1]);
  } else {
#pragma unroll
    for (int s = 0; s < D; s += 16) {
      unsigned af[4], bf[4];
      ldsm_x4(af, A + (lane & 15) * lda + s + (lane >> 4) * 8);
      ldsm_x4(bf, B + ((lane & 7) + ((lane >> 4) << 3)) * ldb + s +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[0], af, bf[0], bf[1]);
      mma_bf16(acc[1], af, bf[2], bf[3]);
    }
  }
}

// acc[16, D] += P (the A fragments of a 16 x 16 block) @ B[16, D], B rows
// at row stride ldb ([k, n] order: ldmatrix .trans).
template <int D>
__device__ __forceinline__ void dot_pn(float (&acc)[D / 8][4],
                                       const unsigned (&pa)[4], const bf16* B,
                                       int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (D == 8) {
    unsigned bf[2];
    ldsm_x2_t(bf, B + (lane & 15) * ldb);
    mma_bf16(acc[0], pa, bf[0], bf[1]);
  } else {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned bf[4];
      ldsm_x4_t(bf, B + (lane & 15) * ldb + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
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
// vp[idx], vp[idx + 1]; the warps' scalar partials (wpm [warp][2]) into the
// mask gradients' slots when `masks`.
__device__ __forceinline__ void fold(float* vp, const float* wpt,
                                     const float* wpm, int idx, bool masks) {
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
    vp[8 * CW + i] += s;
  }
  __syncthreads();
}

// Values of an [rows, 64] matrix at the accumulator positions of a warp's
// 16 rows (zeros past `valid` rows): f32 or bf16 sources.
__device__ __forceinline__ void load_frag(float (&v)[8][4], const float* p,
                                          size_t row0, bool v0, bool v1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool ok = hf ? v1 : v0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 x = make_float2(0.f, 0.f);
      if (ok)
        x = *reinterpret_cast<const float2*>(
            p + (row0 + g + 8 * hf) * CW + j * 8 + 2 * tq);
      v[j][2 * hf] = x.x;
      v[j][2 * hf + 1] = x.y;
    }
  }
}
__device__ __forceinline__ void load_frag(float (&v)[8][4], const bf16* p,
                                          size_t row0, bool v0, bool v1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool ok = hf ? v1 : v0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 x = make_float2(0.f, 0.f);
      if (ok)
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            p + (row0 + g + 8 * hf) * CW + j * 8 + 2 * tq));
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
__device__ __forceinline__ void store_bf(const float (&v)[8][4], bf16* t,
                                         bf16* dst, size_t row0, bool v0,
                                         bool v1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * tq;
      const unsigned pk = pack_bf2(v[j][2 * hf], v[j][2 * hf + 1]);
      *reinterpret_cast<unsigned*>(t + (g + 8 * hf) * LD + c) = pk;
      if (dst && (hf ? v1 : v0))
        *reinterpret_cast<unsigned*>(dst + (row0 + g + 8 * hf) * CW + c) = pk;
    }
}

// One input's side of the attention's projections: dn = dX @ W^T from the
// warp's 16 bf16 rows of dX in `t`, the AdaLN backward against the input
// rows x (bf16) and gamma, plus the residual res (f32 rows at row stride
// 64, or null), into out's rows as bf16; the lane's dgamma / dbeta terms
// into the warp's column partials.
__device__ __forceinline__ void proj_norm_bwd(const bf16* t, const bf16* W,
                                              const bf16* x, const float* gam,
                                              float eps, const float* res,
                                              bf16* out, size_t row0, bool v0,
                                              bool v1, float* wdst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float dn[8][4], xv[8][4], gm[8][2], cg[8][2], cb[8][2];
  zero(dn);
  gemm16x64(dn, t, LD, W, LD);
  load_frag(xv, x, row0, v0, v1);
  load_gamma(gm, gam);
#pragma unroll
  for (int j = 0; j < 8; ++j) cg[j][0] = cg[j][1] = cb[j][0] = cb[j][1] = 0.f;
  adaln_bwd_frag(dn, xv, gm, eps, v0, v1, cg, cb);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!(hf ? v1 : v0)) continue;
    const int r = g + 8 * hf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * tq;
      float d0 = dn[j][2 * hf], d1 = dn[j][2 * hf + 1];
      if (res) {
        const float2 rv = *reinterpret_cast<const float2*>(res + r * CW + c);
        d0 += rv.x;
        d1 += rv.y;
      }
      *reinterpret_cast<unsigned*>(out + (row0 + r) * CW + c) =
          pack_bf2(d0, d1);
    }
  }
  warp_cols(cg, wdst);
  warp_cols(cb, wdst + CW);
}

// Rows [0, n) of an [*, 64] bf16 matrix from row r0 into a tile (row
// stride LD), zeros up to the next multiple of 16.
__device__ __forceinline__ void load_rows(bf16* t, const bf16* src, size_t r0,
                                          int n) {
  const int n16 = (n + 15) / 16 * 16;
  for (int c = threadIdx.x; c < n16 * 8; c += NTH) {
    const int r = c / 8, cc = c % 8 * 8;
    cp_async16(t + r * LD + cc, src + (r0 + (r < n ? r : 0)) * CW + cc,
               r < n);
  }
}

template <bool PROF, int D>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NTH, 1)
    ca_bwd_tile_kernel(const Args a) {
  constexpr int H = CW / D;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  bf16* Wp = reinterpret_cast<bf16*>(smem + OFF_WP);
  bf16* Wq = reinterpret_cast<bf16*>(smem + OFF_WQ);
  bf16* Wk = reinterpret_cast<bf16*>(smem + OFF_WK);
  bf16* Wv = reinterpret_cast<bf16*>(smem + OFF_WV);
  bf16* W2 = reinterpret_cast<bf16*>(smem + OFF_M);
  bf16* W1 = reinterpret_cast<bf16*>(smem + OFF_W1);
  bf16* Qs = reinterpret_cast<bf16*>(smem + OFF_QS);
  bf16* DOs = reinterpret_cast<bf16*>(smem + OFF_DO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + OFF_KS);
  bf16* Vs = reinterpret_cast<bf16*>(smem + OFF_VS);
  bf16* T1 = reinterpret_cast<bf16*>(smem + OFF_T1);
  bf16* T2 = reinterpret_cast<bf16*>(smem + OFF_T2);
  float* Ms = reinterpret_cast<float*>(smem + OFF_T2);
  float* Ls = Ms + RT * MAXH;
  float* Ds = Ls + RT * MAXH;
  float* vp = reinterpret_cast<float*>(smem + OFF_VP);
  float* wpt = reinterpret_cast<float*>(smem + OFF_WPT);
  float* wpm = reinterpret_cast<float*>(smem + OFF_WPM);
  StageClock<PROF> clk;
  clk.start();

  // The long side (the larger of Nq, Nk) in quarters of whole 16-row
  // blocks; the short side whole in every CTA.
  const bool split_q = a.Nq >= a.Nk;
  const int nlong = split_q ? a.Nq : a.Nk;
  const int per = ((nlong + CL - 1) / CL + 15) / 16 * 16;
  const int l0 = min(nlong, rank * per), l1 = min(nlong, l0 + per);
  const int q0 = split_q ? l0 : 0, nq = split_q ? l1 - l0 : a.Nq;
  const int k0 = split_q ? 0 : l0, nk = split_q ? a.Nk : l1 - l0;
  const int nq16 = (nq + 15) / 16 * 16, nk16 = (nk + 15) / 16 * 16;
  // Every CTA of a split-keys cluster computes the queries' side; rank 0
  // alone writes its operands and adds its per-clip sums.
  const bool own_q = split_q || rank == 0;
  const bool masks = a.dm1 != nullptr;
  const size_t qrow0 = (size_t)b * a.Nq + q0, krow0 = (size_t)b * a.Nk + k0;
  const int hid = a.hid;
  const int ldw1 = hid + 8;
  float* dx1s = reinterpret_cast<float*>(smem + OFF_M +
                                         (split_q ? M_DX1_Q : M_DX1_K));

  if (blockIdx.x == 0 && tid < a.ncounters) a.counters[tid] = 0;

  // ---- loads: the six weights, the CTA's q, k, v rows ------------------
  {
    const bf16* sq[4] = {a.wproj, a.wq, a.wk, a.wv};
    bf16* dq4[4] = {Wp, Wq, Wk, Wv};
    for (int c = tid; c < 4 * CW * 8; c += NTH) {
      const int m = c / (CW * 8), r = c % (CW * 8) / 8, cc = c % 8 * 8;
      cp_async16(dq4[m] + r * LD + cc, sq[m] + r * CW + cc, true);
    }
    for (int c = tid; c < hid * 8; c += NTH) {
      const int r = c / 8, cc = c % 8 * 8;
      cp_async16(W2 + r * LD + cc, a.w2 + (size_t)r * CW + cc, true);
    }
    for (int c = tid; c < CW * (hid / 8); c += NTH) {
      const int r = c / (hid / 8), cc = c % (hid / 8) * 8;
      cp_async16(W1 + r * ldw1 + cc, a.w1 + (size_t)r * hid + cc, true);
    }
    load_rows(Qs, a.q, qrow0, nq);
    load_rows(Ks, a.k, krow0, nk);
    load_rows(Vs, a.v, krow0, nk);
    for (int i = tid; i < VP_LEN; i += NTH) vp[i] = 0.f;
    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  clk(0);

  // ---- the queries' side, a warp per 16 rows: m2 * g, the MLP's backward
  // (dh2 in registers), then after a barrier the norm2 AdaLN backward, da,
  // dO = da @ Wproj^T, D = dO . O and the softmax statistics -------------
  const int qr = warp * 16;
  const bool wq_on = qr < nq;
  const bool v0 = qr + g < nq, v1 = qr + g + 8 < nq;
  const size_t wrow0 = qrow0 + qr;
  bf16* T1w = T1 + qr * LD;
  bf16* T2w = T2 + qr * LD;
  const float s2 = a.m2 ? a.m2[b] : 1.f, s1 = a.m1 ? a.m1[b] : 1.f;
  float dh2[8][4];
  zero(dh2);
  float dm_part[2] = {0.f, 0.f};
  if (wq_on) {
    for (int e = lane; e < 16 * 8; e += 32) {
      const int r = e / 8, c8 = e % 8 * 8;
      float gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) gv[i] = 0.f;
      if (qr + r < nq) load8(a.g + (wrow0 + r) * CW + c8, gv);
      unsigned pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pk[i] = pack_bf2(gv[2 * i] * s2, gv[2 * i + 1] * s2);
      const uint4 w4 = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      *reinterpret_cast<uint4*>(T1w + r * LD + c8) = w4;
      if (qr + r < nq && own_q) {
        *reinterpret_cast<uint4*>(a.m2g + (wrow0 + r) * CW + c8) = w4;
        if (a.mo) {
          const float* mp = a.mo + (wrow0 + r) * CW + c8;
#pragma unroll
          for (int i = 0; i < 8; ++i) dm_part[1] += gv[i] * mp[i];
        }
      }
    }
    __syncwarp();
    for (int blk = 0; blk < hid / CW; ++blk) {
      float acc[8][4];
      zero(acc);
      gemm16x64(acc, T1w, LD, W2 + blk * CW * LD, LD);
      // The block's hh values, all loaded before the dhh stores (which
      // may alias them as far as the compiler knows).
      float2 hv[2][8];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          hv[hf][j] = (hf ? v1 : v0)
                          ? *reinterpret_cast<const float2*>(
                                a.hh + (wrow0 + g + 8 * hf) * hid +
                                blk * CW + j * 8 + 2 * tq)
                          : make_float2(0.f, 0.f);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bool ok = hf ? v1 : v0;
        const int r = g + 8 * hf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = j * 8 + 2 * tq;
          const float2 h = hv[hf][j];
          const unsigned pk =
              pack_bf2(acc[j][2 * hf] * gelu_erf_grad(h.x),
                       acc[j][2 * hf + 1] * gelu_erf_grad(h.y));
          *reinterpret_cast<unsigned*>(T2w + r * LD + c) = pk;
          if (ok && own_q)
            *reinterpret_cast<unsigned*>(a.dhh + (wrow0 + r) * hid +
                                         blk * CW + c) = pk;
        }
      }
      __syncwarp();
      gemm16x64(dh2, T2w, LD, W1 + blk * CW, ldw1);
      __syncwarp();
    }
  }
  clk(1);
  __syncthreads();  // every warp is past W1, W2: region M is free
  {
    float cg2[8][2], cb2[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cg2[j][0] = cg2[j][1] = cb2[j][0] = cb2[j][1] = 0.f;
    if (wq_on) {
      float xv[8][4], gm[8][2], gy[8][4];
      load_frag(xv, a.x1, wrow0, v0, v1);
      load_gamma(gm, a.g2 + (size_t)b * CW);
      adaln_bwd_frag(dh2, xv, gm, a.eps, v0, v1, cg2, cb2);
      load_frag(gy, a.g, wrow0, v0, v1);
      float av[8][4];
      if (a.a && own_q) load_frag(av, a.a, wrow0, v0, v1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = dh2[j][2 * hf + e] + gy[j][2 * hf + e];  // dx1
            dx1s[(qr + g + 8 * hf) * CW + j * 8 + 2 * tq + e] = d;
            if (a.a && own_q) dm_part[0] += d * av[j][2 * hf + e];
            dh2[j][2 * hf + e] = d * s1;  // da
          }
      store_bf(dh2, T1w, own_q ? a.da : nullptr, wrow0, v0, v1);
    }
    if (!own_q) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cg2[j][0] = cg2[j][1] = cb2[j][0] = cb2[j][1] = 0.f;
    }
    warp_cols(cg2, wpt + warp * 2 * CW);
    warp_cols(cb2, wpt + warp * 2 * CW + CW);
    const float dm1w = warp_sum(dm_part[0]), dm2w = warp_sum(dm_part[1]);
    if (lane == 0) {
      wpm[warp * 2] = dm1w;
      wpm[warp * 2 + 1] = dm2w;
    }
    fold(vp, wpt, wpm, V_2, masks);
  }
  clk(2);
  if (wq_on) {
    __syncwarp();
    float acc[8][4];
    zero(acc);
    gemm16x64(acc, T1w, LD, Wp, LD);
    float ov[8][4];
    load_frag(ov, a.o, wrow0, v0, v1);
    float dpart[2][MAXH];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < MAXH; ++h) dpart[hf][h] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned pk = pack_bf2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        *reinterpret_cast<unsigned*>(DOs + (qr + g + 8 * hf) * LD + j * 8 +
                                     2 * tq) = pk;
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pk));
        dpart[hf][j * 8 / D] +=
            d2.x * ov[j][2 * hf] + d2.y * ov[j][2 * hf + 1];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float dsum = quad_sum(dpart[hf][h]);
        if (tq == 0) Ds[(qr + g + 8 * hf) * MAXH + h] = dsum;
      }
    for (int e = lane; e < 16 * H; e += 32) {
      const int r = e / H, h = e % H;
      const bool ok = qr + r < nq;
      const size_t si = ((size_t)b * H + h) * a.Nq + q0 + qr + r;
      Ms[(qr + r) * MAXH + h] = ok ? a.sm[si] : 0.f;
      Ls[(qr + r) * MAXH + h] = ok ? 1.0f / a.sl[si] : 0.f;
    }
  }
  // (DOs rows past the queries, up to the next 16, are the last warp's
  // zero rows: its da rows there are zeros.)
  __syncthreads();
  clk(3);

  // ---- attention, dq: items (query tile, head) over the CTA's keys ------
  float* dkv = reinterpret_cast<float*>(smem + OFF_M + M_DKV);  // split_q
  float* dqp = reinterpret_cast<float*>(smem + OFF_M + M_DQP);  // split_k
  bf16* DKt = reinterpret_cast<bf16*>(smem + OFF_M + M_DK);     // split_k
  bf16* DVt = reinterpret_cast<bf16*>(smem + OFF_M + M_DV);     // split_k
  for (int it = warp; it < nq16 / 16 * H; it += NW) {
    const int qb = it / H * 16, h = it % H;
    const int r0 = qb + g, r1 = r0 + 8;
    const bool ok0 = r0 < nq, ok1 = r1 < nq;
    const float m[2] = {Ms[r0 * MAXH + h], Ms[r1 * MAXH + h]};
    const float li[2] = {Ls[r0 * MAXH + h], Ls[r1 * MAXH + h]};
    const float Dq[2] = {Ds[r0 * MAXH + h], Ds[r1 * MAXH + h]};
    float dq[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
    for (int kb = 0; kb < nk16; kb += 16) {
      float sc[2][4] = {}, dp[2][4] = {}, ds[2][4];
      dot_nt<D>(sc, Qs + qb * LD + h * D, LD, Ks + kb * LD + h * D, LD);
      dot_nt<D>(dp, DOs + qb * LD + h * D, LD, Vs + kb * LD + h * D, LD);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + t * 8 + 2 * tq + (e & 1), hf = e >> 1;
          const bool in = key < nk && (hf ? ok1 : ok0);
          const float p = in ? expf(sc[t][e] - m[hf]) * li[hf] : 0.f;
          ds[t][e] = p * (dp[t][e] - Dq[hf]);
        }
      unsigned pa[4];
      pack_a(pa, ds);
      dot_pn<D>(dq, pa, Ks + kb * LD + h * D, LD);
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = hf ? r1 : r0, c = h * D + d * 8 + 2 * tq;
        if (split_q) {
          // Every key is here: dq is whole; bf16 (x qscale) into T1.
          const unsigned pk = pack_bf2(dq[d][2 * hf] * a.qscale,
                                       dq[d][2 * hf + 1] * a.qscale);
          *reinterpret_cast<unsigned*>(T1 + r * LD + c) = pk;
          if (r < nq)
            *reinterpret_cast<unsigned*>(a.dq + (qrow0 + r) * CW + c) = pk;
        } else {
          *reinterpret_cast<float2*>(dqp + r * CW + c) =
              make_float2(dq[d][2 * hf], dq[d][2 * hf + 1]);
        }
      }
  }
  clk(4);

  // ---- attention, dk and dv: items (key tile, head) over the CTA's
  // queries ---------------------------------------------------------------
  for (int it = warp; it < nk16 / 16 * H; it += NW) {
    const int kb = it / H * 16, h = it % H;
    const bool kok0 = kb + g < nk, kok1 = kb + g + 8 < nk;
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
    for (int qb = 0; qb < nq16; qb += 16) {
      float st[2][4] = {}, dpt[2][4] = {}, pt[2][4], dst[2][4];
      dot_nt<D>(st, Ks + kb * LD + h * D, LD, Qs + qb * LD + h * D, LD);
      dot_nt<D>(dpt, Vs + kb * LD + h * D, LD, DOs + qb * LD + h * D, LD);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = qb + t * 8 + 2 * tq + (e & 1);
          const bool in = q < nq && ((e >> 1) ? kok1 : kok0);
          const float p = in ? expf(st[t][e] - Ms[q * MAXH + h]) *
                                   Ls[q * MAXH + h]
                             : 0.f;
          pt[t][e] = p;
          dst[t][e] = p * (dpt[t][e] - Ds[q * MAXH + h]);
        }
      unsigned pa[4], pb[4];
      pack_a(pa, pt);
      pack_a(pb, dst);
      dot_pn<D>(dv, pa, DOs + qb * LD + h * D, LD);
      dot_pn<D>(dk, pb, Qs + qb * LD + h * D, LD);
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = kb + g + 8 * hf, c = h * D + d * 8 + 2 * tq;
        if (split_q) {
          // A partial over this CTA's queries, for the cluster's sum.
          *reinterpret_cast<float2*>(dkv + r * 2 * CW + c) =
              make_float2(dk[d][2 * hf], dk[d][2 * hf + 1]);
          *reinterpret_cast<float2*>(dkv + r * 2 * CW + CW + c) =
              make_float2(dv[d][2 * hf], dv[d][2 * hf + 1]);
        } else {
          const unsigned kp = pack_bf2(dk[d][2 * hf], dk[d][2 * hf + 1]);
          const unsigned vq = pack_bf2(dv[d][2 * hf], dv[d][2 * hf + 1]);
          *reinterpret_cast<unsigned*>(DKt + r * LD + c) = kp;
          *reinterpret_cast<unsigned*>(DVt + r * LD + c) = vq;
          if (r < nk) {
            *reinterpret_cast<unsigned*>(a.dk + (krow0 + r) * CW + c) = kp;
            *reinterpret_cast<unsigned*>(a.dv + (krow0 + r) * CW + c) = vq;
          }
        }
      }
  }
  __syncthreads();
  clk(5);

  // ---- the projections' backward and AdaLNs of the rows whole here ------
  if (split_q) {
    // The queries: dq (T1) @ Wq^T, normq's backward + dx1.
    if (wq_on)
      proj_norm_bwd(T1w, Wq, a.xq, a.gq + (size_t)b * CW, a.eps,
                    dx1s + qr * CW, a.dxq, wrow0, v0, v1,
                    wpt + warp * 2 * CW);
    else
      for (int i = lane; i < 2 * CW; i += 32) wpt[warp * 2 * CW + i] = 0.f;
    fold(vp, wpt, wpm, V_Q, false);
  } else {
    // The keys: dk @ Wk^T, normk's backward; dv @ Wv^T, normv's.
    const int kr = warp * 16;
    const bool kon = kr < nk;
    const bool k0v = kr + g < nk, k1v = kr + g + 8 < nk;
    for (int t = 0; t < 2; ++t) {
      if (kon)
        proj_norm_bwd((t ? DVt : DKt) + kr * LD, t ? Wv : Wk, t ? a.xv : a.xk,
                      (t ? a.gv : a.gk) + (size_t)b * CW, a.eps, nullptr,
                      t ? a.dxv : a.dxk, krow0 + kr, k0v, k1v,
                      wpt + warp * 2 * CW);
      else
        for (int i = lane; i < 2 * CW; i += 32) wpt[warp * 2 * CW + i] = 0.f;
      fold(vp, wpt, wpm, t ? V_V : V_K, false);
    }
  }
  clk(6);

  // ---- the cluster's sums, by rank 0 in rank order ----------------------
  cluster.sync();
  if (rank == 0) {
    if (split_q) {
      // dk | dv of the keys (the short side) over the four CTAs' queries:
      // bf16 into T1 | T2 and the operands; then the keys' projections.
      const int n16 = (a.Nk + 15) / 16 * 16;
      const float* rem[CL];
      for (int r = 0; r < CL; ++r) rem[r] = cluster.map_shared_rank(dkv, r);
      for (int e = tid; e < n16 * 2 * CW; e += NTH) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < CL; ++r) s += rem[r][e];
        const int row = e / (2 * CW), c = e % (2 * CW);
        const bf16 v = f2bf(s);
        (c < CW ? T1 : T2)[row * LD + c % CW] = v;
        if (row < a.Nk)
          (c < CW ? a.dk : a.dv)[((size_t)b * a.Nk + row) * CW + c % CW] = v;
      }
      __syncthreads();
      const int kr = warp * 16;
      const bool kon = kr < a.Nk;
      const bool k0v = kr + g < a.Nk, k1v = kr + g + 8 < a.Nk;
      const size_t kb0 = (size_t)b * a.Nk + kr;
      for (int t = 0; t < 2; ++t) {
        if (kon)
          proj_norm_bwd((t ? T2 : T1) + kr * LD, t ? Wv : Wk,
                        t ? a.xv : a.xk, (t ? a.gv : a.gk) + (size_t)b * CW,
                        a.eps, nullptr, t ? a.dxv : a.dxk, kb0, k0v, k1v,
                        wpt + warp * 2 * CW);
        else
          for (int i = lane; i < 2 * CW; i += 32)
            wpt[warp * 2 * CW + i] = 0.f;
        fold(vp, wpt, wpm, t ? V_V : V_K, false);
      }
    } else {
      // dq of the queries (the short side) over the four CTAs' keys: x
      // qscale, bf16 into T1 and the operand; then the queries' projection
      // with dx1.
      const float* rem[CL];
      for (int r = 0; r < CL; ++r) rem[r] = cluster.map_shared_rank(dqp, r);
      for (int e = tid; e < nq16 * CW; e += NTH) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < CL; ++r) s += rem[r][e];
        const int row = e / CW, c = e % CW;
        const bf16 v = f2bf(s * a.qscale);
        T1[row * LD + c] = v;
        if (row < nq) a.dq[(qrow0 + row) * CW + c] = v;
      }
      __syncthreads();
      if (wq_on)
        proj_norm_bwd(T1w, Wq, a.xq, a.gq + (size_t)b * CW, a.eps,
                      dx1s + qr * CW, a.dxq, wrow0, v0, v1,
                      wpt + warp * 2 * CW);
      else
        for (int i = lane; i < 2 * CW; i += 32) wpt[warp * 2 * CW + i] = 0.f;
      fold(vp, wpt, wpm, V_Q, false);
    }
    // The per-clip vectors over the cluster, in rank order.
    const size_t bc = (size_t)a.clips * CW;
    const float* rvp[CL];
    for (int r = 0; r < CL; ++r) rvp[r] = cluster.map_shared_rank(vp, r);
    for (int e = tid; e < VP_LEN; e += NTH) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) s += rvp[r][e];
      if (e < 8 * CW)
        a.dgb[(e / CW) * bc + (size_t)b * CW + e % CW] = s;
      else if (masks)
        (e == 8 * CW ? a.dm1 : a.dm2)[b] = s;
    }
  }
  cluster.sync();  // the other CTAs' shared memory stays until rank 0 is done
  clk(7);
  clk.write(a.stamps + (size_t)blockIdx.x * NSTAMP);
}

constexpr int WG = 64;  // the weight launch's output tiles, WG x WG

// Tiles of the six products for hid.
__host__ __device__ constexpr int wgrad_tiles(int hid) {
  return 4 + 2 * (hid / WG);
}

}  // namespace cab

// The backward's tile program, a cluster of 4 CTAs a clip. ptrs: xq, xk,
// xv, g (dL/d out), gq, gk, gv, g2 (gammas [clips, 64]), m1, m2, wq, wk,
// wv, wproj, w1, w2 (bf16 [in, out]), the saved q, k, v, o, stat_m, stat_l,
// x1, hh, a, mo (a, mo null without mask gradients); dxq, dxk, dxv; the
// operands m2g, dhh, da, dq, dk, dv; dgb [8, clips, 64] (dgq, dbq, dgk,
// dbk, dgv, dbv, dg2, db2); dm1, dm2 (null without mask gradients); the
// weight launch's counters (zeroed here); stamps (null, or [clips * 4, 8]
// int64 for the stamped instantiation).
extern "C" int pmce_ca_bwd_tile(void* const* ptrs, int clips, int Nq, int Nk,
                                int hid, int H, float eps, void* stream) {
  using namespace cab;
  if (clips <= 0 || Nq <= 0 || Nk <= 0 || std::min(Nq, Nk) > ST ||
      std::max(Nq, Nk) > CL * RT || hid <= 0 || hid % CW || hid > MAX_HID ||
      (H != 2 && H != 4 && H != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  auto cb = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto b = [&](int i) { return static_cast<bf16*>(ptrs[i]); };
  a.xq = cb(0); a.xk = cb(1); a.xv = cb(2); a.g = cb(3);
  a.gq = cf(4); a.gk = cf(5); a.gv = cf(6); a.g2 = cf(7);
  a.m1 = cf(8); a.m2 = cf(9);
  a.wq = cb(10); a.wk = cb(11); a.wv = cb(12); a.wproj = cb(13);
  a.w1 = cb(14); a.w2 = cb(15);
  a.q = cb(16); a.k = cb(17); a.v = cb(18); a.o = cb(19);
  a.sm = cf(20); a.sl = cf(21); a.x1 = cf(22); a.hh = cf(23);
  a.a = cf(24); a.mo = cf(25);
  a.dxq = b(26); a.dxk = b(27); a.dxv = b(28);
  a.m2g = b(29); a.dhh = b(30); a.da = b(31); a.dq = b(32); a.dk = b(33);
  a.dv = b(34);
  a.dgb = static_cast<float*>(ptrs[35]);
  a.dm1 = static_cast<float*>(ptrs[36]);
  a.dm2 = static_cast<float*>(ptrs[37]);
  a.counters = static_cast<int*>(ptrs[38]);
  a.stamps = static_cast<long long*>(ptrs[39]);
  a.ncounters = wgrad_tiles(hid);
  a.clips = clips; a.Nq = Nq; a.Nk = Nk; a.hid = hid;
  a.eps = eps;
  a.qscale = 1.0f / sqrtf(static_cast<float>(CW / H));
  if ((a.dm1 == nullptr) != (a.dm2 == nullptr) ||
      (a.dm1 && (a.a == nullptr || a.mo == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMCE_CA_TILE(PROF, D)                                               \
  {                                                                         \
    const auto kernel = ca_bwd_tile_kernel<PROF, D>;                        \
    cudaError_t e = cudaFuncSetAttribute(                                   \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);         \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    kernel<<<clips * CL, NTH, SMEM, s>>>(a);                                \
    return static_cast<int>(cudaGetLastError());                            \
  }
  const int D = CW / H;
  if (a.stamps) {
    if (D == 8) PMCE_CA_TILE(true, 8)
    if (D == 16) PMCE_CA_TILE(true, 16)
    PMCE_CA_TILE(true, 32)
  }
  if (D == 8) PMCE_CA_TILE(false, 8)
  if (D == 16) PMCE_CA_TILE(false, 16)
  PMCE_CA_TILE(false, 32)
#undef PMCE_CA_TILE
}

// The six weight gradients and six bias gradients in one launch, after
// the tile program. ptrs: nq, nk, nv, o, h2, ge (the products' X), dq, dk,
// dv, da, dhh, m2g (their dY), partial ([tiles * splits, 64 * 64] f32),
// vpartial ([tiles * splits, 64] f32), counters ([tiles] int32, zeroed by
// the tile program), out (the 12 parameters' gradients concatenated in
// their order: wq, bq, wk, bk, wv, bv, wproj, bproj, w1, bb1, w2, bb2).
extern "C" int pmce_ca_wgrad(void* const* ptrs, int clips, int Nq, int Nk,
                             int hid, int splits, void* stream) {
  using namespace cab;
  if (clips <= 0 || Nq <= 0 || Nk <= 0 || hid <= 0 || hid % WG ||
      splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wg::Args<6> a;
  const int C = CW, Mq = clips * Nq, Mk = clips * Nk;
  for (int p = 0; p < 6; ++p) {
    a.X[p] = static_cast<const bf16*>(ptrs[p]);
    a.G[p] = static_cast<const bf16*>(ptrs[6 + p]);
  }
  a.partial = static_cast<float*>(ptrs[12]);
  a.vpartial = static_cast<float*>(ptrs[13]);
  a.counters = static_cast<int*>(ptrs[14]);
  a.mat = static_cast<float*>(ptrs[15]);
  a.vpart = nullptr;
  a.vtiles = a.L = 0;
  a.vec = nullptr;
  return wg::launch_wgrad<WG>(a, {Mq, Mk, Mk, Mq, Mq, Mq},
                              {C, C, C, C, C, hid}, {C, C, C, C, hid, C},
                              splits, 0, static_cast<cudaStream_t>(stream));
}

PMCE_EXPORT_ERROR_STRING(pmce_ca_block_error_string)
