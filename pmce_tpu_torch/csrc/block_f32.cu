// Pre-norm transformer block in f32 for Hopper (sm_90a): the forward with
// or without branch masks (row 6f) and the whole block's backward (row 7f).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_block_kernel` (entry
// `fused_transformer_block`) and `_block_bwd_kernel` (via
// `_fused_block_bwd`, the block's custom VJP) on their f32 branches, where
// JAX's compute dtype is f32 (`PoseEst` / `PMCE(dtype=None,
// fused_attn=True)`): one lifter block,
//
//   x1 = x + m1 MHSA(LN1(x));  y = x1 + m2 MLP(LN2(x1));  [PostLN(y)]
//
// with LayerNorm eps 1e-6 and f32 statistics, heads of 32 with a
// max-stabilised f32 softmax over each clip's N <= 64 tokens, q scaled by
// 1/sqrt(32) before the scores, an erf-GELU MLP, the lifter's shared
// post-norm, and m1 / m2 the per-clip stochastic-depth scales (null: 1).
//
// Products in true f32: FFMA on the CUDA cores. A single TF32 pass keeps 10
// mantissa bits and errs ~1e-3 relative, which breaks the f32 model's 1e-4
// parity; 3xTF32 (hi/lo split on mma.sync m16n8k8) would be faster but
// drops the lo*lo term and adds the split's bookkeeping to every fragment.
// FFMA rounds each product-sum exactly as an f32 GEMM does, so the kernels
// differ from the plain version only in the order of their sums; a first
// kernel is right before it is fast.
//
// What bounds them on this card: products. A row of C = 256 costs qkv 256 x
// 768, proj 256 x 256, fc1 256 x hid and fc2 hid x 256 multiply-adds,
// 1,048,576 flops at hid 512 forward and twice that backward (the
// activation and the weight gradients); Stage 1's 17,408 rows a call make
// 18.3 GFLOP forward (0.27 ms at the 67 TFLOP/s f32 CUDA-core peak) and
// 36.5 GFLOP backward (0.55 ms), 0.82 ms with the forward recomputed.
//
// Forward (pmce_block_fwd_f32): one thread block of 512 threads (16 warps)
// per tile of whole clips, up to TR = 64 rows (3 clips of 17 or 19, 4 of
// 16). Shared memory holds three f32 [64, 256] buffers (192 KB): A, B and
// O. LN1 writes A; per pair of heads the q / k / v columns of each head
// (64 x 96, from A) go to B's space with k transposed ([32, 65], so that a
// lane's key reads fall on distinct banks), and a warp a (row, head)
// computes the scores of its clip's keys (a lane a key), the softmax by
// shuffles and o (a lane a channel), into O. proj writes x1 = x + m1 (O
// Wproj + b) into B (x re-read from device memory); LN2 writes A; the MLP
// runs in hidden chunks of 128: fc1 + GELU into O, then fc2 into registers
// that persist over the chunks; y = x1 + m2 (fc2 + b) into A, then the
// post-norm a warp a row. Every product splits the 16 warps into 8 row
// groups of TM = 8 rows and 2 column halves: a warp's task is its 8 rows
// x 32 TN columns of its half (a lane a column every 32; for qkv the two
// halves are two heads, so a head pair a pass). The rows' A values are
// broadcast float4 reads from shared memory, the weight row a coalesced
// read through L1 / L2 (the block's 4 MB of f32 weights stay in L2), and
// each weight value loaded feeds 8 FMAs. The forward saves nothing for
// the gradient: the backward recomputes it from x.
//
// Backward (pmce_block_bwd_f32), as JAX's `_block_bwd_kernel` does it:
// recompute the forward from x, then run the gradient chain, over the same
// tiles. Saving the forward's state instead would cost ~18 KB a row (320
// MB a Stage-1 call, for each of the 6 blocks until its backward);
// recomputing keeps the forward one program and costs one forward's
// products. Three launches:
// 1. the four weights transposed into a workspace (the gradient chain's
//    products read W^T rows as the forward reads W rows);
// 2. the tile program: the forward above (writing h1, the scaled q and k,
//    v, o, h2, hh and gelu(hh) to a workspace, and the branches a and mo
//    when the mask gradients are owed), then post-norm^T (A: gy), the
//    mask gradients' row sums, MLP^T in hidden chunks (dhh into O's space,
//    dh2 in registers), LN2^T (A: dx1), proj^T (O: dO), attention^T a head
//    at a time in A and B's space (q, k^T, v, P, dS, dq, dk, dv; dh1 in
//    registers over the heads), LN1^T (dx). It writes the weight products'
//    operands (dqkv, da, dhh and m2 gy) and each tile's partial sums of
//    the vector gradients (LayerNorm scales and shifts, biases);
// 3. the weight gradients dW = A^T dY and the tiles' vector partials
//    summed in a fixed order (csrc/f32_ops.cuh).
// No atomics: a rerun gives the same bits.

#include "common.cuh"
#include "f32_ops.cuh"

namespace bf32 {

constexpr int NT = 512;   // threads per block (16 warps)
constexpr int NW = NT / 32;
constexpr int TR = 64;    // tile rows (whole clips)
constexpr int CW = 256;   // channel width C
constexpr int DH = 32;    // head width
constexpr int NH = CW / DH;
constexpr int HC = 128;   // hidden chunk of the MLP
constexpr int TM = 8;     // rows of a warp task (TR = NW / 2 * TM)
constexpr int KT_LD = TR + 1;  // row stride of the transposed keys
constexpr int V_LD = DH + 1;   // row stride of the backward's values
constexpr int QKV_F = 2 * TR * DH + DH * KT_LD;  // one head's q, k^T, v
constexpr int BUF = TR * CW;   // one [64, 256] buffer
// The backward's per-row values in shared memory: LN1's and LN2's means
// and inverse deviations, the post-norm's, the two branch scales and the
// two mask gradients' row sums.
constexpr int ROWV = 10 * TR;
constexpr int FWD_SMEM = (3 * BUF + 2 * TR) * 4;
constexpr int BWD_SMEM = (3 * BUF + ROWV) * 4;

struct Args {
  const float *x, *wqkv, *wproj, *w1, *w2;
  const float *g1, *b1, *bqkv, *bproj, *g2, *b2, *bb1, *bb2, *gp, *bp;
  const float *m1, *m2;  // per-clip branch scales, or null (1)
  float* out;
  int clips, N, hid;
  float eps, post_eps, qscale;
};

// What the backward's recompute of the forward writes (rows of the tile's
// first row g0; null: not written), and its per-row statistics in shared
// memory.
struct Save {
  float *h1, *qkv, *o, *h2, *hh, *ge, *a, *mo;
  float *mean1, *inv1, *mean2, *inv2;
};

struct Bwd {
  const float* gout;
  const float *wqkvT, *wprojT, *w1T, *w2T;
  float *dqkv, *da, *dhh, *m2g;
  float *dx, *part, *dm1, *dm2;
};

// acc[i][j] += sum_k A[i, k] W[k, cbase + lane + j * cstride] over the
// warp's TM rows (A: the first row, row stride lda; A in shared memory)
// and K columns in order.
template <int TN>
__device__ __forceinline__ void tile_mac(const float* A, int lda, int K,
                                         const float* __restrict__ W, int ldw,
                                         int cbase, int cstride,
                                         float (&acc)[TM][TN]) {
  const float* wl = W + cbase + (threadIdx.x & 31);
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float w[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        w[j] = __ldg(wl + (size_t)(k + kk) * ldw + j * cstride);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
      }
    }
  }
}

// A row of C = 256 as a lane holds it: the 8 channels 4 lane + {0..3}
// and 128 + 4 lane + {0..3}.
__device__ __forceinline__ void load_row(const float* row, float4& u,
                                         float4& v) {
  const int lane = threadIdx.x & 31;
  u = *reinterpret_cast<const float4*>(row + 4 * lane);
  v = *reinterpret_cast<const float4*>(row + 128 + 4 * lane);
}

__device__ __forceinline__ float sum8(const float4& u, const float4& v) {
  return ((u.x + u.y) + (u.z + u.w)) + ((v.x + v.y) + (v.z + v.w));
}

// The row's f32 mean and 1 / sqrt(centred variance + eps), a warp a row.
__device__ __forceinline__ void row_moments(float4 u, float4 v, float eps,
                                            float& mean, float& inv) {
  mean = warp_sum(sum8(u, v)) * (1.0f / CW);
  u.x -= mean; u.y -= mean; u.z -= mean; u.w -= mean;
  v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
  const float q = warp_sum(((u.x * u.x + u.y * u.y) + (u.z * u.z + u.w * u.w)) +
                           ((v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w)));
  inv = 1.0f / sqrtf(q * (1.0f / CW) + eps);
}

// LayerNorm of n rows of C = 256, a warp a row: (x - mean) * inv * g + b.
// Rows at and past `valid` are written as zeros (the tile's padding rows).
// With `copy`, rows below `valid` are also written there (row stride CW);
// with `mean` / `inv`, each row's statistics.
__device__ void ln_rows(const float* in, int ldin, float* out, int ldout,
                        int n, int valid, const float* g, const float* b,
                        float eps, float* copy = nullptr,
                        float* mean_out = nullptr, float* inv_out = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = 4 * lane, c1 = 128 + 4 * lane;
  const float4 ga = *reinterpret_cast<const float4*>(g + c0);
  const float4 gb = *reinterpret_cast<const float4*>(g + c1);
  const float4 ba = *reinterpret_cast<const float4*>(b + c0);
  const float4 bb = *reinterpret_cast<const float4*>(b + c1);
  for (int r = warp; r < n; r += NW) {
    float4* o0 = reinterpret_cast<float4*>(out + (size_t)r * ldout + c0);
    float4* o1 = reinterpret_cast<float4*>(out + (size_t)r * ldout + c1);
    if (r >= valid) {
      *o0 = make_float4(0.f, 0.f, 0.f, 0.f);
      *o1 = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    float4 u, v;
    load_row(in + (size_t)r * ldin, u, v);
    float mean, inv;
    row_moments(u, v, eps, mean, inv);
    if (mean_out != nullptr && lane == 0) {
      mean_out[r] = mean;
      inv_out[r] = inv;
    }
    u.x -= mean; u.y -= mean; u.z -= mean; u.w -= mean;
    v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
    const float4 y0 = make_float4(u.x * inv * ga.x + ba.x, u.y * inv * ga.y + ba.y,
                                  u.z * inv * ga.z + ba.z, u.w * inv * ga.w + ba.w);
    const float4 y1 = make_float4(v.x * inv * gb.x + bb.x, v.y * inv * gb.y + bb.y,
                                  v.z * inv * gb.z + bb.z, v.w * inv * gb.w + bb.w);
    *o0 = y0;
    *o1 = y1;
    if (copy != nullptr) {
      *reinterpret_cast<float4*>(copy + (size_t)r * CW + c0) = y0;
      *reinterpret_cast<float4*>(copy + (size_t)r * CW + c1) = y1;
    }
  }
}

// The tile's rows: clip0 its first clip, rows its valid rows (whole clips).
struct TileRows {
  int clip0, rows;
  size_t g0;  // the first row's index
};

__device__ __forceinline__ TileRows tile_rows(int clips, int N) {
  const int cpt = TR / N;
  TileRows t;
  t.clip0 = blockIdx.x * cpt;
  t.rows = min(cpt, clips - t.clip0) * N;
  t.g0 = (size_t)t.clip0 * N;
  return t;
}

// The block's forward over one tile, with A, B, O the three [64, 256]
// buffers and sm1 / sm2 the rows' branch scales (shared memory). On
// return A holds y = x1 + m2 mo (before the post-norm) and B holds x1;
// with s, O holds mo and s's rows and statistics are written.
__device__ void forward_tile(const Args& p, const TileRows& t, float* A,
                             float* B, float* O, const float* sm1,
                             const float* sm2, const Save* s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = p.N, rows = t.rows;
  const float* x = p.x + t.g0 * CW;
  // The warp's rows and column half in every product.
  const int r0 = (warp >> 1) * TM, half = warp & 1;

  // LN1: A = LN(x).
  ln_rows(x, CW, A, CW, TR, rows, p.g1, p.b1, p.eps,
          s ? s->h1 + t.g0 * CW : nullptr, s ? s->mean1 : nullptr,
          s ? s->inv1 : nullptr);
  __syncthreads();

  // Attention, a pair of heads at a time: head 2 hp + u's q [64, 32],
  // k^T [32, 65] and v [64, 32] in B's space at u * QKV_F.
  for (int hp = 0; hp < NH / 2; ++hp) {
    {
      const int h = 2 * hp + half;
      float* Q = B + half * QKV_F;
      float* KT = Q + TR * DH;
      float* Vh = KT + DH * KT_LD;
      float acc[TM][3] = {};
      tile_mac<3>(A + r0 * CW, CW, CW, p.wqkv, 3 * CW, h * DH, CW, acc);
      const float bq = p.bqkv[h * DH + lane];
      const float bk = p.bqkv[CW + h * DH + lane];
      const float bv = p.bqkv[2 * CW + h * DH + lane];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = r0 + i;
        const float q = (acc[i][0] + bq) * p.qscale;
        const float k = acc[i][1] + bk, v = acc[i][2] + bv;
        Q[r * DH + lane] = q;
        KT[lane * KT_LD + r] = k;
        Vh[r * DH + lane] = v;
        if (s != nullptr && r < rows) {
          float* row = s->qkv + (t.g0 + r) * (3 * CW) + h * DH + lane;
          row[0] = q;
          row[CW] = k;
          row[2 * CW] = v;
        }
      }
    }
    __syncthreads();
    for (int w = warp; w < 2 * TR; w += NW) {
      const int u = w / TR, r = w % TR, h = 2 * hp + u;
      const float* Q = B + u * QKV_F;
      const float* KT = Q + TR * DH;
      const float* Vh = KT + DH * KT_LD;
      if (r >= rows) {
        O[r * CW + h * DH + lane] = 0.f;
        continue;
      }
      const int kb = r / N * N;
      const bool has0 = lane < N, has1 = lane + 32 < N;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float qd = Q[r * DH + d];
        s0 = fmaf(qd, KT[d * KT_LD + kb + min(lane, N - 1)], s0);
        s1 = fmaf(qd, KT[d * KT_LD + kb + min(lane + 32, N - 1)], s1);
      }
      float m = fmaxf(has0 ? s0 : -INFINITY, has1 ? s1 : -INFINITY);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float p0 = has0 ? expf(s0 - m) : 0.f;
      const float p1 = has1 ? expf(s1 - m) : 0.f;
      const float l = warp_sum(p0 + p1);
      float o = 0.f;
      for (int j = 0; j < N; ++j) {
        const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
        o = fmaf(pj, Vh[(kb + j) * DH + lane], o);
      }
      O[r * CW + h * DH + lane] = o / l;
      if (s != nullptr) s->o[(t.g0 + r) * CW + h * DH + lane] = o / l;
    }
    __syncthreads();
  }

  // proj: B = x1 = x + m1 (O Wproj + bproj).
  const int cw = half * (CW / 2);  // the warp's output columns
  {
    float acc[TM][4] = {};
    tile_mac<4>(O + r0 * CW, CW, CW, p.wproj, CW, cw, 32, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cw + lane + 32 * j;
        const float res = r < rows ? __ldg(x + (size_t)r * CW + c) : 0.f;
        const float a = acc[i][j] + p.bproj[c];
        B[r * CW + c] = res + sm1[r] * a;
        if (s != nullptr && s->a != nullptr && r < rows)
          s->a[(t.g0 + r) * CW + c] = a;
      }
    }
  }
  __syncthreads();
  // LN2: A = LN(x1).
  ln_rows(B, CW, A, CW, TR, rows, p.g2, p.b2, p.eps,
          s ? s->h2 + t.g0 * CW : nullptr, s ? s->mean2 : nullptr,
          s ? s->inv2 : nullptr);
  __syncthreads();

  // MLP in hidden chunks of HC: fc1 + GELU into O ([64, HC]), fc2 summed in
  // registers over the chunks.
  float acc2[TM][4] = {};
  for (int ch = 0; ch < p.hid; ch += HC) {
    {
      const int ch2 = half * (HC / 2);
      float acc[TM][HC / 64] = {};
      tile_mac<HC / 64>(A + r0 * CW, CW, CW, p.w1, p.hid, ch + ch2, 32, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < HC / 64; ++j) {
          const int r = r0 + i, c = ch2 + lane + 32 * j;
          const float hh = acc[i][j] + p.bb1[ch + c];
          const float ge = gelu_erf(hh);
          O[r * HC + c] = ge;
          if (s != nullptr && r < rows) {
            s->hh[(t.g0 + r) * p.hid + ch + c] = hh;
            s->ge[(t.g0 + r) * p.hid + ch + c] = ge;
          }
        }
    }
    __syncthreads();
    tile_mac<4>(O + r0 * HC, HC, HC, p.w2 + (size_t)ch * CW, CW, cw, 32,
                acc2);
    __syncthreads();
  }

  // A = y = x1 + m2 (fc2 + bb2); with s, O = mo.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cw + lane + 32 * j;
      const float mo = acc2[i][j] + p.bb2[c];
      A[r * CW + c] = B[r * CW + c] + sm2[r] * mo;
      if (s != nullptr) {
        O[r * CW + c] = mo;
        if (s->mo != nullptr && r < rows) s->mo[(t.g0 + r) * CW + c] = mo;
      }
    }
  }
  __syncthreads();
}

// The rows' branch scales: m[clip] for the tile's valid rows, 1 without
// masks, 0 past the valid rows.
__device__ void row_scales(const Args& p, const TileRows& t, float* sm1,
                           float* sm2) {
  for (int r = threadIdx.x; r < TR; r += NT) {
    const int clip = t.clip0 + r / p.N;
    const bool ok = r < t.rows;
    sm1[r] = !ok ? 0.f : p.m1 ? p.m1[clip] : 1.f;
    sm2[r] = !ok ? 0.f : p.m2 ? p.m2[clip] : 1.f;
  }
  __syncthreads();
}


__global__ void __launch_bounds__(NT, 1) block_fwd_f32_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* A = reinterpret_cast<float*>(smem);
  float* B = A + BUF;
  float* O = B + BUF;
  float* sm = O + BUF;  // the rows' two branch scales
  const TileRows t = tile_rows(p.clips, p.N);
  row_scales(p, t, sm, sm + TR);
  forward_tile(p, t, A, B, O, sm, sm + TR, nullptr);
  // The post-norm (or y itself) out.
  float* out = p.out + t.g0 * CW;
  if (p.gp != nullptr)
    ln_rows(A, CW, out, CW, t.rows, t.rows, p.gp, p.bp, p.post_eps);
  else
    for (int e = threadIdx.x; e < t.rows * CW; e += NT) out[e] = A[e];
}

// d gelu(x) / dx for the exact (erf) GELU.
__device__ __forceinline__ float gelu_grad(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752f));
  const float pdf = expf(-0.5f * v * v) * 0.39894228040143268f;
  return cdf + v * pdf;
}

// LayerNorm's backward for one row a warp: dx = inv (dh g - mean(dh g) -
// xhat mean(dh g xhat)), from the row's gradient dh and normalised xhat.
__device__ __forceinline__ void ln_bwd_row(const float4& dh0,
                                           const float4& dh1,
                                           const float4& xh0,
                                           const float4& xh1, const float* g,
                                           float inv, float4& dx0,
                                           float4& dx1) {
  const int lane = threadIdx.x & 31;
  const float4 ga = *reinterpret_cast<const float4*>(g + 4 * lane);
  const float4 gb = *reinterpret_cast<const float4*>(g + 128 + 4 * lane);
  const float4 d0 = make_float4(dh0.x * ga.x, dh0.y * ga.y, dh0.z * ga.z,
                                dh0.w * ga.w);
  const float4 d1 = make_float4(dh1.x * gb.x, dh1.y * gb.y, dh1.z * gb.z,
                                dh1.w * gb.w);
  const float ma = warp_sum(sum8(d0, d1)) * (1.0f / CW);
  const float mb =
      warp_sum(((d0.x * xh0.x + d0.y * xh0.y) + (d0.z * xh0.z + d0.w * xh0.w)) +
               ((d1.x * xh1.x + d1.y * xh1.y) + (d1.z * xh1.z + d1.w * xh1.w))) *
      (1.0f / CW);
  dx0 = make_float4(inv * (d0.x - ma - xh0.x * mb), inv * (d0.y - ma - xh0.y * mb),
                    inv * (d0.z - ma - xh0.z * mb), inv * (d0.w - ma - xh0.w * mb));
  dx1 = make_float4(inv * (d1.x - ma - xh1.x * mb), inv * (d1.y - ma - xh1.y * mb),
                    inv * (d1.z - ma - xh1.z * mb), inv * (d1.w - ma - xh1.w * mb));
}

__device__ __forceinline__ float4 normalised(float4 u, float mean, float inv) {
  return make_float4((u.x - mean) * inv, (u.y - mean) * inv,
                     (u.z - mean) * inv, (u.w - mean) * inv);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float dot8(const float4& a0, const float4& a1,
                                      const float4& b0, const float4& b1) {
  return ((a0.x * b0.x + a0.y * b0.y) + (a0.z * b0.z + a0.w * b0.w)) +
         ((a1.x * b1.x + a1.y * b1.y) + (a1.z * b1.z + a1.w * b1.w));
}

// Offsets of the vector gradients in a tile's partials (the wrapper's
// _block_vec_layout): g1, b1, bqkv, bproj, g2, b2, bb1, bb2, gp, bp.
struct VecLayout {
  int g1, b1, bqkv, bproj, g2, b2, bb1, bb2, gp, bp, len;
  __host__ __device__ explicit VecLayout(int hid)
      : g1(0), b1(CW), bqkv(2 * CW), bproj(5 * CW), g2(6 * CW), b2(7 * CW),
        bb1(8 * CW), bb2(8 * CW + hid), gp(9 * CW + hid),
        bp(10 * CW + hid), len(11 * CW + hid) {}
};

// The backward's tile program (see the header): the forward recomputed,
// then the gradient chain of the tile's rows.
__global__ void __launch_bounds__(NT, 1)
    block_bwd_f32_kernel(Args p, Save s, Bwd b) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* A = reinterpret_cast<float*>(smem);
  float* B = A + BUF;
  float* O = B + BUF;
  float* rv = O + BUF;
  float *sm1 = rv, *sm2 = rv + TR;
  s.mean1 = rv + 2 * TR;
  s.inv1 = rv + 3 * TR;
  s.mean2 = rv + 4 * TR;
  s.inv2 = rv + 5 * TR;
  float *meanp = rv + 6 * TR, *invp = rv + 7 * TR;
  float *dmr1 = rv + 8 * TR, *dmr2 = rv + 9 * TR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TileRows t = tile_rows(p.clips, p.N);
  const int N = p.N, rows = t.rows, hid = p.hid;
  const int r0 = (warp >> 1) * TM, cw = (warp & 1) * (CW / 2);
  const bool masks = b.dm1 != nullptr;
  const VecLayout V(hid);
  float* part = b.part + (size_t)blockIdx.x * V.len;

  row_scales(p, t, sm1, sm2);
  forward_tile(p, t, A, B, O, sm1, sm2, &s);
  // Now A = y, B = x1, O = mo.

  // Post-norm^T: A = gy.
  const float* gout = b.gout + t.g0 * CW;
  if (p.gp != nullptr) {
    for (int r = warp; r < rows; r += NW) {
      float4 u, v;
      load_row(A + r * CW, u, v);
      float mean, inv;
      row_moments(u, v, p.post_eps, mean, inv);
      if (lane == 0) {
        meanp[r] = mean;
        invp[r] = inv;
      }
    }
    __syncthreads();
    for (int c = tid; c < 2 * CW; c += NT) {
      const int cc = c % CW;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r)
        acc += c < CW ? gout[r * CW + cc] * ((A[r * CW + cc] - meanp[r]) * invp[r])
                      : gout[r * CW + cc];
      part[(c < CW ? V.gp : V.bp) + cc] = acc;
    }
    __syncthreads();
    for (int r = warp; r < TR; r += NW) {
      float4* a0 = reinterpret_cast<float4*>(A + r * CW + 4 * lane);
      float4* a1 = reinterpret_cast<float4*>(A + r * CW + 128 + 4 * lane);
      if (r >= rows) {
        *a0 = *a1 = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      float4 g0, g1, y0, y1, d0, d1;
      load_row(gout + r * CW, g0, g1);
      load_row(A + r * CW, y0, y1);
      ln_bwd_row(g0, g1, normalised(y0, meanp[r], invp[r]),
                 normalised(y1, meanp[r], invp[r]), p.gp, invp[r], d0, d1);
      *a0 = d0;
      *a1 = d1;
    }
  } else {
    __syncthreads();
    for (int e = tid; e < BUF; e += NT)
      A[e] = e < rows * CW ? gout[e] : 0.f;
    for (int c = tid; c < 2 * CW; c += NT) part[V.gp + c] = 0.f;
  }
  __syncthreads();

  // The mask gradients' row sums of gy mo; m2g = m2 gy out, dbb2.
  if (masks)
    for (int r = warp; r < rows; r += NW) {
      float4 g0, g1, m0, m1;
      load_row(A + r * CW, g0, g1);
      load_row(O + r * CW, m0, m1);
      const float d = warp_sum(dot8(g0, g1, m0, m1));
      if (lane == 0) dmr2[r] = d;
    }
  for (int e = tid; e < rows * CW; e += NT)
    b.m2g[t.g0 * CW + e] = A[e] * sm2[e / CW];
  for (int c = tid; c < CW; c += NT) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += A[r * CW + c] * sm2[r];
    part[V.bb2 + c] = acc;
  }
  __syncthreads();

  // MLP^T in hidden chunks: dhh = m2 (gy W2^T) gelu'(hh) into O ([64, HC])
  // and out, dbb1, and dh2 += dhh W1^T in registers.
  float dh2[TM][4] = {};
  for (int ch = 0; ch < hid; ch += HC) {
    {
      const int ch2 = (warp & 1) * (HC / 2);
      float acc[TM][HC / 64] = {};
      tile_mac<HC / 64>(A + r0 * CW, CW, CW, b.w2T, hid, ch + ch2, 32, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < HC / 64; ++j) {
          const int r = r0 + i, c = ch2 + lane + 32 * j;
          float dhh = 0.f;
          if (r < rows) {
            const size_t at = (t.g0 + r) * hid + ch + c;
            dhh = acc[i][j] * sm2[r] * gelu_grad(s.hh[at]);
            b.dhh[at] = dhh;
          }
          O[r * HC + c] = dhh;
        }
    }
    __syncthreads();
    for (int c = tid; c < HC; c += NT) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += O[r * HC + c];
      part[V.bb1 + ch + c] = acc;
    }
    tile_mac<4>(O + r0 * HC, HC, HC, b.w1T + (size_t)ch * CW, CW, cw, 32,
                dh2);
    __syncthreads();
  }

  // LN2^T: O = dh2; dg2, db2; A = dx1 = gy + LN2^T(dh2); the mask
  // gradients' row sums of dx1 a.
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      O[(r0 + i) * CW + cw + lane + 32 * j] = dh2[i][j];
  __syncthreads();
  for (int c = tid; c < 2 * CW; c += NT) {
    const int cc = c % CW;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r)
      acc += c < CW ? O[r * CW + cc] * ((B[r * CW + cc] - s.mean2[r]) * s.inv2[r])
                    : O[r * CW + cc];
    part[(c < CW ? V.g2 : V.b2) + cc] = acc;
  }
  for (int r = warp; r < TR; r += NW) {
    float4* a0 = reinterpret_cast<float4*>(A + r * CW + 4 * lane);
    float4* a1 = reinterpret_cast<float4*>(A + r * CW + 128 + 4 * lane);
    if (r >= rows) {
      *a0 = *a1 = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    float4 h0, h1, x0, x1, d0, d1;
    load_row(O + r * CW, h0, h1);
    load_row(B + r * CW, x0, x1);
    ln_bwd_row(h0, h1, normalised(x0, s.mean2[r], s.inv2[r]),
               normalised(x1, s.mean2[r], s.inv2[r]), p.g2, s.inv2[r], d0,
               d1);
    d0 = add4(*a0, d0);
    d1 = add4(*a1, d1);
    *a0 = d0;
    *a1 = d1;
    if (masks) {
      float4 u, v;
      load_row(s.a + (t.g0 + r) * CW, u, v);
      const float d = warp_sum(dot8(d0, d1, u, v));
      if (lane == 0) dmr1[r] = d;
    }
  }
  __syncthreads();

  // proj^T: da = m1 dx1 out, dbproj; dx1 to dx (LN1^T adds to it); O = dO
  // = m1 (dx1 Wproj^T).
  for (int e = tid; e < rows * CW; e += NT) {
    b.da[t.g0 * CW + e] = A[e] * sm1[e / CW];
    b.dx[t.g0 * CW + e] = A[e];
  }
  for (int c = tid; c < CW; c += NT) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += A[r * CW + c] * sm1[r];
    part[V.bproj + c] = acc;
  }
  {
    float acc[TM][4] = {};
    tile_mac<4>(A + r0 * CW, CW, CW, b.wprojT, CW, cw, 32, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + i;
        O[r * CW + cw + lane + 32 * j] = acc[i][j] * sm1[r];
      }
  }
  __syncthreads();

  // Attention^T a head at a time, in A and B's space: the head's scaled q,
  // k^T and v (from the recompute), P and dS [64, 64] (a row's entries at
  // its clip's keys), dq (raw: times the scale), dk, dv.
  float* Qh = A;
  float* KT = Qh + TR * DH;
  float* Vh = KT + DH * KT_LD;
  float* P = Vh + TR * V_LD;
  float* dS = P + TR * TR;
  float* DQ = dS + TR * TR;
  float* DK = DQ + TR * DH;
  float* DV = DK + TR * DH;
  float dh1[TM][4] = {};
  for (int h = 0; h < NH; ++h) {
    for (int e = tid; e < TR * DH; e += NT) {
      const int r = e / DH, d = e % DH;
      float q = 0.f, k = 0.f, v = 0.f;
      if (r < rows) {
        const float* row = s.qkv + (t.g0 + r) * (3 * CW) + h * DH + d;
        q = row[0];
        k = row[CW];
        v = row[2 * CW];
      }
      Qh[r * DH + d] = q;
      KT[d * KT_LD + r] = k;
      Vh[r * V_LD + d] = v;
    }
    __syncthreads();
    for (int r = warp; r < TR; r += NW) {
      if (r >= rows) {
        DQ[r * DH + lane] = 0.f;
        continue;
      }
      const int kb = r / N * N;
      const bool has0 = lane < N, has1 = lane + 32 < N;
      const int j0 = kb + min(lane, N - 1), j1 = kb + min(lane + 32, N - 1);
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float qd = Qh[r * DH + d];
        s0 = fmaf(qd, KT[d * KT_LD + j0], s0);
        s1 = fmaf(qd, KT[d * KT_LD + j1], s1);
        const float od = O[r * CW + h * DH + d];
        dp0 = fmaf(od, Vh[j0 * V_LD + d], dp0);
        dp1 = fmaf(od, Vh[j1 * V_LD + d], dp1);
      }
      float m = fmaxf(has0 ? s0 : -INFINITY, has1 ? s1 : -INFINITY);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e0 = has0 ? expf(s0 - m) : 0.f;
      const float e1 = has1 ? expf(s1 - m) : 0.f;
      const float l = warp_sum(e0 + e1);
      const float p0 = e0 / l, p1 = e1 / l;
      const float D = warp_sum(p0 * dp0 + p1 * dp1);
      const float ds0 = has0 ? p0 * (dp0 - D) : 0.f;
      const float ds1 = has1 ? p1 * (dp1 - D) : 0.f;
      if (has0) {
        P[r * TR + lane] = p0;
        dS[r * TR + lane] = ds0;
      }
      if (has1) {
        P[r * TR + lane + 32] = p1;
        dS[r * TR + lane + 32] = ds1;
      }
      float dq = 0.f;
      for (int j = 0; j < N; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, j < 32 ? ds0 : ds1, j & 31);
        dq = fmaf(dsj, KT[lane * KT_LD + kb + j], dq);
      }
      DQ[r * DH + lane] = dq * p.qscale;
    }
    __syncthreads();
    for (int r = warp; r < TR; r += NW) {
      float dk = 0.f, dv = 0.f;
      if (r < rows) {
        const int kb = r / N * N, jl = r - kb;
        for (int i = kb; i < kb + N; ++i) {
          dk = fmaf(dS[i * TR + jl], Qh[i * DH + lane], dk);
          dv = fmaf(P[i * TR + jl], O[i * CW + h * DH + lane], dv);
        }
      }
      DK[r * DH + lane] = dk;
      DV[r * DH + lane] = dv;
    }
    __syncthreads();
    for (int e = tid; e < rows * DH; e += NT) {
      float* row = b.dqkv + (t.g0 + e / DH) * (3 * CW) + h * DH + e % DH;
      row[0] = DQ[e];
      row[CW] = DK[e];
      row[2 * CW] = DV[e];
    }
    for (int c = tid; c < 3 * DH; c += NT) {
      const float* src = c < DH ? DQ : c < 2 * DH ? DK : DV;
      const int d = c % DH;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += src[r * DH + d];
      part[V.bqkv + c / DH * CW + h * DH + d] = acc;
    }
    // dh1 += dq Wq^T + dk Wk^T + dv Wv^T over the head's rows of Wqkv^T.
    tile_mac<4>(DQ + r0 * DH, DH, DH, b.wqkvT + (size_t)(h * DH) * CW, CW,
                cw, 32, dh1);
    tile_mac<4>(DK + r0 * DH, DH, DH, b.wqkvT + (size_t)(CW + h * DH) * CW,
                CW, cw, 32, dh1);
    tile_mac<4>(DV + r0 * DH, DH, DH,
                b.wqkvT + (size_t)(2 * CW + h * DH) * CW, CW, cw, 32, dh1);
    __syncthreads();
  }

  // LN1^T: O = dh1; dg1, db1; dx = dx1 + LN1^T(dh1).
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      O[(r0 + i) * CW + cw + lane + 32 * j] = dh1[i][j];
  __syncthreads();
  const float* x = p.x + t.g0 * CW;
  for (int c = tid; c < 2 * CW; c += NT) {
    const int cc = c % CW;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r)
      acc += c < CW ? O[r * CW + cc] * ((x[r * CW + cc] - s.mean1[r]) * s.inv1[r])
                    : O[r * CW + cc];
    part[(c < CW ? V.g1 : V.b1) + cc] = acc;
  }
  for (int r = warp; r < rows; r += NW) {
    float4 h0, h1, x0, x1, d0, d1, e0, e1;
    load_row(O + r * CW, h0, h1);
    load_row(x + r * CW, x0, x1);
    ln_bwd_row(h0, h1, normalised(x0, s.mean1[r], s.inv1[r]),
               normalised(x1, s.mean1[r], s.inv1[r]), p.g1, s.inv1[r], d0,
               d1);
    float* dx = b.dx + (t.g0 + r) * CW;
    load_row(dx, e0, e1);
    *reinterpret_cast<float4*>(dx + 4 * lane) = add4(e0, d0);
    *reinterpret_cast<float4*>(dx + 128 + 4 * lane) = add4(e1, d1);
  }
  // The mask gradients: each clip's rows summed in order.
  if (masks)
    for (int c = tid; c < rows / N; c += NT) {
      float a1 = 0.f, a2 = 0.f;
      for (int r = c * N; r < (c + 1) * N; ++r) {
        a1 += dmr1[r];
        a2 += dmr2[r];
      }
      b.dm1[t.clip0 + c] = a1;
      b.dm2[t.clip0 + c] = a2;
    }
}

}  // namespace bf32

// Host entry points.

static bool fill_args(bf32::Args& a, void* const* p, int clips, int N,
                      int hid, float eps, float post_eps, float qscale) {
  using namespace bf32;
  if (clips <= 0 || N <= 0 || N > TR || hid <= 0 || hid % HC) return false;
  auto cf = [&](int i) { return static_cast<const float*>(p[i]); };
  a.x = cf(0);
  a.wqkv = cf(2); a.wproj = cf(3); a.w1 = cf(4); a.w2 = cf(5);
  a.g1 = cf(6); a.b1 = cf(7); a.bqkv = cf(8); a.bproj = cf(9);
  a.g2 = cf(10); a.b2 = cf(11); a.bb1 = cf(12); a.bb2 = cf(13);
  a.gp = cf(14); a.bp = cf(15); a.m1 = cf(16); a.m2 = cf(17);
  a.out = nullptr;
  a.clips = clips; a.N = N; a.hid = hid;
  a.eps = eps; a.post_eps = post_eps; a.qscale = qscale;
  return (a.gp == nullptr) == (a.bp == nullptr) &&
         (a.m1 == nullptr) == (a.m2 == nullptr);
}

// The f32 forward over [clips, N, 256] tokens, N <= 64, hid a multiple of
// 128. ptrs: x, out, wqkv [256, 768], wproj [256, 256], w1 [256, hid],
// w2 [hid, 256] (f32, [in, out] as the parameters are), g1, b1, bqkv, bproj,
// g2, b2, bb1, bb2, gp, bp (gp and bp null without a post-norm), m1, m2
// (per-clip [clips] branch scales; both null without masks).
extern "C" int pmce_block_fwd_f32(void* const* ptrs, int clips, int N,
                                  int hid, float eps, float post_eps,
                                  float qscale, void* stream) {
  using namespace bf32;
  Args a;
  if (!fill_args(a, ptrs, clips, N, hid, eps, post_eps, qscale))
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<float*>(ptrs[1]);
  cudaError_t e = cudaFuncSetAttribute(
      block_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cpt = TR / N;
  const int tiles = (clips + cpt - 1) / cpt;
  block_fwd_f32_kernel<<<tiles, NT, FWD_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The f32 backward: dx, the 14 parameter gradients and, with dm1 / dm2,
// the per-clip mask gradients, in three launches (the transposes, the
// tile program, the weight gradients). ptrs: 0-17 as the forward's (1: the
// output's gradient gout [clips, N, 256]); the workspace 18-21 wqkv^T,
// wproj^T, w1^T, w2^T; 22-29 h1, qkv, o, h2 [M, 256 / 768], hh, ge
// [M, hid], a, mo (both null without mask gradients); 30-33 dqkv, da, dhh,
// m2g; 34 dx; 35 the tiles' vector partials [tiles, 11 * 256 + hid]; 36-37
// dm1, dm2 [clips] (null: not owed); 38 the weight gradients' range
// partials [splits, tiles of 64 x 64, 4096]; 39-42 dwqkv, dwproj, dw1, dw2;
// 43 the vector gradients [11 * 256 + hid] (the layout of VecLayout).
extern "C" int pmce_block_bwd_f32(void* const* ptrs, int clips, int N,
                                  int hid, float eps, float post_eps,
                                  float qscale, int splits, void* stream) {
  using namespace bf32;
  Args a;
  if (!fill_args(a, ptrs, clips, N, hid, eps, post_eps, qscale) ||
      splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  Save s = {f(22), f(23), f(24), f(25), f(26), f(27), f(28), f(29),
            nullptr, nullptr, nullptr, nullptr};
  Bwd b;
  b.gout = f(1);
  b.wqkvT = f(18); b.wprojT = f(19); b.w1T = f(20); b.w2T = f(21);
  b.dqkv = f(30); b.da = f(31); b.dhh = f(32); b.m2g = f(33);
  b.dx = f(34); b.part = f(35); b.dm1 = f(36); b.dm2 = f(37);
  const bool masks = b.dm1 != nullptr;
  if ((b.dm2 != nullptr) != masks || (s.a != nullptr) != masks ||
      (s.mo != nullptr) != masks || (masks && a.m1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  f32ops::Transposes T;
  const float* src[4] = {a.wqkv, a.wproj, a.w1, a.w2};
  const int rows[4] = {CW, CW, CW, hid}, cols[4] = {3 * CW, CW, hid, CW};
  for (int i = 0; i < 4; ++i) {
    T.in[i] = src[i];
    T.out[i] = f(18 + i);
    T.rows[i] = rows[i];
    T.cols[i] = cols[i];
  }
  T.n = 4;
  cudaError_t e = f32ops::launch_transposes(T, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  e = cudaFuncSetAttribute(block_bwd_f32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cpt = TR / N;
  const int tiles = (clips + cpt - 1) / cpt;
  block_bwd_f32_kernel<<<tiles, NT, BWD_SMEM, st>>>(a, s, b);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  f32ops::Jobs J;
  const int M = clips * N;
  J.job[0] = {s.h1, b.dqkv, f(39), CW, 3 * CW};
  J.job[1] = {s.o, b.da, f(40), CW, CW};
  J.job[2] = {s.h2, b.dhh, f(41), CW, hid};
  J.job[3] = {s.ge, b.m2g, f(42), hid, CW};
  J.n = 4;
  J.M = M;
  J.splits = splits;
  J.ws = f(38);
  J.vpart = b.part;
  J.vout = f(43);
  J.vtiles = tiles;
  J.vlen = VecLayout(hid).len;
  return static_cast<int>(f32ops::launch_wgrad(J, st));
}

PMCE_EXPORT_ERROR_STRING(pmce_block_f32_error_string)
