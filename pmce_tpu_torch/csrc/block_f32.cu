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
// Products: 3xTF32 on the tensor cores (mma.sync m16n8k8; common.cuh).
// Each f32 operand is split as hi = v rounded to TF32 (to nearest, ties
// away: cvt.rna's rounding) and lo = v - hi as its fragment is loaded, and
// a product sums a_lo b_hi + a_hi b_lo + a_hi b_hi in f32: about 22 of
// f32's 24 mantissa bits, the lo * lo term dropped. A single TF32 pass
// errs ~4e-4 of the block's output (a CPU model of the products over the
// plain block, C 256, hid 512, N 16 / 17 / 19:
// tests/test_torch_port_block_f32_redesign.py), 40x the card's 1e-5 gate;
// the 3xTF32 model errs <= 7.3e-7 (outputs) and <= 1.8e-6 (gradients).
// The tensor cores add with truncation, so each k-step's three products
// are summed from zero and added to the f32 accumulator by a rounded add
// (product_rows).
// The attention inside a tile (~6 % of the products) stays on FFMA.
//
// What bounds them on this card: products. A row of C = 256 costs qkv 256 x
// 768, proj 256 x 256, fc1 256 x hid and fc2 hid x 256 multiply-adds,
// 1,048,576 flops at hid 512 forward and twice that backward (the
// activation and the weight gradients); Stage 1's 17,408 rows a call make
// 18.3 GFLOP forward and 36.5 GFLOP backward: 0.27 / 0.55 ms at the 67
// TFLOP/s f32 FFMA peak, 0.11 / 0.22 ms as three TF32 products each at the
// 495 TFLOP/s dense TF32 peak. mma.sync itself reaches 1.5 cycles an
// m16n8k8 an SM on the H100 (680 TF32 FMA a cycle, 66 % of that peak).
//
// Tiles and the grid: a tile is whole clips of up to TR = 64 rows (3 clips
// of 17 or 19, 4 of 16), its products run over its rows padded to 16 (51
// and 57 become 64, 34 becomes 48). The grid is persistent: `ctas` CTAs
// (the wrapper's f32_block_plan: min(tiles, the card's co-resident CTAs),
// one an SM), CTA i taking the clips [floor(B i / G), floor(B (i + 1) / G))
// in tiles of whole clips, so the CTAs differ by at most one clip and the
// card runs whole waves.
//
// Shared memory (bytes of the 232,448 a block may take): three f32
// [64, 256] row buffers A, B, O (3 x 65,536), the weight ring (2 stages x
// [16, 256] f32 = 32,768) and the rows' values (forward 2 x 64 x 4 = 512:
// the branch scales; backward 10 x 64 x 4 = 2,560: the branch scales, LN1's,
// LN2's and the post-norm's means and inverse deviations, the two mask
// gradients' row sums): 229,888 forward, 231,936 backward; the 1 KB the
// card reserves a block makes 232,960 of the SM's 233,472.
//
// The weight ring: every product out[rows, ncol] += A[rows, K] W[K, ncol]
// (A in shared memory, W in device memory, K a multiple of 32) streams W in
// K-slabs of 16 rows through two stages, filled by cp.async of 16 B from
// all 256 threads at offsets fixed over the product: one copy of each
// weight a CTA, read by all 8 warps (the FFMA program read W through L1
// once per row group of 8, 8 times a tile). Slab s + 1 is copied while slab
// s is multiplied, one block barrier a slab; the next product's first slab
// is issued as soon as a product's last slab is read, so it lands behind
// the epilogue, a LayerNorm or the attention. A slab's 16 B chunks are
// XOR-swizzled by row ((k / 4) % 4 * 8 floats), so that a warp's B
// fragments (rows 4 t + {0, 1, 2, 3}, columns g of 8) fall on 32 distinct
// banks. A warp owns 32 rows x ncol / 4 columns (NB = ncol / 32 blocks of
// 8): the 8 warps are 2 row halves x 4 column groups, and a 16-row block
// past the padded rows is skipped. The K index is permuted within each
// 16-slab (mma step j, lane quad t: k = 4 t + 2 j + {0, 1}) so that a
// lane's A values for a slab are one float4 load a row; both operands use
// the same permutation, so each product sums every k once.
//
// Registers: 256 threads, so up to 255 each (a warp's accumulators, up to
// 64, and the MLP's or the attention's persistent sums, another 64, do not
// fit the 128 of 512 threads without spilling). ptxas -v for sm_90a: the
// forward 251 registers, the backward's tile program 255, both 0 bytes of
// stack and of spill stores and loads. (Builds of this program that spilled
// faulted on the card with illegal addresses; keep it spill-free.)
//
// Forward (pmce_block_fwd_f32), a tile: LN1 writes A; per pair of heads
// the qkv product (192 columns: the pair's q, k and v) goes to B's space
// with k transposed ([32, 65], so that a lane's key reads fall on distinct
// banks), and a warp takes RI = 4 rows of a head at once (independent
// chains of loads and shuffles): the scores of each row's clip's keys (a
// lane a key), the softmax by shuffles and o (a lane a channel), into O.
// proj writes x1 = x + m1 (O Wproj + b) into B (x re-read from device
// memory); LN2 writes A; the MLP runs in hidden chunks of 128: fc1 + GELU
// into O, then fc2 into registers that persist over the chunks; y = x1 +
// m2 (fc2 + b) into A, then the post-norm a warp a row. The forward saves
// nothing for the gradient: the backward recomputes it from x.
//
// Backward (pmce_block_bwd_f32), as JAX's `_block_bwd_kernel` does it:
// recompute the forward from x, then run the gradient chain, over the same
// tiles. Saving the forward's state instead would cost ~18 KB a row (320
// MB a Stage-1 call, for each of the 6 blocks until its backward);
// recomputing keeps the forward one program and costs one forward's
// products. Three launches:
// 1. the four weights transposed into a workspace (the gradient chain's
//    products read W^T slabs as the forward reads W slabs);
// 2. the tile program: the forward above (writing h1, the scaled q and k,
//    v, o, h2, hh and gelu(hh) to a workspace, and the branches a and mo
//    when the mask gradients are owed), then post-norm^T (A: gy), the
//    mask gradients' row sums, MLP^T in hidden chunks (dhh into O's space,
//    dh2 in registers), LN2^T (A: dx1), proj^T (O: dO), attention^T a head
//    at a time in A and B's space (q, k^T, v, P, dS, dq, dk, dv, RI rows a
//    warp at once; dh1 in registers over the heads), LN1^T (dx). It
//    writes the weight products' operands (dqkv, da, dhh and m2 gy) and
//    each CTA's partial sums of the vector gradients (LayerNorm scales and
//    shifts, biases), its tiles' sums added in order;
// 3. the weight gradients dW = A^T dY (3xTF32) and the CTAs' vector
//    partials summed in a fixed order (csrc/f32_ops.cuh).
// No atomics: a rerun gives the same bits.

#include "common.cuh"
#include "f32_ops.cuh"

namespace bf32 {

using namespace tc32;

constexpr int NT = 256;  // threads per block (8 warps, up to 255 registers)
constexpr int NW = NT / 32;
constexpr int NWN = NW / 2;  // a product's column groups of warps
// The 8-column blocks of a warp in a product of ncol columns.
__host__ __device__ constexpr int nbk(int ncol) { return ncol / (8 * NWN); }
constexpr int TR = 64;    // tile rows (whole clips)
constexpr int CW = 256;   // channel width C
constexpr int DH = 32;    // head width
constexpr int NH = CW / DH;
constexpr int HC = 128;   // hidden chunk of the MLP
constexpr int KT_LD = TR + 1;  // row stride of the transposed keys
// The attention's rows a warp takes at once (r0 + RS i, i < RI).
constexpr int RI = 4;
constexpr int RS = TR / RI;
// The same in the backward's attention (its dh1 stays in registers).
constexpr int RIB = 4;
constexpr int RSB = TR / RIB;
constexpr int V_LD = DH + 1;   // row stride of the backward's values
constexpr int QKV_F = 2 * TR * DH + DH * KT_LD;  // one head's q, k^T, v
constexpr int BUF = TR * CW;   // one [64, 256] buffer
constexpr int KS = 16;         // rows of a weight slab
constexpr int SLAB = KS * CW;  // one stage of the ring: [16, 256]
constexpr int RING = 2 * SLAB;
// The backward's per-row values in shared memory: LN1's and LN2's means
// and inverse deviations, the post-norm's, the two branch scales and the
// two mask gradients' row sums.
constexpr int ROWV = 10 * TR;
constexpr int FWD_SMEM = (3 * BUF + RING + 2 * TR) * 4;
constexpr int BWD_SMEM = (3 * BUF + RING + ROWV) * 4;
static_assert(BWD_SMEM <= 232448, "over the opt-in shared memory a block");

struct Args {
  const float *x, *wqkv, *wproj, *w1, *w2;
  const float *g1, *b1, *bqkv, *bproj, *g2, *b2, *bb1, *bb2, *gp, *bp;
  const float *m1, *m2;  // per-clip branch scales, or null (1)
  float* out;
  int clips, N, hid;
  float eps, post_eps, qscale;
};

// What the backward's recompute of the forward writes (rows of the tile's
// first row g0; a and mo null: not written).
struct Save {
  float *h1, *qkv, *o, *h2, *hh, *ge, *a, *mo;
};

struct Bwd {
  const float* gout;
  const float *wqkvT, *wprojT, *w1T, *w2T;
  float *dqkv, *da, *dhh, *m2g;
  float *dx, *part, *dm1, *dm2;
};

// ---------------------------------------------------------------------------
// The products (see the header): a weight operand W[K, 64 NB] in device
// memory, staged through the ring, and the A operand in shared memory.
// ---------------------------------------------------------------------------

// Where a product's W lies: row k at w + k ldw, logical column n at
// (n / seg) seg_stride + n % seg.
struct Slab {
  const float* w;
  int ldw, seg, seg_stride;
};

// W's columns contiguous.
__device__ __forceinline__ Slab slab(const float* w, int ldw) {
  return {w, ldw, 1 << 30, 0};
}

// The 16 B chunks a thread copies of every K-slab of W (16 rows, NCOL
// columns): their offsets from the slab's first element in W, and their
// swizzled places in a stage (see the header); fixed over a product.
template <int NCOL>
struct Copies {
  static constexpr int PER = KS * NCOL / 4 / NT;
  static_assert(KS * NCOL / 4 % NT == 0, "whole chunks a thread");
  int src[PER], dst[PER];
  __device__ __forceinline__ explicit Copies(const Slab& S) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NT;
      const int kk = e / (NCOL / 4), n = e % (NCOL / 4) * 4;
      src[i] = kk * S.ldw + n / S.seg * S.seg_stride + n % S.seg;
      dst[i] = kk * CW + (n ^ (((kk >> 2) & 3) << 3));
    }
  }
  // The slab at w (its first element) into a stage, as one group of
  // cp.async copies of every thread.
  __device__ __forceinline__ void issue(const float* w, float* stage) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) cp_async16(stage + dst[i], w + src[i]);
    cp_async_commit();
  }
};

// Where slab s of W starts.
__device__ __forceinline__ const float* slab_start(const Slab& S, int s) {
  return S.w + (size_t)s * KS * S.ldw;
}

// Slab s of W into ring stage s % 2.
template <int NCOL>
__device__ __forceinline__ void ring_fill(const Slab& S, int s, float* ring) {
  Copies<NCOL>(S).issue(slab_start(S, s), ring + (s & 1) * SLAB);
}

// One slab of a product from ring stage STAGE: the wait for its copies and
// the block barrier, the next slab's copies (into the other stage), then
// the warp's MB blocks x NB columns over the slab's 16 K values. `a`: the
// A values of the lane's row g and this slab's first column.
template <int NB, int MB, int STAGE, int NCOL>
__device__ __forceinline__ void slab_step(const Copies<NCOL>& cp,
                                          const float* next, float* ring,
                                          const float* a, int lda,
                                          const float* const (&bptr)[NB],
                                          float (&acc)[2][NB][4]) {
  cp_async_wait_all();
  __syncthreads();
  if (next != nullptr) cp.issue(next, ring + (1 - STAGE) * SLAB);
  if (MB == 0) return;
  // Rows g and g + 8 of each block, the lane's 4 K values of the slab
  // (mma step j: k = 4 t + 2 j + {0, 1}).
  float4 f[MB > 0 ? MB : 1][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    f[mb][0] = *reinterpret_cast<const float4*>(a + 16 * mb * lda);
    f[mb][1] = *reinterpret_cast<const float4*>(a + (16 * mb + 8) * lda);
  }
  // Not unrolled: both steps' chains at once overrun 255 registers.
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    unsigned ah[MB > 0 ? MB : 1][4], al[MB > 0 ? MB : 1][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      split_tf32(j ? f[mb][0].z : f[mb][0].x, ah[mb][0], al[mb][0]);
      split_tf32(j ? f[mb][1].z : f[mb][1].x, ah[mb][1], al[mb][1]);
      split_tf32(j ? f[mb][0].w : f[mb][0].y, ah[mb][2], al[mb][2]);
      split_tf32(j ? f[mb][1].w : f[mb][1].y, ah[mb][3], al[mb][3]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float* b = bptr[nb] + STAGE * SLAB + 2 * j * CW;
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(b[0], bh0, bl0);
      split_tf32(b[CW], bh1, bl1);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        // The k-step's three products from zero, then one rounded add.
        float k8[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(k8, al[mb], bh0, bh1);
        mma_tf32(k8, ah[mb], bl0, bl1);
        mma_tf32(k8, ah[mb], bh0, bh1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mb][nb][i] += k8[i];
      }
    }
  }
}

// acc += A W over K (a multiple of 32, so that a product's slabs end in
// stage 1) for the warp's 32 rows x 8 NB columns (see the header), of
// which the first MB 16-row blocks are computed (0: the warp only keeps
// the ring's barriers and copies). Slab 0 must already be issued
// (ring_fill(S, 0, ring)); on return the ring's stage 0 is free for the
// next product's slab 0. Each 8-wide k-step's lo hi, hi lo and hi hi
// products are summed by the tensor cores from zero and added to the
// accumulator by an ordinary (round-to-nearest) f32 add: the tensor cores
// add with truncation, and summing a whole K in them biased every output
// toward zero (on the H100 3.4e-6 of the block's output, against 7e-7 with
// the rounded adds), which the f32 Stage-2 step's gradients amplified to
// 2.4e-4, past their 1e-4 gate (chip_smoke.py phase 13b; 1.7e-6 now).
template <int NB, int MB>
__device__ __forceinline__ void product_rows(const float* A, int lda,
                                             const Slab& S, int K,
                                             float* ring,
                                             float (&acc)[2][NB][4]) {
  constexpr int NCOL = NB * 8 * NWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Copies<NCOL> cp(S);
  // The lane's B values: column g of each of its 8-column blocks, rows
  // 4 t + {0, 1, 2, 3} of a stage, swizzled as those rows are.
  const float* bptr[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    bptr[nb] = ring + 4 * t * CW + 8 * (((warp >> 1) * NB + nb) ^ t) + g;
  const float* arow = A + ((warp & 1) * 32 + g) * lda + 4 * t;
  const int nslab = K / KS;
  for (int s = 0; s < nslab; s += 2) {
    // Slab s is in stage 0, slab s + 1 in stage 1 (K % 32 == 0).
    slab_step<NB, MB, 0>(cp, slab_start(S, s + 1), ring, arow + s * KS, lda,
                         bptr, acc);
    slab_step<NB, MB, 1>(cp, s + 2 < nslab ? slab_start(S, s + 2) : nullptr,
                         ring, arow + (s + 1) * KS, lda, bptr, acc);
  }
}

// product_rows over the warp's 16-row blocks below mrows (a warp-uniform
// choice, made once a product).
template <int NB>
__device__ __forceinline__ void product(const float* A, int lda, const Slab& S,
                                        int K, float* ring, int mrows,
                                        float (&acc)[2][NB][4]) {
  const int rb = (threadIdx.x >> 5 & 1) * 32;
  if (rb + 16 < mrows)
    product_rows<NB, 2>(A, lda, S, K, ring, acc);
  else if (rb < mrows)
    product_rows<NB, 1>(A, lda, S, K, ring, acc);
  else
    product_rows<NB, 0>(A, lda, S, K, ring, acc);
}

// f(r, c, v0, v1) for the warp's accumulator pairs: row r, columns c and
// c + 1 (c even), 16-row blocks at or past mrows skipped.
template <int NB, class F>
__device__ __forceinline__ void for_acc(int mrows, const float (&acc)[2][NB][4],
                                        F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (warp & 1) * 32;
  const int r = rb + (lane >> 2), c = (warp >> 1) * NB * 8 + 2 * (lane & 3);
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    if (rb + 16 * mb >= mrows) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      f(r + 16 * mb, c + 8 * nb, acc[mb][nb][0], acc[mb][nb][1]);
      f(r + 16 * mb + 8, c + 8 * nb, acc[mb][nb][2], acc[mb][nb][3]);
    }
  }
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The qkv slab of head pair hp: the pair's q, k and v columns, 64 each.
__device__ __forceinline__ Slab qkv_slab(const Args& p, int hp) {
  return {p.wqkv + hp * 2 * DH, 3 * CW, 2 * DH, CW};
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

// A tile's rows: clip0 its first clip, rows its valid rows (whole clips),
// mrows those rounded up to 16 (the rows its products run over).
struct TileRows {
  int clip0, rows, mrows;
  size_t g0;  // the first row's index
};

// The CTA's tiles: its clips [begin, end) (a contiguous share of the
// clips, see the header) in tiles of whole clips up to TR rows.
// The bounds are computed afresh from the parameters at each use (the
// empty asm keeps the compiler from hoisting them out of the tile loop), so
// that they hold no register over a tile.
struct Tiles {
  __device__ static int fresh(int v) {
    asm volatile("" : "+r"(v));
    return v;
  }
  __device__ static int share(const Args& p, int cta) {
    return (int)((long long)fresh(p.clips) * cta / gridDim.x);
  }
  __device__ static int begin(const Args& p) { return share(p, blockIdx.x); }
  __device__ static int end(const Args& p) {
    return share(p, blockIdx.x + 1);
  }
  __device__ static int per(const Args& p) { return TR / fresh(p.N); }
  __device__ static TileRows at(const Args& p, int clip0) {
    TileRows t;
    t.clip0 = clip0;
    t.rows = min(per(p), end(p) - clip0) * p.N;
    t.mrows = (t.rows + 15) & ~15;
    t.g0 = (size_t)clip0 * p.N;
    return t;
  }
};

// The block's forward over one tile, with A, B, O the three [64, 256]
// buffers and sm1 / sm2 the rows' branch scales (shared memory); the
// caller has issued ring_fill(qkv_slab(p, 0), 0, ring). On return A holds
// y = x1 + m2 mo (before the post-norm) and B holds x1; with SAVE, O holds
// mo, s's rows are written and `stats` (shared memory) LN1's and LN2's
// means and inverse deviations, [4][TR].
template <bool SAVE>
__device__ __forceinline__ void forward_tile(
    const Args& p, const Save& s, const TileRows& t, float* A, float* B,
    float* O, float* ring, const float* sm1, const float* sm2,
    float* stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = p.N, rows = t.rows, mrows = t.mrows, hid = p.hid;
  const float* x = p.x + t.g0 * CW;

  // LN1: A = LN(x) (the first product's barrier orders it before reads).
  ln_rows(x, CW, A, CW, TR, rows, p.g1, p.b1, p.eps,
          SAVE ? s.h1 + t.g0 * CW : nullptr, SAVE ? stats : nullptr,
          SAVE ? stats + TR : nullptr);

  // Attention, a pair of heads at a time: head 2 hp + u's q [64, 32],
  // k^T [32, 65] and v [64, 32] in B's space at u * QKV_F.
  for (int hp = 0; hp < NH / 2; ++hp) {
    float acc[2][nbk(192)][4] = {};
    product<nbk(192)>(A, CW, qkv_slab(p, hp), CW, ring, mrows, acc);
    if (hp + 1 < NH / 2)
      ring_fill<3 * 2 * DH>(qkv_slab(p, hp + 1), 0, ring);
    else
      ring_fill<CW>(slab(p.wproj, CW), 0, ring);
    // Columns c of the pair's 192: q, k or v (c / 64), head u, channel d.
    for_acc<nbk(192)>(mrows, acc, [&](int r, int c, float v0, float v1) {
      const int part = c >> 6, u = (c >> 5) & 1, d = c & 31, h = 2 * hp + u;
      const float* bias = p.bqkv + part * CW + h * DH + d;
      float* Q = B + u * QKV_F;
      float* KT = Q + TR * DH;
      float* Vh = KT + DH * KT_LD;
      float a0 = v0 + bias[0], a1 = v1 + bias[1];
      if (part == 0) {
        a0 *= p.qscale;
        a1 *= p.qscale;
        st2(Q + r * DH + d, a0, a1);
      } else if (part == 1) {
        KT[d * KT_LD + r] = a0;
        KT[(d + 1) * KT_LD + r] = a1;
      } else {
        st2(Vh + r * DH + d, a0, a1);
      }
      if (SAVE && r < rows)
        st2(s.qkv + (t.g0 + r) * (3 * CW) + part * CW + h * DH + d, a0, a1);
    });
    __syncthreads();
    // A warp takes RI rows of one head at once (r0 + RS i), for RI
    // independent chains of shuffles and loads; rows past the tile's are
    // computed on what the buffers hold and written as zeros.
    for (int it = warp; it < 2 * RS; it += NW) {
      const int u = it / RS, r0 = it % RS, h = 2 * hp + u;
      const float* Q = B + u * QKV_F;
      const float* KT = Q + TR * DH;
      const float* Vh = KT + DH * KT_LD;
      const int j0 = min(lane, N - 1), j1 = min(lane + 32, N - 1);
      const bool has0 = lane < N, has1 = lane + 32 < N;
      int kb[RI];
      float s0[RI], s1[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = r0 + RS * i;
        kb[i] = r < rows ? r / N * N : 0;
        s0[i] = s1[i] = 0.f;
      }
#pragma unroll 2
      for (int d = 0; d < DH; d += 4) {
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 q =
              *reinterpret_cast<const float4*>(Q + (r0 + RS * i) * DH + d);
          const float* k = KT + d * KT_LD + kb[i];
          s0[i] = fmaf(q.x, k[j0], s0[i]);
          s1[i] = fmaf(q.x, k[j1], s1[i]);
          s0[i] = fmaf(q.y, k[KT_LD + j0], s0[i]);
          s1[i] = fmaf(q.y, k[KT_LD + j1], s1[i]);
          s0[i] = fmaf(q.z, k[2 * KT_LD + j0], s0[i]);
          s1[i] = fmaf(q.z, k[2 * KT_LD + j1], s1[i]);
          s0[i] = fmaf(q.w, k[3 * KT_LD + j0], s0[i]);
          s1[i] = fmaf(q.w, k[3 * KT_LD + j1], s1[i]);
        }
      }
      float m[RI], p0[RI], p1[RI], l[RI], o[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        m[i] = fmaxf(has0 ? s0[i] : -INFINITY, has1 ? s1[i] : -INFINITY);
#pragma unroll
      for (int x = 16; x > 0; x >>= 1)
#pragma unroll
        for (int i = 0; i < RI; ++i)
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], x));
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        p0[i] = has0 ? expf(s0[i] - m[i]) : 0.f;
        p1[i] = has1 ? expf(s1[i] - m[i]) : 0.f;
        l[i] = p0[i] + p1[i];
        o[i] = 0.f;
      }
#pragma unroll
      for (int x = 16; x > 0; x >>= 1)
#pragma unroll
        for (int i = 0; i < RI; ++i)
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pj =
              __shfl_sync(0xffffffffu, j < 32 ? p0[i] : p1[i], j & 31);
          o[i] = fmaf(pj, Vh[(kb[i] + j) * DH + lane], o[i]);
        }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = r0 + RS * i;
        const float v = r < rows ? o[i] / l[i] : 0.f;
        O[r * CW + h * DH + lane] = v;
        if (SAVE && r < rows) s.o[(t.g0 + r) * CW + h * DH + lane] = v;
      }
    }
    __syncthreads();
  }

  // proj: B = x1 = x + m1 (O Wproj + bproj).
  {
    float acc[2][nbk(256)][4] = {};
    product<nbk(256)>(O, CW, slab(p.wproj, CW), CW, ring, mrows, acc);
    ring_fill<HC>(slab(p.w1, hid), 0, ring);
    for_acc<nbk(256)>(mrows, acc, [&](int r, int c, float v0, float v1) {
      const float a0 = v0 + p.bproj[c], a1 = v1 + p.bproj[c + 1];
      const float2 res = r < rows
          ? *reinterpret_cast<const float2*>(x + (size_t)r * CW + c)
          : make_float2(0.f, 0.f);
      st2(B + r * CW + c, res.x + sm1[r] * a0, res.y + sm1[r] * a1);
      if (SAVE && s.a != nullptr && r < rows)
        st2(s.a + (t.g0 + r) * CW + c, a0, a1);
    });
  }
  __syncthreads();
  // LN2: A = LN(x1).
  ln_rows(B, CW, A, CW, TR, rows, p.g2, p.b2, p.eps,
          SAVE ? s.h2 + t.g0 * CW : nullptr, SAVE ? stats + 2 * TR : nullptr,
          SAVE ? stats + 3 * TR : nullptr);

  // MLP in hidden chunks of HC: fc1 + GELU into O ([64, HC]), fc2 summed in
  // registers over the chunks.
  float acc2[2][nbk(CW)][4] = {};
  for (int ch = 0; ch < hid; ch += HC) {
    {
      float acc[2][nbk(128)][4] = {};
      product<nbk(128)>(A, CW, slab(p.w1 + ch, hid), CW, ring, mrows, acc);
      ring_fill<CW>(slab(p.w2 + (size_t)ch * CW, CW), 0, ring);
      for_acc<nbk(128)>(mrows, acc, [&](int r, int c, float v0, float v1) {
        const float h0 = v0 + p.bb1[ch + c], h1 = v1 + p.bb1[ch + c + 1];
        const float e0 = gelu_erf(h0), e1 = gelu_erf(h1);
        st2(O + r * HC + c, e0, e1);
        if (SAVE && r < rows) {
          st2(s.hh + (t.g0 + r) * hid + ch + c, h0, h1);
          st2(s.ge + (t.g0 + r) * hid + ch + c, e0, e1);
        }
      });
    }
    product<nbk(256)>(O, HC, slab(p.w2 + (size_t)ch * CW, CW), HC, ring, mrows,
               acc2);
    if (ch + HC < hid) ring_fill<HC>(slab(p.w1 + ch + HC, hid), 0, ring);
  }
  // fc2's reads of O end before mo is written there.
  __syncthreads();

  // A = y = x1 + m2 (fc2 + bb2); with s, O = mo.
  for_acc<nbk(256)>(mrows, acc2, [&](int r, int c, float v0, float v1) {
    const float o0 = v0 + p.bb2[c], o1 = v1 + p.bb2[c + 1];
    st2(A + r * CW + c, B[r * CW + c] + sm2[r] * o0,
        B[r * CW + c + 1] + sm2[r] * o1);
    if (SAVE) {
      st2(O + r * CW + c, o0, o1);
      if (s.mo != nullptr && r < rows)
        st2(s.mo + (t.g0 + r) * CW + c, o0, o1);
    }
  });
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
  float* ring = O + BUF;
  float* sm = ring + RING;  // the rows' two branch scales
  for (int c0 = Tiles::begin(p); c0 < Tiles::end(p); c0 += Tiles::per(p)) {
    const TileRows t = Tiles::at(p, c0);
    ring_fill<3 * 2 * DH>(qkv_slab(p, 0), 0, ring);
    row_scales(p, t, sm, sm + TR);
    forward_tile<false>(p, Save{}, t, A, B, O, ring, sm, sm + TR, nullptr);
    // The post-norm (or y itself) out.
    float* out = p.out + t.g0 * CW;
    if (p.gp != nullptr)
      ln_rows(A, CW, out, CW, t.rows, t.rows, p.gp, p.bp, p.post_eps);
    else
      for (int e = threadIdx.x; e < t.rows * CW; e += NT) out[e] = A[e];
    __syncthreads();
  }
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

// Offsets of the vector gradients in a CTA's partials (the wrapper's
// _block_vec_layout): g1, b1, bqkv, bproj, g2, b2, bb1, bb2, gp, bp.
struct VecLayout {
  int g1, b1, bqkv, bproj, g2, b2, bb1, bb2, gp, bp, len;
  __host__ __device__ explicit VecLayout(int hid)
      : g1(0), b1(CW), bqkv(2 * CW), bproj(5 * CW), g2(6 * CW), b2(7 * CW),
        bb1(8 * CW), bb2(8 * CW + hid), gp(9 * CW + hid),
        bp(10 * CW + hid), len(11 * CW + hid) {}
};

// A CTA's partial of a vector gradient: its first tile's sum, then each
// later tile's added in order (always by the same thread).
__device__ __forceinline__ void put(float* part, int at, float v,
                                    bool first) {
  part[at] = first ? v : part[at] + v;
}

// The backward's tile program (see the header): per tile of the CTA, the
// forward recomputed, then the gradient chain of the tile's rows.
__global__ void __launch_bounds__(NT, 1)
    block_bwd_f32_kernel(Args p, Save s, Bwd b) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* A = reinterpret_cast<float*>(smem);
  float* B = A + BUF;
  float* O = B + BUF;
  float* ring = O + BUF;
  float* rv = ring + RING;
  float *sm1 = rv, *sm2 = rv + TR;
  // LN1's and LN2's means and inverse deviations.
  float *mean1 = rv + 2 * TR, *inv1 = rv + 3 * TR;
  float *mean2 = rv + 4 * TR, *inv2 = rv + 5 * TR;
  float *meanp = rv + 6 * TR, *invp = rv + 7 * TR;
  float *dmr1 = rv + 8 * TR, *dmr2 = rv + 9 * TR;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = p.N, hid = p.hid;
  const bool masks = b.dm1 != nullptr;
  const VecLayout V(hid);
  float* part = b.part + (size_t)blockIdx.x * V.len;
  for (int c0 = Tiles::begin(p); c0 < Tiles::end(p); c0 += Tiles::per(p)) {
    const TileRows t = Tiles::at(p, c0);
    const int rows = t.rows, mrows = t.mrows;
    const bool first = c0 == Tiles::begin(p);

    ring_fill<3 * 2 * DH>(qkv_slab(p, 0), 0, ring);
    row_scales(p, t, sm1, sm2);
    forward_tile<true>(p, s, t, A, B, O, ring, sm1, sm2, mean1);
    // Now A = y, B = x1, O = mo.
    ring_fill<HC>(slab(b.w2T, hid), 0, ring);

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
        put(part, (c < CW ? V.gp : V.bp) + cc, acc, first);
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
      put(part, V.bb2 + c, acc, first);
    }
    __syncthreads();

    // MLP^T in hidden chunks: dhh = m2 (gy W2^T) gelu'(hh) into O ([64, HC])
    // and out, dbb1, and dh2 += dhh W1^T in registers.
    float dh2[2][nbk(CW)][4] = {};
    for (int ch = 0; ch < hid; ch += HC) {
      {
        float acc[2][nbk(128)][4] = {};
        product<nbk(128)>(A, CW, slab(b.w2T + ch, hid), CW, ring, mrows, acc);
        ring_fill<CW>(slab(b.w1T + (size_t)ch * CW, CW), 0, ring);
        for_acc<nbk(128)>(mrows, acc, [&](int r, int c, float v0, float v1) {
          float d0 = 0.f, d1 = 0.f;
          if (r < rows) {
            const size_t at = (t.g0 + r) * hid + ch + c;
            d0 = v0 * sm2[r] * gelu_grad(s.hh[at]);
            d1 = v1 * sm2[r] * gelu_grad(s.hh[at + 1]);
            st2(b.dhh + at, d0, d1);
          }
          st2(O + r * HC + c, d0, d1);
        });
      }
      __syncthreads();
      for (int c = tid; c < HC; c += NT) {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc += O[r * HC + c];
        put(part, V.bb1 + ch + c, acc, first);
      }
      product<nbk(256)>(O, HC, slab(b.w1T + (size_t)ch * CW, CW), HC, ring, mrows,
                 dh2);
      if (ch + HC < hid)
        ring_fill<HC>(slab(b.w2T + ch + HC, hid), 0, ring);
      else
        ring_fill<CW>(slab(b.wprojT, CW), 0, ring);
    }
    __syncthreads();

    // LN2^T: O = dh2; dg2, db2; A = dx1 = gy + LN2^T(dh2); the mask
    // gradients' row sums of dx1 a.
    for_acc<nbk(256)>(mrows, dh2, [&](int r, int c, float v0, float v1) {
      st2(O + r * CW + c, v0, v1);
    });
    __syncthreads();
    for (int c = tid; c < 2 * CW; c += NT) {
      const int cc = c % CW;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r)
        acc += c < CW ? O[r * CW + cc] * ((B[r * CW + cc] - mean2[r]) * inv2[r])
                      : O[r * CW + cc];
      put(part, (c < CW ? V.g2 : V.b2) + cc, acc, first);
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
      ln_bwd_row(h0, h1, normalised(x0, mean2[r], inv2[r]),
                 normalised(x1, mean2[r], inv2[r]), p.g2, inv2[r], d0,
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
      put(part, V.bproj + c, acc, first);
    }
    // Head h's rows of Wq^T, Wk^T or Wv^T (part 0, 1, 2) in Wqkv^T
    // [768, 256].
    auto wqkvT_slab = [&](int part, int h) {
      return slab(b.wqkvT + (size_t)(part * CW + h * DH) * CW, CW);
    };
    {
      float acc[2][nbk(256)][4] = {};
      product<nbk(256)>(A, CW, slab(b.wprojT, CW), CW, ring, mrows, acc);
      ring_fill<CW>(wqkvT_slab(0, 0), 0, ring);
      for_acc<nbk(256)>(mrows, acc, [&](int r, int c, float v0, float v1) {
        st2(O + r * CW + c, v0 * sm1[r], v1 * sm1[r]);
      });
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
    float dh1[2][nbk(CW)][4] = {};
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
      // dq (and P, dS) for RIB rows a warp at once, as the forward's
      // attention.
      for (int r0 = warp; r0 < RSB; r0 += NW) {
        int kb[RIB], j0[RIB], j1[RIB];
        float s0[RIB], s1[RIB], dp0[RIB], dp1[RIB];
#pragma unroll
        for (int i = 0; i < RIB; ++i) {
          const int r = r0 + RSB * i;
          kb[i] = r < rows ? r / N * N : 0;
          j0[i] = kb[i] + min(lane, N - 1);
          j1[i] = kb[i] + min(lane + 32, N - 1);
          s0[i] = s1[i] = dp0[i] = dp1[i] = 0.f;
        }
        const bool has0 = lane < N, has1 = lane + 32 < N;
#pragma unroll 2
        for (int d = 0; d < DH; d += 4) {
#pragma unroll
          for (int i = 0; i < RIB; ++i) {
            const int r = r0 + RSB * i;
            const float4 q = *reinterpret_cast<const float4*>(Qh + r * DH + d);
            const float4 od =
                *reinterpret_cast<const float4*>(O + r * CW + h * DH + d);
            const float* k = KT + d * KT_LD;
            const float* v0 = Vh + j0[i] * V_LD + d;
            const float* v1 = Vh + j1[i] * V_LD + d;
            s0[i] = fmaf(q.x, k[j0[i]], s0[i]);
            s1[i] = fmaf(q.x, k[j1[i]], s1[i]);
            s0[i] = fmaf(q.y, k[KT_LD + j0[i]], s0[i]);
            s1[i] = fmaf(q.y, k[KT_LD + j1[i]], s1[i]);
            s0[i] = fmaf(q.z, k[2 * KT_LD + j0[i]], s0[i]);
            s1[i] = fmaf(q.z, k[2 * KT_LD + j1[i]], s1[i]);
            s0[i] = fmaf(q.w, k[3 * KT_LD + j0[i]], s0[i]);
            s1[i] = fmaf(q.w, k[3 * KT_LD + j1[i]], s1[i]);
            dp0[i] = fmaf(od.x, v0[0], dp0[i]);
            dp1[i] = fmaf(od.x, v1[0], dp1[i]);
            dp0[i] = fmaf(od.y, v0[1], dp0[i]);
            dp1[i] = fmaf(od.y, v1[1], dp1[i]);
            dp0[i] = fmaf(od.z, v0[2], dp0[i]);
            dp1[i] = fmaf(od.z, v1[2], dp1[i]);
            dp0[i] = fmaf(od.w, v0[3], dp0[i]);
            dp1[i] = fmaf(od.w, v1[3], dp1[i]);
          }
        }
        float m[RIB], p0[RIB], p1[RIB], l[RIB], D[RIB];
#pragma unroll
        for (int i = 0; i < RIB; ++i)
          m[i] = fmaxf(has0 ? s0[i] : -INFINITY, has1 ? s1[i] : -INFINITY);
#pragma unroll
        for (int x = 16; x > 0; x >>= 1)
#pragma unroll
          for (int i = 0; i < RIB; ++i)
            m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], x));
#pragma unroll
        for (int i = 0; i < RIB; ++i) {
          p0[i] = has0 ? expf(s0[i] - m[i]) : 0.f;
          p1[i] = has1 ? expf(s1[i] - m[i]) : 0.f;
          l[i] = p0[i] + p1[i];
        }
#pragma unroll
        for (int x = 16; x > 0; x >>= 1)
#pragma unroll
          for (int i = 0; i < RIB; ++i)
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
#pragma unroll
        for (int i = 0; i < RIB; ++i) {
          p0[i] /= l[i];
          p1[i] /= l[i];
          D[i] = p0[i] * dp0[i] + p1[i] * dp1[i];
        }
#pragma unroll
        for (int x = 16; x > 0; x >>= 1)
#pragma unroll
          for (int i = 0; i < RIB; ++i)
            D[i] += __shfl_xor_sync(0xffffffffu, D[i], x);
        float ds0[RIB], ds1[RIB], dq[RIB];
#pragma unroll
        for (int i = 0; i < RIB; ++i) {
          const int r = r0 + RSB * i;
          ds0[i] = has0 ? p0[i] * (dp0[i] - D[i]) : 0.f;
          ds1[i] = has1 ? p1[i] * (dp1[i] - D[i]) : 0.f;
          dq[i] = 0.f;
          if (r < rows) {
            if (has0) {
              P[r * TR + lane] = p0[i];
              dS[r * TR + lane] = ds0[i];
            }
            if (has1) {
              P[r * TR + lane + 32] = p1[i];
              dS[r * TR + lane + 32] = ds1[i];
            }
          }
        }
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int i = 0; i < RIB; ++i) {
            const float dsj =
                __shfl_sync(0xffffffffu, j < 32 ? ds0[i] : ds1[i], j & 31);
            dq[i] = fmaf(dsj, KT[lane * KT_LD + kb[i] + j], dq[i]);
          }
#pragma unroll
        for (int i = 0; i < RIB; ++i) {
          const int r = r0 + RSB * i;
          DQ[r * DH + lane] = r < rows ? dq[i] * p.qscale : 0.f;
        }
      }
      __syncthreads();
      // dk, dv: key row r sums over its clip's query rows, RI key rows a
      // warp at once.
      for (int r0 = warp; r0 < RSB; r0 += NW) {
        int kb[RIB], jl[RIB];
        float dk[RIB], dv[RIB];
#pragma unroll
        for (int i = 0; i < RIB; ++i) {
          const int r = r0 + RSB * i;
          kb[i] = r < rows ? r / N * N : 0;
          jl[i] = r - kb[i];
          dk[i] = dv[i] = 0.f;
        }
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int i = 0; i < RIB; ++i) {
            const int q = kb[i] + n;
            dk[i] = fmaf(dS[q * TR + jl[i]], Qh[q * DH + lane], dk[i]);
            dv[i] = fmaf(P[q * TR + jl[i]], O[q * CW + h * DH + lane], dv[i]);
          }
#pragma unroll
        for (int i = 0; i < RIB; ++i) {
          const int r = r0 + RSB * i;
          DK[r * DH + lane] = r < rows ? dk[i] : 0.f;
          DV[r * DH + lane] = r < rows ? dv[i] : 0.f;
        }
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
        put(part, V.bqkv + c / DH * CW + h * DH + d, acc, first);
      }
      // dh1 += dq Wq^T + dk Wk^T + dv Wv^T over the head's rows of Wqkv^T.
      for (int part = 0; part < 3; ++part) {
        product<nbk(256)>(DQ + part * TR * DH, DH, wqkvT_slab(part, h), DH,
                          ring, mrows, dh1);
        if (part < 2)
          ring_fill<CW>(wqkvT_slab(part + 1, h), 0, ring);
        else if (h + 1 < NH)
          ring_fill<CW>(wqkvT_slab(0, h + 1), 0, ring);
      }
      __syncthreads();
    }

    // LN1^T: O = dh1; dg1, db1; dx = dx1 + LN1^T(dh1).
    for_acc<nbk(256)>(mrows, dh1, [&](int r, int c, float v0, float v1) {
      st2(O + r * CW + c, v0, v1);
    });
    __syncthreads();
    const float* x = p.x + t.g0 * CW;
    for (int c = tid; c < 2 * CW; c += NT) {
      const int cc = c % CW;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r)
        acc += c < CW ? O[r * CW + cc] * ((x[r * CW + cc] - mean1[r]) * inv1[r])
                      : O[r * CW + cc];
      put(part, (c < CW ? V.g1 : V.b1) + cc, acc, first);
    }
    for (int r = warp; r < rows; r += NW) {
      float4 h0, h1, x0, x1, d0, d1, e0, e1;
      load_row(O + r * CW, h0, h1);
      load_row(x + r * CW, x0, x1);
      ln_bwd_row(h0, h1, normalised(x0, mean1[r], inv1[r]),
                 normalised(x1, mean1[r], inv1[r]), p.g1, inv1[r], d0,
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
    __syncthreads();
  }
}

}  // namespace bf32

// Host entry points.

static bool fill_args(bf32::Args& a, void* const* p, int clips, int N,
                      int hid, float eps, float post_eps, float qscale,
                      int ctas) {
  using namespace bf32;
  if (clips <= 0 || N <= 0 || N > TR || hid <= 0 || hid % HC) return false;
  const int cpt = TR / N;
  if (ctas <= 0 || ctas > (clips + cpt - 1) / cpt) return false;
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
// 128, on `ctas` persistent CTAs (1 .. the tiles of whole clips). ptrs: x,
// out, wqkv [256, 768], wproj [256, 256], w1 [256, hid], w2 [hid, 256]
// (f32, [in, out] as the parameters are), g1, b1, bqkv, bproj, g2, b2, bb1,
// bb2, gp, bp (gp and bp null without a post-norm), m1, m2 (per-clip
// [clips] branch scales; both null without masks).
extern "C" int pmce_block_fwd_f32(void* const* ptrs, int clips, int N,
                                  int hid, float eps, float post_eps,
                                  float qscale, int ctas, void* stream) {
  using namespace bf32;
  Args a;
  if (!fill_args(a, ptrs, clips, N, hid, eps, post_eps, qscale, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<float*>(ptrs[1]);
  cudaError_t e = cudaFuncSetAttribute(
      block_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  block_fwd_f32_kernel<<<ctas, NT, FWD_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The f32 backward: dx, the 14 parameter gradients and, with dm1 / dm2,
// the per-clip mask gradients, in three launches (the transposes, the
// tile program on `ctas` persistent CTAs, the weight gradients). ptrs: 0-17
// as the forward's (1: the output's gradient gout [clips, N, 256]); the
// workspace 18-21 wqkv^T, wproj^T, w1^T, w2^T; 22-29 h1, qkv, o, h2 [M,
// 256 / 768], hh, ge [M, hid], a, mo (both null without mask gradients);
// 30-33 dqkv, da, dhh, m2g; 34 dx; 35 the CTAs' vector partials [ctas, 11 *
// 256 + hid]; 36-37 dm1, dm2 [clips] (null: not owed); 38 the weight
// gradients' range partials [splits, tiles of 64 x 64, 4096]; 39-42 dwqkv,
// dwproj, dw1, dw2; 43 the vector gradients [11 * 256 + hid] (the layout
// of VecLayout).
extern "C" int pmce_block_bwd_f32(void* const* ptrs, int clips, int N,
                                  int hid, float eps, float post_eps,
                                  float qscale, int splits, int ctas,
                                  void* stream) {
  using namespace bf32;
  Args a;
  if (!fill_args(a, ptrs, clips, N, hid, eps, post_eps, qscale, ctas) ||
      splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  Save s = {f(22), f(23), f(24), f(25), f(26), f(27), f(28), f(29)};
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
  block_bwd_f32_kernel<<<ctas, NT, BWD_SMEM, st>>>(a, s, b);
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
  J.vtiles = ctas;
  J.vlen = VecLayout(hid).len;
  return static_cast<int>(f32ops::launch_wgrad(J, st));
}

PMCE_EXPORT_ERROR_STRING(pmce_block_f32_error_string)
