// The decoder blocks' f32 programs on the tensor cores (rows 8f-11f:
// csrc/ada_f32.cu, csrc/ca_f32.cu), forwards and backwards: the rows
// program (AdaLN, then the q, k, v products), the attention's three passes
// (the forward, the query side's dq, the key side's dk and dv), the
// forward's tail and the backward's tail with its gradient chain, and every
// row product in 3xTF32 (mma.sync m16n8k8; common.cuh's tc32), from
// operands staged once a CTA.
//
// Numerics. An f32 operand is split as hi = tf32(v) (to nearest, ties
// away) and lo = v - hi; a product sums a_lo b_hi + a_hi b_lo + a_hi b_hi.
// Each 8-wide k-step is summed from zero in the tensor cores and added to
// the f32 accumulator by an ordinary rounded add: the tensor cores add with
// truncation, and summing a whole K in them biased csrc/block_f32.cu's
// outputs past the f32 Stage-2 step's gate. The CPU model of these products
// over the plain blocks (tests/test_torch_port_dec_f32_redesign.py,
// tests/test_torch_port_dec_f32_fwd_redesign.py: the AdaLN block at [4,
// 431, 64] in 2 heads of 32, the CA block both ways, hid 256, masks) errs
// <= 7.5e-7 (outputs) and <= 1.1e-6 (gradients) of the plain blocks' f32,
// inside the card's 1e-5 / 1e-4; one TF32 pass errs 2.8e-4 / 6.7e-4. The
// weight gradients (f32_ops.cuh's launch_wgrad, shared with rows 5f / 7f)
// and mma3 are f32_ops.cuh's, in the same 3xTF32; row 4f / 5f's programs
// (csrc/mhsa_f32.cu) run on these tiles and fragments too.
//
// The warp's tile. A warp owns 16 rows of its side and all C = 64 columns,
// held in registers in the accumulator layout of mma.sync (a Tile, float
// [8][4]: t[nb][0..1] at row g = lane / 4, columns 8 nb + 2 (lane % 4) + {0,
// 1}; t[nb][2..3] the same columns of row g + 8). A row's sums are the
// quad's (4 lanes') sums; column sums over the warp's rows are shuffles
// across g. A Tile is also an A operand: the k index of an 8-wide step is
// permuted (position j < 4 <-> column 2 j, j + 4 <-> 2 j + 1), and the B
// operand is read in the same order, so that every product sums each k once
// and no fragment needs a shuffle. The softmax's P and dS, computed in the
// accumulator layout, feed P.V, dS.K, P^T.dO and dS^T.Q the same way
// (FlashAttention-2's register-resident tiles).
//
// Staged operands. Weights (64 x 64 blocks of W, W^T or the transposed
// copies) and the streamed side's 64-row chunks (k and v; or q, dO and the
// per-head max, sum and D) go through a 2-stage ring filled by cp.async
// from all threads: one copy a CTA, read by all 8 warps; the next item's
// copies are issued as soon as every warp has left the stage they overwrite
// (one block barrier an item), so they land behind the current item's
// products. A block is [64][64] floats, element (r, c) at r 64 + (c ^ 8
// ((r ^ r / 2) % 4)): the two fragment reads, (row 8 n + g, columns 8 k +
// 2 t + {0, 1}) as one 8-byte load and (rows 8 k + 2 t + {0, 1}, column 8 n
// + g), fall on 32 distinct banks.
//
// The forward (rows 8f / 10f) is three programs: rows (AdaLN and the
// products of qkv, or of k and v; the backward's recompute launches the
// same program, so both see the same q, k, v bits), the attention (CA: q
// computed in it), the tail (proj, x1, AdaLN2, the MLP, y). The attention
// and the tail stay two programs over the same tiles, o handed over through
// the workspace, for two reasons: a split short side's tail merges every
// split's partials, which only a launch boundary orders, and the attention
// alone holds 206-254 registers (below), so the tail's tiles on top of it
// would spill. The forward keeps nothing for the gradient.
//
// The backward's query side runs as three programs over the same tiles, so
// that each holds only its own tiles in registers (one program spilled):
// the attention, the tail with the gradient chain, dq. The tail holds no
// tile over a product: its A operands (o, h2, gy, dhh, da) are stashed in
// shared memory a warp's 16 rows at a time and read a k-step at a time.
//
// Shared memory (bytes; each program's list of staged items 1,024): the
// rows program 66,560 (the ring 2 x 16,384: one block a stage; the stash of
// h 8 x 4,096); the attention 66,560 (the ring 2 x 32,768: two blocks a
// stage); the forward's tail 132,096 (the ring; three stashes 8 x 4,096
// each: x1, o then h2, gelu(hh)); the
// backward's tail 181,376 (the ring; three stashes 8 x 4,096 each: a, kept
// for dm1 and x1's recompute, gy, the current product's A; the warps'
// column partials 8 x 2,064); dq 78,848 (the ring; the rows' max, sum and D
// 8 x 1,536); the key program 78,848 (the ring 2 x 38,912: q and dO chunks
// and their rows' statistics); the finishing program 46,080 at 8 warps (the
// ring 2 x 16,384, the column partials 8 x 1,536), 35,328 at one. One CTA
// an SM (the wrappers' plan assumes no more).
//
// Registers (ptxas -v, sm_90a; 256 threads a CTA, so up to 255; heads of
// 32 / 8): the rows program 125; the attention 206 / 238 (ada_f32.cu), 254
// / 254 (ca_f32.cu, which computes q); the forward's tail 155 / 158; the
// backward's tail 170 / 171; dq 254 / 222; the key program 246 / 196; the
// finishing program 180; every program 0 bytes of stack, spill stores and
// loads (builds of row 7f that spilled faulted on the card).
//
// Grids: every program is persistent, min(work items, ctas) CTAs, CTA i
// taking the items [n i / G, n (i + 1) / G) of the clip-major list (the
// wrappers' f32_dec_plan and f32_dec_fwd_plan, ctas = the card's SMs). A
// long side's items are tiles of 128 rows (8 warps x 16); a CA block's
// short side (the smaller, one tile) is split over the long side instead in
// the attention programs: `splits` CTAs a clip, split s taking the long
// side's 64-row chunks [n s / S, n (s + 1) / S), their partials merged in
// order of s by a later launch (the forward's tail, a CTA a clip; the
// backward's tail, in every split, its own copy of o and hh; split 0's
// kept). No atomics: a rerun gives the same bits.
#pragma once

#include "f32_ops.cuh"

namespace f32ops {
namespace dtc {

using tc32::cp_async16;
using tc32::cp_async4;
using tc32::cp_async_commit;
using tc32::cp_async_wait_all;
using tc32::mma_tf32;
using tc32::split_tf32;

constexpr int C = 64;          // channels
constexpr int NT = 256;        // threads a CTA (query and key sides)
constexpr int NW = NT / 32;    // their warps
constexpr int RB = 16;         // rows of a warp
constexpr int TRT = NW * RB;   // rows of a long side's tile
constexpr int KC = 64;         // rows of a streamed chunk
constexpr int BLK = KC * C;    // floats of a staged block
constexpr int HMAX = 8;        // the most heads
constexpr int STATS = 3 * HMAX * KC;  // a query chunk's max, sum and D
constexpr int QSLOT = 2 * BLK;        // a stage of the query side's
constexpr int KSLOT = 2 * BLK + STATS;  // of the key program
constexpr int FSLOT = BLK;            // of the finishing program
// The tail's partial row: dbproj, dbb1 [hid], dbb2, dgamma2, dbeta2,
// dm1, dm2.
__host__ __device__ constexpr int qpart_len(int hid) { return 4 * C + hid + 2; }
constexpr int QPART_MAX = 4 * C + 256 + 4;  // hid <= 256, padded
constexpr int FPART_MAX = 6 * C;
// The programs' shared memory, in floats up to each one's list of staged
// items (Ring), then in bytes.
constexpr int QT_TAB = 2 * QSLOT + 3 * NW * RB * C + NW * QPART_MAX;
constexpr int QD_TAB = 2 * QSLOT + NW * 3 * HMAX * RB;
constexpr int QTAB_BYTES = 16 * 64;  // QTAB Items
constexpr int QA_SMEM = 2 * QSLOT * 4 + QTAB_BYTES;
constexpr int QT_SMEM = QT_TAB * 4 + QTAB_BYTES;
constexpr int QD_SMEM = QD_TAB * 4 + QTAB_BYTES;
constexpr int K_SMEM = 2 * KSLOT * 4 + QTAB_BYTES;
constexpr int R_TAB = 2 * FSLOT + NW * RB * C;
constexpr int R_SMEM = R_TAB * 4 + QTAB_BYTES;
constexpr int QF_TAB = 2 * FSLOT + 3 * NW * RB * C;
constexpr int QF_SMEM = QF_TAB * 4 + QTAB_BYTES;
__host__ __device__ constexpr int f_smem(int warps) {
  return (2 * FSLOT + warps * FPART_MAX) * 4 + QTAB_BYTES;
}
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// gelu(v) into ge and d gelu(v) / dv returned, the exact (erf) GELU's
// (common.cuh's gelu_erf and its derivative) from one erff.
__device__ __forceinline__ float gelu_and_grad(float v, float& ge) {
  const float e = erff(v * 0.70710678118654752f);
  ge = 0.5f * v * (1.0f + e);
  const float cdf = 0.5f * (1.0f + e);
  return cdf + v * (expf(-0.5f * v * v) * 0.39894228040143268f);
}

// ---------------------------------------------------------------------------
// Tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ int swz(int r) {
  return ((r ^ (r >> 1)) & 3) << 3;
}
__device__ __forceinline__ int sat(int r, int c) {
  return r * C + (c ^ swz(r));
}

__device__ __forceinline__ void zero(float (&v)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[nb][e] = 0.f;
}

// Rows [0, valid) of the warp's 16 from a [*, ld] array (its first row at
// base); the others zero.
__device__ __forceinline__ void load_tile(const float* base, int ld,
                                          int valid, float (&v)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float2 f = make_float2(0.f, 0.f);
      if (r < valid)
        f = *reinterpret_cast<const float2*>(base + (size_t)r * ld + 8 * nb +
                                             2 * t);
      v[nb][2 * hf] = f.x;
      v[nb][2 * hf + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store_tile(float* base, int ld, int valid,
                                           const float (&v)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    if (r >= valid) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<float2*>(base + (size_t)r * ld + 8 * nb + 2 * t) =
          make_float2(v[nb][2 * hf], v[nb][2 * hf + 1]);
  }
}

__device__ __forceinline__ void mask_rows(float (&v)[8][4], int valid) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    if (g >= valid) v[nb][0] = v[nb][1] = 0.f;
    if (g + 8 >= valid) v[nb][2] = v[nb][3] = 0.f;
  }
}

// v[nb][e] += vec[c] for the lane's columns c (a per-column vector).
__device__ __forceinline__ void add_cols(float (&v)[8][4], const float* vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const float2 b = *reinterpret_cast<const float2*>(vec + 8 * nb + 2 * t);
    v[nb][0] += b.x; v[nb][1] += b.y; v[nb][2] += b.x; v[nb][3] += b.y;
  }
}

// A tile to the warp's 1,024 floats of shared memory (lane-major:
// no bank conflicts).
__device__ __forceinline__ void stash(float* s, const float (&v)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[(nb * 4 + e) * 32 + lane] = v[nb][e];
}

// v += scale * the warp's stashed tile.
__device__ __forceinline__ void add_stash(float (&v)[8][4], const float* s,
                                          float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[nb][e] += scale * s[(nb * 4 + e) * 32 + lane];
}

// v += the tile of a [*, ld] array at base, a pair of values at a time
// (no second tile in registers).
__device__ __forceinline__ void add_tile(float (&v)[8][4], const float* base,
                                         int ld, int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    if (r >= valid) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 u = *reinterpret_cast<const float2*>(
          base + (size_t)r * ld + 8 * nb + 2 * t);
      v[nb][2 * hf] += u.x;
      v[nb][2 * hf + 1] += u.y;
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

// The sums of rows g (s[0]) and g + 8 (s[1]) over the tile's 64 columns.
__device__ __forceinline__ void row_sums(const float (&v)[8][4],
                                         float (&s)[2]) {
  s[0] = s[1] = 0.f;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    s[0] += v[nb][0] + v[nb][1];
    s[1] += v[nb][2] + v[nb][3];
  }
  s[0] = quad_sum(s[0]);
  s[1] = quad_sum(s[1]);
}

// The warp's sum of the rows' values s[0] (row g), s[1] (row g + 8).
__device__ __forceinline__ float warp_rows_total(const float (&s)[2]) {
  float v = s[0] + s[1];
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  return v + __shfl_xor_sync(FULL, v, 16);
}

// cs[c] = the sum of column c over the warp's 16 rows (rows g, g + 8 added,
// then g = 0 .. 7 by shuffles).
__device__ __forceinline__ void col_sums(const float (&v)[8][4], float* cs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[nb][e] + v[nb][e + 2];
      s += __shfl_xor_sync(FULL, s, 4);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (g == 0) cs[8 * nb + 2 * t + e] = s;
    }
}

// A row's AdaLN statistics: the mean, sigma (the unbiased standard
// deviation, centred) and inv = 1 / (sigma + eps), eps outside the sqrt.
__device__ __forceinline__ void row_stats(const float (&v)[8][4], float eps,
                                          float (&mean)[2], float (&sigma)[2],
                                          float (&inv)[2]) {
  float s[2];
  row_sums(v, s);
  mean[0] = s[0] * (1.f / C);
  mean[1] = s[1] * (1.f / C);
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float u = v[nb][e] - mean[e >> 1];
      q[e >> 1] += u * u;
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sigma[hf] = sqrtf(quad_sum(q[hf]) * (1.f / (C - 1)));
    inv[hf] = 1.f / (sigma[hf] + eps);
  }
}

// y = g (x - mean) inv + b, a row at a time (g, b: the clip's vectors).
__device__ __forceinline__ void adaln_tile(const float (&x)[8][4],
                                           const float* gm, const float* bt,
                                           float eps, float (&y)[8][4]) {
  const int t = threadIdx.x & 3;
  float mean[2], sigma[2], inv[2];
  row_stats(x, eps, mean, sigma, inv);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const float2 gg = *reinterpret_cast<const float2*>(gm + 8 * nb + 2 * t);
    const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * nb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gv = e & 1 ? gg.y : gg.x, bv = e & 1 ? bb.y : bb.x;
      y[nb][e] = gv * ((x[nb][e] - mean[e >> 1]) * inv[e >> 1]) + bv;
    }
  }
}

// AdaLN's backward from dy with x's statistics: du = g dy inv - u inv^2
// sum(g dy u) / ((C - 1) sigma), dx = du - mean(du) (sigma clamped away
// from 0); pg = dy u inv (dgamma's terms; pg may be dy itself).
__device__ __forceinline__ void adaln_bwd_tile(const float (&x)[8][4],
                                               const float (&dy)[8][4],
                                               const float* gm, float eps,
                                               float (&dx)[8][4],
                                               float (&pg)[8][4]) {
  const int t = threadIdx.x & 3;
  float mean[2], sigma[2], inv[2];
  row_stats(x, eps, mean, sigma, inv);
  float sp[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const float2 gg = *reinterpret_cast<const float2*>(gm + 8 * nb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      const float u = x[nb][e] - mean[hf];
      const float a = dy[nb][e] * (e & 1 ? gg.y : gg.x);
      sp[hf] += a * u;
      dx[nb][e] = a;  // g dy, for now
      pg[nb][e] = dy[nb][e] * (u * inv[hf]);
    }
  }
  float k[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    k[hf] = inv[hf] * inv[hf] * quad_sum(sp[hf]) * (1.f / (C - 1)) /
            fmaxf(sigma[hf], 1e-20f);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      dx[nb][e] = dx[nb][e] * inv[hf] - (x[nb][e] - mean[hf]) * k[hf];
    }
  float m[2];
  row_sums(dx, m);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dx[nb][e] -= m[e >> 1] * (1.f / C);
}

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

// A fragment of k-step kb from an accumulator-layout value set (row g:
// f0, f1 at positions t, t + 4; row g + 8: f2, f3), split.
__device__ __forceinline__ void a_frag(float f0, float f1, float f2, float f3,
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  split_tf32(f0, hi[0], lo[0]);
  split_tf32(f2, hi[1], lo[1]);
  split_tf32(f1, hi[2], lo[2]);
  split_tf32(f3, hi[3], lo[3]);
}

// mma3 (d += a k-step's three products, summed from zero, then one
// rounded add): f32_ops.cuh's.

// B of k-step kb, n-block nb from a staged block read as W[k][n] (rows 8 kb
// + 2 t, + 1; column 8 nb + g). The swizzle of rows 8 kb + 2 t (+ 1)
// depends on t alone, so the address is a lane's base, one of 4 lane
// offsets and an immediate (no per-(kb, nb) offsets kept in registers).
__device__ __forceinline__ void b_kn(const float* W, int kb, int nb,
                                     float& b0, float& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = ((2 * t) ^ t) & 3, q1 = ((2 * t + 1) ^ t) & 3;
  const float* w = W + 512 * kb + 128 * t + 32 * (nb >> 2) + g;
  b0 = w[8 * ((nb & 3) ^ q0)];
  b1 = w[C + 8 * ((nb & 3) ^ q1)];
}

// B of k-step kb, n-block nb from a staged block read as X[n][k] (row 8 nb
// + g, columns 8 kb + 2 t, + 1: one 8-byte load; the row's swizzle depends
// on g alone).
__device__ __forceinline__ void b_nk(const float* X, int kb, int nb,
                                     float& b0, float& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q = (g ^ (g >> 1)) & 3;
  const float2 v = *reinterpret_cast<const float2*>(
      X + 512 * nb + C * g + 2 * t + 32 * (kb >> 2) + 8 * ((kb & 3) ^ q));
  b0 = v.x;
  b1 = v.y;
}

// out += (k-step kb's A fragment) W's rows 8 kb .. 8 kb + 7.
__device__ __forceinline__ void mm_kstep(const unsigned (&ah)[4],
                                         const unsigned (&al)[4],
                                         const float* W, int kb,
                                         float (&out)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    float b0, b1;
    b_kn(W, kb, nb, b0, b1);
    mma3(out[nb], ah, al, b0, b1);
  }
}

// out += A W over all 64 k of a staged weight block.
__device__ __forceinline__ void mm_tile(const float (&A)[8][4], const float* W,
                                        float (&out)[8][4]) {
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    unsigned ah[4], al[4];
    a_frag(A[kb][0], A[kb][1], A[kb][2], A[kb][3], ah, al);
    mm_kstep(ah, al, W, kb, out);
  }
}

// The same with A the warp's stashed tile (see stash): its fragments read
// from shared memory a k-step at a time (a loop, not unrolled: neither the
// tile nor eight steps' loads are held in registers).
__device__ __forceinline__ void mm_stashed(const float* s, const float* W,
                                           float (&out)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int kb = 0; kb < 8; ++kb) {
    const float* a = s + kb * 4 * 32 + lane;
    unsigned ah[4], al[4];
    a_frag(a[0], a[32], a[64], a[96], ah, al);
    mm_kstep(ah, al, W, kb, out);
  }
}

// ---------------------------------------------------------------------------
// The staging ring
// ---------------------------------------------------------------------------

// One staged item: one or two [64][64] blocks (rows past `rows` zero) and,
// for the key program, the rows' per-head max, sum and D ([rows][heads] in
// device memory; rows past `rows`: 0, 1, 0).
struct Item {
  const float *a, *b;
  int lda, ldb, rows;
  const float *m, *l, *d;
  int heads;
};

__device__ __forceinline__ Item block_item(const float* w, int ld) {
  Item it = {};
  it.a = w;
  it.lda = ld;
  it.rows = KC;
  return it;
}

template <int SLOT>
struct Pipe {
  float* buf;
  int slot;

  __device__ void issue(const Item& it, float* dst) const {
    constexpr int PER = KC * C / 4;  // 16-byte chunks of a block
    const int n = (it.b != nullptr ? 2 : 1) * PER;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int w = e >= PER ? 1 : 0;
      const int e2 = e - w * PER;
      const int r = e2 >> 4, c4 = (e2 & 15) << 2;
      float* d = dst + w * BLK + sat(r, c4);
      if (r < it.rows)
        cp_async16(d, (w ? it.b : it.a) + (size_t)r * (w ? it.ldb : it.lda) +
                          c4);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (it.m != nullptr) {
      float* st = dst + 2 * BLK;
      const int per = it.heads * KC;
      for (int e = threadIdx.x; e < 3 * per; e += blockDim.x) {
        const int k = e / per, h = e % per / KC, i = e % KC;
        const float* src = k == 0 ? it.m : k == 1 ? it.l : it.d;
        float* dd = st + (k * HMAX + h) * KC + i;
        if (i < it.rows)
          cp_async4(dd, src + (size_t)i * it.heads + h);
        else
          *dd = k == 1 ? 1.f : 0.f;
      }
    }
    cp_async_commit();
  }

  __device__ void start(const Item& it) {
    slot = 0;
    issue(it, buf);
  }

  // Wait for the current item (every thread's copies, then a block
  // barrier), issue `after` (or nothing) into the other stage, and return
  // the current stage.
  __device__ const float* next(const Item* after) {
    cp_async_wait_all();
    __syncthreads();
    if (after != nullptr) issue(*after, buf + (slot ^ 1) * SLOT);
    const float* cur = buf + slot * SLOT;
    slot ^= 1;
    return cur;
  }
};

// The CTA's items [begin, end) of n (a contiguous share).
__device__ __forceinline__ void share(int n, int& begin, int& end) {
  begin = (int)((long long)n * blockIdx.x / gridDim.x);
  end = (int)((long long)n * (blockIdx.x + 1) / gridDim.x);
}

// The split s of S over n chunks: [n s / S, n (s + 1) / S).
__device__ __forceinline__ void split_range(int n, int s, int S, int& c0,
                                            int& c1) {
  c0 = n * s / S;
  c1 = n * (s + 1) / S;
}

// The tile's per-warp column partials summed over the warps in order into
// out [len]; zeros with !keep. Every thread calls it.
__device__ __forceinline__ void flush_parts(const float* cs, int len,
                                            bool keep, float* out) {
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    float s = 0.f;
    if (keep)
      for (int w = 0; w < warps; ++w) s += cs[w * len + e];
    out[e] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void zero_row(float* cs, int len) {
  for (int e = threadIdx.x & 31; e < len; e += 32) cs[e] = 0.f;
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Attention, a warp's 16 rows and every head
// ---------------------------------------------------------------------------

// The forward over one staged chunk of kc keys (K at kv, V at kv + BLK):
// the online softmax's max m and sum l (per head, rows g and g + 8) and O
// (unnormalised; rescaled as the max grows), Q scaled.
template <int H>
__device__ __forceinline__ void attn_fwd_chunk(const float (&Q)[8][4],
                                               const float* kv, int kc,
                                               float (&O)[8][4],
                                               float (&m)[H][2],
                                               float (&l)[H][2]) {
  constexpr int KB = C / H / 8;  // k-steps (column blocks) of a head
  const float* K = kv;
  const float* V = kv + BLK;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float S[8][4];
    zero(S);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const int cb = h * KB + kb;
      unsigned ah[4], al[4];
      a_frag(Q[cb][0], Q[cb][1], Q[cb][2], Q[cb][3], ah, al);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (8 * nb >= kc) break;
        float b0, b1;
        b_nk(K, cb, nb, b0, b1);
        mma3(S[nb], ah, al, b0, b1);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * nb + 2 * t + (e & 1) >= kc) S[nb][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], S[nb][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mn = fmaxf(m[h][hf], quad_max(mx[hf]));
      alpha[hf] = expf(m[h][hf] - mn);
      m[h][hf] = mn;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[nb][e] = expf(S[nb][e] - m[h][e >> 1]);
        sum[e >> 1] += S[nb][e];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      l[h][hf] = l[h][hf] * alpha[hf] + quad_sum(sum[hf]);
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[h * KB + j][e] *= alpha[e >> 1];
    // O += P V: k over the chunk's keys (8 a step).
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      if (8 * kb >= kc) break;
      unsigned ah[4], al[4];
      a_frag(S[kb][0], S[kb][1], S[kb][2], S[kb][3], ah, al);
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float b0, b1;
        b_kn(V, kb, h * KB + j, b0, b1);
        mma3(O[h * KB + j], ah, al, b0, b1);
      }
    }
  }
}

// The per-head statistics of the warp's rows in shared memory: st[(k * HMAX
// + h) * RB + row], k = 0 max, 1 sum, 2 D.
__device__ __forceinline__ float& stat_at(float* st, int k, int h, int r) {
  return st[(k * HMAX + h) * RB + r];
}

// The query side's gradient over one staged chunk of kc keys: dQ += dS K,
// dS = P (dP - D), P = exp(S - M) / L from Q (scaled) and the rows'
// statistics, dP = dO V^T.
template <int H>
__device__ __forceinline__ void attn_dq_chunk(const float (&Q)[8][4],
                                              const float (&dO)[8][4],
                                              const float* st,
                                              const float* kv, int kc,
                                              float (&dQ)[8][4]) {
  constexpr int KB = C / H / 8;
  const float* K = kv;
  const float* V = kv + BLK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float M0 = st[(0 * HMAX + h) * RB + g];
    const float M1 = st[(0 * HMAX + h) * RB + g + 8];
    const float L0 = st[(1 * HMAX + h) * RB + g];
    const float L1 = st[(1 * HMAX + h) * RB + g + 8];
    const float D0 = st[(2 * HMAX + h) * RB + g];
    const float D1 = st[(2 * HMAX + h) * RB + g + 8];
#pragma unroll 1
    for (int nb = 0; nb < 8; ++nb) {
      if (8 * nb >= kc) break;
      float s4[4] = {0.f, 0.f, 0.f, 0.f}, p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int cb = h * KB + kb;
        unsigned ah[4], al[4];
        float b0, b1;
        a_frag(Q[cb][0], Q[cb][1], Q[cb][2], Q[cb][3], ah, al);
        b_nk(K, cb, nb, b0, b1);
        mma3(s4, ah, al, b0, b1);
        a_frag(dO[cb][0], dO[cb][1], dO[cb][2], dO[cb][3], ah, al);
        b_nk(V, cb, nb, b0, b1);
        mma3(p4, ah, al, b0, b1);
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >> 1;
        const float p = 8 * nb + 2 * t + (e & 1) < kc
                            ? expf(s4[e] - (hi ? M1 : M0)) / (hi ? L1 : L0)
                            : 0.f;
        ds[e] = p * (p4[e] - (hi ? D1 : D0));
      }
      unsigned ah[4], al[4];
      a_frag(ds[0], ds[1], ds[2], ds[3], ah, al);
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float b0, b1;
        b_kn(K, nb, h * KB + j, b0, b1);
        mma3(dQ[h * KB + j], ah, al, b0, b1);
      }
    }
  }
}

// The key side's gradients over one staged chunk of qc queries (q at qs,
// dO at qs + BLK, the rows' max, sum and D at qs + 2 BLK, [3][HMAX][KC]):
// dV += P^T dO, dK += dS^T q for the warp's 16 keys (K, V), P and dS
// recomputed as the query side's.
template <int H>
__device__ __forceinline__ void attn_kv_chunk(const float (&K)[8][4],
                                              const float (&V)[8][4],
                                              const float* qs, int qc,
                                              float (&dK)[8][4],
                                              float (&dV)[8][4]) {
  constexpr int KB = C / H / 8;
  const float* Qs = qs;
  const float* Os = qs + BLK;
  const float* st = qs + 2 * BLK;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll 1
    for (int nb = 0; nb < 8; ++nb) {
      if (8 * nb >= qc) break;
      float s4[4] = {0.f, 0.f, 0.f, 0.f}, p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int cb = h * KB + kb;
        unsigned ah[4], al[4];
        float b0, b1;
        a_frag(K[cb][0], K[cb][1], K[cb][2], K[cb][3], ah, al);
        b_nk(Qs, cb, nb, b0, b1);
        mma3(s4, ah, al, b0, b1);
        a_frag(V[cb][0], V[cb][1], V[cb][2], V[cb][3], ah, al);
        b_nk(Os, cb, nb, b0, b1);
        mma3(p4, ah, al, b0, b1);
      }
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nb + 2 * t + (e & 1);  // the query
        const float Mv = st[(0 * HMAX + h) * KC + i];
        const float Lv = st[(1 * HMAX + h) * KC + i];
        const float Dv = st[(2 * HMAX + h) * KC + i];
        p[e] = i < qc ? expf(s4[e] - Mv) / Lv : 0.f;
        ds[e] = p[e] * (p4[e] - Dv);
      }
      unsigned ph[4], pl[4], dh[4], dl[4];
      a_frag(p[0], p[1], p[2], p[3], ph, pl);
      a_frag(ds[0], ds[1], ds[2], ds[3], dh, dl);
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float b0, b1;
        b_kn(Os, nb, h * KB + j, b0, b1);
        mma3(dV[h * KB + j], ph, pl, b0, b1);
        b_kn(Qs, nb, h * KB + j, b0, b1);
        mma3(dK[h * KB + j], dh, dl, b0, b1);
      }
    }
  }
}

// D = dO . o per head for rows g, g + 8 (quad and head-column sums).
template <int H>
__device__ __forceinline__ void head_dots(const float (&a)[8][4],
                                          const float (&b)[8][4], int h,
                                          float (&d)[2]) {
  constexpr int KB = C / H / 8;
  d[0] = d[1] = 0.f;
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[e >> 1] += a[h * KB + j][e] * b[h * KB + j][e];
  d[0] = quad_sum(d[0]);
  d[1] = quad_sum(d[1]);
}

// ---------------------------------------------------------------------------
// The query side, in three programs over the same tiles (a long side's 128
// rows, or a split short side's rows and its range of the keys), so that
// each keeps only its own tiles in registers:
// - attention: (CA) q = AdaLN_q(x) Wq + bq, scaled; the forward's attention
//   recomputed over the tile's keys: o, the softmax's max and sum (split:
//   the range's partials);
// - tail: (split: the partials merged in order of s) the block's tail
//   (proj, x1, AdaLN2, the MLP's first layer) and the gradient chain down
//   to the attention: m2g, the MLP's and AdaLN2's backwards, dx1, da, dO,
//   D = dO . o per head, and the tile's partial sums;
// - dq: dq over the tile's keys (split: the range's partial).
// ---------------------------------------------------------------------------

struct QArgs {
  int clips, Nq, Nk, hid, S, tiles;
  float eps, qscale;
  const float* x;          // the residual input [clips * Nq, C]
  const float* qin;        // the scaled q rows (stride ldqin)
  int ldqin;
  // The CA block's q: AdaLN_q(x) wq + bq, scaled; nq and q (at qin) kept
  // where not null.
  const float *gq, *bqa, *wq, *bq;
  float *nq, *qout;
  const float *k, *v;      // the keys and values [clips * Nk, *]
  int ldkv;
  const float *g2, *b2, *m1, *m2, *wproj, *bproj, *w1, *bb1, *w2, *bb2,
      *wprojT, *w1T, *w2T, *gout;
  float *o, *hh;           // [S][clips * Nq][C], [S][clips * Nq][hid]
  // The softmax's max and sum (null in the forward), the backward's state.
  float *h2, *ge, *m2g, *dhh, *da, *dO, *dx1, *Ms, *Ls, *Ds;
  float* dq;               // [S] x (clips * Nq rows of stride lddq)
  int lddq;
  size_t dq_split;
  float *opart, *mpart, *lpart;  // the attention's partials [S][clips * Nq]
  float* part;             // [items][qpart_len(hid)]
  bool dm;
  float* out;              // the forward's output [clips * Nq, C]
};

// A tile of the query side: its clip, split (0 unsplit), the keys' chunks
// [c0, c1), rows [r0, r0 + nrows) and the warp's share of them.
struct QTile {
  int clip, s, c0, c1, nv;
  size_t gr;  // the warp's first row
  bool active, keep;

  __device__ QTile(const QArgs& p, int item) {
    const int per = p.S > 1 ? p.S : p.tiles;
    const int chunks = cdiv(p.Nk, KC);
    clip = item / per;
    s = p.S > 1 ? item % per : 0;
    if (p.S > 1) {
      split_range(chunks, s, p.S, c0, c1);
    } else {
      c0 = 0;
      c1 = chunks;
    }
    const int r0 = p.S > 1 ? 0 : item % per * TRT;
    const int wr = (threadIdx.x >> 5) * RB;
    nv = max(0, min(RB, min(TRT, p.Nq - r0) - wr));
    gr = (size_t)clip * p.Nq + r0 + wr;
    active = nv > 0;
    keep = s == 0;
  }
};

__device__ __forceinline__ int q_items(const QArgs& p) {
  return p.clips * (p.S > 1 ? p.S : p.tiles);
}

__device__ __forceinline__ Item kv_item(const QArgs& p, int clip, int c) {
  Item it = {};
  const size_t r = (size_t)clip * p.Nk + c * KC;
  it.a = p.k + r * p.ldkv;
  it.b = p.v + r * p.ldkv;
  it.lda = it.ldb = p.ldkv;
  it.rows = min(KC, p.Nk - c * KC);
  return it;
}

// The staged items of the three programs' tiles, in order: the attention's
// (CA: Wq) and the keys' chunks; the tail's Wproj, W1's column blocks,
// then W2^T's column block and W1^T's row block a hidden chunk, Wproj^T;
// dq's the keys' chunks.
enum { Q_ATTN = 0, Q_TAIL = 1, Q_DQ = 2 };

template <int PROG>
__device__ bool q_item(const QArgs& p, int item, int i, Item& it) {
  const QTile tl(p, item);
  const int nc = tl.c1 - tl.c0, nh = p.hid / C;
  if (PROG == Q_TAIL) {
    if (i == 0) {
      it = block_item(p.wproj, C);
    } else if (--i < nh) {
      it = block_item(p.w1 + i * C, p.hid);
    } else if ((i -= nh) < 2 * nh) {
      const int ch = i >> 1;
      it = i & 1 ? block_item(p.w1T + (size_t)ch * C * C, C)
                 : block_item(p.w2T + ch * C, p.hid);
    } else if (i == 2 * nh) {
      it = block_item(p.wprojT, C);
    } else {
      return false;
    }
    return true;
  }
  if (PROG == Q_ATTN && p.wq != nullptr) {
    if (i == 0) {
      it = block_item(p.wq, C);
      return true;
    }
    --i;
  }
  if (i >= nc) return false;
  it = kv_item(p, tl.clip, tl.c0 + i);
  return true;
}

// A program's ring over the CTA's items. A tile's staged items are listed
// once in shared memory (by one thread, at the tile's start, from
// get(item, i, Item&): false past the tile's last), followed by the next
// tile's first; next() waits for the current item and stages the one
// after it.
constexpr int QTAB = 16;  // the most items a tile stages, and one more
static_assert(QTAB * sizeof(Item) == QTAB_BYTES, "the lists' bytes");

template <int SLOT>
struct Ring {
  Pipe<SLOT> pipe;
  Item* tab;
  int item, end, step;

  template <class Get>
  __device__ Ring(const Get& get, float* buf, float* table, int begin,
                  int end_)
      : tab(reinterpret_cast<Item*>(table)), item(begin), end(end_),
        step(0) {
    pipe.buf = buf;
    fill(get);
    pipe.start(tab[0]);
  }
  template <class Get>
  __device__ void fill(const Get& get) {
    __syncthreads();
    if (threadIdx.x == 0) {
      int i = 0;
      while (get(item, i, tab[i])) ++i;
      Item nx = {};
      if (item + 1 < end) get(item + 1, 0, nx);
      tab[i] = nx;
    }
    __syncthreads();
  }
  __device__ const float* next() {
    ++step;
    return pipe.next(tab[step].a != nullptr ? &tab[step] : nullptr);
  }
  template <class Get>
  __device__ void next_tile(const Get& get) {
    ++item;
    step = 0;
    if (item < end) fill(get);
  }
};

// ---------------------------------------------------------------------------
// The rows program: per tile of a side's rows (128, 16 a warp) and each of
// its one or two inputs, h = AdaLN(x) (kept where asked) and out = h W +
// bias a 64-column block of W at a time (the first block scaled: q). h is
// stashed and read a k-step at a time (held in registers over the
// unrolled product, it spilled).
// ---------------------------------------------------------------------------

struct RSide {
  const float *x, *g, *b;  // rows [clips * N, C]; AdaLN's vectors [clips, C]
  float* keep;             // h [clips * N, C], or null
  const float *w, *bias;   // [C, blocks * C] ([in, out]), [blocks * C]
  float* out;              // [clips * N, blocks * C]
  int blocks;
};

struct RArgs {
  int clips, N, tiles, nsides;
  float eps, scale0;  // side 0's first block scaled by scale0
  RSide side[2];
};

__device__ void rprog(const RArgs& p, float* smem) {
  int begin, end;
  share(p.clips * p.tiles, begin, end);
  if (begin >= end) return;
  const int warp = threadIdx.x >> 5;
  float* hs = smem + 2 * FSLOT + warp * RB * C;
  const auto get = [&](int, int i, Item& it) {
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      if (sd >= p.nsides) break;
      const RSide& f = p.side[sd];
      if (i < f.blocks) {
        it = block_item(f.w + i * C, f.blocks * C);
        return true;
      }
      i -= f.blocks;
    }
    return false;
  };
  Ring<FSLOT> ring(get, smem, smem + R_TAB, begin, end);
  for (; ring.item < end; ring.next_tile(get)) {
    const int clip = ring.item / p.tiles, r0 = ring.item % p.tiles * TRT;
    const int nv = max(0, min(RB, min(TRT, p.N - r0) - warp * RB));
    const bool active = nv > 0;
    const size_t gr = (size_t)clip * p.N + r0 + warp * RB;
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      if (sd >= p.nsides) break;
      const RSide& f = p.side[sd];
      if (active) {
        float x[8][4], h[8][4];
        load_tile(f.x + gr * C, C, nv, x);
        adaln_tile(x, f.g + clip * C, f.b + clip * C, p.eps, h);
        mask_rows(h, nv);
        if (f.keep != nullptr) store_tile(f.keep + gr * C, C, nv, h);
        stash(hs, h);
      }
      const int ld = f.blocks * C;
#pragma unroll 1
      for (int j = 0; j < f.blocks; ++j) {
        const float* W = ring.next();
        if (!active) continue;
        float o[8][4];
        zero(o);
        mm_stashed(hs, W, o);
        add_cols(o, f.bias + j * C);
        const float sc = sd == 0 && j == 0 ? p.scale0 : 1.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nb][e] *= sc;
        mask_rows(o, nv);
        store_tile(f.out + gr * ld + j * C, ld, nv, o);
      }
    }
  }
}

// The attention: per tile o (normalised; split: unnormalised partials)
// and the softmax's max and sum (unsplit: where p.Ms is not null).
template <int H, bool CA>
__device__ void q_attn(const QArgs& p, float* smem) {
  int begin, end;
  share(q_items(p), begin, end);
  if (begin >= end) return;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const size_t Mq = (size_t)p.clips * p.Nq;
  const auto get = [&](int item, int i, Item& it) {
    return q_item<Q_ATTN>(p, item, i, it);
  };
  Ring<QSLOT> ring(get, smem, smem + 2 * QSLOT, begin, end);
  for (; ring.item < end; ring.next_tile(get)) {
    const QTile tl(p, ring.item);
    const int nv = tl.nv;
    float Q[8][4];
    if (CA) {
      // nq = AdaLN_q(x); q = (nq wq + bq) qscale.
      float nq[8][4];
      if (tl.active) {
        float xt[8][4];
        load_tile(p.x + tl.gr * C, C, nv, xt);
        adaln_tile(xt, p.gq + tl.clip * C, p.bqa + tl.clip * C, p.eps, nq);
        mask_rows(nq, nv);
        if (tl.keep && p.nq != nullptr)
          store_tile(p.nq + tl.gr * C, C, nv, nq);
      }
      const float* W = ring.next();
      if (tl.active) {
        zero(Q);
        mm_tile(nq, W, Q);
        add_cols(Q, p.bq);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) Q[nb][e] *= p.qscale;
        mask_rows(Q, nv);
        if (tl.keep && p.qout != nullptr)
          store_tile(p.qout + tl.gr * C, C, nv, Q);
      }
    } else {
      load_tile(p.qin + tl.gr * p.ldqin, p.ldqin, nv, Q);
    }
    float O[8][4], m[H][2], l[H][2];
    zero(O);
#pragma unroll
    for (int h = 0; h < H; ++h)
      m[h][0] = m[h][1] = -INFINITY, l[h][0] = l[h][1] = 0.f;
#pragma unroll 1
    for (int c = tl.c0; c < tl.c1; ++c) {
      const float* kv = ring.next();
      if (tl.active)
        attn_fwd_chunk<H>(Q, kv, min(KC, p.Nk - c * KC), O, m, l);
    }
    if (!tl.active) continue;
    const bool split = p.S > 1;
    if (!split) {
      constexpr int KB = C / H / 8;
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < KB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            O[h * KB + j][e] = g + 8 * (e >> 1) < nv
                                   ? O[h * KB + j][e] / l[h][e >> 1]
                                   : 0.f;
    }
    const size_t at = split ? (size_t)tl.s * Mq + tl.gr : tl.gr;
    store_tile((split ? p.opart : p.o) + at * C, C, nv, O);
    float* Mo = split ? p.mpart : p.Ms;
    float* Lo = split ? p.lpart : p.Ls;
    if (t == 0 && Mo != nullptr)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (g + 8 * hf < nv) {
            Mo[(at + g + 8 * hf) * H + h] = m[h][hf];
            Lo[(at + g + 8 * hf) * H + h] = l[h][hf];
          }
  }
}

// The o of the warp's rows (the first at gr; nv of them): the S splits'
// partials merged in order of s, normalised; m, l: the merged softmax's max
// and sum.
template <int H>
__device__ __forceinline__ void merge_o(const QArgs& p, size_t gr, int nv,
                                        float (&O)[8][4], float (&m)[H][2],
                                        float (&l)[H][2]) {
  constexpr int KB = C / H / 8;
  const int g = (threadIdx.x & 31) >> 2;
  const size_t Mq = (size_t)p.clips * p.Nq;
  zero(O);
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[h][hf] = g + 8 * hf < nv ? -INFINITY : 0.f;
      l[h][hf] = 0.f;
    }
#pragma unroll 1
  for (int sp = 0; sp < p.S; ++sp)
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (g + 8 * hf < nv)
          m[h][hf] = fmaxf(m[h][hf],
                           p.mpart[((size_t)sp * Mq + gr + g + 8 * hf) * H +
                                   h]);
#pragma unroll 1
  for (int sp = 0; sp < p.S; ++sp) {
    const size_t at = (size_t)sp * Mq + gr;
    float Os[8][4];
    load_tile(p.opart + at * C, C, nv, Os);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float f[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        f[hf] = 0.f;
        if (g + 8 * hf < nv) {
          const size_t r = (at + g + 8 * hf) * H + h;
          f[hf] = expf(p.mpart[r] - m[h][hf]);
          l[h][hf] += p.lpart[r] * f[hf];
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          O[h * KB + j][e] += Os[h * KB + j][e] * f[e >> 1];
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + 8 * (e >> 1) < nv) O[h * KB + j][e] /= l[h][e >> 1];
}

// The tail and the gradient chain down to the attention.
template <int H>
__device__ void q_tail(const QArgs& p, float* smem) {
  int begin, end;
  share(q_items(p), begin, end);
  if (begin >= end) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hid = p.hid, plen = qpart_len(hid);
  const size_t Mq = (size_t)p.clips * p.Nq;
  // The warp's stashed tiles: a (for dm1 and x1's recompute), gy, and the
  // A operand of the current product.
  float* wstash = smem + 2 * QSLOT + warp * RB * C;
  float* gstash = wstash + NW * RB * C;
  float* astash = gstash + NW * RB * C;
  float* csall = smem + 2 * QSLOT + 3 * NW * RB * C;
  float* cs = csall + warp * plen;
  const auto get = [&](int item, int i, Item& it) {
    return q_item<Q_TAIL>(p, item, i, it);
  };
  Ring<QSLOT> ring(get, smem, smem + QT_TAB, begin, end);
  for (; ring.item < end; ring.next_tile(get)) {
    const QTile tl(p, ring.item);
    const int nv = tl.nv, clip = tl.clip;
    const bool active = tl.active, keep = tl.keep;
    const size_t gr = tl.gr;
    zero_row(cs, plen);
    // o: the splits' partials merged in order of s (this split's own copy
    // kept), or the attention's.
    float* o_own = p.o + ((size_t)tl.s * Mq + gr) * C;
    float O[8][4];
    if (p.S > 1) {
      zero(O);
      if (active) {
        float m[H][2], l[H][2];
        merge_o<H>(p, gr, nv, O, m, l);
        store_tile(o_own, C, nv, O);
        if (keep && t == 0)
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              if (g + 8 * hf < nv) {
                p.Ms[(gr + g + 8 * hf) * H + h] = m[h][hf];
                p.Ls[(gr + g + 8 * hf) * H + h] = l[h][hf];
              }
      }
    } else {
      load_tile(o_own, C, nv, O);
    }

    // a = o Wproj + bproj (kept for dm1 and x1's recompute), x1 = x + m1
    // a, h2 = AdaLN2(x1) (stashed for the MLP's first layer).
    const float m1 = p.m1 != nullptr ? p.m1[clip] : 1.f;
    const float m2 = p.m2 != nullptr ? p.m2[clip] : 1.f;
    const float* g2 = p.g2 + clip * C;
    {
      const float* W = ring.next();
      if (active) {
        stash(astash, O);
        float a[8][4];
        zero(a);
        mm_stashed(astash, W, a);
        add_cols(a, p.bproj);
        mask_rows(a, nv);
        stash(wstash, a);
        float x1[8][4];
        load_tile(p.x + gr * C, C, nv, x1);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) x1[nb][e] += m1 * a[nb][e];
        float h2[8][4];
        adaln_tile(x1, g2, p.b2 + clip * C, p.eps, h2);
        mask_rows(h2, nv);
        if (keep) store_tile(p.h2 + gr * C, C, nv, h2);
        stash(astash, h2);
      }
    }
    // The MLP's first layer a hidden chunk of 64 at a time: hh (this
    // split's own copy, read back below) and gelu(hh) kept. Its output mo
    // is not recomputed: dm2 = sum gy mo = sum gelu(hh) (gy W2^T) + sum gy
    // bb2 takes gy W2^T from the backward.
    float* hh_own = p.hh + (size_t)tl.s * Mq * hid + gr * hid;
#pragma unroll 1
    for (int ch = 0; ch < hid; ch += C) {
      const float* W = ring.next();
      if (active) {
        float hh[8][4];
        zero(hh);
        mm_stashed(astash, W, hh);
        add_cols(hh, p.bb1 + ch);
        mask_rows(hh, nv);
        store_tile(hh_own + ch, hid, nv, hh);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) hh[nb][e] = gelu_erf(hh[nb][e]);
        if (keep) store_tile(p.ge + gr * hid + ch, hid, nv, hh);
      }
    }
    // gy (stashed: the MLP's backward reads it from shared memory); m2g =
    // m2 gy kept (dbb2's column sums); dm2's sum gy bb2.
    float dm2[2] = {0.f, 0.f};
    if (active) {
      float gy[8][4];
      load_tile(p.gout + gr * C, C, nv, gy);
      stash(gstash, gy);
      float m2g[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) m2g[nb][e] = gy[nb][e] * m2;
      if (keep) store_tile(p.m2g + gr * C, C, nv, m2g);
      col_sums(m2g, cs + C + hid);
      if (p.dm) {
        const float* bb2 = p.bb2 + 2 * t;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dm2[e >> 1] += gy[nb][e] * bb2[8 * nb + (e & 1)];
      }
    }
    // The MLP's backward a hidden chunk at a time: gy W2^T, dm2's sum
    // gelu(hh) (gy W2^T), dhh = m2 (gy W2^T) gelu'(hh) (dbb1's column
    // sums), dh2 += dhh W1^T.
    float dh2[8][4];
    zero(dh2);
#pragma unroll 1
    for (int ch = 0; ch < hid; ch += C) {
      float d[8][4];
      const float* W = ring.next();
      if (active) {
        zero(d);
        mm_stashed(gstash, W, d);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = g + 8 * hf;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            float2 u = make_float2(0.f, 0.f);
            if (r < nv)
              u = *reinterpret_cast<const float2*>(hh_own + (size_t)r * hid +
                                                   ch + 8 * nb + 2 * t);
            float ge0, ge1;
            const float gp0 = gelu_and_grad(u.x, ge0);
            const float gp1 = gelu_and_grad(u.y, ge1);
            if (p.dm) dm2[hf] += ge0 * d[nb][2 * hf] + ge1 * d[nb][2 * hf + 1];
            d[nb][2 * hf] *= m2 * gp0;
            d[nb][2 * hf + 1] *= m2 * gp1;
          }
        }
        mask_rows(d, nv);
        if (keep) store_tile(p.dhh + gr * hid + ch, hid, nv, d);
        col_sums(d, cs + C + ch);
        stash(astash, d);
      }
      W = ring.next();
      if (active) mm_stashed(astash, W, dh2);
    }
    // AdaLN2's backward: dx1 = gy + AdaLN2^T(dh2) (dgamma2, dbeta2), dm1's
    // row sums of dx1 a, da = m1 dx1 (dbproj); then dO = da Wproj^T (its
    // block staged first: no tile is held over the ring's barrier) and D =
    // dO . o per head.
    const float* W = ring.next();
    if (active) {
      if (p.dm) {
        dm2[0] = quad_sum(dm2[0]);
        dm2[1] = quad_sum(dm2[1]);
        if (g >= nv) dm2[0] = 0.f;
        if (g + 8 >= nv) dm2[1] = 0.f;
        const float tot = warp_rows_total(dm2);
        if (lane == 0) cs[4 * C + hid + 1] = tot;
      }
      float da[8][4];
      {
        float x1[8][4];
        load_tile(p.x + gr * C, C, nv, x1);
        add_stash(x1, wstash, m1);
        col_sums(dh2, cs + 3 * C + hid);
        adaln_bwd_tile(x1, dh2, g2, p.eps, da, dh2);  // dh2: dgamma2's terms
      }
      mask_rows(dh2, nv);
      col_sums(dh2, cs + 2 * C + hid);
      add_tile(da, p.gout + gr * C, C, nv);  // + gy, read again
      mask_rows(da, nv);
      if (p.dm) {
        float e1[2] = {0.f, 0.f};
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            e1[e >> 1] += da[nb][e] * wstash[(nb * 4 + e) * 32 + lane];
        e1[0] = quad_sum(e1[0]);
        e1[1] = quad_sum(e1[1]);
        if (g >= nv) e1[0] = 0.f;
        if (g + 8 >= nv) e1[1] = 0.f;
        const float tot = warp_rows_total(e1);
        if (lane == 0) cs[4 * C + hid] = tot;
      }
      if (keep) store_tile(p.dx1 + gr * C, C, nv, da);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[nb][e] *= m1;
      if (keep) store_tile(p.da + gr * C, C, nv, da);
      col_sums(da, cs);
      stash(astash, da);
      float dO[8][4];
      zero(dO);
      mm_stashed(astash, W, dO);
      mask_rows(dO, nv);
      if (keep) store_tile(p.dO + gr * C, C, nv, dO);
      load_tile(o_own, C, nv, O);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float d[2];
        head_dots<H>(dO, O, h, d);
        if (keep && t == 0)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            if (g + 8 * hf < nv) p.Ds[(gr + g + 8 * hf) * H + h] = d[hf];
      }
    }
    flush_parts(csall, plen, keep, p.part + (size_t)ring.item * plen);
  }
}

// dq over the tile's keys (split: the range's partial), P and dS
// recomputed from q, dO and the rows' max, sum and D.
template <int H>
__device__ void q_dq(const QArgs& p, float* smem) {
  int begin, end;
  share(q_items(p), begin, end);
  if (begin >= end) return;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float* st = smem + 2 * QSLOT + warp * 3 * HMAX * RB;
  const auto get = [&](int item, int i, Item& it) {
    return q_item<Q_DQ>(p, item, i, it);
  };
  Ring<QSLOT> ring(get, smem, smem + QD_TAB, begin, end);
  for (; ring.item < end; ring.next_tile(get)) {
    const QTile tl(p, ring.item);
    const int nv = tl.nv;
    float Q[8][4], dO[8][4], dQ[8][4];
    load_tile(p.qin + tl.gr * p.ldqin, p.ldqin, nv, Q);
    load_tile(p.dO + tl.gr * C, C, nv, dO);
    if (t == 0)
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bool ok = g + 8 * hf < nv;
          const size_t r = (tl.gr + g + 8 * hf) * H + h;
          stat_at(st, 0, h, g + 8 * hf) = ok ? p.Ms[r] : 0.f;
          stat_at(st, 1, h, g + 8 * hf) = ok ? p.Ls[r] : 1.f;
          stat_at(st, 2, h, g + 8 * hf) = ok ? p.Ds[r] : 0.f;
        }
    __syncwarp();
    zero(dQ);
#pragma unroll 1
    for (int c = tl.c0; c < tl.c1; ++c) {
      const float* kv = ring.next();
      if (tl.active)
        attn_dq_chunk<H>(Q, dO, st, kv, min(KC, p.Nk - c * KC), dQ);
    }
    if (tl.active) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dQ[nb][e] *= p.qscale;
      store_tile(p.dq + tl.s * p.dq_split + tl.gr * p.lddq, p.lddq, nv, dQ);
    }
  }
}

// ---------------------------------------------------------------------------
// The forward's tail: per tile of the query side's rows (a split short
// side: its one tile, the splits' partials merged in order of s), a = o
// Wproj + bproj, x1 = x + m1 a, h2 = AdaLN2(x1), y = x1 + m2 (gelu(h2 W1 +
// bb1) W2 + bb2), the MLP a hidden chunk of 64 at a time (W1's column
// block, then W2's row block). It writes y and keeps nothing. Every
// product's A operand (o, h2, gelu(hh)) is stashed and read a k-step at a
// time, as the backward's tail does (held in registers, it spilled).
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool qf_item(const QArgs& p, int i, Item& it) {
  const int nh = p.hid / C;
  if (i == 0) {
    it = block_item(p.wproj, C);
  } else if (--i < 2 * nh) {
    const int ch = i >> 1;
    it = i & 1 ? block_item(p.w2 + (size_t)ch * C * C, C)
               : block_item(p.w1 + ch * C, p.hid);
  } else {
    return false;
  }
  return true;
}

template <int H>
__device__ void qf_tail(const QArgs& p, float* smem) {
  int begin, end;
  share(p.clips * p.tiles, begin, end);
  if (begin >= end) return;
  const int warp = threadIdx.x >> 5;
  float* xstash = smem + 2 * FSLOT + warp * RB * C;  // x1
  float* hstash = xstash + NW * RB * C;              // o, then h2
  float* gstash = hstash + NW * RB * C;              // gelu(hh)
  const auto get = [&](int, int i, Item& it) { return qf_item(p, i, it); };
  Ring<FSLOT> ring(get, smem, smem + QF_TAB, begin, end);
  for (; ring.item < end; ring.next_tile(get)) {
    const int clip = ring.item / p.tiles, r0 = ring.item % p.tiles * TRT;
    const int nv = max(0, min(RB, min(TRT, p.Nq - r0) - warp * RB));
    const bool active = nv > 0;
    const size_t gr = (size_t)clip * p.Nq + r0 + warp * RB;
    const float m1 = p.m1 != nullptr ? p.m1[clip] : 1.f;
    const float m2 = p.m2 != nullptr ? p.m2[clip] : 1.f;
    if (active) {
      float O[8][4];
      if (p.S > 1) {
        float m[H][2], l[H][2];
        merge_o<H>(p, gr, nv, O, m, l);
      } else {
        load_tile(p.o + gr * C, C, nv, O);
      }
      stash(hstash, O);
    }
    {
      const float* W = ring.next();
      if (active) {
        float a[8][4];
        zero(a);
        mm_stashed(hstash, W, a);
        add_cols(a, p.bproj);
        float x1[8][4];
        load_tile(p.x + gr * C, C, nv, x1);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) x1[nb][e] += m1 * a[nb][e];
        stash(xstash, x1);
        float h2[8][4];
        adaln_tile(x1, p.g2 + clip * C, p.b2 + clip * C, p.eps, h2);
        mask_rows(h2, nv);
        stash(hstash, h2);
      }
    }
    float y[8][4];
    zero(y);
#pragma unroll 1
    for (int ch = 0; ch < p.hid; ch += C) {
      const float* W = ring.next();
      if (active) {
        float ge[8][4];
        zero(ge);
        mm_stashed(hstash, W, ge);
        add_cols(ge, p.bb1 + ch);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) ge[nb][e] = gelu_erf(ge[nb][e]);
        stash(gstash, ge);
      }
      W = ring.next();
      if (active) mm_stashed(gstash, W, y);
    }
    if (active) {
      add_cols(y, p.bb2);
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[nb][e] = xstash[(nb * 4 + e) * 32 + lane] + m2 * y[nb][e];
      store_tile(p.out + gr * C, C, nv, y);
    }
  }
}

// ---------------------------------------------------------------------------
// The key program: per tile (a long side's 128 keys, or a split short
// side's keys and its range of the queries) dk and dv over the queries.
// ---------------------------------------------------------------------------

struct KArgs {
  int clips, Nq, Nk, S, tiles, heads;
  const float *k, *v;  // the keys' k and v rows (stride ldkv)
  int ldkv;
  const float* q;      // the scaled q rows (stride ldq)
  int ldq;
  const float *dO, *Ms, *Ls, *Ds;
  float *dk, *dv;      // [S] x (clips * Nk rows of stride ldd)
  int ldd;
  size_t split;
};

struct KSched {
  const KArgs* p;
  __device__ void range(int item, int& clip, int& s, int& c0, int& c1) const {
    const int per = p->S > 1 ? p->S : p->tiles;
    clip = item / per;
    s = p->S > 1 ? item % per : 0;
    const int n = cdiv(p->Nq, KC);
    if (p->S > 1)
      split_range(n, s, p->S, c0, c1);
    else {
      c0 = 0;
      c1 = n;
    }
  }
  __device__ bool get(int item, int i, Item& it) const {
    int clip, s, c0, c1;
    range(item, clip, s, c0, c1);
    if (i >= c1 - c0) return false;
    const int c = c0 + i;
    const size_t r = (size_t)clip * p->Nq + c * KC;
    it = {};
    it.a = p->q + r * p->ldq;
    it.lda = p->ldq;
    it.b = p->dO + r * C;
    it.ldb = C;
    it.rows = min(KC, p->Nq - c * KC);
    it.m = p->Ms + r * p->heads;
    it.l = p->Ls + r * p->heads;
    it.d = p->Ds + r * p->heads;
    it.heads = p->heads;
    return true;
  }
};

template <int H>
__device__ void kprog(const KArgs& p, float* smem) {
  const int items = p.clips * (p.S > 1 ? p.S : p.tiles);
  int begin, end;
  share(items, begin, end);
  if (begin >= end) return;
  const int warp = threadIdx.x >> 5;
  const KSched sched{&p};
  const auto get = [&](int item, int i, Item& it) {
    return sched.get(item, i, it);
  };
  Ring<KSLOT> ring(get, smem, smem + 2 * KSLOT, begin, end);
  for (; ring.item < end; ring.next_tile(get)) {
    int clip, s, c0, c1;
    sched.range(ring.item, clip, s, c0, c1);
    const int item = ring.item;
    const int r0 = p.S > 1 ? 0 : item % p.tiles * TRT;
    const int nrows = min(TRT, p.Nk - r0);
    const int nv = max(0, min(RB, nrows - warp * RB));
    const bool active = nv > 0;
    const size_t gr = (size_t)clip * p.Nk + r0 + warp * RB;
    float K[8][4], V[8][4], dK[8][4], dV[8][4];
    if (active) {
      load_tile(p.k + gr * p.ldkv, p.ldkv, nv, K);
      load_tile(p.v + gr * p.ldkv, p.ldkv, nv, V);
    }
    zero(dK);
    zero(dV);
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const float* qs = ring.next();
      if (active) attn_kv_chunk<H>(K, V, qs, min(KC, p.Nq - c * KC), dK, dV);
    }
    if (active) {
      store_tile(p.dk + s * p.split + gr * p.ldd, p.ldd, nv, dK);
      store_tile(p.dv + s * p.split + gr * p.ldd, p.ldd, nv, dV);
    }
  }
}

// ---------------------------------------------------------------------------
// The finishing program: per tile of a side's rows (16 a warp) and each of
// its sides, G (the split partials merged in order of s and kept, or read
// whole) with its column sums, dn = sum over G's 64-column parts of G W^T,
// dx = add + AdaLN^T(dn) with dgamma, dbeta's column sums.
// ---------------------------------------------------------------------------

struct FSide {
  const float* G;       // [rows, parts * 64] (stride ldG), or null: merged
  int ldG, parts;
  const float* gpart;   // S > 1: [S][clips * N][C] partials
  size_t gsplit;
  float* gout;          // S > 1: the merged G [clips * N][C]
  const float* WT;      // [parts * 64][64]
  const float *x, *g, *add;
  float* dx;
  int boff, coff;       // the side's column partials in the tile's row
};

struct FArgs {
  int clips, N, rows, tiles, S, nsides, plen;
  float eps;
  FSide side[2];
  float* part;          // [items][plen]
};

struct FSched {
  const FArgs* p;
  __device__ bool get(int, int i, Item& it) const {
    for (int sd = 0; sd < p->nsides; ++sd) {
      if (i < p->side[sd].parts) {
        it = block_item(p->side[sd].WT + (size_t)i * C * C, C);
        return true;
      }
      i -= p->side[sd].parts;
    }
    return false;
  }
};

__device__ void fprog(const FArgs& p, float* smem) {
  const int items = p.clips * p.tiles;
  int begin, end;
  share(items, begin, end);
  if (begin >= end) return;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float* csall = smem + 2 * FSLOT;
  float* cs = csall + warp * p.plen;
  const FSched sched{&p};
  const auto get = [&](int item, int i, Item& it) {
    return sched.get(item, i, it);
  };
  Ring<FSLOT> ring(get, smem, csall + warps * FPART_MAX, begin, end);
  for (; ring.item < end; ring.next_tile(get)) {
    const int item = ring.item;
    const int clip = item / p.tiles, r0 = item % p.tiles * p.rows;
    const int nv = max(0, min(RB, min(p.rows, p.N - r0) - warp * RB));
    const bool active = nv > 0;
    const size_t gr = (size_t)clip * p.N + r0 + warp * RB;
    zero_row(cs, p.plen);
    for (int sd = 0; sd < p.nsides; ++sd) {
      const FSide& f = p.side[sd];
      float dn[8][4];
      zero(dn);
      for (int part = 0; part < f.parts; ++part) {
        float G[8][4];
        if (active) {
          if (p.S > 1) {
            zero(G);
            for (int sp = 0; sp < p.S; ++sp) {
              float Gs[8][4];
              load_tile(f.gpart + sp * f.gsplit + gr * C, C, nv, Gs);
#pragma unroll
              for (int nb = 0; nb < 8; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) G[nb][e] += Gs[nb][e];
            }
            store_tile(f.gout + gr * C, C, nv, G);
          } else {
            load_tile(f.G + gr * f.ldG + part * C, f.ldG, nv, G);
          }
          col_sums(G, cs + f.boff + part * C);
        }
        const float* W = ring.next();
        if (active) mm_tile(G, W, dn);
      }
      if (active) {
        float x[8][4], dx[8][4];
        load_tile(f.x + gr * C, C, nv, x);
        col_sums(dn, cs + f.coff + C);
        adaln_bwd_tile(x, dn, f.g + clip * C, p.eps, dx, dn);  // dgamma's terms
        mask_rows(dn, nv);
        col_sums(dn, cs + f.coff);
        if (f.add != nullptr) add_tile(dx, f.add + gr * C, C, nv);
        store_tile(f.dx + gr * C, C, nv, dx);
      }
    }
    flush_parts(csall, p.plen, true, p.part + (size_t)item * p.plen);
  }
}

// ---------------------------------------------------------------------------
// The sums of the programs' partial rows: per clip (a clip's tiles in
// order) or over every tile (the bias gradients), one launch for all.
// ---------------------------------------------------------------------------

constexpr int MAX_SUMS = 6;

struct SumJob {
  const float* part;  // [clips * tiles][stride]
  int stride, off, len, tiles, clips;
  bool per_clip;
  float* out;         // per clip: out[b * ostride + e]; else out[e]
  int ostride;
};

struct Sums {
  SumJob job[MAX_SUMS];
  int n;
  int first[MAX_SUMS + 1];
};

__global__ void __launch_bounds__(NT) sums_kernel(Sums S) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= S.first[S.n]) return;
  int j = 0;
  while (idx >= S.first[j + 1]) ++j;
  const SumJob& J = S.job[j];
  const int local = idx - S.first[j];
  const int b = local / J.len, e = local % J.len;
  const int n = J.per_clip ? J.tiles : J.tiles * J.clips;
  const size_t row0 = J.per_clip ? (size_t)b * J.tiles : 0;
  float s = 0.f;
  for (int r = 0; r < n; ++r) s += J.part[(row0 + r) * J.stride + J.off + e];
  J.out[(size_t)b * J.ostride + e] = s;
}

inline cudaError_t launch_sums(Sums S, cudaStream_t stream) {
  S.first[0] = 0;
  for (int j = 0; j < S.n; ++j)
    S.first[j + 1] =
        S.first[j] + (S.job[j].per_clip ? S.job[j].clips : 1) * S.job[j].len;
  sums_kernel<<<cdiv(S.first[S.n], NT), NT, 0, stream>>>(S);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(NT, 1) rows_kernel(RArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  rprog(p, reinterpret_cast<float*>(smem));
}

// The forward's attention: q_attn as the backward's qa_kernel runs it,
// under its own name (a profile tells the two apart).
template <int H, bool CA>
__global__ void __launch_bounds__(NT, 1) fwd_attn_kernel(QArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  q_attn<H, CA>(p, reinterpret_cast<float*>(smem));
}

template <int H>
__global__ void __launch_bounds__(NT, 1) fwd_tail_kernel(QArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  qf_tail<H>(p, reinterpret_cast<float*>(smem));
}

template <int H, bool CA>
__global__ void __launch_bounds__(NT, 1) qa_kernel(QArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  q_attn<H, CA>(p, reinterpret_cast<float*>(smem));
}

template <int H>
__global__ void __launch_bounds__(NT, 1) qt_kernel(QArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  q_tail<H>(p, reinterpret_cast<float*>(smem));
}

template <int H>
__global__ void __launch_bounds__(NT, 1) qd_kernel(QArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  q_dq<H>(p, reinterpret_cast<float*>(smem));
}

template <int H>
__global__ void __launch_bounds__(NT, 1) k_kernel(KArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  kprog<H>(p, reinterpret_cast<float*>(smem));
}

__global__ void __launch_bounds__(NT) f_kernel(FArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  fprog(p, reinterpret_cast<float*>(smem));
}

// Host side. A persistent grid: min(items, ctas) CTAs.
inline int grid_of(int items, int ctas) { return items < ctas ? items : ctas; }

template <class K, class... A>
inline cudaError_t launch(K kernel, int items, int ctas, int threads,
                          int bytes, cudaStream_t stream, const A&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid_of(items, ctas), threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <int H, bool CA>
inline cudaError_t launch_q_heads(const QArgs& p, int ctas, cudaStream_t st) {
  const int items = p.clips * (p.S > 1 ? p.S : p.tiles);
  cudaError_t e = launch(qa_kernel<H, CA>, items, ctas, NT, QA_SMEM, st, p);
  if (e == cudaSuccess)
    e = launch(qt_kernel<H>, items, ctas, NT, QT_SMEM, st, p);
  if (e == cudaSuccess)
    e = launch(qd_kernel<H>, items, ctas, NT, QD_SMEM, st, p);
  return e;
}

// The query side's three programs, in order.
template <bool CA>
inline cudaError_t launch_q(const QArgs& p, int heads, int ctas,
                            cudaStream_t st) {
  return heads == 2   ? launch_q_heads<2, CA>(p, ctas, st)
         : heads == 4 ? launch_q_heads<4, CA>(p, ctas, st)
                      : launch_q_heads<8, CA>(p, ctas, st);
}

// The rows program (the forward's first launch; the backward's recompute).
inline cudaError_t launch_rows(const RArgs& p, int ctas, cudaStream_t st) {
  return launch(rows_kernel, p.clips * p.tiles, ctas, NT, R_SMEM, st, p);
}

// The forward's attention, then its tail (a CTA a tile of the query side).
template <int H, bool CA>
inline cudaError_t launch_fwd_heads(const QArgs& p, int ctas,
                                    cudaStream_t st) {
  const int items = p.clips * (p.S > 1 ? p.S : p.tiles);
  cudaError_t e =
      launch(fwd_attn_kernel<H, CA>, items, ctas, NT, QA_SMEM, st, p);
  if (e == cudaSuccess)
    e = launch(fwd_tail_kernel<H>, p.clips * p.tiles, ctas, NT, QF_SMEM, st,
               p);
  return e;
}

template <bool CA>
inline cudaError_t launch_fwd(const QArgs& p, int heads, int ctas,
                              cudaStream_t st) {
  return heads == 2   ? launch_fwd_heads<2, CA>(p, ctas, st)
         : heads == 4 ? launch_fwd_heads<4, CA>(p, ctas, st)
                      : launch_fwd_heads<8, CA>(p, ctas, st);
}

inline cudaError_t launch_k(const KArgs& p, int ctas, cudaStream_t st) {
  const int items = p.clips * (p.S > 1 ? p.S : p.tiles);
  return p.heads == 2   ? launch(k_kernel<2>, items, ctas, NT, K_SMEM, st, p)
         : p.heads == 4 ? launch(k_kernel<4>, items, ctas, NT, K_SMEM, st, p)
                        : launch(k_kernel<8>, items, ctas, NT, K_SMEM, st, p);
}

// The finishing program's warps a CTA: one (16 rows) on a short side (up to
// 64 rows: several CTAs a clip), 8 (128 rows) on a long one.
__host__ __device__ constexpr int f_warps(int N) { return N <= 64 ? 1 : NW; }

inline cudaError_t launch_f(FArgs p, int ctas, cudaStream_t st) {
  const int warps = f_warps(p.N);
  p.rows = warps * RB;
  p.tiles = cdiv(p.N, p.rows);
  return launch(f_kernel, p.clips * p.tiles, ctas, warps * 32, f_smem(warps),
                st, p);
}

}  // namespace dtc
}  // namespace f32ops
