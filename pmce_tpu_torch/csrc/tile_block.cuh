// The pre-norm transformer block as one tile program for Hopper (sm_90a),
// shared by the lifter trunk (lifter_trunk.cu, K1) and the training block's
// forward (block.cu, row 6).
//
// A thread block of 8 warps owns a tile of up to 128 rows made of whole
// attention groups (the J rows of a frame, or the T rows of a (clip, joint)
// column, gathered by index arithmetic; the training block's clips are
// frames of one "clip" of B * N rows: B = 1, T = clips, J = N) and runs the
// whole block on it:
//   LN1 (f32 statistics) into h, bf16 in shared memory;
//   per head: that head's q / k / v columns of h @ Wqkv on the tensor
//     cores (mma.sync m16n8k16, ldmatrix; +bias, q scaled in f32 before its
//     one bf16 rounding), attention of each 16-query tile over the 16-key
//     blocks its groups span, masked to the group (S = QK^T, online softmax
//     in f32 registers, P re-packed as bf16 A fragments, O = PV), and
//     O_h @ Wproj[head rows] added into an f32 accumulator in registers (128
//     floats a thread);
//   LN2 into h (bf16), then the MLP in hidden chunks of 64: h @ W1[:, chunk]
//     + b1, erf-GELU, bf16 in shared memory, then @ W2[chunk, :] added into
//     the accumulator;
//   + b2, the post-norm where there is one (the trunk's after rounding the
//     block output to bf16, plus the temporal pos-embed after block 0),
//     stored back to the tile's rows.
// The weights stream through a 3-stage ring of slices (128 rows of a
// head's q / k / v columns or of an fc1 chunk, a head's 32 Wproj rows, a
// chunk's 64 W2 rows; cp.async, one schedule over the whole tile, so the
// next product's first slices load while the current epilogue or attention
// runs).
//
// Two programs (template SAVE):
// - the trunk's (SAVE = false): the accumulator is the residual stream x +
//   bproj + ... ; only x is read from device memory and the output written:
//   no intermediate leaves the SM;
// - the training block's (SAVE = true): per-clip branch scales m1, m2
//   (stochastic depth) and saving epilogues. The accumulator holds a branch
//   (the attention's, then the MLP's); x1 = x + m1 * a goes to device
//   memory (the backward reads it) and comes back for y = x1 + m2 * mo; each
//   stage writes what the backward reads where it is made: h1 (LN1), the
//   head's q / k / v columns, its o, h2 (LN2), fc1's f32 output hh and its
//   GELU ge per chunk, f32 y before the post-norm, and the branches a, mo
//   where the mask gradients are owed.
#pragma once

#include "transformer_ops.cuh"

using namespace pmce;

namespace tb {

constexpr int TM = 128;            // rows of a tile (whole groups)
constexpr int CW = 256;            // C
constexpr int NTH = 256;           // 8 warps
constexpr int DHD = 32;            // head width
constexpr int HEADS = CW / DHD;
constexpr int KQ = 128;            // rows of a q/k/v or fc1 weight slice
constexpr int NSTAGE = 3;          // slices in the ring
constexpr int FC = 64;             // hidden columns per MLP chunk
constexpr int LDH = CW + 8;        // row strides (bf16) of the shared tiles;
constexpr int LDQ = 3 * DHD + 8;   // the 16-byte pad keeps ldmatrix free of
constexpr int LDO = DHD + 8;       // bank conflicts
constexpr int LDF = FC + 8;
constexpr int LDW_N = CW + 8;      // ring slices: proj [32, 256], fc2
constexpr int LDW_Q = 3 * DHD + 8; // [64, 256], qkv [128, 96], fc1
constexpr int LDW_F = FC + 8;      // [128, 64]
constexpr int STAGE_ELEMS = FC * LDW_N;
constexpr int SLICES_PER_HEAD = CW / KQ + 1;   // 2 qkv + 1 proj
constexpr int SLICES_PER_CHUNK = CW / KQ + 1;  // 2 fc1 + 1 fc2
static_assert(KQ * LDW_Q <= STAGE_ELEMS && KQ * LDW_F <= STAGE_ELEMS &&
                  DHD * LDW_N <= STAGE_ELEMS,
              "a weight slice over its ring stage");
constexpr int NSTAMP = 8;  // LN1, QKV, attention, proj, LN2, fc1, fc2, out

// Shared-memory plan, bytes.
constexpr int OFF_HS = 0;                                 // h: [128, 264]
constexpr int OFF_QKV = OFF_HS + TM * LDH * 2;            // [128, 104]
constexpr int OFF_OH = OFF_QKV + TM * LDQ * 2;            // [128, 40]
constexpr int OFF_HID = OFF_QKV;                          // [128, 72] alias
constexpr int OFF_RING = OFF_OH + TM * LDO * 2;
constexpr int OFF_RED = OFF_RING + NSTAGE * STAGE_ELEMS * 2;  // 2 x [128, 4]
constexpr int OFF_ROWS = OFF_RED + 2 * TM * 4 * 4;            // int [128]
constexpr int SMEM = OFF_ROWS + TM * 4;
static_assert(TM * LDF <= TM * (LDQ + LDO), "hidden chunk over q/k/v");

struct BlockArgs {
  const bf16* x;
  bf16* out;
  const bf16 *wqkv, *wproj, *w1, *w2;   // [C,3C], [C,C], [C,hid], [hid,C]
  const float *g1, *b1, *bqkv, *bproj, *g2, *b2, *bb1, *bb2;
  const float *pg, *pb, *tpe;           // post-norm (pg null: none); tpe
                                        // [T, C] or null
  int B, T, J, temporal, hid;
  float eps, post_eps, qscale;
  int round_y;                          // the block output rounded to bf16
                                        // before the post-norm (the trunk's)
  // The saving program (SAVE): per-group branch scales (null: 1) and the
  // state the backward reads, each null where it is not wanted; x1 is
  // always written (the MLP branch is added to it at the end).
  const float *m1, *m2;                 // [B * G]
  bf16 *h1, *qkv, *o, *h2, *ge;         // [M, C], [M, 3C], [M, C], [M, C],
                                        // [M, hid]
  float *x1, *hh, *y, *a, *mo;          // [M, C], [M, hid], [M, C] x 3
  long long* stamps;                    // [grid, NSTAMP] cycles (profile)
};

// Start loading weight slice s of the tile's schedule into its ring stage:
// per head 2 slices of 128 rows of Wqkv's q / k / v columns of that head,
// then Wproj's 32 head rows; then per MLP chunk 2 slices of 128 rows of
// W1[:, chunk] and W2's 64 chunk rows.
__device__ __forceinline__ void issue_slice(const BlockArgs& a, int s,
                                            bf16* ring) {
  bf16* dst = ring + (s % NSTAGE) * STAGE_ELEMS;
  const int tid = threadIdx.x;
  const int head_slices = HEADS * SLICES_PER_HEAD;
  if (s < head_slices) {
    const int h = s / SLICES_PER_HEAD, j = s % SLICES_PER_HEAD;
    if (j < CW / KQ) {
      for (int c = tid; c < KQ * 12; c += NTH) {
        const int r = c / 12, seg = c % 12 / 4, cc = c % 4 * 8;
        cp_async16(dst + r * LDW_Q + seg * DHD + cc,
                   a.wqkv + (size_t)(j * KQ + r) * (3 * CW) + seg * CW +
                       h * DHD + cc,
                   true);
      }
    } else {
      for (int c = tid; c < DHD * (CW / 8); c += NTH) {
        const int r = c / (CW / 8), cc = c % (CW / 8) * 8;
        cp_async16(dst + r * LDW_N + cc,
                   a.wproj + (size_t)(h * DHD + r) * CW + cc, true);
      }
    }
  } else {
    const int t = s - head_slices;
    const int ch = t / SLICES_PER_CHUNK, j = t % SLICES_PER_CHUNK;
    if (j < CW / KQ) {
      for (int c = tid; c < KQ * (FC / 8); c += NTH) {
        const int r = c / (FC / 8), cc = c % (FC / 8) * 8;
        cp_async16(dst + r * LDW_F + cc,
                   a.w1 + (size_t)(j * KQ + r) * a.hid + ch * FC + cc, true);
      }
    } else {
      for (int c = tid; c < FC * (CW / 8); c += NTH) {
        const int r = c / (CW / 8), cc = c % (CW / 8) * 8;
        cp_async16(dst + r * LDW_N + cc,
                   a.w2 + (size_t)(ch * FC + r) * CW + cc, true);
      }
    }
  }
}

// Wait for slice s and start slice s + NSTAGE - 1, whose stage slice s - 1
// used: every warp is past it once the barrier has passed (the barrier also
// orders every shared-memory write before it against the reads after).
__device__ __forceinline__ const bf16* ring_next(const BlockArgs& a, int& s,
                                                 int total, bf16* ring) {
  cp_async_wait_one();
  __syncthreads();
  if (s + NSTAGE - 1 < total) issue_slice(a, s + NSTAGE - 1, ring);
  cp_async_commit();
  const bf16* st = ring + (s % NSTAGE) * STAGE_ELEMS;
  ++s;
  return st;
}

// Cycles per stage of the profile instantiation: thread 0 books the time
// since the last stamp to `kind` after a block-wide barrier.
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

// acc (a warp's 32 rows hm * 32 .. by 48 columns hn * 48 .. of a head's
// q | k | v) += the tile h (row stride LDH) x Wqkv slice j (w: [KQ, 96] at
// row stride LDW_Q, rows j * KQ ..).
__device__ __forceinline__ void qkv_slice(float (&acc)[2][6][4],
                                          const bf16* hs, const bf16* w,
                                          int j, int hm, int hn) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int kk = 0; kk < KQ; kk += 16) {
    unsigned af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(af[mi], hs + (hm * 32 + mi * 16 + (lane & 15)) * LDH +
                          j * KQ + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < 3; ++nb) {
      unsigned bf[4];
      ldsm_x4_t(bf, w + (kk + (lane & 15)) * LDW_Q + hn * 48 + nb * 16 +
                        (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * nb], af[mi], bf[0], bf[1]);
        mma_bf16(acc[mi][2 * nb + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// Head h's q | k | v block of a warp into the tile qkv (row stride LDQ):
// + bqkv, q scaled in f32 before its one bf16 rounding.
__device__ __forceinline__ void qkv_epilogue(const float (&acc)[2][6][4],
                                             bf16* qkv, const float* bqkv,
                                             int h, float qscale, int hm,
                                             int hn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nj = 0; nj < 6; ++nj) {
    const int lc = hn * 48 + nj * 8 + 2 * tq;
    const int gc = lc / DHD * CW + h * DHD + lc % DHD;
    const float sc = lc < DHD ? qscale : 1.f;
    const float bz0 = bqkv[gc], bz1 = bqkv[gc + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = hm * 32 + mi * 16 + g + 8 * hf;
        *reinterpret_cast<unsigned*>(qkv + r * LDQ + lc) =
            pack_bf2((acc[mi][nj][2 * hf] + bz0) * sc,
                     (acc[mi][nj][2 * hf + 1] + bz1) * sc);
      }
  }
}

// x1 (a warp's 64 x 64 block: rows wm * 64 .., columns wn * 64 ..) += O_h
// (oh, row stride LDO) x Wproj's head rows (w: [32, 256] at LDW_N).
__device__ __forceinline__ void proj_slice(float (&x1)[4][8][4],
                                           const bf16* oh, const bf16* w,
                                           int wm, int wn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DHD; kk += 16) {
    unsigned af[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldsm_x4(af[i], oh + (wm * 64 + i * 16 + (lane & 15)) * LDO + kk +
                         (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      unsigned bf[4];
      ldsm_x4_t(bf, w + (kk + (lane & 15)) * LDW_N + wn * 64 + nb * 16 +
                        (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma_bf16(x1[i][2 * nb], af[i], bf[0], bf[1]);
        mma_bf16(x1[i][2 * nb + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// Row stride of a [256, 32] slice of W^T's columns (gemm_wide's B).
constexpr int LDW_C = DHD + 8;

// The B fragments of two n8 tiles (n0, n0 + 8) for k16 at k0 from a slice in
// [n, k] order: b[0], b[1] tile n0; b[2], b[3] tile n0 + 8.
__device__ __forceinline__ void ldsm_b_nk(unsigned (&b)[4], const bf16* w,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, w + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// acc[128, 256] += A[:, col0 .. col0 + 32] @ W^T, W a [256, 32] slice in
// [n, k] order at row stride LDW_C (a block of 32 columns of W^T read from
// W's own rows); warp (wm, wn) owns rows wm*64.., columns wn*64.. .
__device__ __forceinline__ void gemm_wide(const bf16* A, int lda, int col0,
                                          const bf16* w, int wm, int wn,
                                          float (&acc)[4][8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 32; kk += 16) {
    unsigned af[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldsm_x4(af[i], A + (wm * 64 + i * 16 + (lane & 15)) * lda + col0 + kk +
                         (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      unsigned bf[4];
      ldsm_b_nk(bf, w, LDW_C, wn * 64 + nb * 16, kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma_bf16(acc[i][2 * nb], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][2 * nb + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// Per-row mean and 1/sqrt(var + eps) of the f32 [128, 256] values held in
// accumulator layout (warp (wm, wn) owns rows wm*64.., columns wn*64..):
// quad sums, then the four column warps' partials added in a fixed order.
__device__ __forceinline__ void row_stats(const float (&v)[4][8][4],
                                          float* red, int wm, int wn,
                                          float eps, float (&mean)[4][2],
                                          float (&rstd)[4][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float* red2 = red + TM * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sm = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sm += v[i][j][2 * hf] + v[i][j][2 * hf + 1];
      sm += __shfl_xor_sync(0xffffffffu, sm, 1);
      sm += __shfl_xor_sync(0xffffffffu, sm, 2);
      if (tq == 0) red[(wm * 64 + i * 16 + g + 8 * hf) * 4 + wn] = sm;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* rr = red + (wm * 64 + i * 16 + g + 8 * hf) * 4;
      const float mu = (((rr[0] + rr[1]) + rr[2]) + rr[3]) * (1.0f / CW);
      mean[i][hf] = mu;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d0 = v[i][j][2 * hf] - mu, d1 = v[i][j][2 * hf + 1] - mu;
        q += d0 * d0 + d1 * d1;
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if (tq == 0) red2[(wm * 64 + i * 16 + g + 8 * hf) * 4 + wn] = q;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* rr = red2 + (wm * 64 + i * 16 + g + 8 * hf) * 4;
      const float var = (((rr[0] + rr[1]) + rr[2]) + rr[3]) * (1.0f / CW);
      rstd[i][hf] = rsqrtf(fmaxf(var, 0.f) + eps);
    }
}

// One head's attention for the warp's 16 queries (rows q0..q0+15 of the
// tile): keys of the 16-key blocks that the queries' groups span, masked
// to each query's group; q / k / v in qkv (columns 0, 32, 64), the output
// (bf16, normalised) into oh.
__device__ __forceinline__ void head_attention(const bf16* qkv, bf16* oh,
                                               int q0, int n, int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  if (q0 >= nrows) {
    for (int e = lane; e < 16 * 4; e += 32)
      *reinterpret_cast<uint4*>(oh + (q0 + e / 4) * LDO + e % 4 * 8) =
          make_uint4(0, 0, 0, 0);
    return;
  }
  const int g_lo = q0 / n, g_hi = min(q0 + 15, nrows - 1) / n;
  const int k_beg = g_lo * n / 16 * 16, k_end = (g_hi + 1) * n;
  unsigned qa[2][4];
  ldsm_x4(qa[0], qkv + (q0 + (lane & 15)) * LDQ + (lane >> 4) * 8);
  ldsm_x4(qa[1], qkv + (q0 + (lane & 15)) * LDQ + 16 + (lane >> 4) * 8);
  const int r0 = q0 + g, r1 = r0 + 8;
  const int grp0 = r0 / n, grp1 = r1 / n;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  for (int kb = k_beg; kb < k_end; kb += 16) {
    float sc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
      unsigned kf[4];
      ldsm_x4(kf, qkv + (kb + t * 8 + (lane & 7)) * LDQ + DHD +
                      (lane >> 3) * 8);
      mma_bf16(sc[t], qa[0], kf[0], kf[1]);
      mma_bf16(sc[t], qa[1], kf[2], kf[3]);
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kb + t * 8 + 2 * tq + e;
        const bool in = key < k_end;
        if (!(in && key / n == grp0)) sc[t][e] = -INFINITY;
        if (!(in && key / n == grp1)) sc[t][2 + e] = -INFINITY;
        mx0 = fmaxf(mx0, sc[t][e]);
        mx1 = fmaxf(mx1, sc[t][2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // A row with no key yet keeps max -inf: its probabilities are 0.
    const float c0 = mn0 == -INFINITY ? 1.f : expf(m0 - mn0);
    const float c1 = mn1 == -INFINITY ? 1.f : expf(m1 - mn1);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[t][e] = mn0 == -INFINITY ? 0.f : expf(sc[t][e] - mn0);
        sc[t][2 + e] = mn1 == -INFINITY ? 0.f : expf(sc[t][2 + e] - mn1);
      }
    l0 = l0 * c0 + ((sc[0][0] + sc[0][1]) + (sc[1][0] + sc[1][1]));
    l1 = l1 * c1 + ((sc[0][2] + sc[0][3]) + (sc[1][2] + sc[1][3]));
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      o[d][0] *= c0;
      o[d][1] *= c0;
      o[d][2] *= c1;
      o[d][3] *= c1;
    }
    const unsigned pa[4] = {pack_bf2(sc[0][0], sc[0][1]),
                            pack_bf2(sc[0][2], sc[0][3]),
                            pack_bf2(sc[1][0], sc[1][1]),
                            pack_bf2(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      unsigned vf[4];
      ldsm_x4_t(vf, qkv + (kb + (lane & 15)) * LDQ + 2 * DHD + dp * 16 +
                        (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = l0 > 0.f ? 1.0f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.0f / l1 : 0.f;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int c = d * 8 + 2 * tq;
    *reinterpret_cast<unsigned*>(oh + r0 * LDO + c) =
        pack_bf2(o[d][0] * i0, o[d][1] * i0);
    *reinterpret_cast<unsigned*>(oh + r1 * LDO + c) =
        pack_bf2(o[d][2] * i1, o[d][3] * i1);
  }
}

// The saving program's stores of a tile's bf16 rows: cols [c0, c0 + w) of
// each row r < TM of the shared tile (row stride ld) to dst's rows rows[r]
// (row stride ldd), 16 bytes a thread; rows past the tile's groups skipped.
// The saved state is written evict-first (st.global.cs), as all of its
// stores are: ~160 MB a block, read only by the backward, which would
// otherwise push the weights every tile reads out of L2.
__device__ __forceinline__ void store_rows(const bf16* tile, int ld, int w,
                                           const int* rows, bf16* dst,
                                           size_t ldd, int c0) {
  const int per = w / 8;
  for (int c = threadIdx.x; c < TM * per; c += NTH) {
    const int r = c / per, cc = c % per * 8;
    if (rows[r] >= 0)
      __stcs(reinterpret_cast<uint4*>(dst + (size_t)rows[r] * ldd + c0 + cc),
             *reinterpret_cast<const uint4*>(tile + r * ld + cc));
  }
}

// The whole pre-norm block on a tile of whole groups. SAVE = false: the
// trunk's program (the f32 residual x + bproj + O @ Wproj + MLP in
// registers, only the output written). SAVE = true: the training block's
// program: the registers hold a branch (bproj + O @ Wproj, then the MLP's
// bb2 + GELU(..) @ W2), x1 = x + m1 * branch goes to device memory and comes
// back for y = x1 + m2 * branch, and the saving epilogues write what the
// backward reads (h1, qkv, o, x1, h2, hh, ge, y and the branches a, mo,
// each where its pointer is set).
template <bool PROF, bool SAVE>
__global__ void __launch_bounds__(NTH, 1) tile_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem + OFF_HS);
  bf16* qkv = reinterpret_cast<bf16*>(smem + OFF_QKV);
  bf16* oh = reinterpret_cast<bf16*>(smem + OFF_OH);
  bf16* hid = reinterpret_cast<bf16*>(smem + OFF_HID);
  bf16* ring = reinterpret_cast<bf16*>(smem + OFF_RING);
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  int* rows = reinterpret_cast<int*>(smem + OFF_ROWS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // residual tile: 64 x 64
  const int hm = warp >> 1, hn = warp & 1;  // q/k/v and fc1 tiles: 32 rows
  StageClock<PROF> clk;
  clk.start();

  const int n = a.temporal ? a.T : a.J;  // tokens per group
  const int G = a.temporal ? a.J : a.T;  // groups per clip
  const int gpt = TM / n;
  const int gi0 = blockIdx.x * gpt;
  const int nrows = min(gpt, a.B * G - gi0) * n;
  const int total = HEADS * SLICES_PER_HEAD + a.hid / FC * SLICES_PER_CHUNK;
  int s = 0;
  issue_slice(a, 0, ring);
  cp_async_commit();
  issue_slice(a, 1, ring);
  cp_async_commit();

  // Tile row r -> token row: member r % n of group gi0 + r / n.
  for (int r = tid; r < TM; r += NTH) {
    int row = -1;
    if (r < nrows) {
      const int gi = gi0 + r / n, i = r % n, b = gi / G, gg = gi % G;
      row = b * a.T * a.J + (a.temporal ? gg + i * a.J : gg * a.J + i);
    }
    rows[r] = row;
  }
  __syncthreads();
  // The x tile into h (rows past the tile's groups are zeros).
  for (int c = tid; c < TM * (CW / 8); c += NTH) {
    const int r = c / (CW / 8), cc = c % (CW / 8) * 8;
    if (rows[r] >= 0)
      cp_async16(hs + r * LDH + cc, a.x + (size_t)rows[r] * CW + cc, true);
    else
      *reinterpret_cast<uint4*>(hs + r * LDH + cc) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // The f32 accumulator in accumulator layout: the residual stream x + bproj
  // (trunk), or the attention branch, bproj first (SAVE).
  float x1[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + i * 16 + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = wn * 64 + j * 8 + 2 * tq;
        float2 xv = make_float2(0.f, 0.f);
        if constexpr (!SAVE)
          xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(hs + r * LDH + c));
        x1[i][j][2 * hf] = xv.x + a.bproj[c];
        x1[i][j][2 * hf + 1] = xv.y + a.bproj[c + 1];
      }
    }
  __syncthreads();

  // LN1 in place: a warp per row, 8 channels a lane, f32 statistics.
  for (int r = warp; r < TM; r += NTH / 32) {
    uint4* dst = reinterpret_cast<uint4*>(hs + r * LDH + lane * 8);
    float v[8];
    load8(hs + r * LDH + lane * 8, v);
    float sm = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sm += v[i];
    const float mu = warp_sum(sm) * (1.0f / CW);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] -= mu;
      q += v[i] * v[i];
    }
    const float inv = rsqrtf(warp_sum(q) * (1.0f / CW) + a.eps);
    unsigned pk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane * 8 + 2 * i;
      pk[i] = pack_bf2(v[2 * i] * inv * a.g1[c] + a.b1[c],
                       v[2 * i + 1] * inv * a.g1[c + 1] + a.b1[c + 1]);
    }
    *dst = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    if constexpr (SAVE) {
      if (a.h1 && rows[r] >= 0)
        __stcs(reinterpret_cast<uint4*>(a.h1 + (size_t)rows[r] * CW +
                                        lane * 8),
               make_uint4(pk[0], pk[1], pk[2], pk[3]));
    }
  }
  clk(0);

  for (int h = 0; h < HEADS; ++h) {
    // q / k / v of head h: [128, 96], a warp 32 rows x 48 columns.
    float acc[2][6][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 6; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    for (int j = 0; j < CW / KQ; ++j)
      qkv_slice(acc, hs, ring_next(a, s, total, ring), j, hm, hn);
    qkv_epilogue(acc, qkv, a.bqkv, h, a.qscale, hm, hn);
    __syncthreads();
    if constexpr (SAVE) {
      // The head's q | k | v columns of the saved [M, 3C] qkv.
      if (a.qkv)
        for (int c = tid; c < TM * 12; c += NTH) {
          const int r = c / 12, seg = c % 12 / 4, cc = c % 4 * 8;
          if (rows[r] >= 0)
            __stcs(reinterpret_cast<uint4*>(a.qkv + (size_t)rows[r] * (3 * CW) +
                                            seg * CW + h * DHD + cc),
                   *reinterpret_cast<const uint4*>(qkv + r * LDQ + seg * DHD +
                                                   cc));
        }
    }
    clk(1);
    head_attention(qkv, oh, warp * 16, n, nrows);
    if constexpr (SAVE) {
      // The warp's 16 rows of the head's output, into the saved o.
      __syncwarp();
      if (a.o)
        for (int e = lane; e < 16 * 4; e += 32) {
          const int r = warp * 16 + e / 4, cc = e % 4 * 8;
          if (rows[r] >= 0)
            __stcs(reinterpret_cast<uint4*>(a.o + (size_t)rows[r] * CW +
                                            h * DHD + cc),
                   *reinterpret_cast<const uint4*>(oh + r * LDO + cc));
        }
    }
    clk(2);
    // x1 += O_h @ Wproj[head rows]: K = 32.
    proj_slice(x1, oh, ring_next(a, s, total, ring), wm, wn);
    clk(3);
  }

  if constexpr (SAVE) {
    // The attention branch a (saved where wanted), then x1 = x + m1 * a,
    // written to device memory (y adds the MLP branch to it at the end) and
    // kept in the accumulator for LN2.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A row block's x values are loaded before any of its stores, so
      // the loads are not held behind the stores (they may alias).
      float2 xv[2][8];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = rows[wm * 64 + i * 16 + g + 8 * hf];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xv[hf][j] = row >= 0
                          ? __bfloat1622float2(
                                *reinterpret_cast<const __nv_bfloat162*>(
                                    a.x + (size_t)row * CW + wn * 64 +
                                    j * 8 + 2 * tq))
                          : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm * 64 + i * 16 + g + 8 * hf;
        const int row = rows[r];
        const float sc = (a.m1 && row >= 0) ? a.m1[gi0 + r / n] : 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = wn * 64 + j * 8 + 2 * tq;
          float2 v = make_float2(0.f, 0.f);
          if (row >= 0) {
            const size_t o = (size_t)row * CW + c;
            const float2 br =
                make_float2(x1[i][j][2 * hf], x1[i][j][2 * hf + 1]);
            if (a.a) __stcs(reinterpret_cast<float2*>(a.a + o), br);
            v = make_float2(xv[hf][j].x + sc * br.x,
                            xv[hf][j].y + sc * br.y);
            *reinterpret_cast<float2*>(a.x1 + o) = v;
          }
          x1[i][j][2 * hf] = v.x;
          x1[i][j][2 * hf + 1] = v.y;
        }
      }
    }
  }

  // LN2 from the residual stream into h.
  float mean[4][2], rstd[4][2];
  row_stats(x1, red, wm, wn, a.eps, mean, rstd);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + i * 16 + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = wn * 64 + j * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(hs + r * LDH + c) = pack_bf2(
            (x1[i][j][2 * hf] - mean[i][hf]) * rstd[i][hf] * a.g2[c] +
                a.b2[c],
            (x1[i][j][2 * hf + 1] - mean[i][hf]) * rstd[i][hf] * a.g2[c + 1] +
                a.b2[c + 1]);
      }
    }
  if constexpr (SAVE) {
    __syncthreads();
    if (a.h2) store_rows(hs, LDH, CW, rows, a.h2, CW, 0);
    // The accumulator takes the MLP branch.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x1[i][j][e] = 0.f;
  }
  clk(4);

  for (int ch = 0; ch < a.hid / FC; ++ch) {
    // fc1 chunk: [128, 64], a warp 32 rows x 32 columns; GELU into hid.
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    for (int j = 0; j < CW / KQ; ++j) {
      const bf16* w = ring_next(a, s, total, ring);
#pragma unroll 4
      for (int kk = 0; kk < KQ; kk += 16) {
        unsigned af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(af[mi], hs + (hm * 32 + mi * 16 + (lane & 15)) * LDH +
                              j * KQ + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          unsigned bf[4];
          ldsm_x4_t(bf, w + (kk + (lane & 15)) * LDW_F + hn * 32 + nb * 16 +
                            (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nb], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * nb + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int c = hn * 32 + nj * 8 + 2 * tq;
      const float bz0 = a.bb1[ch * FC + c], bz1 = a.bb1[ch * FC + c + 1];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = hm * 32 + mi * 16 + g + 8 * hf;
          const float h0 = acc[mi][nj][2 * hf] + bz0;
          const float h1 = acc[mi][nj][2 * hf + 1] + bz1;
          if constexpr (SAVE) {
            if (a.hh && rows[r] >= 0)
              __stcs(reinterpret_cast<float2*>(a.hh + (size_t)rows[r] * a.hid +
                                               ch * FC + c),
                     make_float2(h0, h1));
          }
          *reinterpret_cast<unsigned*>(hid + r * LDF + c) =
              pack_bf2(gelu_erf(h0), gelu_erf(h1));
        }
    }
    clk(5);
    // x1 += hid @ W2[chunk rows]: one slice of 64 rows.
    {
      const bf16* w = ring_next(a, s, total, ring);
      if constexpr (SAVE) {
        if (a.ge) store_rows(hid, LDF, FC, rows, a.ge, a.hid, ch * FC);
      }
#pragma unroll 2
      for (int kk = 0; kk < FC; kk += 16) {
        unsigned af[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldsm_x4(af[i], hid + (wm * 64 + i * 16 + (lane & 15)) * LDF + kk +
                             (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          unsigned bf[4];
          ldsm_x4_t(bf, w + (kk + (lane & 15)) * LDW_N + wn * 64 + nb * 16 +
                            (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma_bf16(x1[i][2 * nb], af[i], bf[0], bf[1]);
            mma_bf16(x1[i][2 * nb + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    clk(6);
  }

  // + b2: the block output y (SAVE: x1 + m2 * (mo = the MLP branch + b2),
  // mo and f32 y saved where wanted); rounded to bf16 before the post-norm
  // where the trunk rounds it; the post-norm (and the temporal pos-embed),
  // staged in h and stored row by row.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // SAVE: the row block's x1 values loaded before any of its stores.
    float2 xv[2][8];
    if constexpr (SAVE) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = rows[wm * 64 + i * 16 + g + 8 * hf];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xv[hf][j] = row >= 0 ? *reinterpret_cast<const float2*>(
                                     a.x1 + (size_t)row * CW + wn * 64 +
                                     j * 8 + 2 * tq)
                               : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + i * 16 + g + 8 * hf;
      const int row = rows[r];
      float sc = 1.f;
      if constexpr (SAVE) sc = (a.m2 && row >= 0) ? a.m2[gi0 + r / n] : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = wn * 64 + j * 8 + 2 * tq;
        float v0 = x1[i][j][2 * hf] + a.bb2[c];
        float v1 = x1[i][j][2 * hf + 1] + a.bb2[c + 1];
        if constexpr (SAVE) {
          if (row >= 0) {
            const size_t o = (size_t)row * CW + c;
            if (a.mo) __stcs(reinterpret_cast<float2*>(a.mo + o),
                             make_float2(v0, v1));
            v0 = xv[hf][j].x + sc * v0;
            v1 = xv[hf][j].y + sc * v1;
            if (a.y) __stcs(reinterpret_cast<float2*>(a.y + o),
                            make_float2(v0, v1));
          } else {
            v0 = v1 = 0.f;
          }
        }
        if (a.round_y) {
          v0 = rbf(v0);
          v1 = rbf(v1);
        }
        x1[i][j][2 * hf] = v0;
        x1[i][j][2 * hf + 1] = v1;
      }
    }
  }
  if (a.pg) row_stats(x1, red, wm, wn, a.post_eps, mean, rstd);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + i * 16 + g + 8 * hf;
      const int row = rows[r];
      const float* tp =
          (a.tpe && row >= 0) ? a.tpe + (size_t)(row % (a.T * a.J) / a.J) * CW
                              : nullptr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = wn * 64 + j * 8 + 2 * tq;
        float y0 = x1[i][j][2 * hf], y1 = x1[i][j][2 * hf + 1];
        if (a.pg) {
          y0 = (y0 - mean[i][hf]) * rstd[i][hf] * a.pg[c] + a.pb[c];
          y1 = (y1 - mean[i][hf]) * rstd[i][hf] * a.pg[c + 1] + a.pb[c + 1];
        }
        if (tp) {
          y0 = rbf(y0) + tp[c];
          y1 = rbf(y1) + tp[c + 1];
        }
        *reinterpret_cast<unsigned*>(hs + r * LDH + c) = pack_bf2(y0, y1);
      }
    }
  __syncthreads();
  for (int r = warp; r < nrows; r += NTH / 32)
    *reinterpret_cast<uint4*>(a.out + (size_t)rows[r] * CW + lane * 8) =
        *reinterpret_cast<const uint4*>(hs + r * LDH + lane * 8);
  clk(7);
  clk.write(a.stamps + (size_t)blockIdx.x * NSTAMP);
}

template <bool PROF, bool SAVE>
static int launch_tile_block(const BlockArgs& a, cudaStream_t s) {
  const int n = a.temporal ? a.T : a.J;
  const int G = a.temporal ? a.J : a.T;
  if (n <= 0 || n > TM || a.hid <= 0 || a.hid % FC || a.B <= 0 ||
      (SAVE && a.x1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gpt = TM / n;
  const int grid = (a.B * G + gpt - 1) / gpt;
  cudaError_t e = cudaFuncSetAttribute(
      tile_block_kernel<PROF, SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_block_kernel<PROF, SAVE><<<grid, NTH, SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The four instantiations by the stamps buffer and the saving pointer.
static inline int launch_tile_block(const BlockArgs& a, cudaStream_t s) {
  if (a.x1)
    return a.stamps ? launch_tile_block<true, true>(a, s)
                    : launch_tile_block<false, true>(a, s);
  return a.stamps ? launch_tile_block<true, false>(a, s)
                  : launch_tile_block<false, false>(a, s);
}

}  // namespace tb
