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
// work, ~19 and ~38 us at 989 TFLOP/s); the activations the backward must
// read (~110 MB the forward saved) and the gradient operands it writes
// (~60 MB) take ~50 us at 3.35 TB/s. Memory and the tensor cores bound it
// about equally, so the backward keeps its row gradients on the SM and
// runs in two launches.
//
// Forward, one launch (row 6): the tile program of tile_block.cuh, shared
// with the lifter trunk (K1), on tiles of up to 128 rows of whole clips
// (B = 1, T = clips, J = N in its group addressing, so the tiles are the
// backward's), with its saving program: per-clip branch scales m1, m2, and
// epilogues that write what the backward reads (h1, qkv, o, x1 f32, h2, hh
// f32, ge, y f32 and, where the mask gradients are owed, the branches a and
// mo) where each is made, ~9.2 KB a row at hid 512 (~160 MB a block at
// batch 64, ~48 us at the HBM rate: the saving forward is bound by bytes).
// Without a gradient and without masks it writes only the output.
//
// Backward, two launches:
// - the tile program (bb::block_bwd_tile_kernel): a thread block of 8
//   warps owns a tile of up to 128 rows of whole clips and runs the whole
//   activation-gradient chain on it: the post-norm backward and m2 * gy;
//   fc2^T (per block of 256 hidden units, m2 gy @ W2^T, then * gelu'(hh));
//   fc1^T (dh2 = dhh @ W1^T); the LN2 backward plus the residual and m1 *
//   dx1; proj^T (dO = da @ Wproj^T); per head the attention backward of
//   each (clip, head) on the tensor cores (softmax statistics and D = sum
//   P dP in one online pass over the keys of the query rows' clips, then dq
//   by query tiles and dk, dv by key tiles: no atomics); qkv^T (dh1 = dqkv
//   @ Wqkv^T); the LN1 backward plus the residual. The four products run on
//   the tensor cores (mma.sync m16n8k16, ldmatrix) into one f32 [128, 256]
//   accumulator, 128 registers a thread; their B operands stream through a
//   3-stage cp.async ring as [256, 32] column blocks of W^T read from W's
//   own [in, out] layout (ldmatrix without .trans), so no weight is
//   transposed, and their A operands as the matching columns of the tile's
//   own rows of m2 gy, dhh, da and dqkv, which an earlier stage wrote to
//   device memory (the weight products need them there anyway). The
//   LayerNorm backwards and fc2^T's epilogue run a warp a row from the
//   accumulator parked in shared memory: row sums by shuffles, 16-byte
//   loads. A second f32 [128, 256] value does not fit beside the
//   accumulator, so the residual gradient (gy, then dx1) waits in an f32
//   scratch of the tile's own rows. It writes dx, the bf16 operands of the
//   weight products, per-tile column partials of the vector gradients
//   (fixed order inside the tile) and the per-clip mask gradients (each
//   clip lies in one tile). What holds it above its bound: mma.sync issue
//   and latency with 8 warps an SM, a barrier per ring slice, and two
//   waves of tiles at the Stage-1 shapes (147 / 136 tiles on 132 SMs).
// - the weight gradients (wgrad.cuh, shared with ca_block.cu): the four
//   X^T dY products over K = M rows in one launch over a list of 128 x 128
//   output tiles, each cut into 4 fixed K ranges; the CTA that finishes a
//   tile's last range (an integer counter) adds the ranges' partials in
//   range order, and the CTAs past the tiles add the tile program's vector
//   partials in tile order. No float atomics: two runs give the same gradients bit for
//   bit.

#include "tile_block.cuh"
#include "wgrad.cuh"

using namespace pmce;

namespace bb {

// ---------------------------------------------------------------------------
// The backward tile program (block_bwd_tile_kernel): one thread block of 8
// warps owns a tile of up to 128 rows made of whole clips and runs the
// activation-gradient chain of the block on it.
// ---------------------------------------------------------------------------
constexpr int TM = 128;            // rows of a tile (whole clips)
constexpr int CW = 256;            // C
constexpr int NTH = 256;           // 8 warps
constexpr int DHD = 32;            // head width
constexpr int HEADS = CW / DHD;
constexpr int FC = 32;             // hidden columns per MLP chunk
constexpr int LDA = CW + 8;        // row strides (bf16) of the shared tiles;
constexpr int LDQ = 3 * DHD + 8;   // (the 16-byte pad keeps ldmatrix free
                                   // of bank conflicts)
constexpr int LDW_C = DHD + 8;     // ring slices: [256, 32] columns of W^T
                                   // with the tile's [128, 32] A columns
constexpr int WIDE_ELEMS = CW * LDW_C + TM * LDW_C;
constexpr int NSTAGE = 3;
static_assert(FC == DHD, "MLP chunks and heads share the slice shapes");
// Stages of the stamped instantiation.
constexpr int NSTAMP = 8;  // post-norm, fc2^T, fc1^T, LN2, proj^T,
                           // attention, qkv^T, LN1

// Shared-memory plan, bytes. The f32 accumulator goes to Vs for the
// LayerNorm backwards and the fc2^T epilogue (a warp a row), when none of
// the tiles over it is live; the ring lies over As (dO, bf16, for the
// attention) and the start of Vs.
constexpr int LDV = CW + 4;                            // f32 row stride
constexpr int OFF_A = 0;                               // [128, 264] bf16
constexpr int OFF_V = OFF_A + TM * LDA * 2;            // [128, 260] f32
constexpr int OFF_Q = OFF_V;                           // [128, 104] q|k|v
constexpr int OFF_DQ = OFF_Q + TM * LDQ * 2;           // [128, 104] dq|dk|dv
constexpr int OFF_RING = 0;
constexpr int OFF_COL = OFF_V + TM * LDV * 4;          // [8, 256] f32
constexpr int OFF_STAT = OFF_COL + 8 * CW * 4;         // [128, 3] f32
constexpr int OFF_ROWD = OFF_STAT + TM * 3 * 4;        // [128] f32
constexpr int SMEM = OFF_ROWD + TM * 4;
static_assert(OFF_RING + NSTAGE * WIDE_ELEMS * 2 <= OFF_DQ,
              "the ring over the tiles it may overwrite");
// STAT columns, per head: the softmax max, 1/sum and D = sum_j P dP of each
// query row.
enum { ST_M = 0, ST_L, ST_D, NST };

// Per-tile column partials, one row of `part` a tile (the layout the host's
// _block_bwd_cuda reads): g1, b1, bqkv (3C), bproj, g2, b2, bb1 (hid), bb2,
// gp, bp.
__host__ __device__ constexpr int vec_len(int hid) { return 11 * CW + hid; }
enum { V_G1 = 0, V_B1 = CW, V_BQKV = 2 * CW, V_BPROJ = 5 * CW, V_G2 = 6 * CW,
       V_B2 = 7 * CW, V_BB1 = 8 * CW };

struct BwdArgs {
  const bf16 *gout, *x;      // [M, C]
  const float* y;            // [M, C] pre-post-norm output, or null
  const float* x1;           // [M, C]
  const float* hh;           // [M, hid] fc1 output before GELU
  const bf16* qkv;           // [M, 3C], q pre-scaled
  const float *a, *mo;       // [M, C] branch outputs (mask gradients) or null
  const bf16 *wqkv, *wproj, *w1, *w2;  // [C,3C], [C,C], [C,hid], [hid,C]
  const float *g1, *g2, *gp;           // LayerNorm scales (gp: post-norm)
  const float *m1, *m2;                // per-clip branch scales or null
  float* gbuf;               // [M, C] f32 scratch: gy, then dx1
  bf16 *m2g, *dhh, *da, *dqkv, *dx;    // the weight products' operands, dx
  float* part;               // [tiles, vec_len(hid)]
  float *dm1, *dm2;          // [clips] or null
  int clips, N, hid;
  float eps, post_eps, qscale;
  long long* stamps;         // [tiles, NSTAMP] cycles (profile)
};

// The weight slices of one phase of the tile program stream through a
// 3-stage cp.async ring. A slice is a [256, 32] block of columns of W^T's
// K, the B operand of its product in [n, k] order (ldmatrix without
// .trans reads W^T's fragments from W's own [in, out] layout: the weights
// are never transposed), with the tile's A columns of the same K
// [128, 32] from device memory (this tile's own rows, written by an
// earlier phase): fc2^T, per block of 256 hidden units, W2's columns of a
// K chunk with m2g's; fc1^T W1's columns of a hidden chunk with dhh's;
// proj^T Wproj's with da's; qkv^T Wqkv's columns of a head's q, k or v
// with dqkv's.
enum { PH_W2 = 0, PH_W1, PH_WPROJ, PH_WQKV };

struct Ring {
  bf16* base;
  int phase, total, s, blk;
  size_t row0;
  int nrows;

  __device__ __forceinline__ void issue(const BwdArgs& a, int k) const {
    bf16* dst = base + (k % NSTAGE) * WIDE_ELEMS;
    const int tid = threadIdx.x;
    const bf16 *cols, *acol;
    long long ld;
    int nlim = CW;  // W^T columns (rows of the slice) that exist
    if (phase == PH_W2) {
      cols = a.w2 + (size_t)blk * CW * CW + k * FC;
      acol = a.m2g + k * FC;
      ld = CW;
      nlim = min(CW, a.hid - blk * CW);
    } else if (phase == PH_W1) {
      cols = a.w1 + k * FC;
      acol = a.dhh + k * FC;
      ld = a.hid;
    } else if (phase == PH_WPROJ) {
      cols = a.wproj + k * FC;
      acol = a.da + k * FC;
      ld = CW;
    } else {
      const int off = k % 3 * CW + k / 3 * DHD;  // segment, head
      cols = a.wqkv + off;
      acol = a.dqkv + off;
      ld = 3 * CW;
    }
    for (int c = tid; c < CW * 4; c += NTH) {
      const int r = c / 4, cc = c % 4 * 8;
      const bool ok = r < nlim;
      cp_async16(dst + r * LDW_C + cc, cols + (size_t)(ok ? r : 0) * ld + cc,
                 ok);
    }
    bf16* adst = dst + CW * LDW_C;
    for (int c = tid; c < TM * 4; c += NTH) {
      const int r = c / 4, cc = c % 4 * 8;
      const bool ok = r < nrows;
      cp_async16(adst + r * LDW_C + cc,
                 acol + (row0 + (ok ? r : 0)) * ld + cc, ok);
    }
  }

  // Begin a phase: every earlier copy has landed and every thread's writes
  // (the A columns in device memory among them) are visible to the block.
  __device__ __forceinline__ void start(const BwdArgs& a, int ph, int n) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __threadfence_block();
    __syncthreads();
    phase = ph;
    total = n;
    s = 0;
    issue(a, 0);
    cp_async_commit();
    if (n > 1) issue(a, 1);
    cp_async_commit();
  }

  // Wait for slice s and start slice s + NSTAGE - 1 into the stage slice
  // s - 1 used (the barrier puts every warp past it, and orders the
  // shared-memory writes before it against the reads after). Returns the
  // slice: W^T's columns [256, 32], then the A columns [128, 32], both at
  // row stride LDW_C.
  __device__ __forceinline__ const bf16* next(const BwdArgs& a) {
    cp_async_wait_one();
    __syncthreads();
    if (s + NSTAGE - 1 < total) issue(a, s + NSTAGE - 1);
    cp_async_commit();
    const bf16* st = base + (s % NSTAGE) * WIDE_ELEMS;
    ++s;
    return st;
  }

  __device__ __forceinline__ void gemm(const BwdArgs& a, int ph, int n,
                                       int wm, int wn, float (&acc)[4][8][4]);
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

// W^T products over [256, 32] column blocks: tile_block.cuh's (shared with
// the self-attention backward's tile program, mhsa.cu).
using tb::gemm_wide;

// The tile's column sums of a quantity that each lane holds for its 8
// columns (lane * 8 ..) over its warp's rows: the warps' partials added in
// a fixed order, to dst[0 .. 256).
__device__ __forceinline__ void col_reduce(const float (&cs)[8], float* col,
                                           float* dst, int n = CW) {
  const int tid = threadIdx.x;
  __syncthreads();  // col is free
  float4* p =
      reinterpret_cast<float4*>(col + (tid >> 5) * CW + (tid & 31) * 8);
  p[0] = make_float4(cs[0], cs[1], cs[2], cs[3]);
  p[1] = make_float4(cs[4], cs[5], cs[6], cs[7]);
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < NTH / 32; ++w) t += col[w * CW + tid];
  if (tid < n) dst[tid] = t;
}

// Eight consecutive f32 values (32 bytes, 16-byte aligned) into / out of
// registers, and rounded to bf16 as one 16-byte word.
__device__ __forceinline__ void ld8f(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void st8f(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]),
                    pack_bf2(v[4], v[5]), pack_bf2(v[6], v[7]));
}

// Mean and 1/sqrt(var + eps) of a row held as 8 values a lane, f32 and
// two-pass, as the forward's LayerNorm computes them.
__device__ __forceinline__ void row_stats8(const float (&v)[8], float eps,
                                           float& mu, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += v[i];
  mu = warp_sum(s) * (1.0f / CW);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float d = v[i] - mu;
    q += d * d;
  }
  rstd = rsqrtf(fmaxf(warp_sum(q) * (1.0f / CW), 0.f) + eps);
}

// LayerNorm backward of one row, 8 values a lane: with xh = (x - mu) * rstd
// (written back into x), dx = rstd * (dy*g - mean(dy*g) - xh *
// mean(dy*g*xh)) into dy's place; the lane's dg (dy * xh) and db (dy)
// terms added to cg, cb.
__device__ __forceinline__ void ln_bwd_row(float (&dy)[8], float (&x)[8],
                                           const float (&gm)[8], float eps,
                                           float (&cg)[8], float (&cb)[8]) {
  float mu, rstd;
  row_stats8(x, eps, mu, rstd);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[i] = (x[i] - mu) * rstd;
    const float e = dy[i] * gm[i];
    s1 += e;
    s2 += e * x[i];
    cg[i] += dy[i] * x[i];
    cb[i] += dy[i];
  }
  const float m1 = warp_sum(s1) * (1.0f / CW), m2 = warp_sum(s2) * (1.0f / CW);
#pragma unroll
  for (int i = 0; i < 8; ++i) dy[i] = rstd * (dy[i] * gm[i] - m1 - x[i] * m2);
}

// The f32 accumulator (warp (wm, wn) over rows wm*64.., columns wn*64..)
// into Vs.
__device__ __forceinline__ void store_acc(const float (&v)[4][8][4],
                                          float* vs, int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(
            vs + (wm * 64 + i * 16 + g + 8 * hf) * LDV + wn * 64 + j * 8 +
            2 * tq) = make_float2(v[i][j][2 * hf], v[i][j][2 * hf + 1]);
}

// acc[128, 256] = A @ W^T over the n slices of phase ph.
__device__ __forceinline__ void Ring::gemm(const BwdArgs& a, int ph, int n,
                                           int wm, int wn,
                                           float (&acc)[4][8][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  start(a, ph, n);
  for (int k = 0; k < n; ++k) {
    const bf16* w = next(a);
    gemm_wide(w + CW * LDW_C, LDW_C, 0, w, wm, wn, acc);
  }
}

// Column sums over a warp's 16 rows of a pair of packed bf16 rows (the
// thread's rows g and g + 8, columns 2 tq and 2 tq + 1): lanes g = 0 store
// them at dst[2 tq + e].
__device__ __forceinline__ void colsum_pair(unsigned p0, unsigned p1,
                                            float* dst) {
  const int lane = threadIdx.x & 31;
  const float cs[2] = {__uint_as_float(p0 << 16) + __uint_as_float(p1 << 16),
                       __uint_as_float(p0 & 0xffff0000u) +
                           __uint_as_float(p1 & 0xffff0000u)};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float v = cs[e];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) dst[2 * lane + e] = v;
  }
}

// Per-clip sums of the per-row values in rowd (rows of a clip contiguous),
// in order: dst[clip0 + c].
__device__ __forceinline__ void clip_sums(const float* rowd, int N, int ntile,
                                          float* dst) {
  __syncthreads();
  if (threadIdx.x < ntile) {
    float s = 0.f;
    for (int i = 0; i < N; ++i) s += rowd[threadIdx.x * N + i];
    dst[threadIdx.x] = s;
  }
}

// One head's softmax statistics and D for the warp's 16 queries (rows q0..):
// max m, 1/sum and D = sum_j P_ij dP_ij (dP = dO V^T), online over the
// key blocks its clips span, in f32; into STAT and, for the dq pass, the
// thread's registers.
__device__ __forceinline__ void attn_stats(const bf16* qs, const bf16* os, int ldo,
                                           float* stat, int q0, int N,
                                           int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int g_lo = q0 / N, g_hi = min(q0 + 15, nrows - 1) / N;
  const int k_beg = g_lo * N / 16 * 16, k_end = (g_hi + 1) * N;
  unsigned qa[2][4], oa[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    ldsm_x4(qa[s], qs + (q0 + (lane & 15)) * LDQ + s * 16 + (lane >> 4) * 8);
    ldsm_x4(oa[s], os + (q0 + (lane & 15)) * ldo + s * 16 + (lane >> 4) * 8);
  }
  const int r0 = q0 + g, r1 = r0 + 8;
  // The keys of a row's clip: [lo, lo + N) (past the tile's rows: none
  // below k_end).
  const int lo[2] = {r0 / N * N, r1 / N * N};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
  for (int kb = k_beg; kb < k_end; kb += 16) {
    float sc[2][4], dp[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = dp[t][e] = 0.f;
      unsigned kf[4], vf[4];
      ldsm_x4(kf, qs + (kb + t * 8 + (lane & 7)) * LDQ + DHD + (lane >> 3) * 8);
      ldsm_x4(vf, qs + (kb + t * 8 + (lane & 7)) * LDQ + 2 * DHD +
                      (lane >> 3) * 8);
      mma_bf16(sc[t], qa[0], kf[0], kf[1]);
      mma_bf16(sc[t], qa[1], kf[2], kf[3]);
      mma_bf16(dp[t], oa[0], vf[0], vf[1]);
      mma_bf16(dp[t], oa[1], vf[2], vf[3]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + t * 8 + 2 * tq + e;
          if (!(key < k_end && key >= lo[hf] && key < lo[hf] + N))
            sc[t][2 * hf + e] = -INFINITY;
          mx = fmaxf(mx, sc[t][2 * hf + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hf], mx);
      // A row with no key yet keeps max -inf: its probabilities are 0.
      const float corr = mn == -INFINITY ? 1.f : __expf(m[hf] - mn);
      float ls = 0.f, ds = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe =
              mn == -INFINITY ? 0.f : __expf(sc[t][2 * hf + e] - mn);
          ls += pe;
          ds += pe * dp[t][2 * hf + e];
        }
      l[hf] = l[hf] * corr + ls;
      D[hf] = D[hf] * corr + ds;
      m[hf] = mn;
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    D[hf] += __shfl_xor_sync(0xffffffffu, D[hf], 1);
    D[hf] += __shfl_xor_sync(0xffffffffu, D[hf], 2);
    const float inv = l[hf] > 0.f ? 1.0f / l[hf] : 0.f;
    if (tq == 0) {
      float* st = stat + (hf ? r1 : r0) * NST;
      st[ST_M] = m[hf];
      st[ST_L] = inv;
      st[ST_D] = D[hf] * inv;
    }
  }
}

// dq of the warp's 16 queries: dS = P (dP - D) over the same key blocks,
// dq = dS K (bf16 dS, f32 sums), times qscale (q was scaled before its
// rounding), into dqs columns 0..31.
__device__ __forceinline__ void attn_dq(const bf16* qs, const bf16* os, int ldo,
                                        const float* stat, bf16* dqs,
                                        float* colw, int q0, int N, int nrows,
                                        float qscale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int g_lo = q0 / N, g_hi = min(q0 + 15, nrows - 1) / N;
  const int k_beg = g_lo * N / 16 * 16, k_end = (g_hi + 1) * N;
  unsigned qa[2][4], oa[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    ldsm_x4(qa[s], qs + (q0 + (lane & 15)) * LDQ + s * 16 + (lane >> 4) * 8);
    ldsm_x4(oa[s], os + (q0 + (lane & 15)) * ldo + s * 16 + (lane >> 4) * 8);
  }
  const int r0 = q0 + g, r1 = r0 + 8;
  const int lo[2] = {r0 / N * N, r1 / N * N};
  float m[2], li[2], D[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float* st = stat + (hf ? r1 : r0) * NST;
    m[hf] = st[ST_M];
    li[hf] = st[ST_L];
    D[hf] = st[ST_D];
  }
  float dq[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  for (int kb = k_beg; kb < k_end; kb += 16) {
    float ds[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      unsigned kf[4], vf[4];
      ldsm_x4(kf, qs + (kb + t * 8 + (lane & 7)) * LDQ + DHD + (lane >> 3) * 8);
      ldsm_x4(vf, qs + (kb + t * 8 + (lane & 7)) * LDQ + 2 * DHD +
                      (lane >> 3) * 8);
      mma_bf16(sc, qa[0], kf[0], kf[1]);
      mma_bf16(sc, qa[1], kf[2], kf[3]);
      mma_bf16(dp, oa[0], vf[0], vf[1]);
      mma_bf16(dp, oa[1], vf[2], vf[3]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + t * 8 + 2 * tq + e;
          const bool in = key < k_end && key >= lo[hf] &&
                          key < lo[hf] + N && m[hf] != -INFINITY;
          const float p = in ? __expf(sc[2 * hf + e] - m[hf]) * li[hf] : 0.f;
          ds[t][2 * hf + e] = p * (dp[2 * hf + e] - D[hf]);
        }
    }
    const unsigned pa[4] = {pack_bf2(ds[0][0], ds[0][1]),
                            pack_bf2(ds[0][2], ds[0][3]),
                            pack_bf2(ds[1][0], ds[1][1]),
                            pack_bf2(ds[1][2], ds[1][3])};
#pragma unroll
    for (int dp2 = 0; dp2 < 2; ++dp2) {
      unsigned kf[4];
      ldsm_x4_t(kf, qs + (kb + (lane & 15)) * LDQ + DHD + dp2 * 16 +
                        (lane >> 4) * 8);
      mma_bf16(dq[2 * dp2], pa, kf[0], kf[1]);
      mma_bf16(dq[2 * dp2 + 1], pa, kf[2], kf[3]);
    }
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int c = d * 8 + 2 * tq;
    const unsigned p0 = pack_bf2(dq[d][0] * qscale, dq[d][1] * qscale);
    const unsigned p1 = pack_bf2(dq[d][2] * qscale, dq[d][3] * qscale);
    *reinterpret_cast<unsigned*>(dqs + r0 * LDQ + c) = p0;
    *reinterpret_cast<unsigned*>(dqs + r1 * LDQ + c) = p1;
    colsum_pair(p0, p1, colw + d * 8);
  }
}

// dk and dv of the warp's 16 keys (rows k0..): over the query blocks their
// clips span, P^T and dS^T from K Q^T and V dO^T with the queries'
// statistics, dv = P^T dO and dk = dS^T Q (bf16 operands, f32 sums), into
// dqs columns 32..95.
__device__ __forceinline__ void attn_dkdv(const bf16* qs, const bf16* os, int ldo,
                                          const float* stat, bf16* dqs,
                                          float* colw, int k0, int N,
                                          int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int g_lo = k0 / N, g_hi = min(k0 + 15, nrows - 1) / N;
  const int q_beg = g_lo * N / 16 * 16, q_end = (g_hi + 1) * N;
  unsigned ka[2][4], va[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    ldsm_x4(ka[s], qs + (k0 + (lane & 15)) * LDQ + DHD + s * 16 +
                       (lane >> 4) * 8);
    ldsm_x4(va[s], qs + (k0 + (lane & 15)) * LDQ + 2 * DHD + s * 16 +
                       (lane >> 4) * 8);
  }
  const int r0 = k0 + g, r1 = r0 + 8;
  // The queries of a key row's clip: [lo, hi) (none past the tile's rows).
  const int lo[2] = {r0 / N * N, r1 / N * N};
  const int hi[2] = {r0 < nrows ? lo[0] + N : 0, r1 < nrows ? lo[1] + N : 0};
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  for (int qb = q_beg; qb < q_end; qb += 16) {
    float pt[2][4], dst[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      unsigned qf[4], of[4];
      ldsm_x4(qf, qs + (qb + t * 8 + (lane & 7)) * LDQ + (lane >> 3) * 8);
      ldsm_x4(of, os + (qb + t * 8 + (lane & 7)) * ldo + (lane >> 3) * 8);
      mma_bf16(sc, ka[0], qf[0], qf[1]);
      mma_bf16(sc, ka[1], qf[2], qf[3]);
      mma_bf16(dp, va[0], of[0], of[1]);
      mma_bf16(dp, va[1], of[2], of[3]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = qb + t * 8 + 2 * tq + e;
        const bool qin = q < q_end;
        const float* st = stat + (qin ? q : 0) * NST;
        const float mq = st[ST_M], lq = st[ST_L], Dq = st[ST_D];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bool in =
              qin && q >= lo[hf] && q < hi[hf] && mq != -INFINITY;
          const float p = in ? __expf(sc[2 * hf + e] - mq) * lq : 0.f;
          pt[t][2 * hf + e] = p;
          dst[t][2 * hf + e] = p * (dp[2 * hf + e] - Dq);
        }
      }
    }
    const unsigned pa[4] = {pack_bf2(pt[0][0], pt[0][1]),
                            pack_bf2(pt[0][2], pt[0][3]),
                            pack_bf2(pt[1][0], pt[1][1]),
                            pack_bf2(pt[1][2], pt[1][3])};
    const unsigned pb[4] = {pack_bf2(dst[0][0], dst[0][1]),
                            pack_bf2(dst[0][2], dst[0][3]),
                            pack_bf2(dst[1][0], dst[1][1]),
                            pack_bf2(dst[1][2], dst[1][3])};
#pragma unroll
    for (int dp2 = 0; dp2 < 2; ++dp2) {
      unsigned of[4], qf[4];
      ldsm_x4_t(of, os + (qb + (lane & 15)) * ldo + dp2 * 16 + (lane >> 4) * 8);
      ldsm_x4_t(qf, qs + (qb + (lane & 15)) * LDQ + dp2 * 16 + (lane >> 4) * 8);
      mma_bf16(dv[2 * dp2], pa, of[0], of[1]);
      mma_bf16(dv[2 * dp2 + 1], pa, of[2], of[3]);
      mma_bf16(dk[2 * dp2], pb, qf[0], qf[1]);
      mma_bf16(dk[2 * dp2 + 1], pb, qf[2], qf[3]);
    }
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int c = d * 8 + 2 * tq;
    const unsigned k0p = pack_bf2(dk[d][0], dk[d][1]);
    const unsigned k1p = pack_bf2(dk[d][2], dk[d][3]);
    const unsigned v0p = pack_bf2(dv[d][0], dv[d][1]);
    const unsigned v1p = pack_bf2(dv[d][2], dv[d][3]);
    *reinterpret_cast<unsigned*>(dqs + r0 * LDQ + DHD + c) = k0p;
    *reinterpret_cast<unsigned*>(dqs + r1 * LDQ + DHD + c) = k1p;
    *reinterpret_cast<unsigned*>(dqs + r0 * LDQ + 2 * DHD + c) = v0p;
    *reinterpret_cast<unsigned*>(dqs + r1 * LDQ + 2 * DHD + c) = v1p;
    colsum_pair(k0p, k1p, colw + DHD + d * 8);
    colsum_pair(v0p, v1p, colw + 2 * DHD + d * 8);
  }
}

template <bool PROF>
__global__ void __launch_bounds__(NTH, 1)
    block_bwd_tile_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + OFF_A);
  float* Vs = reinterpret_cast<float*>(smem + OFF_V);
  bf16* Qs = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* DQs = reinterpret_cast<bf16*>(smem + OFF_DQ);
  float* col = reinterpret_cast<float*>(smem + OFF_COL);
  float* stat = reinterpret_cast<float*>(smem + OFF_STAT);
  float* rowd = reinterpret_cast<float*>(smem + OFF_ROWD);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  StageClock<PROF> clk;
  clk.start();

  const int N = a.N, hid = a.hid, L = vec_len(hid);
  const int gpt = TM / N;
  const int clip0 = blockIdx.x * gpt;
  const int ntile = min(gpt, a.clips - clip0);
  const int nrows = ntile * N;
  const size_t row0 = (size_t)clip0 * N;
  float* part = a.part + (size_t)blockIdx.x * L;
  Ring ring;
  ring.base = reinterpret_cast<bf16*>(smem + OFF_RING);
  ring.row0 = row0;
  ring.nrows = nrows;
  // The LayerNorm passes: a warp a row (the warp's 16 rows in turn), a lane
  // 8 consecutive channels; row sums by warp shuffles, column sums per lane
  // then over the warps in a fixed order.
  const int c8 = lane * 8;

  // ---- post-norm backward: gy; then m2 * gy: dbb2, the per-clip dm2 (sum
  // gy * mo), bf16 into m2g; gy into gbuf --------------------------------
  {
    float gp[8], cg[8], cb[8], cs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gp[i] = a.gp ? a.gp[c8 + i] : 1.f;
      cg[i] = cb[i] = cs[i] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const int r = warp * 16 + k;
      if (r >= nrows) continue;
      const size_t o = (row0 + r) * CW + c8;
      float gy[8];
      load8(a.gout + o, gy);
      if (a.y) {
        float yv[8];
        ld8f(a.y + o, yv);
        ln_bwd_row(gy, yv, gp, a.post_eps, cg, cb);
      }
      const float sc = a.m2 ? a.m2[clip0 + r / N] : 1.f;
      st8f(a.gbuf + o, gy);
      float d[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        d[i] = gy[i] * sc;
        cs[i] += d[i];
      }
      *reinterpret_cast<uint4*>(a.m2g + o) = pack8(d);
      if (a.mo) {
        float mv[8];
        ld8f(a.mo + o, mv);
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) t += gy[i] * mv[i];
        t = warp_sum(t);
        if (lane == 0) rowd[r] = t;
      }
    }
    col_reduce(cg, col, part + 9 * CW + hid);   // gp (zeros without)
    col_reduce(cb, col, part + 10 * CW + hid);  // bp
    col_reduce(cs, col, part + 8 * CW + hid);   // bb2
    if (a.dm2) clip_sums(rowd, N, ntile, a.dm2 + clip0);
  }
  clk(0);

  // ---- MLP, fc2^T: per block of 256 hidden units, dge = m2g @ W2^T over
  // K = C (the f32 accumulator v), then a warp a row: dhh = dge *
  // gelu'(hh), bf16 into device memory (the fc1^T phase's A operand and
  // the weight product's), and the column sums of the bf16 values (dbb1)
  for (int blk = 0; blk * CW < hid; ++blk) {
    const int ncol = min(CW, hid - blk * CW);
    float v[4][8][4];
    ring.blk = blk;
    ring.gemm(a, PH_W2, CW / FC, wm, wn, v);
    __syncthreads();  // the ring's last slice is read: Vs is free
    store_acc(v, Vs, wm, wn);
    __syncthreads();
    float cs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) cs[i] = 0.f;
    if (c8 < ncol) {
#pragma unroll 4
      for (int k = 0; k < 16; ++k) {
        const int r = warp * 16 + k;
        if (r >= nrows) continue;
        const size_t o = (row0 + r) * hid + blk * CW + c8;
        float d[8], hv[8];
        ld8f(Vs + r * LDV + c8, d);
        ld8f(a.hh + o, hv);
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] *= gelu_erf_grad(hv[i]);
        const uint4 pk = pack8(d);
        *reinterpret_cast<uint4*>(a.dhh + o) = pk;
        const unsigned w4[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cs[2 * i] += __uint_as_float(w4[i] << 16);
          cs[2 * i + 1] += __uint_as_float(w4[i] & 0xffff0000u);
        }
      }
    }
    col_reduce(cs, col, part + V_BB1 + blk * CW, ncol);
  }
  clk(1);

  {
  // ---- MLP, fc1^T: dh2 = dhh @ W1^T over K = hid, the A columns of each
  // chunk arriving with W1's (v: the f32 accumulator) --------------------
  float v[4][8][4];
  ring.gemm(a, PH_W1, hid / FC, wm, wn, v);
  clk(2);

  // ---- LN2 backward: dx1 = LN2'(dh2) + gy; dg2, db2; then da = m1 * dx1:
  // dbproj, the per-clip dm1 (sum dx1 * a), bf16 into da; dx1 into gbuf --
  __syncthreads();  // the ring's last slice is read: Vs is free
  store_acc(v, Vs, wm, wn);
  __syncthreads();
  {
    float gm[8], cg[8], cb[8], cs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gm[i] = a.g2[c8 + i];
      cg[i] = cb[i] = cs[i] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const int r = warp * 16 + k;
      if (r >= nrows) continue;
      const size_t o = (row0 + r) * CW + c8;
      float d[8], x[8], gy[8];
      ld8f(Vs + r * LDV + c8, d);
      ld8f(a.x1 + o, x);
      ld8f(a.gbuf + o, gy);
      ln_bwd_row(d, x, gm, a.eps, cg, cb);
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] += gy[i];  // dx1
      st8f(a.gbuf + o, d);
      if (a.a) {
        float av[8];
        ld8f(a.a + o, av);
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) t += d[i] * av[i];
        t = warp_sum(t);
        if (lane == 0) rowd[r] = t;
      }
      const float sc = a.m1 ? a.m1[clip0 + r / N] : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        d[i] *= sc;
        cs[i] += d[i];
      }
      *reinterpret_cast<uint4*>(a.da + o) = pack8(d);
    }
    col_reduce(cg, col, part + V_G2);
    col_reduce(cb, col, part + V_B2);
    col_reduce(cs, col, part + V_BPROJ);
    if (a.dm1) clip_sums(rowd, N, ntile, a.dm1 + clip0);
  }
  clk(3);
  }

  // ---- attention branch: dO = da @ Wproj^T (all heads at once, bf16
  // into As); then per head the attention backward on the tensor cores,
  // dqkv_h into device memory (the qkv^T phase's A operand and the weight
  // product's) and its column sums (dbqkv) ------------------------------
  {
    float v[4][8][4];
    ring.gemm(a, PH_WPROJ, CW / FC, wm, wn, v);
    __syncthreads();  // the ring (over As) is read
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<unsigned*>(
              As + (wm * 64 + i * 16 + g + 8 * hf) * LDA + wn * 64 + j * 8 +
              2 * tq) = pack_bf2(v[i][j][2 * hf], v[i][j][2 * hf + 1]);
  }
  clk(4);
  // A head's q | k | v columns travel in registers, loaded while the head
  // before is worked on (6 16-byte words a thread; rows past the tile's
  // clips are zeros).
  uint4 qkv_next[TM * 12 / NTH];
  auto load_qkv = [&](int h) {
#pragma unroll
    for (int i = 0; i < TM * 12 / NTH; ++i) {
      const int c = tid + i * NTH;
      const int r = c / 12, seg = c % 12 / 4, cc = c % 4 * 8;
      qkv_next[i] = r < nrows ? *reinterpret_cast<const uint4*>(
                                    a.qkv + (row0 + r) * (3 * CW) + seg * CW +
                                    h * DHD + cc)
                              : make_uint4(0, 0, 0, 0);
    }
  };
  load_qkv(0);
  for (int h = 0; h < HEADS; ++h) {
    __syncthreads();  // every warp is past the head before
#pragma unroll
    for (int i = 0; i < TM * 12 / NTH; ++i) {
      const int c = tid + i * NTH;
      const int r = c / 12, seg = c % 12 / 4, cc = c % 4 * 8;
      *reinterpret_cast<uint4*>(Qs + r * LDQ + seg * DHD + cc) = qkv_next[i];
    }
    if (h + 1 < HEADS) load_qkv(h + 1);
    __syncthreads();
    const bf16* Os = As + h * DHD;  // dO of the head
    const int q0 = warp * 16;
    if (q0 < nrows) attn_stats(Qs, Os, LDA, stat, q0, N, nrows);
    __syncthreads();
    float* colw = col + warp * 3 * DHD;  // the warp's column sums
    if (q0 < nrows) {
      attn_dq(Qs, Os, LDA, stat, DQs, colw, q0, N, nrows, a.qscale);
      attn_dkdv(Qs, Os, LDA, stat, DQs, colw, q0, N, nrows);
    } else {
      for (int c = lane; c < 3 * DHD; c += 32) colw[c] = 0.f;
    }
    __syncthreads();
    if (tid < 3 * DHD) {
      float t = 0.f;
      for (int w = 0; w < NTH / 32; ++w) t += col[w * 3 * DHD + tid];
      part[V_BQKV + tid / DHD * CW + h * DHD + tid % DHD] = t;
    }
    for (int c = tid; c < nrows * 12; c += NTH) {
      const int r = c / 12, seg = c % 12 / 4, cc = c % 4 * 8;
      *reinterpret_cast<uint4*>(a.dqkv + (row0 + r) * (3 * CW) + seg * CW +
                                h * DHD + cc) =
          *reinterpret_cast<const uint4*>(DQs + r * LDQ + seg * DHD + cc);
    }
    clk(5);
  }

  {
  // ---- qkv^T: dh1 = dqkv @ Wqkv^T over K = 3C, the A columns of each
  // (head, segment) arriving with Wqkv's (v: the f32 accumulator) ---------
  float v[4][8][4];
  ring.gemm(a, PH_WQKV, 3 * HEADS, wm, wn, v);
  clk(6);

  // ---- LN1 backward: dx = LN1'(dh1) + dx1, bf16; dg1, db1 -----------
  __syncthreads();  // the ring's last slice is read: Vs is free
  store_acc(v, Vs, wm, wn);
  __syncthreads();
  {
    float gm[8], cg[8], cb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gm[i] = a.g1[c8 + i];
      cg[i] = cb[i] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const int r = warp * 16 + k;
      if (r >= nrows) continue;
      const size_t o = (row0 + r) * CW + c8;
      float d[8], x[8], dx1[8];
      ld8f(Vs + r * LDV + c8, d);
      load8(a.x + o, x);
      ld8f(a.gbuf + o, dx1);
      ln_bwd_row(d, x, gm, a.eps, cg, cb);
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] += dx1[i];
      *reinterpret_cast<uint4*>(a.dx + o) = pack8(d);
    }
    col_reduce(cg, col, part + V_G1);
    col_reduce(cb, col, part + V_B1);
  }
  }
  clk(7);
  clk.write(a.stamps + (size_t)blockIdx.x * NSTAMP);
}

}  // namespace bb

// ---------------------------------------------------------------------------
// C interface (ctypes). Every function returns cudaGetLastError().
// ---------------------------------------------------------------------------
// The forward over [clips, N, 256] tokens: one launch of the tile
// program. ptrs: x, out, wqkv, wproj, w1, w2, g1, b1, bqkv, bproj, g2, b2,
// bb1, bb2, gp, bp, m1, m2, h1, qkv, o, x1, h2, hh, ge, y, a, mo, stamps
// (gp, bp null without a post-norm; m1, m2 null without masks; x1 null: the
// trunk's program, only the output written; else the saving program, which
// writes each of h1 .. mo whose pointer is set; stamps null, or
// [tiles, 8] int64 for the stamped instantiation).
extern "C" int pmce_block_fwd_tile(void* const* ptrs, int clips, int N,
                                   int hid, float eps, float post_eps,
                                   float qscale, void* stream) {
  if (clips <= 0 || N <= 0 || N > tb::TM || hid <= 0 || hid % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  tb::BlockArgs a;
  auto cb = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto b = [&](int i) { return static_cast<bf16*>(ptrs[i]); };
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  a.x = cb(0); a.out = b(1);
  a.wqkv = cb(2); a.wproj = cb(3); a.w1 = cb(4); a.w2 = cb(5);
  a.g1 = cf(6); a.b1 = cf(7); a.bqkv = cf(8); a.bproj = cf(9);
  a.g2 = cf(10); a.b2 = cf(11); a.bb1 = cf(12); a.bb2 = cf(13);
  a.pg = cf(14); a.pb = cf(15); a.tpe = nullptr;
  a.m1 = cf(16); a.m2 = cf(17);
  a.h1 = b(18); a.qkv = b(19); a.o = b(20); a.x1 = f(21); a.h2 = b(22);
  a.hh = f(23); a.ge = b(24); a.y = f(25); a.a = f(26); a.mo = f(27);
  a.stamps = static_cast<long long*>(ptrs[28]);
  a.B = 1; a.T = clips; a.J = N; a.temporal = 0; a.hid = hid;
  a.eps = eps; a.post_eps = post_eps; a.qscale = qscale; a.round_y = 0;
  if ((a.pg == nullptr) != (a.pb == nullptr) ||
      (a.x1 == nullptr && (a.m1 || a.m2 || a.h1 || a.qkv || a.o || a.h2 ||
                           a.hh || a.ge || a.y || a.a || a.mo)))
    return static_cast<int>(cudaErrorInvalidValue);
  return tb::launch_tile_block(a, static_cast<cudaStream_t>(stream));
}

// The backward's tile program over [clips, N, 256] tokens. ptrs: gout, x,
// y, x1, hh, qkv, a, mo, wqkv, wproj, w1, w2, g1, g2, gp, m1, m2, gbuf, m2g,
// dhh, da, dqkv, dx, part, dm1, dm2, stamps (y and gp null without a
// post-norm; a, mo, dm1, dm2 null without mask gradients; m1, m2 null
// without masks; stamps null, or [tiles, 8] int64 for the stamped
// instantiation).
extern "C" int pmce_block_bwd_tile(void* const* ptrs, int clips, int N,
                                   int hid, float eps, float post_eps,
                                   float qscale, void* stream) {
  if (clips <= 0 || N <= 0 || N > bb::TM || hid <= 0 || hid % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  bb::BwdArgs a;
  auto cb = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  a.gout = cb(0); a.x = cb(1); a.y = cf(2); a.x1 = cf(3); a.hh = cf(4);
  a.qkv = cb(5); a.a = cf(6); a.mo = cf(7);
  a.wqkv = cb(8); a.wproj = cb(9); a.w1 = cb(10); a.w2 = cb(11);
  a.g1 = cf(12); a.g2 = cf(13); a.gp = cf(14); a.m1 = cf(15); a.m2 = cf(16);
  a.gbuf = static_cast<float*>(ptrs[17]);
  a.m2g = static_cast<bf16*>(ptrs[18]);
  a.dhh = static_cast<bf16*>(ptrs[19]);
  a.da = static_cast<bf16*>(ptrs[20]);
  a.dqkv = static_cast<bf16*>(ptrs[21]);
  a.dx = static_cast<bf16*>(ptrs[22]);
  a.part = static_cast<float*>(ptrs[23]);
  a.dm1 = static_cast<float*>(ptrs[24]);
  a.dm2 = static_cast<float*>(ptrs[25]);
  a.stamps = static_cast<long long*>(ptrs[26]);
  a.clips = clips; a.N = N; a.hid = hid;
  a.eps = eps; a.post_eps = post_eps; a.qscale = qscale;
  if ((a.y == nullptr) != (a.gp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gpt = bb::TM / N;
  const int grid = (clips + gpt - 1) / gpt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = a.stamps ? bb::block_bwd_tile_kernel<true>
                               : bb::block_bwd_tile_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bb::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, bb::NTH, bb::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The four weight gradients and the vector gradients in one launch. ptrs:
// h1, o, h2, ge (the products' X), dqkv, da, dhh, m2g (their dY), partial
// ([tiles * splits, 128 * 128] f32), counters ([tiles] int32, zero), mat
// (dWqkv, dWproj, dW1, dW2 concatenated), vpart ([vtiles, L]), vec ([L]).
extern "C" int pmce_block_wgrad(void* const* ptrs, int M, int hid, int splits,
                                int vtiles, void* stream) {
  constexpr int C = bb::CW;
  if (M <= 0 || hid <= 0 || hid % 128 || splits <= 0 || vtiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wg::Args<4> a;
  for (int p = 0; p < 4; ++p) {
    a.X[p] = static_cast<const bf16*>(ptrs[p]);
    a.G[p] = static_cast<const bf16*>(ptrs[4 + p]);
  }
  a.partial = static_cast<float*>(ptrs[8]);
  a.counters = static_cast<int*>(ptrs[9]);
  a.mat = static_cast<float*>(ptrs[10]);
  a.vpartial = nullptr;
  a.vpart = static_cast<const float*>(ptrs[11]);
  a.vtiles = vtiles;
  a.L = bb::vec_len(hid);
  a.vec = static_cast<float*>(ptrs[12]);
  return wg::launch_wgrad<128>(a, {M, M, M, M}, {C, C, C, hid},
                               {3 * C, C, hid, C}, splits,
                               (a.L + wg::NTH - 1) / wg::NTH,
                               static_cast<cudaStream_t>(stream));
}

PMCE_EXPORT_ERROR_STRING(pmce_block_error_string)
