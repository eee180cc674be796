// The decoder's CoevoBlock in f32 for Hopper (sm_90a): the whole chain and
// the whole block, the f32 serving forward.
//
// Replaces, where JAX's compute dtype is f32 (`PMCE(dtype=None,
// fused_attn=True)`):
// - pmce_tpu/ops/fused_coevo_chain.py `_chain_kernel` (entry
//   `fused_coevo_chain`): all CoevoBlocks of a clip with their f32
//   coordinate heads (pmce_coevo_chain_f32);
// - pmce_tpu/ops/fused_attention.py `_coevo_kernel` (entry
//   `fused_coevo_block`): one CoevoBlock a clip on its projected features,
//   the heads outside (pmce_coevo_block_f32).
// Per block, as the bf16 kernels (coevo_chain.cu, coevo_block.cu over
// coevo_ops.cuh) and with the reference quirks kept: the pos / Q / K
// embeds, the v->j and j->v projections, the joint CA+FFN (8 heads of 8, J
// queries over V keys) and vertex CA+FFN (2 heads of 32, V queries over J
// keys) on the pre-update streams, the AdaLN'd SA+FFN of each stream. Every
// tensor is f32: no cast point, no bf16 rounding anywhere.
//
// What bounds it on this card: the products, ~144 M flops a clip and block
// at V = 431, C = 64 (the vertex products and the vertex self-attention
// most of them): 110.9 GFLOP for the chain at B = 256, 0.67 ms at the 3xTF32
// rate of the tensor cores (495 / 3 TFLOP/s), 1.65 ms at the 67 TFLOP/s
// f32 CUDA-core peak, against ~11 MB of inputs and outputs.
//
// Products and attention in 3xTF32 on mma.sync (csrc/dec_tc32.cuh's
// tiles, fragments and mma3, the routines of rows 8f-11f): every f32
// operand split as hi + lo, a product summing a_lo b_hi + a_hi b_lo + a_hi
// b_hi, each 8-wide k-step summed from zero and added to the f32 sums
// rounded (dec_tc32.cuh's header). A row product loads and splits a
// k-step's eight B fragments, then issues each of the three products over
// the eight n-blocks (mm_ilp). The attention runs a head at a time (its
// query, output and softmax state alone in registers: the whole tile's
// spilled in the chain kernel), softmax weights as exp2 on the
// special-function unit. The 3 -> C embeds and the C -> 3 coordinate heads
// (~0.1 % of the flops) stay FFMA.
//
// A cluster of S CTAs a clip (one launch a call, cudaLaunchKernelEx with a
// cluster dimension; grid B S). The clip's vertex rows, in tiles of 16, are
// split into S contiguous ranges, rank r taking the tiles [T r / S,
// T (r + 1) / S) of T = ceil(V / 16); S is the fewest of 1, 2, 4, 8, 16 that
// leaves a rank at most 8 tiles (128 rows), so that each of a CTA's 8 warps
// (256 threads) owns one vertex tile: V <= 2048. At V = 431, S = 4 (27
// tiles: 6, 7, 7, 7); at the two-level coarsening's V = 1723, S = 16 (108
// tiles: 6 or 7 a rank). S = 2 at 431 would put two tiles on a warp and 224
// rows on a rank, whose three f32 [224, 64] buffers (the stream, k, v)
// alone take 172 KB of the 227: the weight ring, the warps' stashes and the
// joint side do not fit beside them. Clusters of 16 are past the portable
// 8: the kernels allow the non-portable size
// (cudaFuncAttributeNonPortableClusterSizeAllowed), which the H100 takes.
// The wrappers' plan (coevo_f32_plan) reads S from the same rule;
// pmce_coevo_f32_clusters gives the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; on the H100 SXM 30 of 4, so B = 64
// takes 3 waves and B = 256 takes 9; 66 of 2).
//
// Each rank keeps its own range in its own shared memory: the vertex stream
// as each warp's stashed tile (its A operands and residuals read a k-step at
// a time, lane-private), and its rows' k and v in [64][64] blocks (the
// staged layout of dec_tc32.cuh) for the attention. Nothing of shape [V, C]
// leaves the SM: the kernel has no workspace. The joint side (J <= 32 rows:
// one or two warp tiles, warps 0 and 1) is computed by every rank where the
// vertex side reads it (jf; the vertex CA's keys and values over the
// joints); the joint stream's own CA tail and SA+FFN, whose only reader is
// the output, by rank 0 alone, after its vertex side (the other ranks wait
// for none of it).
// - The vertex SA: every rank writes its rows' k and v, a cluster barrier,
//   then each warp's queries stream every rank's 64-row chunks in rank
//   order (the peers' copied through distributed shared memory), one
//   online softmax; a second cluster barrier before any rank overwrites
//   its k, v.
//   A peer's chunk is first copied once for the CTA's warps, 16 bytes a
//   thread, into two [64][64] blocks free during the attention (the
//   weight ring's stage of the q product, the keys and values over the
//   joints), then read from there. The warps' eightfold reads of it
//   through distributed shared memory made the whole kernel 1.6-1.8x as
//   slow at V = 1723 (S = 16) and 1.09-1.16x at V = 431 (S = 4), the same
//   bits (NVIDIA H100 80GB HBM3, 700.00 W; tools/profile_coevo.py).
// - The joint CA (J queries over the V vertex keys): every rank runs the
//   queries over its own keys (its k, v in the same blocks), keeps the
//   partial o, max and sum; after a cluster barrier rank 0 merges the S
//   partials in rank order.
// - The vertex CA (keys and values over the J joints) and the joint SA read
//   one chunk of J rows from each CTA's own shared memory.
// The weights go through a 2-stage cp.async ring (dec_tc32.cuh's Pipe) in
// 64 x 64 blocks, one copy a CTA read by all 8 warps, in one fixed order a
// block (`items`), the next block's copy issued behind the current
// product; every MLP runs a hidden block of 64 at a time from the stashed
// A operand, its output summed in registers (the residual's stash holding
// gelu(hh) meanwhile). No atomics and a fixed order of every sum: a rerun
// gives the same bits.
//
// Shared memory (bytes): the vertex stream 32,768 and the warps' A operands
// 32,768 (8 stashed tiles each), k and v of the rank's 128 rows 65,536, the
// weight ring 32,768, the joint side 43,008 (jf and the joint stream, 2
// stashed tiles each; the keys and values over the joints, [32][64] each;
// the joint CA's q, then its partial o, max and sum), the ring's list of
// items 896: 207,744 a CTA, one CTA an SM.
//
// Registers (ptxas -v, sm_90a, 256 threads a CTA): the chain 255, the whole
// block 223, 0 bytes of stack, spill stores and spill loads.

#include "common.cuh"
#include "dec_tc32.cuh"

namespace cf32 {

using namespace f32ops::dtc;

constexpr int HID = 256;       // MLP hidden width (4C)
constexpr int HJ = 8;          // joint-stream heads
constexpr int HV = 2;          // vertex-stream heads
constexpr int MAX_S = 16;      // CTAs of a cluster (non-portable)
constexpr int RMAX = NW * RB;  // vertex rows of a rank: a tile a warp
constexpr int JMAX = 2 * RB;   // joint rows: two tiles (warps 0 and 1)
constexpr int JKB = JMAX / 8;  // key blocks of a chunk of joints
constexpr int TS = RB * C;     // floats of a stashed tile

// Shared memory, in floats.
constexpr int OFF_X = 0;                     // the vertex stream
constexpr int OFF_A = OFF_X + NW * TS;       // each warp's A operand
constexpr int OFF_KV = OFF_A + NW * TS;      // k, v: 2 chunks x (K, V)
constexpr int OFF_W = OFF_KV + 2 * 2 * BLK;  // the weight ring, 2 stages
constexpr int OFF_JF = OFF_W + 2 * BLK;      // jf, a tile a joint warp
constexpr int OFF_JX = OFF_JF + 2 * TS;      // the joint stream
constexpr int OFF_JK = OFF_JX + 2 * TS;      // keys over the joints
constexpr int OFF_JV = OFF_JK + JMAX * C;    // values over the joints
constexpr int OFF_JP = OFF_JV + JMAX * C;    // joint CA: q, then partial o
constexpr int OFF_JM = OFF_JP + 2 * TS;      // its max [32][HJ]
constexpr int OFF_JL = OFF_JM + JMAX * HJ;   // its sum [32][HJ]
constexpr int OFF_TAB = OFF_JL + JMAX * HJ;  // the ring's items
constexpr int MAX_ITEMS = 56;

struct WItem {
  const float* w;
  long long ld;
};

constexpr int SMEM = OFF_TAB * 4 + MAX_ITEMS * (int)sizeof(WItem);
static_assert(SMEM <= 232448, "over the opt-in shared memory");

// One block's parameter table, in the order of the JAX package's
// ``fused_coevo_block`` params tuple, every entry f32; products as given,
// W [in, out] row-major.
enum {
  K_JPOS = 0, K_VPOS, K_JQ, K_VQ, K_V2JK, K_J2VK,  // [J|V, C]
  K_WV2J, K_BV2J, K_WJ2V, K_BJ2V,                  // [C, C], [C]
  K_CAJ = 10,  // 12: wq bq wk bk wv bv wproj bproj w1 bb1 w2 bb2
  K_CAV = 22,  // 12
  K_SAJ = 34,  // 8: wqkv bqkv wproj bproj w1 bb1 w2 bb2
  K_SAV = 42,  // 8
  K_COUNT = 50
};

// The chain's per-block table: the 3 -> C projections, the block's own
// table (K_*), the coordinate heads; every entry f32.
enum {
  P_WJP = 0, P_BJP, P_WVP, P_BVP,                  // [3, C], [C]
  P_BLOCK = 4,                                     // K_COUNT entries
  P_WHJ = P_BLOCK + K_COUNT, P_BHJ, P_WHV, P_BHV,  // [C, 3], [3]
  P_COUNT = P_WHJ + 4
};

#define WF(tab, i) static_cast<const float*>((tab)[i])

// The CTA's shared memory (a constant address: no register holds it).
__device__ __forceinline__ float* shm() {
  extern __shared__ __align__(16) unsigned char smem[];
  return reinterpret_cast<float*>(smem);
}

// The warp's stashed tile in the area at `off` (a tile a warp).
__device__ __forceinline__ float* tile_at(int off) {
  return shm() + off + (threadIdx.x >> 5) * TS;
}

// Rank r's vertex rows [row0, row0 + n) of V, split by tiles of 16.
__host__ __device__ inline void rank_rows(int V, int S, int r, int& row0,
                                          int& n) {
  const int T = cdiv(V, RB);
  row0 = RB * (T * r / S);
  const int end = RB * (T * (r + 1) / S);
  n = (end < V ? end : V) - row0;
}

// The most rows a rank takes (its stream, k and v must fit RMAX).
__host__ __device__ inline int rank_rows_max(int V, int S) {
  return RB * cdiv(cdiv(V, RB), S);
}

// A clip's shape and this CTA's part of it: the kernel's arguments and
// what follows from them (the cluster rank, the warp's valid rows).
struct Geo {
  int S, J, V, rank, row0, nrows;
  float eps, sj, sv;

  __device__ Geo(int S_, int J_, int V_, float e, float a, float b)
      : S(S_), J(J_), V(V_), eps(e), sj(a), sv(b) {
    rank = clu::rank();
    rank_rows(V, S, rank, row0, nrows);
  }
  // The valid rows of the warp's vertex tile and joint tile (0: none).
  __device__ int nv() const {
    return max(0, min(RB, nrows - RB * (int)(threadIdx.x >> 5)));
  }
  __device__ int jv() const {
    return max(0, min(RB, J - RB * (int)(threadIdx.x >> 5)));
  }
  // The warp's first vertex row of the clip, first joint row.
  __device__ int vr0() const { return row0 + RB * (threadIdx.x >> 5); }
  __device__ int jr0() const { return RB * (threadIdx.x >> 5); }
};

__device__ __forceinline__ void unstash(const float* s, float (&v)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[nb][e] = s[(nb * 4 + e) * 32 + lane];
}

__device__ __forceinline__ void scale_tile(float (&v)[8][4], float s) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[nb][e] *= s;
}

// d[nb] += A B[nb] for the n-blocks nb < N with 8 nb < n (one k-step, its
// B fragments split): each n-block's three products summed from zero, then
// one rounded add (f32_ops.cuh's mma3), issued a product at a time across
// the n-blocks, so that N independent products stand between a result and
// its use (the same sums, the same bits as mma3 an n-block at a time).
template <int N>
__device__ __forceinline__ void mma3_blocks(float (&d)[N][4],
                                            const unsigned (&ah)[4],
                                            const unsigned (&al)[4],
                                            const unsigned (&bh)[N][2],
                                            const unsigned (&bl)[N][2],
                                            int n) {
  float k8[N][4];
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) k8[nb][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
    if (8 * nb < n) mma_tf32(k8[nb], al, bh[nb][0], bh[nb][1]);
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
    if (8 * nb < n) mma_tf32(k8[nb], ah, bl[nb][0], bl[nb][1]);
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
    if (8 * nb < n) mma_tf32(k8[nb], ah, bh[nb][0], bh[nb][1]);
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
    if (8 * nb < n)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[nb][i] += k8[nb][i];
}

// out += A W over a staged weight block, A the warp's stashed tile read a
// k-step at a time (dec_tc32.cuh's mm_stashed, its order changed): a
// k-step's eight B fragments loaded and split first, then mma3_blocks.
__device__ __forceinline__ void mm_ilp(const float* A, const float* W,
                                       float (&out)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int kb = 0; kb < 8; ++kb) {
    const float* a = A + kb * 4 * 32 + lane;
    unsigned ah[4], al[4], bh[8][2], bl[8][2];
    a_frag(a[0], a[32], a[64], a[96], ah, al);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float b0, b1;
      b_kn(W, kb, nb, b0, b1);
      split_tf32(b0, bh[nb][0], bl[nb][0]);
      split_tf32(b1, bh[nb][1], bl[nb][1]);
    }
    mma3_blocks<8>(out, ah, al, bh, bl, C);
  }
}

// out = (the stashed A) W + bias, rows from nv on zero.
__device__ __forceinline__ void prod(const float* A, const float* W,
                                     const float* bias, int nv,
                                     float (&out)[8][4]) {
  zero(out);
  mm_ilp(A, W, out);
  add_cols(out, bias);
  mask_rows(out, nv);
}

// AdaLN(x), rows from nv on zero, stashed at A.
__device__ __forceinline__ void adaln_stash(const float (&x)[8][4],
                                            const float* g, const float* b,
                                            float eps, int nv, float* A) {
  float y[8][4];
  adaln_tile(x, g, b, eps, y);
  mask_rows(y, nv);
  stash(A, y);
}

// The warp's tile (rows lr0 .. lr0 + 15 of its side) into key blocks in
// the staged layout: row r at blocks + (r / KC) * stride + sat(r % KC, c).
__device__ __forceinline__ void store_keys(float* blocks, int stride, int lr0,
                                           const float (&v)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = lr0 + g + 8 * hf;
    float* b = blocks + (r / KC) * stride;
    const int cr = r % KC;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<float2*>(b + sat(cr, 8 * nb + 2 * t)) =
          make_float2(v[nb][2 * hf], v[nb][2 * hf + 1]);
  }
}

// e^x of a softmax weight (x <= 0; -inf gives 0) as 2^(x log2 e) on the
// special-function unit: within ~2e-7 relative where the weight is not
// negligible.
__device__ __forceinline__ float exp_w(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// Column blocks [cb0, cb0 + KB) of the warp's stashed tile, in and out.
template <int KB>
__device__ __forceinline__ void unstash_cols(const float* s, int cb0,
                                             float (&v)[KB][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[j][e] = s[((cb0 + j) * 4 + e) * 32 + lane];
}

template <int KB>
__device__ __forceinline__ void stash_cols(float* s, int cb0,
                                           const float (&v)[KB][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[((cb0 + j) * 4 + e) * 32 + lane] = v[j][e];
}

// One head of the warp's 16 scaled queries (Q: the head's KB column blocks,
// the first cb0) over one chunk of kc keys, K and V [64][64] blocks in the
// staged layout (their rows past kc up to the next multiple of 8 finite:
// they are read, with weight 0; local or a peer's): the online softmax's
// max m and sum l (rows g, g + 8) and the head's o (unnormalised, rescaled
// as the max grows). The products are 3xTF32 (f32_ops.cuh's mma3), the
// chunk's keys at most 8 NKB.
template <int KB, int NKB>
__device__ __forceinline__ void head_chunk(const float (&Q)[KB][4], int cb0,
                                           const float* K, const float* V,
                                           int kc, float (&O)[KB][4],
                                           float (&m)[2], float (&l)[2]) {
  const int t = threadIdx.x & 3;
  float S[NKB][4];
#pragma unroll
  for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[nb][e] = 0.f;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    unsigned ah[4], al[4];
    a_frag(Q[kb][0], Q[kb][1], Q[kb][2], Q[kb][3], ah, al);
    // Four n-blocks at a time (eight at once held too many registers).
#pragma unroll
    for (int n0 = 0; n0 < NKB; n0 += 4) {
      if (8 * n0 >= kc) break;
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float b0 = 0.f, b1 = 0.f;
        if (8 * (n0 + i) < kc) b_nk(K, cb0 + kb, n0 + i, b0, b1);
        split_tf32(b0, bh[i][0], bl[i][0]);
        split_tf32(b1, bh[i][1], bl[i][1]);
      }
      mma3_blocks<4>(*reinterpret_cast<float(*)[4][4]>(&S[n0]), ah, al, bh,
                     bl, kc - 8 * n0);
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * nb + 2 * t + (e & 1) >= kc) S[nb][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], S[nb][e]);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float mn = fmaxf(m[hf], quad_max(mx[hf]));
    alpha[hf] = exp_w(m[hf] - mn);
    m[hf] = mn;
  }
#pragma unroll
  for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      S[nb][e] = exp_w(S[nb][e] - m[e >> 1]);
      sum[e >> 1] += S[nb][e];
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + quad_sum(sum[hf]);
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[j][e] *= alpha[e >> 1];
  // O += P V: k over the chunk's keys (8 a step).
#pragma unroll
  for (int kb = 0; kb < NKB; ++kb) {
    if (8 * kb >= kc) break;
    unsigned ah[4], al[4], bh[KB][2], bl[KB][2];
    a_frag(S[kb][0], S[kb][1], S[kb][2], S[kb][3], ah, al);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float b0, b1;
      b_kn(V, kb, cb0 + j, b0, b1);
      split_tf32(b0, bh[j][0], bl[j][0]);
      split_tf32(b1, bh[j][1], bl[j][1]);
    }
    mma3_blocks<KB>(O, ah, al, bh, bl, 8 * KB);
  }
}

// The warp's scaled queries, stashed at A, over one chunk of at most 32
// keys at K, V (the joints), a head at a time: A holds o (normalised) on
// return.
template <int H>
__device__ __forceinline__ void attend_joints(float* A, const float* K,
                                              const float* V, int kc) {
  constexpr int KB = C / H / 8;
#pragma unroll 1
  for (int h = 0; h < H; ++h) {
    float Q[KB][4], O[KB][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    unstash_cols<KB>(A, h * KB, Q);
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[j][e] = 0.f;
    head_chunk<KB, JKB>(Q, h * KB, K, V, kc, O, m, l);
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[j][e] /= l[e >> 1];
    stash_cols<KB>(A, h * KB, O);
  }
}

// The weight ring: the block's items in order (listed at OFF_TAB), each
// [64][64] block staged once a CTA by cp.async into one of two stages at
// fixed offsets (dec_tc32.cuh's Pipe keeps its buffer's address in a
// register); next() waits for the current item (a block barrier), stages
// the one after it into the other stage, and returns the current.
struct Weights {
  int n, step, slot;

  __device__ static void issue(const WItem& it, float* dst) {
    for (int e = threadIdx.x; e < KC * C / 4; e += NT) {
      const int r = e >> 4, c4 = (e & 15) << 2;
      cp_async16(dst + sat(r, c4), it.w + (size_t)r * it.ld + c4);
    }
    cp_async_commit();
  }
  __device__ void begin(int count) {
    n = count;
    step = 1;
    slot = 0;
    issue(reinterpret_cast<const WItem*>(shm() + OFF_TAB)[0], shm() + OFF_W);
  }
  __device__ const float* next() {
    cp_async_wait_all();
    __syncthreads();
    if (step < n)
      issue(reinterpret_cast<const WItem*>(shm() + OFF_TAB)[step],
            shm() + OFF_W + (slot ^ 1) * BLK);
    ++step;
    const float* cur = shm() + OFF_W + slot * BLK;
    slot ^= 1;
    return cur;
  }
};

// The items of a tail (wproj, then W1's column block and W2's row block a
// hidden block), w: the sub-layer's wproj, bproj, w1, bb1, w2, bb2.
__device__ __forceinline__ void tail_items(WItem* tab, int& n, bool write,
                                           const void* const* w) {
  const auto add = [&](const float* a, int ld) {
    if (write) tab[n] = {a, ld};
    ++n;
  };
  add(WF(w, 0), C);
  for (int ch = 0; ch < HID; ch += C) {
    add(WF(w, 2) + ch, HID);
    add(WF(w, 4) + (size_t)ch * C, C);
  }
}

// A block's items in the order block_body takes them (listed by thread 0),
// and their count.
__device__ __forceinline__ int items(const void* const* P, bool live,
                                     bool owner) {
  WItem* tab = reinterpret_cast<WItem*>(shm() + OFF_TAB);
  const bool write = threadIdx.x == 0;
  const void* const* CJ = P + K_CAJ;
  const void* const* CV = P + K_CAV;
  const void* const* SJ = P + K_SAJ;
  const void* const* SV = P + K_SAV;
  int n = 0;
  const auto add = [&](const float* a, int ld) {
    if (write) tab[n] = {a, ld};
    ++n;
  };
  if (live) {
    add(WF(CJ, 0), C);      // joint q
    add(WF(P, K_WV2J), C);  // v_as_j
    add(WF(CJ, 2), C);      // k
    add(WF(CJ, 4), C);      // v
  }
  add(WF(P, K_WJ2V), C);    // j_as_v
  add(WF(CV, 2), C);        // k over the joints
  add(WF(CV, 4), C);        // v over the joints
  add(WF(CV, 0), C);        // vertex q
  tail_items(tab, n, write, CV + 6);
  add(WF(SV, 0) + C, 3 * C);    // vertex k
  add(WF(SV, 0) + 2 * C, 3 * C);
  add(WF(SV, 0), 3 * C);        // vertex q
  tail_items(tab, n, write, SV + 2);
  if (live && owner) {
    tail_items(tab, n, write, CJ + 6);  // the joint CA's tail
    add(WF(SJ, 0) + C, 3 * C);  // joint k
    add(WF(SJ, 0) + 2 * C, 3 * C);
    add(WF(SJ, 0), 3 * C);      // joint q
    tail_items(tab, n, write, SJ + 2);
  }
  return n;
}

// Stage a block's items (after every warp has left the previous block's
// last product).
__device__ __forceinline__ void start(Weights& wr, const void* const* P,
                                      bool live, bool owner) {
  __syncthreads();
  const int n = items(P, live, owner);
  __syncthreads();
  wr.begin(n);
}

// The sub-layer's tail from o (normalised, stashed at the warp's A) and
// the residual stashed at R: x1 = R + (o Wproj + bproj), h2 = AdaLN(x1), R
// = x1 + (gelu(h2 W1 + bb1) W2 + bb2). The MLP's output is summed in
// registers; R holds gelu(hh) of the current hidden block meanwhile. w:
// wproj, bproj, w1, bb1, w2, bb2.
__device__ __forceinline__ void tail(Weights& wr, bool act, int nv, float* R,
                                     const void* const* w, const float* g2,
                                     const float* b2, float eps) {
  float* A = tile_at(OFF_A);
  float y[8][4];
  zero(y);
  {
    const float* W = wr.next();
    if (act) {
      float x1[8][4], a[8][4];
      prod(A, W, WF(w, 1), nv, a);
      unstash(R, x1);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) x1[nb][e] += a[nb][e];
      adaln_stash(x1, g2, b2, eps, nv, A);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[nb][e] = x1[nb][e];
      add_cols(y, WF(w, 5));
    }
  }
#pragma unroll 1
  for (int ch = 0; ch < HID; ch += C) {
    const float* W = wr.next();
    if (act) {
      float ge[8][4];
      zero(ge);
      mm_ilp(A, W, ge);
      add_cols(ge, WF(w, 3) + ch);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) ge[nb][e] = gelu_erf(ge[nb][e]);
      stash(R, ge);
    }
    W = wr.next();
    if (act) mm_ilp(R, W, y);
  }
  if (act) {
    mask_rows(y, nv);
    stash(R, y);
  }
}

// Rank 0's joint CA output: the S ranks' partials (o unnormalised, max,
// sum; each over its rank's keys) merged in rank order, normalised, over
// its own partial (every read of it precedes the write).
__device__ __forceinline__ void merge_joint(int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int row = RB * (threadIdx.x >> 5) + g;
  float M[HJ][2], L[HJ][2];
#pragma unroll
  for (int h = 0; h < HJ; ++h)
    M[h][0] = M[h][1] = -INFINITY, L[h][0] = L[h][1] = 0.f;
  const float* jm = shm() + OFF_JM;
  const float* jl = shm() + OFF_JL;
#pragma unroll 1
  for (int r = 0; r < S; ++r) {
    const float* pm = clu::peer(jm, r);
#pragma unroll
    for (int h = 0; h < HJ; ++h)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        M[h][hf] = fmaxf(M[h][hf], pm[(row + 8 * hf) * HJ + h]);
  }
  float O[8][4];
  zero(O);
#pragma unroll 1
  for (int r = 0; r < S; ++r) {
    const float* po = clu::peer(tile_at(OFF_JP), r);
    const float* pm = clu::peer(jm, r);
    const float* pl = clu::peer(jl, r);
#pragma unroll
    for (int h = 0; h < HJ; ++h) {  // heads of 8: column block h
      float f[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int at = (row + 8 * hf) * HJ + h;
        f[hf] = expf(pm[at] - M[h][hf]);
        L[h][hf] += pl[at] * f[hf];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        O[h][e] += po[(h * 4 + e) * 32 + lane] * f[e >> 1];
    }
  }
#pragma unroll
  for (int h = 0; h < HJ; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[h][e] /= L[h][e >> 1];
  stash(tile_at(OFF_JP), O);
}

// A peer's staged [64][64] block (k or v of a chunk, through distributed
// shared memory) copied as it is into this CTA's block at dst: 16 bytes a
// thread at a time, every load of a thread issued before its stores.
__device__ __forceinline__ void stage_block(const float* src, float* dst) {
  constexpr int PER = BLK / 4 / NT;
  float4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    v[i] = reinterpret_cast<const float4*>(src)[threadIdx.x + i * NT];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    reinterpret_cast<float4*>(dst)[threadIdx.x + i * NT] = v[i];
}

// One CoevoBlock from its pos-embedded features to its post-SA streams.
// On entry each vertex warp's stash of the stream holds vf = vf0 +
// vertx_pos, each joint warp's jf = jf0 + joint_pos; P is the block's K_*
// table, gm / bt its 12 AdaLN gamma / beta rows (COEVO_SLOTS order). On
// return the stream's stashes hold vertx2 and, with joint_live, rank 0's
// joint stream joint2. Without joint_live (the chain's blocks before its
// last, whose joint outputs the next block overwrites) the joint stream's
// CA+FFN and SA+FFN and the v->j projection they alone read are skipped.
__device__ __forceinline__ void block_body(const Geo& q, Weights& wr,
                                           const void* const* P,
                                           const float* gm, const float* bt,
                                           bool live) {
#define GAM(k) (gm + (k) * C)
#define BET(k) (bt + (k) * C)
  const void* const* CJ = P + K_CAJ;
  const void* const* CV = P + K_CAV;
  const void* const* SJ = P + K_SAJ;
  const void* const* SV = P + K_SAV;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = threadIdx.x >> 5;
  const int nv = q.nv(), jv = q.jv();
  const bool va = nv > 0, ja = jv > 0, owner = q.rank == 0;
  float* XS = tile_at(OFF_X);
  float* AS = tile_at(OFF_A);
  float* JF = tile_at(OFF_JF);
  float* JX = tile_at(OFF_JX);
  float* JP = tile_at(OFF_JP);
  float* Km = shm() + OFF_KV;
  float* Vm = Km + BLK;
  float* JK = shm() + OFF_JK;
  float* JV = shm() + OFF_JV;
  const float eps = q.eps;
  float x[8][4], o[8][4];

  if (live) {
    // Joint q: jq = jf + j_Q (the joint CA's residual), q = (AdaLN0(jq) Wq
    // + bq) s_j.
    if (ja) {
      unstash(JF, x);
      add_tile(x, WF(P, K_JQ) + q.jr0() * C, C, jv);
      mask_rows(x, jv);
      stash(JX, x);
      adaln_stash(x, GAM(0), BET(0), eps, jv, AS);
    }
    const float* W = wr.next();
    if (ja) {
      prod(AS, W, WF(CJ, 1), jv, o);
      scale_tile(o, q.sj);
      stash(JP, o);
    }
    // The joint CA's keys over this rank's vertices: k = AdaLN1(v_as_j) Wk +
    // bk, v_as_j = vf Wv2j + bv2j + v2j_K; values v = AdaLN2(vf) Wv + bv.
    W = wr.next();
    if (va) {
      prod(XS, W, WF(P, K_BV2J), nv, x);
      add_tile(x, WF(P, K_V2JK) + (size_t)q.vr0() * C, C, nv);
      adaln_stash(x, GAM(1), BET(1), eps, nv, AS);
    }
    W = wr.next();
    if (va) {
      prod(AS, W, WF(CJ, 3), nv, o);
      store_keys(Km, 2 * BLK, RB * w, o);
      unstash(XS, x);
      adaln_stash(x, GAM(2), BET(2), eps, nv, AS);
    }
    W = wr.next();
    if (va) {
      prod(AS, W, WF(CJ, 5), nv, o);
      store_keys(Vm, 2 * BLK, RB * w, o);
    }
    __syncthreads();
    // The joint queries over this rank's keys, a head at a time: the
    // partial o (over q in JP), max and sum.
    if (ja) {
#pragma unroll 1
      for (int h = 0; h < HJ; ++h) {
        float Q[1][4], O[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        unstash_cols<1>(JP, h, Q);
#pragma unroll 1
        for (int c = 0; c * KC < q.nrows; ++c)
          head_chunk<1, KC / 8>(Q, h, Km + c * 2 * BLK, Vm + c * 2 * BLK,
                                min(KC, q.nrows - c * KC), O, m, l);
        stash_cols<1>(JP, h, O);
        if (t == 0)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int at = (RB * w + g + 8 * hf) * HJ + h;
            shm()[OFF_JM + at] = m[hf];
            shm()[OFF_JL + at] = l[hf];
          }
      }
    }
    clu::sync();  // every rank's partials
    if (owner && ja) merge_joint(q.S);
  }

  // The vertex CA's keys and values over the joints (every rank): k =
  // AdaLN5(j_as_v) Wk + bk, j_as_v = jf Wj2v + bj2v + j2v_K; v = AdaLN6(jf)
  // Wv + bv.
  const float* W = wr.next();
  if (ja) {
    prod(JF, W, WF(P, K_BJ2V), jv, x);
    add_tile(x, WF(P, K_J2VK) + q.jr0() * C, C, jv);
    adaln_stash(x, GAM(5), BET(5), eps, jv, AS);
  }
  W = wr.next();
  if (ja) {
    prod(AS, W, WF(CV, 3), jv, o);
    store_keys(JK, 0, q.jr0(), o);
    unstash(JF, x);
    adaln_stash(x, GAM(6), BET(6), eps, jv, AS);
  }
  W = wr.next();
  if (ja) {
    prod(AS, W, WF(CV, 5), jv, o);
    store_keys(JV, 0, q.jr0(), o);
  }
  // The vertex CA: vq = vf + v_Q (its residual), q = (AdaLN4(vq) Wq + bq)
  // s_v over the J keys (complete after the ring's barrier).
  if (va) {
    unstash(XS, x);
    add_tile(x, WF(P, K_VQ) + (size_t)q.vr0() * C, C, nv);
    mask_rows(x, nv);
    stash(XS, x);
    adaln_stash(x, GAM(4), BET(4), eps, nv, AS);
  }
  W = wr.next();
  if (va) {
    prod(AS, W, WF(CV, 1), nv, x);
    scale_tile(x, q.sv);
    stash(AS, x);
    attend_joints<HV>(AS, JK, JV, q.J);
  }
  tail(wr, va, nv, XS, CV + 6, GAM(7), BET(7), eps);  // vertx1

  // The vertex SA + FFN on vertx1: k and v of the rank's rows, q; the
  // queries over every rank's keys in rank order.
  if (va) {
    unstash(XS, x);
    adaln_stash(x, GAM(10), BET(10), eps, nv, AS);
  }
  W = wr.next();
  if (va) {
    prod(AS, W, WF(SV, 1) + C, nv, o);
    store_keys(Km, 2 * BLK, RB * w, o);
  }
  W = wr.next();
  if (va) {
    prod(AS, W, WF(SV, 1) + 2 * C, nv, o);
    store_keys(Vm, 2 * BLK, RB * w, o);
  }
  W = wr.next();
  if (va) {
    prod(AS, W, WF(SV, 1), nv, x);
    scale_tile(x, q.sv);
    stash(AS, x);
  }
  clu::sync();  // every rank's k and v
  // Each peer's chunk copied once for the CTA's warps: its k block into
  // the ring's free stage (the q product's, reissued after the next
  // barrier of the ring), its v block over the keys and values over the
  // joints (free until rank 0's joint SA stores them again).
  float* ks = const_cast<float*>(W);
  float* vs = JK;
  constexpr int KB = C / HV / 8;
#pragma unroll 1
  for (int h = 0; h < HV; ++h) {
    float Q[KB][4], O[KB][4], m[2] = {-INFINITY, -INFINITY},
                              l[2] = {0.f, 0.f};
    if (va) unstash_cols<KB>(AS, h * KB, Q);
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[j][e] = 0.f;
#pragma unroll 1
    for (int r = 0; r < q.S; ++r) {
      int r0, n;
      rank_rows(q.V, q.S, r, r0, n);
#pragma unroll 1
      for (int c = 0; c * KC < n; ++c) {
        const float *kc = Km + c * 2 * BLK, *vc = kc + BLK;
        if (r != q.rank) {
          __syncthreads();  // every warp done with the staged chunk
          stage_block(clu::peer(kc, r), ks);
          stage_block(clu::peer(vc, r), vs);
          __syncthreads();
          kc = ks;
          vc = vs;
        }
        if (va)
          head_chunk<KB, KC / 8>(Q, h * KB, kc, vc, min(KC, n - c * KC), O,
                                 m, l);
      }
    }
    if (va) {
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) O[j][e] /= l[e >> 1];
      stash_cols<KB>(AS, h * KB, O);
    }
  }
  clu::sync();  // every rank has read every peer's k and v
  tail(wr, va, nv, XS, SV + 2, GAM(11), BET(11), eps);  // vertx2
  // The joint stream's CA tail and SA + FFN (rank 0), after the vertex
  // side: the other ranks wait for none of it. The joint CA's o (merged in
  // JP) to joint1; k, v over the joints, then q and the attention.
  if (live && owner) {
    if (ja) {
      unstash(JP, x);
      stash(AS, x);
    }
    tail(wr, ja, jv, JX, CJ + 6, GAM(3), BET(3), eps);  // joint1
    if (ja) {
      unstash(JX, x);
      adaln_stash(x, GAM(8), BET(8), eps, jv, AS);
    }
    W = wr.next();
    if (ja) {
      prod(AS, W, WF(SJ, 1) + C, jv, o);
      store_keys(JK, 0, q.jr0(), o);
    }
    W = wr.next();
    if (ja) {
      prod(AS, W, WF(SJ, 1) + 2 * C, jv, o);
      store_keys(JV, 0, q.jr0(), o);
    }
    W = wr.next();
    if (ja) {
      prod(AS, W, WF(SJ, 1), jv, x);
      scale_tile(x, q.sj);
      stash(AS, x);
      attend_joints<HJ>(AS, JK, JV, q.J);
    }
    tail(wr, ja, jv, JX, SJ + 2, GAM(9), BET(9), eps);  // joint2
  }
#undef GAM
#undef BET
}

// The lane's rows g, g + 8 of a tile: (((c0 W0 + c1 W1) + c2 W2) + b) +
// pos, the 3 -> C projection of [n, 3] coordinates (xyz: the tile's first
// row) with its embed add (pos: the tile's first row); rows from nv on
// zero.
__device__ __forceinline__ void embed3(const float* xyz, const float* W,
                                       const float* b, const float* pos,
                                       int nv, float (&x)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    float c[3] = {0.f, 0.f, 0.f};
    if (r < nv)
#pragma unroll
      for (int k = 0; k < 3; ++k) c[k] = xyz[r * 3 + k];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nb + 2 * t + e;
        x[nb][2 * hf + e] =
            r < nv ? (((c[0] * W[col] + c[1] * W[C + col]) +
                       c[2] * W[2 * C + col]) + b[col]) +
                         pos[(size_t)r * C + col]
                   : 0.f;
      }
  }
}

// out = X W + b + resid over the stashed tile X's rows (nv of them): the
// C -> 3 head (the quad's columns summed by shuffles), resid and out [*, 3]
// from the tile's first row (out may be resid: each lane of a quad reads
// its row's resid before the first lane writes).
__device__ __forceinline__ void head3(const float* Xs, const float* W,
                                      const float* b, const float* resid,
                                      float* out, int nv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float x[8][4];
  unstash(Xs, x);
  float s[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nb + 2 * t + (e & 1);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s[e >> 1][k] = fmaf(x[nb][e], W[col * 3 + k], s[e >> 1][k]);
    }
  float y[2][3];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      y[hf][k] = (quad_sum(s[hf][k]) + b[k]) + (r < nv ? resid[r * 3 + k]
                                                        : 0.f);
  }
  __syncwarp();
  if (t == 0)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (g + 8 * hf < nv)
#pragma unroll
        for (int k = 0; k < 3; ++k) out[(g + 8 * hf) * 3 + k] = y[hf][k];
  __syncwarp();
}

__global__ void __launch_bounds__(NT, 1)
    chain_f32_kernel(const float* joints, float* jout, float* vout,
                     const float* gammas, const float* betas,
                     const void* const* params, int J, int V, int NB, int S,
                     float eps, float scale_j, float scale_v) {
  const Geo q(S, J, V, eps, scale_j, scale_v);
  Weights wr;
  const int b = blockIdx.x / S;
  // The warp's rows of the original joints and of the vertices, moved in
  // place by each block's head.
  const float* jin = joints + ((size_t)b * J + q.jr0()) * 3;
  float* vc = vout + ((size_t)b * V + q.vr0()) * 3;
  for (int blk = 0; blk < NB; ++blk) {
    const void* const* P = params + (size_t)blk * P_COUNT;
    const void* const* K = P + P_BLOCK;
    // Every block re-reads the original joints, so only the last block's
    // joint stream reaches an output (evo_pose).
    const bool live = blk == NB - 1;
    start(wr, K, live, q.rank == 0);
    float x[8][4];
    if (q.nv() > 0) {
      embed3(vc, WF(P, P_WVP), WF(P, P_BVP),
             WF(K, K_VPOS) + (size_t)q.vr0() * C, q.nv(), x);
      stash(tile_at(OFF_X), x);
    }
    if (q.jv() > 0) {
      embed3(jin, WF(P, P_WJP), WF(P, P_BJP), WF(K, K_JPOS) + q.jr0() * C,
             q.jv(), x);
      stash(tile_at(OFF_JF), x);
    }
    block_body(q, wr, K, gammas + ((size_t)b * NB + blk) * 12 * C,
               betas + ((size_t)b * NB + blk) * 12 * C, live);
    if (live && q.jv() > 0 && q.rank == 0)
      head3(tile_at(OFF_JX), WF(P, P_WHJ), WF(P, P_BHJ), jin,
            jout + ((size_t)b * J + q.jr0()) * 3, q.jv());
    if (q.nv() > 0)
      head3(tile_at(OFF_X), WF(P, P_WHV), WF(P, P_BHV), vc, vc, q.nv());
  }
}

__global__ void __launch_bounds__(NT, 1)
    block_f32_kernel(const float* jf0, const float* vf0, float* jout,
                     float* vout, const float* gammas, const float* betas,
                     const void* const* params, int J, int V, int S,
                     float eps, float scale_j, float scale_v) {
  const Geo q(S, J, V, eps, scale_j, scale_v);
  Weights wr;
  const int b = blockIdx.x / S;
  const int nv = q.nv(), jv = q.jv();
  const size_t vr = (size_t)b * V + q.vr0(), jr = (size_t)b * J + q.jr0();
  start(wr, params, true, q.rank == 0);
  float x[8][4];
  if (nv > 0) {
    load_tile(vf0 + vr * C, C, nv, x);
    add_tile(x, WF(params, K_VPOS) + (size_t)q.vr0() * C, C, nv);
    stash(tile_at(OFF_X), x);
  }
  if (jv > 0) {
    load_tile(jf0 + jr * C, C, jv, x);
    add_tile(x, WF(params, K_JPOS) + q.jr0() * C, C, jv);
    stash(tile_at(OFF_JF), x);
  }
  block_body(q, wr, params, gammas + (size_t)b * 12 * C,
             betas + (size_t)b * 12 * C, true);
  if (nv > 0) {
    unstash(tile_at(OFF_X), x);
    store_tile(vout + vr * C, C, nv, x);
  }
  if (jv > 0 && q.rank == 0) {
    unstash(tile_at(OFF_JX), x);
    store_tile(jout + jr * C, C, jv, x);
  }
}

// Whether the plan takes the shape: J <= 32 joints, S in 1..16 CTAs a clip
// of at most RMAX vertex rows each.
__host__ __device__ inline bool admits(int J, int V, int S) {
  return J > 0 && J <= JMAX && V > 0 && S >= 1 && S <= MAX_S &&
         S <= cdiv(V, RB) && rank_rows_max(V, S) <= RMAX;
}

// The kernel's shared memory, and clusters past the portable 8 CTAs.
template <class K>
cudaError_t allow_clusters(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <class K, class... A>
cudaError_t launch_clusters(K kernel, int clips, int S, cudaStream_t stream,
                            A... args) {
  cudaError_t e = allow_clusters(kernel);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clips * S);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace cf32

// Host entry points.

// The dynamic shared memory a CTA of the plan takes at V vertices in
// clusters of S (the same at every admitted shape), or -1 where the plan
// does not take V (a rank over RMAX rows, S outside 1..16).
extern "C" long long pmce_coevo_f32_smem_bytes(int V, int S) {
  return cf32::admits(1, V, S) ? cf32::SMEM : -1;
}

// The clusters of S CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int pmce_coevo_f32_clusters(int S) {
  using namespace cf32;
  const auto kernel = chain_f32_kernel;
  cudaError_t e = allow_clusters(kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * 256);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kernel), &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// joints / jout: f32 [B, J, 3]; vout: f32 [B, V, 3], the vertices on entry
// (moved in place); gammas / betas: f32 [B, NB, 12, C]; params: a device
// array of NB * P_COUNT pointers; S: the CTAs of a clip's cluster.
extern "C" int pmce_coevo_chain_f32(const float* joints, float* jout,
                                    float* vout, const float* gammas,
                                    const float* betas, const void* params,
                                    int B, int J, int V, int NB, int S,
                                    float eps, float scale_j, float scale_v,
                                    void* stream) {
  using namespace cf32;
  if (B <= 0 || NB <= 0 || !admits(J, V, S))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(
      chain_f32_kernel, B, S, static_cast<cudaStream_t>(stream), joints,
      jout, vout, gammas, betas, static_cast<const void* const*>(params), J, V, NB,
      S, eps, scale_j, scale_v));
}

// jf0 / vf0 / jout / vout: f32 [B, J|V, C]; gammas / betas: f32
// [B, 12, C]; params: a device array of the K_COUNT pointers; S: the CTAs
// of a clip's cluster.
extern "C" int pmce_coevo_block_f32(const float* jf0, const float* vf0,
                                    float* jout, float* vout,
                                    const float* gammas, const float* betas,
                                    const void* params, int B, int J, int V,
                                    int S, float eps, float scale_j,
                                    float scale_v, void* stream) {
  using namespace cf32;
  if (B <= 0 || !admits(J, V, S))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(
      block_f32_kernel, B, S, static_cast<cudaStream_t>(stream), jf0, vf0,
      jout, vout, gammas, betas, static_cast<const void* const*>(params), J,
      V, S, eps, scale_j, scale_v));
}

PMCE_EXPORT_ERROR_STRING(pmce_coevo_f32_error_string)
