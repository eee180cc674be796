// Multi-head self-attention with its projections in f32, forward (row 4f)
// and backward (row 5f), for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_mhsa_kernel` (entry
// `fused_mhsa`) and `_mhsa_bwd_kernel` (via `_fused_mhsa_bwd`, its custom
// VJP) on their f32 branches (JAX's compute dtype f32): over each clip's
// N <= 64 tokens of width C (a multiple of 64, at most 256), in heads of
// 8, 16 or 32,
//
//   qkv = x Wqkv + bqkv;  o = softmax(q k^T) v per head;  out = o Wproj + b
//
// with q scaled by 1/sqrt(head width) before the scores and a
// max-stabilised f32 softmax. Its path is the f32 Stage-2 joint stream
// (AdaBlock over <= 64 tokens calls fused_mhsa): [32, 17, 64] and
// [32, 19, 64] in heads of 8.
//
// Products: every product and the attention's in 3xTF32 on the tensor
// cores (mma.sync m16n8k8; csrc/dec_tc32.cuh's tiles, fragments and staged
// [64][64] block layout, f32_ops.cuh's mma3: each 8-wide k-step summed from
// zero, then one rounded add), the weight gradients too (f32_ops.cuh's
// launch_wgrad). They differ from the plain version in the order of their
// sums and the split operands' last bits (the CPU model,
// tests/test_torch_port_mhsa_f32_redesign.py: within 1e-5 of the output,
// 1e-4 of each gradient).
//
// What bounds them on this card: at the path's shapes, nothing the card
// is short of: [32, 17, 64] is ~18 MFLOP forward, ~0.1 us at 3xTF32's
// rate, and 0.2 MB. Latency bounds them: the launches and each CTA's chain
// of dependent steps. So the work is spread over more SMs than clips, and
// each step is short: a persistent grid of min(items, ctas) CTAs (ctas: the
// card's SMs; the wrappers' mhsa_f32_plan), an item a clip's 16-row block
// (64 items at [32, 17]: two a clip), CTA i taking the items [n i / G,
// n (i + 1) / G). Each item's CTA recomputes what its rows need of the
// clip's other rows (k and v in the forward; dO, the softmax's max and sum
// and D in the backward): at N <= 64 that costs no step, since those rows'
// products run on warps that would otherwise wait.
//
// Column blocks. C is taken 64 columns at a time (a column block holds
// whole heads: 64 / head width of them, the attention routines' <= 8).
// A 2-stage ring stages the products' operands a 64-column block each
// (cp.async from all threads; the next item's copies issued behind a block
// barrier, so they land behind the current products): the clip's x (or g)
// columns with the weight blocks they meet, or up to three weight blocks.
// No product keeps its A operand in registers: fragments are read from the
// staged blocks a k-step at a time. A staged block is read in both orders
// without bank conflicts, so W^T's products read W itself: no transposed
// copy.
//
// Forward (pmce_mhsa_fwd_f32), per item and column block: the clip's k and
// v (warps 0-3 k, 4-7 v, a 16-row block each; the item's own block's k
// warp also q, from the same x fragments) into staged blocks, bias added
// and q scaled; the attention, a warp a head: the scores, the softmax in
// registers, o = P V / l into the item's o block; out += o Wproj, a warp
// an 8-column block. qkv and o reach device memory only as the backward's
// saved state, with a gradient owed (else those pointers are null).
//
// Backward (pmce_mhsa_bwd_f32), from the saved qkv and o, two launches: the
// tile program, then the weight gradients dWqkv = x^T dqkv, dWproj = o^T g
// with the bias gradients' fixed-order sums over the items (f32_ops.cuh).
// Per item and column block, the clip's q, k, v and o staged by cp.async;
// dO = g Wproj^T for every row block (warps 0-3), D = dO . o per head; the
// softmax's max and sum recomputed per (row block, head); then the item's
// rows as queries (warps 0-3, heads in turn: dq = dS K, P and dS from the
// recomputed scores) and as keys (warps 4-7: dk = dS^T q, dv = P^T dO)
// into the item's dqkv block in shared memory; it goes to device memory
// (the weight launch's operand) with its column sums (the item's bias
// partials), and dx += dqkv Wqkv^T from it. No atomics: a rerun gives the
// same bits.
//
// Shared memory (bytes): the forward 172,032 (the ring 2 x 65,536; k, v
// 2 x 16,384; the item's q and o 2 x 4,096), the backward 198,656 (the
// ring 2 x 49,152; k, v, q, dO, o 5 x 16,384; the rows' max, sum and D
// 6,144; the item's dq, dk, dv 3 x 4,096). One CTA an SM.

#include "common.cuh"
#include "f32_ops.cuh"
#include "dec_tc32.cuh"

namespace mf32 {

using f32ops::mma3;
using f32ops::dtc::a_frag;
using f32ops::dtc::add_cols;
using f32ops::dtc::b_kn;
using f32ops::dtc::b_nk;
using f32ops::dtc::BLK;
using f32ops::dtc::cdiv;
using f32ops::dtc::mask_rows;
using f32ops::dtc::mm_kstep;
using f32ops::dtc::quad_max;
using f32ops::dtc::quad_sum;
using f32ops::dtc::sat;
using f32ops::dtc::share;
using f32ops::dtc::store_tile;
using f32ops::dtc::zero;
using tc32::cp_async16;
using tc32::cp_async_commit;
using tc32::cp_async_wait_all;

constexpr int NT = 256;          // threads a CTA (8 warps)
constexpr int NW = NT / 32;
constexpr int TR = 64;           // the most tokens a clip
constexpr int RB = 16;           // rows of a warp's tile, of an item
constexpr int QB = RB * 64;      // floats of an item's 16-row block
constexpr int FSTAGE = 4 * BLK;  // a ring stage: x and three weight blocks
constexpr int BSTAGE = 3 * BLK;  // g and a weight block, or three weights
constexpr int HMAX = 8;          // the most heads of a column block
constexpr int STATS = 3 * HMAX * TR;
constexpr int FWD_FLOATS = 2 * FSTAGE + 2 * BLK + 2 * QB;
constexpr int BWD_FLOATS = 2 * BSTAGE + 5 * BLK + STATS + 3 * QB;

struct Args {
  const float *x, *wqkv, *bqkv, *wproj, *bproj;
  float *out, *qkv, *o;  // the forward's; qkv, o null without a gradient
  const float* g;        // the backward's
  float *dqkv, *part, *dx;
  int clips, N, C, heads;
  float qscale;
};

__host__ __device__ constexpr int row_blocks(int N) { return (N + RB - 1) / RB; }

// A ring item: up to four 64-column blocks, p[i] rows of stride ld;
// block 0 may be a clip's rows instead (stride ld0, rows0 of them, the
// rest of the block zero).
struct WItem {
  const float* p[4];
  int ld, ld0, rows0, n;
};

__device__ __forceinline__ void issue_blocks(const WItem& it, float* dst) {
  for (int e = threadIdx.x; e < it.n * 1024; e += NT) {
    const int b = e >> 10, r = (e >> 4) & 63, c4 = (e & 15) << 2;
    const float* src = b == 0   ? it.p[0]
                       : b == 1 ? it.p[1]
                       : b == 2 ? it.p[2]
                                : it.p[3];
    float* d = dst + b * BLK + sat(r, c4);
    if (b > 0)
      cp_async16(d, src + (size_t)r * it.ld + c4);
    else if (r < it.rows0)
      cp_async16(d, src + (size_t)r * it.ld0 + c4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// The 2-stage ring of `stage` floats a stage: next() waits for the current
// stage (and every copy in flight), passes a block barrier, issues the
// item after it (if `more`) into the other stage and returns the current
// one.
struct Ring {
  float* buf;
  int stage, slot;

  __device__ const float* next(bool more, WItem after) {
    cp_async_wait_all();
    __syncthreads();
    if (more) issue_blocks(after, buf + (slot ^ 1) * stage);
    const float* cur = buf + slot * stage;
    slot ^= 1;
    return cur;
  }
};

// The A fragment of k-step kb of a staged block's rows 16 rb .. 16 rb + 15
// (b_nk's reads of n-blocks 2 rb and 2 rb + 1).
__device__ __forceinline__ void a_rows(const float* X, int rb, int kb,
                                       unsigned (&ah)[4], unsigned (&al)[4]) {
  float f0, f1, f2, f3;
  b_nk(X, kb, 2 * rb, f0, f1);
  b_nk(X, kb, 2 * rb + 1, f2, f3);
  a_frag(f0, f1, f2, f3, ah, al);
}

// NB 8-column blocks of a tile (accumulator layout) into a staged block's
// rows 16 rb .., columns 8 nb0 ..
template <int NB>
__device__ __forceinline__ void put_cols(float* X, int rb,
                                         const float (&v)[NB][4], int nb0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int c = 8 * (nb0 + j) + 2 * t;
    *reinterpret_cast<float2*>(X + sat(16 * rb + g, c)) =
        make_float2(v[j][0], v[j][1]);
    *reinterpret_cast<float2*>(X + sat(16 * rb + g + 8, c)) =
        make_float2(v[j][2], v[j][3]);
  }
}

__device__ __forceinline__ void put_tile(float* X, int rb,
                                         const float (&v)[8][4]) {
  put_cols<8>(X, rb, v, 0);
}

// Rows [0, nrows) of a [*, ld] array into a staged block by cp.async, rows
// [nrows, 16 nrb) zero (what the fragments read of the padding).
__device__ __forceinline__ void issue_rows(float* dst, const float* src,
                                           int ld, int nrows, int nrb) {
  for (int e = threadIdx.x; e < RB * nrb * 16; e += NT) {
    const int r = e >> 4, c4 = (e & 15) << 2;
    float* d = dst + sat(r, c4);
    if (r < nrows)
      cp_async16(d, src + (size_t)r * ld + c4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// The scores of rows 16 rb .. of head h over the N keys (8 KB columns a
// head), keys past N at -inf.
template <int KB>
__device__ __forceinline__ void scores(const float* Qs, int rb, const float* Ks,
                                       int N, int h, float (&S)[8][4]) {
  const int t = threadIdx.x & 3;
  zero(S);
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    unsigned ah[4], al[4];
    a_rows(Qs, rb, h * KB + j, ah, al);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      if (8 * nb >= N) break;
      float b0, b1;
      b_nk(Ks, h * KB + j, nb, b0, b1);
      mma3(S[nb], ah, al, b0, b1);
    }
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * nb + 2 * t + (e & 1) >= N) S[nb][e] = -INFINITY;
}

// The rows' max m and sum l of exp(S - m) (rows g, g + 8); S becomes
// exp(S - m).
__device__ __forceinline__ void softmax_rows(float (&S)[8][4], float (&m)[2],
                                             float (&l)[2]) {
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], S[nb][e]);
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      S[nb][e] = expf(S[nb][e] - m[e >> 1]);
      s[e >> 1] += S[nb][e];
    }
  l[0] = quad_sum(s[0]);
  l[1] = quad_sum(s[1]);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Ring item j of an item's column block cb: j < NC the clip's x columns
// 64 j .. and the q, k, v columns of cb over Wqkv's rows 64 j ..; then
// Wproj's rows of cb, three column blocks an item.
__device__ __forceinline__ WItem fwd_item(const Args& p, int item, int cb,
                                          int j) {
  const int NC = p.C / 64;
  WItem it;
  if (j < NC) {
    it.p[0] = p.x + (size_t)(item / row_blocks(p.N)) * p.N * p.C + 64 * j;
    it.ld0 = p.C;
    it.rows0 = p.N;
    it.ld = 3 * p.C;
    it.n = 4;
    for (int s = 0; s < 3; ++s)
      it.p[s + 1] = p.wqkv + (size_t)j * 64 * 3 * p.C + s * p.C + cb * 64;
  } else {
    const int o0 = 3 * (j - NC);
    it.ld = it.ld0 = p.C;
    it.rows0 = 64;
    it.n = min(3, NC - o0);
    for (int s = 0; s < 3; ++s)  // past n: never read
      it.p[s] = p.wproj + (size_t)cb * 64 * p.C + (o0 + s) * 64;
  }
  return it;
}

// Head h of the item's 16 query rows: o = softmax(q k^T) v into its columns
// of Ob (and of o in device memory, rows < nv, with a gradient owed).
template <int KB>
__device__ __forceinline__ void fwd_head(const float* Qb, const float* Kb,
                                         const float* Vb, int N, int h,
                                         float* Ob, float* o, int C, int nv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float S[8][4], m[2], l[2];
  scores<KB>(Qb, 0, Kb, N, h, S);
  softmax_rows(S, m, l);
  float O[KB][4];
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[j][e] = 0.f;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    if (8 * kb >= N) break;
    unsigned ah[4], al[4];
    a_frag(S[kb][0], S[kb][1], S[kb][2], S[kb][3], ah, al);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float b0, b1;
      b_kn(Vb, kb, h * KB + j, b0, b1);
      mma3(O[j], ah, al, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[j][e] /= l[e >> 1];
  put_cols<KB>(Ob, 0, O, h * KB);
  if (o != nullptr)
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (g + 8 * hf < nv)
          *reinterpret_cast<float2*>(o + (size_t)(g + 8 * hf) * C +
                                     8 * (h * KB + j) + 2 * t) =
              make_float2(O[j][2 * hf], O[j][2 * hf + 1]);
}

template <int HB>
__global__ void __launch_bounds__(NT, 1) mhsa_fwd_f32_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KB = 8 / HB;  // 8-column blocks of a head
  float* ring = reinterpret_cast<float*>(smem);
  float* Kb = ring + 2 * FSTAGE;  // the clip's k of the column block
  float* Vb = Kb + BLK;           // its v
  float* Qb = Vb + BLK;         // the item's q rows
  float* Ob = Qb + QB;          // their o
  const int N = p.N, C = p.C, NC = C / 64, nrb = row_blocks(N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int begin, end;
  share(p.clips * nrb, begin, end);
  const int per = NC + cdiv(NC, 3);  // ring items a column block
  const int total = (end - begin) * NC * per;
  auto item_at = [&](int q) {
    return fwd_item(p, begin + q / per / NC, q / per % NC, q % per);
  };
  Ring rg{ring, FSTAGE, 0};
  issue_blocks(item_at(0), ring);
  int q = 0;
  auto next = [&]() {
    ++q;
    return rg.next(q < total, item_at(q < total ? q : 0));
  };
  // Warp roles in the qkv products: k (warps 0-3) or v (4-7) of row block
  // warp % 4.
  const int rbw = warp & 3;
  const bool isv = warp >= 4;

  for (int item = begin; item < end; ++item) {
    const int clip = item / nrb, rb = item % nrb;
    const size_t row0 = (size_t)clip * N;
    const int nv = min(RB, N - RB * rb);
    const bool act = rbw < nrb, doq = !isv && rbw == rb;
    float acc_o[4][4];  // out's 8 columns of the warp in column block ob
#pragma unroll
    for (int ob = 0; ob < 4; ++ob)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_o[ob][e] = 0.f;

    for (int cb = 0; cb < NC; ++cb) {
      float acc[8][4], accq[8][4];
      zero(acc);
      zero(accq);
      for (int kb = 0; kb < NC; ++kb) {
        const float* W = next();  // x's columns, then Wq, Wk, Wv's rows
        if (act)
#pragma unroll 1
          for (int k8 = 0; k8 < 8; ++k8) {
            unsigned ah[4], al[4];
            a_rows(W, rbw, k8, ah, al);
            mm_kstep(ah, al, W + (isv ? 3 : 2) * BLK, k8, acc);
            if (doq) mm_kstep(ah, al, W + BLK, k8, accq);
          }
      }
      if (act) {
        add_cols(acc, p.bqkv + (isv ? 2 : 1) * C + 64 * cb);
        mask_rows(acc, N - RB * rbw);  // padding rows zero (P V reads v's)
        put_tile(isv ? Vb : Kb, rbw, acc);
        if (doq) {
          add_cols(accq, p.bqkv + 64 * cb);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) accq[nb][e] *= p.qscale;
          put_tile(Qb, 0, accq);
        }
        if (p.qkv != nullptr && rbw == rb) {
          float* dst = p.qkv + (row0 + RB * rb) * 3 * C + 64 * cb;
          store_tile(dst + (isv ? 2 : 1) * C, 3 * C, nv, acc);
          if (doq) store_tile(dst, 3 * C, nv, accq);
        }
      }
      __syncthreads();
      if (warp < HB)
        fwd_head<KB>(Qb, Kb, Vb, N, warp, Ob,
                     p.o != nullptr ? p.o + (row0 + RB * rb) * C + 64 * cb
                                    : nullptr,
                     C, nv);
      // out += o_cb Wproj[cb rows, :], three column blocks an item.
      for (int j = NC; j < per; ++j) {
        const float* W = next();
#pragma unroll
        for (int ob = 0; ob < 4; ++ob) {
          const int s = ob - 3 * (j - NC);
          if (s < 0 || s > 2 || ob >= NC) continue;
#pragma unroll
          for (int kb = 0; kb < 8; ++kb) {
            unsigned ah[4], al[4];
            a_rows(Ob, 0, kb, ah, al);
            float b0, b1;
            b_kn(W + s * BLK, kb, warp, b0, b1);
            mma3(acc_o[ob], ah, al, b0, b1);
          }
        }
      }
    }
    float* out = p.out + (row0 + RB * rb) * C;
#pragma unroll
    for (int ob = 0; ob < 4; ++ob) {
      if (ob >= NC) continue;
      const int c = 64 * ob + 8 * warp + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(p.bproj + c);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (g + 8 * hf < nv)
          *reinterpret_cast<float2*>(out + (size_t)(g + 8 * hf) * C + c) =
              make_float2(acc_o[ob][2 * hf] + b.x,
                          acc_o[ob][2 * hf + 1] + b.y);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Ring item j of an item's column block cb: j < NC the clip's g columns
// 64 j .. and Wproj's block (rows of cb, columns 64 j ..: dO = g Wproj^T);
// then, for each column block ob = j - NC of dx, Wqkv's rows of ob at the
// q, k, v columns of cb (dx += dqkv Wqkv^T).
__device__ __forceinline__ WItem bwd_item(const Args& p, int item, int cb,
                                          int j) {
  const int NC = p.C / 64;
  WItem it;
  if (j < NC) {
    it.p[0] = p.g + (size_t)(item / row_blocks(p.N)) * p.N * p.C + 64 * j;
    it.ld0 = it.ld = p.C;
    it.rows0 = p.N;
    it.n = 2;
    it.p[1] = p.wproj + (size_t)cb * 64 * p.C + 64 * j;
  } else {
    it.ld = it.ld0 = 3 * p.C;
    it.rows0 = 64;
    it.n = 3;
    for (int s = 0; s < 3; ++s)
      it.p[s] = p.wqkv + (size_t)(j - NC) * 64 * 3 * p.C + s * p.C + cb * 64;
  }
  return it;
}

// The item's rows as queries, head h: dq = qscale dS K, dS = P (dP - D),
// P = exp(S - M) / L, dP = dO V^T; into dq's columns of the head.
template <int KB>
__device__ __forceinline__ void dq_head(const float* Qb, const float* Db,
                                        const float* Kb, const float* Vb,
                                        const float* St, int N, int rb, int h,
                                        float qscale, float* Gq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = RB * rb + g;
  float M[2], L[2], D[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    M[hf] = St[(0 * HMAX + h) * TR + r0 + 8 * hf];
    L[hf] = St[(1 * HMAX + h) * TR + r0 + 8 * hf];
    D[hf] = St[(2 * HMAX + h) * TR + r0 + 8 * hf];
  }
  unsigned qh[KB][4], ql[KB][4], oh[KB][4], ol[KB][4];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    a_rows(Qb, rb, h * KB + j, qh[j], ql[j]);
    a_rows(Db, rb, h * KB + j, oh[j], ol[j]);
  }
  float dq[KB][4];
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll 1
  for (int nb = 0; nb < 8; ++nb) {
    if (8 * nb >= N) break;
    float s4[4] = {0.f, 0.f, 0.f, 0.f}, p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float b0, b1;
      b_nk(Kb, h * KB + j, nb, b0, b1);
      mma3(s4, qh[j], ql[j], b0, b1);
      b_nk(Vb, h * KB + j, nb, b0, b1);
      mma3(p4, oh[j], ol[j], b0, b1);
    }
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      ds[e] = 8 * nb + 2 * t + (e & 1) < N
                  ? expf(s4[e] - M[hf]) / L[hf] * (p4[e] - D[hf])
                  : 0.f;
    }
    unsigned ah[4], al[4];
    a_frag(ds[0], ds[1], ds[2], ds[3], ah, al);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float b0, b1;
      b_kn(Kb, nb, h * KB + j, b0, b1);
      mma3(dq[j], ah, al, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] *= qscale;
  put_cols<KB>(Gq, 0, dq, h * KB);
}

// The item's rows as keys, head h: dk = dS^T q, dv = P^T dO over the clip's
// queries (P, dS from the scores recomputed key-side); into dk's and dv's
// columns of the head.
template <int KB>
__device__ __forceinline__ void dkv_head(const float* Qb, const float* Db,
                                         const float* Kb, const float* Vb,
                                         const float* St, int N, int rb, int h,
                                         float* Gk, float* Gv) {
  const int t = threadIdx.x & 3;
  unsigned kh[KB][4], kl[KB][4], vh[KB][4], vl[KB][4];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    a_rows(Kb, rb, h * KB + j, kh[j], kl[j]);
    a_rows(Vb, rb, h * KB + j, vh[j], vl[j]);
  }
  float dk[KB][4], dv[KB][4];
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
#pragma unroll 1
  for (int nb = 0; nb < 8; ++nb) {
    if (8 * nb >= N) break;
    float s4[4] = {0.f, 0.f, 0.f, 0.f}, p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float b0, b1;
      b_nk(Qb, h * KB + j, nb, b0, b1);
      mma3(s4, kh[j], kl[j], b0, b1);
      b_nk(Db, h * KB + j, nb, b0, b1);
      mma3(p4, vh[j], vl[j], b0, b1);
    }
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * nb + 2 * t + (e & 1);  // the query
      const bool in = i < N;
      pr[e] = in ? expf(s4[e] - St[(0 * HMAX + h) * TR + i]) /
                       St[(1 * HMAX + h) * TR + i]
                 : 0.f;
      ds[e] = in ? pr[e] * (p4[e] - St[(2 * HMAX + h) * TR + i]) : 0.f;
    }
    unsigned ph[4], pl[4], dh[4], dl[4];
    a_frag(pr[0], pr[1], pr[2], pr[3], ph, pl);
    a_frag(ds[0], ds[1], ds[2], ds[3], dh, dl);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float b0, b1;
      b_kn(Db, nb, h * KB + j, b0, b1);
      mma3(dv[j], ph, pl, b0, b1);
      b_kn(Qb, nb, h * KB + j, b0, b1);
      mma3(dk[j], dh, dl, b0, b1);
    }
  }
  put_cols<KB>(Gk, 0, dk, h * KB);
  put_cols<KB>(Gv, 0, dv, h * KB);
}

template <int HB>
__global__ void __launch_bounds__(NT, 1) mhsa_bwd_f32_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KB = 8 / HB;
  float* ring = reinterpret_cast<float*>(smem);
  float* Kb = ring + 2 * BSTAGE;  // the clip's k, v, q, dO, o of the column
  float* Vb = Kb + BLK;         // block
  float* Qb = Vb + BLK;
  float* Db = Qb + BLK;
  float* Ob = Db + BLK;
  float* St = Ob + BLK;         // the rows' max, sum, D: [3][HMAX][TR]
  float* Gq = St + STATS;       // the item's dq, dk, dv rows
  const int N = p.N, C = p.C, NC = C / 64, nrb = row_blocks(N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int begin, end;
  share(p.clips * nrb, begin, end);
  const int per = 2 * NC;  // ring items a column block
  const int units = (end - begin) * NC;
  const int total = units * per;
  auto item_at = [&](int q) {
    return bwd_item(p, begin + q / per / NC, q / per % NC, q % per);
  };
  Ring rg{ring, BSTAGE, 0};
  int q = 0;
  auto next = [&]() {
    ++q;
    return rg.next(q < total, item_at(q < total ? q : 0));
  };
  // The clip's q, k, v and o columns of a unit (item, column block).
  auto issue_acts = [&](int u) {
    const int item = begin + u / NC, cb = u % NC;
    const size_t row0 = (size_t)(item / nrb) * N;
    const float* qkv = p.qkv + row0 * 3 * C + 64 * cb;
    issue_rows(Qb, qkv, 3 * C, N, nrb);
    issue_rows(Kb, qkv + C, 3 * C, N, nrb);
    issue_rows(Vb, qkv + 2 * C, 3 * C, N, nrb);
    issue_rows(Ob, p.o + row0 * C + 64 * cb, C, N, nrb);
  };
  issue_blocks(item_at(0), ring);
  issue_acts(0);

  for (int item = begin; item < end; ++item) {
    const int clip = item / nrb, rb = item % nrb;
    const size_t row0 = (size_t)clip * N, own = row0 + RB * rb;
    const int nv = min(RB, N - RB * rb);
    float* part = p.part + (size_t)item * 4 * C;
    // dbproj's partial: g's column sums over the item's rows, in order.
    for (int c = threadIdx.x; c < C; c += NT) {
      float s = 0.f;
      for (int r = 0; r < nv; ++r) s += p.g[(own + r) * C + c];
      part[3 * C + c] = s;
    }
    float acc_dx[4][4];  // dx's 8 columns of the warp in column block ob
#pragma unroll
    for (int ob = 0; ob < 4; ++ob)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dx[ob][e] = 0.f;

    for (int cb = 0; cb < NC; ++cb) {
      const int u = (item - begin) * NC + cb;
      // dO of row block `warp` (warps < nrb) = g Wproj^T, then D per head.
      float dO[8][4];
      zero(dO);
      for (int kb = 0; kb < NC; ++kb) {
        const float* W = next();  // g's columns, Wproj's block
        if (warp < nrb)
#pragma unroll 1
          for (int k8 = 0; k8 < 8; ++k8) {
            unsigned ah[4], al[4];
            a_rows(W, warp, k8, ah, al);
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              float b0, b1;
              b_nk(W + BLK, k8, nb, b0, b1);
              mma3(dO[nb], ah, al, b0, b1);
            }
          }
      }
      if (warp < nrb) {
        mask_rows(dO, N - RB * warp);
        put_tile(Db, warp, dO);
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          float d[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int c = 8 * (h * KB + j) + 2 * t;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float2 o = *reinterpret_cast<const float2*>(
                  Ob + sat(RB * warp + g + 8 * hf, c));
              d[hf] += dO[h * KB + j][2 * hf] * o.x +
                       dO[h * KB + j][2 * hf + 1] * o.y;
            }
          }
          d[0] = quad_sum(d[0]);
          d[1] = quad_sum(d[1]);
          if (t == 0) {
            St[(2 * HMAX + h) * TR + RB * warp + g] = d[0];
            St[(2 * HMAX + h) * TR + RB * warp + g + 8] = d[1];
          }
        }
      }
      // The softmax's max and sum of every (row block, head).
      for (int task = warp; task < nrb * HB; task += NW) {
        const int rbx = task / HB, h = task % HB;
        float S[8][4], m[2], l[2];
        scores<KB>(Qb, rbx, Kb, N, h, S);
        softmax_rows(S, m, l);
        if (t == 0)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            St[(0 * HMAX + h) * TR + RB * rbx + g + 8 * hf] = m[hf];
            St[(1 * HMAX + h) * TR + RB * rbx + g + 8 * hf] = l[hf];
          }
      }
      __syncthreads();
      if (warp < 4) {
        for (int h = warp; h < HB; h += 4)
          dq_head<KB>(Qb, Db, Kb, Vb, St, N, rb, h, p.qscale, Gq);
      } else {
        for (int h = warp - 4; h < HB; h += 4)
          dkv_head<KB>(Qb, Db, Kb, Vb, St, N, rb, h, Gq + QB, Gq + 2 * QB);
      }
      __syncthreads();
      if (u + 1 < units) issue_acts(u + 1);
      // dqkv's rows of the column block to device memory, and their column
      // sums (dbqkv's partials) in row order.
      for (int e = threadIdx.x; e < 3 * nv * 16; e += NT) {
        const int s = e / (nv * 16), r = e / 16 % nv, c4 = (e & 15) << 2;
        *reinterpret_cast<float4*>(p.dqkv + (own + r) * 3 * C + s * C +
                                   64 * cb + c4) =
            *reinterpret_cast<const float4*>(Gq + s * QB + sat(r, c4));
      }
      for (int c = threadIdx.x; c < 3 * 64; c += NT) {
        const int s = c >> 6, col = c & 63;
        float sum = 0.f;
        for (int r = 0; r < nv; ++r) sum += Gq[s * QB + sat(r, col)];
        part[s * C + 64 * cb + col] = sum;
      }
      // dx += dqkv_cb Wqkv[ob rows, cb's q, k, v columns]^T, a warp an
      // 8-column block of each ob.
      for (int ob = 0; ob < NC; ++ob) {
        const float* W = next();
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          if (o != ob) continue;
#pragma unroll
          for (int s = 0; s < 3; ++s)
#pragma unroll
            for (int kb = 0; kb < 8; ++kb) {
              unsigned ah[4], al[4];
              a_rows(Gq + s * QB, 0, kb, ah, al);
              float b0, b1;
              b_nk(W + s * BLK, kb, warp, b0, b1);
              mma3(acc_dx[o], ah, al, b0, b1);
            }
        }
      }
    }
    float* dx = p.dx + own * C;
#pragma unroll
    for (int ob = 0; ob < 4; ++ob) {
      if (ob >= NC) continue;
      const int c = 64 * ob + 8 * warp + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (g + 8 * hf < nv)
          *reinterpret_cast<float2*>(dx + (size_t)(g + 8 * hf) * C + c) =
              make_float2(acc_dx[ob][2 * hf], acc_dx[ob][2 * hf + 1]);
    }
  }
}

bool shape_ok(int clips, int N, int C, int heads) {
  if (clips <= 0 || N <= 0 || N > TR || C <= 0 || C % 64 || C > 256 ||
      heads <= 0 || C % heads)
    return false;
  const int dh = C / heads;
  return dh == 8 || dh == 16 || dh == 32;
}

template <class K>
cudaError_t launch(K kernel, int items, int ctas, int floats,
                   cudaStream_t st, const Args& a) {
  const int bytes = floats * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<items < ctas ? items : ctas, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace mf32

// Host entry points.

// The forward over [clips, N, C] tokens on min(clips * ceil(N / 16), ctas)
// persistent CTAs. ptrs: x, wqkv [C, 3C], bqkv, wproj [C, C], bproj (f32,
// [in, out] as the parameters are), out, qkv [clips * N, 3C] (q scaled)
// and o [clips * N, C]: the backward's saved state, both null when no
// gradient is owed.
extern "C" int pmce_mhsa_fwd_f32(void* const* ptrs, int clips, int N, int C,
                                 int heads, float qscale, int ctas,
                                 void* stream) {
  using namespace mf32;
  if (!shape_ok(clips, N, C, heads) || ctas <= 0 ||
      (ptrs[6] == nullptr) != (ptrs[7] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.x = static_cast<const float*>(ptrs[0]);
  a.wqkv = static_cast<const float*>(ptrs[1]);
  a.bqkv = static_cast<const float*>(ptrs[2]);
  a.wproj = static_cast<const float*>(ptrs[3]);
  a.bproj = static_cast<const float*>(ptrs[4]);
  a.out = static_cast<float*>(ptrs[5]);
  a.qkv = static_cast<float*>(ptrs[6]);
  a.o = static_cast<float*>(ptrs[7]);
  a.clips = clips; a.N = N; a.C = C; a.heads = heads; a.qscale = qscale;
  const int items = clips * row_blocks(N), dh = C / heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dh == 8    ? launch(mhsa_fwd_f32_kernel<8>, items, ctas, FWD_FLOATS, st, a)
      : dh == 16 ? launch(mhsa_fwd_f32_kernel<4>, items, ctas, FWD_FLOATS, st, a)
                 : launch(mhsa_fwd_f32_kernel<2>, items, ctas, FWD_FLOATS, st,
                          a));
}

// The backward: dx and the four parameter gradients, on the forward's
// CTAs. ptrs: g (the output's gradient), x, wqkv, wproj, qkv, o (the
// forward's saved state), the workspace dqkv [clips * N, 3C], the items'
// bias partials [clips * ceil(N / 16), 4C], the weight gradients' range
// partials [splits, 4C^2 / 4096, 4096]; dx, dwqkv [C, 3C], dwproj [C, C],
// and the bias gradients [4C] (dbqkv, then dbproj).
extern "C" int pmce_mhsa_bwd_f32(void* const* ptrs, int clips, int N, int C,
                                 int heads, float qscale, int splits,
                                 int ctas, void* stream) {
  using namespace mf32;
  if (!shape_ok(clips, N, C, heads) || splits <= 0 || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.g = f(0);
  a.wqkv = f(2);
  a.wproj = f(3);
  a.qkv = f(4);
  a.o = f(5);
  a.dqkv = f(6);
  a.part = f(7);
  a.dx = f(9);
  a.clips = clips; a.N = N; a.C = C; a.heads = heads; a.qscale = qscale;
  const int items = clips * row_blocks(N), dh = C / heads;
  cudaError_t e =
      dh == 8    ? launch(mhsa_bwd_f32_kernel<8>, items, ctas, BWD_FLOATS, st, a)
      : dh == 16 ? launch(mhsa_bwd_f32_kernel<4>, items, ctas, BWD_FLOATS, st, a)
                 : launch(mhsa_bwd_f32_kernel<2>, items, ctas, BWD_FLOATS, st,
                          a);
  if (e != cudaSuccess) return static_cast<int>(e);

  f32ops::Jobs J;
  J.job[0] = {f(1), f(6), f(10), C, 3 * C};
  J.job[1] = {f(5), f(0), f(11), C, C};
  J.n = 2;
  J.M = clips * N;
  J.splits = splits;
  J.ws = f(8);
  J.vpart = f(7);
  J.vout = f(12);
  J.vtiles = items;
  J.vlen = 4 * C;
  return static_cast<int>(f32ops::launch_wgrad(J, st));
}

PMCE_EXPORT_ERROR_STRING(pmce_mhsa_f32_error_string)
