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
// vertices attending to joints (431 queries over 17 keys, 2 heads of 32);
// on the two-level mesh 1723 vertices instead of 431.
//
// What bounds it on this card: the products are ~0.4 GFLOP per direction
// at these shapes and the activations ~4 MB: microseconds at the bf16
// tensor-core peak or the HBM rate. Launches, host work and latency bound
// it.
//
// Forward, one launch where the tile programs' gate holds (C = 64, hid up
// to 256, the short side up to 64 rows, the long side of any length): the
// tile program (caf::ca_fwd_tile_kernel), a cluster of CL = 4 CTAs a clip,
// the long side split in quarters, each CTA walking its quarter in passes
// of up to 128 rows (one pass up to 512 rows, four at the 1723-vertex
// mesh), the short side whole in every CTA (computed by each, stored by
// rank 0 alone). The six weights are read into shared memory from their
// [in, out] rows by cp.async once; a warp's 16 rows go through AdaLN, the
// projections (q scaled in f32 before its bf16 rounding), the attention
// (scores and P on the tensor cores, P rounded to bf16 after normalising:
// the plain version's cast point), the projection with its masked
// residual, AdaLN2, fc1 + exact GELU and fc2 with its masked residual, all
// in the accumulator's registers. With the keys split, each pass's partial
// softmax max and sum are folded into the CTA's (PM, PL); every CTA merges
// the four CTAs' in rank order through distributed shared memory, then
// each CTA's P.V over its keys (its passes in turn, k and v recomputed for
// all but the last, whose are still in shared memory, added in PO) is
// added by rank 0 in rank order: the saved max and sum are the whole key
// range's, which the backward's P reads. It writes the state the backward
// reads only when a gradient is owed (the branches a, mo only for the mask
// gradients). Other shapes: the launch sequence, one launch per stage over
// all rows (three AdaLNs, WMMA projections, attention_ops.cuh's CUDA-core
// attention, the residual projection, the AdaLN'd MLP).
//
// Backward, two launches:
// - the tile program (cab::ca_bwd_tile_kernel): a cluster of CL = 4 CTAs a
//   clip (128 CTAs at batch 32; one CTA a clip would leave 100 SMs idle).
//   The CTAs split the long side (the vertices' 431 or 1723 rows: queries
//   in one orientation, keys in the other) into quarters, each walked in
//   passes of up to 128 rows; every CTA holds the short side (at most 64
//   rows) whole. A CTA runs, a warp per 16 query rows: m2 * g; the MLP's
//   backward (fc2^T, gelu'(hh), fc1^T per block of 64 hidden units, all on
//   the tensor cores, mma.sync m16n8k16, B fragments read from the weights'
//   own [in, out] layout by ldmatrix without .trans: no transposed copy);
//   the norm2 AdaLN backward from the accumulator's fragments plus the
//   residual; da = m1 * dx1; proj^T. Then the attention backward on the
//   tensor cores from the forward's saved q, k, v, o and softmax
//   statistics (D = dO . O, P recomputed from the saved max and sum; head
//   width 8 by mma m16n8k8): dq by (query tile, head), dk and dv by (key
//   tile, head), each block of the result owned by one warp. Then q / k /
//   v proj^T and the three AdaLN backwards. Split queries run all of it a
//   pass at a time (W2 and W1 read again for each pass: their region holds
//   the pass's sums); split keys run the queries' side once and the rest a
//   pass of keys at a time. The short side's sums over the long side (dk,
//   dv of the 17 joints as keys; dq of the 17 joints as queries) are added
//   over a CTA's passes in pass order (dk, dv through a workspace between
//   passes, dq in shared memory), then with the per-clip sums (the four
//   norms' dgamma / dbeta, the mask gradients) across the cluster through
//   distributed shared memory by the cluster's rank 0, in rank order: no
//   float atomics, reruns bit-identical. It writes dxq, dxk, dxv, the
//   per-clip vectors and the weight products' bf16 dY operands.
// - the weight gradients (wgrad.cuh, shared with block.cu): the six
//   X^T dY products (dWq, dWk, dWv, dWproj, dW1, dW2) over a list of
//   64 x 64 output tiles, each cut into fixed K ranges; the CTA that
//   finishes a tile's last range (an integer counter, zeroed by the tile
//   program) adds the ranges' partials and column sums (the six bias
//   gradients) in range order.

#include "adaln_tile.cuh"
#include "attention_ops.cuh"
#include "wgrad.cuh"

using namespace pmce;

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

// ---------------------------------------------------------------------------
// The forward's tile program (row 10): a cluster of CL = 4 CTAs a clip.
// ---------------------------------------------------------------------------
namespace caf {

using namespace tile;

constexpr int NSTAMP = 6;  // loads, k/v norms + proj, q norm + proj,
                           // attention, cluster merge, proj + norm2 + MLP

// Shared-memory plan, bytes: the six weights, the CTA's q, k, v and o
// tiles, and (keys split) the partial softmax of its keys.
constexpr int TILE = RT * LD * 2;                     // [128, 72] bf16
constexpr int WSQ = CW * LD * 2;                      // [64, 72] bf16
constexpr int OFF_WQ = 0, OFF_WK = WSQ, OFF_WV = 2 * WSQ, OFF_WP = 3 * WSQ;
constexpr int OFF_W2 = 4 * WSQ;                       // [hid, 72]
constexpr int OFF_W1 = OFF_W2 + MAX_HID * LD * 2;     // [64, hid + 8]
constexpr int OFF_QT = OFF_W1 + CW * (MAX_HID + 8) * 2;
constexpr int OFF_KT = OFF_QT + TILE;
constexpr int OFF_VT = OFF_KT + TILE;
constexpr int OFF_OT = OFF_VT + TILE;
constexpr int OFF_PM = OFF_OT + TILE;                 // [64, 8] f32 max
constexpr int OFF_PL = OFF_PM + ST * MAXH * 4;        // [64, 8] f32 sum
constexpr int OFF_PO = OFF_PL + ST * MAXH * 4;        // [64, 64] f32 P.V
constexpr int SMEM = OFF_PO + ST * CW * 4;
static_assert(SMEM <= 232448, "over the opt-in shared memory");

struct Args {
  const bf16 *xq, *xk, *xv;             // [Mq | Mk, 64]
  const float* cond[8];                 // gq, bq, gk, bk, gv, bv, g2, b2
  const float *m1, *m2;                 // [clips] or null
  const bf16 *wq, *wk, *wv, *wproj, *w1, *w2;  // [in, out]
  const float *bq, *bk, *bv, *bproj, *bb1, *bb2;
  bf16* out;
  bf16 *nq, *nk, *nv, *q, *k, *v, *o;   // the saved state, or all null
  float *sm, *sl;                       // [clips, H, Nq] softmax max, sum
  float* x1;                            // [Mq, 64]
  bf16* h2;
  float* hh;                            // [Mq, hid]
  bf16* ge;
  float *a, *mo;                        // [Mq, 64] or null
  int clips, Nq, Nk, hid;
  float eps, qscale;
  long long* stamps;                    // [clips * CL, NSTAMP] or null
};

// One input's side of the attention, a warp's 16 rows: the clip's AdaLN of
// x's rows, rounded to bf16 (into nsave's rows when set), then (@ W + bias)
// times scale, rounded to bf16 into the tile t (row stride LD) and psave's
// rows when set.
__device__ __forceinline__ void norm_proj(const bf16* x, size_t row0,
                                          bool v0, bool v1, const float* gam,
                                          const float* bet, float eps,
                                          const bf16* W, const float* bias,
                                          float scale, bf16* t, bf16* nsave,
                                          bf16* psave) {
  float v[8][4];
  load_frag(v, x, row0, v0, v1);
  adaln_fwd_frag(v, gam, bet, eps);
  unsigned af[4][4];
  frag_a(af, v);
  if (nsave) store_bf(v, nullptr, nsave, row0, v0, v1);
  float acc[8][4];
  zero(acc);
  mma_aw(acc, af, W, LD);
  add_cols(acc, bias);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= scale;
  store_bf(acc, t, psave, row0, v0, v1);
}

// The row max m and sum l of exp(s - m) of a warp's 16 query rows q (a
// head's columns, row stride LD) over keys [0, nk) of k, quad-reduced: rows
// g (index 0) and g + 8. No keys: -inf and 0.
template <int D>
__device__ __forceinline__ void softmax_stats(const bf16* q, const bf16* k,
                                              int nk, float (&m)[2],
                                              float (&l)[2]) {
  const int tq = threadIdx.x & 3;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int kb = 0; kb < nk; kb += 16) {
    float sc[2][4] = {};
    dot_nt<D>(sc, q, LD, k + kb * LD, LD);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kb + t * 8 + 2 * tq + (e & 1) < nk)
          m[e >> 1] = fmaxf(m[e >> 1], sc[t][e]);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  for (int kb = 0; kb < nk; kb += 16) {
    float sc[2][4] = {};
    dot_nt<D>(sc, q, LD, k + kb * LD, LD);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kb + t * 8 + 2 * tq + (e & 1) < nk)
          l[e >> 1] += expf(sc[t][e] - m[e >> 1]);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// o[16, D] += P @ v over keys [0, nk), P = bf16(exp(s - m) * li): the
// plain version's cast point (probabilities rounded, f32 sums).
template <int D>
__device__ __forceinline__ void attend_pv(const bf16* q, const bf16* k,
                                          const bf16* v, int nk,
                                          const float (&m)[2],
                                          const float (&li)[2],
                                          float (&o)[D / 8][4]) {
  const int tq = threadIdx.x & 3;
  for (int kb = 0; kb < nk; kb += 16) {
    float sc[2][4] = {};
    dot_nt<D>(sc, q, LD, k + kb * LD, LD);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[t][e] = kb + t * 8 + 2 * tq + (e & 1) < nk
                       ? expf(sc[t][e] - m[e >> 1]) * li[e >> 1]
                       : 0.f;
    unsigned pa[4];
    pack_a(pa, sc);
    dot_pn<D>(o, 0, pa, v + kb * LD, LD);
  }
}

template <bool PROF, int D>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NTH, 1)
    ca_fwd_tile_kernel(const Args a) {
  constexpr int H = CW / D;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  bf16* Wq = reinterpret_cast<bf16*>(smem + OFF_WQ);
  bf16* Wk = reinterpret_cast<bf16*>(smem + OFF_WK);
  bf16* Wv = reinterpret_cast<bf16*>(smem + OFF_WV);
  bf16* Wp = reinterpret_cast<bf16*>(smem + OFF_WP);
  bf16* W2 = reinterpret_cast<bf16*>(smem + OFF_W2);
  bf16* W1 = reinterpret_cast<bf16*>(smem + OFF_W1);
  bf16* Qt = reinterpret_cast<bf16*>(smem + OFF_QT);
  bf16* Kt = reinterpret_cast<bf16*>(smem + OFF_KT);
  bf16* Vt = reinterpret_cast<bf16*>(smem + OFF_VT);
  bf16* Ot = reinterpret_cast<bf16*>(smem + OFF_OT);
  float* PM = reinterpret_cast<float*>(smem + OFF_PM);
  float* PL = reinterpret_cast<float*>(smem + OFF_PL);
  float* PO = reinterpret_cast<float*>(smem + OFF_PO);
  StageClock<PROF, NSTAMP> clk;
  clk.start();

  // The long side (the larger of Nq, Nk) in quarters of whole 16-row
  // blocks, a rank's quarter [l0, l1) walked in passes of up to RT rows; the
  // short side whole in every CTA, stored by rank 0 alone.
  const bool split_q = a.Nq >= a.Nk;
  const int nlong = split_q ? a.Nq : a.Nk;
  const int l0 = min(nlong, rank * rank_rows(nlong));
  const int l1 = min(nlong, l0 + rank_rows(nlong));
  const int passes = max(1, (l1 - l0 + RT - 1) / RT);
  const bool save = a.q != nullptr;
  const bool store_q = save && (split_q || rank == 0);
  const bool store_k = save && (!split_q || rank == 0);
  const size_t cb = (size_t)b * CW;
  const int hid = a.hid, ldw1 = hid + 8;

  // ---- loads: the six weights -------------------------------------------
  {
    const bf16* src[4] = {a.wq, a.wk, a.wv, a.wproj};
    bf16* dst[4] = {Wq, Wk, Wv, Wp};
    for (int c = tid; c < 4 * CW * 8; c += NTH) {
      const int m = c / (CW * 8), r = c % (CW * 8) / 8, cc = c % 8 * 8;
      cp_async16(dst[m] + r * LD + cc, src[m] + r * CW + cc, true);
    }
    for (int c = tid; c < hid * 8; c += NTH) {
      const int r = c / 8, cc = c % 8 * 8;
      cp_async16(W2 + r * LD + cc, a.w2 + (size_t)r * CW + cc, true);
    }
    for (int c = tid; c < CW * (hid / 8); c += NTH) {
      const int r = c / (hid / 8), cc = c % (hid / 8) * 8;
      cp_async16(W1 + r * ldw1 + cc, a.w1 + (size_t)r * hid + cc, true);
    }
    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  clk(0);

  // The keys' side of rows [k0, k0 + nk), a warp per 16 rows: AdaLN, then
  // k and v into Kt, Vt (and the saved state where `store`).
  const auto keys_side = [&](int k0, int nk, bool store) {
    const size_t krow0 = (size_t)b * a.Nk + k0;
    for (int kr = warp * 16; kr < (nk + 15) / 16 * 16; kr += NW * 16) {
      const bool v0 = kr + g < nk, v1 = kr + g + 8 < nk;
      norm_proj(a.xk, krow0 + kr, v0, v1, a.cond[2] + cb, a.cond[3] + cb,
                a.eps, Wk, a.bk, 1.f, Kt + kr * LD, store ? a.nk : nullptr,
                store ? a.k : nullptr);
      norm_proj(a.xv, krow0 + kr, v0, v1, a.cond[4] + cb, a.cond[5] + cb,
                a.eps, Wv, a.bv, 1.f, Vt + kr * LD, store ? a.nv : nullptr,
                store ? a.v : nullptr);
    }
  };
  // The queries' side of rows [q0, q0 + nq): AdaLN, then q (scaled in f32
  // before its bf16 rounding) into Qt.
  const auto queries_side = [&](int q0, int nq) {
    const size_t qrow0 = (size_t)b * a.Nq + q0;
    for (int qr = warp * 16; qr < (nq + 15) / 16 * 16; qr += NW * 16) {
      const bool v0 = qr + g < nq, v1 = qr + g + 8 < nq;
      norm_proj(a.xq, qrow0 + qr, v0, v1, a.cond[0] + cb, a.cond[1] + cb,
                a.eps, Wq, a.bq, a.qscale, Qt + qr * LD,
                store_q ? a.nq : nullptr, store_q ? a.q : nullptr);
    }
  };
  // The projection with its masked residual, AdaLN2 and the MLP with its
  // masked residual of query rows [q0, q0 + nq), a warp per 16 rows, all in
  // registers.
  const float s1 = a.m1 ? a.m1[b] : 1.f, s2 = a.m2 ? a.m2[b] : 1.f;
  const auto tail = [&](int q0, int nq) {
    const Tail t{a.xq, a.out, Wp, W1, W2, a.bproj, a.bb1, a.bb2,
                 a.cond[6] + cb, a.cond[7] + cb, a.a, a.x1, a.hh, a.mo,
                 a.h2, a.ge, hid, a.eps};
    const size_t qrow0 = (size_t)b * a.Nq + q0;
    for (int qr = warp * 16; qr < (nq + 15) / 16 * 16; qr += NW * 16) {
      unsigned of[4][4];
      load_a(of, Ot + qr * LD, LD);
      ada_tail(t, of, qrow0 + qr, qr + g < nq, qr + g + 8 < nq, s1, s2);
    }
  };

  if (split_q) {
    // ---- queries split: the keys whole, then each pass of the rank's
    // queries through the whole softmax, its P.V and the tail -------------
    keys_side(0, a.Nk, store_k);
    clk(1);
    for (int p = 0; p < passes; ++p) {
      const int q0 = l0 + p * RT, nq = max(0, min(RT, l1 - q0));
      const int nq16 = (nq + 15) / 16 * 16;
      const size_t qrow0 = (size_t)b * a.Nq + q0;
      if (p) __syncthreads();  // the last pass is done with Qt and Ot
      queries_side(q0, nq);
      __syncthreads();
      clk(2);
      for (int it = warp; it < nq16 / 16 * H; it += NW) {
        const int qb = it / H * 16, h = it % H;
        const bf16* qh = Qt + qb * LD + h * D;
        float m[2], l[2];
        softmax_stats<D>(qh, Kt + h * D, a.Nk, m, l);
        const float li[2] = {1.0f / l[0], 1.0f / l[1]};
        float o[D / 8][4] = {};
        attend_pv<D>(qh, Kt + h * D, Vt + h * D, a.Nk, m, li, o);
#pragma unroll
        for (int d = 0; d < D / 8; ++d)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = qb + g + 8 * hf, c = h * D + d * 8 + 2 * tq;
            const unsigned pk = pack_bf2(o[d][2 * hf], o[d][2 * hf + 1]);
            *reinterpret_cast<unsigned*>(Ot + r * LD + c) = pk;
            if (store_q && r < nq)
              *reinterpret_cast<unsigned*>(a.o + (qrow0 + r) * CW + c) = pk;
          }
        if (store_q && tq == 0)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = qb + g + 8 * hf;
            if (r < nq) {
              const size_t si = ((size_t)b * H + h) * a.Nq + q0 + r;
              a.sm[si] = m[hf];
              a.sl[si] = l[hf];
            }
          }
      }
      clk(3);
      __syncthreads();
      clk(4);
      tail(q0, nq);
      clk(5);
    }
    clk.write(a.stamps);
    return;
  }

  // ---- keys split: the queries whole; each pass of the rank's keys folds
  // its partial softmax max and sum into PM, PL ------------------------------
  const int nq = a.Nq, nq16 = (nq + 15) / 16 * 16;
  queries_side(0, nq);
  clk(2);
  for (int p = 0; p < passes; ++p) {
    const int k0 = l0 + p * RT, nk = max(0, min(RT, l1 - k0));
    if (p) __syncthreads();  // the last pass is done with Kt
    keys_side(k0, nk, store_k);
    __syncthreads();
    clk(1);
    for (int it = warp; it < nq16 / 16 * H; it += NW) {
      const int qb = it / H * 16, h = it % H;
      float m[2], l[2];
      softmax_stats<D>(Qt + qb * LD + h * D, Kt + h * D, nk, m, l);
      if (tq == 0)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = (qb + g + 8 * hf) * MAXH + h;
          if (p == 0) {
            PM[i] = m[hf];
            PL[i] = l[hf];
          } else {  // a later pass has keys: m[hf] is finite
            const float mp = PM[i], mn = fmaxf(mp, m[hf]);
            PL[i] = PL[i] * expf(mp - mn) + l[hf] * expf(m[hf] - mn);
            PM[i] = mn;
          }
        }
    }
    clk(3);
  }

  // ---- the clip's softmax from the four partials (every CTA, in rank
  // order); each pass's P.V over its keys added in PO (the last pass first:
  // its k and v are still in Kt, Vt; the others recomputed); the CTAs' PO
  // summed by rank 0 in rank order -------------------------------------------
  cluster.sync();
  const float* rpm[CL];
  const float* rpl[CL];
  for (int r = 0; r < CL; ++r) {
    rpm[r] = cluster.map_shared_rank(PM, r);
    rpl[r] = cluster.map_shared_rank(PL, r);
  }
  for (int p = passes - 1; p >= 0; --p) {
    const int k0 = l0 + p * RT, nk = max(0, min(RT, l1 - k0));
    const bool first = p == passes - 1;
    if (!first) {
      __syncthreads();  // the last pass is done with Kt, Vt
      keys_side(k0, nk, false);
      __syncthreads();
    }
    for (int it = warp; it < nq16 / 16 * H; it += NW) {
      const int qb = it / H * 16, h = it % H;
      float m[2], l[2], li[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = (qb + g + 8 * hf) * MAXH + h;
        float mg = -INFINITY;
        for (int r = 0; r < CL; ++r) mg = fmaxf(mg, rpm[r][i]);
        float lg = 0.f;
        for (int r = 0; r < CL; ++r) lg += rpl[r][i] * expf(rpm[r][i] - mg);
        m[hf] = mg;
        l[hf] = lg;
        li[hf] = 1.0f / lg;
      }
      float o[D / 8][4] = {};
      attend_pv<D>(Qt + qb * LD + h * D, Kt + h * D, Vt + h * D, nk, m, li,
                   o);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2* po = reinterpret_cast<float2*>(PO + (qb + g + 8 * hf) * CW +
                                                 h * D + d * 8 + 2 * tq);
          float2 v = make_float2(o[d][2 * hf], o[d][2 * hf + 1]);
          if (!first) {
            v.x += po->x;
            v.y += po->y;
          }
          *po = v;
        }
      if (first && store_q && tq == 0)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = qb + g + 8 * hf;
          if (r < nq) {
            const size_t si = ((size_t)b * H + h) * a.Nq + r;
            a.sm[si] = m[hf];
            a.sl[si] = l[hf];
          }
        }
    }
  }
  cluster.sync();
  if (rank == 0) {
    const float* rpo[CL];
    for (int r = 0; r < CL; ++r) rpo[r] = cluster.map_shared_rank(PO, r);
    for (int e = tid; e < nq16 * CW; e += NTH) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) s += rpo[r][e];
      const int row = e / CW, c = e % CW;
      const bf16 v = f2bf(s);
      Ot[row * LD + c] = v;
      if (store_q && row < nq) a.o[(size_t)b * a.Nq * CW + row * CW + c] = v;
    }
  }
  cluster.sync();  // rank 0 has read the partials: the others may leave
  __syncthreads();
  clk(4);
  if (rank == 0) tail(0, nq);
  clk(5);
  clk.write(a.stamps);
}

}  // namespace caf

// The forward's tile program, a cluster of 4 CTAs a clip. ptrs: xq, xk, xv
// (bf16), gq, bq, gk, bk, gv, bv, g2, b2 ([clips, 64] f32), m1, m2 (or
// null), wq, wk, wv, wproj, w1, w2 (bf16 [in, out]), bq, bk, bv, bproj,
// bb1, bb2 (f32), out; the saved nq, nk, nv, q, k, v, o, stat_m, stat_l,
// x1, h2, hh, ge (all null: not saving, only out is written); a, mo (f32
// [Mq, 64] or null); stamps (null, or [clips * 4, 6] int64 for the stamped
// instantiation).
extern "C" int pmce_ca_fwd_tile(void* const* ptrs, int clips, int Nq, int Nk,
                                int hid, int H, float eps, void* stream) {
  using namespace caf;
  if (clips <= 0 || Nq <= 0 || Nk <= 0 || std::min(Nq, Nk) > ST ||
      hid <= 0 || hid % CW || hid > MAX_HID || (H != 2 && H != 4 && H != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  auto cb = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto b = [&](int i) { return static_cast<bf16*>(ptrs[i]); };
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  a.xq = cb(0); a.xk = cb(1); a.xv = cb(2);
  for (int i = 0; i < 8; ++i) a.cond[i] = cf(3 + i);
  a.m1 = cf(11); a.m2 = cf(12);
  a.wq = cb(13); a.wk = cb(14); a.wv = cb(15); a.wproj = cb(16);
  a.w1 = cb(17); a.w2 = cb(18);
  a.bq = cf(19); a.bk = cf(20); a.bv = cf(21); a.bproj = cf(22);
  a.bb1 = cf(23); a.bb2 = cf(24);
  a.out = b(25);
  a.nq = b(26); a.nk = b(27); a.nv = b(28); a.q = b(29); a.k = b(30);
  a.v = b(31); a.o = b(32); a.sm = f(33); a.sl = f(34); a.x1 = f(35);
  a.h2 = b(36); a.hh = f(37); a.ge = b(38);
  a.a = f(39); a.mo = f(40);
  a.stamps = static_cast<long long*>(ptrs[41]);
  a.clips = clips; a.Nq = Nq; a.Nk = Nk; a.hid = hid;
  a.eps = eps;
  a.qscale = 1.0f / sqrtf(static_cast<float>(CW / H));
  // The saved state is written whole or not at all.
  int saved = 0;
  for (int i = 26; i <= 38; ++i) saved += ptrs[i] != nullptr;
  if ((saved != 0 && saved != 13) || (a.a == nullptr) != (a.mo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMCE_CA_FWD(PROF, D)                                                \
  {                                                                         \
    const auto kernel = ca_fwd_tile_kernel<PROF, D>;                        \
    cudaError_t e = cudaFuncSetAttribute(                                   \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);         \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    kernel<<<clips * CL, NTH, SMEM, s>>>(a);                                \
    return static_cast<int>(cudaGetLastError());                            \
  }
  const int D = CW / H;
  if (a.stamps) {
    if (D == 8) PMCE_CA_FWD(true, 8)
    if (D == 16) PMCE_CA_FWD(true, 16)
    PMCE_CA_FWD(true, 32)
  }
  if (D == 8) PMCE_CA_FWD(false, 8)
  if (D == 16) PMCE_CA_FWD(false, 16)
  PMCE_CA_FWD(false, 32)
#undef PMCE_CA_FWD
}

namespace cab {

using namespace tile;

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
  // Split queries over more than a pass a rank: each CTA's dk | dv sums
  // over its passes, [clips * CL, ST, 2 * CW] f32 (else null).
  float* acc;
  int ncounters, clips, Nq, Nk, hid;
  float eps, qscale;
  long long* stamps;                    // [clips * CL, NSTAMP] or null
};

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

// The attention's dq for the 16 query rows qb .. of head h (unscaled),
// over keys [0, nk) of Ks, Vs: P recomputed from the rows' saved max (Ms)
// and 1 / sum (Ls), dS = P (dP - D) with dP = dO V^T; rows from nq on and
// keys from nk on give nothing.
template <int D>
__device__ __forceinline__ void attn_dq(float (&dq)[D / 8][4], const bf16* Qs,
                                        const bf16* DOs, const bf16* Ks,
                                        const bf16* Vs, const float* Ms,
                                        const float* Ls, const float* Ds,
                                        int qb, int h, int nq, int nk) {
  const int tq = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int r0 = qb + g, r1 = r0 + 8;
  const bool ok0 = r0 < nq, ok1 = r1 < nq;
  const float m[2] = {Ms[r0 * MAXH + h], Ms[r1 * MAXH + h]};
  const float li[2] = {Ls[r0 * MAXH + h], Ls[r1 * MAXH + h]};
  const float Dq[2] = {Ds[r0 * MAXH + h], Ds[r1 * MAXH + h]};
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  for (int kb = 0; kb < nk; kb += 16) {
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
    dot_pn<D>(dq, 0, pa, Ks + kb * LD + h * D, LD);
  }
}

// dk and dv of the 16 key rows kb .. of head h over queries [0, nq) (P and
// dS recomputed as attn_dq's).
template <int D>
__device__ __forceinline__ void attn_dkdv(float (&dk)[D / 8][4],
                                          float (&dv)[D / 8][4],
                                          const bf16* Qs, const bf16* DOs,
                                          const bf16* Ks, const bf16* Vs,
                                          const float* Ms, const float* Ls,
                                          const float* Ds, int kb, int h,
                                          int nq, int nk) {
  const int tq = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const bool kok0 = kb + g < nk, kok1 = kb + g + 8 < nk;
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  for (int qb = 0; qb < nq; qb += 16) {
    float st[2][4] = {}, dpt[2][4] = {}, pt[2][4], dst[2][4];
    dot_nt<D>(st, Ks + kb * LD + h * D, LD, Qs + qb * LD + h * D, LD);
    dot_nt<D>(dpt, Vs + kb * LD + h * D, LD, DOs + qb * LD + h * D, LD);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qb + t * 8 + 2 * tq + (e & 1);
        const bool in = q < nq && ((e >> 1) ? kok1 : kok0);
        const float p =
            in ? expf(st[t][e] - Ms[q * MAXH + h]) * Ls[q * MAXH + h] : 0.f;
        pt[t][e] = p;
        dst[t][e] = p * (dpt[t][e] - Ds[q * MAXH + h]);
      }
    unsigned pa[4], pb[4];
    pack_a(pa, pt);
    pack_a(pb, dst);
    dot_pn<D>(dv, 0, pa, DOs + qb * LD + h * D, LD);
    dot_pn<D>(dk, 0, pb, Qs + qb * LD + h * D, LD);
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
  StageClock<PROF, NSTAMP> clk;
  clk.start();

  // The long side (the larger of Nq, Nk) in quarters of whole 16-row
  // blocks, a rank's quarter [l0, l1) walked in passes of up to RT rows; the
  // short side whole in every CTA.
  const bool split_q = a.Nq >= a.Nk;
  const int nlong = split_q ? a.Nq : a.Nk;
  const int l0 = min(nlong, rank * rank_rows(nlong));
  const int l1 = min(nlong, l0 + rank_rows(nlong));
  const int passes = max(1, (l1 - l0 + RT - 1) / RT);
  // The first pass's rows of each side.
  int q0 = split_q ? l0 : 0, nq = split_q ? min(RT, l1 - l0) : a.Nq;
  int k0 = split_q ? 0 : l0, nk = split_q ? a.Nk : min(RT, l1 - l0);
  int nq16 = (nq + 15) / 16 * 16;
  // Every CTA of a split-keys cluster computes the queries' side; rank 0
  // alone writes its operands and adds its per-clip sums.
  const bool own_q = split_q || rank == 0;
  const bool masks = a.dm1 != nullptr;
  size_t qrow0 = (size_t)b * a.Nq + q0;
  const int hid = a.hid;
  const int ldw1 = hid + 8;
  float* dx1s = reinterpret_cast<float*>(smem + OFF_M +
                                         (split_q ? M_DX1_Q : M_DX1_K));
  // W2 and W1 into region M (again for each pass of split queries: the
  // pass before used the region for its sums).
  const auto load_mlp = [&]() {
    for (int c = tid; c < hid * 8; c += NTH) {
      const int r = c / 8, cc = c % 8 * 8;
      cp_async16(W2 + r * LD + cc, a.w2 + (size_t)r * CW + cc, true);
    }
    for (int c = tid; c < CW * (hid / 8); c += NTH) {
      const int r = c / (hid / 8), cc = c % (hid / 8) * 8;
      cp_async16(W1 + r * ldw1 + cc, a.w1 + (size_t)r * hid + cc, true);
    }
  };

  if (blockIdx.x == 0 && tid < a.ncounters) a.counters[tid] = 0;

  // ---- loads: the six weights, the CTA's q, k, v rows ------------------
  {
    const bf16* sq[4] = {a.wproj, a.wq, a.wk, a.wv};
    bf16* dq4[4] = {Wp, Wq, Wk, Wv};
    for (int c = tid; c < 4 * CW * 8; c += NTH) {
      const int m = c / (CW * 8), r = c % (CW * 8) / 8, cc = c % 8 * 8;
      cp_async16(dq4[m] + r * LD + cc, sq[m] + r * CW + cc, true);
    }
    load_mlp();
    load_rows(Qs, a.q, qrow0, nq);
    load_rows(Ks, a.k, (size_t)b * a.Nk + k0, nk);
    load_rows(Vs, a.v, (size_t)b * a.Nk + k0, nk);
    for (int i = tid; i < VP_LEN; i += NTH) vp[i] = 0.f;
    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  clk(0);

  float* dkv = reinterpret_cast<float*>(smem + OFF_M + M_DKV);  // split_q
  float* dqp = reinterpret_cast<float*>(smem + OFF_M + M_DQP);  // split_k
  bf16* DKt = reinterpret_cast<bf16*>(smem + OFF_M + M_DK);     // split_k
  bf16* DVt = reinterpret_cast<bf16*>(smem + OFF_M + M_DV);     // split_k
  const int qr = warp * 16;
  bf16* T1w = T1 + qr * LD;
  bf16* T2w = T2 + qr * LD;
  const float s2 = a.m2 ? a.m2[b] : 1.f, s1 = a.m1 ? a.m1[b] : 1.f;
  bool wq_on = false, v0 = false, v1 = false;
  size_t wrow0 = 0;
  // The queries' side, a pass of split queries or the short side whole:
  // a warp per 16 rows.
  for (int p = 0; p < (split_q ? passes : 1); ++p) {
    if (p) {
      q0 = l0 + p * RT;
      nq = max(0, min(RT, l1 - q0));
      nq16 = (nq + 15) / 16 * 16;
      qrow0 = (size_t)b * a.Nq + q0;
      __syncthreads();  // the last pass is done with region M, Qs, T1, T2
      load_mlp();
      load_rows(Qs, a.q, qrow0, nq);
      cp_async_commit();
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      clk(0);
    }
    // ---- m2 * g, the MLP's backward (dh2 in registers), then after a
    // barrier the norm2 AdaLN backward, da, dO = da @ Wproj^T, D = dO . O
    // and the softmax statistics ------------------------------------------
    wq_on = qr < nq;
    v0 = qr + g < nq;
    v1 = qr + g + 8 < nq;
    wrow0 = qrow0 + qr;
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
      fold(vp, wpt, wpm, V_2, masks, 8 * CW);
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
    if (!split_q) break;

    // ---- split queries: dq over the keys (all here), then dk and dv of
    // the keys over the pass's queries: a partial, added over the passes
    // (in the workspace `acc` between them) into DKV -------------------------
    for (int it = warp; it < nq16 / 16 * H; it += NW) {
      const int qb = it / H * 16, h = it % H;
      float dq[D / 8][4];
      attn_dq<D>(dq, Qs, DOs, Ks, Vs, Ms, Ls, Ds, qb, h, nq, nk);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // Every key is here: dq is whole; bf16 (x qscale) into T1.
          const int r = qb + g + 8 * hf, c = h * D + d * 8 + 2 * tq;
          const unsigned pk = pack_bf2(dq[d][2 * hf] * a.qscale,
                                       dq[d][2 * hf + 1] * a.qscale);
          *reinterpret_cast<unsigned*>(T1 + r * LD + c) = pk;
          if (r < nq)
            *reinterpret_cast<unsigned*>(a.dq + (qrow0 + r) * CW + c) = pk;
        }
    }
    clk(4);
    for (int it = warp; it < (nk + 15) / 16 * H; it += NW) {
      const int kb = it / H * 16, h = it % H;
      float dk[D / 8][4], dv[D / 8][4];
      attn_dkdv<D>(dk, dv, Qs, DOs, Ks, Vs, Ms, Ls, Ds, kb, h, nq, nk);
      float* ws = a.acc + (size_t)blockIdx.x * ST * 2 * CW;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e = (kb + g + 8 * hf) * 2 * CW + h * D + d * 8 + 2 * tq;
          float2 pk = make_float2(dk[d][2 * hf], dk[d][2 * hf + 1]);
          float2 pv = make_float2(dv[d][2 * hf], dv[d][2 * hf + 1]);
          if (p) {  // the earlier passes' sum, this thread's own writes
            const float2 sk = *reinterpret_cast<const float2*>(ws + e);
            const float2 sv = *reinterpret_cast<const float2*>(ws + e + CW);
            pk = make_float2(sk.x + pk.x, sk.y + pk.y);
            pv = make_float2(sv.x + pv.x, sv.y + pv.y);
          }
          float* dst = p < passes - 1 ? ws : dkv;
          *reinterpret_cast<float2*>(dst + e) = pk;
          *reinterpret_cast<float2*>(dst + e + CW) = pv;
        }
    }
    __syncthreads();
    clk(5);
    // The queries: dq (T1) @ Wq^T, normq's backward + dx1.
    if (wq_on)
      proj_norm_bwd(T1w, Wq, a.xq, a.gq + (size_t)b * CW, a.eps,
                    dx1s + qr * CW, a.dxq, wrow0, v0, v1,
                    wpt + warp * 2 * CW);
    else
      for (int i = lane; i < 2 * CW; i += 32) wpt[warp * 2 * CW + i] = 0.f;
    fold(vp, wpt, wpm, V_Q, false, 0);
    clk(6);
  }

  // ---- split keys: each pass of the rank's keys: dq over them (a partial,
  // added over the passes in DQP), dk and dv over the queries (all here),
  // their projections' backward and AdaLNs ----------------------------------
  for (int p = 0; p < (split_q ? 0 : passes); ++p) {
    if (p) {
      k0 = l0 + p * RT;
      nk = max(0, min(RT, l1 - k0));
      __syncthreads();  // the last pass is done with Ks, Vs, DKt, DVt
      load_rows(Ks, a.k, (size_t)b * a.Nk + k0, nk);
      load_rows(Vs, a.v, (size_t)b * a.Nk + k0, nk);
      cp_async_commit();
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      clk(0);
    }
    const size_t krow0 = (size_t)b * a.Nk + k0;
    for (int it = warp; it < nq16 / 16 * H; it += NW) {
      const int qb = it / H * 16, h = it % H;
      float dq[D / 8][4];
      attn_dq<D>(dq, Qs, DOs, Ks, Vs, Ms, Ls, Ds, qb, h, nq, nk);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2* dst = reinterpret_cast<float2*>(
              dqp + (qb + g + 8 * hf) * CW + h * D + d * 8 + 2 * tq);
          float2 v = make_float2(dq[d][2 * hf], dq[d][2 * hf + 1]);
          if (p) {
            v.x += dst->x;
            v.y += dst->y;
          }
          *dst = v;
        }
    }
    clk(4);
    for (int it = warp; it < (nk + 15) / 16 * H; it += NW) {
      const int kb = it / H * 16, h = it % H;
      float dk[D / 8][4], dv[D / 8][4];
      attn_dkdv<D>(dk, dv, Qs, DOs, Ks, Vs, Ms, Ls, Ds, kb, h, nq, nk);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = kb + g + 8 * hf, c = h * D + d * 8 + 2 * tq;
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
    __syncthreads();
    clk(5);
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
      fold(vp, wpt, wpm, t ? V_V : V_K, false, 0);
    }
    clk(6);
  }

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
        fold(vp, wpt, wpm, t ? V_V : V_K, false, 0);
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
      fold(vp, wpt, wpm, V_Q, false, 0);
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
  clk.write(a.stamps);
}

constexpr int WG = 64;  // the weight launch's output tiles, WG x WG

// Tiles of the six products for hid.
__host__ __device__ constexpr int wgrad_tiles(int hid) {
  return 4 + 2 * (hid / WG);
}

// Floats of the tile program's dk | dv sums over a rank's passes: split
// queries over more than RT rows a rank (else 0).
inline long long ca_bwd_acc_floats(int clips, int Nq, int Nk) {
  return Nq >= Nk && rank_rows(Nq) > RT
             ? (long long)clips * CL * ST * 2 * CW
             : 0;
}

}  // namespace cab

// The backward's tile program, a cluster of 4 CTAs a clip. ptrs: xq, xk,
// xv, g (dL/d out), gq, gk, gv, g2 (gammas [clips, 64]), m1, m2, wq, wk,
// wv, wproj, w1, w2 (bf16 [in, out]), the saved q, k, v, o, stat_m, stat_l,
// x1, hh, a, mo (a, mo null without mask gradients); dxq, dxk, dxv; the
// operands m2g, dhh, da, dq, dk, dv; dgb [8, clips, 64] (dgq, dbq, dgk,
// dbk, dgv, dbv, dg2, db2); dm1, dm2 (null without mask gradients); the
// weight launch's counters (zeroed here); stamps (null, or [clips * 4, 8]
// int64 for the stamped instantiation); acc (cab::ca_bwd_acc_floats f32,
// the wrappers' ca_bwd_workspace; null where that is 0).
extern "C" int pmce_ca_bwd_tile(void* const* ptrs, int clips, int Nq, int Nk,
                                int hid, int H, float eps, void* stream) {
  using namespace cab;
  if (clips <= 0 || Nq <= 0 || Nk <= 0 || std::min(Nq, Nk) > ST ||
      hid <= 0 || hid % CW || hid > MAX_HID || (H != 2 && H != 4 && H != 8))
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
  a.acc = static_cast<float*>(ptrs[40]);
  a.ncounters = wgrad_tiles(hid);
  a.clips = clips; a.Nq = Nq; a.Nk = Nk; a.hid = hid;
  a.eps = eps;
  a.qscale = 1.0f / sqrtf(static_cast<float>(CW / H));
  if ((a.dm1 == nullptr) != (a.dm2 == nullptr) ||
      (a.dm1 && (a.a == nullptr || a.mo == nullptr)) ||
      (a.acc == nullptr && ca_bwd_acc_floats(clips, Nq, Nk) > 0))
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

// Clusters of the forward's (fwd != 0) or the backward's tile program the
// card holds at once (a clip each), or minus a CUDA error code.
extern "C" int pmce_ca_tile_clusters(int fwd) {
  return fwd ? tile::max_active_clusters(caf::ca_fwd_tile_kernel<false, 32>,
                                         caf::SMEM)
             : tile::max_active_clusters(cab::ca_bwd_tile_kernel<false, 32>,
                                         cab::SMEM);
}

PMCE_EXPORT_ERROR_STRING(pmce_ca_block_error_string)
