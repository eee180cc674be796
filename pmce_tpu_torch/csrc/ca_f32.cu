// The decoder's AdaLayerNorm cross-attention block in f32, forward (row
// 10f) and backward (row 11f), for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_ca_block_kernel` (entry
// `fused_ca_block`) and `_ca_block_bwd_kernel` (via `_fused_ca_block_bwd`,
// its custom VJP) on their f32 branches (JAX's compute dtype f32): both
// streams' cross-attention + FFN,
//
//   q = AdaLN(xq; gq, bq') Wq + bq,  k = AdaLN(xk; gk, bk') Wk + bk,
//   v = AdaLN(xv; gv, bv') Wv + bv,
//   x1 = xq + m1 (softmax(q k^T / sqrt(dh)) v Wproj + bproj),
//   y = x1 + m2 MLP(AdaLN(x1; g2, b2))
//
// with per-clip AdaLN vectors (unbiased sigma, eps outside the sqrt),
// per-clip branch scales m1, m2 (null: 1), C = 64, heads of 8, 16 or 32
// and an erf-GELU MLP of up to 256 hidden units. Its path is f32 Stage-2
// training in both orientations: joints [32, 17, 64] over vertices [32,
// 431, 64] in 8 heads of 8, and vertices over joints in 2 heads of 32
// (1723 vertices on the two-level mesh: the long side of any length, the
// short side up to 64 rows).
//
// Products: every row product and the attention in 3xTF32 on the tensor
// cores (csrc/dec_tc32.cuh), the backward's weight gradients too
// (f32_ops.cuh).
//
// Forward (pmce_ca_fwd_f32), three launches on the persistent grids of the
// wrappers' f32_dec_fwd_plan (min(items, ctas) CTAs):
// 1. key rows: k and v (AdaLN, product) into the workspace, tiles of 128
//    rows of a clip's keys;
// 2. the attention: AdaLN_q and q (scaled), the tile's queries over the
//    clip's keys streamed in 64-row chunks, an online softmax: o into the
//    workspace. A long query side (431 vertices) is cut into tiles of 128
//    rows (4 a clip: 128 CTAs at 32 clips); the short one (17 joints: one
//    tile, 32 CTAs on 132 SMs) is split over the long side's chunks as the
//    backward's (below), each split's partial o, max and sum kept;
// 3. the tail (a CTA a tile of the query side; split: the partials merged
//    in order of s first): proj, x1, AdaLN2, MLP, y.
// It saves nothing for the gradient: the backward recomputes the forward
// from xq, xk and xv, as JAX's `_ca_block_bwd_kernel` does.
//
// Backward (pmce_ca_bwd_f32), no atomics (a rerun gives the same bits).
// Its programs are persistent grids of min(items, ctas) CTAs. A long side
// (431 vertices) is cut into tiles of 128 rows (4 a clip: 128 CTAs at 32
// clips). The short side (17 joints: one tile) would be one CTA a clip, 32
// CTAs on 132 SMs, so its program is split over the long side instead:
// `splits` CTAs a clip (min(ctas / clips, the long side's 64-row chunks):
// 4 on 132 SMs), split s taking the chunks [n s / S, n (s + 1) / S), its
// partials merged in order of s.
// 1. the six weights transposed (f32_ops.cuh, two launches);
// 2. key rows: the forward's first launch, keeping nk, nv;
// 3. the query side's three programs (dec_tc32.cuh): AdaLN_q and q (nq,
//    q kept) and the attention recomputed; the tail and the gradient chain
//    down to the attention (dx1, da, dO, D); dq over the clip's keys.
//    Split (joints over vertices): the splits' attention partials (o, the
//    softmax's max and sum); each split merges them in order and runs the
//    tail (its own copy; split 0's kept); each its keys' dq partial;
// 4. the key program: dk and dv over the clip's queries (split, vertices
//    over joints: each split its queries' partials);
// 5. the finishing program a side: the split partials merged in order (dq;
//    dk, dv), dnq = dq Wq^T, dxq = dx1 + AdaLN_q^T(dnq); dxk = AdaLN_k^T(dk
//    Wk^T), dxv = AdaLN_v^T(dv Wv^T);
// 6. the weight gradients (f32_ops.cuh, 3xTF32), one launch pair a side: Wq,
//    Wproj, W1, W2 over the query rows, Wk, Wv over the key rows;
// 7. the programs' partials summed in order: the bias gradients, and per
//    clip the eight AdaLN vectors' gradients and dm1, dm2 when owed.
// Registers and shared memory: csrc/dec_tc32.cuh, PERF.md section 3.

#include "common.cuh"
#include "f32_ops.cuh"
#include "dec_tc32.cuh"

namespace ca32 {

namespace dtc = f32ops::dtc;
using dtc::C;

struct Args {
  const float *xq, *xk, *xv;
  const float *gq, *bq_, *gk, *bk_, *gv, *bv_, *g2, *b2, *m1, *m2;
  const float *wq, *bq, *wk, *bk, *wv, *bv, *wproj, *bproj, *w1, *bb1, *w2,
      *bb2;
  int clips, Nq, Nk, hid;
  float eps, qscale;
};

// The finishing programs' partial rows: the query side's dbq, dgq, dbq';
// the key side's dbk, dbv, dgk, dbk', dgv, dbv'.
constexpr int FQLEN = 3 * C;
constexpr int FKLEN = 6 * C;

bool shape_ok(int clips, int Nq, int Nk, int hid, int heads) {
  return clips > 0 && Nq > 0 && Nk > 0 && hid > 0 && hid % C == 0 &&
         hid <= 256 && (heads == 2 || heads == 4 || heads == 8);
}

// The rows program's arguments over the keys: k = AdaLN_k(xk) Wk + bk, v =
// AdaLN_v(xv) Wv + bv; nk, nv kept where not null.
dtc::RArgs key_rows(const Args& a, float* k, float* v, float* nk,
                    float* nv) {
  dtc::RArgs r = {};
  r.clips = a.clips; r.N = a.Nk; r.tiles = dtc::cdiv(a.Nk, dtc::TRT);
  r.nsides = 2; r.eps = a.eps; r.scale0 = 1.f;
  r.side[0] = {a.xk, a.gk, a.bk_, nk, a.wk, a.bk, k, 1};
  r.side[1] = {a.xv, a.gv, a.bv_, nv, a.wv, a.bv, v, 1};
  return r;
}

// The backward's grids (the wrappers' f32_dec_plan): the splits of each
// side's program (1: tiles of 128 rows) and the tiles of each program.
struct Plan {
  int Sq, Sk, qtiles, ktiles, qper, fqtiles, fktiles;
};

// The query side's arguments common to the forward and the backward: q
// computed from xq in the attention; k, v [clips * Nk, 64].
dtc::QArgs query_args(const Args& a, int S, const float* k, const float* v) {
  dtc::QArgs q = {};
  q.clips = a.clips; q.Nq = a.Nq; q.Nk = a.Nk; q.hid = a.hid; q.S = S;
  q.tiles = dtc::cdiv(a.Nq, dtc::TRT); q.eps = a.eps; q.qscale = a.qscale;
  q.x = a.xq; q.gq = a.gq; q.bqa = a.bq_; q.wq = a.wq; q.bq = a.bq;
  q.k = k; q.v = v; q.ldkv = C;
  q.g2 = a.g2; q.b2 = a.b2; q.m1 = a.m1; q.m2 = a.m2;
  q.wproj = a.wproj; q.bproj = a.bproj; q.w1 = a.w1; q.bb1 = a.bb1;
  q.w2 = a.w2; q.bb2 = a.bb2;
  return q;
}

Plan plan(int clips, int Nq, int Nk, int ctas) {
  auto splits = [&](int shortN, int longN) {
    if (shortN >= longN || shortN > dtc::TRT) return 1;
    const int s = ctas / clips, n = dtc::cdiv(longN, dtc::KC);
    return s < 1 ? 1 : s > n ? n : s;
  };
  Plan p;
  p.Sq = splits(Nq, Nk);
  p.Sk = splits(Nk, Nq);
  p.qtiles = dtc::cdiv(Nq, dtc::TRT);
  p.ktiles = dtc::cdiv(Nk, dtc::TRT);
  p.qper = p.Sq > 1 ? p.Sq : p.qtiles;
  p.fqtiles = dtc::cdiv(Nq, dtc::RB * dtc::f_warps(Nq));
  p.fktiles = dtc::cdiv(Nk, dtc::RB * dtc::f_warps(Nk));
  return p;
}

struct Ws {
  float *wqT, *wkT, *wvT, *wprojT, *w1T, *w2T, *nq, *q, *o, *h2, *hh, *ge,
      *m2g, *dhh, *da, *dO, *Ms, *Ls, *Ds, *dq, *k, *v, *nk, *nv, *dk, *dv,
      *opart, *mpart, *lpart, *gq, *gk, *gv, *qpart, *fqpart, *fkpart,
      *wpart;
  size_t floats;
};

Ws carve(float* base, int clips, int Nq, int Nk, int hid, int heads,
         int splits, const Plan& pl) {
  const size_t Mq = (size_t)clips * Nq, Mk = (size_t)clips * Nk;
  const size_t wtiles = (size_t)(2 * C * C + 2 * C * hid) / 4096;
  const size_t Sq = pl.Sq, Sk = pl.Sk;
  const size_t sq = Sq > 1 ? Sq : 0, sk = Sk > 1 ? Sk : 0;
  Ws w;
  size_t at = 0;
  auto take = [&](size_t n) {
    float* p = base != nullptr ? base + at : nullptr;
    at += (n + 3) / 4 * 4;
    return p;
  };
  w.wqT = take(C * C); w.wkT = take(C * C); w.wvT = take(C * C);
  w.wprojT = take(C * C); w.w1T = take((size_t)hid * C);
  w.w2T = take((size_t)C * hid);
  w.nq = take(Mq * C); w.q = take(Mq * C); w.o = take(Sq * Mq * C);
  w.h2 = take(Mq * C); w.hh = take(Sq * Mq * hid); w.ge = take(Mq * hid);
  w.m2g = take(Mq * C); w.dhh = take(Mq * hid); w.da = take(Mq * C);
  w.dO = take(Mq * C); w.Ms = take(Mq * heads); w.Ls = take(Mq * heads);
  w.Ds = take(Mq * heads); w.dq = take(Mq * C);
  w.k = take(Mk * C); w.v = take(Mk * C); w.nk = take(Mk * C);
  w.nv = take(Mk * C); w.dk = take(Mk * C); w.dv = take(Mk * C);
  w.opart = take(sq * Mq * C); w.mpart = take(sq * Mq * heads);
  w.lpart = take(sq * Mq * heads); w.gq = take(sq * Mq * C);
  w.gk = take(sk * Mk * C); w.gv = take(sk * Mk * C);
  w.qpart = take((size_t)clips * pl.qper * dtc::qpart_len(hid));
  w.fqpart = take((size_t)clips * pl.fqtiles * FQLEN);
  w.fkpart = take((size_t)clips * pl.fktiles * FKLEN);
  w.wpart = take((size_t)splits * wtiles * 4096);
  w.floats = at;
  return w;
}

void fill(Args& a, void* const* ptrs, int clips, int Nq, int Nk, int hid,
          float eps, float qscale) {
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  a = Args{};
  a.xq = cf(0); a.xk = cf(1); a.xv = cf(2);
  a.gq = cf(3); a.bq_ = cf(4); a.gk = cf(5); a.bk_ = cf(6);
  a.gv = cf(7); a.bv_ = cf(8); a.g2 = cf(9); a.b2 = cf(10);
  a.m1 = cf(11); a.m2 = cf(12);
  a.wq = cf(13); a.bq = cf(14); a.wk = cf(15); a.bk = cf(16);
  a.wv = cf(17); a.bv = cf(18); a.wproj = cf(19); a.bproj = cf(20);
  a.w1 = cf(21); a.bb1 = cf(22); a.w2 = cf(23); a.bb2 = cf(24);
  a.clips = clips; a.Nq = Nq; a.Nk = Nk; a.hid = hid;
  a.eps = eps; a.qscale = qscale;
}

}  // namespace ca32

// Host entry points.

// Floats of the backward's workspace (pmce_ca_bwd_f32's pointer 26).
extern "C" long long pmce_ca_f32_workspace(int clips, int Nq, int Nk,
                                           int hid, int heads, int splits,
                                           int ctas) {
  const ca32::Plan pl = ca32::plan(clips, Nq, Nk, ctas);
  return static_cast<long long>(
      ca32::carve(nullptr, clips, Nq, Nk, hid, heads, splits, pl).floats);
}

// The f32 forward: [clips, Nq, 64] queries over [clips, Nk, 64] keys and
// values. ptrs: 0-2 xq, xk, xv, 3-10 the AdaLN vectors gq, bq', gk, bk',
// gv, bv', g2, b2 ([clips, 64] each), 11-12 m1, m2 ([clips]; both null
// without masks), 13-24 wq, bq, wk, bk, wv, bv, wproj, bproj ([64, 64]
// matrices), w1 [64, hid], bb1, w2 [hid, 64], bb2 (f32, [in, out] as the
// parameters are), 25 out, 26 the workspace: k, v [2, clips * Nk, 64], o
// [S, clips * Nq, 64], the attention's max and sum [2, S, clips * Nq,
// heads] (S: the query side's splits, 1 unsplit: 2 * clips * Nk * 64 + S *
// clips * Nq * (64 + 2 * heads) floats). ctas: the most CTAs a program
// launches (the card's co-resident CTAs, one an SM); it also sets S.
extern "C" int pmce_ca_fwd_f32(void* const* ptrs, int clips, int Nq, int Nk,
                               int hid, int heads, float eps, float qscale,
                               int ctas, void* stream) {
  using namespace ca32;
  if (!shape_ok(clips, Nq, Nk, hid, heads) || ctas <= 0 ||
      (ptrs[11] == nullptr) != (ptrs[12] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  fill(a, ptrs, clips, Nq, Nk, hid, eps, qscale);
  const Plan pl = plan(clips, Nq, Nk, ctas);
  const size_t Mq = (size_t)clips * Nq, Mk = (size_t)clips * Nk;
  float* k = static_cast<float*>(ptrs[26]);
  float* v = k + Mk * C;
  float* o = v + Mk * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtc::launch_rows(key_rows(a, k, v, nullptr, nullptr), ctas, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  dtc::QArgs q = query_args(a, pl.Sq, k, v);
  if (pl.Sq > 1) {
    q.opart = o;
    q.mpart = o + pl.Sq * Mq * C;
    q.lpart = q.mpart + pl.Sq * Mq * heads;
  } else {
    q.o = o;
  }
  q.out = static_cast<float*>(ptrs[25]);
  return static_cast<int>(dtc::launch_fwd<true>(q, heads, ctas, st));
}

// The f32 backward (see the header). ptrs: 0-24 as the forward's, 25 gout
// (the output's gradient), 26 the workspace (pmce_ca_f32_workspace
// floats), 27-29 dxq, dxk, dxv, 30 the query side's per-clip sums [clips,
// 258] (dgq, dbq', dg2, db2 [64] each, dm1, dm2), 31 the key side's [clips,
// 256] (dgk, dbk', dgv, dbv'), 32-37 dwq, dwk, dwv, dwproj, dw1, dw2, 38
// the query side's bias gradients [3 * 64 + hid] (dbq, dbproj, dbb1, dbb2),
// 39 the key side's [128] (dbk, dbv). dm: the mask gradients are owed.
// ctas: the most CTAs a program launches (the card's co-resident CTAs, one
// an SM); it also sets the short side's splits.
extern "C" int pmce_ca_bwd_f32(void* const* ptrs, int clips, int Nq, int Nk,
                               int hid, int heads, float eps, float qscale,
                               int splits_q, int splits_k, int dm, int ctas,
                               void* stream) {
  using namespace ca32;
  if (!shape_ok(clips, Nq, Nk, hid, heads) || splits_q <= 0 ||
      splits_k <= 0 || ctas <= 0 ||
      (ptrs[11] == nullptr) != (ptrs[12] == nullptr) ||
      (dm && ptrs[11] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  Args a;
  fill(a, ptrs, clips, Nq, Nk, hid, eps, qscale);
  const Plan pl = plan(clips, Nq, Nk, ctas);
  const int splits = splits_q > splits_k ? splits_q : splits_k;
  const Ws w = carve(f(26), clips, Nq, Nk, hid, heads, splits, pl);
  const size_t Mq = (size_t)clips * Nq, Mk = (size_t)clips * Nk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const float* src[6] = {a.wq, a.wk, a.wv, a.wproj, a.w1, a.w2};
  float* dst[6] = {w.wqT, w.wkT, w.wvT, w.wprojT, w.w1T, w.w2T};
  const int rows[6] = {C, C, C, C, C, hid};
  const int cols[6] = {C, C, C, C, hid, C};
  cudaError_t e;
  for (int half = 0; half < 2; ++half) {
    f32ops::Transposes T;
    for (int i = 0; i < 3; ++i) {
      T.in[i] = src[3 * half + i];
      T.out[i] = dst[3 * half + i];
      T.rows[i] = rows[3 * half + i];
      T.cols[i] = cols[3 * half + i];
    }
    T.n = 3;
    if ((e = f32ops::launch_transposes(T, st)) != cudaSuccess)
      return static_cast<int>(e);
  }
  if ((e = dtc::launch_rows(key_rows(a, w.k, w.v, w.nk, w.nv), ctas, st)) !=
      cudaSuccess)
    return static_cast<int>(e);

  dtc::QArgs q = query_args(a, pl.Sq, w.k, w.v);
  q.qin = w.q; q.ldqin = C;
  q.nq = w.nq; q.qout = w.q;
  q.wprojT = w.wprojT; q.w1T = w.w1T; q.w2T = w.w2T; q.gout = f(25);
  q.o = w.o; q.hh = w.hh; q.h2 = w.h2; q.ge = w.ge; q.m2g = w.m2g;
  q.dhh = w.dhh; q.da = w.da; q.dO = w.dO; q.dx1 = f(27);
  q.Ms = w.Ms; q.Ls = w.Ls; q.Ds = w.Ds;
  q.dq = pl.Sq > 1 ? w.gq : w.dq; q.lddq = C; q.dq_split = Mq * C;
  q.opart = w.opart; q.mpart = w.mpart; q.lpart = w.lpart;
  q.part = w.qpart; q.dm = dm != 0;
  if ((e = dtc::launch_q<true>(q, heads, ctas, st)) != cudaSuccess)
    return static_cast<int>(e);

  dtc::KArgs k = {};
  k.clips = clips; k.Nq = Nq; k.Nk = Nk; k.S = pl.Sk; k.tiles = pl.ktiles;
  k.heads = heads;
  k.k = w.k; k.v = w.v; k.ldkv = C; k.q = w.q; k.ldq = C;
  k.dO = w.dO; k.Ms = w.Ms; k.Ls = w.Ls; k.Ds = w.Ds;
  k.dk = pl.Sk > 1 ? w.gk : w.dk; k.dv = pl.Sk > 1 ? w.gv : w.dv;
  k.ldd = C; k.split = Mk * C;
  if ((e = dtc::launch_k(k, ctas, st)) != cudaSuccess)
    return static_cast<int>(e);

  dtc::FArgs fq = {};
  fq.clips = clips; fq.N = Nq; fq.S = pl.Sq; fq.nsides = 1;
  fq.plen = FQLEN; fq.eps = eps; fq.part = w.fqpart;
  fq.side[0] = {w.dq, C, 1, w.gq, Mq * C, w.dq, w.wqT, a.xq, a.gq, f(27),
                f(27), 0, C};
  if ((e = dtc::launch_f(fq, ctas, st)) != cudaSuccess)
    return static_cast<int>(e);
  dtc::FArgs fk = {};
  fk.clips = clips; fk.N = Nk; fk.S = pl.Sk; fk.nsides = 2;
  fk.plen = FKLEN; fk.eps = eps; fk.part = w.fkpart;
  fk.side[0] = {w.dk, C, 1, w.gk, Mk * C, w.dk, w.wkT, a.xk, a.gk, nullptr,
                f(28), 0, 2 * C};
  fk.side[1] = {w.dv, C, 1, w.gv, Mk * C, w.dv, w.wvT, a.xv, a.gv, nullptr,
                f(29), C, 4 * C};
  if ((e = dtc::launch_f(fk, ctas, st)) != cudaSuccess)
    return static_cast<int>(e);

  f32ops::Jobs J;
  J.job[0] = {w.nq, w.dq, f(32), C, C};
  J.job[1] = {w.o, w.da, f(35), C, C};
  J.job[2] = {w.h2, w.dhh, f(36), C, hid};
  J.job[3] = {w.ge, w.m2g, f(37), hid, C};
  J.n = 4;
  J.M = clips * Nq;
  J.splits = splits_q;
  J.ws = w.wpart;
  J.vpart = nullptr;
  J.vout = nullptr;
  J.vtiles = 0;
  J.vlen = 0;
  if ((e = f32ops::launch_wgrad(J, st)) != cudaSuccess)
    return static_cast<int>(e);
  f32ops::Jobs K;
  K.job[0] = {w.nk, w.dk, f(33), C, C};
  K.job[1] = {w.nv, w.dv, f(34), C, C};
  K.n = 2;
  K.M = clips * Nk;
  K.splits = splits_k;
  K.ws = w.wpart;
  K.vpart = nullptr;
  K.vout = nullptr;
  K.vtiles = 0;
  K.vlen = 0;
  if ((e = f32ops::launch_wgrad(K, st)) != cudaSuccess)
    return static_cast<int>(e);

  const int qlen = dtc::qpart_len(hid);
  dtc::Sums S;
  S.n = 6;
  S.job[0] = {w.qpart, qlen, 0, 2 * C + hid, pl.qper, clips, false,
              f(38) + C, 0};
  S.job[1] = {w.qpart, qlen, 2 * C + hid, 2 * C + 2, pl.qper, clips, true,
              f(30) + 2 * C, 4 * C + 2};
  S.job[2] = {w.fqpart, FQLEN, 0, C, pl.fqtiles, clips, false, f(38), 0};
  S.job[3] = {w.fqpart, FQLEN, C, 2 * C, pl.fqtiles, clips, true, f(30),
              4 * C + 2};
  S.job[4] = {w.fkpart, FKLEN, 0, 2 * C, pl.fktiles, clips, false, f(39), 0};
  S.job[5] = {w.fkpart, FKLEN, 2 * C, 4 * C, pl.fktiles, clips, true, f(31),
              4 * C};
  return static_cast<int>(dtc::launch_sums(S, st));
}

PMCE_EXPORT_ERROR_STRING(pmce_ca_f32_error_string)
