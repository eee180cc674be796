// The decoder's AdaLayerNorm self-attention block in f32, forward (row 8f)
// and backward (row 9f), for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_ada_block_kernel` (entry
// `fused_ada_block`) and `_ada_block_bwd_kernel` (via
// `_fused_ada_block_bwd`, its custom VJP) on their f32 branches (JAX's
// compute dtype f32; the kernels work in x's dtype): the vertex stream's
//
//   x1 = x + m1 MHSA(AdaLN(x; g1, b1));  y = x1 + m2 MLP(AdaLN(x1; g2, b2))
//
// with per-clip AdaLN vectors (unbiased sigma, eps outside the sqrt),
// per-clip branch scales m1, m2 (stochastic depth; null: 1), C = 64, heads
// of 8, 16 or 32 with a max-stabilised softmax over every token of the
// clip, q scaled by 1/sqrt(head width) before the scores, and an erf-GELU
// MLP of up to 256 hidden units. Its path is f32 Stage-2 training:
// [32, 431, 64] in 2 heads of 32.
//
// Products: every row product and the attention in 3xTF32 on the tensor
// cores (csrc/dec_tc32.cuh), the backward's weight gradients too
// (f32_ops.cuh). Both differ from the plain version only in the order of
// their sums and the tensor cores' products (<= 7.5e-7 of the
// output, <= 1.1e-6 of the gradients in the CPU model).
//
// Forward (pmce_ada_fwd_f32), three launches, persistent grids of min(items,
// ctas) CTAs over tiles of 128 rows of a clip (4 a clip at 431 rows: 128
// CTAs, one wave on 132 SMs; the wrappers' f32_dec_fwd_plan):
// 1. rows: AdaLN1 and qkv = h1 Wqkv + bqkv (q scaled) into the workspace;
// 2. the attention: the tile's queries over the clip's keys, streamed in
//    64-row chunks (a clip's x, K and V, ~331 KB at 431 rows, never sit on
//    one SM), an online softmax: o into the workspace;
// 3. the tail: proj, x1, AdaLN2, MLP, y.
// It saves nothing for the gradient: the backward recomputes the forward
// from x, as JAX's `_ada_block_bwd_kernel` does ("recompute in VMEM").
//
// Backward (pmce_ada_bwd_f32), ten launches, no atomics (a rerun gives the
// same bits); the programs are persistent grids as the forward's
// (csrc/dec_tc32.cuh):
// 1. the four weights transposed (f32_ops.cuh);
// 2. rows: the forward's first launch, keeping h1 and qkv;
// 3. the attention recomputed: o, the softmax's max and sum;
// 4. the tail and the gradient chain down to the attention: h2, hh,
//    gelu(hh), m2g, dhh, dx1, da, dO, D;
// 5. dq over the clip's keys;
// 6. dk and dv of the tile's keys over the clip's queries (P and dS
//    recomputed from the saved max, sum and D);
// 7. dh1 = dqkv Wqkv^T, dx = dx1 + AdaLN1^T(dh1);
// 8-9. the weight gradients dW = A^T dY (f32_ops.cuh, fixed-order partial
//    sums, 3xTF32);
// 10. the programs' per-tile partials summed in order: the bias gradients
//    and per clip dgamma1, dbeta1, dgamma2, dbeta2, and dm1, dm2 when owed.
// Registers and shared memory: csrc/dec_tc32.cuh, PERF.md section 3.

#include "common.cuh"
#include "f32_ops.cuh"
#include "dec_tc32.cuh"

namespace ada32 {

namespace dtc = f32ops::dtc;
using dtc::C;

struct Args {
  const float *x, *g1, *b1, *g2, *b2, *m1, *m2;
  const float *wqkv, *bqkv, *wproj, *bproj, *w1, *bb1, *w2, *bb2;
  int clips, N, hid;
  float eps, qscale;
};

// The finishing program's partial row: dbqkv [3C], dgamma1, dbeta1.
constexpr int FLEN = 5 * C;

bool shape_ok(int clips, int N, int hid, int heads) {
  return clips > 0 && N > 0 && hid > 0 && hid % C == 0 && hid <= 256 &&
         (heads == 2 || heads == 4 || heads == 8);
}

// The rows program's arguments: h1 = AdaLN1(x) (kept where h1 is not null),
// qkv = h1 Wqkv + bqkv, q scaled.
dtc::RArgs rows_args(const Args& a, float* qkv, float* h1) {
  dtc::RArgs r = {};
  r.clips = a.clips; r.N = a.N; r.tiles = dtc::cdiv(a.N, dtc::TRT);
  r.nsides = 1; r.eps = a.eps; r.scale0 = a.qscale;
  r.side[0] = {a.x, a.g1, a.b1, h1, a.wqkv, a.bqkv, qkv, 3};
  return r;
}

// The query side's arguments common to the forward and the backward.
dtc::QArgs query_args(const Args& a, const float* qkv) {
  dtc::QArgs q = {};
  q.clips = a.clips; q.Nq = a.N; q.Nk = a.N; q.hid = a.hid; q.S = 1;
  q.tiles = dtc::cdiv(a.N, dtc::TRT); q.eps = a.eps; q.qscale = a.qscale;
  q.x = a.x; q.qin = qkv; q.ldqin = 3 * C;
  q.k = qkv + C; q.v = qkv + 2 * C; q.ldkv = 3 * C;
  q.g2 = a.g2; q.b2 = a.b2; q.m1 = a.m1; q.m2 = a.m2;
  q.wproj = a.wproj; q.bproj = a.bproj; q.w1 = a.w1; q.bb1 = a.bb1;
  q.w2 = a.w2; q.bb2 = a.bb2;
  return q;
}

// The backward's workspace, carved from one f32 buffer (null: only count).
struct Ws {
  float *wqkvT, *wprojT, *w1T, *w2T, *h1, *qkv, *o, *h2, *hh, *ge, *m2g,
      *dhh, *da, *dO, *Ms, *Ls, *Ds, *dqkv, *qpart, *fpart, *wpart;
  int qtiles, ftiles;
  size_t floats;
};

Ws carve(float* base, int clips, int N, int hid, int heads, int splits) {
  const size_t M = (size_t)clips * N;
  const size_t wtiles = (size_t)(3 * C * C + C * C + 2 * C * hid) / 4096;
  Ws w;
  w.qtiles = dtc::cdiv(N, dtc::TRT);
  w.ftiles = dtc::cdiv(N, dtc::RB * dtc::f_warps(N));
  size_t at = 0;
  auto take = [&](size_t n) {
    float* q = base != nullptr ? base + at : nullptr;
    at += (n + 3) / 4 * 4;  // 16-byte aligned pieces
    return q;
  };
  w.wqkvT = take(3 * C * C); w.wprojT = take(C * C);
  w.w1T = take((size_t)hid * C); w.w2T = take((size_t)C * hid);
  w.h1 = take(M * C); w.qkv = take(M * 3 * C); w.o = take(M * C);
  w.h2 = take(M * C); w.hh = take(M * hid); w.ge = take(M * hid);
  w.m2g = take(M * C); w.dhh = take(M * hid); w.da = take(M * C);
  w.dO = take(M * C); w.Ms = take(M * heads); w.Ls = take(M * heads);
  w.Ds = take(M * heads); w.dqkv = take(M * 3 * C);
  w.qpart = take((size_t)clips * w.qtiles * dtc::qpart_len(hid));
  w.fpart = take((size_t)clips * w.ftiles * FLEN);
  w.wpart = take((size_t)splits * wtiles * 4096);
  w.floats = at;
  return w;
}

void fill(Args& a, void* const* ptrs, int clips, int N, int hid, float eps,
          float qscale) {
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  a = Args{};
  a.x = cf(0); a.g1 = cf(1); a.b1 = cf(2); a.g2 = cf(3); a.b2 = cf(4);
  a.m1 = cf(5); a.m2 = cf(6);
  a.wqkv = cf(7); a.bqkv = cf(8); a.wproj = cf(9); a.bproj = cf(10);
  a.w1 = cf(11); a.bb1 = cf(12); a.w2 = cf(13); a.bb2 = cf(14);
  a.clips = clips; a.N = N; a.hid = hid; a.eps = eps; a.qscale = qscale;
}

}  // namespace ada32

// Host entry points.

// Floats of the backward's workspace (pmce_ada_bwd_f32's pointer 16).
extern "C" long long pmce_ada_f32_workspace(int clips, int N, int hid,
                                            int heads, int splits) {
  return static_cast<long long>(
      ada32::carve(nullptr, clips, N, hid, heads, splits).floats);
}

// The f32 forward over [clips, N, 64] tokens. ptrs: 0 x, 1-4 g1, b1, g2, b2
// ([clips, 64] each), 5-6 m1, m2 ([clips]; both null without masks), 7
// wqkv [64, 192], 8 bqkv, 9 wproj [64, 64], 10 bproj, 11 w1 [64, hid], 12
// bb1, 13 w2 [hid, 64], 14 bb2 (f32, [in, out] as the parameters are), 15
// out, 16 the workspace [clips * N, 256] (q, k, v, o). ctas: the most CTAs
// a program launches (the card's co-resident CTAs, one an SM).
extern "C" int pmce_ada_fwd_f32(void* const* ptrs, int clips, int N, int hid,
                                int heads, float eps, float qscale, int ctas,
                                void* stream) {
  using namespace ada32;
  if (!shape_ok(clips, N, hid, heads) || ctas <= 0 ||
      (ptrs[5] == nullptr) != (ptrs[6] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  fill(a, ptrs, clips, N, hid, eps, qscale);
  float* qkv = static_cast<float*>(ptrs[16]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtc::launch_rows(rows_args(a, qkv, nullptr), ctas, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  dtc::QArgs q = query_args(a, qkv);
  q.o = qkv + (size_t)clips * N * 3 * C;
  q.out = static_cast<float*>(ptrs[15]);
  return static_cast<int>(dtc::launch_fwd<false>(q, heads, ctas, st));
}

// The f32 backward: dx, the per-clip sums, the four weight gradients and
// the bias gradients, in ten launches (see the header). ptrs: 0-14 as the
// forward's, 15 gout (the output's gradient), 16 the workspace
// (pmce_ada_f32_workspace floats), 17 dx, 18 the per-clip sums [clips, 258]
// (dg1, db1, dg2, db2 [64] each, dm1, dm2), 19 dwqkv, 20 dwproj, 21 dw1, 22
// dw2, 23 the bias gradients [5 * 64 + hid] (dbqkv, dbproj, dbb1, dbb2).
// dm: the mask gradients are owed (masks given). ctas: the most CTAs a
// program launches (the card's co-resident CTAs, one an SM).
extern "C" int pmce_ada_bwd_f32(void* const* ptrs, int clips, int N, int hid,
                                int heads, float eps, float qscale,
                                int splits, int dm, int ctas, void* stream) {
  using namespace ada32;
  if (!shape_ok(clips, N, hid, heads) || splits <= 0 || ctas <= 0 ||
      (ptrs[5] == nullptr) != (ptrs[6] == nullptr) ||
      (dm && ptrs[5] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  Args a;
  fill(a, ptrs, clips, N, hid, eps, qscale);
  const Ws w = carve(f(16), clips, N, hid, heads, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  f32ops::Transposes T;
  const float* src[4] = {a.wqkv, a.wproj, a.w1, a.w2};
  float* dst[4] = {w.wqkvT, w.wprojT, w.w1T, w.w2T};
  const int rows[4] = {C, C, C, hid}, cols[4] = {3 * C, C, hid, C};
  for (int i = 0; i < 4; ++i) {
    T.in[i] = src[i];
    T.out[i] = dst[i];
    T.rows[i] = rows[i];
    T.cols[i] = cols[i];
  }
  T.n = 4;
  cudaError_t e = f32ops::launch_transposes(T, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = dtc::launch_rows(rows_args(a, w.qkv, w.h1), ctas, st)) !=
      cudaSuccess)
    return static_cast<int>(e);

  dtc::QArgs q = query_args(a, w.qkv);
  q.wprojT = w.wprojT; q.w1T = w.w1T; q.w2T = w.w2T; q.gout = f(15);
  q.o = w.o; q.hh = w.hh; q.h2 = w.h2; q.ge = w.ge; q.m2g = w.m2g;
  q.dhh = w.dhh; q.da = w.da; q.dO = w.dO; q.dx1 = f(17);
  q.Ms = w.Ms; q.Ls = w.Ls; q.Ds = w.Ds;
  q.dq = w.dqkv; q.lddq = 3 * C;
  q.part = w.qpart; q.dm = dm != 0;
  if ((e = dtc::launch_q<false>(q, heads, ctas, st)) != cudaSuccess)
    return static_cast<int>(e);

  dtc::KArgs k = {};
  k.clips = clips; k.Nq = N; k.Nk = N; k.S = 1; k.tiles = w.qtiles;
  k.heads = heads;
  k.k = w.qkv + C; k.v = w.qkv + 2 * C; k.ldkv = 3 * C;
  k.q = w.qkv; k.ldq = 3 * C;
  k.dO = w.dO; k.Ms = w.Ms; k.Ls = w.Ls; k.Ds = w.Ds;
  k.dk = w.dqkv + C; k.dv = w.dqkv + 2 * C; k.ldd = 3 * C;
  if ((e = dtc::launch_k(k, ctas, st)) != cudaSuccess)
    return static_cast<int>(e);

  dtc::FArgs fa = {};
  fa.clips = clips; fa.N = N; fa.S = 1; fa.nsides = 1; fa.plen = FLEN;
  fa.eps = eps; fa.part = w.fpart;
  dtc::FSide& sd = fa.side[0];
  sd.G = w.dqkv; sd.ldG = 3 * C; sd.parts = 3; sd.WT = w.wqkvT;
  sd.x = a.x; sd.g = a.g1; sd.add = f(17); sd.dx = f(17);
  sd.boff = 0; sd.coff = 3 * C;
  if ((e = dtc::launch_f(fa, ctas, st)) != cudaSuccess)
    return static_cast<int>(e);

  f32ops::Jobs J;
  J.job[0] = {w.h1, w.dqkv, f(19), C, 3 * C};
  J.job[1] = {w.o, w.da, f(20), C, C};
  J.job[2] = {w.h2, w.dhh, f(21), C, hid};
  J.job[3] = {w.ge, w.m2g, f(22), hid, C};
  J.n = 4;
  J.M = clips * N;
  J.splits = splits;
  J.ws = w.wpart;
  J.vpart = nullptr;
  J.vout = nullptr;
  J.vtiles = 0;
  J.vlen = 0;
  if ((e = f32ops::launch_wgrad(J, st)) != cudaSuccess)
    return static_cast<int>(e);

  const int qlen = dtc::qpart_len(hid);
  dtc::Sums S;
  S.n = 4;
  S.job[0] = {w.qpart, qlen, 0, 2 * C + hid, w.qtiles, clips, false,
              f(23) + 3 * C, 0};
  S.job[1] = {w.qpart, qlen, 2 * C + hid, 2 * C + 2, w.qtiles, clips, true,
              f(18) + 2 * C, 4 * C + 2};
  S.job[2] = {w.fpart, FLEN, 0, 3 * C, w.ftiles, clips, false, f(23), 0};
  S.job[3] = {w.fpart, FLEN, 3 * C, 2 * C, w.ftiles, clips, true, f(18),
              4 * C + 2};
  return static_cast<int>(dtc::launch_sums(S, st));
}

PMCE_EXPORT_ERROR_STRING(pmce_ada_f32_error_string)
