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
// 431, 64] in 8 heads of 8, and vertices over joints in 2 heads of 32.
//
// Products in true f32 (FFMA on the CUDA cores, no TF32), as csrc/
// ada_f32.cu, whose plan this is (csrc/f32_ops.cuh, namespace dec): grids
// of chunks of 64 rows of one clip on each side (the query side's Nq rows,
// the key side's Nk), the other side's rows streamed from device memory in
// chunks of 64.
//
// Forward (pmce_ca_fwd_f32), two launches:
// - key chunks: k and v (AdaLN, product) into the workspace;
// - query chunks: AdaLN_q and q (scaled), the attention over the clip's
//   keys, the tail (proj, x1, AdaLN2, MLP, y).
// It saves nothing for the gradient: the backward recomputes the forward
// from xq, xk and xv, as JAX's `_ca_block_bwd_kernel` does.
//
// Backward (pmce_ca_bwd_f32), no atomics (a rerun gives the same bits):
// 1. the six weights transposed (f32_ops.cuh, two launches);
// 2. key chunks: the forward's first launch, keeping nk, nv;
// 3. query chunks: the forward's second, keeping nq, q, o, the softmax max
//    and sum, h2, hh, ge; the gradient chain down to the attention (dx1,
//    da, dO, D), dq over every key of the clip, then dnq = dq Wq^T and dxq
//    = dx1 + AdaLN_q^T(dnq);
// 4. key chunks: dk and dv over every query of the clip, then dxk =
//    AdaLN_k^T(dk Wk^T) and dxv = AdaLN_v^T(dv Wv^T);
// 5. the weight gradients (f32_ops.cuh), one launch pair a side: Wq,
//    Wproj, W1, W2 over the query rows, Wk, Wv over the key rows, with the
//    bias gradients from the chunks' partials;
// 6. the per-clip sums of the chunks' partials a side: the eight AdaLN
//    vectors' gradients, and dm1, dm2 when owed.

#include "common.cuh"
#include "f32_ops.cuh"

namespace ca32 {

using namespace f32ops::dec;

struct Args {
  const float *xq, *xk, *xv;
  const float *gq, *bq_, *gk, *bk_, *gv, *bv_, *g2, *b2, *m1, *m2;
  const float *wq, *bq, *wk, *bk, *wv, *bv, *wproj, *bproj, *w1, *bb1, *w2,
      *bb2;
  float *out, *k, *v, *nq, *nk, *nv, *q;
  int clips, Nq, Nk, hid;
  float eps, qscale;
  // The backward's.
  const float* gout;
  const float *wqT, *wkT, *wvT, *wprojT, *w1T, *w2T;
  float *o, *h2, *hh, *ge, *m2g, *dhh, *da, *dO, *Ms, *Ls, *Ds, *dq, *dk,
      *dv;
  float *bpart_q, *cpart_q, *bpart_k, *cpart_k, *dxq, *dxk, *dxv;
  bool dm;
};

// The query side's bias partials (dbq, dbproj, dbb1, dbb2) and clip
// partials (dgq, dbq', dg2, db2, dm1, dm2); the key side's (dbk, dbv) and
// (dgk, dbk', dgv, dbv').
__host__ __device__ constexpr int qbias_len(int hid) { return 3 * C + hid; }
constexpr int QCLIP_LEN = 4 * C + 2;
constexpr int KBIAS_LEN = 2 * C;
constexpr int KCLIP_LEN = 4 * C;

// Key chunks: k = AdaLN_k(xk) Wk + bk, v = AdaLN_v(xv) Wv + bv; nk, nv kept
// when p.nk is not null. A warp's rows need no CTA barrier.
__global__ void __launch_bounds__(NT) ca_keys_fwd_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int clip = blockIdx.y, r0 = blockIdx.x * TR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * RW;
  const int nv = max(0, min(RW, p.Nk - r0 - wr));
  if (nv == 0) return;
  const size_t g = (size_t)clip * p.Nk + r0 + wr;
  float* HS = reinterpret_cast<float*>(smem) + wr * C;
  for (int side = 0; side < 2; ++side) {
    const float* x = side == 0 ? p.xk : p.xv;
    const float* gm = side == 0 ? p.gk : p.gv;
    const float* bt = side == 0 ? p.bk_ : p.bv_;
    float* keep = side == 0 ? p.nk : p.nv;
    adaln_rows(x + g * C, C, nv, gm + clip * C, bt + clip * C, p.eps, HS,
               keep != nullptr ? keep + g * C : nullptr);
    __syncwarp();
    float acc[RW][2] = {};
    mac<2>(HS, C, nv, C, side == 0 ? p.wk : p.wv, C, 0, acc);
    const float* b = side == 0 ? p.bk : p.bv;
    float* out = side == 0 ? p.k : p.v;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (i >= nv) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        out[(g + i) * C + c] = acc[i][j] + b[c];
      }
    }
    __syncwarp();
  }
}

// Query chunks: q, the attention over the clip's keys and the tail; in the
// backward also the gradient chain down to dq, then dxq.
template <int H, bool BWD>
__global__ void __launch_bounds__(NT, 1) ca_query_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChunkSmem s = chunk_smem(smem);
  const int clip = blockIdx.y, r0 = blockIdx.x * TR;
  const int n = min(TR, p.Nq - r0);
  const int cta = clip * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * RW;
  const int nv = max(0, min(RW, n - wr));
  const size_t g0 = (size_t)clip * p.Nq + r0;
  const size_t k0 = (size_t)clip * p.Nk;
  load_rows(p.xq + g0 * C, C, n, s.R0);
  // nq = AdaLN_q(xq) in R2's rows (o's place), q = (nq Wq + bq) / sqrt(dh).
  {
    float* NS = s.R2 + wr * C;
    adaln_rows(p.xq + (g0 + wr) * C, C, nv, p.gq + clip * C,
               p.bq_ + clip * C, p.eps, NS,
               BWD ? p.nq + (g0 + wr) * C : nullptr);
    __syncwarp();
    float acc[RW][2] = {};
    if (nv > 0) mac<2>(NS, C, nv, C, p.wq, C, 0, acc);
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float q = i < nv ? (acc[i][j] + p.bq[c]) * p.qscale : 0.f;
        s.R1[(wr + i) * C + c] = q;
        if (BWD && i < nv) p.q[(g0 + wr + i) * C + c] = q;
      }
  }
  attn_fwd<H>(s.R1, p.k + k0 * C, C, p.v + k0 * C, C, p.Nk, n, s.R2, s.a);
  Tail t;
  t.g2 = p.g2 + clip * C;
  t.b2 = p.b2 + clip * C;
  t.m1 = clip_scale(p.m1, clip);
  t.m2 = clip_scale(p.m2, clip);
  t.wproj = p.wproj; t.bproj = p.bproj;
  t.w1 = p.w1; t.bb1 = p.bb1; t.w2 = p.w2; t.bb2 = p.bb2;
  t.hid = p.hid;
  t.eps = p.eps;
  float *bpart = nullptr, *cpart = nullptr;
  if constexpr (!BWD) {
    t.out = p.out + g0 * C;
  } else {
    save_attn<H>(s, n, p.o + g0 * C, p.Ms + g0 * H, p.Ls + g0 * H);
    bpart = p.bpart_q + (size_t)cta * qbias_len(p.hid);
    cpart = p.cpart_q + (size_t)cta * QCLIP_LEN;
    t.gout = p.gout + g0 * C;
    t.wprojT = p.wprojT; t.w1T = p.w1T; t.w2T = p.w2T;
    t.h2 = p.h2 + g0 * C;
    t.hh = p.hh + g0 * p.hid;
    t.ge = p.ge + g0 * p.hid;
    t.m2g = p.m2g + g0 * C;
    t.dhh = p.dhh + g0 * p.hid;
    t.da = p.da + g0 * C;
    t.dO = p.dO + g0 * C;
    t.dx1 = p.dxq + g0 * C;
    t.D = p.Ds + g0 * H;
    t.bpart = bpart + C;
    t.cpart = cpart + 2 * C;
    t.dm = p.dm;
  }
  tail_rows<H, BWD>(t, n, s);
  if constexpr (BWD) {
    attn_bwd_q<H>(s.R1, s.R3, p.k + k0 * C, C, p.v + k0 * C, C, p.Nk, n,
                  p.qscale, s.R0, s.a);
    // dq out; dnq = dq Wq^T; dxq = dx1 + AdaLN_q^T(dnq); the partials.
    const float* DQ = s.R0 + wr * C;
    float v0, v1;
    warp_colsum(DQ, nv, v0, v1);
    for (int i = 0; i < nv; ++i) {
      p.dq[(g0 + wr + i) * C + lane] = DQ[i * C + lane];
      p.dq[(g0 + wr + i) * C + lane + 32] = DQ[i * C + lane + 32];
    }
    float acc[RW][2] = {};
    if (nv > 0) mac<2>(DQ, C, nv, C, p.wqT, C, 0, acc);
    float pg[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
    float* dx = p.dxq + (g0 + wr) * C;
    adaln_bwd_rows(p.xq + (g0 + wr) * C, nv, acc, p.gq + clip * C, p.eps, dx,
                   dx, pg, pb);
    float* scr = s.a.P2;
    cta_colsum(v0, v1, scr, bpart);
    cta_colsum(pg[0], pg[1], scr, cpart);
    cta_colsum(pb[0], pb[1], scr, cpart + C);
  }
}

// Key chunks: dk, dv over every query of the clip, then dxk, dxv and the
// partials.
template <int H>
__global__ void __launch_bounds__(NT, 1) ca_keys_bwd_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChunkSmem s = chunk_smem(smem);
  const int clip = blockIdx.y, r0 = blockIdx.x * TR;
  const int n = min(TR, p.Nk - r0);
  const int cta = clip * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int wr = warp * RW;
  const int nv = max(0, min(RW, n - wr));
  const size_t g0 = (size_t)clip * p.Nk + r0;
  const size_t q0 = (size_t)clip * p.Nq;
  load_rows(p.k + g0 * C, C, n, s.R0);
  load_rows(p.v + g0 * C, C, n, s.R1);
  attn_bwd_kv<H>(s.R0, s.R1, n, p.q + q0 * C, C, p.dO + q0 * C,
                 p.Ms + q0 * H, p.Ls + q0 * H, p.Ds + q0 * H, p.Nq, s.R2,
                 s.R3, s.a);
  float* bpart = p.bpart_k + (size_t)cta * KBIAS_LEN;
  float* cpart = p.cpart_k + (size_t)cta * KCLIP_LEN;
  float* scr = s.a.P2;
  for (int side = 0; side < 2; ++side) {
    const float* G = (side == 0 ? s.R2 : s.R3) + wr * C;
    float* keep = (side == 0 ? p.dk : p.dv) + (g0 + wr) * C;
    float v0, v1;
    warp_colsum(G, nv, v0, v1);
    const int lane = threadIdx.x & 31;
    for (int i = 0; i < nv; ++i) {
      keep[i * C + lane] = G[i * C + lane];
      keep[i * C + lane + 32] = G[i * C + lane + 32];
    }
    float acc[RW][2] = {};
    if (nv > 0)
      mac<2>(G, C, nv, C, side == 0 ? p.wkT : p.wvT, C, 0, acc);
    float pg[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
    adaln_bwd_rows((side == 0 ? p.xk : p.xv) + (g0 + wr) * C, nv, acc,
                   (side == 0 ? p.gk : p.gv) + clip * C, p.eps, nullptr,
                   (side == 0 ? p.dxk : p.dxv) + (g0 + wr) * C, pg, pb);
    cta_colsum(v0, v1, scr, bpart + side * C);
    cta_colsum(pg[0], pg[1], scr, cpart + 2 * side * C);
    cta_colsum(pb[0], pb[1], scr, cpart + (2 * side + 1) * C);
  }
}

constexpr int ROWS_SMEM = TR * C * 4;

bool shape_ok(int clips, int Nq, int Nk, int hid, int heads) {
  return clips > 0 && Nq > 0 && Nk > 0 && hid > 0 && hid % HC == 0 &&
         (heads == 2 || heads == 4 || heads == 8);
}

struct Ws {
  float *wqT, *wkT, *wvT, *wprojT, *w1T, *w2T, *nq, *q, *o, *h2, *hh, *ge,
      *m2g, *dhh, *da, *dO, *Ms, *Ls, *Ds, *dq, *k, *v, *nk, *nv, *dk, *dv,
      *bpart_q, *cpart_q, *bpart_k, *cpart_k, *wpart;
  size_t floats;
};

Ws carve(float* base, int clips, int Nq, int Nk, int hid, int heads,
         int splits) {
  const size_t Mq = (size_t)clips * Nq, Mk = (size_t)clips * Nk;
  const int qctas = clips * ((Nq + TR - 1) / TR);
  const int kctas = clips * ((Nk + TR - 1) / TR);
  const size_t wtiles = (size_t)(2 * C * C + 2 * C * hid) / 4096;
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
  w.nq = take(Mq * C); w.q = take(Mq * C); w.o = take(Mq * C);
  w.h2 = take(Mq * C); w.hh = take(Mq * hid); w.ge = take(Mq * hid);
  w.m2g = take(Mq * C); w.dhh = take(Mq * hid); w.da = take(Mq * C);
  w.dO = take(Mq * C); w.Ms = take(Mq * heads); w.Ls = take(Mq * heads);
  w.Ds = take(Mq * heads); w.dq = take(Mq * C);
  w.k = take(Mk * C); w.v = take(Mk * C); w.nk = take(Mk * C);
  w.nv = take(Mk * C); w.dk = take(Mk * C); w.dv = take(Mk * C);
  w.bpart_q = take((size_t)qctas * qbias_len(hid));
  w.cpart_q = take((size_t)qctas * QCLIP_LEN);
  w.bpart_k = take((size_t)kctas * KBIAS_LEN);
  w.cpart_k = take((size_t)kctas * KCLIP_LEN);
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

template <bool BWD>
cudaError_t launch_queries(const Args& a, int heads, dim3 grid,
                           cudaStream_t st) {
  return launch_chunk(heads == 2   ? ca_query_kernel<2, BWD>
                      : heads == 4 ? ca_query_kernel<4, BWD>
                                   : ca_query_kernel<8, BWD>,
                      grid, a, st);
}

}  // namespace ca32

// Host entry points.

// Floats of the backward's workspace (pmce_ca_bwd_f32's pointer 26).
extern "C" long long pmce_ca_f32_workspace(int clips, int Nq, int Nk,
                                           int hid, int heads, int splits) {
  return static_cast<long long>(
      ca32::carve(nullptr, clips, Nq, Nk, hid, heads, splits).floats);
}

// Shared memory of the chunk programs (bytes).
extern "C" int pmce_ca_f32_smem_bytes() {
  return f32ops::dec::CHUNK_SMEM_FLOATS * 4;
}

// The f32 forward: [clips, Nq, 64] queries over [clips, Nk, 64] keys and
// values. ptrs: 0-2 xq, xk, xv, 3-10 the AdaLN vectors gq, bq', gk, bk',
// gv, bv', g2, b2 ([clips, 64] each), 11-12 m1, m2 ([clips]; both null
// without masks), 13-24 wq, bq, wk, bk, wv, bv, wproj, bproj ([64, 64]
// matrices), w1 [64, hid], bb1, w2 [hid, 64], bb2 (f32, [in, out] as the
// parameters are), 25 out, 26 scratch [2, clips * Nk, 64] (k, v).
extern "C" int pmce_ca_fwd_f32(void* const* ptrs, int clips, int Nq, int Nk,
                               int hid, int heads, float eps, float qscale,
                               void* stream) {
  using namespace ca32;
  if (!shape_ok(clips, Nq, Nk, hid, heads) ||
      (ptrs[11] == nullptr) != (ptrs[12] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  fill(a, ptrs, clips, Nq, Nk, hid, eps, qscale);
  a.out = static_cast<float*>(ptrs[25]);
  a.k = static_cast<float*>(ptrs[26]);
  a.v = a.k + (size_t)clips * Nk * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ca_keys_fwd_kernel<<<dim3((Nk + TR - 1) / TR, clips), NT, ROWS_SMEM, st>>>(
      a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_queries<false>(a, heads, dim3((Nq + TR - 1) / TR, clips), st));
}

// The f32 backward (see the header). ptrs: 0-24 as the forward's, 25 gout
// (the output's gradient), 26 the workspace (pmce_ca_f32_workspace
// floats), 27-29 dxq, dxk, dxv, 30 the query side's per-clip sums [clips,
// 258] (dgq, dbq', dg2, db2 [64] each, dm1, dm2), 31 the key side's [clips,
// 256] (dgk, dbk', dgv, dbv'), 32-37 dwq, dwk, dwv, dwproj, dw1, dw2, 38
// the query side's bias gradients [3 * 64 + hid] (dbq, dbproj, dbb1, dbb2),
// 39 the key side's [128] (dbk, dbv). dm: the mask gradients are owed.
extern "C" int pmce_ca_bwd_f32(void* const* ptrs, int clips, int Nq, int Nk,
                               int hid, int heads, float eps, float qscale,
                               int splits_q, int splits_k, int dm,
                               void* stream) {
  using namespace ca32;
  if (!shape_ok(clips, Nq, Nk, hid, heads) || splits_q <= 0 ||
      splits_k <= 0 || (ptrs[11] == nullptr) != (ptrs[12] == nullptr) ||
      (dm && ptrs[11] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  Args a;
  fill(a, ptrs, clips, Nq, Nk, hid, eps, qscale);
  const int splits = splits_q > splits_k ? splits_q : splits_k;
  const Ws w = carve(f(26), clips, Nq, Nk, hid, heads, splits);
  a.gout = f(25);
  a.wqT = w.wqT; a.wkT = w.wkT; a.wvT = w.wvT; a.wprojT = w.wprojT;
  a.w1T = w.w1T; a.w2T = w.w2T;
  a.nq = w.nq; a.q = w.q; a.o = w.o; a.h2 = w.h2; a.hh = w.hh; a.ge = w.ge;
  a.m2g = w.m2g; a.dhh = w.dhh; a.da = w.da; a.dO = w.dO; a.Ms = w.Ms;
  a.Ls = w.Ls; a.Ds = w.Ds; a.dq = w.dq; a.k = w.k; a.v = w.v; a.nk = w.nk;
  a.nv = w.nv; a.dk = w.dk; a.dv = w.dv;
  a.bpart_q = w.bpart_q; a.cpart_q = w.cpart_q;
  a.bpart_k = w.bpart_k; a.cpart_k = w.cpart_k;
  a.dxq = f(27); a.dxk = f(28); a.dxv = f(29);
  a.dm = dm != 0;
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

  const int qchunks = (Nq + TR - 1) / TR, kchunks = (Nk + TR - 1) / TR;
  const dim3 qgrid(qchunks, clips), kgrid(kchunks, clips);
  ca_keys_fwd_kernel<<<kgrid, NT, ROWS_SMEM, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = launch_queries<true>(a, heads, qgrid, st)) != cudaSuccess)
    return static_cast<int>(e);
  e = launch_chunk(heads == 2   ? ca_keys_bwd_kernel<2>
                   : heads == 4 ? ca_keys_bwd_kernel<4>
                                : ca_keys_bwd_kernel<8>,
                   kgrid, a, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  f32ops::Jobs J;
  J.job[0] = {w.nq, w.dq, f(32), C, C};
  J.job[1] = {w.o, w.da, f(35), C, C};
  J.job[2] = {w.h2, w.dhh, f(36), C, hid};
  J.job[3] = {w.ge, w.m2g, f(37), hid, C};
  J.n = 4;
  J.M = clips * Nq;
  J.splits = splits_q;
  J.ws = w.wpart;
  J.vpart = w.bpart_q;
  J.vout = f(38);
  J.vtiles = clips * qchunks;
  J.vlen = qbias_len(hid);
  if ((e = f32ops::launch_wgrad(J, st)) != cudaSuccess)
    return static_cast<int>(e);
  f32ops::Jobs K;
  K.job[0] = {w.nk, w.dk, f(33), C, C};
  K.job[1] = {w.nv, w.dv, f(34), C, C};
  K.n = 2;
  K.M = clips * Nk;
  K.splits = splits_k;
  K.ws = w.wpart;
  K.vpart = w.bpart_k;
  K.vout = f(39);
  K.vtiles = clips * kchunks;
  K.vlen = KBIAS_LEN;
  if ((e = f32ops::launch_wgrad(K, st)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = launch_clip_sum(w.cpart_q, qchunks, QCLIP_LEN, clips, f(30),
                           st)) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(
      launch_clip_sum(w.cpart_k, kchunks, KCLIP_LEN, clips, f(31), st));
}

PMCE_EXPORT_ERROR_STRING(pmce_ca_f32_error_string)
