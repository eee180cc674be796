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
// vertices attending to joints (431 queries over 17 keys, 2 heads of 32).
//
// What bounds it on this card: the products are ~0.4 GFLOP per direction
// at these shapes and the activations ~4 MB: microseconds at the bf16
// tensor-core peak or the HBM rate. Launches, and this first kernel's
// attention on the CUDA cores, bound it.
//
// Design (simple first), as ada_block.cu: one launch per stage over all
// rows; three AdaLNs, the q / k / v projections as WMMA GEMMs (q scaled in
// f32 before its bf16 rounding), attention_ops.cuh's attention with each
// clip's keys its own Nk rows (no padding, so no key mask: the TPU kernel
// pads 17 keys to a tile and masks them), the projection with its masked
// residual, the AdaLN'd MLP. The backward: the MLP half, the attention
// backward (query pass for dq, key pass for dk and dv, which sum over the
// heads' queries inside one thread), the three projections' gradients and
// three AdaLN backwards, each with its clip's dgamma / dbeta summed in one
// block; weight gradients by split-K partials added in a fixed order, so
// reruns agree bit for bit. One C call runs each direction's sequence.

#include "attention_ops.cuh"

using namespace pmce;

namespace {

struct CaWs {
  bf16 *m2g, *dhh, *da, *dout, *dq, *dk, *dv;
  float *dh2, *dx1, *dnq, *dnk, *dnv, *dsum, *colpart, *tnpart;
};

CaWs ca_ws(Carve& c, int clips, int Nq, int Nk, int C, int hid, int H) {
  const size_t Mq = (size_t)clips * Nq, Mk = (size_t)clips * Nk;
  CaWs w;
  w.m2g = c.take<bf16>(Mq * C);
  w.dhh = c.take<bf16>(Mq * hid);
  w.da = c.take<bf16>(Mq * C);
  w.dout = c.take<bf16>(Mq * C);
  w.dq = c.take<bf16>(Mq * C);
  w.dk = c.take<bf16>(Mk * C);
  w.dv = c.take<bf16>(Mk * C);
  w.dh2 = c.take<float>(Mq * C);
  w.dx1 = c.take<float>(Mq * C);
  w.dnq = c.take<float>(Mq * C);
  w.dnk = c.take<float>(Mk * C);
  w.dnv = c.take<float>(Mk * C);
  w.dsum = c.take<float>((size_t)clips * H * Nq);
  w.colpart = c.take<float>(std::max(colsum_part_elems((int)Mq, hid),
                                     colsum_part_elems((int)Mk, C)));
  w.tnpart = c.take<float>(std::max(
      {tn_part_elems((int)Mq, C, C), tn_part_elems((int)Mk, C, C),
       tn_part_elems((int)Mq, C, hid), tn_part_elems((int)Mq, hid, C)}));
  return w;
}

}  // namespace

extern "C" long long pmce_ca_block_workspace(int clips, int Nq, int Nk,
                                             int C, int hid, int H) {
  Carve c(nullptr);
  ca_ws(c, clips, Nq, Nk, C, hid, H);
  return static_cast<long long>(c.off);
}

// P: xq [Mq,C], xk, xv [Mk,C] bf16; gq, bq, gk, bk, gv, bv, g2, b2 [clips,C]
// f32; m1, m2 [clips] or null; wq, bq, wk, bk, wv, bv, wproj, bproj, w1,
// bb1, w2, bb2; saved nq, nk, nv, q, k, v, o, stat_m, stat_l, x1, h2, hh,
// ge; out.
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
                f(11), Nq));
  return ada_mlp_fwd(f(34), clips, Nq, C, hid, f(9), f(10), eps, b(21),
                     f(22), b(23), f(24), f(12), b(35), f(36), b(37), b(38),
                     s);
}

// P: xq, xk, xv, g (dL/d out), gq, gk, gv, g2 (gammas), m1, m2, wqᵀ, wkᵀ,
// wvᵀ, wprojᵀ, w1ᵀ, w2ᵀ; saved nq, nk, nv, q, k, v, o, stat_m, stat_l,
// x1, h2, hh, ge; dxq, dxk, dxv bf16; dgb f32 [8, clips, C] (dgq, dbq,
// dgk, dbk, dgv, dbv, dg2, db2); grads f32 (dwq, dbq, dwk, dbk, dwv, dbv,
// dwproj, dbproj, dw1, dbb1, dw2, dbb2); ws.
extern "C" int pmce_ca_block_bwd(void* const* P, int clips, int Nq, int Nk,
                                 int C, int hid, int H, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  const int Mq = clips * Nq, Mk = clips * Nk, D = C / H;
  Carve c(P[34]);
  const CaWs w = ca_ws(c, clips, Nq, Nk, C, hid, H);
  float* dgb = f(32);
  const size_t bc = (size_t)clips * C, cc = (size_t)C * C;
  float* gr = f(33);
  float *dwq = gr, *dbq = dwq + cc, *dwk = dbq + C, *dbk = dwk + cc;
  float *dwv = dbk + C, *dbv = dwv + cc, *dwp = dbv + C, *dbp = dwp + cc;
  float* mlp = dbp + C;
  const MlpGrads mg{mlp, mlp + C * hid, mlp + C * hid + hid,
                    mlp + 2 * C * hid + hid, dgb + 6 * bc, dgb + 7 * bc};
  PMCE_TRY(ada_mlp_bwd(b(3), f(25), b(26), f(27), b(28), clips, Nq, C, hid,
                       f(7), eps, b(14), b(15), f(8), f(9), w.m2g, w.dhh,
                       w.dh2, w.dx1, w.da, w.colpart, w.tnpart, mg, s));
  // Output projection.
  PMCE_TRY(colsum_to(w.da, Mq, C, w.colpart, dbp, s));
  PMCE_TRY(wgrad_to(b(22), w.da, Mq, C, C, w.tnpart, dwp, s));
  PMCE_TRY(gemm(EPI_STORE, w.da, b(13), Mq, C, C, w.dout, 0, nullptr, s));
  // Attention.
  const AttnIO io{b(19), b(20), b(21), C, C, C};
  PMCE_TRY(launch_attn_bwd(io, w.dout, C, f(23), f(24), w.dsum, w.dq, C,
                           w.dk, C, w.dv, C,
                           1.0f / sqrtf(static_cast<float>(D)), clips, Nq,
                           Nk, H, D, s));
  // The q, k, v projections and their AdaLNs.
  const bf16* norms[3] = {b(16), b(17), b(18)};
  const bf16* dproj[3] = {w.dq, w.dk, w.dv};
  float* dnorm[3] = {w.dnq, w.dnk, w.dnv};
  float* dws[3] = {dwq, dwk, dwv};
  float* dbs[3] = {dbq, dbk, dbv};
  for (int t = 0; t < 3; ++t) {
    const int M = t ? Mk : Mq;
    PMCE_TRY(colsum_to(dproj[t], M, C, w.colpart, dbs[t], s));
    PMCE_TRY(wgrad_to(norms[t], dproj[t], M, C, C, w.tnpart, dws[t], s));
    PMCE_TRY(gemm(EPI_STORE, dproj[t], b(10 + t), M, C, C, dnorm[t], 1,
                  nullptr, s));
    PMCE_TRY(launch_adaln_bwd(dnorm[t], b(t), f(4 + t), eps,
                              t ? nullptr : w.dx1, 1, nullptr, clips,
                              t ? Nk : Nq, C, nullptr, b(29 + t),
                              dgb + 2 * t * bc, dgb + (2 * t + 1) * bc, s));
  }
  return 0;
}

PMCE_EXPORT_ERROR_STRING(pmce_ca_block_error_string)
