// The decoder's AdaLayerNorm self-attention block, forward and backward,
// for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_ada_block_kernel` (entry
// `fused_ada_block`) and `_ada_block_bwd_kernel` (via
// `_fused_ada_block_bwd`), the vertex stream's self-attention + FFN:
//
//   x1 = x + m1 * MHSA(AdaLN(x; g1, b1));  y = x1 + m2 * MLP(AdaLN(x1; g2, b2))
//
// with per-clip AdaLN vectors (regressed from the GRU feature outside) and
// per-clip branch scales m1, m2 (stochastic depth).
//
// What bounds it on this card: at the training shapes (32 clips of 431
// tokens, C = 64, 2 heads of 32, hidden 256) the products are ~2.2 GFLOP
// forward, 1.5 of them the 431 x 431 attention, and twice that backward;
// the activations are ~3.5 MB. Hopper's tensor cores would take ~2 us and
// its memory ~1 us: the bound is far below what launches cost. This first
// kernel runs the attention on the CUDA cores (f32 FMAs, ~67 TFLOP/s peak),
// which then bounds it.
//
// Design (simple first): one launch per stage over all rows: AdaLN (a warp
// per row, gamma/beta row = row / N), WMMA GEMMs with fused epilogues (q
// scale, exact GELU keeping its input, masked residual adds), and
// attention_ops.cuh's attention, whose keys stream through shared memory in
// tiles of 64 so the 431-key score rows never leave registers. The forward
// keeps what the backward reads (qkv, head outputs, softmax statistics, x1,
// the MLP's input and pre-activation) in device memory, ~15 MB a block.
// The backward runs the MLP half, the AdaLN backward (a block per clip, so
// the clip's dgamma / dbeta sum inside one block in a fixed order), the
// attention backward (query pass for dq, key pass for dk / dv) and the
// first AdaLN backward; weight gradients are split-K partial tiles added in
// a fixed order. No float atomics: reruns agree bit for bit. One C call
// runs each direction's whole sequence.

#include "attention_ops.cuh"

using namespace pmce;

namespace {

struct AdaWs {
  bf16 *m2g, *dhh, *da, *dout, *dqkv;
  float *dh2, *dx1, *dh1, *dsum, *colpart, *tnpart;
};

AdaWs ada_ws(Carve& c, int clips, int N, int C, int hid, int H) {
  const size_t M = (size_t)clips * N;
  AdaWs w;
  w.m2g = c.take<bf16>(M * C);
  w.dhh = c.take<bf16>(M * hid);
  w.da = c.take<bf16>(M * C);
  w.dout = c.take<bf16>(M * C);
  w.dqkv = c.take<bf16>(M * 3 * C);
  w.dh2 = c.take<float>(M * C);
  w.dx1 = c.take<float>(M * C);
  w.dh1 = c.take<float>(M * C);
  w.dsum = c.take<float>((size_t)clips * H * N);
  w.colpart = c.take<float>(colsum_part_elems((int)M, std::max(hid, 3 * C)));
  w.tnpart = c.take<float>(std::max(
      {tn_part_elems((int)M, C, 3 * C), tn_part_elems((int)M, C, C),
       tn_part_elems((int)M, C, hid), tn_part_elems((int)M, hid, C)}));
  return w;
}

}  // namespace

extern "C" long long pmce_ada_block_workspace(int clips, int N, int C,
                                              int hid, int H) {
  Carve c(nullptr);
  ada_ws(c, clips, N, C, hid, H);
  return static_cast<long long>(c.off);
}

// P: x [M,C] bf16, g1, b1, g2, b2 [clips,C] f32, m1, m2 [clips] f32 or
// null, wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2 (bf16 [in,out] / f32);
// saved h1, qkv, o, stat_m, stat_l, x1 (f32), h2, hh (f32), ge; out.
extern "C" int pmce_ada_block_fwd(void* const* P, int clips, int N, int C,
                                  int hid, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  const int M = clips * N;
  PMCE_TRY(launch_adaln(b(0), b(15), f(1), f(2), M, N, C, eps, s));
  PMCE_TRY(self_attn_fwd(b(15), clips, N, C, H, b(7), f(8), b(16), b(17),
                         f(18), f(19), s));
  PMCE_TRY(gemm(EPI_RES, b(17), b(9), M, C, C, f(20), 1, f(10), s, b(0), 0,
                f(5), N));
  return ada_mlp_fwd(f(20), clips, N, C, hid, f(3), f(4), eps, b(11), f(12),
                     b(13), f(14), f(6), b(21), f(22), b(23), b(24), s);
}

// P: x, g (dL/d out), gamma1, gamma2, m1, m2, wqkvᵀ, wprojᵀ, w1ᵀ [hid,C],
// w2ᵀ [C,hid]; saved h1, qkv, o, stat_m, stat_l, x1, h2, hh, ge; dx bf16;
// dgb f32 [4, clips, C] (dg1, db1, dg2, db2); grads f32 (dwqkv, dbqkv,
// dwproj, dbproj, dw1, dbb1, dw2, dbb2); ws.
extern "C" int pmce_ada_block_bwd(void* const* P, int clips, int N, int C,
                                  int hid, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  Carve c(P[22]);
  const AdaWs w = ada_ws(c, clips, N, C, hid, H);
  float* dgb = f(20);
  const size_t bc = (size_t)clips * C;
  float* gr = f(21);
  const SelfAttnGrads ag{gr, gr + 3 * C * C, gr + 3 * C * C + 3 * C,
                         gr + 4 * C * C + 3 * C};
  float* mlp = gr + 4 * C * C + 4 * C;
  const MlpGrads mg{mlp, mlp + C * hid, mlp + C * hid + hid,
                    mlp + 2 * C * hid + hid, dgb + 2 * bc, dgb + 3 * bc};
  PMCE_TRY(ada_mlp_bwd(b(1), f(15), b(16), f(17), b(18), clips, N, C, hid,
                       f(3), eps, b(8), b(9), f(4), f(5), w.m2g, w.dhh,
                       w.dh2, w.dx1, w.da, w.colpart, w.tnpart, mg, s));
  PMCE_TRY(self_attn_bwd(b(10), w.da, clips, N, C, H, b(11), b(12), f(13),
                         f(14), b(6), b(7), w.dout, w.dqkv, w.dsum,
                         w.colpart, w.tnpart, ag, w.dh1, 1, s));
  return launch_adaln_bwd(w.dh1, b(0), f(2), eps, w.dx1, 1, nullptr, clips,
                          N, C, nullptr, b(19), dgb, dgb + bc, s);
}

PMCE_EXPORT_ERROR_STRING(pmce_ada_block_error_string)
