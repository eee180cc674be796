// Multi-head self-attention with its projections, forward and backward,
// for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_mhsa_kernel` (entry
// `fused_mhsa`, both its grouped N <= 64 and one-clip N > 64 calls) and
// `_mhsa_bwd_kernel` (via `_fused_mhsa_bwd`):
//
//   out = softmax(q kᵀ / sqrt(dh)) v @ Wproj + bproj,  [q|k|v] = x @ Wqkv + bqkv
//
// per clip of N tokens, any N: the decoder's joint self-attention ([32, 17,
// 64], 8 heads of 8) and the lifter trunk's backward recompute ([B*T, 17,
// 256] and [B*J, 16, 256], 8 heads of 32).
//
// What bounds it on this card: little. At [32, 17, 64] the products are
// 0.02 GFLOP and the activations 0.1 MB (a few microseconds at the bf16
// tensor-core peak or at 3.35 TB/s); at the trunk's [512, 17, 256] 1.9
// GFLOP (~2 us). The launches and the host around them bound it.
//
// Design (simple first): the projections are the shared WMMA GEMMs with
// fused epilogues (transformer_ops.cuh); attention is attention_ops.cuh's
// thread-per-query kernel, which streams keys through shared memory and
// keeps each query's softmax max and sum for the backward. The forward
// saves qkv, the head outputs and those statistics instead of recomputing
// them as the TPU kernel does in VMEM. The backward's attention pass runs
// twice, query-major for dq and key-major for dk / dv, so that every
// gradient element is summed by one thread; the parameter gradients are
// split-K partial tiles added in a fixed order (no float atomics: reruns
// agree bit for bit). One C call runs each direction's whole sequence.

#include "attention_ops.cuh"

using namespace pmce;

namespace {

// Backward scratch, in carve order.
struct MhsaWs {
  bf16 *dout, *dqkv;
  float *dsum, *colpart, *tnpart;
};

MhsaWs mhsa_ws(Carve& c, int clips, int N, int C, int H) {
  const int M = clips * N;
  MhsaWs w;
  w.dout = c.take<bf16>((size_t)M * C);
  w.dqkv = c.take<bf16>((size_t)M * 3 * C);
  w.dsum = c.take<float>((size_t)clips * H * N);
  w.colpart = c.take<float>(colsum_part_elems(M, 3 * C));
  w.tnpart = c.take<float>(std::max(tn_part_elems(M, C, 3 * C),
                                    tn_part_elems(M, C, C)));
  return w;
}

}  // namespace

extern "C" long long pmce_mhsa_workspace(int clips, int N, int C, int H) {
  Carve c(nullptr);
  mhsa_ws(c, clips, N, C, H);
  return static_cast<long long>(c.off);
}

// P: x, wqkv [C,3C], bqkv, wproj [C,C], bproj; saved qkv [M,3C], o [M,C],
// stat_m, stat_l [clips,H,N]; out [M,C].
extern "C" int pmce_mhsa_fwd(void* const* P, int clips, int N, int C, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  PMCE_TRY(self_attn_fwd(b(0), clips, N, C, H, b(1), f(2), b(5), b(6), f(7),
                         f(8), s));
  return gemm(EPI_STORE, b(6), b(3), clips * N, C, C, b(9), 0, f(4), s);
}

// P: x, g (dL/d out), wqkvᵀ [3C,C], wprojᵀ [C,C], saved qkv, o, stat_m,
// stat_l; dx [M,C] bf16; grads f32 (dwqkv, dbqkv, dwproj, dbproj); ws.
extern "C" int pmce_mhsa_bwd(void* const* P, int clips, int N, int C, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  Carve c(P[10]);
  const MhsaWs w = mhsa_ws(c, clips, N, C, H);
  float* gr = f(9);
  const SelfAttnGrads g{gr, gr + 3 * C * C, gr + 3 * C * C + 3 * C,
                        gr + 4 * C * C + 3 * C};
  return self_attn_bwd(b(0), b(1), clips, N, C, H, b(4), b(5), f(6), f(7),
                       b(2), b(3), w.dout, w.dqkv, w.dsum, w.colpart,
                       w.tnpart, g, b(8), 0, s);
}

PMCE_EXPORT_ERROR_STRING(pmce_mhsa_error_string)
