// Stage-1 lifter trunk for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_lifter_trunk_kernel` (entry
// `fused_lifter_trunk`), the Pallas kernel that runs all depth x (spatial,
// temporal) pre-norm blocks of one clip's [T*J = 304, C = 256] tokens in
// VMEM, with the shared norm_s / norm_t and the temporal pos-embed.
//
// What bounds it on this card: a clip's f32 stream is 304 x 256 x 4 B =
// 311 KB, over the 227 KB of shared memory one block may use, so the TPU's
// one-program-per-clip design does not carry over. At batch 256 the four
// projections of the six blocks are 490 GFLOP of bf16 products (tensor-core
// work) and the activations they read and write are about 1.2 GB per block
// (device-memory work); neither fits on chip across a block.
//
// Design: a short sequence of launches per block, each over all B*T*J rows
// (the three kernels live in transformer_ops.cuh, shared with block.cu):
//   ln_rows      row LayerNorm, f32 statistics, bf16 out (the temporal
//                pos-embed add is fused into the first norm_s);
//   gemm         128x128 bf16 tiles on the tensor cores (WMMA 16x16x16,
//                f32 accumulation), the next k-tile copied with cp.async
//                while the current one is multiplied, and the epilogue
//                fused: +bias, the 1/sqrt(dh) q scale in f32 before the
//                one bf16 rounding, erf-GELU, and the f32 residual adds;
//   group_attn   one warp per (clip, group, head); a spatial group is the
//                J rows of one frame, a temporal group the T rows of one
//                joint, found by index arithmetic: no [R, R] mask exists.
//                Each lane owns one query and runs a max-stabilised online
//                softmax in f32 over the group's keys. (Eight head-warps in
//                one block measured slower on an H100 at 700 W: with 96
//                registers a thread, fewer warps stay resident than with
//                32-thread blocks.)
// Fusing these launches (and keeping x1 on chip) is later work.

#include "transformer_ops.cuh"

using namespace pmce;

// ---------------------------------------------------------------------------
// C interface (ctypes). Every function returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" int pmce_trunk_ln(const void* x, int x_is_f32, void* out,
                             const float* g, const float* b, const float* tpe,
                             int M, int R, int J, float eps, void* stream) {
  return launch_ln_rows(x, x_is_f32, out, g, b, tpe, M, R, J, eps,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int pmce_trunk_gemm(const void* A, const void* W, int M, int N,
                               int K, int epi, int out_f32,
                               const float* bias, const void* res,
                               int res_f32, const float* rowscale, int rps,
                               int qcols, float qscale, float* save,
                               const float* aux, void* out, void* stream) {
  return gemm_entry(A, W, M, N, K, epi, out_f32, bias, res, res_f32,
                    rowscale, rps, qcols, qscale, save, aux, out, stream);
}

extern "C" int pmce_trunk_attn(const void* qkv, void* out, int B, int T,
                               int J, int C, int heads, int temporal,
                               void* stream) {
  return launch_group_attn(static_cast<const bf16*>(qkv),
                           static_cast<bf16*>(out), B, T, J, C, heads,
                           temporal, static_cast<cudaStream_t>(stream));
}

PMCE_EXPORT_ERROR_STRING(pmce_trunk_error_string)
