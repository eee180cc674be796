// Stage-1 lifter trunk for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_lifter_trunk_kernel` (entry
// `fused_lifter_trunk`), the Pallas kernel that runs all depth x (spatial,
// temporal) pre-norm blocks of one clip's [T*J = 304, C = 256] tokens in
// VMEM, with the shared norm_s / norm_t and the temporal pos-embed.
//
// What bounds it on this card: at batch 256 the four products of the six
// blocks are 490 GFLOP of bf16 tensor-core work (0.50 ms at the dense
// peak); each block has to read and write the bf16 token stream once
// (2 x 40 MB, 0.024 ms at the HBM rate). A clip's f32 stream (311 KB) is
// over the 227 KB of shared memory a block may use, so the TPU's
// one-program-per-clip design does not carry over.
//
// Design: one launch per transformer block, the tile program of
// tile_block.cuh (tb::tile_block_kernel, its trunk program): a thread block
// of 8 warps owns a tile of up to 128 rows made of whole attention groups
// (the J rows of a frame, or the T rows of a (clip, joint) column, gathered
// by index arithmetic) and runs the whole block on it, LN1, per-head
// attention on the tensor cores, the MLP in hidden chunks, the shared
// post-norm (plus the temporal pos-embed after block 0), with the f32
// residual in registers and the weights streaming through a cp.async ring.
// Only x is read from device memory and the output written: no
// intermediate leaves the SM. The training block's forward (block.cu, row
// 6) runs the same program with its saving epilogues.
//
// Groups over 128 tokens (T or J > 128) take the long route: the earlier
// launch sequence of transformer_ops.cuh (ln_rows, the WMMA gemm with fused
// epilogues, group_attn), 8 launches a block, its own launch counter.

#include "tile_block.cuh"

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

// One whole transformer block (LN1, attention, proj, LN2, MLP, post-norm)
// over [B, T*J, C] bf16 tokens, a tile of whole groups per thread block.
// tpe: null, or the [T, C] pos-embed added after the post-norm. stamps:
// null, or [tiles, 8] int64 for the stage-stamped instantiation.
extern "C" int pmce_trunk_block(
    const void* x, void* out, const void* wqkv, const void* wproj,
    const void* w1, const void* w2, const float* g1, const float* b1,
    const float* bqkv, const float* bproj, const float* g2, const float* b2,
    const float* bb1, const float* bb2, const float* pg, const float* pb,
    const float* tpe, int B, int T, int J, int temporal, int hid, float eps,
    float qscale, long long* stamps, void* stream) {
  tb::BlockArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.wproj = static_cast<const bf16*>(wproj);
  a.w1 = static_cast<const bf16*>(w1);
  a.w2 = static_cast<const bf16*>(w2);
  a.g1 = g1; a.b1 = b1; a.bqkv = bqkv; a.bproj = bproj;
  a.g2 = g2; a.b2 = b2; a.bb1 = bb1; a.bb2 = bb2;
  a.pg = pg; a.pb = pb; a.tpe = tpe;
  a.B = B; a.T = T; a.J = J; a.temporal = temporal; a.hid = hid;
  a.eps = eps; a.post_eps = eps; a.qscale = qscale; a.round_y = 1;
  a.m1 = a.m2 = nullptr;
  a.h1 = a.qkv = a.o = a.h2 = a.ge = nullptr;
  a.x1 = a.hh = a.y = a.a = a.mo = nullptr;
  a.stamps = stamps;
  return tb::launch_tile_block(a, static_cast<cudaStream_t>(stream));
}

// Tokens per tile of the block kernel and its stage count (Python plans
// the grid and the stamps buffer from these).
extern "C" int pmce_trunk_tile_rows() { return tb::TM; }
extern "C" int pmce_trunk_stamps() { return tb::NSTAMP; }

PMCE_EXPORT_ERROR_STRING(pmce_trunk_error_string)
