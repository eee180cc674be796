// One whole CoevoBlock per clip for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_coevo_kernel` (entry
// `fused_coevo_block`), the Pallas kernel that runs one CoevoBlock's token
// program per clip on the projected features: the pos / Q / K embeds, the
// v->j and j->v projections, the joint CA+FFN (8 heads, J queries over V
// keys) and vertex CA+FFN (2 heads, V queries over J keys) on the
// pre-update streams, and the AdaLN'd SA+FFN on each stream. It returns
// the post-SA features; the f32 coordinate heads stay outside, as in JAX.
//
// What bounds it on this card: the products, ~140 M flops a clip at
// V = 431, C = 64 (~36 GFLOP at B = 256, 0.036 ms at the bf16 tensor-core
// peak), against ~29 MB of features in and out (0.009 ms at the HBM rate).
// The work of one clip is small and serial, and its [431, 64]
// intermediates would make ~60 round trips through device memory if each
// op were its own launch.
//
// Design: the block program of the whole-chain kernel (coevo_ops.cuh's
// coevo_block_body: one block of 512 threads per clip, B = 256 blocks on
// 132 SMs, the vertex stream swizzled in dynamic shared memory, the joint
// stream in a per-clip workspace, mma.sync bf16 products with f32 sums and
// register epilogues, the vertex self-attention on the tensor cores). It
// returns its joint features, so it always runs the joint stream. Here it starts from bf16 features instead of coordinates and
// ends by rounding the two f32 streams to bf16 features. No atomics and a
// fixed order of every sum: a rerun gives the same bits.

#include "coevo_ops.cuh"

using namespace coevo;

template <bool PROF>
__global__ void __launch_bounds__(NT, 1)
    coevo_block_kernel(const bf16* jf0, const bf16* vf0, bf16* jout,
                       bf16* vout, const float* gammas, const float* betas,
                       const void* const* params, unsigned char* ws,
                       long long ws_stride, int J, int V, float eps,
                       float scale_j, float scale_v, long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  Stamps<PROF> mark{stamps + (size_t)b * 2 * MAX_STAMPS, 0};
  mark(ST_IO, KD_OTHER);
  const ClipBuffers s = clip_buffers(smem, ws + (size_t)b * ws_stride, J, V);
  const size_t jc = (size_t)J * CC, vc = (size_t)V * CC;
  // jf into the workspace, vf into B1: the features with their pos embeds.
  add_rows(jf0 + b * jc, false, COEVO_WF(params, K_JPOS), s.jf, J);
  add_rows(vf0 + b * vc, false, COEVO_WF(params, K_VPOS), s.B1, V);
  __syncthreads();
  mark(ST_IO, KD_OTHER);
  coevo_block_body(s, params, gammas + (size_t)b * 12 * CC,
                   betas + (size_t)b * 12 * CC, J, V, eps, scale_j, scale_v,
                   true, mark);
  round_rows(s.jx, Mat{jout + b * jc, CC, false}, J);
  round_rows(s.XV, Mat{vout + b * vc, CC, false}, V);
  mark(ST_IO, KD_OTHER);
}

extern "C" long long pmce_coevo_block_workspace_bytes(int J) {
  return clip_workspace_bytes(J);
}

extern "C" long long pmce_coevo_block_smem_bytes(int V) {
  return clip_smem_bytes(V);
}

template <bool PROF>
static int launch_block(const void* jf0, const void* vf0, void* jout,
                        void* vout, const float* gammas, const float* betas,
                        const void* params, void* ws, int B, int J, int V,
                        float eps, float scale_j, float scale_v,
                        long long* stamps, void* stream) {
  const int smem = static_cast<int>(clip_smem_bytes(V));
  cudaError_t e = cudaFuncSetAttribute(
      coevo_block_kernel<PROF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  coevo_block_kernel<PROF><<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(jf0), static_cast<const bf16*>(vf0),
      static_cast<bf16*>(jout), static_cast<bf16*>(vout), gammas, betas,
      static_cast<const void* const*>(params),
      static_cast<unsigned char*>(ws), clip_workspace_bytes(J), J, V, eps,
      scale_j, scale_v, stamps);
  return static_cast<int>(cudaGetLastError());
}

// jf0 / vf0 / jout / vout: bf16 [B, J|V, C]; gammas / betas: f32
// [B, 12, C]; params: a device array of the K_COUNT pointers of
// coevo_ops.cuh; ws: B * pmce_coevo_block_workspace_bytes(J) bytes.
extern "C" int pmce_coevo_block(const void* jf0, const void* vf0, void* jout,
                                void* vout, const float* gammas,
                                const float* betas, const void* params,
                                void* ws, int B, int J, int V, float eps,
                                float scale_j, float scale_v, void* stream) {
  return launch_block<false>(jf0, vf0, jout, vout, gammas, betas, params, ws,
                             B, J, V, eps, scale_j, scale_v, nullptr, stream);
}

// The stamped instantiation (chip_smoke.py --profile only).
extern "C" int pmce_coevo_block_prof(const void* jf0, const void* vf0,
                                     void* jout, void* vout,
                                     const float* gammas, const float* betas,
                                     const void* params, void* ws, int B,
                                     int J, int V, float eps, float scale_j,
                                     float scale_v, long long* stamps,
                                     void* stream) {
  return launch_block<true>(jf0, vf0, jout, vout, gammas, betas, params, ws,
                            B, J, V, eps, scale_j, scale_v, stamps, stream);
}

PMCE_EXPORT_ERROR_STRING(pmce_coevo_block_error_string)
