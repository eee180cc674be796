// The decoder's whole co-evolution chain for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_coevo_chain.py `_chain_kernel` (entry
// `fused_coevo_chain`), the Pallas kernel that runs all CoevoBlocks of a
// group of clips with their f32 coordinate heads: per block the 3 -> C
// projections of the ORIGINAL joints and of the current vertices, the pos /
// Q / K embeds, the v->j and j->v projections, the joint CA+FFN (8 heads,
// J queries over V keys) and vertex CA+FFN (2 heads, V queries over J keys)
// on the pre-update streams, AdaLN'd SA+FFN on each stream, and the C -> 3
// heads with their residuals.
//
// What bounds it on this card: per clip the work is small and serial
// (about 70 M multiply-adds per block at V = 431, C = 64), and its
// intermediates are [431, 64] tensors that would make ~60 round trips
// through device memory per clip if each op were its own launch. The
// vertex stream alone is 431 x 64 x 4 B = 110 KB in f32.
//
// Design: one block of 512 threads per clip (B = 256 blocks on 132 SMs)
// loops over the blocks of the chain. Each block's token program is
// coevo_ops.cuh's coevo_block_body (the vertex stream swizzled in shared
// memory, the joint stream in a per-clip workspace, mma.sync products with
// register epilogues, the vertex self-attention on the tensor cores; the
// plan is spelled out there), between the 3 -> C embeds and the f32
// coordinate heads; the weights (bf16, under 1 MB for the chain) stay in
// L1/L2. Every block re-reads the original joints, so the joint stream's
// CA+FFN, SA+FFN and head of blocks 0..NB-2 feed no output and are
// skipped: evo_pose and the vertices are the same bits as with them.

#include "coevo_ops.cuh"

using namespace coevo;

// Per-block parameter table (device array of pointers): the 3 -> C
// projections, then the block's own table (coevo_ops.cuh, K_*), then the
// coordinate heads.
enum {
  P_WJP = 0, P_BJP, P_WVP, P_BVP,                      // [3,C] bf16, [C] f32
  P_BLOCK = 4,                                         // K_COUNT entries
  P_WHJ = P_BLOCK + K_COUNT, P_BHJ, P_WHV, P_BHV,      // f32 [C,3], [3]
  P_COUNT = P_WHJ + 4
};

// out = bf16(f32(bf16(bf16(x) @ W + b)) + pos): the 3 -> C projection of
// f32 coordinates [n, 3] and its embed add, with the chain's cast points;
// one 8-channel chunk a thread at a time.
__device__ void embed3(const float* x, int n, const bf16* W, const float* b,
                       const float* pos, Mat out) {
  for (int i = threadIdx.x; i < n * CC / 8; i += NT) {
    const int r = i / (CC / 8), c = i % (CC / 8) * 8;
    float w[3][8], acc[8];
#pragma unroll
    for (int k = 0; k < 3; ++k) load8(W + k * CC + c, w[k]);
    const float x0 = rbf(x[r * 3]), x1 = rbf(x[r * 3 + 1]),
                x2 = rbf(x[r * 3 + 2]);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] = rbf(((x0 * w[0][e] + x1 * w[1][e]) + x2 * w[2][e]) + b[c + e]) +
               pos[(size_t)i * 8 + e];
    *reinterpret_cast<uint4*>(out.at(r, c)) =
        make_uint4(pack_bf2(acc[0], acc[1]), pack_bf2(acc[2], acc[3]),
                   pack_bf2(acc[4], acc[5]), pack_bf2(acc[6], acc[7]));
  }
}

// out[n, 3] = X[n, C] @ W[C, 3] + b + resid, all f32 (the coordinate head);
// out may alias resid.
__device__ void head3(const float* X, int n, const float* W, const float* b,
                      const float* resid, float* out) {
  for (int e = threadIdx.x; e < n * 3; e += NT) {
    const int r = e / 3, k = e % 3;
    float acc = 0.f;
    for (int c = 0; c < CC; ++c) acc += X[(size_t)r * CC + c] * W[c * 3 + k];
    out[e] = (acc + b[k]) + resid[e];
  }
}

template <bool PROF>
__global__ void __launch_bounds__(NT, 1)
    coevo_chain_kernel(const float* joints, float* jout, float* vout,
                       const float* gammas, const float* betas,
                       const void* const* params, unsigned char* ws,
                       long long ws_stride, int J, int V, int NB, float eps,
                       float scale_j, float scale_v, long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  Stamps<PROF> mark{stamps + (size_t)b * 2 * MAX_STAMPS, 0};
  mark(ST_IO, KD_OTHER);
  const ClipBuffers s = clip_buffers(smem, ws + (size_t)b * ws_stride, J, V);
  const float* jin = joints + (size_t)b * J * 3;
  float* jo = jout + (size_t)b * J * 3;
  float* vc = vout + (size_t)b * V * 3;  // holds the current vertices

  for (int blk = 0; blk < NB; ++blk) {
    const void* const* P = params + (size_t)blk * P_COUNT;
    const void* const* K = P + P_BLOCK;
    // jf and vf (B1): the projections of the ORIGINAL joints and of the
    // current vertices, with their pos embeds.
    embed3(jin, J, COEVO_WB(P, P_WJP), COEVO_WF(P, P_BJP),
           COEVO_WF(K, K_JPOS), s.jf);
    embed3(vc, V, COEVO_WB(P, P_WVP), COEVO_WF(P, P_BVP),
           COEVO_WF(K, K_VPOS), s.B1);
    __syncthreads();
    mark(ST_IO, KD_OTHER);
    // Every block re-reads the original joints, so only the last block's
    // joint stream reaches an output (evo_pose).
    const bool joint_live = blk == NB - 1;
    coevo_block_body(s, K, gammas + ((size_t)b * NB + blk) * 12 * CC,
                     betas + ((size_t)b * NB + blk) * 12 * CC, J, V, eps,
                     scale_j, scale_v, joint_live, mark);
    if (joint_live)
      head3(s.jx, J, COEVO_WF(P, P_WHJ), COEVO_WF(P, P_BHJ), jin, jo);
    head3(s.XV, V, COEVO_WF(P, P_WHV), COEVO_WF(P, P_BHV), vc, vc);
    __syncthreads();
    mark(ST_IO, KD_OTHER);
  }
}

extern "C" long long pmce_chain_workspace_bytes(int J) {
  return clip_workspace_bytes(J);
}

extern "C" long long pmce_chain_smem_bytes(int V) { return clip_smem_bytes(V); }

template <bool PROF>
static int launch_chain(const float* joints, float* jout, float* vout,
                        const float* gammas, const float* betas,
                        const void* params, void* ws, int B, int J, int V,
                        int NB, float eps, float scale_j, float scale_v,
                        long long* stamps, void* stream) {
  const int smem = static_cast<int>(pmce_chain_smem_bytes(V));
  cudaError_t e = cudaFuncSetAttribute(
      coevo_chain_kernel<PROF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  coevo_chain_kernel<PROF><<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      joints, jout, vout, gammas, betas,
      static_cast<const void* const*>(params),
      static_cast<unsigned char*>(ws), pmce_chain_workspace_bytes(J), J, V,
      NB, eps, scale_j, scale_v, stamps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmce_coevo_chain(const float* joints, float* jout, float* vout,
                                const float* gammas, const float* betas,
                                const void* params, void* ws, int B, int J,
                                int V, int NB, float eps, float scale_j,
                                float scale_v, void* stream) {
  return launch_chain<false>(joints, jout, vout, gammas, betas, params, ws,
                             B, J, V, NB, eps, scale_j, scale_v, nullptr,
                             stream);
}

// The stamped instantiation (chip_smoke.py --profile only): stamps holds
// B * 2 * MAX_STAMPS int64 (coevo_ops.cuh, Stamps).
extern "C" int pmce_coevo_chain_prof(const float* joints, float* jout,
                                     float* vout, const float* gammas,
                                     const float* betas, const void* params,
                                     void* ws, int B, int J, int V, int NB,
                                     float eps, float scale_j, float scale_v,
                                     long long* stamps, void* stream) {
  return launch_chain<true>(joints, jout, vout, gammas, betas, params, ws, B,
                            J, V, NB, eps, scale_j, scale_v, stamps, stream);
}

extern "C" int pmce_max_stamps() { return MAX_STAMPS; }

PMCE_EXPORT_ERROR_STRING(pmce_chain_error_string)
