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
// 132 SMs, while the clip's vertex stream fits in its shared memory, V <=
// 450, else a cluster of S CTAs a clip, S = 8 at V = 1723; the vertex
// stream swizzled in dynamic shared memory, the joint stream in a per-clip
// workspace or a rank's shared memory, mma.sync bf16 products with f32
// sums and register epilogues, the vertex self-attention on the tensor
// cores). It returns its joint features, so it always runs the joint
// stream. Here it starts from bf16 features instead of coordinates and ends
// by rounding the two f32 streams to bf16 features (each rank its own
// vertex rows; the joints rank 0). No atomics and a fixed order of every
// sum: a rerun gives the same bits.

#include "coevo_ops.cuh"

using namespace coevo;

// CL: a cluster of S CTAs a clip (coevo_ops.cuh's cluster program), each
// rank its own vertex rows, the joint workspace in its shared memory (ws
// unused); else one CTA a clip, the joint workspace at ws.
template <bool PROF, bool CL>
__global__ void __launch_bounds__(NT, 1)
    coevo_block_kernel(const bf16* jf0, const bf16* vf0, bf16* jout,
                       bf16* vout, const float* gammas, const float* betas,
                       const void* const* params, unsigned char* ws,
                       long long ws_stride, int J, int V, int S, float eps,
                       float scale_j, float scale_v, long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  Clip c{1, 0, V, 0, V};
  if constexpr (CL) {
    c.S = S;
    c.rank = clu::rank();
    rank_rows(V, S, c.rank, c.row0, c.n);
  }
  const int b = blockIdx.x / c.S;
  Stamps<PROF> mark{stamps + (size_t)b * 2 * MAX_STAMPS, 0};
  mark(ST_IO, KD_OTHER);
  const ClipBuffers s =
      CL ? cluster_buffers(smem, J, rank_rows_max(V, S))
         : clip_buffers(smem, ws + (size_t)b * ws_stride, J, V);
  const size_t jc = (size_t)J * CC;
  const size_t vr = ((size_t)b * V + c.row0) * CC;  // this CTA's first row
  // jf into the workspace, vf into B1: the features with their pos embeds.
  add_rows(jf0 + b * jc, false, COEVO_WF(params, K_JPOS), s.jf, J);
  add_rows(vf0 + vr, false, COEVO_WF(params, K_VPOS) + (size_t)c.row0 * CC,
           s.B1, c.n);
  __syncthreads();
  mark(ST_IO, KD_OTHER);
  coevo_block_body<PROF, CL>(s, params, gammas + (size_t)b * 12 * CC,
                             betas + (size_t)b * 12 * CC, J, c, eps, scale_j,
                             scale_v, true, mark);
  if (c.rank == 0) round_rows(s.jx, Mat{jout + b * jc, CC, false}, J);
  round_rows(s.XV, Mat{vout + vr, CC, false}, c.n);
  mark(ST_IO, KD_OTHER);
}

extern "C" long long pmce_coevo_block_workspace_bytes(int J) {
  return clip_workspace_bytes(J);
}

extern "C" long long pmce_coevo_block_smem_bytes(int V) {
  return clip_smem_bytes(V);
}

// A CTA's shared memory in clusters of S > 1 CTAs a clip, or -1 where the
// cluster program does not take (J, V, S).
extern "C" long long pmce_coevo_cluster_smem_bytes(int J, int V,
                                                         int S) {
  return cluster_admits(J, V, S) ? cluster_smem_bytes(J, V, S) : -1;
}

// Clusters of S > 1 CTAs at (J, V) the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int pmce_coevo_clusters(int J, int V, int S) {
  if (!cluster_admits(J, V, S))
    return -static_cast<int>(cudaErrorInvalidValue);
  return occupancy_clusters(coevo_block_kernel<false, true>,
                            static_cast<int>(cluster_smem_bytes(J, V, S)), S);
}

template <bool PROF>
static int launch_block(const void* jf0, const void* vf0, void* jout,
                        void* vout, const float* gammas, const float* betas,
                        const void* params, void* ws, int B, int J, int V,
                        int S, float eps, float scale_j, float scale_v,
                        long long* stamps, void* stream) {
  const auto tab = static_cast<const void* const*>(params);
  const auto w = static_cast<unsigned char*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto j0 = static_cast<const bf16*>(jf0);
  const auto v0 = static_cast<const bf16*>(vf0);
  const auto jo = static_cast<bf16*>(jout);
  const auto vo = static_cast<bf16*>(vout);
  if (S > 1) {
    if (PROF || B <= 0 || !cluster_admits(J, V, S))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_cluster(
        coevo_block_kernel<false, true>,
        static_cast<int>(cluster_smem_bytes(J, V, S)), B, S, st, j0, v0, jo,
        vo, gammas, betas, tab, w, 0LL, J, V, S, eps, scale_j, scale_v,
        static_cast<long long*>(nullptr)));
  }
  const int smem = static_cast<int>(clip_smem_bytes(V));
  cudaError_t e = cudaFuncSetAttribute(
      coevo_block_kernel<PROF, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  coevo_block_kernel<PROF, false><<<B, NT, smem, st>>>(
      j0, v0, jo, vo, gammas, betas, tab, w, clip_workspace_bytes(J), J, V,
      1, eps, scale_j, scale_v, stamps);
  return static_cast<int>(cudaGetLastError());
}

// jf0 / vf0 / jout / vout: bf16 [B, J|V, C]; gammas / betas: f32
// [B, 12, C]; params: a device array of the K_COUNT pointers of
// coevo_ops.cuh; S: the CTAs of a clip's cluster (1: one CTA a clip, ws
// B * pmce_coevo_block_workspace_bytes(J) bytes; S > 1: ws unused).
extern "C" int pmce_coevo_block(const void* jf0, const void* vf0, void* jout,
                                void* vout, const float* gammas,
                                const float* betas, const void* params,
                                void* ws, int B, int J, int V, int S,
                                float eps, float scale_j, float scale_v,
                                void* stream) {
  return launch_block<false>(jf0, vf0, jout, vout, gammas, betas, params, ws,
                             B, J, V, S, eps, scale_j, scale_v, nullptr,
                             stream);
}

// The stamped instantiation (chip_smoke.py --profile only; one CTA a clip).
extern "C" int pmce_coevo_block_prof(const void* jf0, const void* vf0,
                                     void* jout, void* vout,
                                     const float* gammas, const float* betas,
                                     const void* params, void* ws, int B,
                                     int J, int V, float eps, float scale_j,
                                     float scale_v, long long* stamps,
                                     void* stream) {
  return launch_block<true>(jf0, vf0, jout, vout, gammas, betas, params, ws,
                            B, J, V, 1, eps, scale_j, scale_v, stamps,
                            stream);
}

PMCE_EXPORT_ERROR_STRING(pmce_coevo_block_error_string)
