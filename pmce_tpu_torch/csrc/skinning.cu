// Linear blend skinning for Hopper (sm_90a), full f32.
//
// Replaces: pmce_tpu/smpl/kernels.py `_skinning_kernel` (entry
// `fused_skinning`), the Pallas kernel that blends each vertex tile's
// per-joint transforms on the MXU ([12, J] @ [J, V_tile] at HIGHEST
// precision) and applies the blended 3x4 transform to the posed vertices.
//
// What bounds it on this card: at B = 256, V = 6890, J = 24 the blend is
// 2 * 12 * 24 * V * B = 1.02 GFLOP of f32 multiply-adds (about 15 us at the
// 67 TFLOP/s of the CUDA cores; tensor cores are not used, TF32 would cost
// the layer its 0.001 mm parity), against 43 MB of vertices in and out
// (about 13 us at 3.35 TB/s). The two are close; the FMAs bound it.
//
// Design: one thread per vertex, one block per 128-vertex tile and per
// chunk of BB batch elements. The block stages its tile of skinning weights
// in shared memory once, transposed to [J][128] so a warp reads 32
// consecutive floats, and the 12 x J transform entries of each of its batch
// elements beside them (read by every thread at the same address, so
// broadcast). Each thread then blends its 12 transform entries in registers
// and applies them: the [B, V, 12] blended tensor never exists. The ragged
// vertex edge (6890 = 53 x 128 + 106) is masked.

#include "common.cuh"

constexpr int SK_TILE = 128;  // vertices per block (one per thread)
constexpr int SK_BB = 8;      // batch elements per block
constexpr int SK_MAXJ = 32;   // joints the shared-memory plan allows

__global__ void __launch_bounds__(SK_TILE)
    skinning_kernel(const float* __restrict__ v_posed,
                    const float* __restrict__ A,  // [B, J, 4, 4]
                    const float* __restrict__ W,  // [V, J]
                    float* __restrict__ out, int B, int V, int J) {
  __shared__ float Wt[SK_MAXJ][SK_TILE];
  __shared__ float As[SK_BB][SK_MAXJ][12];
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * SK_TILE;
  const int b0 = blockIdx.y * SK_BB;
  const int nb = min(SK_BB, B - b0);

  // Weights of this tile: global [v0 .. v0+128) x J is contiguous.
  for (int e = tid; e < SK_TILE * J; e += SK_TILE) {
    const int i = e / J, j = e % J;
    Wt[j][i] = (v0 + i < V) ? W[(size_t)(v0 + i) * J + j] : 0.f;
  }
  // Rows 0..2 of each 4x4 transform of the chunk's batch elements.
  for (int e = tid; e < nb * J * 12; e += SK_TILE) {
    const int bb = e / (J * 12), r = e % (J * 12);
    const int j = r / 12, k = r % 12;
    As[bb][j][k] = A[((size_t)(b0 + bb) * J + j) * 16 + k];
  }
  __syncthreads();

  const int v = v0 + tid;
  if (v >= V) return;
  for (int bb = 0; bb < nb; ++bb) {
    float t[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) t[k] = 0.f;
    for (int j = 0; j < J; ++j) {
      const float w = Wt[j][tid];
#pragma unroll
      for (int k = 0; k < 12; ++k) t[k] = fmaf(w, As[bb][j][k], t[k]);
    }
    const size_t o = ((size_t)(b0 + bb) * V + v) * 3;
    const float x = v_posed[o], y = v_posed[o + 1], z = v_posed[o + 2];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      out[o + m] = fmaf(t[4 * m], x,
                        fmaf(t[4 * m + 1], y,
                             fmaf(t[4 * m + 2], z, t[4 * m + 3])));
  }
}

extern "C" int pmce_skinning(const float* v_posed, const float* A,
                             const float* W, float* out, int B, int V, int J,
                             void* stream) {
  if (J > SK_MAXJ || B <= 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + SK_TILE - 1) / SK_TILE, (B + SK_BB - 1) / SK_BB);
  skinning_kernel<<<grid, SK_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      v_posed, A, W, out, B, V, J);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_skin_error_string)
