// One step of a GRU direction for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_gru_scan_kernel` (entries
// `fused_gru_layer` and `fused_gru_layer_rev`), the Pallas kernel that runs
// a whole GRU direction over T with the recurrent weights resident in VMEM
// and an f32 carry: gh = bf16(h) @ Whh + bhh, then torch's gate math.
//
// What bounds it on this card: Whh in bf16 is [1024, 3072] = 6 MB, too big
// for shared memory, and the steps are sequential: each one is a
// [B, 1024] x [1024, 3072] product (1.6 GFLOP at B = 256) that needs the
// previous step's h from every block.
//
// Design: one launch per time step (the wrapper loops over T), so the
// launch boundary is the grid-wide barrier. Each block owns 16 batch rows
// and 16 hidden units j and computes the three gate columns {j, H+j, 2H+j}
// of bf16(h_prev) @ Whh on the tensor cores (WMMA 16x16x16, f32 sums),
// split over K among its 4 warps so that enough warps are in flight to hide
// the reads of h_prev and Whh straight from global memory (Whh stays in the
// 50 MB L2 across steps). The gate epilogue is then local to the block: it
// adds bhh in f32, applies r, z, n, writes h_next in f32 (ping-pong
// buffers) and its bf16 rounding, which is both ys[t] and the next step's
// matrix operand. The reverse direction is the same kernel pointed at row
// T-1-t by the wrapper: no copies. A persistent kernel with a grid barrier
// is a later optimisation.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int KSPLIT = 4;  // warps per block, each one quarter of K

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// gi_t [B, 3H] bf16 (this step's input projections), whh [H, 3H] bf16,
// bhh [3H] f32, h_prev [B, H] f32, hb_prev [Bp, H] bf16 (bf16(h_prev), rows
// >= B zero), outputs h_next, hb_next, ys_t [B, H]. One block per tile of
// 16 rows x 16 units; its KSPLIT warps each sum a slice of K, and the
// partial sums meet in shared memory before the gate epilogue.
__global__ void __launch_bounds__(KSPLIT * 32)
    gru_step_kernel(const bf16* gi_t, const bf16* whh, const float* bhh,
                    const float* h_prev, const bf16* hb_prev, float* h_next,
                    bf16* hb_next, bf16* ys_t, int B, int H) {
  __shared__ __align__(32) float part[KSPLIT][3][16 * 16];
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * 16, r0 = blockIdx.y * 16;
  const int H3 = 3 * H;
  const int kspan = H / KSPLIT, k_begin = warp * kspan;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) wmma::fill_fragment(acc[g], 0.f);
#pragma unroll 4
  for (int k = k_begin; k < k_begin + kspan; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, hb_prev + (size_t)r0 * H + k, H);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w;
      wmma::load_matrix_sync(w, whh + (size_t)k * H3 + g * H + u0, H3);
      wmma::mma_sync(acc[g], a, w, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
    wmma::store_matrix_sync(part[warp][g], acc[g], 16, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < 256; e += KSPLIT * 32) {
    const int r = r0 + e / 16, u = u0 + e % 16;
    if (r >= B) continue;
    float gh[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < KSPLIT; ++w) sum += part[w][g][e];
      gh[g] = sum + bhh[g * H + u];
    }
    const bf16* gir = gi_t + (size_t)r * H3;
    const float rg = sigmoid_f32(bf2f(gir[u]) + gh[0]);
    const float zg = sigmoid_f32(bf2f(gir[H + u]) + gh[1]);
    const float ng = tanhf(bf2f(gir[2 * H + u]) + rg * gh[2]);
    const size_t o = (size_t)r * H + u;
    const float hnew = (1.0f - zg) * ng + zg * h_prev[o];
    const bf16 hb = f2bf(hnew);
    h_next[o] = hnew;
    hb_next[o] = hb;
    ys_t[o] = hb;
  }
}

extern "C" int pmce_gru_step(const void* gi_t, const void* whh,
                             const float* bhh, const float* h_prev,
                             const void* hb_prev, float* h_next,
                             void* hb_next, void* ys_t, int B, int Bp, int H,
                             void* stream) {
  if (H % (16 * KSPLIT) != 0 || Bp % 16 != 0 || Bp < B)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H / 16, Bp / 16);
  gru_step_kernel<<<grid, KSPLIT * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gi_t), static_cast<const bf16*>(whh), bhh,
      h_prev, static_cast<const bf16*>(hb_prev), h_next,
      static_cast<bf16*>(hb_next), static_cast<bf16*>(ys_t), B, H);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_gru_error_string)
