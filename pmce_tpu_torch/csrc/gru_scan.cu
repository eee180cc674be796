// The GRU recurrence for Hopper (sm_90a): one launch per time step, for
// serving and for training.
//
// Replaces, in pmce_tpu/ops/fused_attention.py:
// - `_gru_scan_kernel` (entries `fused_gru_layer` and `fused_gru_layer_rev`),
//   the Pallas kernel that runs a whole GRU direction over T with the
//   recurrent weights resident in VMEM and an f32 carry:
//   gh = bf16(h) @ Whh + bhh, then torch's gate math (`gru_step_kernel`);
// - `_gru_scan_save_kernel` (`_fused_gru_layer_fwd`), the same scan that also
//   saves, per step, the f32 entry state h_prev and the gates r, z, n and
//   h_n = W_hn h + b_hn before the reset product (`gru_step_kernel<true>`);
// - `_gru_bwd_kernel` (`_fused_gru_layer_bwd`), the reverse-time scan of the
//   backward: dh = g[t] + carry, the gate gradients dgi = [dr, dz, dn] and
//   dgh = [dr, dz, dn*r] in f32, then carry = dh*z + bf16(dgh) @ Whh^T with
//   f32 sums (`gru_bwd_first_kernel`, `gru_bwd_step_kernel`).
//
// What bounds them on this card: Whh in bf16 is [1024, 3072] = 6 MB, too big
// for shared memory, and the steps are sequential: each one is a
// [B, 1024] x [1024, 3072] product (0.2 GFLOP at B = 32, 1.6 at B = 256)
// that needs the previous step's state from every block. At these sizes the
// launches, not the bytes or the products, set the time.
//
// Design: one launch per time step (the wrapper loops over T), so the
// launch boundary is the grid-wide barrier. Each block owns 16 batch rows
// and 16 hidden units and runs its product on the tensor cores (WMMA
// 16x16x16, f32 sums), split over K among its 4 warps so that enough warps
// are in flight to hide the reads straight from global memory (Whh stays in
// the 50 MB L2 across steps). The epilogue is local to the block:
// - forward: the three gate columns {u, H+u, 2H+u} of bf16(h_prev) @ Whh,
//   then bhh, r, z, n and h_next in f32 (ping-pong buffers) and its bf16
//   rounding, which is both ys[t] and the next step's matrix operand; the
//   saving variant also writes h_prev, r, z, n and h_n of the step;
// - backward: column u of bf16(dgh_t) @ Whh^T over K = 3H (Whh^T read as a
//   column-major view of Whh, no transposed copy), the carry, and then the
//   gate gradients of the step the backward visits next for the same units:
//   every gate gradient of unit u reads only unit u's saved state, so one
//   launch per step suffices, plus one gate-only launch for the last step.
// The reverse direction is the same kernels pointed at row T-1-t by the
// wrapper: no copies. A persistent kernel with a grid barrier is a later
// optimisation.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int KSPLIT = 4;  // warps per block, each one quarter of K

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The saved state of one forward step (f32 [B, H] each, row t of the
// [T, B, H] buffers), written by the saving forward and read by the backward.
struct StepSave {
  float *hprev, *r, *z, *n, *hn;
};

// gi_t [B, 3H] bf16 (this step's input projections), whh [H, 3H] bf16,
// bhh [3H] f32, h_prev [B, H] f32, hb_prev [Bp, H] bf16 (bf16(h_prev), rows
// >= B zero), outputs h_next, hb_next, ys_t [B, H] and, with SAVE, the step's
// state. One block per tile of 16 rows x 16 units; its KSPLIT warps each sum
// a slice of K, and the partial sums meet in shared memory before the gate
// epilogue.
template <bool SAVE>
__global__ void __launch_bounds__(KSPLIT * 32)
    gru_step_kernel(const bf16* gi_t, const bf16* whh, const float* bhh,
                    const float* h_prev, const bf16* hb_prev, float* h_next,
                    bf16* hb_next, bf16* ys_t, StepSave save, int B, int H) {
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
    const float hp = h_prev[o];
    const float hnew = (1.0f - zg) * ng + zg * hp;
    const bf16 hb = f2bf(hnew);
    h_next[o] = hnew;
    hb_next[o] = hb;
    ys_t[o] = hb;
    if constexpr (SAVE) {
      // h_n is saved before the reset product: the backward's dr reads it.
      save.hprev[o] = hp;
      save.r[o] = rg;
      save.z[o] = zg;
      save.n[o] = ng;
      save.hn[o] = gh[2];
    }
  }
}

// What the backward reads at one step: g = dL/dys[t] (bf16 [B, H]) and the
// forward's saved state of that step.
struct StepState {
  const bf16* g;
  const float *hprev, *r, *z, *n, *hn;
};

// What it writes at one step: dgi and dgh (f32 [B, 3H]) and dgh rounded to
// bf16 (the next launch's matrix operand, [Bp, 3H], rows >= B zero).
struct StepGrads {
  float *dgi, *dgh;
  bf16* dghb;
};

// The gate gradients at (row, u) given dh = dL/dh_t, in the order of
// operations of `_gru_bwd_kernel` (fused_attention.py:2462-2467).
__device__ __forceinline__ void gate_grads(float dh, int row, int u, int H,
                                           const StepState& s,
                                           const StepGrads& d) {
  const size_t o = (size_t)row * H + u;
  const float hp = s.hprev[o], r = s.r[o], z = s.z[o], n = s.n[o];
  const float hn = s.hn[o];
  const float dz = dh * (hp - n);
  const float dn = (dh * (1.0f - z)) * (1.0f - n * n);
  const float dr = (dn * hn) * (r * (1.0f - r));
  const float dzp = dz * (z * (1.0f - z));
  const float dnr = dn * r;
  const size_t o3 = (size_t)row * 3 * H + u;
  d.dgi[o3] = dr;
  d.dgi[o3 + H] = dzp;
  d.dgi[o3 + 2 * H] = dn;
  d.dgh[o3] = dr;
  d.dgh[o3 + H] = dzp;
  d.dgh[o3 + 2 * H] = dnr;
  d.dghb[o3] = f2bf(dr);
  d.dghb[o3 + H] = f2bf(dzp);
  d.dghb[o3 + 2 * H] = f2bf(dnr);
}

// The first step of the backward (the forward's last): no carry yet, so
// dh = g; writes dh [B, H] f32 for the next launch.
__global__ void gru_bwd_first_kernel(StepState s, StepGrads d, float* dh,
                                     int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const float v = bf2f(s.g[i]);
  dh[i] = v;
  gate_grads(v, i / H, i % H, H, s, d);
}

// One later step. In: dghb_t = bf16(dgh) of the step just done (all units),
// z_t its saved z, dh its dL/dh. The block's 16 x 16 tile of
// carry = dh * z + dghb_t @ Whh^T becomes dL/dh of the step visited next
// (dh = g + carry, in place), whose gate gradients `nx` / `dnx` it writes.
__global__ void __launch_bounds__(KSPLIT * 32)
    gru_bwd_step_kernel(const bf16* dghb_t, const bf16* whh,
                        const float* z_t, float* dh, StepState nx,
                        StepGrads dnx, int B, int H) {
  __shared__ __align__(32) float part[KSPLIT][16 * 16];
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * 16, r0 = blockIdx.y * 16;
  const int H3 = 3 * H;
  const int kspan = H3 / KSPLIT, k_begin = warp * kspan;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
  for (int k = k_begin; k < k_begin + kspan; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, dghb_t + (size_t)r0 * H3 + k, H3);
    // Whh^T [3H, H] at (k, u) is whh[u * 3H + k]: a column-major tile.
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> w;
    wmma::load_matrix_sync(w, whh + (size_t)u0 * H3 + k, H3);
    wmma::mma_sync(acc, a, w, acc);
  }
  wmma::store_matrix_sync(part[warp], acc, 16, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < 256; e += KSPLIT * 32) {
    const int r = r0 + e / 16, u = u0 + e % 16;
    if (r >= B) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < KSPLIT; ++w) sum += part[w][e];
    const size_t o = (size_t)r * H + u;
    const float carry = dh[o] * z_t[o] + sum;
    const float dhn = bf2f(nx.g[o]) + carry;
    dh[o] = dhn;
    gate_grads(dhn, r, u, H, nx, dnx);
  }
}

// Both products split K (H forward, 3H backward) into KSPLIT spans of whole
// 16-wide steps, and the grid tiles H and Bp by 16.
static bool step_shapes_ok(int B, int Bp, int H) {
  return H % (16 * KSPLIT) == 0 && Bp % 16 == 0 && Bp >= B && B > 0;
}

template <bool SAVE>
static int launch_step(const void* gi_t, const void* whh, const float* bhh,
                       const float* h_prev, const void* hb_prev,
                       float* h_next, void* hb_next, void* ys_t,
                       StepSave save, int B, int Bp, int H, void* stream) {
  if (!step_shapes_ok(B, Bp, H))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H / 16, Bp / 16);
  gru_step_kernel<SAVE><<<grid, KSPLIT * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gi_t), static_cast<const bf16*>(whh), bhh,
      h_prev, static_cast<const bf16*>(hb_prev), h_next,
      static_cast<bf16*>(hb_next), static_cast<bf16*>(ys_t), save, B, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmce_gru_step(const void* gi_t, const void* whh,
                             const float* bhh, const float* h_prev,
                             const void* hb_prev, float* h_next,
                             void* hb_next, void* ys_t, int B, int Bp, int H,
                             void* stream) {
  return launch_step<false>(gi_t, whh, bhh, h_prev, hb_prev, h_next, hb_next,
                            ys_t, StepSave{}, B, Bp, H, stream);
}

extern "C" int pmce_gru_step_save(const void* gi_t, const void* whh,
                                  const float* bhh, const float* h_prev,
                                  const void* hb_prev, float* h_next,
                                  void* hb_next, void* ys_t, float* s_hprev,
                                  float* s_r, float* s_z, float* s_n,
                                  float* s_hn, int B, int Bp, int H,
                                  void* stream) {
  return launch_step<true>(gi_t, whh, bhh, h_prev, hb_prev, h_next, hb_next,
                           ys_t, StepSave{s_hprev, s_r, s_z, s_n, s_hn}, B,
                           Bp, H, stream);
}

extern "C" int pmce_gru_bwd_first(const void* g, const float* hprev,
                                  const float* r, const float* z,
                                  const float* n, const float* hn,
                                  float* dgi, float* dgh, void* dghb,
                                  float* dh, int B, int H, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256, blocks = (B * H + threads - 1) / threads;
  gru_bwd_first_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      StepState{static_cast<const bf16*>(g), hprev, r, z, n, hn},
      StepGrads{dgi, dgh, static_cast<bf16*>(dghb)}, dh, B, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmce_gru_bwd_step(const void* dghb_t, const void* whh,
                                 const float* z_t, float* dh, const void* g,
                                 const float* hprev, const float* r,
                                 const float* z, const float* n,
                                 const float* hn, float* dgi, float* dgh,
                                 void* dghb_next, int B, int Bp, int H,
                                 void* stream) {
  if (!step_shapes_ok(B, Bp, H))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H / 16, Bp / 16);
  gru_bwd_step_kernel<<<grid, KSPLIT * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dghb_t), static_cast<const bf16*>(whh), z_t,
      dh, StepState{static_cast<const bf16*>(g), hprev, r, z, n, hn},
      StepGrads{dgi, dgh, static_cast<bf16*>(dghb_next)}, B, H);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_gru_error_string)
