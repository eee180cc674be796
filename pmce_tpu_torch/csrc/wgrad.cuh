// The weight-gradient launch shared by the block backward (block.cu) and
// the cross-attention block backward (ca_block.cu): dW = X^T dY for NPROD
// products in one launch.
//
// A work list of WT x WT output tiles of the products, each cut into
// `splits` fixed K ranges of its product's M rows; a CTA of 8 warps
// computes one (tile, range) with mma.sync (ldmatrix.trans of both [k, *]
// operands, a 3-stage cp.async ring of 32-row K steps) and writes its f32
// partial tile; the CTA that finishes a tile's last range (an integer
// counter, no float atomics) adds the ranges' partials in range order.
// Bias gradients, by either of two routes:
// - `vpartial` set: the CTAs on a product's first row of tiles also sum
//   their columns of dY over their range, and the last CTA adds those in
//   range order into `mat + voff[p]`;
// - `vpart` set: CTAs past the tiles add [vtiles, L] vector partials (a
//   tile program's) in tile order into `vec`.
// Reruns are bit-identical.

#pragma once

#include "transformer_ops.cuh"

namespace wg {

using namespace pmce;

constexpr int NTH = 256;  // 8 warps
constexpr int BK = 32, STAGES = 3;

template <int WT>
constexpr int smem_bytes() {
  return STAGES * 2 * BK * (WT + 8) * 2;
}

template <int NPROD>
struct Args {
  const bf16* X[NPROD];   // [M_p, mo_p]
  const bf16* G[NPROD];   // [M_p, n_p]
  int M[NPROD], mo[NPROD], n[NPROD];
  long long off[NPROD];   // the weight's offset into mat
  long long voff[NPROD];  // the bias's offset into mat (with vpartial)
  int tile0[NPROD + 1];   // first tile of each product (the last: total)
  int splits;
  float* partial;         // [tiles * splits, WT * WT]
  int* counters;          // [tiles], zero at launch
  float* mat;             // the gradients, concatenated
  float* vpartial;        // [tiles * splits, WT], or null
  const float* vpart;     // [vtiles, L], or null
  int vtiles, L;
  float* vec;             // [L]
};

// Warp tile (WT / WM) x 32: WT = 128 as 2 x 4 warps, WT = 64 as 4 x 2.
template <int WT, int NPROD>
__global__ void __launch_bounds__(NTH, 1) wgrad_kernel(const Args<NPROD> a) {
  constexpr int LD = WT + 8, WN = WT / 32, WM = 8 / WN, MI = WT / WM / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int items = a.tile0[NPROD] * a.splits;
  if ((int)blockIdx.x >= items) {
    // Vector partials, a column a thread, tiles added in order.
    const int c = (blockIdx.x - items) * NTH + tid;
    if (c < a.L) {
      float s = 0.f;
      for (int t = 0; t < a.vtiles; ++t) s += a.vpart[(size_t)t * a.L + c];
      a.vec[c] = s;
    }
    return;
  }
  const int tile = blockIdx.x / a.splits, z = blockIdx.x % a.splits;
  int p = 0;
  while (tile >= a.tile0[p + 1]) ++p;
  const int nt_n = a.n[p] / WT;
  const int tt = tile - a.tile0[p];
  const int m0 = tt / nt_n * WT, n0 = tt % nt_n * WT;
  const int mo = a.mo[p], nn = a.n[p], M = a.M[p];
  const bool sums = a.vpartial != nullptr && m0 == 0;
  const bf16* X = a.X[p];
  const bf16* G = a.G[p];
  const int kchunk = ((M + a.splits - 1) / a.splits + BK - 1) / BK * BK;
  const int k_beg = min(M, z * kchunk), k_end = min(M, k_beg + kchunk);
  const int steps = (k_end - k_beg + BK - 1) / BK;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + STAGES * BK * LD;
  const int wm = warp / WN, wn = warp % WN;

  auto issue = [&](int st) {
    if (st < steps) {
      const int k0 = k_beg + st * BK;
      bf16* xd = xs + (st % STAGES) * BK * LD;
      bf16* gd = gs + (st % STAGES) * BK * LD;
      for (int c = tid; c < BK * (WT / 8); c += NTH) {
        const int r = c / (WT / 8), cc = c % (WT / 8) * 8;
        const bool ok = k0 + r < k_end;
        const size_t row = ok ? k0 + r : 0;
        cp_async16(xd + r * LD + cc, X + row * mo + m0 + cc, ok);
        cp_async16(gd + r * LD + cc, G + row * nn + n0 + cc, ok);
      }
    }
    cp_async_commit();
  };
  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float csum = 0.f;  // thread tid < WT: column n0 + tid of dY
  issue(0);
  issue(1);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait_one();
    __syncthreads();
    issue(st + 2);
    const bf16* xb = xs + (st % STAGES) * BK * LD;
    const bf16* gb = gs + (st % STAGES) * BK * LD;
    if (sums && tid < WT)
      for (int r = 0; r < BK; ++r) csum += bf2f(gb[r * LD + tid]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MI][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4_t(af[i], xb + (kk + (lane & 7) + ((lane >> 4) << 3)) * LD +
                             wm * (WT / WM) + i * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jb = 0; jb < 2; ++jb)
        ldsm_x4_t(bf[jb], gb + (kk + (lane & 15)) * LD + wn * 32 + jb * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
          mma_bf16(acc[i][2 * jb], af[i], bf[jb][0], bf[jb][1]);
          mma_bf16(acc[i][2 * jb + 1], af[i], bf[jb][2], bf[jb][3]);
        }
    }
  }
  cp_async_wait_none();
  // This range's partial tile, row-major WT x WT.
  float* mine = a.partial + (size_t)blockIdx.x * WT * WT;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm * (WT / WM) + i * 16 + g + 8 * hf;
        const int c = wn * 32 + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(mine + r * WT + c) =
            make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
      }
  if (sums && tid < WT) a.vpartial[(size_t)blockIdx.x * WT + tid] = csum;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* base = a.partial + (size_t)tile * a.splits * WT * WT;
  for (int e = tid; e < WT * WT / 4; e += NTH) {
    float4 s = __ldcg(reinterpret_cast<const float4*>(base) + e);
    for (int k = 1; k < a.splits; ++k) {
      const float4 q = __ldcg(
          reinterpret_cast<const float4*>(base + (size_t)k * WT * WT) + e);
      s.x += q.x, s.y += q.y, s.z += q.z, s.w += q.w;
    }
    const int r = e * 4 / WT, c = e * 4 % WT;
    *reinterpret_cast<float4*>(a.mat + a.off[p] + (size_t)(m0 + r) * nn +
                               n0 + c) = s;
  }
  if (sums && tid < WT) {
    const float* vb = a.vpartial + (size_t)tile * a.splits * WT + tid;
    float s = 0.f;
    for (int k = 0; k < a.splits; ++k) s += __ldcg(vb + (size_t)k * WT);
    a.mat[a.voff[p] + n0 + tid] = s;
  }
}

// Fills the products' tiles, offsets (each weight, then its bias with
// `vpartial`) and splits, and launches over the tiles plus `extra` CTAs
// (for the vector partials).
template <int WT, int NPROD>
int launch_wgrad(Args<NPROD>& a, const int (&M)[NPROD],
                 const int (&mo)[NPROD], const int (&n)[NPROD], int splits,
                 int extra, cudaStream_t s) {
  long long off = 0;
  a.tile0[0] = 0;
  for (int p = 0; p < NPROD; ++p) {
    a.M[p] = M[p];
    a.mo[p] = mo[p];
    a.n[p] = n[p];
    a.off[p] = off;
    off += (long long)mo[p] * n[p];
    a.voff[p] = off;
    if (a.vpartial) off += n[p];
    a.tile0[p + 1] = a.tile0[p] + (mo[p] / WT) * (n[p] / WT);
  }
  a.splits = splits;
  const auto kernel = wgrad_kernel<WT, NPROD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<WT>());
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<a.tile0[NPROD] * splits + extra, NTH, smem_bytes<WT>(), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
