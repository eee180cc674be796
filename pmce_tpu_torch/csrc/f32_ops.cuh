// f32 pieces shared by the f32 training kernels (csrc/block_f32.cu,
// csrc/mhsa_f32.cu, csrc/ada_f32.cu, csrc/ca_f32.cu): the weight products'
// transposes and the weight gradients dW = A^T dY with the vector
// gradients' sums over tiles, in true f32 (FFMA on the CUDA cores, no
// TF32); every sum in a fixed order: no atomics, so a rerun gives the same
// bits. The decoder blocks' other programs run on the tensor cores
// (csrc/dec_tc32.cuh).
//
// Weight gradients: one launch of 64 x 64 output tiles of every job (a
// job is one dW = A^T dY over M rows), each tile's M rows cut into
// `splits` fixed ranges, one CTA a (tile, range), its partial sum written
// to a workspace; a second launch adds the ranges in order and sums the
// per-tile vector partials ([vtiles, vlen], row by row in order). A CTA's
// 256 threads own 4 x 4 outputs each; a 32-row chunk of A's and dY's 64
// columns is staged in shared memory (16 KB) and every value read there
// feeds 4 FMAs.
#pragma once

namespace f32ops {

constexpr int WT = 64;    // output tile edge
constexpr int WK = 32;    // rows of a staged chunk
constexpr int WNT = 256;  // threads of a weight-gradient CTA
constexpr int MAX_JOBS = 4;
constexpr int WSMEM = 2 * WK * WT * 4;

struct Job {
  const float* A;  // [M, K]
  const float* Y;  // [M, Ncol]
  float* out;      // [K, Ncol]
  int K, Ncol;
};

struct Jobs {
  Job job[MAX_JOBS];
  int n;
  int first[MAX_JOBS + 1];  // the first tile of each job; first[n] = tiles
  int M, splits;
  float* ws;                // [splits, tiles, WT * WT]
  const float* vpart;       // [vtiles, vlen] or null
  float* vout;              // [vlen]
  int vtiles, vlen;
};

__global__ void __launch_bounds__(WNT) wgrad_partial_kernel(Jobs J) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [WK][WT]
  float* Ys = As + WK * WT;                    // [WK][WT]
  const int tile = blockIdx.x, split = blockIdx.y;
  int jb = 0;
  while (tile >= J.first[jb + 1]) ++jb;
  const Job& jo = J.job[jb];
  const int local = tile - J.first[jb];
  const int ntn = jo.Ncol / WT;
  const int k0 = local / ntn * WT, n0 = local % ntn * WT;
  const int m_begin = (int)((long long)J.M * split / J.splits);
  const int m_end = (int)((long long)J.M * (split + 1) / J.splits);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int m0 = m_begin; m0 < m_end; m0 += WK) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid * 2 + q;  // a float4 slot of the 32 x 16 chunk
      const int row = e >> 4, c4 = (e & 15) * 4;
      const int m = m0 + row;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), y = a;
      if (m < m_end) {
        a = *reinterpret_cast<const float4*>(jo.A + (size_t)m * jo.K + k0 +
                                             c4);
        y = *reinterpret_cast<const float4*>(jo.Y + (size_t)m * jo.Ncol +
                                             n0 + c4);
      }
      *reinterpret_cast<float4*>(As + row * WT + c4) = a;
      *reinterpret_cast<float4*>(Ys + row * WT + c4) = y;
    }
    __syncthreads();
#pragma unroll 4
    for (int mm = 0; mm < WK; ++mm) {
      const float4 a = *reinterpret_cast<const float4*>(As + mm * WT + ty * 4);
      const float4 y = *reinterpret_cast<const float4*>(Ys + mm * WT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = J.ws + ((size_t)split * J.first[J.n] + tile) * (WT * WT);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (ty * 4 + i) * WT + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The ranges' partials added in order into each job's dW, and the vector
// partials summed over their tiles in order.
__global__ void __launch_bounds__(WNT) wgrad_reduce_kernel(Jobs J) {
  const int tiles = J.first[J.n];
  const long long outs = (long long)tiles * WT * WT;
  const long long idx = (long long)blockIdx.x * WNT + threadIdx.x;
  if (idx < outs) {
    const int tile = (int)(idx / (WT * WT)), e = (int)(idx % (WT * WT));
    int jb = 0;
    while (tile >= J.first[jb + 1]) ++jb;
    const Job& jo = J.job[jb];
    const int local = tile - J.first[jb];
    const int ntn = jo.Ncol / WT;
    const int k = local / ntn * WT + e / WT, n = local % ntn * WT + e % WT;
    float s = 0.f;
    for (int sp = 0; sp < J.splits; ++sp)
      s += J.ws[((size_t)sp * tiles + tile) * (WT * WT) + e];
    jo.out[(size_t)k * jo.Ncol + n] = s;
  } else if (idx - outs < J.vlen) {
    const int l = (int)(idx - outs);
    float s = 0.f;
    for (int t = 0; t < J.vtiles; ++t) s += J.vpart[(size_t)t * J.vlen + l];
    J.vout[l] = s;
  }
}

// Transposes of up to four row-major matrices, 32 x 32 tiles through
// shared memory (a padded [32][33] tile: no bank conflicts).
struct Transposes {
  const float* in[MAX_JOBS];
  float* out[MAX_JOBS];
  int rows[MAX_JOBS], cols[MAX_JOBS];
  int first[MAX_JOBS + 1];  // the first tile of each matrix
  int n;
};

constexpr int TT = 32;
constexpr int TSMEM = TT * (TT + 1) * 4;

__global__ void __launch_bounds__(WNT) transpose_kernel(Transposes T) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  int jb = 0;
  while ((int)blockIdx.x >= T.first[jb + 1]) ++jb;
  const int local = blockIdx.x - T.first[jb];
  const int rows = T.rows[jb], cols = T.cols[jb];
  const int tcols = (cols + TT - 1) / TT;
  const int r0 = local / tcols * TT, c0 = local % tcols * TT;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < TT; i += WNT / 32) {
    const int r = r0 + i, c = c0 + tx;
    if (r < rows && c < cols)
      tile[i * (TT + 1) + tx] = T.in[jb][(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = ty; i < TT; i += WNT / 32) {
    const int c = c0 + i, r = r0 + tx;
    if (r < rows && c < cols)
      T.out[jb][(size_t)c * rows + r] = tile[tx * (TT + 1) + i];
  }
}

// Host side: launch the transposes of n matrices.
inline cudaError_t launch_transposes(Transposes T, cudaStream_t stream) {
  T.first[0] = 0;
  for (int i = 0; i < T.n; ++i)
    T.first[i + 1] = T.first[i] + ((T.rows[i] + TT - 1) / TT) *
                                      ((T.cols[i] + TT - 1) / TT);
  transpose_kernel<<<T.first[T.n], WNT, TSMEM, stream>>>(T);
  return cudaGetLastError();
}

// Host side: both weight-gradient launches. Every job's K and Ncol must
// be multiples of 64.
inline cudaError_t launch_wgrad(Jobs J, cudaStream_t stream) {
  J.first[0] = 0;
  for (int i = 0; i < J.n; ++i) {
    if (J.job[i].K % WT || J.job[i].Ncol % WT)
      return cudaErrorInvalidValue;
    J.first[i + 1] = J.first[i] + J.job[i].K / WT * (J.job[i].Ncol / WT);
  }
  if (J.splits <= 0 || J.M <= 0) return cudaErrorInvalidValue;
  wgrad_partial_kernel<<<dim3(J.first[J.n], J.splits), WNT, WSMEM,
                         stream>>>(J);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = (long long)J.first[J.n] * WT * WT + J.vlen;
  wgrad_reduce_kernel<<<(int)((total + WNT - 1) / WNT), WNT, 0, stream>>>(J);
  return cudaGetLastError();
}

}  // namespace f32ops
