// f32 pieces shared by the f32 training kernels (csrc/block_f32.cu,
// csrc/mhsa_f32.cu, csrc/ada_f32.cu, csrc/ca_f32.cu, and through
// csrc/dec_tc32.cuh csrc/coevo_f32.cu): the 3xTF32 k-step (mma3), the
// weight products' transposes and the weight gradients dW = A^T dY with
// the vector gradients' sums over tiles; every sum in a fixed order: no
// atomics, so a rerun gives the same bits.
//
// 3xTF32 (common.cuh's tc32): an f32 operand is split as hi = tf32(v) (to
// nearest, ties away) and lo = v - hi; a product sums a_lo b_hi + a_hi b_lo
// + a_hi b_hi. Each 8-wide k-step is summed from zero in the tensor cores
// and added to the f32 accumulator by an ordinary rounded add (the tensor
// cores add with truncation; a whole K summed in them biased the f32
// blocks' outputs past their gate).
//
// Weight gradients (rows 5f, 7f, 9f, 11f): one launch over output tiles of
// every job (a job is one dW = A^T dY over M rows), each tile's M rows cut
// into `splits` fixed ranges (the wrappers' f32_wgrad_plan: enough to fill
// the card twice), one CTA a (tile, range), its partial written to a
// workspace of 64 x 64 sub-tiles; a second launch adds the ranges in range
// order and sums the per-tile vector partials ([vtiles, vlen], row by row
// in order). The products run as 3xTF32 mma.sync m16n8k8: dW's k is the
// mma's row, A's and dY's rows m its inner index, 8 rows a k-step. A CTA's
// 8 warps own 32 x 64 outputs each (two 16-row blocks: every dY fragment
// split once feeds both), arranged by the job's shape (tile_shape): 128 x
// 128 tiles where K and Ncol allow, else 128 x 64, 64 x 128 or 64 x 64, the
// warps of the narrower ones also splitting a chunk's k-steps in 2 or 4
// groups, added in group order at the end. The tile's size sets how often
// A and dY are read: at row 7f's Stage-1 jobs 128 x 128 tiles read them
// ~2.9x (64 x 64: 5.8x). 32-row chunks of A's and dY's tile columns are
// staged through a 3-stage cp.async ring (rows padded to 8 floats past a
// multiple of 32: the fragment reads, 4 rows x 8 columns, fall on 32
// banks), two chunks' copies in flight behind the current one's products;
// the copies' indices are shifts (a staged row is 16, or 32, 16-byte
// pieces): computed by division they took as many issue slots as the
// products, and the two stopped overlapping. 104,448 B of shared memory,
// one CTA an SM: 200 registers (at two an SM, 128, it spilled).
#pragma once

namespace f32ops {

// d += the k-step's three products, summed from zero, then one rounded add.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], float b0,
                                     float b1) {
  unsigned bh0, bl0, bh1, bl1;
  tc32::split_tf32(b0, bh0, bl0);
  tc32::split_tf32(b1, bh1, bl1);
  float k8[4] = {0.f, 0.f, 0.f, 0.f};
  tc32::mma_tf32(k8, al, bh0, bh1);
  tc32::mma_tf32(k8, ah, bl0, bl1);
  tc32::mma_tf32(k8, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += k8[i];
}

constexpr int WT = 64;      // edge of a workspace sub-tile
constexpr int WK = 32;      // rows of a staged chunk
constexpr int WNT = 256;    // threads of a weight-gradient CTA (8 warps)
constexpr int WSTAGES = 3;
constexpr int WCOLS = 256;  // the most staged columns a row (A's and dY's)
constexpr int WSTAGE = WK * (WCOLS + 16);
constexpr int WSMEM = WSTAGES * WSTAGE * 4;
constexpr int MAX_JOBS = 4;

struct Job {
  const float* A;  // [M, K]
  const float* Y;  // [M, Ncol]
  float* out;      // [K, Ncol]
  int K, Ncol;
};

struct Jobs {
  Job job[MAX_JOBS];
  int n;
  int first[MAX_JOBS + 1];   // each job's first 64 x 64 sub-tile
  int tfirst[MAX_JOBS + 1];  // each job's first CTA tile
  int M, splits;
  float* ws;                 // [splits, sub-tiles, WT * WT]
  const float* vpart;        // [vtiles, vlen] or null
  float* vout;               // [vlen]
  int vtiles, vlen;
};

// A CTA tile of dW: wr x wc warps of 32 x 64 outputs (a tile of 32 wr x
// 64 wc), wm groups of them taking a chunk's 8-row k-steps in turn (their
// sums added in group order at the end).
struct TileShape {
  int wr, wc, wm;
};

__host__ __device__ inline TileShape tile_shape(int K, int Ncol) {
  if (K % 128 == 0 && Ncol % 128 == 0) return {4, 2, 1};
  if (K % 128 == 0) return {4, 1, 2};
  if (Ncol % 128 == 0) return {2, 2, 2};
  return {2, 1, 4};
}

__global__ void __launch_bounds__(WNT, 1) wgrad_partial_kernel(Jobs J) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const int tile = blockIdx.x, split = blockIdx.y;
  int jb = 0;
  while (tile >= J.tfirst[jb + 1]) ++jb;
  const Job& jo = J.job[jb];
  const TileShape ts = tile_shape(jo.K, jo.Ncol);
  const int tk = 32 * ts.wr, tn = 64 * ts.wc;
  const int local = tile - J.tfirst[jb];
  const int k0 = local / (jo.Ncol / tn) * tk;
  const int n0 = local % (jo.Ncol / tn) * tn;
  const int m0 = (int)((long long)J.M * split / J.splits);
  const int m1 = (int)((long long)J.M * (split + 1) / J.splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pertile = ts.wr * ts.wc;
  const int wm = warp / pertile, wr = warp % pertile % ts.wr,
            wc = warp % pertile / ts.wr;
  const int lda = tk + 8, ldy = tn + 8;  // 8 past a multiple of 32: the
                                         // fragment reads on 32 banks
  // 16-byte pieces of a staged row, 2^la of A's and 2^ly of dY's.
  const int la = tk == 128 ? 5 : 4, ly = tn == 128 ? 5 : 4;
  const int chunks = (m1 - m0 + WK - 1) / WK;

  auto stage_rows = [&](float* dst, int ld, int l, const float* src,
                        int sld, int rows) {
    for (int e = threadIdx.x; e < WK << l; e += WNT) {
      const int row = e >> l, col = (e & ((1 << l) - 1)) << 2;
      float* d = dst + row * ld + col;
      if (row < rows)
        tc32::cp_async16(d, src + (size_t)row * sld + col);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const float* A0 = jo.A + (size_t)m0 * jo.K + k0;
  const float* Y0 = jo.Y + (size_t)m0 * jo.Ncol + n0;
  // The warp's 32 x 64 outputs go to its 64 x 64 sub-tile of the workspace.
  float* out = J.ws +
               ((size_t)split * J.first[J.n] + J.first[jb] +
                (k0 + 32 * wr) / WT * (jo.Ncol / WT) + (n0 + 64 * wc) / WT) *
                   (WT * WT) +
               (32 * wr) % WT * WT;
  // The chunk's k-steps this warp's group takes (bit ms).
  const unsigned mine = ts.wm == 1 ? 0xfu : ts.wm == 2 ? 0x5u << wm
                                                      : 0x1u << wm;
  // The fragments' offsets in a stage (see below).
  const int aoff = t * lda + 32 * wr + g, yoff = WK * lda + t * ldy +
                                                 64 * wc + g;
  auto issue = [&](int c) {
    if (c < chunks) {
      float* As = buf + (c % WSTAGES) * WSTAGE;
      const int rows = min(WK, m1 - m0 - c * WK);
      stage_rows(As, lda, la, A0 + (size_t)c * WK * jo.K, jo.K, rows);
      stage_rows(As + WK * lda, ldy, ly, Y0 + (size_t)c * WK * jo.Ncol,
                 jo.Ncol, rows);
    }
    tc32::cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[2][8][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0.f;
#pragma unroll
  for (int c = 0; c < WSTAGES - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    tc32::cp_async_wait_group<WSTAGES - 2>();  // chunk c has landed
    __syncthreads();  // everyone's copies; chunk c - 1's stage is free
    issue(c + WSTAGES - 1);
    const float* st = buf + (c % WSTAGES) * WSTAGE;
#pragma unroll
    for (int ms = 0; ms < WK / 8; ++ms) {
      if (!(mine >> ms & 1u)) continue;
      // A^T's fragments of the warp's two 16-row blocks: (k g, m t), (g +
      // 8, t), (g, t + 4), (g + 8, t + 4); dY's: (m t, n g), (t + 4, g).
      const float* a = st + aoff + 8 * ms * lda;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        tc32::split_tf32(a[16 * mb], ah[mb][0], al[mb][0]);
        tc32::split_tf32(a[16 * mb + 8], ah[mb][1], al[mb][1]);
        tc32::split_tf32(a[4 * lda + 16 * mb], ah[mb][2], al[mb][2]);
        tc32::split_tf32(a[4 * lda + 16 * mb + 8], ah[mb][3], al[mb][3]);
      }
      const float* y = st + yoff + 8 * ms * ldy;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        unsigned bh0, bl0, bh1, bl1;
        tc32::split_tf32(y[8 * nb], bh0, bl0);
        tc32::split_tf32(y[4 * ldy + 8 * nb], bh1, bl1);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          float k8[4] = {0.f, 0.f, 0.f, 0.f};
          tc32::mma_tf32(k8, al[mb], bh0, bh1);
          tc32::mma_tf32(k8, ah[mb], bl0, bl1);
          tc32::mma_tf32(k8, ah[mb], bh0, bh1);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mb][nb][i] += k8[i];
        }
      }
    }
  }
  if (ts.wm > 1) {
    // The groups' sums added in group order, through the spent stages.
    __syncthreads();
    float* red = buf + (size_t)((wm - 1) * pertile + warp % pertile) * 2048;
    if (wm > 0)
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[((mb * 8 + nb) * 4 + i) * 32 + lane] = acc[mb][nb][i];
    __syncthreads();
    if (wm == 0)
      for (int w = 1; w < ts.wm; ++w) {
        const float* r = buf + (size_t)((w - 1) * pertile + warp) * 2048;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mb][nb][i] += r[((mb * 8 + nb) * 4 + i) * 32 + lane];
      }
  }
  if (wm != 0) return;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float* o = out + (16 * mb + g) * WT + 8 * nb + 2 * t;
      *reinterpret_cast<float2*>(o) =
          make_float2(acc[mb][nb][0], acc[mb][nb][1]);
      *reinterpret_cast<float2*>(o + 8 * WT) =
          make_float2(acc[mb][nb][2], acc[mb][nb][3]);
    }
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
#pragma unroll 8
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
  J.first[0] = J.tfirst[0] = 0;
  for (int i = 0; i < J.n; ++i) {
    const Job& jo = J.job[i];
    if (jo.K % WT || jo.Ncol % WT) return cudaErrorInvalidValue;
    J.first[i + 1] = J.first[i] + jo.K / WT * (jo.Ncol / WT);
    const TileShape ts = tile_shape(jo.K, jo.Ncol);
    J.tfirst[i + 1] =
        J.tfirst[i] + jo.K / (32 * ts.wr) * (jo.Ncol / (64 * ts.wc));
  }
  if (J.splits <= 0 || J.M <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WSMEM);
  if (e != cudaSuccess) return e;
  wgrad_partial_kernel<<<dim3(J.tfirst[J.n], J.splits), WNT, WSMEM,
                         stream>>>(J);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = (long long)J.first[J.n] * WT * WT + J.vlen;
  wgrad_reduce_kernel<<<(int)((total + WNT - 1) / WNT), WNT, 0, stream>>>(J);
  return cudaGetLastError();
}

}  // namespace f32ops
