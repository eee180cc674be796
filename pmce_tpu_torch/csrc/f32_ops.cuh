// f32 pieces shared by the f32 training kernels (csrc/block_f32.cu,
// csrc/mhsa_f32.cu, csrc/ada_f32.cu, csrc/ca_f32.cu): the weight products'
// transposes and the weight gradients dW = A^T dY with the vector
// gradients' sums over tiles, in true f32 (FFMA on the CUDA cores, no
// TF32), and the decoder blocks' forward programs (namespace dec, FFMA);
// every sum in a fixed order: no atomics, so a rerun gives the same bits.
// The decoder blocks' backwards run on the tensor cores (csrc/dec_tc32.cuh).
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


// ---------------------------------------------------------------------------
// The decoder's AdaLN blocks' f32 forwards (csrc/ada_f32.cu, row 8f;
// csrc/ca_f32.cu, row 10f; and the rows launches of qkv and of k, v that
// the backwards share), FFMA on the CUDA cores: C = 64 channels. A CTA of
// NT threads owns a chunk of up to TR rows of one clip; a warp owns RW of
// them, and a lane the columns lane and lane + 32 of each, so that a row's
// sums (the AdaLN statistics) are one warp reduction and the row-local
// stages need no CTA barrier. Attention runs
// over a clip's keys streamed through shared memory in chunks of KC rows,
// staged transposed ([C][LD]: a lane's key or channel reads fall on
// distinct banks), a warp a row (scores a lane a key, all heads at once;
// the products over keys a lane a channel), with an online softmax. Every
// sum is taken in a fixed order: a rerun gives the same bits. (The chunk
// programs' shared memory keeps the layout it had when the backwards ran
// here too: P2 and D are spare.)
// ---------------------------------------------------------------------------
namespace dec {

constexpr int C = 64;        // channels
constexpr int NT = 256;      // threads of a CTA
constexpr int NW = NT / 32;  // warps of a CTA
constexpr int RW = 8;        // rows of a warp
constexpr int TR = NW * RW;  // rows of a CTA's chunk
constexpr int KC = 64;       // rows of a staged key (or query) chunk
constexpr int LD = KC + 1;   // row stride of a transposed stage
constexpr int HMAX = 8;      // the most heads (heads of 8)
constexpr int HC = 64;       // hidden units of an MLP chunk

__device__ __forceinline__ float clip_scale(const float* m, int clip) {
  return m != nullptr ? m[clip] : 1.f;
}

// acc[i][j] += sum_k A[i, k] W[k, col0 + lane + 32 j] over the warp's RW
// rows of A (row stride lda; rows at and past `valid` read row valid - 1,
// so A may end there in device memory) and k < K in order (K a multiple of
// 4, rows 16-byte aligned). A's values are broadcast reads, W's a coalesced
// read through L1 / L2, and each W value feeds RW FMAs.
template <int TN>
__device__ __forceinline__ void mac(const float* A, int lda, int valid, int K,
                                    const float* __restrict__ W, int ldw,
                                    int col0, float (&acc)[RW][TN]) {
  const float* wl = W + col0 + (threadIdx.x & 31);
  const float* a_row[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
    a_row[i] = A + (size_t)min(i, valid - 1) * lda;
  for (int k = 0; k < K; k += 4) {
    float4 a[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_row[i] + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float w[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        w[j] = __ldg(wl + (size_t)(k + kk) * ldw + 32 * j);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
      }
    }
  }
}

// A row's AdaLN statistics from the lane's two values: the mean, sigma (the
// unbiased standard deviation, centred) and inv = 1 / (sigma + eps), eps
// outside the sqrt.
__device__ __forceinline__ void adaln_stats(float v0, float v1, float eps,
                                            float& mean, float& sigma,
                                            float& inv) {
  mean = warp_sum(v0 + v1) * (1.f / C);
  const float u0 = v0 - mean, u1 = v1 - mean;
  sigma = sqrtf(warp_sum(u0 * u0 + u1 * u1) * (1.f / (C - 1)));
  inv = 1.f / (sigma + eps);
}

// AdaLN of the warp's rows of `in` (row stride ldin, rows past `valid`
// written as zeros) into `out` (row stride C) with the clip's g, b, and
// into `keep` (device memory, row stride C) when not null.
__device__ __forceinline__ void adaln_rows(const float* in, int ldin,
                                           int valid, const float* g,
                                           const float* b, float eps,
                                           float* out, float* keep) {
  const int lane = threadIdx.x & 31;
  const float g0 = g[lane], g1 = g[lane + 32];
  const float b0 = b[lane], b1 = b[lane + 32];
  for (int i = 0; i < RW; ++i) {
    float y0 = 0.f, y1 = 0.f;
    if (i < valid) {
      float mean, sigma, inv;
      const float v0 = in[(size_t)i * ldin + lane];
      const float v1 = in[(size_t)i * ldin + lane + 32];
      adaln_stats(v0, v1, eps, mean, sigma, inv);
      y0 = g0 * ((v0 - mean) * inv) + b0;
      y1 = g1 * ((v1 - mean) * inv) + b1;
      if (keep != nullptr) {
        keep[(size_t)i * C + lane] = y0;
        keep[(size_t)i * C + lane + 32] = y1;
      }
    }
    out[i * C + lane] = y0;
    out[i * C + lane + 32] = y1;
  }
}

// Rows 0 .. kc - 1 of `src` (row stride ld, C columns) transposed into T
// [C][LD]; columns kc .. KC - 1 zero.
__device__ __forceinline__ void stage_t(const float* src, int ld, int kc,
                                        float* T) {
  for (int e = threadIdx.x; e < KC * C; e += NT) {
    const int j = e / C, c = e % C;
    T[c * LD + j] = j < kc ? src[(size_t)j * ld + c] : 0.f;
  }
}

// The attention's shared memory: a chunk's two transposed stages, two
// per-warp buffers of per-head rows [NW][HMAX][LD] (probabilities, dS) and
// the rows' per-head softmax max, sum and D = dO . o ([HMAX][LD], head
// major: a lane's query reads fall on distinct banks).
struct AttnSmem {
  float *T0, *T1, *P, *P2, *M, *L, *D;
};

// The per-head score-like sums of one row against a chunk's keys (lane,
// lane + 32): s[h][t] = sum_{c in head h} a[c] T[c][lane + 32 t], a in
// shared memory (16-byte aligned).
template <int H>
__device__ __forceinline__ void head_dots(const float* a, const float* T,
                                          float (&s)[H][2]) {
  constexpr int DH = C / H;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    s[h][0] = s[h][1] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + h * DH + d);
      const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* t = T + (h * DH + d + u) * LD;
        s[h][0] = fmaf(av[u], t[lane], s[h][0]);
        s[h][1] = fmaf(av[u], t[lane + 32], s[h][1]);
      }
    }
  }
}

// O = softmax(Q K^T) V per head for the chunk's n query rows (Q [TR][C]
// scaled, shared) over the clip's Nk keys and values (rows of stride ldk /
// ldv in device memory); O [TR][C] shared (rows past n zero), the rows'
// per-head max and sum in sm.M / sm.L. Every thread calls it.
template <int H>
__device__ void attn_fwd(const float* Q, const float* K, int ldk,
                         const float* V, int ldv, int Nk, int n, float* O,
                         const AttnSmem& sm) {
  constexpr int DH = C / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = lane / DH, h1 = (lane + 32) / DH;
  float* P = sm.P + warp * HMAX * LD;
  __syncthreads();
  for (int e = threadIdx.x; e < TR * C; e += NT) O[e] = 0.f;
  for (int e = threadIdx.x; e < HMAX * LD; e += NT) {
    sm.M[e] = -INFINITY;
    sm.L[e] = 0.f;
  }
  for (int j0 = 0; j0 < Nk; j0 += KC) {
    const int kc = min(KC, Nk - j0);
    __syncthreads();
    stage_t(K + (size_t)j0 * ldk, ldk, kc, sm.T0);
    stage_t(V + (size_t)j0 * ldv, ldv, kc, sm.T1);
    __syncthreads();
    const bool has0 = lane < kc, has1 = lane + 32 < kc;
    for (int i = 0; i < RW; ++i) {
      const int r = warp * RW + i;
      if (r >= n) break;
      float s[H][2];
      head_dots<H>(Q + r * C, sm.T0, s);
      float a0 = 1.f, a1 = 1.f;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float cm = fmaxf(has0 ? s[h][0] : -INFINITY,
                         has1 ? s[h][1] : -INFINITY);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        const float mo = sm.M[h * LD + r];
        const float mn = fmaxf(mo, cm);
        const float alpha = expf(mo - mn);
        const float p0 = has0 ? expf(s[h][0] - mn) : 0.f;
        const float p1 = has1 ? expf(s[h][1] - mn) : 0.f;
        const float l = sm.L[h * LD + r] * alpha + warp_sum(p0 + p1);
        P[h * LD + lane] = p0;
        P[h * LD + lane + 32] = p1;
        if (h == h0) a0 = alpha;
        if (h == h1) a1 = alpha;
        __syncwarp();
        if (lane == 0) {
          sm.M[h * LD + r] = mn;
          sm.L[h * LD + r] = l;
        }
      }
      __syncwarp();
      const float* p0r = P + h0 * LD;
      const float* p1r = P + h1 * LD;
      const float* v0 = sm.T1 + lane * LD;
      const float* v1 = sm.T1 + (lane + 32) * LD;
      float o0 = O[r * C + lane] * a0, o1 = O[r * C + lane + 32] * a1;
      for (int j = 0; j < kc; ++j) {
        o0 = fmaf(p0r[j], v0[j], o0);
        o1 = fmaf(p1r[j], v1[j], o1);
      }
      O[r * C + lane] = o0;
      O[r * C + lane + 32] = o1;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TR * C; e += NT) {
    const int r = e / C, c = e % C;
    if (r < n) O[e] = O[e] / sm.L[(c / DH) * LD + r];
  }
  __syncthreads();
}

// The shared memory of the chunk programs: four [TR][C] row buffers and the
// attention's stages. The query-side programs hold x (then x1, then dq), q,
// o and dO in them; the key-side ones k, v, dk and dv.
struct ChunkSmem {
  float *R0, *R1, *R2, *R3;
  AttnSmem a;
};

constexpr int CHUNK_SMEM_FLOATS =
    4 * TR * C + 2 * C * LD + 2 * NW * HMAX * LD + 3 * HMAX * LD;

__device__ __forceinline__ ChunkSmem chunk_smem(unsigned char* smem) {
  ChunkSmem s;
  float* f = reinterpret_cast<float*>(smem);
  s.R0 = f;
  s.R1 = f + TR * C;
  s.R2 = f + 2 * TR * C;
  s.R3 = f + 3 * TR * C;
  s.a.T0 = f + 4 * TR * C;
  s.a.T1 = s.a.T0 + C * LD;
  s.a.P = s.a.T1 + C * LD;
  s.a.P2 = s.a.P + NW * HMAX * LD;
  s.a.M = s.a.P2 + NW * HMAX * LD;
  s.a.L = s.a.M + HMAX * LD;
  s.a.D = s.a.L + HMAX * LD;
  return s;
}

// Host side: one launch of a chunk program (NT threads, the chunk
// programs' shared memory).
template <class K, class A>
inline cudaError_t launch_chunk(K kernel, dim3 grid, const A& args,
                                cudaStream_t stream) {
  const int bytes = CHUNK_SMEM_FLOATS * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, bytes, stream>>>(args);
  return cudaGetLastError();
}

// n rows of a [*, C] slice (row stride ld) into a [TR][C] buffer, zeros past
// n.
__device__ __forceinline__ void load_rows(const float* src, int ld, int n,
                                          float* dst) {
  for (int e = threadIdx.x; e < TR * C; e += NT) {
    const int r = e / C, c = e % C;
    dst[e] = r < n ? src[(size_t)r * ld + c] : 0.f;
  }
}

// The blocks' common tail over a chunk of query rows, after the attention
// (the forwards, rows 8f / 10f): a = o Wproj + bproj, x1 = x + m1 a, h2 =
// AdaLN2(x1), y = x1 + m2 (gelu(h2 W1 + bb1) W2 + bb2) (the MLP in hidden
// chunks of HC, fc2's sums in registers). Pointers are the chunk's first
// rows.
struct Tail {
  const float *g2, *b2;  // the clip's AdaLN2 vectors
  float m1, m2;          // the clip's branch scales
  const float *wproj, *bproj, *w1, *bb1, *w2, *bb2;
  int hid;
  float eps;
  float* out;  // the forward's output
};

template <int H>
__device__ void tail_rows(const Tail& t, int n, const ChunkSmem& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * RW;
  const int nv = max(0, min(RW, n - wr));
  float* XS = s.R0 + wr * C;    // x, then x1
  float* OS = s.R2 + wr * C;    // o
  float* AS = s.a.P + wr * C;   // a
  float* HS = s.a.T0 + wr * C;  // h2
  float* GS = s.a.T1 + wr * C;  // ge chunks

  {
    float acc[RW][2] = {};
    if (nv > 0) mac<2>(OS, C, nv, C, t.wproj, C, 0, acc);
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float a = i < nv ? acc[i][j] + t.bproj[c] : 0.f;
        AS[i * C + c] = a;
        XS[i * C + c] += t.m1 * a;
      }
  }
  __syncwarp();
  adaln_rows(XS, C, nv, t.g2, t.b2, t.eps, HS, nullptr);
  __syncwarp();
  float acc2[RW][2] = {};
  for (int ch = 0; ch < t.hid; ch += HC) {
    float ah[RW][2] = {};
    if (nv > 0) mac<2>(HS, C, nv, C, t.w1, t.hid, ch, ah);
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        float ge = 0.f;
        if (i < nv) {
          const float hh = ah[i][j] + t.bb1[ch + c];
          ge = gelu_erf(hh);
        }
        GS[i * C + c] = ge;
      }
    __syncwarp();
    if (nv > 0) mac<2>(GS, C, nv, HC, t.w2 + (size_t)ch * C, C, 0, acc2);
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < RW; ++i)
    if (i < nv)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        t.out[(size_t)(wr + i) * C + c] =
            XS[i * C + c] + t.m2 * (acc2[i][j] + t.bb2[c]);
      }
}

}  // namespace dec
}  // namespace f32ops
