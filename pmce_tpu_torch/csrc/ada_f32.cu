// The decoder's AdaLayerNorm self-attention block in f32, forward (row 8f)
// and backward (row 9f), for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_ada_block_kernel` (entry
// `fused_ada_block`) and `_ada_block_bwd_kernel` (via
// `_fused_ada_block_bwd`, its custom VJP) on their f32 branches (JAX's
// compute dtype f32; the kernels work in x's dtype): the vertex stream's
//
//   x1 = x + m1 MHSA(AdaLN(x; g1, b1));  y = x1 + m2 MLP(AdaLN(x1; g2, b2))
//
// with per-clip AdaLN vectors (unbiased sigma, eps outside the sqrt),
// per-clip branch scales m1, m2 (stochastic depth; null: 1), C = 64, heads
// of 8, 16 or 32 with a max-stabilised softmax over every token of the
// clip, q scaled by 1/sqrt(head width) before the scores, and an erf-GELU
// MLP of up to 256 hidden units. Its path is f32 Stage-2 training:
// [32, 431, 64] in 2 heads of 32.
//
// Products in true f32 (FFMA on the CUDA cores, no TF32; see
// csrc/block_f32.cu): the kernels differ from the plain version only in the
// order of their sums.
//
// Plan (csrc/f32_ops.cuh, namespace dec): one f32 [431, 64] buffer is 110
// KB, so a clip's x, K and V (~331 KB) do not fit in one SM's shared
// memory. Every launch is a grid of chunks of 64 rows of one clip
// (ceil(N / 64) chunks a clip, 224 CTAs at [32, 431]); the clip's keys and
// values stream from device memory (L2-resident: 10.6 MB at [32, 431])
// in chunks of 64 rows.
//
// Forward (pmce_ada_fwd_f32), two launches:
// - rows: AdaLN1 and qkv = h1 Wqkv + bqkv (q scaled) into the workspace;
// - chunks: the chunk's queries against the clip's keys (an online
//   softmax, a warp a row), then the tail (proj, x1, AdaLN2, MLP, y).
// It saves nothing for the gradient: the backward recomputes the forward
// from x, as JAX's `_ada_block_bwd_kernel` does ("recompute in VMEM").
//
// Backward (pmce_ada_bwd_f32), seven launches, no atomics (a rerun gives
// the same bits):
// 1. the four weights transposed (f32_ops.cuh);
// 2. rows: the forward's first launch, keeping h1;
// 3. chunks: the forward's attention and tail, keeping o, the softmax max
//    and sum, h2, hh, ge; then the gradient chain down to the attention
//    (m2g, the MLP's and AdaLN2's backwards, dx1, da, dO, D) and the
//    chunk's dq over every key of the clip;
// 4. key chunks: dk and dv of the chunk's keys over every query of the
//    clip (P and dS recomputed from the saved max, sum and D);
// 5. rows: dh1 = dqkv Wqkv^T, AdaLN1's backward, dx = dx1 + AdaLN1^T(dh1);
// 6. the weight gradients dW = A^T dY (f32_ops.cuh, fixed-order partial
//    sums) with the bias gradients from the chunks' partials;
// 7. the per-clip sums of the chunks' partials: dgamma1, dbeta1, dgamma2,
//    dbeta2, and dm1, dm2 when owed.

#include "common.cuh"
#include "f32_ops.cuh"

namespace ada32 {

using namespace f32ops::dec;

struct Args {
  const float *x, *g1, *b1, *g2, *b2, *m1, *m2;
  const float *wqkv, *bqkv, *wproj, *bproj, *w1, *bb1, *w2, *bb2;
  float *out, *qkv, *h1;
  int clips, N, hid;
  float eps, qscale;
  // The backward's.
  const float* gout;
  const float *wqkvT, *wprojT, *w1T, *w2T;
  float *o, *h2, *hh, *ge, *m2g, *dhh, *da, *dO, *Ms, *Ls, *Ds, *dqkv;
  float *bpart, *cpart, *dx;
  bool dm;
};

// The bias partials' layout (dbqkv, dbproj, dbb1, dbb2) and the clip
// partials' (dg1, db1, dg2, db2, dm1, dm2).
__host__ __device__ constexpr int bias_len(int hid) { return 5 * C + hid; }
constexpr int CLIP_LEN = 4 * C + 2;

// Rows: h1 = AdaLN1(x), qkv = h1 Wqkv + bqkv (q scaled); h1 kept when
// p.h1 is not null. A warp's rows need no CTA barrier.
__global__ void __launch_bounds__(NT) ada_rows_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int clip = blockIdx.y, r0 = blockIdx.x * TR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * RW;
  const int nv = max(0, min(RW, p.N - r0 - wr));
  if (nv == 0) return;
  const size_t g = (size_t)clip * p.N + r0 + wr;  // the warp's first row
  float* HS = reinterpret_cast<float*>(smem) + wr * C;
  adaln_rows(p.x + g * C, C, nv, p.g1 + clip * C, p.b1 + clip * C, p.eps, HS,
             p.h1 != nullptr ? p.h1 + g * C : nullptr);
  __syncwarp();
  float acc[RW][6] = {};
  mac<6>(HS, C, nv, C, p.wqkv, 3 * C, 0, acc);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i >= nv) break;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int c = lane + 32 * j;
      const float v = acc[i][j] + p.bqkv[c];
      p.qkv[(g + i) * 3 * C + c] = c < C ? v * p.qscale : v;
    }
  }
}

// Chunks: the chunk's attention over the clip's keys and the tail; in the
// backward also the gradient chain down to dq.
template <int H, bool BWD>
__global__ void __launch_bounds__(NT, 1) ada_chunk_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChunkSmem s = chunk_smem(smem);
  const int clip = blockIdx.y, r0 = blockIdx.x * TR;
  const int n = min(TR, p.N - r0);
  const int cta = clip * gridDim.x + blockIdx.x;
  const size_t g0 = (size_t)clip * p.N + r0;
  const float* qkv = p.qkv + (size_t)clip * p.N * 3 * C;
  load_rows(qkv + (size_t)r0 * 3 * C, 3 * C, n, s.R1);
  load_rows(p.x + g0 * C, C, n, s.R0);
  attn_fwd<H>(s.R1, qkv + C, 3 * C, qkv + 2 * C, 3 * C, p.N, n, s.R2, s.a);
  Tail t;
  t.g2 = p.g2 + clip * C;
  t.b2 = p.b2 + clip * C;
  t.m1 = clip_scale(p.m1, clip);
  t.m2 = clip_scale(p.m2, clip);
  t.wproj = p.wproj; t.bproj = p.bproj;
  t.w1 = p.w1; t.bb1 = p.bb1; t.w2 = p.w2; t.bb2 = p.bb2;
  t.hid = p.hid;
  t.eps = p.eps;
  if constexpr (!BWD) {
    t.out = p.out + g0 * C;
  } else {
    save_attn<H>(s, n, p.o + g0 * C, p.Ms + g0 * H, p.Ls + g0 * H);
    t.gout = p.gout + g0 * C;
    t.wprojT = p.wprojT; t.w1T = p.w1T; t.w2T = p.w2T;
    t.h2 = p.h2 + g0 * C;
    t.hh = p.hh + g0 * p.hid;
    t.ge = p.ge + g0 * p.hid;
    t.m2g = p.m2g + g0 * C;
    t.dhh = p.dhh + g0 * p.hid;
    t.da = p.da + g0 * C;
    t.dO = p.dO + g0 * C;
    t.dx1 = p.dx + g0 * C;
    t.D = p.Ds + g0 * H;
    t.bpart = p.bpart + (size_t)cta * bias_len(p.hid) + 3 * C;
    t.cpart = p.cpart + (size_t)cta * CLIP_LEN + 2 * C;
    t.dm = p.dm;
  }
  tail_rows<H, BWD>(t, n, s);
  if constexpr (BWD) {
    attn_bwd_q<H>(s.R1, s.R3, qkv + C, 3 * C, qkv + 2 * C, 3 * C, p.N, n,
                  p.qscale, s.R0, s.a);
    for (int e = threadIdx.x; e < n * C; e += NT)
      p.dqkv[(g0 + e / C) * 3 * C + e % C] = s.R0[e];
  }
}

// Key chunks: dk, dv of the chunk's keys over every query of the clip.
template <int H>
__global__ void __launch_bounds__(NT, 1) ada_keys_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChunkSmem s = chunk_smem(smem);
  const int clip = blockIdx.y, r0 = blockIdx.x * TR;
  const int n = min(TR, p.N - r0);
  const size_t c0 = (size_t)clip * p.N;  // the clip's first row
  const float* qkv = p.qkv + c0 * 3 * C;
  load_rows(qkv + (size_t)r0 * 3 * C + C, 3 * C, n, s.R0);
  load_rows(qkv + (size_t)r0 * 3 * C + 2 * C, 3 * C, n, s.R1);
  attn_bwd_kv<H>(s.R0, s.R1, n, qkv, 3 * C, p.dO + c0 * C, p.Ms + c0 * H,
                 p.Ls + c0 * H, p.Ds + c0 * H, p.N, s.R2, s.R3, s.a);
  for (int e = threadIdx.x; e < n * C; e += NT) {
    float* row = p.dqkv + (c0 + r0 + e / C) * 3 * C;
    row[C + e % C] = s.R2[e];
    row[2 * C + e % C] = s.R3[e];
  }
}

// Rows: dh1 = dqkv Wqkv^T, dx += AdaLN1^T(dh1) (dx holds dx1); the
// chunk's partials of dgamma1, dbeta1 and dbqkv.
__global__ void __launch_bounds__(NT) ada_dx_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scr = reinterpret_cast<float*>(smem);  // [NW][C]
  const int clip = blockIdx.y, r0 = blockIdx.x * TR;
  const int cta = clip * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp * RW;
  const int nv = max(0, min(RW, p.N - r0 - wr));
  const size_t g = (size_t)clip * p.N + r0 + wr;
  const float* dq = p.dqkv + g * 3 * C;
  float acc[RW][2] = {};
  if (nv > 0) mac<2>(dq, 3 * C, nv, 3 * C, p.wqkvT, C, 0, acc);
  float pg[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
  adaln_bwd_rows(p.x + g * C, nv, acc, p.g1 + clip * C, p.eps, p.dx + g * C,
                 p.dx + g * C, pg, pb);
  float* cpart = p.cpart + (size_t)cta * CLIP_LEN;
  cta_colsum(pg[0], pg[1], scr, cpart);
  cta_colsum(pb[0], pb[1], scr, cpart + C);
  float* bpart = p.bpart + (size_t)cta * bias_len(p.hid);
  for (int j = 0; j < 3; ++j) {
    float v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < nv; ++i) {
      v0 += dq[(size_t)i * 3 * C + j * C + lane];
      v1 += dq[(size_t)i * 3 * C + j * C + lane + 32];
    }
    cta_colsum(v0, v1, scr, bpart + j * C);
  }
}

constexpr int ROWS_SMEM = TR * C * 4;

bool shape_ok(int clips, int N, int hid, int heads) {
  return clips > 0 && N > 0 && hid > 0 && hid % HC == 0 &&
         (heads == 2 || heads == 4 || heads == 8);
}

// The backward's workspace, carved from one f32 buffer (null: only count).
struct Ws {
  float *wqkvT, *wprojT, *w1T, *w2T, *h1, *qkv, *o, *h2, *hh, *ge, *m2g,
      *dhh, *da, *dO, *Ms, *Ls, *Ds, *dqkv, *bpart, *cpart, *wpart;
  size_t floats;
};

Ws carve(float* base, int clips, int N, int hid, int heads, int splits) {
  const size_t M = (size_t)clips * N;
  const int ctas = clips * ((N + TR - 1) / TR);
  const size_t wtiles = (size_t)(3 * C * C + C * C + 2 * C * hid) / 4096;
  Ws w;
  size_t at = 0;
  auto take = [&](size_t n) {
    float* q = base != nullptr ? base + at : nullptr;
    at += (n + 3) / 4 * 4;  // 16-byte aligned pieces
    return q;
  };
  w.wqkvT = take(3 * C * C); w.wprojT = take(C * C);
  w.w1T = take((size_t)hid * C); w.w2T = take((size_t)C * hid);
  w.h1 = take(M * C); w.qkv = take(M * 3 * C); w.o = take(M * C);
  w.h2 = take(M * C); w.hh = take(M * hid); w.ge = take(M * hid);
  w.m2g = take(M * C); w.dhh = take(M * hid); w.da = take(M * C);
  w.dO = take(M * C); w.Ms = take(M * heads); w.Ls = take(M * heads);
  w.Ds = take(M * heads); w.dqkv = take(M * 3 * C);
  w.bpart = take((size_t)ctas * bias_len(hid));
  w.cpart = take((size_t)ctas * CLIP_LEN);
  w.wpart = take((size_t)splits * wtiles * 4096);
  w.floats = at;
  return w;
}

void fill(Args& a, void* const* ptrs, int clips, int N, int hid, float eps,
          float qscale) {
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  a = Args{};
  a.x = cf(0); a.g1 = cf(1); a.b1 = cf(2); a.g2 = cf(3); a.b2 = cf(4);
  a.m1 = cf(5); a.m2 = cf(6);
  a.wqkv = cf(7); a.bqkv = cf(8); a.wproj = cf(9); a.bproj = cf(10);
  a.w1 = cf(11); a.bb1 = cf(12); a.w2 = cf(13); a.bb2 = cf(14);
  a.clips = clips; a.N = N; a.hid = hid; a.eps = eps; a.qscale = qscale;
}

template <bool BWD>
cudaError_t launch_chunks(const Args& a, int heads, dim3 grid,
                          cudaStream_t st) {
  return launch_chunk(heads == 2   ? ada_chunk_kernel<2, BWD>
                      : heads == 4 ? ada_chunk_kernel<4, BWD>
                                   : ada_chunk_kernel<8, BWD>,
                      grid, a, st);
}

}  // namespace ada32

// Host entry points.

// Floats of the backward's workspace (pmce_ada_bwd_f32's pointer 16).
extern "C" long long pmce_ada_f32_workspace(int clips, int N, int hid,
                                            int heads, int splits) {
  return static_cast<long long>(
      ada32::carve(nullptr, clips, N, hid, heads, splits).floats);
}

// Shared memory of the chunk programs (bytes).
extern "C" int pmce_ada_f32_smem_bytes() {
  return f32ops::dec::CHUNK_SMEM_FLOATS * 4;
}

// The f32 forward over [clips, N, 64] tokens. ptrs: 0 x, 1-4 g1, b1, g2, b2
// ([clips, 64] each), 5-6 m1, m2 ([clips]; both null without masks), 7
// wqkv [64, 192], 8 bqkv, 9 wproj [64, 64], 10 bproj, 11 w1 [64, hid], 12
// bb1, 13 w2 [hid, 64], 14 bb2 (f32, [in, out] as the parameters are), 15
// out, 16 scratch [clips * N, 192] (q, k, v).
extern "C" int pmce_ada_fwd_f32(void* const* ptrs, int clips, int N, int hid,
                                int heads, float eps, float qscale,
                                void* stream) {
  using namespace ada32;
  if (!shape_ok(clips, N, hid, heads) ||
      (ptrs[5] == nullptr) != (ptrs[6] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  fill(a, ptrs, clips, N, hid, eps, qscale);
  a.out = static_cast<float*>(ptrs[15]);
  a.qkv = static_cast<float*>(ptrs[16]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + TR - 1) / TR, clips);
  ada_rows_kernel<<<grid, NT, ROWS_SMEM, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_chunks<false>(a, heads, grid, st));
}

// The f32 backward: dx, the per-clip sums, the four weight gradients and
// the bias gradients, in seven launches (see the header). ptrs: 0-14 as the
// forward's, 15 gout (the output's gradient), 16 the workspace
// (pmce_ada_f32_workspace floats), 17 dx, 18 the per-clip sums [clips, 258]
// (dg1, db1, dg2, db2 [64] each, dm1, dm2), 19 dwqkv, 20 dwproj, 21 dw1, 22
// dw2, 23 the bias gradients [5 * 64 + hid] (dbqkv, dbproj, dbb1, dbb2).
// dm: the mask gradients are owed (masks given).
extern "C" int pmce_ada_bwd_f32(void* const* ptrs, int clips, int N, int hid,
                                int heads, float eps, float qscale,
                                int splits, int dm, void* stream) {
  using namespace ada32;
  if (!shape_ok(clips, N, hid, heads) || splits <= 0 ||
      (ptrs[5] == nullptr) != (ptrs[6] == nullptr) ||
      (dm && ptrs[5] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  Args a;
  fill(a, ptrs, clips, N, hid, eps, qscale);
  const Ws w = carve(f(16), clips, N, hid, heads, splits);
  a.gout = f(15);
  a.wqkvT = w.wqkvT; a.wprojT = w.wprojT; a.w1T = w.w1T; a.w2T = w.w2T;
  a.qkv = w.qkv; a.h1 = w.h1; a.o = w.o; a.h2 = w.h2; a.hh = w.hh;
  a.ge = w.ge; a.m2g = w.m2g; a.dhh = w.dhh; a.da = w.da; a.dO = w.dO;
  a.Ms = w.Ms; a.Ls = w.Ls; a.Ds = w.Ds; a.dqkv = w.dqkv;
  a.bpart = w.bpart; a.cpart = w.cpart; a.dx = f(17);
  a.dm = dm != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  f32ops::Transposes T;
  const float* src[4] = {a.wqkv, a.wproj, a.w1, a.w2};
  float* dst[4] = {w.wqkvT, w.wprojT, w.w1T, w.w2T};
  const int rows[4] = {C, C, C, hid}, cols[4] = {3 * C, C, hid, C};
  for (int i = 0; i < 4; ++i) {
    T.in[i] = src[i];
    T.out[i] = dst[i];
    T.rows[i] = rows[i];
    T.cols[i] = cols[i];
  }
  T.n = 4;
  cudaError_t e = f32ops::launch_transposes(T, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const int chunks = (N + TR - 1) / TR;
  const dim3 grid(chunks, clips);
  ada_rows_kernel<<<grid, NT, ROWS_SMEM, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = launch_chunks<true>(a, heads, grid, st)) != cudaSuccess)
    return static_cast<int>(e);
  e = launch_chunk(heads == 2   ? ada_keys_kernel<2>
                   : heads == 4 ? ada_keys_kernel<4>
                                : ada_keys_kernel<8>,
                   grid, a, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ada_dx_kernel<<<grid, NT, NW * C * 4, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  f32ops::Jobs J;
  J.job[0] = {w.h1, w.dqkv, f(19), C, 3 * C};
  J.job[1] = {w.o, w.da, f(20), C, C};
  J.job[2] = {w.h2, w.dhh, f(21), C, hid};
  J.job[3] = {w.ge, w.m2g, f(22), hid, C};
  J.n = 4;
  J.M = clips * N;
  J.splits = splits;
  J.ws = w.wpart;
  J.vpart = w.bpart;
  J.vout = f(23);
  J.vtiles = clips * chunks;
  J.vlen = bias_len(hid);
  if ((e = f32ops::launch_wgrad(J, st)) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(
      launch_clip_sum(w.cpart, chunks, CLIP_LEN, clips, f(18), st));
}

PMCE_EXPORT_ERROR_STRING(pmce_ada_f32_error_string)
