// Multi-head self-attention with its projections in f32, forward (row 4f)
// and backward (row 5f), for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_mhsa_kernel` (entry
// `fused_mhsa`) and `_mhsa_bwd_kernel` (via `_fused_mhsa_bwd`, its custom
// VJP) on their f32 branches (JAX's compute dtype f32): over each clip's
// N <= 64 tokens of width C (a multiple of 64, at most 256), in heads of
// 8, 16 or 32,
//
//   qkv = x Wqkv + bqkv;  o = softmax(q k^T) v per head;  out = o Wproj + b
//
// with q scaled by 1/sqrt(head width) before the scores and a
// max-stabilised f32 softmax. Its path is the f32 Stage-2 joint stream
// (AdaBlock over <= 64 tokens calls fused_mhsa): [32, 17, 64] and
// [32, 19, 64] in heads of 8.
//
// Products in true f32 (FFMA, no TF32; see csrc/block_f32.cu): the kernels
// differ from the plain version only in the order of their sums.
//
// What bounds them on this card: at the path's shapes, nothing the card
// is short of: [32, 17, 64] is 544 rows, 4 x 64 x 64 multiply-adds a row in
// the projections (~18 MFLOP forward with the scores) against ~0.3 ms of
// nothing at the f32 peak; one clip a CTA, so 32 CTAs on 132 SMs, and the
// time is the launches' and each CTA's chain of dependent steps. The
// design is the simplest that is right: one CTA of 256 threads a clip.
//
// Forward (pmce_mhsa_fwd_f32): x into shared memory; qkv = x Wqkv + b (a
// thread a column, rows in groups of 8, every weight value read once a
// group) to device memory (the backward's saved state; a scratch buffer
// when no gradient is owed); q into x's space, k^T ([C, 65]: a lane's key
// reads on distinct banks) and v staged; a warp a (row, head) computes the
// scores of its keys (a lane a key), the softmax by shuffles and o (a lane
// a channel) over q's place; out = o Wproj + b, and o to device memory
// with a gradient owed.
//
// Backward (pmce_mhsa_bwd_f32), from the saved qkv and o, in four
// launches: Wqkv^T and Wproj^T into a workspace; the tile program (a CTA a
// clip: dO = g Wproj^T into shared memory; a head at a time, its q, k^T
// and v staged, a warp a row recomputes P and forms dS = P (dP - D) and
// dq, a warp a key forms dk and dv, and dqkv goes to device memory with
// its per-clip bias sums; then dx = dqkv Wqkv^T); the weight gradients
// dWqkv = x^T dqkv, dWproj = o^T g and the clips' bias partials summed in
// a fixed order (csrc/f32_ops.cuh). No atomics: a rerun gives the same
// bits.

#include "common.cuh"
#include "f32_ops.cuh"

namespace mf32 {

constexpr int NT = 256;  // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int TR = 64;   // the most tokens a clip
constexpr int KT_LD = TR + 1;
constexpr int DHM = 32;  // the widest head
constexpr int RG = 8;    // rows of a product's group

struct Args {
  const float *x, *wqkv, *bqkv, *wproj, *bproj;
  float *out, *qkv, *o;
  // The backward's.
  const float *g, *wqkvT, *wprojT;
  float *dx, *dqkv, *part;
  int clips, N, C, heads;
  float qscale;
};

// epi(r, c, sum_k A[r, k] W[k, c]) for r < rows, c < ncols, the sum over
// k < K in order. A thread a column, rows in groups of RG: a weight value
// read once a group feeds RG FMAs; A's rows are broadcast reads (shared or
// device memory; rows past `rows` are not read). K is a multiple of 64:
// the loop runs 8 k a step, its 8 weight loads issued together (one L2
// round trip a step, not one a k).
template <class Epi>
__device__ void rows_mac(const float* A, int lda, int rows, int K,
                         const float* __restrict__ W, int ldw, int ncols,
                         Epi epi) {
  for (int c = threadIdx.x; c < ncols; c += NT)
    for (int rg = 0; rg < rows; rg += RG) {
      const float* a[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
        a[i] = A + (size_t)min(rg + i, rows - 1) * lda;
      float acc[RG] = {};
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float w = __ldg(W + (size_t)k * ldw + c);
#pragma unroll
        for (int i = 0; i < RG; ++i) acc[i] = fmaf(a[i][k], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RG; ++i)
        if (rg + i < rows) epi(rg + i, c, acc[i]);
    }
}

__host__ __device__ constexpr int fwd_smem_floats(int C) {
  return TR * C + C * KT_LD + TR * C;
}

__global__ void __launch_bounds__(NT) mhsa_fwd_f32_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, C = p.C, H = p.heads, dh = C / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Xs = reinterpret_cast<float*>(smem);  // [TR][C]: x, then q, then o
  float* KT = Xs + TR * C;                     // [C][KT_LD]
  float* Vs = KT + C * KT_LD;                  // [TR][C]
  const size_t g0 = (size_t)blockIdx.x * N;
  const float* x = p.x + g0 * C;
  float* qkv = p.qkv + g0 * 3 * C;

  for (int e = threadIdx.x; e < N * C; e += NT) Xs[e] = x[e];
  __syncthreads();
  rows_mac(Xs, C, N, C, p.wqkv, 3 * C, 3 * C, [&](int r, int c, float acc) {
    const float v = acc + p.bqkv[c];
    qkv[(size_t)r * 3 * C + c] = c < C ? v * p.qscale : v;
  });
  __syncthreads();
  for (int e = threadIdx.x; e < N * C; e += NT) {
    const int r = e / C, c = e % C;
    const float* row = qkv + (size_t)r * 3 * C;
    Xs[e] = row[c];
    KT[c * KT_LD + r] = row[C + c];
    Vs[e] = row[2 * C + c];
  }
  __syncthreads();
  for (int t = warp; t < N * H; t += NW) {
    const int r = t / H, h = t % H;
    const bool has0 = lane < N, has1 = lane + 32 < N;
    const float* q = Xs + r * C + h * dh;
    const float* kt = KT + (h * dh) * KT_LD;
    float s0 = 0.f, s1 = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float qd = q[d];
      s0 = fmaf(qd, kt[d * KT_LD + min(lane, N - 1)], s0);
      s1 = fmaf(qd, kt[d * KT_LD + min(lane + 32, N - 1)], s1);
    }
    float m = fmaxf(has0 ? s0 : -INFINITY, has1 ? s1 : -INFINITY);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float p0 = has0 ? expf(s0 - m) : 0.f;
    const float p1 = has1 ? expf(s1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    float o = 0.f;
    for (int j = 0; j < N; ++j) {
      const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
      o = fmaf(pj, lane < dh ? Vs[j * C + h * dh + lane] : 0.f, o);
    }
    __syncwarp();
    if (lane < dh) Xs[r * C + h * dh + lane] = o / l;  // over q's place
  }
  __syncthreads();
  if (p.o != nullptr)
    for (int e = threadIdx.x; e < N * C; e += NT) p.o[g0 * C + e] = Xs[e];
  float* out = p.out + g0 * C;
  rows_mac(Xs, C, N, C, p.wproj, C, C, [&](int r, int c, float acc) {
    out[(size_t)r * C + c] = acc + p.bproj[c];
  });
}

__host__ __device__ constexpr int bwd_smem_floats(int C) {
  // dO, then one head's q, k^T, v, P, dS, dq, dk, dv.
  return TR * C + TR * DHM + DHM * KT_LD + TR * (DHM + 1) + 2 * TR * TR +
         3 * TR * DHM;
}

__global__ void __launch_bounds__(NT) mhsa_bwd_f32_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, C = p.C, H = p.heads, dh = C / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int VLD = DHM + 1;
  float* DO = reinterpret_cast<float*>(smem);  // [TR][C]
  float* Qh = DO + TR * C;                     // [TR][DHM]
  float* KT = Qh + TR * DHM;                   // [DHM][KT_LD]
  float* Vh = KT + DHM * KT_LD;                // [TR][VLD]
  float* P = Vh + TR * VLD;                    // [TR][TR]
  float* dS = P + TR * TR;
  float* DQ = dS + TR * TR;                    // [TR][DHM] each
  float* DK = DQ + TR * DHM;
  float* DV = DK + TR * DHM;
  const size_t g0 = (size_t)blockIdx.x * N;
  const float* g = p.g + g0 * C;
  const float* qkv = p.qkv + g0 * 3 * C;
  float* dqkv = p.dqkv + g0 * 3 * C;
  float* part = p.part + (size_t)blockIdx.x * 4 * C;

  // dO = g Wproj^T; the clip's dbproj partial.
  rows_mac(g, C, N, C, p.wprojT, C, C,
           [&](int r, int c, float acc) { DO[r * C + c] = acc; });
  for (int c = threadIdx.x; c < C; c += NT) {
    float acc = 0.f;
    for (int r = 0; r < N; ++r) acc += g[(size_t)r * C + c];
    part[3 * C + c] = acc;
  }
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    for (int e = threadIdx.x; e < N * dh; e += NT) {
      const int r = e / dh, d = e % dh;
      const float* row = qkv + (size_t)r * 3 * C + h * dh + d;
      Qh[r * DHM + d] = row[0];
      KT[d * KT_LD + r] = row[C];
      Vh[r * VLD + d] = row[2 * C];
    }
    __syncthreads();
    for (int r = warp; r < N; r += NW) {
      const bool has0 = lane < N, has1 = lane + 32 < N;
      const int j0 = min(lane, N - 1), j1 = min(lane + 32, N - 1);
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float qd = Qh[r * DHM + d];
        s0 = fmaf(qd, KT[d * KT_LD + j0], s0);
        s1 = fmaf(qd, KT[d * KT_LD + j1], s1);
        const float od = DO[r * C + h * dh + d];
        dp0 = fmaf(od, Vh[j0 * VLD + d], dp0);
        dp1 = fmaf(od, Vh[j1 * VLD + d], dp1);
      }
      float m = fmaxf(has0 ? s0 : -INFINITY, has1 ? s1 : -INFINITY);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e0 = has0 ? expf(s0 - m) : 0.f;
      const float e1 = has1 ? expf(s1 - m) : 0.f;
      const float l = warp_sum(e0 + e1);
      const float p0 = e0 / l, p1 = e1 / l;
      const float D = warp_sum(p0 * dp0 + p1 * dp1);
      const float ds0 = has0 ? p0 * (dp0 - D) : 0.f;
      const float ds1 = has1 ? p1 * (dp1 - D) : 0.f;
      if (has0) {
        P[r * TR + lane] = p0;
        dS[r * TR + lane] = ds0;
      }
      if (has1) {
        P[r * TR + lane + 32] = p1;
        dS[r * TR + lane + 32] = ds1;
      }
      float dq = 0.f;
      for (int j = 0; j < N; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, j < 32 ? ds0 : ds1, j & 31);
        dq = fmaf(dsj, lane < dh ? KT[lane * KT_LD + j] : 0.f, dq);
      }
      if (lane < dh) DQ[r * DHM + lane] = dq * p.qscale;
    }
    __syncthreads();
    for (int j = warp; j < N; j += NW) {
      if (lane >= dh) continue;
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < N; ++i) {
        dk = fmaf(dS[i * TR + j], Qh[i * DHM + lane], dk);
        dv = fmaf(P[i * TR + j], DO[i * C + h * dh + lane], dv);
      }
      DK[j * DHM + lane] = dk;
      DV[j * DHM + lane] = dv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < N * dh; e += NT) {
      const int r = e / dh, d = e % dh;
      float* row = dqkv + (size_t)r * 3 * C + h * dh + d;
      row[0] = DQ[r * DHM + d];
      row[C] = DK[r * DHM + d];
      row[2 * C] = DV[r * DHM + d];
    }
    for (int c = threadIdx.x; c < 3 * dh; c += NT) {
      const float* src = c < dh ? DQ : c < 2 * dh ? DK : DV;
      const int d = c % dh;
      float acc = 0.f;
      for (int r = 0; r < N; ++r) acc += src[r * DHM + d];
      part[c / dh * C + h * dh + d] = acc;
    }
    __syncthreads();
  }

  // dx = dqkv Wqkv^T (dqkv re-read from device memory).
  float* dx = p.dx + g0 * C;
  rows_mac(dqkv, 3 * C, N, 3 * C, p.wqkvT, C, C,
           [&](int r, int c, float acc) { dx[(size_t)r * C + c] = acc; });
}

bool shape_ok(int clips, int N, int C, int heads) {
  if (clips <= 0 || N <= 0 || N > TR || C <= 0 || C % 64 || C > 256 ||
      heads <= 0 || C % heads)
    return false;
  const int dh = C / heads;
  return dh == 8 || dh == 16 || dh == 32;
}

}  // namespace mf32

// Host entry points.

// The forward over [clips, N, C] tokens. ptrs: x, wqkv [C, 3C], bqkv,
// wproj [C, C], bproj (f32, [in, out] as the parameters are), out, qkv
// [clips * N, 3C] (q scaled; the backward's saved state, or scratch), o
// [clips * N, C] (the backward's, or null).
extern "C" int pmce_mhsa_fwd_f32(void* const* ptrs, int clips, int N, int C,
                                 int heads, float qscale, void* stream) {
  using namespace mf32;
  if (!shape_ok(clips, N, C, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.x = static_cast<const float*>(ptrs[0]);
  a.wqkv = static_cast<const float*>(ptrs[1]);
  a.bqkv = static_cast<const float*>(ptrs[2]);
  a.wproj = static_cast<const float*>(ptrs[3]);
  a.bproj = static_cast<const float*>(ptrs[4]);
  a.out = static_cast<float*>(ptrs[5]);
  a.qkv = static_cast<float*>(ptrs[6]);
  a.o = static_cast<float*>(ptrs[7]);
  a.clips = clips; a.N = N; a.C = C; a.heads = heads; a.qscale = qscale;
  const int bytes = fwd_smem_floats(C) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      mhsa_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  mhsa_fwd_f32_kernel<<<clips, NT, bytes,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward: dx and the four parameter gradients. ptrs: g (the output's
// gradient), x, wqkv, wproj, qkv, o (the forward's saved state), the
// workspace wqkv^T [3C, C], wproj^T [C, C], dqkv [clips * N, 3C], the
// clips' bias partials [clips, 4C], the weight gradients' range partials
// [splits, tiles of 64 x 64, 4096]; dx, dwqkv [C, 3C], dwproj [C, C], and
// the bias gradients [4C] (dbqkv, then dbproj).
extern "C" int pmce_mhsa_bwd_f32(void* const* ptrs, int clips, int N, int C,
                                 int heads, float qscale, int splits,
                                 void* stream) {
  using namespace mf32;
  if (!shape_ok(clips, N, C, heads) || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  f32ops::Transposes T;
  T.in[0] = f(2); T.out[0] = f(6); T.rows[0] = C; T.cols[0] = 3 * C;
  T.in[1] = f(3); T.out[1] = f(7); T.rows[1] = C; T.cols[1] = C;
  T.n = 2;
  cudaError_t e = f32ops::launch_transposes(T, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  Args a = {};
  a.g = f(0);
  a.qkv = f(4);
  a.wqkvT = f(6);
  a.wprojT = f(7);
  a.dqkv = f(8);
  a.part = f(9);
  a.dx = f(11);
  a.clips = clips; a.N = N; a.C = C; a.heads = heads; a.qscale = qscale;
  const int bytes = bwd_smem_floats(C) * 4;
  e = cudaFuncSetAttribute(mhsa_bwd_f32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  mhsa_bwd_f32_kernel<<<clips, NT, bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  f32ops::Jobs J;
  J.job[0] = {f(1), f(8), f(12), C, 3 * C};
  J.job[1] = {f(5), f(0), f(13), C, C};
  J.n = 2;
  J.M = clips * N;
  J.splits = splits;
  J.ws = f(10);
  J.vpart = f(9);
  J.vout = f(14);
  J.vtiles = clips;
  J.vlen = 4 * C;
  return static_cast<int>(f32ops::launch_wgrad(J, st));
}

PMCE_EXPORT_ERROR_STRING(pmce_mhsa_f32_error_string)
