// Pre-norm transformer block, f32 serving forward, for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_block_kernel` (entry
// `fused_transformer_block`) on its f32 branch, where JAX's compute dtype
// is f32 (`PMCE(dtype=None, fused_attn=True)`): one lifter block,
//
//   x1 = x + MHSA(LN1(x));  y = x1 + MLP(LN2(x1));  [PostLN(y)]
//
// with LayerNorm eps 1e-6 and f32 statistics, heads of 32 with a
// max-stabilised f32 softmax over each clip's N <= 64 tokens, q scaled by
// 1/sqrt(32) before the scores, an erf-GELU MLP, and the lifter's shared
// post-norm. This is the non-saving program: no branch masks and nothing
// kept for a gradient (the serving forward). f32 with a gradient or with
// masks is queued (ROADMAP.md B2b) and refused by the wrapper.
//
// Products in true f32: FFMA on the CUDA cores. A single TF32 pass keeps 10
// mantissa bits and errs ~1e-3 relative, which breaks the f32 model's 1e-4
// parity; 3xTF32 (hi/lo split on mma.sync m16n8k8) would be faster but
// drops the lo*lo term and adds the split's bookkeeping to every fragment.
// FFMA rounds each product-sum exactly as an f32 GEMM does, so the kernel
// differs from the plain version only in the order of its sums; a first
// kernel is right before it is fast.
//
// What bounds it on this card: products. A row of C = 256 costs qkv 256 x
// 768, proj 256 x 256, fc1 256 x hid and fc2 hid x 256 multiply-adds,
// 1,048,576 flops at hid 512; the serving shapes ([4096, 19, 256] spatial,
// [4864, 16, 256] temporal, 77,824 rows each) make 81.6 GFLOP a call, 1.22
// ms at the 67 TFLOP/s f32 CUDA-core peak, against 160 MB of tokens in and
// out (0.05 ms at the HBM rate).
//
// Design: one thread block of 512 threads (16 warps) per tile of whole
// clips, up to TR = 64 rows (3 clips of 19, 4 of 16). Shared memory holds
// three f32 [64, 256] buffers (192 KB): X, H and O. LN1 writes H; per pair
// of heads the q / k / v columns of each head (64 x 96, from H) go to X's
// space with k transposed ([32, 65], so that a lane's key reads fall on
// distinct banks), and a warp a (row, head) computes the scores of its
// clip's keys (a lane a key), the softmax by shuffles and o (a lane a
// channel), into O. proj
// writes x1 = x + O Wproj + b into X (x re-read from device memory); LN2
// writes H; the MLP runs in hidden chunks of 128: fc1 + GELU into O, then
// fc2 into registers that persist over the chunks; y = x1 + fc2 + b, then
// the post-norm a warp a row. Every product splits the 16 warps into 8 row
// groups of TM = 8 rows and 2 column halves: a warp's task is its 8 rows
// x 32 TN columns of its half (a lane a column every 32; for qkv the two
// halves are two heads, so a head pair a pass). The rows' A values are
// broadcast float4 reads from shared memory, the weight row a coalesced
// read through L1 / L2 (the block's 4 MB of f32 weights stay in L2), and
// each weight value loaded feeds 8 FMAs. No atomics and a fixed order of
// every sum.

#include "common.cuh"

namespace bf32 {

constexpr int NT = 512;   // threads per block (16 warps)
constexpr int NW = NT / 32;
constexpr int TR = 64;    // tile rows (whole clips)
constexpr int CW = 256;   // channel width C
constexpr int DH = 32;    // head width
constexpr int HC = 128;   // hidden chunk of the MLP
constexpr int TM = 8;     // rows of a warp task (TR = NW / 2 * TM)
constexpr int KT_LD = TR + 1;  // row stride of the transposed keys
constexpr int QKV_F = 2 * TR * DH + DH * KT_LD;  // one head's q, k^T, v

struct Args {
  const float *x, *wqkv, *wproj, *w1, *w2;
  const float *g1, *b1, *bqkv, *bproj, *g2, *b2, *bb1, *bb2, *gp, *bp;
  float* out;
  int clips, N, hid;
  float eps, post_eps, qscale;
};

// acc[i][j] += sum_k A[i, k] W[k, cbase + lane + j * cstride] over the
// warp's TM rows (A: the first row, row stride lda; A in shared memory)
// and K columns in order.
template <int TN>
__device__ __forceinline__ void tile_mac(const float* A, int lda, int K,
                                         const float* __restrict__ W, int ldw,
                                         int cbase, int cstride,
                                         float (&acc)[TM][TN]) {
  const float* wl = W + cbase + (threadIdx.x & 31);
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float w[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        w[j] = __ldg(wl + (size_t)(k + kk) * ldw + j * cstride);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
      }
    }
  }
}

// LayerNorm of n rows of C = 256, a warp a row (a lane the 8 channels
// 4 lane + {0..3} and 128 + 4 lane + {0..3}): f32 mean and centred
// variance, (x - mean) / sqrt(var + eps) * g + b. Rows at and past `valid`
// are written as zeros (the tile's padding rows).
__device__ void ln_rows(const float* in, int ldin, float* out, int ldout,
                        int n, int valid, const float* g, const float* b,
                        float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = 4 * lane, c1 = 128 + 4 * lane;
  const float4 ga = *reinterpret_cast<const float4*>(g + c0);
  const float4 gb = *reinterpret_cast<const float4*>(g + c1);
  const float4 ba = *reinterpret_cast<const float4*>(b + c0);
  const float4 bb = *reinterpret_cast<const float4*>(b + c1);
  for (int r = warp; r < n; r += NW) {
    float4* o0 = reinterpret_cast<float4*>(out + (size_t)r * ldout + c0);
    float4* o1 = reinterpret_cast<float4*>(out + (size_t)r * ldout + c1);
    if (r >= valid) {
      *o0 = make_float4(0.f, 0.f, 0.f, 0.f);
      *o1 = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    float4 u = *reinterpret_cast<const float4*>(in + (size_t)r * ldin + c0);
    float4 v = *reinterpret_cast<const float4*>(in + (size_t)r * ldin + c1);
    const float mean =
        warp_sum(((u.x + u.y) + (u.z + u.w)) + ((v.x + v.y) + (v.z + v.w))) *
        (1.0f / CW);
    u.x -= mean; u.y -= mean; u.z -= mean; u.w -= mean;
    v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
    const float q = warp_sum(((u.x * u.x + u.y * u.y) + (u.z * u.z + u.w * u.w)) +
                             ((v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w)));
    const float inv = 1.0f / sqrtf(q * (1.0f / CW) + eps);
    *o0 = make_float4(u.x * inv * ga.x + ba.x, u.y * inv * ga.y + ba.y,
                      u.z * inv * ga.z + ba.z, u.w * inv * ga.w + ba.w);
    *o1 = make_float4(v.x * inv * gb.x + bb.x, v.y * inv * gb.y + bb.y,
                      v.z * inv * gb.z + bb.z, v.w * inv * gb.w + bb.w);
  }
}

__global__ void __launch_bounds__(NT, 1) block_fwd_f32_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);
  float* H = X + TR * CW;
  float* O = H + TR * CW;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = p.N, cpt = TR / N;
  const int clip0 = blockIdx.x * cpt;
  const int rows = min(cpt, p.clips - clip0) * N;
  const size_t g0 = (size_t)clip0 * N * CW;
  const float* x = p.x + g0;
  // The warp's rows and column half in every product.
  const int r0 = (warp >> 1) * TM, half = warp & 1;

  // LN1: H = LN(x).
  ln_rows(x, CW, H, CW, TR, rows, p.g1, p.b1, p.eps);
  __syncthreads();

  // Attention, a pair of heads at a time: head 2 hp + u's q [64, 32],
  // k^T [32, 65] and v [64, 32] in X's space at u * QKV_F.
  for (int hp = 0; hp < CW / DH / 2; ++hp) {
    {
      const int h = 2 * hp + half;
      float* Q = X + half * QKV_F;
      float* KT = Q + TR * DH;
      float* Vh = KT + DH * KT_LD;
      float acc[TM][3] = {};
      tile_mac<3>(H + r0 * CW, CW, CW, p.wqkv, 3 * CW, h * DH, CW, acc);
      const float bq = p.bqkv[h * DH + lane];
      const float bk = p.bqkv[CW + h * DH + lane];
      const float bv = p.bqkv[2 * CW + h * DH + lane];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = r0 + i;
        Q[r * DH + lane] = (acc[i][0] + bq) * p.qscale;
        KT[lane * KT_LD + r] = acc[i][1] + bk;
        Vh[r * DH + lane] = acc[i][2] + bv;
      }
    }
    __syncthreads();
    for (int t = warp; t < 2 * TR; t += NW) {
      const int u = t / TR, r = t % TR, h = 2 * hp + u;
      const float* Q = X + u * QKV_F;
      const float* KT = Q + TR * DH;
      const float* Vh = KT + DH * KT_LD;
      if (r >= rows) {
        O[r * CW + h * DH + lane] = 0.f;
        continue;
      }
      const int kb = r / N * N;
      const bool has0 = lane < N, has1 = lane + 32 < N;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float qd = Q[r * DH + d];
        s0 = fmaf(qd, KT[d * KT_LD + kb + min(lane, N - 1)], s0);
        s1 = fmaf(qd, KT[d * KT_LD + kb + min(lane + 32, N - 1)], s1);
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
        o = fmaf(pj, Vh[(kb + j) * DH + lane], o);
      }
      O[r * CW + h * DH + lane] = o / l;
    }
    __syncthreads();
  }

  // proj: X = x1 = x + (O Wproj + bproj).
  const int cw = half * (CW / 2);  // the warp's output columns
  {
    float acc[TM][4] = {};
    tile_mac<4>(O + r0 * CW, CW, CW, p.wproj, CW, cw, 32, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cw + lane + 32 * j;
        const float res = r < rows ? __ldg(x + (size_t)r * CW + c) : 0.f;
        X[r * CW + c] = res + (acc[i][j] + p.bproj[c]);
      }
    }
  }
  __syncthreads();
  // LN2: H = LN(x1).
  ln_rows(X, CW, H, CW, TR, TR, p.g2, p.b2, p.eps);
  __syncthreads();

  // MLP in hidden chunks of HC: fc1 + GELU into O ([64, HC]), fc2 summed in
  // registers over the chunks.
  float acc2[TM][4] = {};
  for (int ch = 0; ch < p.hid; ch += HC) {
    {
      const int ch2 = half * (HC / 2);
      float acc[TM][HC / 64] = {};
      tile_mac<HC / 64>(H + r0 * CW, CW, CW, p.w1, p.hid, ch + ch2, 32, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < HC / 64; ++j) {
          const int c = ch2 + lane + 32 * j;
          O[(r0 + i) * HC + c] = gelu_erf(acc[i][j] + p.bb1[ch + c]);
        }
    }
    __syncthreads();
    tile_mac<4>(O + r0 * HC, HC, HC, p.w2 + (size_t)ch * CW, CW, cw, 32,
                acc2);
    __syncthreads();
  }

  // y = x1 + (fc2 + bb2), then the post-norm (or y itself) out.
  float* out = p.out + g0;
  const bool post = p.gp != nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cw + lane + 32 * j;
      const float y = X[r * CW + c] + (acc2[i][j] + p.bb2[c]);
      if (post)
        X[r * CW + c] = y;
      else if (r < rows)
        out[(size_t)r * CW + c] = y;
    }
  }
  if (post) {
    __syncthreads();
    ln_rows(X, CW, out, CW, rows, rows, p.gp, p.bp, p.post_eps);
  }
}

constexpr int SMEM_BYTES = 3 * TR * CW * 4;

}  // namespace bf32

// Host entry points.

// The f32 forward over [clips, N, 256] tokens, N <= 64, hid a multiple of
// 128. ptrs: x, out, wqkv [256, 768], wproj [256, 256], w1 [256, hid],
// w2 [hid, 256] (f32, [in, out] as the parameters are), g1, b1, bqkv, bproj,
// g2, b2, bb1, bb2, gp, bp (gp and bp null without a post-norm).
extern "C" int pmce_block_fwd_f32(void* const* ptrs, int clips, int N,
                                  int hid, float eps, float post_eps,
                                  float qscale, void* stream) {
  using namespace bf32;
  if (clips <= 0 || N <= 0 || N > TR || hid <= 0 || hid % HC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  Args a;
  a.x = cf(0);
  a.out = static_cast<float*>(ptrs[1]);
  a.wqkv = cf(2); a.wproj = cf(3); a.w1 = cf(4); a.w2 = cf(5);
  a.g1 = cf(6); a.b1 = cf(7); a.bqkv = cf(8); a.bproj = cf(9);
  a.g2 = cf(10); a.b2 = cf(11); a.bb1 = cf(12); a.bb2 = cf(13);
  a.gp = cf(14); a.bp = cf(15);
  a.clips = clips; a.N = N; a.hid = hid;
  a.eps = eps; a.post_eps = post_eps; a.qscale = qscale;
  if ((a.gp == nullptr) != (a.bp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      block_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cpt = TR / N;
  const int tiles = (clips + cpt - 1) / cpt;
  block_fwd_f32_kernel<<<tiles, NT, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_block_f32_error_string)
