// One CoevoBlock's token program on one clip, shared by the whole-chain
// kernel (coevo_chain.cu, all blocks plus their coordinate heads) and the
// whole-block kernel (coevo_block.cu, one block, features in and out).
//
// Both run one thread block of NT threads per clip. The vertex stream and
// its temporaries live in dynamic shared memory: an f32 [V, C] stream
// buffer and two bf16 [V, C] buffers, 512 * V bytes in all (220,672 B at
// V = 431), plus 16 padding rows. Each stage reuses whichever buffer is
// dead at that point (the plan is spelled out in coevo_block_body), so no
// [V, C] intermediate leaves the SM. The joint stream ([J, C], 19 rows) and
// its temporaries live in a per-clip workspace in global memory, which L1
// and L2 hold, as do the weights.
//
// The bf16 shared-memory buffers are swizzled: the 16-byte chunk c of row
// r sits at chunk c ^ (r % 8), so the eight rows an ldmatrix phase reads
// (128-byte rows, one bank set each) fall on eight different banks.
// Products run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// sums): A from shared memory through ldmatrix (or from the workspace),
// B from the transposed weight [N, K] in global memory (L1 / L2), and
// each epilogue (bias, q scale, erf-GELU, residual adds) works on the
// accumulator fragments in registers and stores column pairs, with no
// staging. The vertex queries' attention (self-attention 431 x 431 and
// cross-attention over the J joints, heads of 32) runs on the tensor cores
// too: a warp takes 16 queries of one head and walks the keys in blocks of
// 16, S = QK^T and the online-softmax state in f32 registers, P re-packed
// as bf16 A fragments for O = PV. The joint queries (heads of 8) stay on
// the CUDA cores: over the V vertices three lanes split each (query,
// head)'s keys and merge their softmax states by shuffles; over the J
// joints a thread takes one (query, head). No atomics, and a fixed order of
// every sum.
#pragma once

#include "common.cuh"

namespace coevo {

constexpr int NT = 512;    // threads per block
constexpr int CC = 64;     // channel width C of both streams
constexpr int HID = 256;   // MLP hidden width (4C)
constexpr int HJ = 8;      // joint-stream heads
constexpr int HV = 2;      // vertex-stream heads
constexpr int DHJ = CC / HJ;
constexpr int DHV = CC / HV;

// One block's parameter table (device array of pointers), in the order of
// the JAX package's ``fused_coevo_block`` params tuple. Products are
// stored transposed, W^T [N, K] bf16 (the B fragments' layout).
enum {
  K_JPOS = 0, K_VPOS, K_JQ, K_VQ, K_V2JK, K_J2VK,      // f32 [J|V, C]
  K_WV2J, K_BV2J, K_WJ2V, K_BJ2V,                      // [C,C]^T bf16, [C]
  K_CAJ = 10,  // 12: wq bq wk bk wv bv wproj bproj w1 bb1 w2 bb2
  K_CAV = 22,  // 12
  K_SAJ = 34,  // 8: wqkv bqkv wproj bproj w1 bb1 w2 bb2
  K_SAV = 42,  // 8
  K_COUNT = 50
};

// Offset of element (r, c) of a bf16 buffer with row stride ld (a multiple
// of 64); sw: the swizzled layout of the shared-memory buffers.
__device__ __forceinline__ int off(int r, int c, int ld, bool sw) {
  return sw ? r * ld + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7) : r * ld + c;
}

// A bf16 matrix operand: base, row stride, layout.
struct Mat {
  bf16* p;
  int ld;
  bool sw;
  __device__ __forceinline__ bf16* at(int r, int c) const {
    return p + off(r, c, ld, sw);
  }
  __device__ __forceinline__ Mat rows(int r0) const {  // r0 % 8 == 0
    return Mat{p + (size_t)r0 * ld, ld, sw};
  }
};

enum { E_BIAS = 0, E_SCALE, E_ADDMAT, E_RES, E_GELU, E_ACC };

// out[n, N] = epilogue(A[n, K] @ W + bias), W given as W^T [N, K] (row
// stride K). Warp tasks of RM 16-row tiles x NN 8-column tiles; A rows past
// n are read as row n - 1 (their results are dropped), so no buffer needs
// padding rows. A from shared memory (ASM: ldmatrix) or the workspace
// (32-bit loads). A task reads all K columns of its own rows before it
// writes them, so out may alias A only when N == K == 8 * NN. Epilogues:
//   E_BIAS / E_SCALE: bf16 out = v (* scale); E_ADDMAT: bf16 out = v +
//   addm[r, c] (f32, row stride C); E_RES: f32 outf = res + v (res bf16);
//   E_GELU: bf16 out = gelu(v); E_ACC: f32 outf += v.
template <int EPI, int RM, int NN, bool ASM, int K>
__device__ void gemm_tc(Mat A, int n, const bf16* Wt, int N,
                        const float* bias, Mat out, float* outf,
                        const float* addm, Mat res, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ctiles = N / (8 * NN);
  const int tasks = (n + 16 * RM - 1) / (16 * RM) * ctiles;
  for (int task = warp; task < tasks; task += NT / 32) {
    const int r0 = task / ctiles * 16 * RM, c0 = task % ctiles * 8 * NN;
    float acc[RM][NN][4];
#pragma unroll
    for (int mi = 0; mi < RM; ++mi)
#pragma unroll
      for (int nj = 0; nj < NN; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      unsigned af[RM][4];
#pragma unroll
      for (int mi = 0; mi < RM; ++mi) {
        if constexpr (ASM) {
          const int r = min(r0 + mi * 16 + (lane & 15), n - 1);
          ldsm_x4(af[mi], A.at(r, k + (lane >> 4) * 8));
        } else {
          const int ra = min(r0 + mi * 16 + g, n - 1);
          const int rb = min(r0 + mi * 16 + g + 8, n - 1);
          af[mi][0] = *reinterpret_cast<const unsigned*>(A.at(ra, k + 2 * tq));
          af[mi][1] = *reinterpret_cast<const unsigned*>(A.at(rb, k + 2 * tq));
          af[mi][2] =
              *reinterpret_cast<const unsigned*>(A.at(ra, k + 8 + 2 * tq));
          af[mi][3] =
              *reinterpret_cast<const unsigned*>(A.at(rb, k + 8 + 2 * tq));
        }
      }
#pragma unroll
      for (int nj = 0; nj < NN; ++nj) {
        const bf16* wr = Wt + (size_t)(c0 + nj * 8 + g) * K + k + 2 * tq;
        const unsigned b0 = __ldg(reinterpret_cast<const unsigned*>(wr));
        const unsigned b1 = __ldg(reinterpret_cast<const unsigned*>(wr + 8));
#pragma unroll
        for (int mi = 0; mi < RM; ++mi) mma_bf16(acc[mi][nj], af[mi], b0, b1);
      }
    }
#pragma unroll
    for (int nj = 0; nj < NN; ++nj) {
      const int c = c0 + nj * 8 + 2 * tq;
      const float bz0 = bias[c], bz1 = bias[c + 1];
#pragma unroll
      for (int mi = 0; mi < RM; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + mi * 16 + g + 8 * hf;
          if (r >= n) continue;
          const float v0 = acc[mi][nj][2 * hf] + bz0;
          const float v1 = acc[mi][nj][2 * hf + 1] + bz1;
          unsigned* o2 = reinterpret_cast<unsigned*>(out.p ? out.at(r, c)
                                                           : nullptr);
          float2* of = reinterpret_cast<float2*>(outf + (size_t)r * N + c);
          if (EPI == E_BIAS) {
            *o2 = pack_bf2(v0, v1);
          } else if (EPI == E_SCALE) {
            *o2 = pack_bf2(v0 * scale, v1 * scale);
          } else if (EPI == E_ADDMAT) {
            const float2 m =
                *reinterpret_cast<const float2*>(addm + (size_t)r * CC + c);
            *o2 = pack_bf2(v0 + m.x, v1 + m.y);
          } else if (EPI == E_RES) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res.at(r, c)));
            *of = make_float2(rv.x + v0, rv.y + v1);
          } else if (EPI == E_GELU) {
            *o2 = pack_bf2(gelu_erf(v0), gelu_erf(v1));
          } else {
            float2 cur = *of;
            cur.x += v0;
            cur.y += v1;
            *of = cur;
          }
        }
    }
  }
}

// The product shapes: vertex rows (A in shared memory) in 16 x 64 tasks
// (in place allowed), joint rows (A in the workspace) in 16 x 16 tasks.
template <int EPI>
__device__ __forceinline__ void gemm_v(Mat A, int n, const bf16* Wt,
                                       const float* bias, Mat out,
                                       float* outf, const float* addm,
                                       Mat res, float scale) {
  gemm_tc<EPI, 1, 8, true, CC>(A, n, Wt, CC, bias, out, outf, addm, res,
                               scale);
}
template <int EPI>
__device__ __forceinline__ void gemm_j(Mat A, int n, const bf16* Wt,
                                       const float* bias, Mat out,
                                       float* outf, const float* addm,
                                       Mat res, float scale) {
  gemm_tc<EPI, 1, 2, false, CC>(A, n, Wt, CC, bias, out, outf, addm, res,
                                scale);
}

// Reference AdaLayerNorm on rows of C = 64: unbiased std, eps outside the
// sqrt, f32 statistics; one warp per row. May run in place.
__device__ __forceinline__ float ld_el(const float* p, int r, int c, bool) {
  return p[r * CC + c];
}
__device__ __forceinline__ float ld_el(const bf16* p, int r, int c, bool sw) {
  return bf2f(p[off(r, c, CC, sw)]);
}

// Two rows per warp at a time, so that their reductions overlap.
template <typename T>
__device__ void adaln_rows(const T* in, bool insw, Mat out, int n,
                           const float* gamma, const float* beta, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float ga = gamma[lane], gb = gamma[lane + 32];
  const float ba = beta[lane], bb = beta[lane + 32];
  for (int r0 = 2 * warp; r0 < n; r0 += NT / 16) {
    float a[2], b[2], s[2], q[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = min(r0 + u, n - 1);
      a[u] = ld_el(in, r, lane, insw);
      b[u] = ld_el(in, r, lane + 32, insw);
      s[u] = a[u] + b[u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u] *= 1.0f / CC;
      a[u] -= s[u];
      b[u] -= s[u];
      q[u] = a[u] * a[u] + b[u] * b[u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        q[u] += __shfl_xor_sync(0xffffffffu, q[u], o);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (r0 + u >= n) continue;
      const float inv = 1.0f / (sqrtf(q[u] * (1.0f / (CC - 1))) + eps);
      *out.at(r0 + u, lane) = f2bf(ga * (a[u] * inv) + ba);
      *out.at(r0 + u, lane + 32) = f2bf(gb * (b[u] * inv) + bb);
    }
  }
}

// out = bf16(f32(x) + e) over n rows (e f32 [n, C], row-major), one
// 8-channel chunk (16 bytes of bf16) a thread at a time.
__device__ __forceinline__ void add_rows(const bf16* x, bool xsw,
                                         const float* e, Mat out, int n) {
  for (int i = threadIdx.x; i < n * CC / 8; i += NT) {
    const int r = i / (CC / 8), c = i % (CC / 8) * 8;
    float v[8];
    load8(x + off(r, c, CC, xsw), v);
    const float4 e0 = *reinterpret_cast<const float4*>(e + (size_t)i * 8);
    const float4 e1 = *reinterpret_cast<const float4*>(e + (size_t)i * 8 + 4);
    *reinterpret_cast<uint4*>(out.at(r, c)) = make_uint4(
        pack_bf2(v[0] + e0.x, v[1] + e0.y), pack_bf2(v[2] + e0.z, v[3] + e0.w),
        pack_bf2(v[4] + e1.x, v[5] + e1.y),
        pack_bf2(v[6] + e1.z, v[7] + e1.w));
  }
}

// out = bf16(x) over n rows of the f32 [n, C] x, a chunk at a time.
__device__ __forceinline__ void round_rows(const float* x, Mat out, int n) {
  for (int i = threadIdx.x; i < n * CC / 8; i += NT) {
    const float4 a = *reinterpret_cast<const float4*>(x + (size_t)i * 8);
    const float4 b = *reinterpret_cast<const float4*>(x + (size_t)i * 8 + 4);
    *reinterpret_cast<uint4*>(out.at(i / (CC / 8), i % (CC / 8) * 8)) =
        make_uint4(pack_bf2(a.x, a.y), pack_bf2(a.z, a.w),
                   pack_bf2(b.x, b.y), pack_bf2(b.z, b.w));
  }
}

// Multi-head attention on the CUDA cores, one thread per (query, head),
// online softmax in f32 over the nk keys, q/k/v read 8 channels (one
// 16-byte chunk) at a time. q is pre-scaled; out may alias q.
template <int DH>
__device__ void attn_rows(Mat q, Mat k, Mat v, Mat out, int nq, int nk,
                          int heads) {
  for (int t = threadIdx.x; t < nq * heads; t += NT) {
    const int h = t / nq, i = t % nq;
    float qr[DH], o[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(q.at(i, h * DH + d), qr + d);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        float kv[8];
        load8(k.at(j, h * DH + d), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += qr[d + e] * kv[e];
      }
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), p = expf(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        float vv[8];
        load8(v.at(j, h * DH + d), vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[d + e] = o[d + e] * corr + p * vv[e];
      }
      m = mn;
    }
    const float inv = 1.0f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) *out.at(i, h * DH + d) = f2bf(o[d] * inv);
  }
}

// Attention of few queries over many keys (the joint cross-attention: J
// queries, 8 heads of 8, over the V vertices): three lanes of a warp split
// one (query, head)'s keys in thirds, each runs an online softmax in f32,
// and the first lane merges the three states, pulled by shuffles in a
// fixed order; ten (query, head) pairs a warp. q is pre-scaled; out may
// alias q.
template <int DH>
__device__ void attn_split3(Mat q, Mat k, Mat v, Mat out, int nq, int nk,
                            int heads) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = lane % 3, per = (nk + 2) / 3;
  for (int base = warp * 10; base < nq * heads; base += NT / 32 * 10) {
    const int t = base + lane / 3;
    const bool act = lane < 30 && t < nq * heads;
    const int h = act ? t / nq : 0, i = act ? t % nq : 0;
    float qr[DH], o[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(q.at(i, h * DH + d), qr + d);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    const int j1 = act ? min(nk, (part + 1) * per) : 0;
    for (int j = part * per; j < j1; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        float kv[8];
        load8(k.at(j, h * DH + d), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += qr[d + e] * kv[e];
      }
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), p = expf(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        float vv[8];
        load8(v.at(j, h * DH + d), vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[d + e] = o[d + e] * corr + p * vv[e];
      }
      m = mn;
    }
    // A third with no key keeps m = -inf and l = 0: its weight below is 0.
    const float m1 = __shfl_down_sync(0xffffffffu, m, 1);
    const float m2 = __shfl_down_sync(0xffffffffu, m, 2);
    const float l1 = __shfl_down_sync(0xffffffffu, l, 1);
    const float l2 = __shfl_down_sync(0xffffffffu, l, 2);
    const float mm = fmaxf(m, fmaxf(m1, m2));
    const float w0 = m == -INFINITY ? 0.f : expf(m - mm);
    const float w1 = m1 == -INFINITY ? 0.f : expf(m1 - mm);
    const float w2 = m2 == -INFINITY ? 0.f : expf(m2 - mm);
    const float inv = 1.0f / ((l * w0 + l1 * w1) + l2 * w2);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float o1 = __shfl_down_sync(0xffffffffu, o[d], 1);
      const float o2 = __shfl_down_sync(0xffffffffu, o[d], 2);
      o[d] = ((o[d] * w0 + o1 * w1) + o2 * w2) * inv;
    }
    if (act && part == 0) {
#pragma unroll
      for (int d = 0; d < DH; ++d) *out.at(i, h * DH + d) = f2bf(o[d]);
    }
  }
}

// Attention of the vertex queries on the tensor cores: heads of 32, q
// swizzled in shared memory and pre-scaled, k / v swizzled in shared
// memory (KVS: the self-attention, ldmatrix) or in the workspace (the
// cross-attention over the J joints, 32-bit and 16-bit loads); a warp takes
// 16 queries of one head and walks the keys in blocks of 16 (rows past nk
// read as row nk - 1 and masked). out may alias q (a task writes only the
// rows and head it read).
template <bool KVS>
__device__ void attn_tc(Mat q, Mat k, Mat v, Mat out, int nq, int nk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tasks = (nq + 15) / 16 * HV;
  for (int task = warp; task < tasks; task += NT / 32) {
    const int q0 = task / HV * 16, hc = task % HV * DHV;
    unsigned qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(qa[ks], q.at(min(q0 + (lane & 15), nq - 1),
                           hc + ks * 16 + (lane >> 4) * 8));
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[4][4];
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    for (int kb = 0; kb < nk; kb += 16) {
      float sc[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
        unsigned kf[4];
        if constexpr (KVS) {
          ldsm_x4(kf, k.at(min(kb + t * 8 + (lane & 7), nk - 1),
                           hc + (lane >> 3) * 8));
        } else {
          const bf16* kr = k.at(min(kb + t * 8 + g, nk - 1), hc + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            kf[e] = *reinterpret_cast<const unsigned*>(kr + 8 * e);
        }
        mma_bf16(sc[t], qa[0], kf[0], kf[1]);
        mma_bf16(sc[t], qa[1], kf[2], kf[3]);
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kb + t * 8 + 2 * tq + e >= nk) {
            sc[t][e] = -INFINITY;
            sc[t][2 + e] = -INFINITY;
          }
          mx0 = fmaxf(mx0, sc[t][e]);
          mx1 = fmaxf(mx1, sc[t][2 + e]);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // Every block holds a valid key for every query, so the maxima are
      // finite from the first block on.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[t][e] = expf(sc[t][e] - mn0);
          sc[t][2 + e] = expf(sc[t][2 + e] - mn1);
        }
      l0 = l0 * c0 + ((sc[0][0] + sc[0][1]) + (sc[1][0] + sc[1][1]));
      l1 = l1 * c1 + ((sc[0][2] + sc[0][3]) + (sc[1][2] + sc[1][3]));
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        o[d][0] *= c0;
        o[d][1] *= c0;
        o[d][2] *= c1;
        o[d][3] *= c1;
      }
      const unsigned pa[4] = {pack_bf2(sc[0][0], sc[0][1]),
                              pack_bf2(sc[0][2], sc[0][3]),
                              pack_bf2(sc[1][0], sc[1][1]),
                              pack_bf2(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        unsigned vf[4];
        if constexpr (KVS) {
          ldsm_x4_t(vf, v.at(min(kb + (lane & 15), nk - 1),
                             hc + dp * 16 + (lane >> 4) * 8));
        } else {
          // vf[2 * j + h]: keys kb + 8h + 2 tq + {0, 1} at column
          // hc + dp * 16 + 8 j + g.
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + (e & 1) * 8 + 2 * tq;
            const int col = hc + dp * 16 + (e >> 1) * 8 + g;
            const bf16 lo = *v.at(min(key, nk - 1), col);
            const bf16 hi = *v.at(min(key + 1, nk - 1), col);
            vf[e] = static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
                    static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16;
          }
        }
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.0f / l0, i1 = 1.0f / l1;
    const int r0 = q0 + g, r1 = r0 + 8;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int c = hc + d * 8 + 2 * tq;
      if (r0 < nq)
        *reinterpret_cast<unsigned*>(out.at(r0, c)) =
            pack_bf2(o[d][0] * i0, o[d][1] * i0);
      if (r1 < nq)
        *reinterpret_cast<unsigned*>(out.at(r1, c)) =
            pack_bf2(o[d][2] * i1, o[d][3] * i1);
    }
  }
}

// Stage stamps of the --profile instantiation (ON = true): after a
// block-wide barrier thread 0 writes (what just finished, clock64()) into
// the clip's row of MAX_STAMPS pairs; the first stamp is "start". `what`
// is stage * 8 + kind (the ST_* and KD_* codes). The serving instantiation
// (ON = false) compiles every stamp away.
constexpr int MAX_STAMPS = 192;
enum { ST_IO = 0, ST_S1 = 1, ST_JCA = 2, ST_VCA = 3, ST_JSA = 4, ST_VSA = 5 };
enum { KD_OTHER = 0, KD_GEMM = 1, KD_ADALN = 2, KD_ATTN = 3, KD_FC1 = 4,
       KD_FC2 = 5 };

template <bool ON>
struct Stamps {
  long long* out;
  int n;
  __device__ __forceinline__ void operator()(int stage, int kind) {
    if constexpr (ON) {
      __syncthreads();
      if (threadIdx.x == 0 && n < MAX_STAMPS) {
        out[2 * n] = stage * 8 + kind;
        out[2 * n + 1] = clock64();
      }
      ++n;
    }
  }
};

// fc1 -> erf-GELU -> fc2 added into the f32 stream x, over row tiles whose
// [tile, HID] hidden block fits in `hid` (capacity hid_elems, at least 16
// rows); tiles are whole 16-row multiples, up to 128 rows. Vertex tiles
// (ASM): fc1 in 48 x 32 tasks, fc2 (K = 256) in 48 x 8 tasks, each weight
// fragment used for three row tiles and 16 tasks for a 96-row tile; joint
// rows: 16 x 64 and 16 x 16 tasks.
template <bool ASM, bool PROF>
__device__ __forceinline__ void mlp_rows(Mat h, int n, const void* const* w,
                                         float* x, Mat hid, int hid_elems,
                                         Stamps<PROF>& mark, int stage) {
  constexpr int RM = ASM ? 3 : 1;
  const int tile = min(128, hid_elems / HID / 16 * 16);
  for (int r0 = 0; r0 < n; r0 += tile) {
    const int nr = min(tile, n - r0);
    gemm_tc<E_GELU, RM, ASM ? 4 : 8, ASM, CC>(
        h.rows(r0), nr, static_cast<const bf16*>(w[0]), HID,
        static_cast<const float*>(w[1]), hid, nullptr, nullptr, Mat{}, 0.f);
    __syncthreads();
    mark(stage, KD_FC1);
    gemm_tc<E_ACC, RM, ASM ? 1 : 2, ASM, HID>(
        hid, nr, static_cast<const bf16*>(w[2]), CC,
        static_cast<const float*>(w[3]), Mat{}, x + (size_t)r0 * CC, nullptr,
        Mat{}, 0.f);
    __syncthreads();
    mark(stage, KD_FC2);
  }
}

// Three [V, C] buffers (f32, bf16, bf16) plus 16 rows past the last one
// (the MLP's hidden tiles use them).
__host__ __device__ inline long long clip_smem_bytes(int V) {
  return (long long)V * CC * 8 + 16 * CC * 2;
}

// Per-clip workspace: the joint-stream buffers, each with its rows padded
// to a multiple of 16.
__host__ __device__ inline long long clip_workspace_bytes(int J) {
  const long long Jp = (J + 15) / 16 * 16;
  const long long bytes = Jp * (18 * CC + 2 * HID);
  return (bytes + 255) / 256 * 256;
}

// Where one clip's buffers live: the vertex stream in shared memory
// (bf16 buffers swizzled), the joint stream in the clip's workspace.
struct ClipBuffers {
  float* XV;    // f32 [V, C] stream, or
  Mat XVa;      // two bf16 [V, C] buffers over the same bytes
  Mat XVb;
  Mat B1;       // bf16 [V, C]
  Mat B2;       // bf16 [V, C], then 16 rows; the MLP's hidden tiles
  Mat hidv;     // B2 as [.., HID] rows
  int hid_elems;
  Mat jf, jq, jav, jn, jt, kvk, kvv, jh;  // joint stream, bf16
  float* jx;                              // f32 [J, C] joint stream
  int Jp;
};

__device__ __forceinline__ ClipBuffers clip_buffers(unsigned char* smem,
                                                    unsigned char* ws,
                                                    int J, int V) {
  ClipBuffers s;
  const size_t vc = (size_t)V * CC;
  bf16* sb = reinterpret_cast<bf16*>(smem);
  s.XV = reinterpret_cast<float*>(smem);
  s.XVa = Mat{sb, CC, true};
  s.XVb = Mat{sb + vc, CC, true};
  s.B1 = Mat{sb + 2 * vc, CC, true};
  s.B2 = Mat{sb + 3 * vc, CC, true};
  s.hidv = Mat{sb + 3 * vc, HID, true};
  s.hid_elems = static_cast<int>(vc) + 16 * CC;
  s.Jp = (J + 15) / 16 * 16;
  const size_t jc = (size_t)s.Jp * CC;
  bf16* w = reinterpret_cast<bf16*>(ws);
  s.jf = Mat{w, CC, false};
  s.jq = Mat{w + jc, CC, false};
  s.jav = Mat{w + 2 * jc, CC, false};
  s.jn = Mat{w + 3 * jc, CC, false};
  s.jt = Mat{w + 4 * jc, CC, false};
  s.kvk = Mat{w + 5 * jc, CC, false};
  s.kvv = Mat{w + 6 * jc, CC, false};
  s.jh = Mat{w + 7 * jc, HID, false};
  s.jx = reinterpret_cast<float*>(w + 7 * jc + (size_t)s.Jp * HID);
  return s;
}

#define COEVO_WB(tab, i) static_cast<const bf16*>((tab)[i])
#define COEVO_WF(tab, i) static_cast<const float*>((tab)[i])

// One CoevoBlock from its pos-embedded features to its post-SA streams.
// On entry (after a __syncthreads) s.jf holds jf = bf16(jf0 + joint_pos)
// and s.B1 holds vf = bf16(vf0 + vertx_pos); P is the block's K_* table,
// gm / bt its 12 AdaLN gamma / beta rows (COEVO_SLOTS order). On return
// (after a __syncthreads) s.XV holds vertx2 and, with joint_live, s.jx
// holds joint2, both f32. Without joint_live (the chain's blocks before
// its last, whose joint outputs the next block overwrites: every block
// re-reads the original joints) the joint stream's CA+FFN and SA+FFN and
// the v->j projection they alone read are skipped; the vertex stream is
// the same bits either way.
template <bool PROF>
__device__ __forceinline__ void coevo_block_body(
    const ClipBuffers& s, const void* const* P, const float* gm,
    const float* bt, int J, int V, float eps, float scale_j, float scale_v,
    bool joint_live, Stamps<PROF>& mark) {
#define GAM(k) (gm + (k) * CC)
#define BET(k) (bt + (k) * CC)
  const Mat none{};
  // 1. The Q embed and the projections across: jq and j_as_v in the
  //    workspace; B2 = v_as_j.
  gemm_j<E_ADDMAT>(s.jf, J, COEVO_WB(P, K_WJ2V), COEVO_WF(P, K_BJ2V), s.jav,
                   nullptr, COEVO_WF(P, K_J2VK), none, 0.f);
  if (joint_live) {
    add_rows(s.jf.p, false, COEVO_WF(P, K_JQ), s.jq, J);
    gemm_v<E_ADDMAT>(s.B1, V, COEVO_WB(P, K_WV2J), COEVO_WF(P, K_BV2J), s.B2,
                     nullptr, COEVO_WF(P, K_V2JK), none, 0.f);
  }
  __syncthreads();
  mark(ST_S1, KD_GEMM);

  // 2. Joint CA + FFN: queries jq, keys v_as_j (B2), values vf (B1).
  //    k overwrites B2, normv goes to XVa and v to XVb.
  const void* const* CJ = P + K_CAJ;
  if (joint_live) {
    adaln_rows(s.B2.p, true, s.B2, V, GAM(1), BET(1), eps);
    adaln_rows(s.B1.p, true, s.XVa, V, GAM(2), BET(2), eps);
    adaln_rows(s.jq.p, false, s.jn, J, GAM(0), BET(0), eps);
    __syncthreads();
    mark(ST_JCA, KD_ADALN);
    gemm_v<E_BIAS>(s.B2, V, COEVO_WB(CJ, 2), COEVO_WF(CJ, 3), s.B2, nullptr,
                   nullptr, none, 0.f);
    gemm_v<E_BIAS>(s.XVa, V, COEVO_WB(CJ, 4), COEVO_WF(CJ, 5), s.XVb,
                   nullptr, nullptr, none, 0.f);
    gemm_j<E_SCALE>(s.jn, J, COEVO_WB(CJ, 0), COEVO_WF(CJ, 1), s.jt, nullptr,
                    nullptr, none, scale_j);
    __syncthreads();
    mark(ST_JCA, KD_GEMM);
    attn_split3<DHJ>(s.jt, s.B2, s.XVb, s.jt, J, V, HJ);
    __syncthreads();
    mark(ST_JCA, KD_ATTN);
    gemm_j<E_RES>(s.jt, J, COEVO_WB(CJ, 6), COEVO_WF(CJ, 7), none, s.jx,
                  nullptr, s.jq, 0.f);
    __syncthreads();
    mark(ST_JCA, KD_GEMM);
    adaln_rows(s.jx, false, s.jn, J, GAM(3), BET(3), eps);
    __syncthreads();
    mark(ST_JCA, KD_ADALN);
    mlp_rows<false>(s.jn, J, CJ + 8, s.jx, s.jh, s.Jp * HID, mark, ST_JCA);
  }

  // 3. Vertex CA + FFN: queries vq (B2), keys j_as_v, values jf.
  //    q overwrites B1 (vf is dead once vq exists); x1 goes to XV.
  const void* const* CV = P + K_CAV;
  add_rows(s.B1.p, true, COEVO_WF(P, K_VQ), s.B2, V);
  __syncthreads();
  adaln_rows(s.B2.p, true, s.B1, V, GAM(4), BET(4), eps);
  adaln_rows(s.jav.p, false, s.jn, J, GAM(5), BET(5), eps);
  adaln_rows(s.jf.p, false, s.jt, J, GAM(6), BET(6), eps);
  __syncthreads();
  mark(ST_VCA, KD_ADALN);
  gemm_v<E_SCALE>(s.B1, V, COEVO_WB(CV, 0), COEVO_WF(CV, 1), s.B1, nullptr,
                  nullptr, none, scale_v);
  gemm_j<E_BIAS>(s.jn, J, COEVO_WB(CV, 2), COEVO_WF(CV, 3), s.kvk, nullptr,
                 nullptr, none, 0.f);
  gemm_j<E_BIAS>(s.jt, J, COEVO_WB(CV, 4), COEVO_WF(CV, 5), s.kvv, nullptr,
                 nullptr, none, 0.f);
  __syncthreads();
  mark(ST_VCA, KD_GEMM);
  attn_tc<false>(s.B1, s.kvk, s.kvv, s.B1, V, J);
  __syncthreads();
  mark(ST_VCA, KD_ATTN);
  gemm_v<E_RES>(s.B1, V, COEVO_WB(CV, 6), COEVO_WF(CV, 7), none, s.XV,
                nullptr, s.B2, 0.f);
  __syncthreads();
  mark(ST_VCA, KD_GEMM);
  adaln_rows(s.XV, false, s.B1, V, GAM(7), BET(7), eps);
  __syncthreads();
  mark(ST_VCA, KD_ADALN);
  mlp_rows<true>(s.B1, V, CV + 8, s.XV, s.hidv, s.hid_elems, mark, ST_VCA);

  // 4. Joint SA + FFN on bf16(joint1): residual in jt, k / v in kvk / kvv,
  //    q and then the attention output in jq (dead since joint CA; a joint
  //    product's tasks are 16 columns wide, so none runs in place).
  const void* const* SJ = P + K_SAJ;
  if (joint_live) {
    round_rows(s.jx, s.jt, J);
    __syncthreads();
    adaln_rows(s.jt.p, false, s.jn, J, GAM(8), BET(8), eps);
    __syncthreads();
    mark(ST_JSA, KD_ADALN);
    gemm_j<E_BIAS>(s.jn, J, COEVO_WB(SJ, 0) + CC * CC, COEVO_WF(SJ, 1) + CC,
                   s.kvk, nullptr, nullptr, none, 0.f);
    gemm_j<E_BIAS>(s.jn, J, COEVO_WB(SJ, 0) + 2 * CC * CC,
                   COEVO_WF(SJ, 1) + 2 * CC, s.kvv, nullptr, nullptr, none,
                   0.f);
    __syncthreads();
    gemm_j<E_SCALE>(s.jn, J, COEVO_WB(SJ, 0), COEVO_WF(SJ, 1), s.jq, nullptr,
                    nullptr, none, scale_j);
    __syncthreads();
    mark(ST_JSA, KD_GEMM);
    attn_rows<DHJ>(s.jq, s.kvk, s.kvv, s.jq, J, J, HJ);
    __syncthreads();
    mark(ST_JSA, KD_ATTN);
    gemm_j<E_RES>(s.jq, J, COEVO_WB(SJ, 2), COEVO_WF(SJ, 3), none, s.jx,
                  nullptr, s.jt, 0.f);
    __syncthreads();
    mark(ST_JSA, KD_GEMM);
    adaln_rows(s.jx, false, s.jn, J, GAM(9), BET(9), eps);
    __syncthreads();
    mark(ST_JSA, KD_ADALN);
    mlp_rows<false>(s.jn, J, SJ + 4, s.jx, s.jh, s.Jp * HID, mark, ST_JSA);
  }

  // 5. Vertex SA + FFN on bf16(vertx1): residual in B2, normalised input
  //    in B1, k/v in XVa/XVb, q and then the attention output in B1.
  const void* const* SV = P + K_SAV;
  round_rows(s.XV, s.B2, V);
  __syncthreads();
  adaln_rows(s.B2.p, true, s.B1, V, GAM(10), BET(10), eps);
  __syncthreads();
  mark(ST_VSA, KD_ADALN);
  gemm_v<E_BIAS>(s.B1, V, COEVO_WB(SV, 0) + CC * CC, COEVO_WF(SV, 1) + CC,
                 s.XVa, nullptr, nullptr, none, 0.f);
  gemm_v<E_BIAS>(s.B1, V, COEVO_WB(SV, 0) + 2 * CC * CC,
                 COEVO_WF(SV, 1) + 2 * CC, s.XVb, nullptr, nullptr, none,
                 0.f);
  __syncthreads();
  gemm_v<E_SCALE>(s.B1, V, COEVO_WB(SV, 0), COEVO_WF(SV, 1), s.B1, nullptr,
                  nullptr, none, scale_v);
  __syncthreads();
  mark(ST_VSA, KD_GEMM);
  attn_tc<true>(s.B1, s.XVa, s.XVb, s.B1, V, V);
  __syncthreads();
  mark(ST_VSA, KD_ATTN);
  gemm_v<E_RES>(s.B1, V, COEVO_WB(SV, 2), COEVO_WF(SV, 3), none, s.XV,
                nullptr, s.B2, 0.f);
  __syncthreads();
  mark(ST_VSA, KD_GEMM);
  adaln_rows(s.XV, false, s.B1, V, GAM(11), BET(11), eps);
  __syncthreads();
  mark(ST_VSA, KD_ADALN);
  mlp_rows<true>(s.B1, V, SV + 4, s.XV, s.hidv, s.hid_elems, mark, ST_VSA);
#undef GAM
#undef BET
}

}  // namespace coevo
