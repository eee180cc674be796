// The decoder's CoevoBlock in f32 for Hopper (sm_90a): the whole chain and
// the whole block, the f32 serving forward.
//
// Replaces, where JAX's compute dtype is f32 (`PMCE(dtype=None,
// fused_attn=True)`):
// - pmce_tpu/ops/fused_coevo_chain.py `_chain_kernel` (entry
//   `fused_coevo_chain`): all CoevoBlocks of a clip with their f32
//   coordinate heads (pmce_coevo_chain_f32);
// - pmce_tpu/ops/fused_attention.py `_coevo_kernel` (entry
//   `fused_coevo_block`): one CoevoBlock a clip on its projected features,
//   the heads outside (pmce_coevo_block_f32).
// Per block, as the bf16 kernels (coevo_chain.cu, coevo_block.cu over
// coevo_ops.cuh) and with the reference quirks kept: the pos / Q / K
// embeds, the v->j and j->v projections, the joint CA+FFN (8 heads of 8, J
// queries over V keys) and vertex CA+FFN (2 heads of 32, V queries over J
// keys) on the pre-update streams, the AdaLN'd SA+FFN of each stream. Every
// tensor is f32: no cast point, no bf16 rounding anywhere.
//
// Products in true f32: FFMA on the CUDA cores, the same rule as
// block_f32.cu (one TF32 pass errs ~1e-3 relative and is not used; 3xTF32
// on mma.sync is left to a later pass that makes this faster).
//
// What bounds it on this card: the products, ~144 M flops a clip and block
// at V = 431, C = 64 (the vertex products and the vertex self-attention
// most of them): 110.9 GFLOP for the chain at B = 256, 1.65 ms at the 67
// TFLOP/s f32 CUDA-core peak, against ~11 MB of inputs and outputs.
//
// Shared memory, the design problem. The bf16 plan keeps an f32 [V, C]
// stream and two bf16 [V, C] temporaries on the SM (V C 8 + 16 C 2 bytes).
// In f32 a block needs three [V, C] buffers at once in the joint CA (its
// keys, its values, vf kept for the vertex queries) and four in the vertex
// SA (the stream as residual, q, k, v). Four f32 [V, C] buffers are 441 KB
// at V = 431, over the SM's 227 KB. The plan: two f32 [V, C]
// buffers in dynamic shared memory, S0 and S1, V C 8 = 220,672 bytes at
// V = 431 (so V <= 454 under sm_90's 232,448), and two more, G0 and G1, in
// a per-clip workspace in device memory beside the joint stream and the
// MLP's hidden tile ([64, 256] f32). What shared memory holds is what the
// inner loops read most: the attention's keys and values over V (S0 = k,
// S1 = v in the joint CA and in the vertex SA) and the vertex products' A
// operands; the workspace holds what is read once a stage (vf, the SA's q
// and its residual, the hidden tile). A clip's workspace is 384,512 bytes
// at J = 19, V = 431; the 132 resident clips' ~51 MB match the 50 MB L2,
// of which a stage touches a part (the L2 hit rate is not measured). The
// alternative, a cluster of 2 CTAs a clip splitting the vertex
// rows with the peer's keys read through distributed shared memory, halves
// each CTA's buffers but makes every attention key loop cross the cluster;
// it is the redesign to try when this kernel is made fast.
//
// The buffers of one block (stage: S0, S1, G0, G1):
//   entry      -, -, -, vf
//   1          v_as_j, -, -, vf
//   2 joint CA k, v (in place over the AdaLN'd inputs), -, vf
//   3 vertex   vq -> x1 -> vertx1, q -> o -> AdaLN(x1), -, - (vf read once)
//   4 joint SA (the joint stream only, in the workspace)
//   5 vertex   k -> x1 -> vertx2, v -> AdaLN(x1), AdaLN(vertx1) -> q -> o,
//              vertx1 (the residual)
// On return S0 holds vertx2 and, with joint_live, the workspace's jx holds
// joint2.
//
// Work split: one block of 512 threads (16 warps) a clip. A product is a
// set of warp tasks of TM rows x 32 TN columns (a lane a column every 32):
// the rows' A values are broadcast float4 reads (shared memory or the
// workspace), W is read from its own [in, out] layout, a coalesced row of
// 32 values through L1 / L2 per k (the chain's f32 weights, ~3 MB, stay
// in L2); a task of a product that runs in place reads all of its rows
// before its lanes write them. AdaLN runs a warp two rows. Attention runs
// on the CUDA cores, a thread a (query, head) with an online softmax over
// the keys; the joint queries over the V vertices split each (query,
// head)'s keys in thirds over three lanes, merged by shuffles in a fixed
// order. No atomics and a fixed order of every sum: a rerun gives the same
// bits.

#include "common.cuh"

namespace cf32 {

constexpr int NT = 512;  // threads per block
constexpr int NW = NT / 32;
constexpr int CC = 64;   // channel width C of both streams
constexpr int HID = 256; // MLP hidden width (4C)
constexpr int HJ = 8;    // joint-stream heads
constexpr int HV = 2;    // vertex-stream heads
constexpr int DHJ = CC / HJ;
constexpr int DHV = CC / HV;
constexpr int MT = 64;   // rows of the vertex MLP's hidden tile
constexpr int VM = 8;    // rows of a vertex product's warp task
constexpr int JM = 2;    // rows of a joint product's warp task

// One block's parameter table, in the order of the JAX package's
// ``fused_coevo_block`` params tuple, every entry f32; products as given,
// W [in, out] row-major.
enum {
  K_JPOS = 0, K_VPOS, K_JQ, K_VQ, K_V2JK, K_J2VK,  // [J|V, C]
  K_WV2J, K_BV2J, K_WJ2V, K_BJ2V,                  // [C, C], [C]
  K_CAJ = 10,  // 12: wq bq wk bk wv bv wproj bproj w1 bb1 w2 bb2
  K_CAV = 22,  // 12
  K_SAJ = 34,  // 8: wqkv bqkv wproj bproj w1 bb1 w2 bb2
  K_SAV = 42,  // 8
  K_COUNT = 50
};

enum { E_BIAS = 0, E_SCALE, E_ADDMAT, E_RES, E_GELU, E_ACC };

// out[n, N] = epilogue(A[n, K] @ W + bias): W the [K, N] column slice that
// starts at W with row stride ldw; A, out and aux with row strides lda,
// ldo and CC. Warp tasks of TM rows x 32 TN columns; A rows past n read as
// row n - 1 (their results are dropped). In place (out == A) only where a
// task spans all N columns (N == 32 TN): its lanes have all read its rows
// before any writes them. Epilogues (v = A W + bias): E_BIAS out = v;
// E_SCALE out = v * scale; E_ADDMAT out = v + aux; E_RES out = aux + v
// (aux may be out); E_GELU out = gelu(v); E_ACC out += v.
template <int EPI, int TM, int TN>
__device__ void gemm(const float* A, int lda, int n, int K,
                     const float* __restrict__ W, int ldw, int N,
                     const float* __restrict__ bias, float* out, int ldo,
                     const float* aux, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctiles = N / (32 * TN);
  const int tasks = (n + TM - 1) / TM * ctiles;
  for (int task = warp; task < tasks; task += NW) {
    const int r0 = task / ctiles * TM, c0 = task % ctiles * 32 * TN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const float* ar[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ar[i] = A + (size_t)min(r0 + i, n - 1) * lda;
    const float* wl = W + c0 + lane;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(ar[i] + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          w[j] = __ldg(wl + (size_t)(k + kk) * ldw + 32 * j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                           : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + lane + 32 * j;
        const float v = acc[i][j] + bias[c];
        float* o = out + (size_t)r * ldo + c;
        if (EPI == E_BIAS) {
          *o = v;
        } else if (EPI == E_SCALE) {
          *o = v * scale;
        } else if (EPI == E_ADDMAT) {
          *o = v + aux[(size_t)r * CC + c];
        } else if (EPI == E_RES) {
          *o = aux[(size_t)r * CC + c] + v;
        } else if (EPI == E_GELU) {
          *o = gelu_erf(v);
        } else {
          *o += v;
        }
      }
    }
  }
}

// The [n, C] x [C, C] products of each stream (W with row stride ldw:
// C, or 3C for a slice of the SA's qkv weight).
template <int EPI>
__device__ __forceinline__ void gemm_v(const float* A, int n, const float* W,
                                       int ldw, const float* bias, float* out,
                                       const float* aux, float scale) {
  gemm<EPI, VM, 2>(A, CC, n, CC, W, ldw, CC, bias, out, CC, aux, scale);
}
template <int EPI>
__device__ __forceinline__ void gemm_j(const float* A, int n, const float* W,
                                       int ldw, const float* bias, float* out,
                                       const float* aux, float scale) {
  gemm<EPI, JM, 2>(A, CC, n, CC, W, ldw, CC, bias, out, CC, aux, scale);
}

// Reference AdaLayerNorm on rows of C = 64: unbiased std, eps outside the
// sqrt, f32 statistics; a warp two rows at a time (a lane channels lane and
// lane + 32). May run in place. With `copy`, the input rows are also
// copied there.
__device__ void adaln(const float* in, float* out, int n, const float* gamma,
                      const float* beta, float eps, float* copy = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float ga = gamma[lane], gb = gamma[lane + 32];
  const float ba = beta[lane], bb = beta[lane + 32];
  for (int r0 = 2 * warp; r0 < n; r0 += 2 * NW) {
    float a[2], b[2], s[2], q[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = min(r0 + u, n - 1);
      a[u] = in[(size_t)r * CC + lane];
      b[u] = in[(size_t)r * CC + lane + 32];
      s[u] = a[u] + b[u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    if (copy) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (r0 + u >= n) continue;
        copy[(size_t)(r0 + u) * CC + lane] = a[u];
        copy[(size_t)(r0 + u) * CC + lane + 32] = b[u];
      }
    }
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
      out[(size_t)(r0 + u) * CC + lane] = ga * (a[u] * inv) + ba;
      out[(size_t)(r0 + u) * CC + lane + 32] = gb * (b[u] * inv) + bb;
    }
  }
}

// out = x + e over n rows of C (e.g. a pos embed), a float4 a thread.
__device__ __forceinline__ void add_rows(const float* x, const float* e,
                                         float* out, int n) {
  for (int i = threadIdx.x; i < n * CC / 4; i += NT) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 b = reinterpret_cast<const float4*>(e)[i];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

__device__ __forceinline__ void copy_rows(const float* x, float* out, int n) {
  for (int i = threadIdx.x; i < n * CC / 4; i += NT)
    reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(x)[i];
}

// Multi-head attention on the CUDA cores: P lanes a (query, head), each an
// online softmax in f32 over its part of the nk keys (a third for P = 3),
// the parts' states merged by shuffles in a fixed order by the group's
// first lane, which writes. q is pre-scaled; q, k, v and out have rows of
// C; out may alias q (a group writes only the row and head it read).
template <int DH, int P>
__device__ void attn(const float* q, const float* k, const float* v,
                     float* out, int nq, int nk, int heads) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int G = 32 / P;  // (query, head) groups a warp
  const int part = lane % P, span = (nk + P - 1) / P;
  for (int base = warp * G; base < nq * heads; base += NW * G) {
    const int t = base + lane / P;
    const bool act = lane < G * P && t < nq * heads;
    const int h = act ? t / nq : 0, i = act ? t % nq : 0;
    float qr[DH], o[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 f =
          *reinterpret_cast<const float4*>(q + (size_t)i * CC + h * DH + d);
      qr[d] = f.x; qr[d + 1] = f.y; qr[d + 2] = f.z; qr[d + 3] = f.w;
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    const int j1 = act ? min(nk, (part + 1) * span) : 0;
    for (int j = part * span; j < j1; ++j) {
      const float* kr = k + (size_t)j * CC + h * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 f = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(qr[d], f.x, s);
        s = fmaf(qr[d + 1], f.y, s);
        s = fmaf(qr[d + 2], f.z, s);
        s = fmaf(qr[d + 3], f.w, s);
      }
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), pj = expf(s - mn);
      l = l * corr + pj;
      const float* vr = v + (size_t)j * CC + h * DH;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 f = *reinterpret_cast<const float4*>(vr + d);
        o[d] = o[d] * corr + pj * f.x;
        o[d + 1] = o[d + 1] * corr + pj * f.y;
        o[d + 2] = o[d + 2] * corr + pj * f.z;
        o[d + 3] = o[d + 3] * corr + pj * f.w;
      }
      m = mn;
    }
    float inv;
    if constexpr (P == 1) {
      inv = 1.0f / l;
    } else {
      // A part with no key keeps m = -inf and l = 0: its weight is 0.
      float ms[P], ls[P], ws[P];
      float mm = m;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        ms[u] = u ? __shfl_down_sync(0xffffffffu, m, u) : m;
        ls[u] = u ? __shfl_down_sync(0xffffffffu, l, u) : l;
        mm = fmaxf(mm, ms[u]);
      }
      float lsum = 0.f;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        ws[u] = ms[u] == -INFINITY ? 0.f : expf(ms[u] - mm);
        lsum += ls[u] * ws[u];
      }
      inv = 1.0f / lsum;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        float od = o[d] * ws[0];
#pragma unroll
        for (int u = 1; u < P; ++u)
          od += __shfl_down_sync(0xffffffffu, o[d], u) * ws[u];
        o[d] = od;
      }
    }
    if (act && part == 0) {
#pragma unroll
      for (int d = 0; d < DH; ++d)
        out[(size_t)i * CC + h * DH + d] = o[d] * inv;
    }
  }
}

// fc1 -> erf-GELU -> fc2 added into the f32 stream x (rows of C), over row
// tiles of `tile` rows whose [tile, HID] hidden block goes to `hid`.
template <int TM>
__device__ void mlp(const float* h, int n, const void* const* w, float* x,
                    float* hid, int tile) {
  const float* w1 = static_cast<const float*>(w[0]);
  const float* b1 = static_cast<const float*>(w[1]);
  const float* w2 = static_cast<const float*>(w[2]);
  const float* b2 = static_cast<const float*>(w[3]);
  for (int r0 = 0; r0 < n; r0 += tile) {
    const int nr = min(tile, n - r0);
    gemm<E_GELU, TM, HID / 32>(h + (size_t)r0 * CC, CC, nr, CC, w1, HID, HID,
                               b1, hid, HID, nullptr, 0.f);
    __syncthreads();
    gemm<E_ACC, TM, 2>(hid, HID, nr, HID, w2, CC, CC, b2,
                       x + (size_t)r0 * CC, CC, nullptr, 0.f);
    __syncthreads();
  }
}

// Workspace rows of the joint stream, padded to a multiple of 16.
__host__ __device__ inline int joint_rows(int J) { return (J + 15) / 16 * 16; }

// Per-clip workspace, floats: G0, G1 [V, C], the vertex MLP's hidden tile
// [MT, HID], the joint stream's eight [Jp, C] buffers and its hidden
// [Jp, HID]; rounded up to 256 bytes.
__host__ __device__ inline long long workspace_bytes(int J, int V) {
  const long long Jp = joint_rows(J);
  const long long floats =
      2LL * V * CC + (long long)MT * HID + Jp * (8 * CC + HID);
  return (floats * 4 + 255) / 256 * 256;
}

__host__ __device__ inline long long smem_bytes(int V) {
  return 2LL * V * CC * 4;
}

struct Buffers {
  float *S0, *S1;                              // shared memory, [V, C]
  float *G0, *G1, *hid;                        // workspace, [V, C], [MT, HID]
  float *jf, *jq, *jav, *jn, *jt, *kvk, *kvv;  // workspace, [Jp, C]
  float *jx, *jh;                              // [Jp, C], [Jp, HID]
  int Jp;
};

__device__ __forceinline__ Buffers buffers(unsigned char* smem,
                                           unsigned char* ws, int J, int V) {
  Buffers s;
  const size_t vc = (size_t)V * CC;
  s.S0 = reinterpret_cast<float*>(smem);
  s.S1 = s.S0 + vc;
  float* w = reinterpret_cast<float*>(ws);
  s.G0 = w;
  s.G1 = w + vc;
  s.hid = w + 2 * vc;
  float* j = s.hid + (size_t)MT * HID;
  s.Jp = joint_rows(J);
  const size_t jc = (size_t)s.Jp * CC;
  s.jf = j;
  s.jq = j + jc;
  s.jav = j + 2 * jc;
  s.jn = j + 3 * jc;
  s.jt = j + 4 * jc;
  s.kvk = j + 5 * jc;
  s.kvv = j + 6 * jc;
  s.jx = j + 7 * jc;
  s.jh = j + 8 * jc;
  return s;
}

#define WF(tab, i) static_cast<const float*>((tab)[i])

// One CoevoBlock from its pos-embedded features to its post-SA streams.
// On entry (after a __syncthreads) s.jf holds jf = jf0 + joint_pos and
// s.G1 holds vf = vf0 + vertx_pos; P is the block's K_* table, gm / bt its
// 12 AdaLN gamma / beta rows (COEVO_SLOTS order). On return (after a
// __syncthreads) s.S0 holds vertx2 and, with joint_live, s.jx holds
// joint2. Without joint_live (the chain's blocks before its last, whose
// joint outputs the next block overwrites) the joint stream's CA+FFN and
// SA+FFN and the v->j projection they alone read are skipped.
__device__ void block_body(const Buffers& s, const void* const* P,
                           const float* gm, const float* bt, int J, int V,
                           float eps, float scale_j, float scale_v,
                           bool joint_live) {
#define GAM(k) (gm + (k) * CC)
#define BET(k) (bt + (k) * CC)
  // 1. The projections across (j_as_v in the workspace, v_as_j in S0) and
  //    the joint Q embed.
  gemm_j<E_ADDMAT>(s.jf, J, WF(P, K_WJ2V), CC, WF(P, K_BJ2V), s.jav,
                   WF(P, K_J2VK), 0.f);
  if (joint_live) {
    add_rows(s.jf, WF(P, K_JQ), s.jq, J);
    gemm_v<E_ADDMAT>(s.G1, V, WF(P, K_WV2J), CC, WF(P, K_BV2J), s.S0,
                     WF(P, K_V2JK), 0.f);
  }
  __syncthreads();

  // 2. Joint CA + FFN: queries jq, keys v_as_j (S0), values vf (G1); k in
  //    place in S0, v in S1.
  const void* const* CJ = P + K_CAJ;
  if (joint_live) {
    adaln(s.S0, s.S0, V, GAM(1), BET(1), eps);
    adaln(s.G1, s.S1, V, GAM(2), BET(2), eps);
    adaln(s.jq, s.jn, J, GAM(0), BET(0), eps);
    __syncthreads();
    gemm_v<E_BIAS>(s.S0, V, WF(CJ, 2), CC, WF(CJ, 3), s.S0, nullptr, 0.f);
    gemm_v<E_BIAS>(s.S1, V, WF(CJ, 4), CC, WF(CJ, 5), s.S1, nullptr, 0.f);
    gemm_j<E_SCALE>(s.jn, J, WF(CJ, 0), CC, WF(CJ, 1), s.jt, nullptr,
                    scale_j);
    __syncthreads();
    attn<DHJ, 3>(s.jt, s.S0, s.S1, s.jt, J, V, HJ);
    __syncthreads();
    gemm_j<E_RES>(s.jt, J, WF(CJ, 6), CC, WF(CJ, 7), s.jx, s.jq, 0.f);
    __syncthreads();
    adaln(s.jx, s.jn, J, GAM(3), BET(3), eps);
    __syncthreads();
    mlp<JM>(s.jn, J, CJ + 8, s.jx, s.jh, s.Jp);
  }

  // 3. Vertex CA + FFN: queries vq (S0, then x1 in place), keys j_as_v,
  //    values jf; q and then o in S1.
  const void* const* CV = P + K_CAV;
  add_rows(s.G1, WF(P, K_VQ), s.S0, V);
  __syncthreads();
  adaln(s.S0, s.S1, V, GAM(4), BET(4), eps);
  adaln(s.jav, s.jn, J, GAM(5), BET(5), eps);
  adaln(s.jf, s.jt, J, GAM(6), BET(6), eps);
  __syncthreads();
  gemm_v<E_SCALE>(s.S1, V, WF(CV, 0), CC, WF(CV, 1), s.S1, nullptr, scale_v);
  gemm_j<E_BIAS>(s.jn, J, WF(CV, 2), CC, WF(CV, 3), s.kvk, nullptr, 0.f);
  gemm_j<E_BIAS>(s.jt, J, WF(CV, 4), CC, WF(CV, 5), s.kvv, nullptr, 0.f);
  __syncthreads();
  attn<DHV, 1>(s.S1, s.kvk, s.kvv, s.S1, V, J, HV);
  __syncthreads();
  gemm_v<E_RES>(s.S1, V, WF(CV, 6), CC, WF(CV, 7), s.S0, s.S0, 0.f);
  __syncthreads();
  adaln(s.S0, s.S1, V, GAM(7), BET(7), eps);
  __syncthreads();
  mlp<VM / 2>(s.S1, V, CV + 8, s.S0, s.hid, MT);

  // 4. Joint SA + FFN on joint1 (jx, its own residual): k / v in kvk /
  //    kvv, q and then the attention output in jq.
  const void* const* SJ = P + K_SAJ;
  if (joint_live) {
    adaln(s.jx, s.jn, J, GAM(8), BET(8), eps);
    __syncthreads();
    gemm_j<E_BIAS>(s.jn, J, WF(SJ, 0) + CC, 3 * CC, WF(SJ, 1) + CC, s.kvk,
                   nullptr, 0.f);
    gemm_j<E_BIAS>(s.jn, J, WF(SJ, 0) + 2 * CC, 3 * CC, WF(SJ, 1) + 2 * CC,
                   s.kvv, nullptr, 0.f);
    gemm_j<E_SCALE>(s.jn, J, WF(SJ, 0), 3 * CC, WF(SJ, 1), s.jq, nullptr,
                    scale_j);
    __syncthreads();
    attn<DHJ, 1>(s.jq, s.kvk, s.kvv, s.jq, J, J, HJ);
    __syncthreads();
    gemm_j<E_RES>(s.jq, J, WF(SJ, 2), CC, WF(SJ, 3), s.jx, s.jx, 0.f);
    __syncthreads();
    adaln(s.jx, s.jn, J, GAM(9), BET(9), eps);
    __syncthreads();
    mlp<JM>(s.jn, J, SJ + 4, s.jx, s.jh, s.Jp);
  }

  // 5. Vertex SA + FFN on vertx1 (S0): AdaLN'd input in G0, the residual
  //    copied to G1; k in S0, v in S1, q and then o in place in G0; x1 into
  //    S0.
  const void* const* SV = P + K_SAV;
  adaln(s.S0, s.G0, V, GAM(10), BET(10), eps, s.G1);
  __syncthreads();
  gemm_v<E_BIAS>(s.G0, V, WF(SV, 0) + CC, 3 * CC, WF(SV, 1) + CC, s.S0,
                 nullptr, 0.f);
  gemm_v<E_BIAS>(s.G0, V, WF(SV, 0) + 2 * CC, 3 * CC, WF(SV, 1) + 2 * CC,
                 s.S1, nullptr, 0.f);
  __syncthreads();
  gemm_v<E_SCALE>(s.G0, V, WF(SV, 0), 3 * CC, WF(SV, 1), s.G0, nullptr,
                  scale_v);
  __syncthreads();
  attn<DHV, 1>(s.G0, s.S0, s.S1, s.G0, V, V, HV);
  __syncthreads();
  gemm_v<E_RES>(s.G0, V, WF(SV, 2), CC, WF(SV, 3), s.S0, s.G1, 0.f);
  __syncthreads();
  adaln(s.S0, s.S1, V, GAM(11), BET(11), eps);
  __syncthreads();
  mlp<VM / 2>(s.S1, V, SV + 4, s.S0, s.hid, MT);
#undef GAM
#undef BET
}

// The chain's per-block table: the 3 -> C projections, the block's own
// table (K_*), the coordinate heads; every entry f32.
enum {
  P_WJP = 0, P_BJP, P_WVP, P_BVP,                  // [3, C], [C]
  P_BLOCK = 4,                                     // K_COUNT entries
  P_WHJ = P_BLOCK + K_COUNT, P_BHJ, P_WHV, P_BHV,  // [C, 3], [3]
  P_COUNT = P_WHJ + 4
};

// out = (x @ W + b) + pos over n rows: the 3 -> C projection of [n, 3]
// coordinates with its embed add.
__device__ void embed3(const float* x, int n, const float* W, const float* b,
                       const float* pos, float* out) {
  for (int e = threadIdx.x; e < n * CC; e += NT) {
    const int r = e / CC, c = e % CC;
    const float* xr = x + (size_t)r * 3;
    out[e] = (((xr[0] * W[c] + xr[1] * W[CC + c]) + xr[2] * W[2 * CC + c]) +
              b[c]) + pos[e];
  }
}

// out[n, 3] = X[n, C] @ W[C, 3] + b + resid; out may alias resid.
__device__ void head3(const float* X, int n, const float* W, const float* b,
                      const float* resid, float* out) {
  for (int e = threadIdx.x; e < n * 3; e += NT) {
    const int r = e / 3, k = e % 3;
    float acc = 0.f;
    for (int c = 0; c < CC; ++c) acc += X[(size_t)r * CC + c] * W[c * 3 + k];
    out[e] = (acc + b[k]) + resid[e];
  }
}

__global__ void __launch_bounds__(NT, 1)
    chain_f32_kernel(const float* joints, float* jout, float* vout,
                     const float* gammas, const float* betas,
                     const void* const* params, unsigned char* ws,
                     long long ws_stride, int J, int V, int NB, float eps,
                     float scale_j, float scale_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const Buffers s = buffers(smem, ws + (size_t)b * ws_stride, J, V);
  const float* jin = joints + (size_t)b * J * 3;
  float* jo = jout + (size_t)b * J * 3;
  float* vc = vout + (size_t)b * V * 3;  // holds the current vertices
  for (int blk = 0; blk < NB; ++blk) {
    const void* const* P = params + (size_t)blk * P_COUNT;
    const void* const* K = P + P_BLOCK;
    // jf and vf (G1): the projections of the ORIGINAL joints and of the
    // current vertices, with their pos embeds.
    embed3(jin, J, WF(P, P_WJP), WF(P, P_BJP), WF(K, K_JPOS), s.jf);
    embed3(vc, V, WF(P, P_WVP), WF(P, P_BVP), WF(K, K_VPOS), s.G1);
    __syncthreads();
    // Every block re-reads the original joints, so only the last block's
    // joint stream reaches an output (evo_pose).
    const bool joint_live = blk == NB - 1;
    block_body(s, K, gammas + ((size_t)b * NB + blk) * 12 * CC,
               betas + ((size_t)b * NB + blk) * 12 * CC, J, V, eps, scale_j,
               scale_v, joint_live);
    if (joint_live)
      head3(s.jx, J, WF(P, P_WHJ), WF(P, P_BHJ), jin, jo);
    head3(s.S0, V, WF(P, P_WHV), WF(P, P_BHV), vc, vc);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 1)
    block_f32_kernel(const float* jf0, const float* vf0, float* jout,
                     float* vout, const float* gammas, const float* betas,
                     const void* const* params, unsigned char* ws,
                     long long ws_stride, int J, int V, float eps,
                     float scale_j, float scale_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const Buffers s = buffers(smem, ws + (size_t)b * ws_stride, J, V);
  const size_t jc = (size_t)J * CC, vc = (size_t)V * CC;
  add_rows(jf0 + b * jc, WF(params, K_JPOS), s.jf, J);
  add_rows(vf0 + b * vc, WF(params, K_VPOS), s.G1, V);
  __syncthreads();
  block_body(s, params, gammas + (size_t)b * 12 * CC,
             betas + (size_t)b * 12 * CC, J, V, eps, scale_j, scale_v, true);
  copy_rows(s.jx, jout + b * jc, J);
  copy_rows(s.S0, vout + b * vc, V);
}

}  // namespace cf32

// Host entry points.

extern "C" long long pmce_coevo_f32_workspace_bytes(int J, int V) {
  return cf32::workspace_bytes(J, V);
}

extern "C" long long pmce_coevo_f32_smem_bytes(int V) {
  return cf32::smem_bytes(V);
}

// joints / jout: f32 [B, J, 3]; vout: f32 [B, V, 3], the vertices on entry
// (moved in place); gammas / betas: f32 [B, NB, 12, C]; params: a device
// array of NB * P_COUNT pointers; ws: B * pmce_coevo_f32_workspace_bytes
// bytes.
extern "C" int pmce_coevo_chain_f32(const float* joints, float* jout,
                                    float* vout, const float* gammas,
                                    const float* betas, const void* params,
                                    void* ws, int B, int J, int V, int NB,
                                    float eps, float scale_j, float scale_v,
                                    void* stream) {
  using namespace cf32;
  if (B <= 0 || J <= 0 || V <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(V));
  cudaError_t e = cudaFuncSetAttribute(
      chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  chain_f32_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      joints, jout, vout, gammas, betas,
      static_cast<const void* const*>(params),
      static_cast<unsigned char*>(ws), workspace_bytes(J, V), J, V, NB, eps,
      scale_j, scale_v);
  return static_cast<int>(cudaGetLastError());
}

// jf0 / vf0 / jout / vout: f32 [B, J|V, C]; gammas / betas: f32
// [B, 12, C]; params: a device array of the K_COUNT pointers; ws:
// B * pmce_coevo_f32_workspace_bytes bytes.
extern "C" int pmce_coevo_block_f32(const float* jf0, const float* vf0,
                                    float* jout, float* vout,
                                    const float* gammas, const float* betas,
                                    const void* params, void* ws, int B,
                                    int J, int V, float eps, float scale_j,
                                    float scale_v, void* stream) {
  using namespace cf32;
  if (B <= 0 || J <= 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(V));
  cudaError_t e = cudaFuncSetAttribute(
      block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  block_f32_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      jf0, vf0, jout, vout, gammas, betas,
      static_cast<const void* const*>(params),
      static_cast<unsigned char*>(ws), workspace_bytes(J, V), J, V, eps,
      scale_j, scale_v);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_coevo_f32_error_string)
