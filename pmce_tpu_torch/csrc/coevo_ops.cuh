// One CoevoBlock's token program on one clip, shared by the whole-chain
// kernel (coevo_chain.cu, all blocks plus their coordinate heads) and the
// whole-block kernel (coevo_block.cu, one block, features in and out).
//
// Both run one thread block of NT threads per clip. The vertex stream and
// its temporaries live in dynamic shared memory: an f32 [V, C] stream
// buffer and two bf16 [V, C] buffers, 512 * V bytes in all (220,672 B at
// V = 431), plus 16 readable padding rows. Each stage reuses whichever
// buffer is dead at that point (the plan is spelled out in
// coevo_block_body), so no [V, C] intermediate leaves the SM. The joint
// stream ([J, C], 19 rows) and its temporaries live in a per-clip workspace
// in global memory, which L1 and L2 hold, as do the weights. Products run
// on the tensor cores (WMMA 16x16x16, bf16 operands, f32 sums), one
// 16 x 64 output tile per warp at a time, with each epilogue (bias, q
// scale, erf-GELU, residual adds) applied from a per-warp staging slice;
// the MLP's 4C hidden layer is processed in row tiles. Attention gives each
// thread one (query, head) and runs a max-stabilised online softmax in f32
// over the keys, so the 431 x 431 vertex self-attention never holds a
// score matrix.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace coevo {

using namespace nvcuda;

constexpr int NT = 512;    // threads per block
constexpr int CC = 64;     // channel width C of both streams
constexpr int HID = 256;   // MLP hidden width (4C)
constexpr int HJ = 8;      // joint-stream heads
constexpr int HV = 2;      // vertex-stream heads
constexpr int DHJ = CC / HJ;
constexpr int DHV = CC / HV;

// One block's parameter table (device array of pointers), in the order of
// the JAX package's ``fused_coevo_block`` params tuple.
enum {
  K_JPOS = 0, K_VPOS, K_JQ, K_VQ, K_V2JK, K_J2VK,      // f32 [J|V, C]
  K_WV2J, K_BV2J, K_WJ2V, K_BJ2V,                      // [C,C] bf16, [C]
  K_CAJ = 10,  // 12: wq bq wk bk wv bv wproj bproj w1 bb1 w2 bb2
  K_CAV = 22,  // 12
  K_SAJ = 34,  // 8: wqkv bqkv wproj bproj w1 bb1 w2 bb2
  K_SAV = 42,  // 8
  K_COUNT = 50
};

enum { E_BIAS = 0, E_SCALE, E_ADDMAT, E_RES, E_GELU, E_ACC };

template <int EPI>
__device__ __forceinline__ void epi_store(int r, int c, float v, void* out,
                                          int ldo, const void* aux,
                                          int ldaux, float scale) {
  const size_t o = (size_t)r * ldo + c;
  if (EPI == E_BIAS) {
    static_cast<bf16*>(out)[o] = f2bf(v);
  } else if (EPI == E_SCALE) {
    static_cast<bf16*>(out)[o] = f2bf(v * scale);
  } else if (EPI == E_ADDMAT) {
    static_cast<bf16*>(out)[o] =
        f2bf(v + static_cast<const float*>(aux)[(size_t)r * ldaux + c]);
  } else if (EPI == E_RES) {
    static_cast<float*>(out)[o] =
        bf2f(static_cast<const bf16*>(aux)[(size_t)r * ldaux + c]) + v;
  } else if (EPI == E_GELU) {
    static_cast<bf16*>(out)[o] = f2bf(gelu_erf(v));
  } else {
    static_cast<float*>(out)[o] += v;
  }
}

// out[n, N] = epilogue(A[n, K] @ W[K, N] + bias); W has row stride ldw.
// Tensor cores (WMMA 16x16x16, bf16 operands, f32 sums): each warp takes a
// 16-row x 64-column output tile at a time, A from shared memory or the
// workspace and W from global memory (L1/L2). Its accumulators pass through
// the warp's 1 KB staging slice for the epilogue. A warp reads A rows
// r0..r0+15 even past n (their outputs are dropped), so every A buffer has
// readable rows up to the next multiple of 16. A warp reads only its own
// rows of A before it writes the same rows of out, so out may alias A
// when N == K == 64 (one column tile per row tile).
template <int EPI>
__device__ void gemm_rows(const bf16* A, int lda, int n, int K, const bf16* W,
                          int ldw, int N, const float* bias, void* out,
                          int ldo, const void* aux, int ldaux, float scale,
                          float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
  const int col_tiles = N / 64;
  const int tasks = (n + 15) / 16 * col_tiles;
  for (int task = warp; task < tasks; task += NT / 32) {
    const int r0 = task / col_tiles * 16, c0 = task % col_tiles * 64;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + (size_t)r0 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w;
        wmma::load_matrix_sync(w, W + (size_t)k * ldw + c0 + 16 * j, ldw);
        wmma::mma_sync(acc[j], a, w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, c = c0 + 16 * j + e % 16;
        if (r < n)
          epi_store<EPI>(r, c, st[e] + bias[c], out, ldo, aux, ldaux, scale);
      }
      __syncwarp();
    }
  }
}

// Reference AdaLayerNorm on rows of C = 64: unbiased std, eps outside the
// sqrt, f32 statistics; one warp per row. May run in place.
template <typename T>
__device__ void adaln_rows(const T* in, int ldi, bf16* out, int ldo, int n,
                           const float* gamma, const float* beta, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += NT / 32) {
    const float a = ldf(in + (size_t)r * ldi + lane);
    const float b = ldf(in + (size_t)r * ldi + lane + 32);
    const float mean = warp_sum(a + b) * (1.0f / CC);
    const float da = a - mean, db = b - mean;
    const float var = warp_sum(da * da + db * db) * (1.0f / (CC - 1));
    const float inv = 1.0f / (sqrtf(var) + eps);
    out[(size_t)r * ldo + lane] = f2bf(gamma[lane] * (da * inv) + beta[lane]);
    out[(size_t)r * ldo + lane + 32] =
        f2bf(gamma[lane + 32] * (db * inv) + beta[lane + 32]);
  }
}

// out = bf16(f32(x) + e), elementwise over count values.
__device__ __forceinline__ void add_rows(const bf16* x, const float* e,
                                         bf16* out, int count) {
  for (int i = threadIdx.x; i < count; i += NT) out[i] = f2bf(bf2f(x[i]) + e[i]);
}

__device__ __forceinline__ void round_rows(const float* x, bf16* out,
                                           int count) {
  for (int i = threadIdx.x; i < count; i += NT) out[i] = f2bf(x[i]);
}

// Multi-head attention, one thread per (query, head), online softmax in
// f32 over the nk keys, q/k/v read 8 channels (16 bytes) at a time. q is
// pre-scaled; out may alias q.
template <int DH>
__device__ void attn_rows(const bf16* q, const bf16* k, const bf16* v,
                          bf16* out, int nq, int nk, int heads) {
  for (int t = threadIdx.x; t < nq * heads; t += NT) {
    const int h = t / nq, i = t % nq;
    float qr[DH], o[DH];
    const bf16* qp = q + (size_t)i * CC + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(qp + d, qr + d);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < nk; ++j) {
      const bf16* kp = k + (size_t)j * CC + h * DH;
      const bf16* vp = v + (size_t)j * CC + h * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        float kv[8];
        load8(kp + d, kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += qr[d + e] * kv[e];
      }
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn), p = expf(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        float vv[8];
        load8(vp + d, vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[d + e] = o[d + e] * corr + p * vv[e];
      }
      m = mn;
    }
    const float inv = 1.0f / l;
    bf16* op = out + (size_t)i * CC + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = f2bf(o[d] * inv);
  }
}

// fc1 -> erf-GELU -> fc2 added into the f32 stream x, over row tiles whose
// [tile, HID] hidden block fits in `hid` (capacity hid_elems, at least 16
// rows); tiles are whole 16-row multiples, up to 128 rows, so fc2 (one
// task per 16 rows) keeps several warps busy.
__device__ __forceinline__ void mlp_rows(const bf16* h, int n,
                                         const void* const* w, float* x,
                                         bf16* hid, int hid_elems,
                                         float* stage) {
  const int tile = min(128, hid_elems / HID / 16 * 16);
  for (int r0 = 0; r0 < n; r0 += tile) {
    const int nr = min(tile, n - r0);
    gemm_rows<E_GELU>(h + (size_t)r0 * CC, CC, nr, CC,
                      static_cast<const bf16*>(w[0]), HID, HID,
                      static_cast<const float*>(w[1]), hid, HID, nullptr, 0,
                      0.f, stage);
    __syncthreads();
    gemm_rows<E_ACC>(hid, HID, nr, HID, static_cast<const bf16*>(w[2]), CC,
                     CC, static_cast<const float*>(w[3]),
                     x + (size_t)r0 * CC, CC, nullptr, 0, 0.f, stage);
    __syncthreads();
  }
}

// Three [V, C] buffers (f32, bf16, bf16) plus 16 readable rows past the
// last one (the tensor-core tiles read A rows up to a multiple of 16).
__host__ __device__ inline long long clip_smem_bytes(int V) {
  return (long long)V * CC * 8 + 16 * CC * 2;
}

// Per-clip workspace: the warps' staging slices, then the joint-stream
// buffers, each with its rows padded to a multiple of 16.
__host__ __device__ inline long long clip_workspace_bytes(int J) {
  const long long Jp = (J + 15) / 16 * 16;
  const long long bytes = NT / 32 * 256 * 4 + Jp * (18 * CC + 2 * HID);
  return (bytes + 255) / 256 * 256;
}

// Where one clip's buffers live: the vertex stream in shared memory, the
// joint stream in the clip's workspace.
struct ClipBuffers {
  float* XV;   // f32 [V, C] stream, or
  bf16* XVa;   // two bf16 [V, C] buffers over the same bytes
  bf16* XVb;
  bf16* B1;    // bf16 [V, C]
  bf16* B2;    // bf16 [V, C], then 16 padding rows; the MLP's hidden tiles
  int hid_elems;
  float* stage;  // NT / 32 staging slices of 16 x 16 f32
  bf16 *jf, *jq, *jav, *jn, *jt, *kvk, *kvv, *jh;  // joint stream, bf16
  float* jx;                                      // f32 [J, C] joint stream
  int Jp;
};

__device__ __forceinline__ ClipBuffers clip_buffers(unsigned char* smem,
                                                    unsigned char* ws,
                                                    int J, int V) {
  ClipBuffers s;
  const size_t vc = (size_t)V * CC;
  s.XV = reinterpret_cast<float*>(smem);
  s.XVa = reinterpret_cast<bf16*>(smem);
  s.XVb = s.XVa + vc;
  s.B1 = reinterpret_cast<bf16*>(smem + vc * 4);
  s.B2 = s.B1 + vc;
  s.hid_elems = static_cast<int>(vc) + 16 * CC;
  s.Jp = (J + 15) / 16 * 16;
  const size_t jc = (size_t)s.Jp * CC;
  s.stage = reinterpret_cast<float*>(ws);
  s.jf = reinterpret_cast<bf16*>(s.stage + NT / 32 * 256);
  s.jq = s.jf + jc;
  s.jav = s.jq + jc;
  s.jn = s.jav + jc;
  s.jt = s.jn + jc;
  s.kvk = s.jt + jc;
  s.kvv = s.kvk + jc;
  s.jh = s.kvv + jc;
  s.jx = reinterpret_cast<float*>(s.jh + (size_t)s.Jp * HID);
  return s;
}

#define COEVO_WB(tab, i) static_cast<const bf16*>((tab)[i])
#define COEVO_WF(tab, i) static_cast<const float*>((tab)[i])

// One CoevoBlock from its pos-embedded features to its post-SA streams.
// On entry (after a __syncthreads) s.jf holds jf = bf16(jf0 + joint_pos)
// and s.B1 holds vf = bf16(vf0 + vertx_pos); P is the block's K_* table,
// gm / bt its 12 AdaLN gamma / beta rows (COEVO_SLOTS order). On return
// (after a __syncthreads) s.jx holds joint2 and s.XV vertx2, both f32.
__device__ __forceinline__ void coevo_block_body(
    const ClipBuffers& s, const void* const* P, const float* gm,
    const float* bt, int J, int V, float eps, float scale_j, float scale_v) {
#define GAM(k) (gm + (k) * CC)
#define BET(k) (bt + (k) * CC)
  float* stage = s.stage;
  // 1. The Q embed and the projections across: jq and j_as_v in the
  //    workspace; B2 = v_as_j.
  add_rows(s.jf, COEVO_WF(P, K_JQ), s.jq, J * CC);
  gemm_rows<E_ADDMAT>(s.jf, CC, J, CC, COEVO_WB(P, K_WJ2V), CC, CC,
                      COEVO_WF(P, K_BJ2V), s.jav, CC, COEVO_WF(P, K_J2VK),
                      CC, 0.f, stage);
  gemm_rows<E_ADDMAT>(s.B1, CC, V, CC, COEVO_WB(P, K_WV2J), CC, CC,
                      COEVO_WF(P, K_BV2J), s.B2, CC, COEVO_WF(P, K_V2JK), CC,
                      0.f, stage);
  __syncthreads();

  // 2. Joint CA + FFN: queries jq, keys v_as_j (B2), values vf (B1).
  //    k overwrites B2, normv goes to XVa and v to XVb.
  const void* const* CJ = P + K_CAJ;
  adaln_rows(s.B2, CC, s.B2, CC, V, GAM(1), BET(1), eps);
  adaln_rows(s.B1, CC, s.XVa, CC, V, GAM(2), BET(2), eps);
  adaln_rows(s.jq, CC, s.jn, CC, J, GAM(0), BET(0), eps);
  __syncthreads();
  gemm_rows<E_BIAS>(s.B2, CC, V, CC, COEVO_WB(CJ, 2), CC, CC,
                    COEVO_WF(CJ, 3), s.B2, CC, nullptr, 0, 0.f, stage);
  gemm_rows<E_BIAS>(s.XVa, CC, V, CC, COEVO_WB(CJ, 4), CC, CC,
                    COEVO_WF(CJ, 5), s.XVb, CC, nullptr, 0, 0.f, stage);
  gemm_rows<E_SCALE>(s.jn, CC, J, CC, COEVO_WB(CJ, 0), CC, CC,
                     COEVO_WF(CJ, 1), s.jt, CC, nullptr, 0, scale_j, stage);
  __syncthreads();
  attn_rows<DHJ>(s.jt, s.B2, s.XVb, s.jt, J, V, HJ);
  __syncthreads();
  gemm_rows<E_RES>(s.jt, CC, J, CC, COEVO_WB(CJ, 6), CC, CC,
                   COEVO_WF(CJ, 7), s.jx, CC, s.jq, CC, 0.f, stage);
  __syncthreads();
  adaln_rows(s.jx, CC, s.jn, CC, J, GAM(3), BET(3), eps);
  __syncthreads();
  mlp_rows(s.jn, J, CJ + 8, s.jx, s.jh, s.Jp * HID, stage);

  // 3. Vertex CA + FFN: queries vq (B2), keys j_as_v, values jf.
  //    q overwrites B1 (vf is dead once vq exists); x1 goes to XV.
  const void* const* CV = P + K_CAV;
  add_rows(s.B1, COEVO_WF(P, K_VQ), s.B2, V * CC);
  __syncthreads();
  adaln_rows(s.B2, CC, s.B1, CC, V, GAM(4), BET(4), eps);
  adaln_rows(s.jav, CC, s.jn, CC, J, GAM(5), BET(5), eps);
  adaln_rows(s.jf, CC, s.jt, CC, J, GAM(6), BET(6), eps);
  __syncthreads();
  gemm_rows<E_SCALE>(s.B1, CC, V, CC, COEVO_WB(CV, 0), CC, CC,
                     COEVO_WF(CV, 1), s.B1, CC, nullptr, 0, scale_v, stage);
  gemm_rows<E_BIAS>(s.jn, CC, J, CC, COEVO_WB(CV, 2), CC, CC,
                    COEVO_WF(CV, 3), s.kvk, CC, nullptr, 0, 0.f, stage);
  gemm_rows<E_BIAS>(s.jt, CC, J, CC, COEVO_WB(CV, 4), CC, CC,
                    COEVO_WF(CV, 5), s.kvv, CC, nullptr, 0, 0.f, stage);
  __syncthreads();
  attn_rows<DHV>(s.B1, s.kvk, s.kvv, s.B1, V, J, HV);
  __syncthreads();
  gemm_rows<E_RES>(s.B1, CC, V, CC, COEVO_WB(CV, 6), CC, CC,
                   COEVO_WF(CV, 7), s.XV, CC, s.B2, CC, 0.f, stage);
  __syncthreads();
  adaln_rows(s.XV, CC, s.B1, CC, V, GAM(7), BET(7), eps);
  __syncthreads();
  mlp_rows(s.B1, V, CV + 8, s.XV, s.B2, s.hid_elems, stage);

  // 4. Joint SA + FFN on bf16(joint1).
  const void* const* SJ = P + K_SAJ;
  round_rows(s.jx, s.jt, J * CC);
  __syncthreads();
  adaln_rows(s.jt, CC, s.jn, CC, J, GAM(8), BET(8), eps);
  __syncthreads();
  gemm_rows<E_BIAS>(s.jn, CC, J, CC, COEVO_WB(SJ, 0) + CC, 3 * CC, CC,
                    COEVO_WF(SJ, 1) + CC, s.kvk, CC, nullptr, 0, 0.f, stage);
  gemm_rows<E_BIAS>(s.jn, CC, J, CC, COEVO_WB(SJ, 0) + 2 * CC, 3 * CC, CC,
                    COEVO_WF(SJ, 1) + 2 * CC, s.kvv, CC, nullptr, 0, 0.f,
                    stage);
  __syncthreads();
  gemm_rows<E_SCALE>(s.jn, CC, J, CC, COEVO_WB(SJ, 0), 3 * CC, CC,
                     COEVO_WF(SJ, 1), s.jn, CC, nullptr, 0, scale_j, stage);
  __syncthreads();
  attn_rows<DHJ>(s.jn, s.kvk, s.kvv, s.jn, J, J, HJ);
  __syncthreads();
  gemm_rows<E_RES>(s.jn, CC, J, CC, COEVO_WB(SJ, 2), CC, CC,
                   COEVO_WF(SJ, 3), s.jx, CC, s.jt, CC, 0.f, stage);
  __syncthreads();
  adaln_rows(s.jx, CC, s.jn, CC, J, GAM(9), BET(9), eps);
  __syncthreads();
  mlp_rows(s.jn, J, SJ + 4, s.jx, s.jh, s.Jp * HID, stage);

  // 5. Vertex SA + FFN on bf16(vertx1): residual in B2, normalised input
  //    in B1, k/v in XVa/XVb, q and then the attention output in B1.
  const void* const* SV = P + K_SAV;
  round_rows(s.XV, s.B2, V * CC);
  __syncthreads();
  adaln_rows(s.B2, CC, s.B1, CC, V, GAM(10), BET(10), eps);
  __syncthreads();
  gemm_rows<E_BIAS>(s.B1, CC, V, CC, COEVO_WB(SV, 0) + CC, 3 * CC, CC,
                    COEVO_WF(SV, 1) + CC, s.XVa, CC, nullptr, 0, 0.f, stage);
  gemm_rows<E_BIAS>(s.B1, CC, V, CC, COEVO_WB(SV, 0) + 2 * CC, 3 * CC, CC,
                    COEVO_WF(SV, 1) + 2 * CC, s.XVb, CC, nullptr, 0, 0.f,
                    stage);
  __syncthreads();
  gemm_rows<E_SCALE>(s.B1, CC, V, CC, COEVO_WB(SV, 0), 3 * CC, CC,
                     COEVO_WF(SV, 1), s.B1, CC, nullptr, 0, scale_v, stage);
  __syncthreads();
  attn_rows<DHV>(s.B1, s.XVa, s.XVb, s.B1, V, V, HV);
  __syncthreads();
  gemm_rows<E_RES>(s.B1, CC, V, CC, COEVO_WB(SV, 2), CC, CC,
                   COEVO_WF(SV, 3), s.XV, CC, s.B2, CC, 0.f, stage);
  __syncthreads();
  adaln_rows(s.XV, CC, s.B1, CC, V, GAM(11), BET(11), eps);
  __syncthreads();
  mlp_rows(s.B1, V, SV + 4, s.XV, s.B2, s.hid_elems, stage);
#undef GAM
#undef BET
}

}  // namespace coevo
