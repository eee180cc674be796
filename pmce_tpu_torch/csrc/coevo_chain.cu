// The decoder's whole co-evolution chain for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_coevo_chain.py `_chain_kernel` (entry
// `fused_coevo_chain`), the Pallas kernel that runs all CoevoBlocks of a
// group of clips with their f32 coordinate heads: per block the 3 -> C
// projections of the ORIGINAL joints and of the current vertices, the pos /
// Q / K embeds, the v->j and j->v projections, the joint CA+FFN (8 heads,
// J queries over V keys) and vertex CA+FFN (2 heads, V queries over J keys)
// on the pre-update streams, AdaLN'd SA+FFN on each stream, and the C -> 3
// heads with their residuals.
//
// What bounds it on this card: per clip the work is small and serial
// (about 70 M multiply-adds per block at V = 431, C = 64), and its
// intermediates are [431, 64] tensors that would make ~60 round trips
// through device memory per clip if each op were its own launch. The
// vertex stream alone is 431 x 64 x 4 B = 110 KB in f32.
//
// Design: one block of 512 threads per clip (B = 256 blocks on 132 SMs)
// loops over the blocks of the chain with the vertex stream in dynamic
// shared memory: an f32 [V, C] stream buffer and two bf16 [V, C] buffers,
// 512 * V bytes in all (220,672 B at V = 431), plus 16 padding rows. Each
// stage reuses whichever buffer is dead at that point (the plan is spelled
// out below), so no [V, C] intermediate leaves the SM. The joint stream
// ([J, C], 19 rows) and its temporaries live in a per-clip workspace in
// global memory, which L1 and L2 hold, as do the weights (bf16, under 1 MB
// for the chain). Products run on the tensor cores (WMMA 16x16x16, f32
// sums), one 16 x 64 output tile per warp at a time, with each epilogue
// (bias, q scale, erf-GELU, residual adds) applied from a per-warp staging
// slice; the MLP's 4C hidden layer is processed in row tiles. Attention
// gives each thread one (query, head) and runs a max-stabilised online
// softmax in f32 over the keys, so the 431 x 431 vertex self-attention
// never holds a score matrix.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int NT = 512;    // threads per block
constexpr int CC = 64;     // channel width C of both streams
constexpr int HID = 256;   // MLP hidden width (4C)
constexpr int HJ = 8;      // joint-stream heads
constexpr int HV = 2;      // vertex-stream heads
constexpr int DHJ = CC / HJ;
constexpr int DHV = CC / HV;

// Per-block parameter table (device array of pointers), in this order.
enum {
  P_WJP = 0, P_BJP, P_WVP, P_BVP,                      // [3,C] bf16, [C] f32
  P_JPOS, P_VPOS, P_JQ, P_VQ, P_V2JK, P_J2VK,          // f32 [J|V, C]
  P_WV2J, P_BV2J, P_WJ2V, P_BJ2V,                      // [C,C] bf16, [C]
  P_CAJ = 14,  // 12: wq bq wk bk wv bv wproj bproj w1 bb1 w2 bb2
  P_CAV = 26,  // 12
  P_SAJ = 38,  // 8: wqkv bqkv wproj bproj w1 bb1 w2 bb2
  P_SAV = 46,  // 8
  P_WHJ = 54, P_BHJ, P_WHV, P_BHV,                     // f32 [C,3], [3]
  P_COUNT = 58
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

// out = bf16(f32(bf16(bf16(x) @ W + b)) + pos): the 3 -> C projection of
// f32 coordinates [n, 3] and its embed add, with the chain's cast points.
__device__ void embed3(const float* x, int n, const bf16* W, const float* b,
                       const float* pos, bf16* out) {
  for (int e = threadIdx.x; e < n * CC; e += NT) {
    const int r = e / CC, c = e % CC;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc += rbf(x[r * 3 + k]) * bf2f(W[k * CC + c]);
    out[e] = f2bf(rbf(acc + b[c]) + pos[e]);
  }
}

__device__ void add_rows(const bf16* x, const float* e, bf16* out, int count) {
  for (int i = threadIdx.x; i < count; i += NT) out[i] = f2bf(bf2f(x[i]) + e[i]);
}

__device__ void round_rows(const float* x, bf16* out, int count) {
  for (int i = threadIdx.x; i < count; i += NT) out[i] = f2bf(x[i]);
}

// out[n, 3] = X[n, C] @ W[C, 3] + b + resid, all f32 (the coordinate head);
// out may alias resid.
__device__ void head3(const float* X, int n, const float* W, const float* b,
                      const float* resid, float* out) {
  for (int e = threadIdx.x; e < n * 3; e += NT) {
    const int r = e / 3, k = e % 3;
    float acc = 0.f;
    for (int c = 0; c < CC; ++c) acc += X[(size_t)r * CC + c] * W[c * 3 + k];
    out[e] = (acc + b[k]) + resid[e];
  }
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
__device__ void mlp_rows(const bf16* h, int n, const void* const* w,
                         float* x, bf16* hid, int hid_elems, float* stage) {
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

#define WB(tab, i) static_cast<const bf16*>((tab)[i])
#define WF(tab, i) static_cast<const float*>((tab)[i])

__global__ void __launch_bounds__(NT, 1)
    coevo_chain_kernel(const float* joints, float* jout, float* vout,
                       const float* gammas, const float* betas,
                       const void* const* params, unsigned char* ws,
                       long long ws_stride, int J, int V, int NB, float eps,
                       float scale_j, float scale_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const size_t vc_elems = (size_t)V * CC;
  float* XV = reinterpret_cast<float*>(smem);          // f32 [V, C] stream
  bf16* XVa = reinterpret_cast<bf16*>(smem);           // or two bf16 [V, C]
  bf16* XVb = XVa + vc_elems;
  bf16* B1 = reinterpret_cast<bf16*>(smem + vc_elems * 4);
  bf16* B2 = B1 + vc_elems;
  // B2 and the 16 padding rows after it hold the MLP's hidden row tiles.
  const int hid_elems = static_cast<int>(vc_elems) + 16 * CC;

  // Per-clip workspace: the warps' staging slices, then the joint-stream
  // buffers, each with its rows padded to a multiple of 16 (Jp).
  const int Jp = (J + 15) / 16 * 16;
  const size_t jc = (size_t)Jp * CC;
  float* stage = reinterpret_cast<float*>(ws + (size_t)b * ws_stride);
  bf16* jf = reinterpret_cast<bf16*>(stage + NT / 32 * 256);
  bf16* jq = jf + jc;
  bf16* jav = jq + jc;
  bf16* jn = jav + jc;
  bf16* jt = jn + jc;
  bf16* kvk = jt + jc;
  bf16* kvv = kvk + jc;
  bf16* jh = kvv + jc;
  float* jx = reinterpret_cast<float*>(jh + (size_t)Jp * HID);

  const float* jin = joints + (size_t)b * J * 3;
  float* jo = jout + (size_t)b * J * 3;
  float* vc = vout + (size_t)b * V * 3;  // holds the current vertices

  for (int blk = 0; blk < NB; ++blk) {
    const void* const* P = params + (size_t)blk * P_COUNT;
    const float* gm = gammas + ((size_t)b * NB + blk) * 12 * CC;
    const float* bt = betas + ((size_t)b * NB + blk) * 12 * CC;
#define GAM(s) (gm + (s) * CC)
#define BET(s) (bt + (s) * CC)

    // 1. Embeds. B1 = vf; jf, jq and j_as_v in the workspace; B2 = v_as_j.
    embed3(jin, J, WB(P, P_WJP), WF(P, P_BJP), WF(P, P_JPOS), jf);
    embed3(vc, V, WB(P, P_WVP), WF(P, P_BVP), WF(P, P_VPOS), B1);
    __syncthreads();
    add_rows(jf, WF(P, P_JQ), jq, J * CC);
    gemm_rows<E_ADDMAT>(jf, CC, J, CC, WB(P, P_WJ2V), CC, CC, WF(P, P_BJ2V),
                        jav, CC, WF(P, P_J2VK), CC, 0.f, stage);
    gemm_rows<E_ADDMAT>(B1, CC, V, CC, WB(P, P_WV2J), CC, CC, WF(P, P_BV2J),
                        B2, CC, WF(P, P_V2JK), CC, 0.f, stage);
    __syncthreads();

    // 2. Joint CA + FFN: queries jq, keys v_as_j (B2), values vf (B1).
    //    k overwrites B2, normv goes to XVa and v to XVb.
    const void* const* CJ = P + P_CAJ;
    adaln_rows(B2, CC, B2, CC, V, GAM(1), BET(1), eps);
    adaln_rows(B1, CC, XVa, CC, V, GAM(2), BET(2), eps);
    adaln_rows(jq, CC, jn, CC, J, GAM(0), BET(0), eps);
    __syncthreads();
    gemm_rows<E_BIAS>(B2, CC, V, CC, WB(CJ, 2), CC, CC, WF(CJ, 3), B2, CC,
                      nullptr, 0, 0.f, stage);
    gemm_rows<E_BIAS>(XVa, CC, V, CC, WB(CJ, 4), CC, CC, WF(CJ, 5), XVb, CC,
                      nullptr, 0, 0.f, stage);
    gemm_rows<E_SCALE>(jn, CC, J, CC, WB(CJ, 0), CC, CC, WF(CJ, 1), jt, CC,
                       nullptr, 0, scale_j, stage);
    __syncthreads();
    attn_rows<DHJ>(jt, B2, XVb, jt, J, V, HJ);
    __syncthreads();
    gemm_rows<E_RES>(jt, CC, J, CC, WB(CJ, 6), CC, CC, WF(CJ, 7), jx, CC, jq,
                     CC, 0.f, stage);
    __syncthreads();
    adaln_rows(jx, CC, jn, CC, J, GAM(3), BET(3), eps);
    __syncthreads();
    mlp_rows(jn, J, CJ + 8, jx, jh, Jp * HID, stage);

    // 3. Vertex CA + FFN: queries vq (B2), keys j_as_v, values jf.
    //    q overwrites B1 (vf is dead once vq exists); x1 goes to XV.
    const void* const* CV = P + P_CAV;
    add_rows(B1, WF(P, P_VQ), B2, V * CC);
    __syncthreads();
    adaln_rows(B2, CC, B1, CC, V, GAM(4), BET(4), eps);
    adaln_rows(jav, CC, jn, CC, J, GAM(5), BET(5), eps);
    adaln_rows(jf, CC, jt, CC, J, GAM(6), BET(6), eps);
    __syncthreads();
    gemm_rows<E_SCALE>(B1, CC, V, CC, WB(CV, 0), CC, CC, WF(CV, 1), B1, CC,
                       nullptr, 0, scale_v, stage);
    gemm_rows<E_BIAS>(jn, CC, J, CC, WB(CV, 2), CC, CC, WF(CV, 3), kvk, CC,
                      nullptr, 0, 0.f, stage);
    gemm_rows<E_BIAS>(jt, CC, J, CC, WB(CV, 4), CC, CC, WF(CV, 5), kvv, CC,
                      nullptr, 0, 0.f, stage);
    __syncthreads();
    attn_rows<DHV>(B1, kvk, kvv, B1, V, J, HV);
    __syncthreads();
    gemm_rows<E_RES>(B1, CC, V, CC, WB(CV, 6), CC, CC, WF(CV, 7), XV, CC, B2,
                     CC, 0.f, stage);
    __syncthreads();
    adaln_rows(XV, CC, B1, CC, V, GAM(7), BET(7), eps);
    __syncthreads();
    mlp_rows(B1, V, CV + 8, XV, B2, hid_elems, stage);

    // 4. Joint SA + FFN on bf16(joint1); then the joint head.
    const void* const* SJ = P + P_SAJ;
    round_rows(jx, jt, J * CC);
    __syncthreads();
    adaln_rows(jt, CC, jn, CC, J, GAM(8), BET(8), eps);
    __syncthreads();
    gemm_rows<E_BIAS>(jn, CC, J, CC, WB(SJ, 0) + CC, 3 * CC, CC,
                      WF(SJ, 1) + CC, kvk, CC, nullptr, 0, 0.f, stage);
    gemm_rows<E_BIAS>(jn, CC, J, CC, WB(SJ, 0) + 2 * CC, 3 * CC, CC,
                      WF(SJ, 1) + 2 * CC, kvv, CC, nullptr, 0, 0.f, stage);
    __syncthreads();
    gemm_rows<E_SCALE>(jn, CC, J, CC, WB(SJ, 0), 3 * CC, CC, WF(SJ, 1), jn,
                       CC, nullptr, 0, scale_j, stage);
    __syncthreads();
    attn_rows<DHJ>(jn, kvk, kvv, jn, J, J, HJ);
    __syncthreads();
    gemm_rows<E_RES>(jn, CC, J, CC, WB(SJ, 2), CC, CC, WF(SJ, 3), jx, CC, jt,
                     CC, 0.f, stage);
    __syncthreads();
    adaln_rows(jx, CC, jn, CC, J, GAM(9), BET(9), eps);
    __syncthreads();
    mlp_rows(jn, J, SJ + 4, jx, jh, Jp * HID, stage);
    head3(jx, J, WF(P, P_WHJ), WF(P, P_BHJ), jin, jo);

    // 5. Vertex SA + FFN on bf16(vertx1): residual in B2, normalised input
    //    in B1, k/v in XVa/XVb, q and then the attention output in B1.
    const void* const* SV = P + P_SAV;
    round_rows(XV, B2, V * CC);
    __syncthreads();
    adaln_rows(B2, CC, B1, CC, V, GAM(10), BET(10), eps);
    __syncthreads();
    gemm_rows<E_BIAS>(B1, CC, V, CC, WB(SV, 0) + CC, 3 * CC, CC,
                      WF(SV, 1) + CC, XVa, CC, nullptr, 0, 0.f, stage);
    gemm_rows<E_BIAS>(B1, CC, V, CC, WB(SV, 0) + 2 * CC, 3 * CC, CC,
                      WF(SV, 1) + 2 * CC, XVb, CC, nullptr, 0, 0.f, stage);
    __syncthreads();
    gemm_rows<E_SCALE>(B1, CC, V, CC, WB(SV, 0), 3 * CC, CC, WF(SV, 1), B1,
                       CC, nullptr, 0, scale_v, stage);
    __syncthreads();
    attn_rows<DHV>(B1, XVa, XVb, B1, V, V, HV);
    __syncthreads();
    gemm_rows<E_RES>(B1, CC, V, CC, WB(SV, 2), CC, CC, WF(SV, 3), XV, CC, B2,
                     CC, 0.f, stage);
    __syncthreads();
    adaln_rows(XV, CC, B1, CC, V, GAM(11), BET(11), eps);
    __syncthreads();
    mlp_rows(B1, V, SV + 4, XV, B2, hid_elems, stage);
    head3(XV, V, WF(P, P_WHV), WF(P, P_BHV), vc, vc);
    __syncthreads();
#undef GAM
#undef BET
  }
}

extern "C" long long pmce_chain_workspace_bytes(int J) {
  const long long Jp = (J + 15) / 16 * 16;
  const long long bytes = NT / 32 * 256 * 4 + Jp * (18 * CC + 2 * HID);
  return (bytes + 255) / 256 * 256;
}

// Three [V, C] buffers (f32, bf16, bf16) plus 16 readable rows past the
// last one (the tensor-core tiles read A rows up to a multiple of 16).
extern "C" long long pmce_chain_smem_bytes(int V) {
  return (long long)V * CC * 8 + 16 * CC * 2;
}

extern "C" int pmce_coevo_chain(const float* joints, float* jout, float* vout,
                                const float* gammas, const float* betas,
                                const void* params, void* ws, int B, int J,
                                int V, int NB, float eps, float scale_j,
                                float scale_v, void* stream) {
  const int smem = static_cast<int>(pmce_chain_smem_bytes(V));
  cudaError_t e = cudaFuncSetAttribute(
      coevo_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  coevo_chain_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      joints, jout, vout, gammas, betas,
      static_cast<const void* const*>(params),
      static_cast<unsigned char*>(ws), pmce_chain_workspace_bytes(J), J, V,
      NB, eps, scale_j, scale_v);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_chain_error_string)
