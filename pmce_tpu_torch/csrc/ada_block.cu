// The decoder's AdaLayerNorm self-attention block, forward and backward,
// for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_ada_block_kernel` (entry
// `fused_ada_block`) and `_ada_block_bwd_kernel` (via
// `_fused_ada_block_bwd`), the vertex stream's self-attention + FFN:
//
//   x1 = x + m1 * MHSA(AdaLN(x; g1, b1));  y = x1 + m2 * MLP(AdaLN(x1; g2, b2))
//
// with per-clip AdaLN vectors (regressed from the GRU feature outside) and
// per-clip branch scales m1, m2 (stochastic depth), whose gradients are
// dm1 = sum(dx1 * a) and dm2 = sum(g * mo) per clip (a, mo: the branches
// before their scales).
//
// What bounds it on this card: at the training shapes (32 clips of 431
// tokens, C = 64, 2 heads of 32, hidden 256) the products are ~2.2 GFLOP
// forward, 1.5 of them the 431 x 431 attention, and twice that backward;
// the activations are ~3.5 MB. Hopper's tensor cores would take ~2 us and
// its memory ~1 us: the bound is far below what launches and latency cost,
// so the forward is two launches that fill the card in one wave.
//
// Forward, two launches where the tile programs' gate holds (C = 64, hid up
// to 256, N up to 512), four ordinary CTAs a clip (a quarter of its rows,
// at most 128, a warp's 16 each: 128 CTAs at batch 32, one an SM, one wave
// on 132 SMs; no cluster, no cooperative launch, no spin: the kernel
// boundary is the only barrier):
// - launch A (adf::ada_fwd_rows_kernel), row-local: AdaLN1 (f32 statistics,
//   unbiased sigma, eps outside the sqrt) from the accumulator layout, then
//   h1 @ Wqkv + bqkv on the tensor cores (mma.sync m16n8k16, W's own [in,
//   out] rows by ldmatrix .trans), q scaled in f32 before its one bf16
//   rounding. It writes qkv (the clip's keys and values for launch B, 5.3
//   MB at batch 32: L2-resident) and h1 when a gradient is owed.
// - launch B (adf::ada_fwd_attn_kernel), a CTA's query rows: the clip's K
//   (then K and V) stream from qkv through a two-stage cp.async ring of
//   64-row chunks, as row 9's program streams them. Pass 1: each row's max
//   and sum of exp(q k^T - max) over all N keys (per lane, merged over the
//   quad); pass 2: S again, P = bf16(exp(s - m) / l) (the plain version's
//   cast point after normalising), O += P V. Then the projection, x1 = x +
//   m1 * a, AdaLN2, fc1 + exact GELU and fc2 in hidden blocks of 64 with
//   their sums in f32 registers, y = x1 + m2 * mo (adaln_tile.cuh's
//   ada_tail, shared with row 10). The weights are read in their [in, out]
//   layout: no transposed copies.
//   Shared memory at hid 256: Wproj [64, 72], W1 [64, 264], W2 [256, 72]
//   bf16 (80 KB), the q tile [128, 72] (18 KB), the ring 2 x (K | V) [64,
//   72] (36 KB): 132 KB; O, x1 and the hidden block stay in registers.
// Both write the state the backward reads (h1, qkv, o, the softmax max and
// sum [clips, H, N], x1 f32, h2, hh f32, ge; the branches a, mo f32 only for
// the mask gradients) in the launch sequence's layout, only when a
// gradient is owed, evict-first (only the backward reads it).
// Outside the gate, the launch sequence (simple first): one launch per stage
// over all rows: AdaLN (a warp per row), WMMA GEMMs with fused epilogues (q
// scale, exact GELU keeping its input, masked residual adds keeping the
// branches a and mo where the mask gradients are owed), and
// attention_ops.cuh's attention on the CUDA cores, whose keys stream through
// shared memory in tiles of 64; it always keeps what the backward reads.
//
// Backward, two launches where the tile program's gate holds (C = 64, hid
// up to 256, N up to 512):
// - the tile program (adb::ada_bwd_tile_kernel), a cluster of CL = 4 CTAs a
//   clip (128 CTAs at batch 32), each owning a quarter
//   of the clip's rows (at most 128, a warp's 16 each). Row-local first, on
//   the tensor cores (mma.sync m16n8k16, W^T's fragments from W's own rows):
//   m2 * g, the MLP's backward (fc2^T, gelu'(hh), fc1^T in blocks of 64
//   hidden units), the AdaLN2 backward plus the residual (dx1, kept in
//   shared memory), da = m1 * dx1, dO = da @ Wproj^T and D = dO . O per
//   head. Then the attention backward over the whole clip, P recomputed
//   from the forward's saved max and sum: dq of the CTA's query rows over
//   every key, then (after a cluster barrier) dk and dv of its key rows
//   over every query (adaln_tile.cuh's attn_bwd_dq / attn_bwd_dkdv, shared
//   with the self-attention backward, mhsa.cu). The clip's keys, values,
//   queries and dO stream
//   through a two-stage cp.async ring in chunks of 64 rows from device
//   memory: q, k, v from the forward's saved qkv, dO and D from scratch that
//   each CTA writes for its own rows before the barrier (55 KB of dO a
//   clip, read from L2; distributed shared memory would serve only the
//   peers' rows, and ldmatrix cannot read it, so every chunk would still
//   be copied into this CTA's shared memory). Every dq, dk, dv row is
//   whole in the CTA that owns it: no cross-CTA sum. Then qkv^T, the AdaLN1
//   backward and dx = dx1 + dx_ln. The per-clip sums (dgamma1, dbeta1,
//   dgamma2, dbeta2, dm1, dm2) are added across the cluster by rank 0 in
//   rank order through distributed shared memory: no float atomics, reruns
//   bit-identical. It writes the weight products' bf16 dY operands.
// - the weight gradients (wgrad.cuh, shared with block.cu and ca_block.cu):
//   h1^T dqkv, o^T da, h2^T dhh, ge^T m2g and the four bias gradients, over
//   64 x 64 output tiles cut into fixed K ranges.
// Outside the gate, the launch sequence: the MLP half, the AdaLN backward (a
// block per clip), the CUDA-core attention backward (a query pass, then a
// key pass), split-K weight partials added in a fixed order, and the mask
// gradients as a block per clip.

#include "adaln_tile.cuh"
#include "attention_ops.cuh"
#include "wgrad.cuh"

using namespace pmce;

namespace {

struct AdaWs {
  bf16 *m2g, *dhh, *da, *dout, *dqkv;
  float *dh2, *dx1, *dh1, *dsum, *colpart, *tnpart;
};

AdaWs ada_ws(Carve& c, int clips, int N, int C, int hid, int H) {
  const size_t M = (size_t)clips * N;
  AdaWs w;
  w.m2g = c.take<bf16>(M * C);
  w.dhh = c.take<bf16>(M * hid);
  w.da = c.take<bf16>(M * C);
  w.dout = c.take<bf16>(M * C);
  w.dqkv = c.take<bf16>(M * 3 * C);
  w.dh2 = c.take<float>(M * C);
  w.dx1 = c.take<float>(M * C);
  w.dh1 = c.take<float>(M * C);
  w.dsum = c.take<float>((size_t)clips * H * N);
  w.colpart = c.take<float>(colsum_part_elems((int)M, std::max(hid, 3 * C)));
  w.tnpart = c.take<float>(std::max(
      {tn_part_elems((int)M, C, 3 * C), tn_part_elems((int)M, C, C),
       tn_part_elems((int)M, C, hid), tn_part_elems((int)M, hid, C)}));
  return w;
}

// dm1 = sum(dx1 * a), dm2 = sum(g * mo) over a clip's n = N * C values, a
// block per clip, summed in a fixed order.
__global__ void __launch_bounds__(256)
    mask_sums_kernel(const float* dx1, const float* a, const bf16* g,
                     const float* mo, int n, float* dm1, float* dm2) {
  __shared__ float red[2][256];
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n;
  float s1 = 0.f, s2 = 0.f;
  for (int i = tid; i < n; i += 256) {
    s1 += dx1[base + i] * a[base + i];
    s2 += bf2f(g[base + i]) * mo[base + i];
  }
  red[0][tid] = s1;
  red[1][tid] = s2;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (tid < s) {
      red[0][tid] += red[0][tid + s];
      red[1][tid] += red[1][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    dm1[blockIdx.x] = red[0][0];
    dm2[blockIdx.x] = red[1][0];
  }
}

}  // namespace

extern "C" long long pmce_ada_block_workspace(int clips, int N, int C,
                                              int hid, int H) {
  Carve c(nullptr);
  ada_ws(c, clips, N, C, hid, H);
  return static_cast<long long>(c.off);
}

// P: x [M,C] bf16, g1, b1, g2, b2 [clips,C] f32, m1, m2 [clips] f32 or
// null, wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2 (bf16 [in,out] / f32);
// saved h1, qkv, o, stat_m, stat_l, x1 (f32), h2, hh (f32), ge; out; the
// branches a, mo [M, C] f32 or null (saved for the mask gradients).
extern "C" int pmce_ada_block_fwd(void* const* P, int clips, int N, int C,
                                  int hid, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  const int M = clips * N;
  PMCE_TRY(launch_adaln(b(0), b(15), f(1), f(2), M, N, C, eps, s));
  PMCE_TRY(self_attn_fwd(b(15), clips, N, C, H, b(7), f(8), b(16), b(17),
                         f(18), f(19), s));
  PMCE_TRY(gemm(EPI_RES, b(17), b(9), M, C, C, f(20), 1, f(10), s, b(0), 0,
                f(5), N, 0, 1.f, f(25)));
  return ada_mlp_fwd(f(20), clips, N, C, hid, f(3), f(4), eps, b(11), f(12),
                     b(13), f(14), f(6), b(21), f(22), b(23), b(24), s,
                     f(26));
}

// ---------------------------------------------------------------------------
// The forward's tile programs (row 8): launches A and B, 4 CTAs a clip.
// ---------------------------------------------------------------------------
namespace adf {

using namespace tile;

constexpr int NSTAMP_A = 2;  // loads + norm1, qkv
constexpr int NSTAMP_B = 4;  // loads, attention max + sum, attention P.V,
                             // proj + norm2 + MLP
constexpr int CH = 64;       // rows of a streamed chunk
constexpr int L3 = 3 * CW;   // qkv's row stride
constexpr int LDQKV = L3 + 8;
constexpr int SMEM_A = CW * LDQKV * 2;                // Wqkv [64, 200]
// Launch B's shared-memory plan, bytes.
constexpr int CTILE = CH * LD * 2;                    // [64, 72] bf16
constexpr int OFF_WP = 0;                             // [64, 72]
constexpr int OFF_W1 = OFF_WP + CW * LD * 2;          // [64, hid + 8]
constexpr int OFF_W2 = OFF_W1 + CW * (MAX_HID + 8) * 2;  // [hid, 72]
constexpr int OFF_QT = OFF_W2 + MAX_HID * LD * 2;     // [128, 72]
constexpr int OFF_RING = OFF_QT + RT * LD * 2;        // 2 x (K | V) chunks
constexpr int SMEM_B = OFF_RING + 2 * 2 * CTILE;
static_assert(SMEM_B <= 232448, "over the opt-in shared memory");

struct Args {
  const bf16* x;                        // [M, 64]
  const float *g1, *b1, *g2, *b2;       // AdaLN vectors [clips, 64]
  const float *m1, *m2;                 // [clips] or null
  const bf16 *wqkv, *wproj, *w1, *w2;   // [in, out]
  const float *bqkv, *bproj, *bb1, *bb2;
  bf16* out;
  bf16* qkv;                            // [M, 192], q pre-scaled: A writes,
                                        // B reads (saved when owed)
  bf16 *h1, *o, *h2, *ge;               // the saved state, or all null
  float *sm, *sl;                       // [clips, H, N] softmax max, sum
  float *x1, *hh;                       // [M, 64], [M, hid]
  float *a, *mo;                        // [M, 64] or null
  int clips, N, hid;
  float eps, qscale;
  long long* stamps;                    // A's [clips * CL, NSTAMP_A], then
                                        // B's [clips * CL, NSTAMP_B]; or null
};

// A CTA's quarter of its clip's rows (whole 16-row blocks, as row 9's).
struct Rows {
  int b, r0, nr;
  size_t row0;
  __device__ Rows(int N) {
    b = blockIdx.x / CL;
    const int rank = blockIdx.x % CL;
    r0 = min(N, rank * rank_rows(N));
    nr = min(N, r0 + rank_rows(N)) - r0;
    row0 = (size_t)b * N + r0;
  }
};

// Launch A: AdaLN1 and the qkv product of a warp's 16 rows.
template <bool PROF>
__global__ void __launch_bounds__(NTH) ada_fwd_rows_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Wqkv = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2;
  StageClock<PROF, NSTAMP_A> clk;
  clk.start();
  for (int c = tid; c < CW * (L3 / 8); c += NTH) {
    const int r = c / (L3 / 8), cc = c % (L3 / 8) * 8;
    cp_async16(Wqkv + r * LDQKV + cc, a.wqkv + r * L3 + cc, true);
  }
  cp_async_commit();
  // The warp's rows and their AdaLN while the weights are in flight.
  const Rows rw(a.N);
  const int qr = warp * 16;
  const bool on = qr < rw.nr;
  const bool v0 = qr + g < rw.nr, v1 = qr + g + 8 < rw.nr;
  const size_t r0 = rw.row0 + qr, cb = (size_t)rw.b * CW;
  unsigned af[4][4];
  if (on) {
    float h[8][4];
    load_frag(h, a.x, r0, v0, v1);
    adaln_fwd_frag(h, a.g1 + cb, a.b1 + cb, a.eps);
    if (a.h1) store_bf<true>(h, nullptr, a.h1, r0, v0, v1);
    frag_a(af, h);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  clk(0);
  if (on) {
#pragma unroll 1
    for (int j = 0; j < 3; ++j) {
      float acc[8][4];
      zero(acc);
      mma_aw(acc, af, Wqkv + j * CW, LDQKV);
      add_cols(acc, a.bqkv + j * CW);
      if (j == 0) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jj][e] *= a.qscale;
      }
      // Launch B reads qkv from L2: written normally, not evict-first.
      store_bf(acc, nullptr, a.qkv, r0, v0, v1, L3, j * CW);
    }
  }
  clk(1);
  clk.write(a.stamps);
}

// Launch B: the attention of a CTA's query rows over the clip's keys, then
// the block's tail.
template <bool PROF, int D>
__global__ void __launch_bounds__(NTH, 1) ada_fwd_attn_kernel(const Args a) {
  constexpr int H = CW / D;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Wp = reinterpret_cast<bf16*>(smem + OFF_WP);
  bf16* W1 = reinterpret_cast<bf16*>(smem + OFF_W1);
  bf16* W2 = reinterpret_cast<bf16*>(smem + OFF_W2);
  bf16* Qt = reinterpret_cast<bf16*>(smem + OFF_QT);
  unsigned char* ring = smem + OFF_RING;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  StageClock<PROF, NSTAMP_B> clk;
  clk.start();
  const Rows rw(a.N);
  const int N = a.N, hid = a.hid, ldw1 = hid + 8;
  const size_t crow0 = (size_t)rw.b * N;  // the clip's first row
  const size_t cb = (size_t)rw.b * CW;

  // ---- loads: the three weights and the CTA's q rows; the first K chunk --
  for (int c = tid; c < CW * 8; c += NTH) {
    const int r = c / 8, cc = c % 8 * 8;
    cp_async16(Wp + r * LD + cc, a.wproj + r * CW + cc, true);
  }
  for (int c = tid; c < CW * (hid / 8); c += NTH) {
    const int r = c / (hid / 8), cc = c % (hid / 8) * 8;
    cp_async16(W1 + r * ldw1 + cc, a.w1 + (size_t)r * hid + cc, true);
  }
  for (int c = tid; c < hid * 8; c += NTH) {
    const int r = c / 8, cc = c % 8 * 8;
    cp_async16(W2 + r * LD + cc, a.w2 + (size_t)r * CW + cc, true);
  }
  load_rows(Qt, a.qkv, rw.row0, rw.nr, L3, 0);
  cp_async_commit();
  const int nch = (N + CH - 1) / CH;
  auto stage_of = [&](int c) {
    return reinterpret_cast<bf16*>(ring + (c & 1) * 2 * CTILE);
  };
  // Chunk c of the clip's keys (and values) into its ring stage; a group is
  // committed either way, so that waiting for all but one stays exact.
  auto issue = [&](int c, bool values) {
    if (c < nch) {
      const int n = min(CH, N - c * CH);
      load_rows(stage_of(c), a.qkv, crow0 + c * CH, n, L3, CW);
      if (values)
        load_rows(stage_of(c) + CH * LD, a.qkv, crow0 + c * CH, n, L3,
                  2 * CW);
    }
    cp_async_commit();
  };
  issue(0, false);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
  clk(0);

  const int qr = warp * 16;
  const bool on = qr < rw.nr;
  // The warp's q fragments of every head, kept for both passes.
  QFrag<D> qf[H];
  if (on) {
#pragma unroll
    for (int h = 0; h < H; ++h) load_q(qf[h], Qt + qr * LD + h * D, LD);
  }

  // ---- pass 1: each row's max and sum over the clip's keys ----------------
  float m[H][2], l[H][2];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    m[h][0] = m[h][1] = -INFINITY;
    l[h][0] = l[h][1] = 0.f;
  }
  for (int c = 0; c < nch; ++c) {
    issue(c + 1, false);
    cp_async_wait_one();
    __syncthreads();
    if (on) {
      const bf16* Kc = stage_of(c);
      const int n = min(CH, N - c * CH);
      // The chunk's key blocks unrolled: their products are independent.
#pragma unroll
      for (int kb = 0; kb < CH; kb += 16) {
        if (kb >= n) break;
        const auto in = [&](int, int col) { return kb + col < n; };
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float sc[2][4] = {};
          dot_q<D>(sc, qf[h], Kc + kb * LD + h * D, LD);
          softmax_fold(sc, in, m[h], l[h]);
        }
      }
    }
    __syncthreads();
  }
  float li[H][2];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    softmax_merge(m[h], l[h]);
    li[h][0] = 1.0f / l[h][0];
    li[h][1] = 1.0f / l[h][1];
  }
  clk(1);

  // ---- pass 2: O = P V, P = bf16(exp(s - m) / l) --------------------------
  float o[8][4];
  zero(o);
  issue(0, true);
  for (int c = 0; c < nch; ++c) {
    issue(c + 1, true);
    cp_async_wait_one();
    __syncthreads();
    if (on) {
      const bf16* Kc = stage_of(c);
      const bf16* Vc = Kc + CH * LD;
      const int n = min(CH, N - c * CH);
#pragma unroll
      for (int kb = 0; kb < CH; kb += 16) {
        if (kb >= n) break;
        const auto in = [&](int, int col) { return kb + col < n; };
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float sc[2][4] = {};
          dot_q<D>(sc, qf[h], Kc + kb * LD + h * D, LD);
          softmax_probs(sc, in, m[h], li[h]);
          unsigned pa[4];
          pack_a(pa, sc);
          dot_pn<D>(o, h * (D / 8), pa, Vc + kb * LD + h * D, LD);
        }
      }
    }
    __syncthreads();
  }
  clk(2);

  // ---- the saved o and statistics, then the tail in registers --------------
  if (on) {
    const bool v0 = qr + g < rw.nr, v1 = qr + g + 8 < rw.nr;
    const size_t r0 = rw.row0 + qr;
    if (a.o) store_bf<true>(o, nullptr, a.o, r0, v0, v1);
    if (a.sm && tq == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (hf ? v1 : v0) {
            const size_t si =
                ((size_t)rw.b * H + h) * N + rw.r0 + qr + g + 8 * hf;
            __stcs(a.sm + si, m[h][hf]);
            __stcs(a.sl + si, l[h][hf]);
          }
    }
    unsigned of[4][4];
    frag_a(of, o);
    const Tail t{a.x, a.out, Wp, W1, W2, a.bproj, a.bb1, a.bb2,
                 a.g2 + cb, a.b2 + cb, a.a, a.x1, a.hh, a.mo, a.h2, a.ge,
                 hid, a.eps};
    ada_tail(t, of, r0, v0, v1, a.m1 ? a.m1[rw.b] : 1.f,
             a.m2 ? a.m2[rw.b] : 1.f);
  }
  clk(3);
  clk.write(a.stamps ? a.stamps + (size_t)gridDim.x * NSTAMP_A : nullptr);
}

template <bool PROF, int D>
int launch(const Args& a, cudaStream_t s) {
  const auto ka = ada_fwd_rows_kernel<PROF>;
  const auto kb = ada_fwd_attn_kernel<PROF, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_B);
  if (e != cudaSuccess) return static_cast<int>(e);
  ka<<<a.clips * CL, NTH, SMEM_A, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kb<<<a.clips * CL, NTH, SMEM_B, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace adf

// The forward's tile programs, two launches of 4 CTAs a clip. ptrs: x, g1,
// b1, g2, b2 ([clips, 64] f32), m1, m2 (or null), wqkv, wproj, w1, w2 (bf16
// [in, out]), bqkv, bproj, bb1, bb2 (f32), out, qkv (always: launch B reads
// it); the saved h1, o, stat_m, stat_l, x1, h2, hh, ge (all null: not
// saving); a, mo (f32 [M, 64] or null); stamps (null, or int64 [clips * 4,
// 2] then [clips * 4, 4] for the stamped instantiations).
extern "C" int pmce_ada_fwd_tile(void* const* ptrs, int clips, int N, int hid,
                                 int H, float eps, void* stream) {
  using namespace adf;
  if (clips <= 0 || N <= 0 || N > CL * RT || hid <= 0 || hid % CW ||
      hid > MAX_HID || (H != 2 && H != 4 && H != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  auto cb = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto b = [&](int i) { return static_cast<bf16*>(ptrs[i]); };
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  a.x = cb(0); a.g1 = cf(1); a.b1 = cf(2); a.g2 = cf(3); a.b2 = cf(4);
  a.m1 = cf(5); a.m2 = cf(6);
  a.wqkv = cb(7); a.wproj = cb(8); a.w1 = cb(9); a.w2 = cb(10);
  a.bqkv = cf(11); a.bproj = cf(12); a.bb1 = cf(13); a.bb2 = cf(14);
  a.out = b(15); a.qkv = b(16);
  a.h1 = b(17); a.o = b(18); a.sm = f(19); a.sl = f(20); a.x1 = f(21);
  a.h2 = b(22); a.hh = f(23); a.ge = b(24);
  a.a = f(25); a.mo = f(26);
  a.stamps = static_cast<long long*>(ptrs[27]);
  a.clips = clips; a.N = N; a.hid = hid;
  a.eps = eps;
  a.qscale = 1.0f / sqrtf(static_cast<float>(CW / H));
  // The saved state is written whole or not at all.
  int saved = 0;
  for (int i = 17; i <= 24; ++i) saved += ptrs[i] != nullptr;
  if (a.qkv == nullptr || (saved != 0 && saved != 8) ||
      (a.a == nullptr) != (a.mo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = CW / H;
  if (a.stamps) {
    if (D == 8) return launch<true, 8>(a, s);
    if (D == 16) return launch<true, 16>(a, s);
    return launch<true, 32>(a, s);
  }
  if (D == 8) return launch<false, 8>(a, s);
  if (D == 16) return launch<false, 16>(a, s);
  return launch<false, 32>(a, s);
}

// CTAs of the forward's launch B the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), or minus a CUDA
// error code: a batch of clips runs in one wave while 4 x clips is at most
// this.
extern "C" int pmce_ada_fwd_resident() {
  const auto kernel = adf::ada_fwd_attn_kernel<false, 32>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, adf::SMEM_B);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    tile::NTH, adf::SMEM_B);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

// The sequence route (outside the tile program's gate). P: x, g (dL/d
// out), gamma1, gamma2, m1, m2, wqkvᵀ, wprojᵀ, w1ᵀ [hid,C], w2ᵀ [C,hid];
// saved h1, qkv, o, stat_m, stat_l, x1, h2, hh, ge; dx bf16; dgb f32 [4,
// clips, C] (dg1, db1, dg2, db2); grads f32 (dwqkv, dbqkv, dwproj, dbproj,
// dw1, dbb1, dw2, dbb2); ws; the saved branches a, mo and the mask
// gradients dm1, dm2 [clips] (all four null: none owed).
extern "C" int pmce_ada_block_bwd(void* const* P, int clips, int N, int C,
                                  int hid, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  Carve c(P[22]);
  const AdaWs w = ada_ws(c, clips, N, C, hid, H);
  float* dgb = f(20);
  const size_t bc = (size_t)clips * C;
  float* gr = f(21);
  const SelfAttnGrads ag{gr, gr + 3 * C * C, gr + 3 * C * C + 3 * C,
                         gr + 4 * C * C + 3 * C};
  float* mlp = gr + 4 * C * C + 4 * C;
  const MlpGrads mg{mlp, mlp + C * hid, mlp + C * hid + hid,
                    mlp + 2 * C * hid + hid, dgb + 2 * bc, dgb + 3 * bc};
  PMCE_TRY(ada_mlp_bwd(b(1), f(15), b(16), f(17), b(18), clips, N, C, hid,
                       f(3), eps, b(8), b(9), f(4), f(5), w.m2g, w.dhh,
                       w.dh2, w.dx1, w.da, w.colpart, w.tnpart, mg, s));
  if (P[25]) {
    if (!P[23] || !P[24] || !P[26])
      return static_cast<int>(cudaErrorInvalidValue);
    mask_sums_kernel<<<clips, 256, 0, s>>>(w.dx1, f(23), b(1), f(24), N * C,
                                           f(25), f(26));
    PMCE_TRY(static_cast<int>(cudaGetLastError()));
  }
  PMCE_TRY(self_attn_bwd(b(10), w.da, clips, N, C, H, b(11), b(12), f(13),
                         f(14), b(6), b(7), w.dout, w.dqkv, w.dsum,
                         w.colpart, w.tnpart, ag, w.dh1, 1, s));
  return launch_adaln_bwd(w.dh1, b(0), f(2), eps, w.dx1, 1, nullptr, clips,
                          N, C, nullptr, b(19), dgb, dgb + bc, s);
}

// ---------------------------------------------------------------------------
// The backward's tile program (row 9): a cluster of CL = 4 CTAs a clip.
// ---------------------------------------------------------------------------
namespace adb {

using namespace tile;

constexpr int NSTAMP = 9;  // loads, MLP^T, norm2, proj^T + D, attention dq,
                           // cluster barrier, attention dk dv, qkv^T +
                           // norm1, cluster sums
constexpr int CH = 64;     // rows of a streamed chunk
constexpr int L3 = 3 * CW; // qkv's row stride

// Shared-memory plan, bytes. Region M holds W2 and W1 for the MLP's
// backward; after it (a block-wide barrier) dx1 f32 and the ring's two
// stages (k | v chunks for dq, then q | dO chunks for dk, dv). The four
// [128, 72] bf16 tiles, a warp's 16 rows each, by stage: RA m2g, da, dq;
// RB dhh, dO, dk; RC q, v; RD k, dv.
constexpr int TILE = RT * LD * 2;
constexpr int CTILE = CH * LD * 2;
constexpr int LDQKV = L3 + 8;
constexpr int OFF_WP = 0;
constexpr int OFF_WQKV = CW * LD * 2;
constexpr int OFF_M = OFF_WQKV + CW * LDQKV * 2;
constexpr int OFF_W1 = OFF_M + MAX_HID * LD * 2;      // W2: [hid, 72]
constexpr int M_BYTES = MAX_HID * LD * 2 + CW * (MAX_HID + 8) * 2;
constexpr int M_RING = RT * CW * 4;                   // after dx1 [128, 64]
constexpr int OFF_RA = OFF_M + M_BYTES;
constexpr int OFF_RB = OFF_RA + TILE;
constexpr int OFF_RC = OFF_RB + TILE;
constexpr int OFF_RD = OFF_RC + TILE;
constexpr int OFF_ST = OFF_RD + TILE;                 // own m, 1/l, D
constexpr int OFF_SR = OFF_ST + 3 * RT * MAXH * 4;    // a chunk's, 2 stages
constexpr int SR_STAGE = 3 * CH * MAXH;               // floats
constexpr int OFF_VP = OFF_SR + 2 * SR_STAGE * 4;     // [4 * 64 + 2] f32
constexpr int VP_LEN = 4 * CW + 2;
constexpr int OFF_WPT = OFF_VP + 1280;                // [8 warps][2][64]
constexpr int OFF_WPM = OFF_WPT + NW * 2 * CW * 4;    // [8 warps][2]
constexpr int SMEM = OFF_WPM + NW * 2 * 4;
static_assert(M_RING + 4 * CTILE <= M_BYTES, "the ring over region M");
static_assert(VP_LEN * 4 <= 1280, "the per-clip vectors");
static_assert(SMEM <= 232448, "over the opt-in shared memory");
// Per-clip vectors in VP: dg1, db1, dg2, db2, dm1, dm2.
enum { V_1 = 0, V_2 = 2 };

struct Args {
  const bf16 *x, *g;                    // [M, 64] input, dL/d out
  const float *g1, *g2;                 // AdaLN gammas [clips, 64]
  const float *m1, *m2;                 // [clips] or null
  const bf16 *wqkv, *wproj, *w1, *w2;   // [in, out]
  const bf16 *qkv, *o;                  // saved, q pre-scaled
  const float *sm, *sl;                 // [clips, H, N] softmax max, sum
  const float *x1, *hh;                 // [M, 64], [M, hid]
  const float *a, *mo;                  // [M, 64] or null
  bf16* dx;
  bf16 *m2g, *dhh, *da, *dqkv;          // the weight products' dY
  bf16* dout;                           // scratch [M, 64]: dO
  float* dsum;                          // scratch [clips, H, N]: dO . O
  float* dgb;                           // [4, clips, 64]
  float *dm1, *dm2;                     // [clips] or null
  int* counters;                        // the weight launch's, zeroed here
  int ncounters, clips, N, hid;
  float eps, qscale;
  long long* stamps;                    // [clips * CL, NSTAMP] or null
};

template <bool PROF, int D>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NTH, 1)
    ada_bwd_tile_kernel(const Args a) {
  constexpr int H = CW / D;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  bf16* Wp = reinterpret_cast<bf16*>(smem + OFF_WP);
  bf16* Wqkv = reinterpret_cast<bf16*>(smem + OFF_WQKV);
  bf16* W2 = reinterpret_cast<bf16*>(smem + OFF_M);
  bf16* W1 = reinterpret_cast<bf16*>(smem + OFF_W1);
  float* dx1s = reinterpret_cast<float*>(smem + OFF_M);
  unsigned char* ring = smem + OFF_M + M_RING;
  bf16* RA = reinterpret_cast<bf16*>(smem + OFF_RA);
  bf16* RB = reinterpret_cast<bf16*>(smem + OFF_RB);
  bf16* RC = reinterpret_cast<bf16*>(smem + OFF_RC);
  bf16* RD = reinterpret_cast<bf16*>(smem + OFF_RD);
  float* Ms = reinterpret_cast<float*>(smem + OFF_ST);
  float* Ls = Ms + RT * MAXH;
  float* Ds = Ls + RT * MAXH;
  float* SR = reinterpret_cast<float*>(smem + OFF_SR);
  float* vp = reinterpret_cast<float*>(smem + OFF_VP);
  float* wpt = reinterpret_cast<float*>(smem + OFF_WPT);
  float* wpm = reinterpret_cast<float*>(smem + OFF_WPM);
  StageClock<PROF, NSTAMP> clk;
  clk.start();

  const int N = a.N;
  const int r0 = min(N, rank * rank_rows(N));
  const int nr = min(N, r0 + rank_rows(N)) - r0;
  const size_t crow0 = (size_t)b * N;  // the clip's first row
  const size_t row0 = crow0 + r0;      // the CTA's
  const bool masks = a.dm1 != nullptr;
  const int hid = a.hid, ldw1 = hid + 8;
  const size_t cb = (size_t)b * CW;

  if (blockIdx.x == 0 && tid < a.ncounters) a.counters[tid] = 0;

  // ---- loads: the four weights, the CTA's q and k rows -------------------
  {
    for (int c = tid; c < CW * 8; c += NTH) {
      const int r = c / 8, cc = c % 8 * 8;
      cp_async16(Wp + r * LD + cc, a.wproj + r * CW + cc, true);
    }
    for (int c = tid; c < CW * (L3 / 8); c += NTH) {
      const int r = c / (L3 / 8), cc = c % (L3 / 8) * 8;
      cp_async16(Wqkv + r * LDQKV + cc, a.wqkv + r * L3 + cc, true);
    }
    for (int c = tid; c < hid * 8; c += NTH) {
      const int r = c / 8, cc = c % 8 * 8;
      cp_async16(W2 + r * LD + cc, a.w2 + (size_t)r * CW + cc, true);
    }
    for (int c = tid; c < CW * (hid / 8); c += NTH) {
      const int r = c / (hid / 8), cc = c % (hid / 8) * 8;
      cp_async16(W1 + r * ldw1 + cc, a.w1 + (size_t)r * hid + cc, true);
    }
    load_rows(RC, a.qkv, row0, nr, L3, 0);
    load_rows(RD, a.qkv, row0, nr, L3, CW);
    for (int i = tid; i < VP_LEN; i += NTH) vp[i] = 0.f;
    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  clk(0);

  // ---- row-local, a warp per 16 rows: m2 * g, the MLP's backward (dh2 in
  // registers) ---------------------------------------------------------------
  const int qr = warp * 16;
  const bool on = qr < nr;
  const bool v0 = qr + g < nr, v1 = qr + g + 8 < nr;
  const size_t wrow0 = row0 + qr;
  bf16* T1w = RA + qr * LD;
  bf16* T2w = RB + qr * LD;
  const float s2 = a.m2 ? a.m2[b] : 1.f, s1 = a.m1 ? a.m1[b] : 1.f;
  float dh2[8][4];
  zero(dh2);
  float dm_part[2] = {0.f, 0.f};
  if (on) {
    for (int e = lane; e < 16 * 8; e += 32) {
      const int r = e / 8, c8 = e % 8 * 8;
      float gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) gv[i] = 0.f;
      if (qr + r < nr) load8(a.g + (wrow0 + r) * CW + c8, gv);
      unsigned pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pk[i] = pack_bf2(gv[2 * i] * s2, gv[2 * i + 1] * s2);
      const uint4 w4 = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      *reinterpret_cast<uint4*>(T1w + r * LD + c8) = w4;
      if (qr + r < nr) {
        *reinterpret_cast<uint4*>(a.m2g + (wrow0 + r) * CW + c8) = w4;
        if (a.mo) {
          const float* mp = a.mo + (wrow0 + r) * CW + c8;
#pragma unroll
          for (int i = 0; i < 8; ++i) dm_part[1] += gv[i] * mp[i];
        }
      }
    }
    __syncwarp();
    for (int blk = 0; blk < hid / CW; ++blk) {
      float acc[8][4];
      zero(acc);
      gemm16x64(acc, T1w, LD, W2 + blk * CW * LD, LD);
      // The block's hh values, all loaded before the dhh stores (which
      // may alias them as far as the compiler knows).
      float2 hv[2][8];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          hv[hf][j] = (hf ? v1 : v0)
                          ? *reinterpret_cast<const float2*>(
                                a.hh + (wrow0 + g + 8 * hf) * hid +
                                blk * CW + j * 8 + 2 * tq)
                          : make_float2(0.f, 0.f);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bool ok = hf ? v1 : v0;
        const int r = g + 8 * hf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = j * 8 + 2 * tq;
          const float2 h = hv[hf][j];
          const unsigned pk =
              pack_bf2(acc[j][2 * hf] * gelu_erf_grad(h.x),
                       acc[j][2 * hf + 1] * gelu_erf_grad(h.y));
          *reinterpret_cast<unsigned*>(T2w + r * LD + c) = pk;
          if (ok)
            *reinterpret_cast<unsigned*>(a.dhh + (wrow0 + r) * hid +
                                         blk * CW + c) = pk;
        }
      }
      __syncwarp();
      gemm16x64(dh2, T2w, LD, W1 + blk * CW, ldw1);
      __syncwarp();
    }
  }
  clk(1);
  __syncthreads();  // every warp is past W1, W2: region M is free

  // ---- the AdaLN2 backward plus the residual: dx1 (kept), da = m1 * dx1,
  // the mask gradients' terms -----------------------------------------------
  {
    float cg2[8][2], cb2[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cg2[j][0] = cg2[j][1] = cb2[j][0] = cb2[j][1] = 0.f;
    if (on) {
      float xv[8][4], gm[8][2], gy[8][4];
      load_frag(xv, a.x1, wrow0, v0, v1);
      load_gamma(gm, a.g2 + cb);
      adaln_bwd_frag(dh2, xv, gm, a.eps, v0, v1, cg2, cb2);
      load_frag(gy, a.g, wrow0, v0, v1);
      float av[8][4];
      if (a.a) load_frag(av, a.a, wrow0, v0, v1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = dh2[j][2 * hf + e] + gy[j][2 * hf + e];  // dx1
            dx1s[(qr + g + 8 * hf) * CW + j * 8 + 2 * tq + e] = d;
            if (a.a) dm_part[0] += d * av[j][2 * hf + e];
            dh2[j][2 * hf + e] = d * s1;  // da
          }
      store_bf(dh2, T1w, a.da, wrow0, v0, v1);
    }
    warp_cols(cg2, wpt + warp * 2 * CW);
    warp_cols(cb2, wpt + warp * 2 * CW + CW);
    const float dm1w = warp_sum(dm_part[0]), dm2w = warp_sum(dm_part[1]);
    if (lane == 0) {
      wpm[warp * 2] = dm1w;
      wpm[warp * 2 + 1] = dm2w;
    }
    fold(vp, wpt, wpm, V_2, masks, 4 * CW);
  }
  clk(2);

  // ---- dO = da @ Wproj^T (into RB and the cluster's scratch), D = dO . O
  // per head, the rows' softmax statistics -----------------------------------
  if (on) {
    __syncwarp();
    float acc[8][4];
    zero(acc);
    gemm16x64(acc, T1w, LD, Wp, LD);
    float ov[8][4];
    load_frag(ov, a.o, wrow0, v0, v1);
    float dpart[2][MAXH];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < MAXH; ++h) dpart[hf][h] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = g + 8 * hf, c = j * 8 + 2 * tq;
        const unsigned pk = pack_bf2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        *reinterpret_cast<unsigned*>(T2w + r * LD + c) = pk;
        if (hf ? v1 : v0)
          *reinterpret_cast<unsigned*>(a.dout + (wrow0 + r) * CW + c) = pk;
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pk));
        dpart[hf][j * 8 / D] +=
            d2.x * ov[j][2 * hf] + d2.y * ov[j][2 * hf + 1];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float dsum = quad_sum(dpart[hf][h]);
        const int r = qr + g + 8 * hf;
        if (tq == 0) {
          Ds[r * MAXH + h] = dsum;
          if (r < nr) a.dsum[((size_t)b * H + h) * N + r0 + r] = dsum;
        }
      }
    for (int e = lane; e < 16 * H; e += 32) {
      const int r = qr + e / H, h = e % H;
      const bool ok = r < nr;
      const size_t si = ((size_t)b * H + h) * N + r0 + r;
      Ms[r * MAXH + h] = ok ? a.sm[si] : 0.f;
      Ls[r * MAXH + h] = ok ? 1.0f / a.sl[si] : 0.f;
    }
  }
  __threadfence();  // dO and D: the cluster's other CTAs read them
  __syncthreads();
  clk(3);

  // ---- attention, dq of the CTA's query rows over the clip's keys, which
  // stream through the ring in chunks of CH rows ------------------------------
  const int nch = (N + CH - 1) / CH;
  auto stage_of = [&](int c) {
    return reinterpret_cast<bf16*>(ring + (c & 1) * 2 * CTILE);
  };
  auto issue_kv = [&](int c) {
    if (c < nch) {
      const int n = min(CH, N - c * CH);
      load_rows(stage_of(c), a.qkv, crow0 + c * CH, n, L3, CW);
      load_rows(stage_of(c) + CH * LD, a.qkv, crow0 + c * CH, n, L3, 2 * CW);
    }
    cp_async_commit();
  };
  {
    float dq[8][4];
    zero(dq);
    issue_kv(0);
    for (int c = 0; c < nch; ++c) {
      issue_kv(c + 1);
      cp_async_wait_one();
      __syncthreads();
      const bf16* Kc = stage_of(c);
      const bf16* Vc = Kc + CH * LD;
      const int n = min(CH, N - c * CH);
      if (on) {
        const auto in = [&](int, int key) { return key < n; };
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int ra = (qr + g) * MAXH + h, rb = ra + 8 * MAXH;
          const float m[2] = {Ms[ra], Ms[rb]}, li[2] = {Ls[ra], Ls[rb]};
          const float Dq[2] = {Ds[ra], Ds[rb]};
          QFrag<D> qf, df;
          load_q(qf, RC + qr * LD + h * D, LD);
          load_q(df, T2w + h * D, LD);
          attn_bwd_dq<D>(dq, h * (D / 8), qf, df, Kc + h * D, Vc + h * D, LD,
                         0, n, in, m, li, Dq);
        }
      }
      __syncthreads();
    }
    if (on) {
      // dq (x qscale) into RA (da's rows, spent) and the operand; the
      // warp's v rows into RC (its q rows, spent).
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] *= a.qscale;
      store_bf(dq, T1w, a.dqkv, wrow0, v0, v1, L3, 0);
      load_rows(RC + qr * LD, a.qkv, wrow0, min(16, nr - qr), L3, 2 * CW,
                warp * 32, 32);
      cp_async_commit();
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncwarp();
    }
  }
  clk(4);
  cluster.sync();  // every CTA's dO and D rows are in device memory
  clk(5);

  // ---- attention, dk and dv of the CTA's key rows over the clip's queries
  // (q, dO and their statistics through the ring) -----------------------------
  auto issue_q = [&](int c) {
    if (c < nch) {
      const int n = min(CH, N - c * CH);
      load_rows(stage_of(c), a.qkv, crow0 + c * CH, n, L3, 0);
      load_rows(stage_of(c) + CH * LD, a.dout, crow0 + c * CH, n);
      float* sr = SR + (c & 1) * SR_STAGE;
      for (int e = tid; e < CH * H; e += NTH) {
        const int r = e / H, h = e % H;
        const bool ok = r < n;
        const size_t si = ((size_t)b * H + h) * N + c * CH + r;
        sr[r * MAXH + h] = ok ? a.sm[si] : 0.f;
        sr[CH * MAXH + r * MAXH + h] = ok ? 1.0f / a.sl[si] : 0.f;
        sr[2 * CH * MAXH + r * MAXH + h] = ok ? __ldcg(a.dsum + si) : 0.f;
      }
    }
    cp_async_commit();
  };
  {
    float dk[8][4], dv[8][4];
    zero(dk);
    zero(dv);
    issue_q(0);
    for (int c = 0; c < nch; ++c) {
      issue_q(c + 1);
      cp_async_wait_one();
      __syncthreads();
      const bf16* Qc = stage_of(c);
      const bf16* DOc = Qc + CH * LD;
      const float* srm = SR + (c & 1) * SR_STAGE;
      const float* srl = srm + CH * MAXH;
      const float* srd = srl + CH * MAXH;
      const int n = min(CH, N - c * CH);
      if (on) {
        // A query past the chunk's n rows has the statistics 0, 0: P = 0.
        const auto in = [&](int hf, int) { return hf ? v1 : v0; };
#pragma unroll
        for (int h = 0; h < H; ++h) {
          QFrag<D> kf, vf;
          load_q(kf, RD + qr * LD + h * D, LD);
          load_q(vf, RC + qr * LD + h * D, LD);
          attn_bwd_dkdv<D>(dk, dv, h * (D / 8), kf, vf, Qc + h * D, LD,
                           DOc + h * D, LD, 0, n, in, srm + h, srl + h,
                           srd + h, MAXH);
        }
      }
      __syncthreads();
    }
    if (on) {
      // dk into RB (the warp's dO rows, spent), dv into RD (its k rows).
      __syncwarp();
      store_bf(dk, T2w, a.dqkv, wrow0, v0, v1, L3, CW);
      store_bf(dv, RD + qr * LD, a.dqkv, wrow0, v0, v1, L3, 2 * CW);
    }
  }
  clk(6);

  // ---- qkv^T, the AdaLN1 backward, dx = dx1 + dx_ln -------------------------
  {
    float cg1[8][2], cb1[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cg1[j][0] = cg1[j][1] = cb1[j][0] = cb1[j][1] = 0.f;
    if (on) {
      __syncwarp();
      float dh[8][4];
      zero(dh);
      gemm16x64(dh, T1w, LD, Wqkv, LDQKV);
      gemm16x64(dh, T2w, LD, Wqkv + CW, LDQKV);
      gemm16x64(dh, RD + qr * LD, LD, Wqkv + 2 * CW, LDQKV);
      float xv[8][4], gm[8][2];
      load_frag(xv, a.x, wrow0, v0, v1);
      load_gamma(gm, a.g1 + cb);
      adaln_bwd_frag(dh, xv, gm, a.eps, v0, v1, cg1, cb1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dh[j][2 * hf + e] +=
                dx1s[(qr + g + 8 * hf) * CW + j * 8 + 2 * tq + e];
      store_bf(dh, nullptr, a.dx, wrow0, v0, v1);
    }
    warp_cols(cg1, wpt + warp * 2 * CW);
    warp_cols(cb1, wpt + warp * 2 * CW + CW);
    fold(vp, wpt, wpm, V_1, false, 0);
  }
  clk(7);

  // ---- the per-clip vectors over the cluster, by rank 0 in rank order -----
  cluster.sync();
  if (rank == 0) {
    const size_t bc = (size_t)a.clips * CW;
    const float* rvp[CL];
    for (int r = 0; r < CL; ++r) rvp[r] = cluster.map_shared_rank(vp, r);
    for (int e = tid; e < VP_LEN; e += NTH) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) s += rvp[r][e];
      if (e < 4 * CW)
        a.dgb[(e / CW) * bc + cb + e % CW] = s;
      else if (masks)
        (e == 4 * CW ? a.dm1 : a.dm2)[b] = s;
    }
  }
  cluster.sync();  // the other CTAs' shared memory stays until rank 0 is done
  clk(8);
  clk.write(a.stamps);
}

constexpr int WG = 64;  // the weight launch's output tiles, WG x WG

}  // namespace adb

// The backward's tile program, a cluster of 4 CTAs a clip. ptrs: x, g (dL/d
// out), g1, g2 (gammas [clips, 64] f32), m1, m2, wqkv, wproj, w1, w2 (bf16
// [in, out]), the saved qkv, o, stat_m, stat_l, x1, hh, a, mo (a, mo null
// without mask gradients); dx; the operands m2g, dhh, da, dqkv; the
// scratch dout [M, 64] bf16 and dsum [clips, H, N] f32; dgb [4, clips, 64]
// (dg1, db1, dg2, db2); dm1, dm2 (null without mask gradients); the weight
// launch's counters (zeroed here); stamps (null, or [clips * 4, 9] int64 for
// the stamped instantiation).
extern "C" int pmce_ada_bwd_tile(void* const* ptrs, int clips, int N, int hid,
                                 int H, float eps, void* stream) {
  using namespace adb;
  if (clips <= 0 || N <= 0 || N > CL * RT || hid <= 0 || hid % CW ||
      hid > MAX_HID || (H != 2 && H != 4 && H != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  auto cb = [&](int i) { return static_cast<const bf16*>(ptrs[i]); };
  auto cf = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto b = [&](int i) { return static_cast<bf16*>(ptrs[i]); };
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  a.x = cb(0); a.g = cb(1); a.g1 = cf(2); a.g2 = cf(3);
  a.m1 = cf(4); a.m2 = cf(5);
  a.wqkv = cb(6); a.wproj = cb(7); a.w1 = cb(8); a.w2 = cb(9);
  a.qkv = cb(10); a.o = cb(11); a.sm = cf(12); a.sl = cf(13);
  a.x1 = cf(14); a.hh = cf(15); a.a = cf(16); a.mo = cf(17);
  a.dx = b(18); a.m2g = b(19); a.dhh = b(20); a.da = b(21); a.dqkv = b(22);
  a.dout = b(23); a.dsum = f(24); a.dgb = f(25);
  a.dm1 = f(26); a.dm2 = f(27);
  a.counters = static_cast<int*>(ptrs[28]);
  a.stamps = static_cast<long long*>(ptrs[29]);
  a.ncounters = 4 + 2 * (hid / WG);
  a.clips = clips; a.N = N; a.hid = hid;
  a.eps = eps;
  a.qscale = 1.0f / sqrtf(static_cast<float>(CW / H));
  if ((a.dm1 == nullptr) != (a.dm2 == nullptr) ||
      (a.dm1 && (a.a == nullptr || a.mo == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMCE_ADA_TILE(PROF, D)                                              \
  {                                                                         \
    const auto kernel = ada_bwd_tile_kernel<PROF, D>;                       \
    cudaError_t e = cudaFuncSetAttribute(                                   \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);         \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    kernel<<<clips * CL, NTH, SMEM, s>>>(a);                                \
    return static_cast<int>(cudaGetLastError());                            \
  }
  const int D = CW / H;
  if (a.stamps) {
    if (D == 8) PMCE_ADA_TILE(true, 8)
    if (D == 16) PMCE_ADA_TILE(true, 16)
    PMCE_ADA_TILE(true, 32)
  }
  if (D == 8) PMCE_ADA_TILE(false, 8)
  if (D == 16) PMCE_ADA_TILE(false, 16)
  PMCE_ADA_TILE(false, 32)
#undef PMCE_ADA_TILE
}

// The four weight gradients and four bias gradients in one launch, after
// the tile program. ptrs: h1, o, h2, ge (the products' X), dqkv, da, dhh,
// m2g (their dY), partial ([tiles * splits, 64 * 64] f32), vpartial ([tiles
// * splits, 64] f32), counters ([tiles] int32, zeroed by the tile
// program), out (the 8 parameters' gradients concatenated in their order:
// wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2).
extern "C" int pmce_ada_wgrad(void* const* ptrs, int M, int hid, int splits,
                              void* stream) {
  using namespace adb;
  if (M <= 0 || hid <= 0 || hid % WG || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wg::Args<4> a;
  const int C = CW;
  for (int p = 0; p < 4; ++p) {
    a.X[p] = static_cast<const bf16*>(ptrs[p]);
    a.G[p] = static_cast<const bf16*>(ptrs[4 + p]);
  }
  a.partial = static_cast<float*>(ptrs[8]);
  a.vpartial = static_cast<float*>(ptrs[9]);
  a.counters = static_cast<int*>(ptrs[10]);
  a.mat = static_cast<float*>(ptrs[11]);
  a.vpart = nullptr;
  a.vtiles = a.L = 0;
  a.vec = nullptr;
  return wg::launch_wgrad<WG>(a, {M, M, M, M}, {C, C, C, hid},
                              {3 * C, C, hid, C}, splits, 0,
                              static_cast<cudaStream_t>(stream));
}

// Clusters of the backward's tile program the card holds at once (a clip
// each), or minus a CUDA error code.
extern "C" int pmce_ada_tile_clusters() {
  return tile::max_active_clusters(adb::ada_bwd_tile_kernel<false, 32>,
                                   adb::SMEM);
}

PMCE_EXPORT_ERROR_STRING(pmce_ada_block_error_string)
