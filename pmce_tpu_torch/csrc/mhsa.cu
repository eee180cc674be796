// Multi-head self-attention with its projections, forward and backward,
// for Hopper (sm_90a).
//
// Replaces: pmce_tpu/ops/fused_attention.py `_mhsa_kernel` (entry
// `fused_mhsa`, both its grouped N <= 64 and one-clip N > 64 calls) and
// `_mhsa_bwd_kernel` (via `_fused_mhsa_bwd`):
//
//   out = softmax(q kᵀ / sqrt(dh)) v @ Wproj + bproj,  [q|k|v] = x @ Wqkv + bqkv
//
// per clip of N tokens, any N: the decoder's joint self-attention ([32, 17,
// 64], 8 heads of 8) and the lifter trunk's backward recompute ([B*T, 17,
// 256] and [B*J, 16, 256], 8 heads of 32).
//
// What bounds it on this card: little. At [32, 17, 64] the products are
// 0.02 GFLOP and the activations 0.1 MB (a few microseconds at the bf16
// tensor-core peak or at 3.35 TB/s); at the trunk's [512, 17, 256] 1.9
// GFLOP (~2 us). Launches and latency bound it.
//
// Forward, one launch where the tile programs' gate holds (N <= 64; C = 64
// with heads of 8, 16 or 32, or C = 256 with heads of 32): a CTA owns whole
// clips, at most 128 rows (mhsa_fwd_plan on the host picks how many), and
// each clip attends to its own rows: a query's keys are its clip's, picked
// out of the 16-key blocks its clips span by index (no padding clips, no
// block-diagonal mask matrix). Scores, P.V and both products run on the
// tensor cores (mma.sync m16n8k16, m16n8k8 for heads of 8; ldmatrix; weights
// by cp.async in their own [in, out] layout), the softmax in two passes
// (the row max and sum, kept for the backward, then P = bf16(exp(s - m) /
// l), the plain version's cast point, and O = P V; adaln_tile.cuh's
// clip_attention).
// - C = 64 (mhf::narrow_kernel): both weights whole in shared memory; the
//   qkv product by (16-row block, q | k | v) items into three [128, 72]
//   tiles, the attention by (16-row block, head) items into an o tile, the
//   projection by 16-row blocks: every warp busy even at one clip a CTA.
//   Shared memory 106 KB: two CTAs an SM.
// - C = 256 (mhf::wide_kernel): tile_block.cuh's per-head sequence and its
//   3-stage weight ring (row 6's and K1's): per head, its q / k / v columns
//   of x @ Wqkv, its attention, then O_h @ Wproj[head rows] added into an
//   f32 accumulator in registers. Shared memory 201 KB.
// The forward writes the state the backward reads (qkv, o, the softmax max
// and sum) only when a gradient is owed, evict-first.
//
// Outside that gate (N > 64, other widths) the forward is the launch
// sequence: the shared WMMA GEMMs with fused epilogues (transformer_ops.cuh)
// around attention_ops.cuh's thread-per-query kernel, which streams keys
// through shared memory and keeps each query's softmax max and sum.
//
// Backward (simple first): the saved qkv, head outputs and statistics; the
// attention pass runs twice, query-major for dq and key-major for dk / dv,
// so that every gradient element is summed by one thread; the parameter
// gradients are split-K partial tiles added in a fixed order (no float
// atomics: reruns agree bit for bit). One C call runs each direction's
// whole sequence.

#include "adaln_tile.cuh"
#include "attention_ops.cuh"
#include "tile_block.cuh"

using namespace pmce;

namespace {

// Backward scratch, in carve order.
struct MhsaWs {
  bf16 *dout, *dqkv;
  float *dsum, *colpart, *tnpart;
};

MhsaWs mhsa_ws(Carve& c, int clips, int N, int C, int H) {
  const int M = clips * N;
  MhsaWs w;
  w.dout = c.take<bf16>((size_t)M * C);
  w.dqkv = c.take<bf16>((size_t)M * 3 * C);
  w.dsum = c.take<float>((size_t)clips * H * N);
  w.colpart = c.take<float>(colsum_part_elems(M, 3 * C));
  w.tnpart = c.take<float>(std::max(tn_part_elems(M, C, 3 * C),
                                    tn_part_elems(M, C, C)));
  return w;
}

}  // namespace

// ---------------------------------------------------------------------------
// The forward's tile programs (row 4).
// ---------------------------------------------------------------------------
namespace mhf {

using namespace tile;

constexpr int NSTAMP = 4;  // loads, qkv, attention, proj + store

struct Args {
  const bf16* x;                        // [M, C]
  const bf16 *wqkv, *wproj;             // [C, 3C], [C, C]
  const float *bqkv, *bproj;
  bf16* out;
  bf16 *qkv, *o;                        // the saved state, or all null
  float *sm, *sl;                       // [clips, H, N] softmax max, sum
  int clips, N, cpc;                    // cpc: clips a CTA
  float qscale;
  long long* stamps;                    // [grid, NSTAMP] or null
  tb::BlockArgs ring;                   // the wide program's weight ring
};

// The tile of whole clips a CTA owns: rows [rows0, rows0 + nrows).
struct Tile {
  size_t rows0;
  int nrows;
  __device__ explicit Tile(const Args& a) {
    rows0 = (size_t)blockIdx.x * a.cpc * a.N;
    nrows = min(a.cpc, a.clips - (int)blockIdx.x * a.cpc) * a.N;
  }
};

// The saved softmax statistics of rows g, g + 8 of a 16-row block from
// tile row r0 (lanes with tq = 0 store).
__device__ __forceinline__ void store_stats(const Args& a, const Tile& tl,
                                            int r0, int h, int H,
                                            const float (&m)[2],
                                            const float (&l)[2]) {
  const int lane = threadIdx.x & 31;
  if (!a.sm || (lane & 3)) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + (lane >> 2) + 8 * hf;
    if (r >= tl.nrows) continue;
    const size_t row = tl.rows0 + r, clip = row / a.N;
    const size_t si = (clip * H + h) * a.N + row % a.N;
    __stcs(a.sm + si, m[hf]);
    __stcs(a.sl + si, l[hf]);
  }
}

// C = 64: shared-memory plan, bytes.
constexpr int L3 = 3 * CW, LDQKV = L3 + 8;
constexpr int TILE = RT * LD * 2;                     // [128, 72] bf16
constexpr int OFF_WQKV = 0;                           // [64, 200]
constexpr int OFF_WP = OFF_WQKV + CW * LDQKV * 2;     // [64, 72]
constexpr int OFF_T = OFF_WP + CW * LD * 2;           // q, k, v, o tiles
constexpr int SMEM_NARROW = OFF_T + 4 * TILE;

template <bool PROF, int D>
__global__ void __launch_bounds__(NTH, 2) narrow_kernel(const Args a) {
  constexpr int H = CW / D;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Wqkv = reinterpret_cast<bf16*>(smem + OFF_WQKV);
  bf16* Wp = reinterpret_cast<bf16*>(smem + OFF_WP);
  // Tiles 0-3: q, k, v, o.
  const auto T = [&](int i) {
    return reinterpret_cast<bf16*>(smem + OFF_T + i * TILE);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  StageClock<PROF, NSTAMP> clk;
  clk.start();
  for (int c = tid; c < CW * (L3 / 8); c += NTH) {
    const int r = c / (L3 / 8), cc = c % (L3 / 8) * 8;
    cp_async16(Wqkv + r * LDQKV + cc, a.wqkv + r * L3 + cc, true);
  }
  for (int c = tid; c < CW * 8; c += NTH) {
    const int r = c / 8, cc = c % 8 * 8;
    cp_async16(Wp + r * LD + cc, a.wproj + r * CW + cc, true);
  }
  cp_async_commit();
  const Tile tl(a);
  const int nb = (tl.nrows + 15) / 16;
  // An item's x rows as A fragments (zeros past the tile's rows): the
  // warp's first while the weights are in flight.
  unsigned af[4][4];
  const auto load_x = [&](int it) {
    const int qr = it / 3 * 16;
    float xv[8][4];
    load_frag(xv, a.x, tl.rows0 + qr, qr + g < tl.nrows,
              qr + g + 8 < tl.nrows);
    frag_a(af, xv);
  };
  if (warp < nb * 3) load_x(warp);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  clk(0);

  // ---- q, k, v of each 16-row block (q scaled in f32 before its bf16
  // rounding); rows past the tile's are zeros in x, finite in the tiles ----
  for (int it = warp; it < nb * 3; it += NW) {
    const int qr = it / 3 * 16, j = it % 3;
    const bool v0 = qr + g < tl.nrows, v1 = qr + g + 8 < tl.nrows;
    if (it != warp) load_x(it);
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
    store_bf<true>(acc, T(j) + qr * LD, a.qkv, tl.rows0 + qr, v0, v1, L3,
                   j * CW);
  }
  __syncthreads();
  clk(1);

  // ---- attention by (16-row block, head) --------------------------------
  for (int it = warp; it < nb * H; it += NW) {
    const int qr = it / H * 16, h = it % H;
    float o[D / 8][4] = {}, m[2], l[2];
    clip_attention<D>(T(0) + h * D, T(1) + h * D, T(2) + h * D, LD, qr, a.N,
                      tl.nrows, o, m, l);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = qr + g + 8 * hf, c = h * D + d * 8 + 2 * tq;
        const unsigned pk = pack_bf2(o[d][2 * hf], o[d][2 * hf + 1]);
        *reinterpret_cast<unsigned*>(T(3) + r * LD + c) = pk;
        if (a.o && r < tl.nrows)
          __stcs(reinterpret_cast<unsigned*>(a.o + (tl.rows0 + r) * CW + c),
                 pk);
      }
    store_stats(a, tl, qr, h, H, m, l);
  }
  __syncthreads();
  clk(2);

  // ---- the projection of each 16-row block -------------------------------
  for (int qr = warp * 16; qr < nb * 16; qr += NW * 16) {
    float acc[8][4];
    zero(acc);
    mma_sw(acc, T(3) + qr * LD, LD, Wp, LD);
    add_cols(acc, a.bproj);
    store_bf(acc, nullptr, a.out, tl.rows0 + qr, qr + g < tl.nrows,
             qr + g + 8 < tl.nrows);
  }
  clk(3);
  clk.write(a.stamps);
}

// C = 256, heads of 32: tile_block.cuh's layout and weight ring. Shared
// memory: x [128, 264], the head's q | k | v [128, 104], its o [128, 40],
// the ring's 3 stages.
constexpr int OFF_XS = 0;
constexpr int OFF_QKVH = OFF_XS + tb::TM * tb::LDH * 2;
constexpr int OFF_OH = OFF_QKVH + tb::TM * tb::LDQ * 2;
constexpr int OFF_RING = OFF_OH + tb::TM * tb::LDO * 2;
constexpr int SMEM_WIDE = OFF_RING + tb::NSTAGE * tb::STAGE_ELEMS * 2;
static_assert(SMEM_WIDE <= 232448, "over the opt-in shared memory");

template <bool PROF>
__global__ void __launch_bounds__(tb::NTH, 1) wide_kernel(const Args a) {
  using tb::DHD;
  using tb::LDO;
  using tb::LDQ;
  constexpr int C = tb::CW, H = tb::HEADS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_XS);
  bf16* qkv = reinterpret_cast<bf16*>(smem + OFF_QKVH);
  bf16* oh = reinterpret_cast<bf16*>(smem + OFF_OH);
  bf16* ring = reinterpret_cast<bf16*>(smem + OFF_RING);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // the output: 64 x 64 a warp
  const int hm = warp >> 1, hn = warp & 1;  // q / k / v: 32 x 48 a warp
  StageClock<PROF, NSTAMP> clk;
  clk.start();
  const Tile tl(a);
  const int total = H * tb::SLICES_PER_HEAD;
  int s = 0;
  tb::issue_slice(a.ring, 0, ring);
  cp_async_commit();
  tb::issue_slice(a.ring, 1, ring);
  cp_async_commit();
  for (int c = tid; c < tb::TM * (C / 8); c += NTH) {
    const int r = c / (C / 8), cc = c % (C / 8) * 8;
    if (r < tl.nrows)
      cp_async16(xs + r * tb::LDH + cc, a.x + (tl.rows0 + r) * C + cc, true);
    else
      *reinterpret_cast<uint4*>(xs + r * tb::LDH + cc) =
          make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  clk(0);

  // The output accumulator, bproj first.
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bz = *reinterpret_cast<const float2*>(
          a.bproj + wn * 64 + j * 8 + 2 * tq);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        acc[i][j][2 * hf] = bz.x;
        acc[i][j][2 * hf + 1] = bz.y;
      }
    }

  for (int h = 0; h < H; ++h) {
    // ---- q / k / v of head h: [128, 96] --------------------------------
    float pq[2][6][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 6; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) pq[mi][nj][e] = 0.f;
    for (int j = 0; j < C / tb::KQ; ++j) {
      const bf16* w = tb::ring_next(a.ring, s, total, ring);
      if (hm * 32 < tl.nrows) tb::qkv_slice(pq, xs, w, j, hm, hn);
    }
    tb::qkv_epilogue(pq, qkv, a.bqkv, h, a.qscale, hm, hn);
    __syncthreads();
    if (a.qkv)  // the head's q | k | v columns of the saved [M, 3C] qkv
      for (int c = tid; c < tl.nrows * 12; c += NTH) {
        const int r = c / 12, seg = c % 12 / 4, cc = c % 4 * 8;
        __stcs(reinterpret_cast<uint4*>(a.qkv + (tl.rows0 + r) * (3 * C) +
                                        seg * C + h * DHD + cc),
               *reinterpret_cast<const uint4*>(qkv + r * LDQ + seg * DHD +
                                               cc));
      }
    clk(1);

    // ---- the head's attention, a warp's 16 query rows ------------------
    const int q0 = warp * 16;
    if (q0 < tl.nrows) {
      float o[DHD / 8][4] = {}, m[2], l[2];
      // Two key blocks at a time: the accumulator's 128 registers a
      // thread leave no room for more.
      clip_attention<DHD, 2>(qkv, qkv + DHD, qkv + 2 * DHD, LDQ, q0, a.N,
                             tl.nrows, o, m, l);
#pragma unroll
      for (int d = 0; d < DHD / 8; ++d)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<unsigned*>(oh + (q0 + g + 8 * hf) * LDO + d * 8 +
                                       2 * tq) =
              pack_bf2(o[d][2 * hf], o[d][2 * hf + 1]);
      store_stats(a, tl, q0, h, H, m, l);
      __syncwarp();
      if (a.o)
        for (int e = lane; e < 16 * 4; e += 32) {
          const int r = q0 + e / 4, cc = e % 4 * 8;
          if (r < tl.nrows)
            __stcs(reinterpret_cast<uint4*>(a.o + (tl.rows0 + r) * C +
                                            h * DHD + cc),
                   *reinterpret_cast<const uint4*>(oh + r * LDO + cc));
        }
    } else {
      for (int e = lane; e < 16 * 4; e += 32)
        *reinterpret_cast<uint4*>(oh + (q0 + e / 4) * LDO + e % 4 * 8) =
            make_uint4(0, 0, 0, 0);
    }
    clk(2);

    // ---- acc += O_h @ Wproj[head rows]: K = 32 --------------------------
    const bf16* w = tb::ring_next(a.ring, s, total, ring);
    if (wm * 64 < tl.nrows) tb::proj_slice(acc, oh, w, wm, wn);
    clk(3);
  }

  // ---- the output rows ---------------------------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + i * 16 + g + 8 * hf;
      if (r >= tl.nrows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<unsigned*>(a.out + (tl.rows0 + r) * C + wn * 64 +
                                     j * 8 + 2 * tq) =
            pack_bf2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
    }
  clk.write(a.stamps);
}

template <bool PROF>
int launch(const Args& a, int C, int D, cudaStream_t s) {
  const int grid = (a.clips + a.cpc - 1) / a.cpc;
  int smem = SMEM_NARROW;
  const void* k = nullptr;
  if (C == tb::CW && D == tb::DHD) {
    k = reinterpret_cast<const void*>(wide_kernel<PROF>);
    smem = SMEM_WIDE;
  } else if (C == CW && D == 8) {
    k = reinterpret_cast<const void*>(narrow_kernel<PROF, 8>);
  } else if (C == CW && D == 16) {
    k = reinterpret_cast<const void*>(narrow_kernel<PROF, 16>);
  } else if (C == CW && D == 32) {
    k = reinterpret_cast<const void*>(narrow_kernel<PROF, 32>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {const_cast<Args*>(&a)};
  e = cudaLaunchKernel(k, dim3(grid), dim3(NTH), args, smem, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace mhf

// The forward's tile program, one launch of ceil(clips / cpc) CTAs of cpc
// whole clips each (cpc * N <= 128). ptrs: x [M, C] bf16, wqkv [C, 3C],
// bqkv, wproj [C, C], bproj (bf16 [in, out] / f32), out; the saved qkv [M,
// 3C], o [M, C], stat_m, stat_l [clips, H, N] (all null: not saving);
// stamps (null, or int64 [grid, 4] for the stamped instantiation).
extern "C" int pmce_mhsa_fwd_tile(void* const* ptrs, int clips, int N, int C,
                                  int H, int cpc, void* stream) {
  using namespace mhf;
  if (clips <= 0 || N <= 0 || H <= 0 || C % H || cpc <= 0 ||
      cpc * N > RT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.wqkv = static_cast<const bf16*>(ptrs[1]);
  a.bqkv = static_cast<const float*>(ptrs[2]);
  a.wproj = static_cast<const bf16*>(ptrs[3]);
  a.bproj = static_cast<const float*>(ptrs[4]);
  a.out = static_cast<bf16*>(ptrs[5]);
  a.qkv = static_cast<bf16*>(ptrs[6]);
  a.o = static_cast<bf16*>(ptrs[7]);
  a.sm = static_cast<float*>(ptrs[8]);
  a.sl = static_cast<float*>(ptrs[9]);
  a.stamps = static_cast<long long*>(ptrs[10]);
  a.clips = clips; a.N = N; a.cpc = cpc;
  a.qscale = 1.0f / sqrtf(static_cast<float>(C / H));
  a.ring.wqkv = a.wqkv;
  a.ring.wproj = a.wproj;
  // The saved state is written whole or not at all.
  int saved = 0;
  for (int i = 6; i <= 9; ++i) saved += ptrs[i] != nullptr;
  if (saved != 0 && saved != 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.stamps ? launch<true>(a, C, C / H, s) : launch<false>(a, C, C / H, s);
}

extern "C" long long pmce_mhsa_workspace(int clips, int N, int C, int H) {
  Carve c(nullptr);
  mhsa_ws(c, clips, N, C, H);
  return static_cast<long long>(c.off);
}

// P: x, wqkv [C,3C], bqkv, wproj [C,C], bproj; saved qkv [M,3C], o [M,C],
// stat_m, stat_l [clips,H,N]; out [M,C].
extern "C" int pmce_mhsa_fwd(void* const* P, int clips, int N, int C, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  PMCE_TRY(self_attn_fwd(b(0), clips, N, C, H, b(1), f(2), b(5), b(6), f(7),
                         f(8), s));
  return gemm(EPI_STORE, b(6), b(3), clips * N, C, C, b(9), 0, f(4), s);
}

// P: x, g (dL/d out), wqkvᵀ [3C,C], wprojᵀ [C,C], saved qkv, o, stat_m,
// stat_l; dx [M,C] bf16; grads f32 (dwqkv, dbqkv, dwproj, dbproj); ws.
extern "C" int pmce_mhsa_bwd(void* const* P, int clips, int N, int C, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [&](int i) { return static_cast<bf16*>(P[i]); };
  auto f = [&](int i) { return static_cast<float*>(P[i]); };
  Carve c(P[10]);
  const MhsaWs w = mhsa_ws(c, clips, N, C, H);
  float* gr = f(9);
  const SelfAttnGrads g{gr, gr + 3 * C * C, gr + 3 * C * C + 3 * C,
                        gr + 4 * C * C + 3 * C};
  return self_attn_bwd(b(0), b(1), clips, N, C, H, b(4), b(5), f(6), f(7),
                       b(2), b(3), w.dout, w.dqkv, w.dsum, w.colpart,
                       w.tnpart, g, b(8), 0, s);
}

PMCE_EXPORT_ERROR_STRING(pmce_mhsa_error_string)
