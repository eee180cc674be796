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
// Backward, two launches inside the forward's gate, on the state the
// forward saved (qkv with q pre-scaled, o, the softmax max and sum):
// - the tile program (mhb::): a CTA owns the forward's whole clips, so
//   every dk and dv row is summed inside the CTA that owns it (no cluster,
//   no device barrier, no float atomic: reruns are bit-identical). Per
//   head, dO = g @ Wproj^T (W^T's B fragments from W's own rows), D = dO .
//   O (the row sums of the softmax backward in the form row 9 uses: D =
//   sum_j P_ij dP_ij with O = P V, from the saved bf16 o and the bf16 dO),
//   P recomputed from the saved q, k, max and sum as clip_attention forms
//   it, dS = P (dP - D), dq = dS K qscale, dk = dS^T Q, dv = P^T dO (P and
//   dS rounded to bf16 before their products, f32 sums: adaln_tile.cuh's
//   attn_bwd_dq / attn_bwd_dkdv, shared with row 9), all on mma.sync
//   (m16n8k8 for heads of 8); it writes dqkv (the weight launch's operand)
//   and dx = dqkv @ Wqkv^T, and zeroes the weight launch's counters.
//   C = 64 (mhb::narrow_kernel): both weights whole in shared memory, the
//   tile's q, k, v, dO (over g), dq, dk, dv as [128, 72] tiles: dO by
//   16-row blocks, the attention by (16-row block, head) items (every warp
//   busy at one clip a CTA), dx by 16-row blocks: 172 KB of shared memory
//   (one CTA an SM), 106-115 registers (stamped 110-117), no spills.
//   C = 256 (mhb::wide_kernel): per head, its q | k | v columns and
//   Wproj's 32 head rows double-buffered by cp.async, dO_h and the
//   attention of a warp's 16 rows; dqkv's head columns go to device
//   memory, and dx is a second phase over K = 3C (Wqkv^T's [256, 32]
//   column blocks with the tile's own dqkv columns, read back from L2,
//   through a 3-stage ring over the spent tiles): a [128, 256] f32
//   accumulator beside the per-head attention state would spill. 163 KB of
//   shared memory, 213 registers (stamped 224), no spills.
// The weight launch takes 96 registers at C = 64 (64 x 64 tiles), 153 at
// C = 256 (128 x 128). (ptxas -v for sm_90a; chip_smoke.py prints the
// libraries' [build] lines.)
// - the weight launch (wgrad.cuh, shared with rows 7, 9 and 11): dWqkv =
//   x^T dqkv and dWproj = o^T g with dbqkv and dbproj by their column sums,
//   fixed K ranges added in range order. No transposed weight copy.
// Outside the gate the backward is the launch sequence (counter mhsa_bwd_seq):
// transposed weight copies, the attention pass twice on the CUDA cores
// (query-major for dq, key-major for dk / dv), split-K weight partials
// added in a fixed order; one C call runs it.

#include "adaln_tile.cuh"
#include "attention_ops.cuh"
#include "tile_block.cuh"
#include "wgrad.cuh"

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

// A [128, 256] f32 accumulator (warp (wm, wn): rows wm * 64 .., columns
// wn * 64 ..) rounded to bf16 into the tile's valid rows of dst (row0 ..).
__device__ __forceinline__ void store_wide(const float (&acc)[4][8][4],
                                           bf16* dst, size_t row0, int nrows,
                                           int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 64 + i * 16 + g + 8 * hf;
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<unsigned*>(dst + (row0 + r) * tb::CW + wn * 64 +
                                     j * 8 + 2 * tq) =
            pack_bf2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
    }
}

// One launch of a tile program (tile::NTH threads a CTA, `smem` bytes of
// dynamic shared memory, opted in first) on its argument struct.
template <typename K, typename A>
int launch_tile(K kernel, int grid, int smem, const A& a, cudaStream_t s) {
  const void* k = reinterpret_cast<const void*>(kernel);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {const_cast<A*>(&a)};
  e = cudaLaunchKernel(k, dim3(grid), dim3(tile::NTH), args, smem, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
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

// The tile of whole clips a CTA owns: rows [rows0, rows0 + nrows) (the
// backward's CTAs own the forward's).
struct Tile {
  size_t rows0;
  int nrows;
  template <typename A>
  __device__ explicit Tile(const A& a) {
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

  store_wide(acc, a.out, tl.rows0, tl.nrows, wm, wn);
  clk.write(a.stamps);
}

template <bool PROF>
int launch(const Args& a, int C, int D, cudaStream_t s) {
  const int grid = (a.clips + a.cpc - 1) / a.cpc;
  if (C == tb::CW && D == tb::DHD)
    return launch_tile(wide_kernel<PROF>, grid, SMEM_WIDE, a, s);
  if (C == CW && D == 8)
    return launch_tile(narrow_kernel<PROF, 8>, grid, SMEM_NARROW, a, s);
  if (C == CW && D == 16)
    return launch_tile(narrow_kernel<PROF, 16>, grid, SMEM_NARROW, a, s);
  if (C == CW && D == 32)
    return launch_tile(narrow_kernel<PROF, 32>, grid, SMEM_NARROW, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// ---------------------------------------------------------------------------
// The backward's tile programs (row 5).
// ---------------------------------------------------------------------------
namespace mhb {

using namespace tile;
using mhf::Tile;

constexpr int NSTAMP = 5;  // loads, dO + D, attention dq, attention dk dv,
                           // dx + store

struct Args {
  const bf16* g;                        // [M, C] dL/d out
  const bf16 *wqkv, *wproj;             // [C, 3C], [C, C]
  const bf16 *qkv, *o;                  // the forward's, q pre-scaled
  const float *sm, *sl;                 // [clips, H, N] softmax max, sum
  bf16 *dx, *dqkv;                      // [M, C], [M, 3C]
  int* counters;                        // the weight launch's, zeroed here
  int ncounters, clips, N, cpc;
  float qscale;
  long long* stamps;                    // [grid, NSTAMP] or null
};

// A warp's [16, D] accumulator block (n8 tiles 0 .. D / 8) rounded to bf16
// into the tile t (row stride ldt; null: none) and into dst's valid rows
// row0 .. (row stride ld, columns col0 ..).
template <int D>
__device__ __forceinline__ void store_head(const float (&v)[D / 8][4],
                                           bf16* t, int ldt, bf16* dst,
                                           size_t row0, bool v0, bool v1,
                                           int ld, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      const int c = d * 8 + 2 * tq;
      const unsigned pk = pack_bf2(v[d][2 * hf], v[d][2 * hf + 1]);
      if (t) *reinterpret_cast<unsigned*>(t + (g + 8 * hf) * ldt + c) = pk;
      if (hf ? v1 : v0)
        *reinterpret_cast<unsigned*>(dst + (row0 + g + 8 * hf) * ld + col0 +
                                     c) = pk;
    }
}

// The saved softmax max and 1/sum of a tile row r and head h (0, 0 past
// the tile's rows: no key is attended).
__device__ __forceinline__ void load_stats(const Args& a, const Tile& tl,
                                           int r, int h, int H, float& m,
                                           float& li) {
  m = li = 0.f;
  if (r < tl.nrows) {
    const size_t row = tl.rows0 + r;
    const size_t si = (row / a.N * H + h) * a.N + row % a.N;
    m = a.sm[si];
    li = 1.0f / a.sl[si];
  }
}

// C = 64: shared-memory plan, bytes. Both weights; seven [128, 72] bf16
// tiles (q, k, v, dO over g, dq, dk, dv); the rows' softmax max, 1/sum and
// D a head.
constexpr int L3 = 3 * CW, LDQKV = L3 + 8;
constexpr int TILE = RT * LD * 2;
constexpr int OFF_WQKV = 0;                           // [64, 200]
constexpr int OFF_WP = OFF_WQKV + CW * LDQKV * 2;     // [64, 72]
constexpr int OFF_T = OFF_WP + CW * LD * 2;
constexpr int OFF_ST = OFF_T + 7 * TILE;
constexpr int SMEM_NARROW = OFF_ST + 3 * RT * MAXH * 4;
static_assert(SMEM_NARROW <= 232448, "over the opt-in shared memory");

template <bool PROF, int D>
__global__ void __launch_bounds__(NTH, 1) narrow_kernel(const Args a) {
  constexpr int H = CW / D;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Wqkv = reinterpret_cast<bf16*>(smem + OFF_WQKV);
  bf16* Wp = reinterpret_cast<bf16*>(smem + OFF_WP);
  const auto T = [&](int i) {
    return reinterpret_cast<bf16*>(smem + OFF_T + i * TILE);
  };
  float* Ms = reinterpret_cast<float*>(smem + OFF_ST);
  float* Ls = Ms + RT * MAXH;
  float* Ds = Ls + RT * MAXH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  StageClock<PROF, NSTAMP> clk;
  clk.start();
  if (blockIdx.x == 0 && tid < a.ncounters) a.counters[tid] = 0;
  const Tile tl(a);
  const int nb = (tl.nrows + 15) / 16;

  // ---- loads: both weights, the tile's q, k, v and g rows (zeros up to
  // the next 16), the rows' softmax statistics -----------------------------
  for (int c = tid; c < CW * (L3 / 8); c += NTH) {
    const int r = c / (L3 / 8), cc = c % (L3 / 8) * 8;
    cp_async16(Wqkv + r * LDQKV + cc, a.wqkv + r * L3 + cc, true);
  }
  for (int c = tid; c < CW * 8; c += NTH) {
    const int r = c / 8, cc = c % 8 * 8;
    cp_async16(Wp + r * LD + cc, a.wproj + r * CW + cc, true);
  }
  for (int j = 0; j < 3; ++j)
    load_rows(T(j), a.qkv, tl.rows0, tl.nrows, L3, j * CW);
  load_rows(T(3), a.g, tl.rows0, tl.nrows);
  cp_async_commit();
  for (int e = tid; e < nb * 16 * H; e += NTH) {
    const int r = e / H, h = e % H;
    load_stats(a, tl, r, h, H, Ms[r * MAXH + h], Ls[r * MAXH + h]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  clk(0);

  // ---- dO = g @ Wproj^T of each 16-row block, rounded to bf16 in place of
  // g; D = dO . O of each head ----------------------------------------------
  for (int it = warp; it < nb; it += NW) {
    const int qr = it * 16;
    const bool v0 = qr + g < tl.nrows, v1 = qr + g + 8 < tl.nrows;
    bf16* t = T(3) + qr * LD;
    float acc[8][4], ov[8][4];
    zero(acc);
    gemm16x64(acc, t, LD, Wp, LD);
    load_frag(ov, a.o, tl.rows0 + qr, v0, v1);
    __syncwarp();
    float dpart[2][H] = {};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned pk = pack_bf2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        *reinterpret_cast<unsigned*>(t + (g + 8 * hf) * LD + j * 8 +
                                     2 * tq) = pk;
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pk));
        dpart[hf][j * 8 / D] +=
            d2.x * ov[j][2 * hf] + d2.y * ov[j][2 * hf + 1];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float d = quad_sum(dpart[hf][h]);
        if (tq == 0) Ds[(qr + g + 8 * hf) * MAXH + h] = d;
      }
  }
  __syncthreads();
  clk(1);

  // ---- attention dq by (16-row block, head) items: dS K over the keys of
  // the rows' clips, times qscale, into tile 4 and dqkv's q columns ---------
  for (int it = warp; it < nb * H; it += NW) {
    const int qr = it / H * 16, h = it % H;
    const ClipSpan sp(qr, a.N, tl.nrows);
    const int ra = (qr + g) * MAXH + h, rb = ra + 8 * MAXH;
    const float m[2] = {Ms[ra], Ms[rb]}, li[2] = {Ls[ra], Ls[rb]};
    const float Dq[2] = {Ds[ra], Ds[rb]};
    QFrag<D> qf, df;
    load_q(qf, T(0) + qr * LD + h * D, LD);
    load_q(df, T(3) + qr * LD + h * D, LD);
    float dq[D / 8][4] = {};
    attn_bwd_dq<D>(dq, 0, qf, df, T(1) + h * D, T(2) + h * D, LD, sp.beg,
                   sp.end, sp, m, li, Dq);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[d][e] *= a.qscale;
    store_head<D>(dq, T(4) + qr * LD + h * D, LD, a.dqkv, tl.rows0 + qr,
                  qr + g < tl.nrows, qr + g + 8 < tl.nrows, L3, h * D);
  }
  clk(2);

  // ---- attention dk, dv by (16-row block, head) items: the block's keys
  // over the queries of their clips, into tiles 5, 6 and dqkv's k, v
  // columns ---------------------------------------------------------------
  for (int it = warp; it < nb * H; it += NW) {
    const int kr = it / H * 16, h = it % H;
    const ClipSpan sp(kr, a.N, tl.nrows);
    QFrag<D> kf, vf;
    load_q(kf, T(1) + kr * LD + h * D, LD);
    load_q(vf, T(2) + kr * LD + h * D, LD);
    float dk[D / 8][4] = {}, dv[D / 8][4] = {};
    attn_bwd_dkdv<D>(dk, dv, 0, kf, vf, T(0) + h * D, LD, T(3) + h * D, LD,
                     sp.beg, sp.end, sp, Ms + h, Ls + h, Ds + h, MAXH);
    const bool v0 = kr + g < tl.nrows, v1 = kr + g + 8 < tl.nrows;
    store_head<D>(dk, T(5) + kr * LD + h * D, LD, a.dqkv, tl.rows0 + kr, v0,
                  v1, L3, CW + h * D);
    store_head<D>(dv, T(6) + kr * LD + h * D, LD, a.dqkv, tl.rows0 + kr, v0,
                  v1, L3, 2 * CW + h * D);
  }
  __syncthreads();
  clk(3);

  // ---- dx = dq Wq^T + dk Wk^T + dv Wv^T of each 16-row block, Wqkv^T's B
  // fragments from Wqkv's own rows ------------------------------------------
  for (int qr = warp * 16; qr < nb * 16; qr += NW * 16) {
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gemm16x64(acc, T(4 + j) + qr * LD, LD, Wqkv + j * CW, LDQKV);
    store_bf(acc, nullptr, a.dx, tl.rows0 + qr, qr + g < tl.nrows,
             qr + g + 8 < tl.nrows);
  }
  clk(4);
  clk.write(a.stamps);
}

// C = 256, heads of 32: shared-memory plan, bytes. g's tile [128, 264];
// two head buffers (the head's q | k | v [128, 104] and Wproj's 32 head
// rows [32, 264]: the next head's load while one is worked on); the
// head's dO [128, 40]; its rows' softmax max, 1/sum and D. dx's weight
// ring (3 stages of Wqkv^T's [256, 32] column blocks with the tile's own
// [128, 32] dqkv columns) lies over g's tile and the head buffers, spent
// by then.
constexpr int HB = tb::TM * tb::LDQ * 2 + tb::DHD * tb::LDW_N * 2;
constexpr int OFF_GS = 0;
constexpr int OFF_HB = OFF_GS + tb::TM * tb::LDH * 2;
constexpr int OFF_DO = OFF_HB + 2 * HB;
constexpr int OFF_WST = OFF_DO + tb::TM * tb::LDO * 2;
constexpr int SMEM_WIDE = OFF_WST + 3 * tb::TM * 4;
constexpr int RING_STAGE = (tb::CW + tb::TM) * tb::LDW_C;  // elements
constexpr int DX_SLICES = 3 * tb::HEADS;
static_assert(3 * RING_STAGE * 2 <= OFF_DO, "dx's ring over spent tiles");
static_assert(SMEM_WIDE <= 232448, "over the opt-in shared memory");

template <bool PROF>
__global__ void __launch_bounds__(tb::NTH, 1) wide_kernel(const Args a) {
  using tb::DHD;
  using tb::LDH;
  using tb::LDO;
  using tb::LDQ;
  using tb::LDW_C;
  using tb::LDW_N;
  constexpr int C = tb::CW, H = tb::HEADS, L3W = 3 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem + OFF_GS);
  bf16* dos = reinterpret_cast<bf16*>(smem + OFF_DO);
  float* Mst = reinterpret_cast<float*>(smem + OFF_WST);
  float* Lst = Mst + tb::TM;
  float* Dst = Lst + tb::TM;
  const auto hbuf = [&](int h) {
    return reinterpret_cast<bf16*>(smem + OFF_HB + (h & 1) * HB);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  StageClock<PROF, NSTAMP> clk;
  clk.start();
  if (blockIdx.x == 0 && tid < a.ncounters) a.counters[tid] = 0;
  const Tile tl(a);
  const int nrows = tl.nrows;
  // Head h's q | k | v columns of the tile's rows and Wproj's 32 head rows
  // into its buffer (rows past the tile's: zeros).
  const auto issue_head = [&](int h) {
    bf16* qkv = hbuf(h);
    bf16* wp = qkv + tb::TM * LDQ;
    for (int c = tid; c < tb::TM * 12; c += NTH) {
      const int r = c / 12, seg = c % 12 / 4, cc = c % 4 * 8;
      const bool ok = r < nrows;
      cp_async16(qkv + r * LDQ + seg * DHD + cc,
                 a.qkv + (tl.rows0 + (ok ? r : 0)) * L3W + seg * C +
                     h * DHD + cc,
                 ok);
    }
    for (int c = tid; c < DHD * (C / 8); c += NTH) {
      const int r = c / (C / 8), cc = c % (C / 8) * 8;
      cp_async16(wp + r * LDW_N + cc, a.wproj + (size_t)(h * DHD + r) * C + cc,
                 true);
    }
  };
  for (int c = tid; c < tb::TM * (C / 8); c += NTH) {
    const int r = c / (C / 8), cc = c % (C / 8) * 8;
    const bool ok = r < nrows;
    cp_async16(gs + r * LDH + cc, a.g + (tl.rows0 + (ok ? r : 0)) * C + cc,
               ok);
  }
  issue_head(0);
  cp_async_commit();

  // A warp's 16 rows: its queries for dq, its keys for dk and dv.
  const int q0 = warp * 16;
  const bool on = q0 < nrows;
  const bool v0 = q0 + g < nrows, v1 = q0 + g + 8 < nrows;
  for (int h = 0; h < H; ++h) {
    if (h + 1 < H) issue_head(h + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    clk(0);
    const bf16* qkv = hbuf(h);
    const bf16* wp = qkv + tb::TM * LDQ;

    // ---- dO_h = g @ Wproj[head rows]^T (bf16) and D = dO . O of the
    // warp's rows, their softmax statistics -------------------------------
    if (on) {
      float acc[4][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < C; kk += 16) {
        unsigned af[4];
        ldsm_x4(af, gs + (q0 + (lane & 15)) * LDH + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          unsigned bf[4];
          tb::ldsm_b_nk(bf, wp, LDW_N, nb * 16, kk);
          mma_bf16(acc[2 * nb], af, bf[0], bf[1]);
          mma_bf16(acc[2 * nb + 1], af, bf[2], bf[3]);
        }
      }
      float dpart[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = q0 + g + 8 * hf, c = j * 8 + 2 * tq;
          const unsigned pk = pack_bf2(acc[j][2 * hf], acc[j][2 * hf + 1]);
          *reinterpret_cast<unsigned*>(dos + r * LDO + c) = pk;
          if (hf ? v1 : v0) {
            const float2 d2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&pk));
            const float2 o2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    a.o + (tl.rows0 + r) * C + h * DHD + c));
            dpart[hf] += d2.x * o2.x + d2.y * o2.y;
          }
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float d = quad_sum(dpart[hf]);
        if (tq == 0) Dst[q0 + g + 8 * hf] = d;
      }
      if (lane < 16) load_stats(a, tl, q0 + lane, h, H, Mst[q0 + lane],
                                Lst[q0 + lane]);
    }
    __syncthreads();
    clk(1);

    // ---- the head's attention: dq of the warp's query rows --------------
    if (on) {
      const ClipSpan sp(q0, a.N, nrows);
      const float m[2] = {Mst[q0 + g], Mst[q0 + g + 8]};
      const float li[2] = {Lst[q0 + g], Lst[q0 + g + 8]};
      const float Dq[2] = {Dst[q0 + g], Dst[q0 + g + 8]};
      QFrag<DHD> qf, df;
      load_q(qf, qkv + q0 * LDQ, LDQ);
      load_q(df, dos + q0 * LDO, LDO);
      float dq[DHD / 8][4] = {};
      attn_bwd_dq<DHD>(dq, 0, qf, df, qkv + DHD, qkv + 2 * DHD, LDQ, sp.beg,
                       sp.end, sp, m, li, Dq);
#pragma unroll
      for (int d = 0; d < DHD / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[d][e] *= a.qscale;
      store_head<DHD>(dq, nullptr, 0, a.dqkv, tl.rows0 + q0, v0, v1, L3W,
                      h * DHD);
    }
    clk(2);

    // ---- dk and dv of the warp's key rows over their clips' queries -----
    if (on) {
      const ClipSpan sp(q0, a.N, nrows);
      QFrag<DHD> kf, vf;
      load_q(kf, qkv + q0 * LDQ + DHD, LDQ);
      load_q(vf, qkv + q0 * LDQ + 2 * DHD, LDQ);
      float dk[DHD / 8][4] = {}, dv[DHD / 8][4] = {};
      attn_bwd_dkdv<DHD>(dk, dv, 0, kf, vf, qkv, LDQ, dos, LDO, sp.beg,
                         sp.end, sp, Mst, Lst, Dst, 1);
      store_head<DHD>(dk, nullptr, 0, a.dqkv, tl.rows0 + q0, v0, v1, L3W,
                      C + h * DHD);
      store_head<DHD>(dv, nullptr, 0, a.dqkv, tl.rows0 + q0, v0, v1, L3W,
                      2 * C + h * DHD);
    }
    __syncthreads();  // every warp is past the head's buffer, dO, D
    clk(3);
  }

  // ---- dx = dqkv @ Wqkv^T over K = 3C: per (segment, head) Wqkv's 32
  // columns (W^T's [256, 32] block, read from W's own rows) with the tile's
  // own dqkv columns, written above (device memory, read back from L2) ----
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const auto issue_dx = [&](int k) {
    if (k < DX_SLICES) {
      bf16* dst = ring + (k % 3) * RING_STAGE;
      const int off = k % 3 * C + k / 3 * DHD;
      for (int c = tid; c < C * 4; c += NTH) {
        const int r = c / 4, cc = c % 4 * 8;
        cp_async16(dst + r * LDW_C + cc, a.wqkv + (size_t)r * L3W + off + cc,
                   true);
      }
      bf16* adst = dst + C * LDW_C;
      for (int c = tid; c < tb::TM * 4; c += NTH) {
        const int r = c / 4, cc = c % 4 * 8;
        const bool ok = r < nrows;
        cp_async16(adst + r * LDW_C + cc,
                   a.dqkv + (tl.rows0 + (ok ? r : 0)) * L3W + off + cc, ok);
      }
    }
    cp_async_commit();
  };
  __threadfence_block();
  __syncthreads();
  issue_dx(0);
  issue_dx(1);
  const int wm = warp >> 2, wn = warp & 3;  // dx: 64 x 64 a warp
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int k = 0; k < DX_SLICES; ++k) {
    cp_async_wait_one();
    __syncthreads();
    issue_dx(k + 2);
    const bf16* w = ring + (k % 3) * RING_STAGE;
    if (wm * 64 < nrows) tb::gemm_wide(w + C * LDW_C, LDW_C, 0, w, wm, wn, acc);
  }
  store_wide(acc, a.dx, tl.rows0, nrows, wm, wn);
  clk(4);
  clk.write(a.stamps);
}

template <bool PROF>
int launch(const Args& a, int C, int D, cudaStream_t s) {
  const int grid = (a.clips + a.cpc - 1) / a.cpc;
  if (C == tb::CW && D == tb::DHD)
    return launch_tile(wide_kernel<PROF>, grid, SMEM_WIDE, a, s);
  if (C == CW && D == 8)
    return launch_tile(narrow_kernel<PROF, 8>, grid, SMEM_NARROW, a, s);
  if (C == CW && D == 16)
    return launch_tile(narrow_kernel<PROF, 16>, grid, SMEM_NARROW, a, s);
  if (C == CW && D == 32)
    return launch_tile(narrow_kernel<PROF, 32>, grid, SMEM_NARROW, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mhb

// The backward's tile program (row 5): one launch of ceil(clips / cpc) CTAs
// of the forward's cpc whole clips each. ptrs: g (dL/d out) [M, C] bf16,
// wqkv [C, 3C], wproj [C, C] (bf16 [in, out]); the forward's saved qkv [M,
// 3C], o [M, C], stat_m, stat_l [clips, H, N]; dx [M, C]; dqkv [M, 3C] (the
// weight launch's operand); the weight launch's counters (ncounters int32,
// zeroed here); stamps (null, or int64 [grid, 5] for the stamped
// instantiation).
extern "C" int pmce_mhsa_bwd_tile(void* const* ptrs, int clips, int N, int C,
                                  int H, int cpc, int ncounters,
                                  void* stream) {
  using namespace mhb;
  if (clips <= 0 || N <= 0 || H <= 0 || C % H || cpc <= 0 ||
      cpc * N > RT || ncounters < 0 || ncounters > NTH)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.g = static_cast<const bf16*>(ptrs[0]);
  a.wqkv = static_cast<const bf16*>(ptrs[1]);
  a.wproj = static_cast<const bf16*>(ptrs[2]);
  a.qkv = static_cast<const bf16*>(ptrs[3]);
  a.o = static_cast<const bf16*>(ptrs[4]);
  a.sm = static_cast<const float*>(ptrs[5]);
  a.sl = static_cast<const float*>(ptrs[6]);
  a.dx = static_cast<bf16*>(ptrs[7]);
  a.dqkv = static_cast<bf16*>(ptrs[8]);
  a.counters = static_cast<int*>(ptrs[9]);
  a.stamps = static_cast<long long*>(ptrs[10]);
  a.ncounters = ncounters;
  a.clips = clips; a.N = N; a.cpc = cpc;
  a.qscale = 1.0f / sqrtf(static_cast<float>(C / H));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.stamps ? launch<true>(a, C, C / H, s) : launch<false>(a, C, C / H, s);
}

// Row 5's weight and bias gradients in one launch after its tile program
// (wgrad.cuh, the launch rows 7, 9 and 11 share): dWqkv = x^T dqkv and
// dWproj = o^T g over K = M rows, dbqkv and dbproj by their column sums
// (the vpartial route); 64 x 64 output tiles at C = 64, 128 x 128 at C =
// 256. ptrs: x, o (the products' X), dqkv, g (their dY), partial ([tiles *
// splits, WT * WT] f32), vpartial ([tiles * splits, WT] f32), counters
// ([tiles] int32, zeroed by the tile program), out (the gradients of wqkv,
// bqkv, wproj, bproj concatenated, f32).
extern "C" int pmce_mhsa_wgrad(void* const* ptrs, int M, int C, int splits,
                               void* stream) {
  if (M <= 0 || splits <= 0 || (C != 64 && C != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  wg::Args<2> a{};
  a.X[0] = static_cast<const bf16*>(ptrs[0]);
  a.X[1] = static_cast<const bf16*>(ptrs[1]);
  a.G[0] = static_cast<const bf16*>(ptrs[2]);
  a.G[1] = static_cast<const bf16*>(ptrs[3]);
  a.partial = static_cast<float*>(ptrs[4]);
  a.vpartial = static_cast<float*>(ptrs[5]);
  a.counters = static_cast<int*>(ptrs[6]);
  a.mat = static_cast<float*>(ptrs[7]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64)
    return wg::launch_wgrad<64>(a, {M, M}, {C, C}, {3 * C, C}, splits, 0, s);
  return wg::launch_wgrad<128>(a, {M, M}, {C, C}, {3 * C, C}, splits, 0, s);
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
