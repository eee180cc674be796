// The GRU recurrence for Hopper (sm_90a): persistent, weight-stationary
// scans, one launch for all T steps: the forward of one or two directions
// (serving and the saving forward of training) and the backward of one
// direction.
//
// Replaces, in pmce_tpu/ops/fused_attention.py:
// - `_gru_scan_kernel` (entries `fused_gru_layer` and `fused_gru_layer_rev`),
//   the Pallas kernel that runs a whole GRU direction over T with the
//   recurrent weights resident in VMEM and an f32 carry:
//   gh = bf16(h) @ Whh + bhh, then torch's gate math (`gru_scan_kernel`);
// - `_gru_scan_save_kernel` (`_fused_gru_layer_fwd`), the same scan that also
//   saves, per step, the f32 entry state h_prev and the gates r, z, n and
//   h_n = W_hn h + b_hn before the reset product (`gru_scan_kernel<., true>`);
// - `_gru_bwd_kernel` (`_fused_gru_layer_bwd`), the reverse-time scan of the
//   backward: dh = g[t] + carry, the gate gradients dgi = [dr, dz, dn] and
//   dgh = [dr, dz, dn*r] in f32, then carry = dh*z + bf16(dgh) @ Whh^T with
//   f32 sums (`gru_bwd_kernel`).
//
// What bounds both on this card: the steps are sequential and each needs
// the whole previous state of its direction. Whh in bf16 is 6 MB a
// direction at H = 1024, too big for one SM but not for the card's shared
// memory. A step at B = 256 is a [256, 1024] x [1024, 3072] product
// (1.6 GFLOP): 16 steps of both directions bound the scan at 0.052 ms of
// tensor-core time, far below a launch per step. What the design pays
// instead is the read of every step's operand by every CTA from L2 (bf16 h,
// 512 KB at B = 256, forward; bf16 dgh, 192 KB at B = 32, backward), one
// grid barrier a step, and the one-time weight load.
//
// Design of the forward (`gru_scan_kernel`): one cooperative launch runs
// every step of both directions. The host's plan (`gru_plan` in
// ops/fused_attention.py) gives each CTA a group of U = 8, 16 or 24 hidden
// units of one direction, one CTA per SM. At kernel start the CTA loads the
// three gate rows {u, H+u, 2H+u} of its units from weight_hh in the
// parameter's own torch layout ([3H, H], any strides, f32 or bf16), rounds
// them to bf16 (the same round-to-nearest as `.to(bfloat16)`) and keeps them
// in shared memory for all T steps, stored in the order the tensor-core
// fragments read them. The f32 carry of its units stays in shared memory
// too. Each step:
// - every warp streams its rows of bf16(h_prev) straight from L2 into
//   registers (`ld.global.cg`: the ping-pong buffer is rewritten by other
//   SMs, and L1 is not coherent), four 32-wide K chunks in flight, and
//   multiplies them by the resident slice with mma.sync m16n8k16 (f32
//   sums). K is permuted inside each 32-wide chunk, the same way for both
//   operands, so that a thread's share of h is one 16-byte load a chunk and
//   of the weights one conflict-free 8-byte load a k16 step; the products
//   go tile by tile so that an accumulator's successive products are far
//   apart in the instruction stream;
// - at small B the warps also split K, and the partial sums meet in shared
//   memory in a fixed order;
// - the epilogue stays in registers: a thread holds the r, z and n columns
//   of the same units, adds bhh and gi[t] (loaded before the product), and
//   writes the f32 carry, ys[t] and bf16(h_next) into the other half of the
//   ping-pong buffer (the saving variant also h_prev, r, z, n and h_n);
// - one grid-wide barrier (release / acquire on a counter in device memory)
//   ends the step.
// Each direction has its own T (a CTA of the shorter one idles through the
// other's last barriers); the reverse direction visits rows T-1 .. 0 of the
// same buffers, no copies. The summation order is fixed, so reruns are
// bit-identical. The saving variant also writes the bf16 rounding of its
// weight slice ([3H, H]) for the backward, which then needs no cast.
//
// Design of the backward (`gru_bwd_kernel`), the same machinery over the
// transposed product: one cooperative launch runs all T steps of one
// direction (the host's `gru_bwd_plan`: U units a CTA, at most one CTA an
// SM). At kernel start a CTA loads the columns of its units, Whh[:, units]
// (3H x U bf16, 48 KB at U = 8), from the bf16 [3H, H] rounding the saving
// scan wrote, into the fragment order. It keeps dh * z of its units (the
// carry's first term, f32) in shared memory. Each step it prefetches the
// saved f32 h_prev, r, z, n, h_n and g[t] of its units into registers,
// waits at the grid barrier, reads the whole bf16(dgh) [B, 3H] of the step
// just done from L2 (`ld.global.cg`, K permuted as the forward's) and
// forms carry[:, units] on the tensor cores (K = 3H split over the warps at
// small B, partial sums added in a fixed order). The epilogue, in
// registers, computes dh = g + carry and the gate gradients of its units
// and writes dgi (f32, or bf16 for the gradient of bf16 projections: the
// bits of the cast), dgh (f32, for the bias gradient's sum) and bf16(dgh)
// for every step: the next step's operand and the weight gradient's, no
// ping-pong and no cast. The backward visits the forward's rows in reverse,
// by row index, no copies; reruns are bit-identical. The earlier backward,
// a launch (and a host call) per step that re-streamed all of Whh^T from L2
// every step, is gone from every path.

#include "common.cuh"

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// The persistent forward scan
// ---------------------------------------------------------------------------

constexpr int SCAN_WARPS = 8;
constexpr int SCAN_THREADS = SCAN_WARPS * 32;
constexpr int SCAN_MT = 2;  // 16-row tiles per warp: 32 rows a "pair"
constexpr int SCAN_KDEPTH = 4;  // 32-wide K chunks of h in flight a warp
constexpr int SCAN_WLOAD = 4;   // weight items in flight a thread at load
// clock64() stamps of the profiled launch, per CTA: weight load, barrier
// wait, exposed h load, product (+ the K-split reduction), epilogue.
constexpr int SCAN_STAGES = 5;

// One direction: gi [T, B, 3H] bf16; w with element (j, k) of the [3H, H]
// parameter at w[j * w_srow + k * w_scol] (f32 if w_f32, else bf16); bhh [3H]
// f32; ys [T, B, H] bf16; hb [2, B, H] bf16 (bf16(h) ping-pong, no
// initial value needed); with SAVE the five f32 [T, B, H] saved states and,
// where w_out is not null, the bf16 [3H, H] rounding of w.
struct ScanDir {
  const bf16* gi;
  const void* w;
  const float* bhh;
  bf16* ys;
  bf16* hb;
  float *s_hprev, *s_r, *s_z, *s_n, *s_hn;
  bf16* w_out;
  long long w_srow, w_scol;
  int T, reverse, w_f32;
};

struct ScanParams {
  ScanDir dir[2];
  int B, H, groups;  // groups of units per direction
  int wm, wk;        // warps over row pairs x warps over K
  int pairs;         // ceil(B / 32)
  unsigned* bar;     // grid-barrier counter, zero at launch
  long long* stamps; // [grid, SCAN_STAGES] or null
};

// Shared memory of one CTA: the weight slice (H * 3U bf16), the carry
// (pairs * 32 rows x U f32) and, when warps split K, the partial sums of
// the warps past the first ((wk - 1) * wm x 3U/8 tiles of 32 x 32 f32).
static long long scan_smem_bytes(int B, int H, int units, int wm, int wk) {
  const long long pairs = (B + 31) / 32;
  return (long long)H * 3 * units * 2 + pairs * 32 * units * 4 +
         (long long)(wk - 1) * wm * (3 * units / 8) * SCAN_MT * 4 * 32 * 4;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// All CTAs of the grid (co-resident: cooperative launch) meet here; the
// writes before it are visible to every CTA after it. A barrier that has
// not filled after ~2^25 polls (seconds; a step takes microseconds) traps,
// so a fault shows as a launch error and never as a hung card.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    for (unsigned polls = 0; ld_acquire_gpu(bar) < target; ++polls) {
      if (polls == (1u << 25)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ long long stamp_after(unsigned dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t) : "r"(dep) : "memory");
  return t;
}

template <int NTU, bool SAVE>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
    gru_scan_kernel(const ScanParams p) {
  constexpr int U = 8 * NTU, NT = 3 * NTU;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = blockIdx.x / p.groups;
  const ScanDir dp = d == 0 ? p.dir[0] : p.dir[1];
  const int H = p.H, B = p.B, H3 = 3 * H, NK = H / 32;
  const int u0 = (blockIdx.x % p.groups) * U;
  // wf[kc][s][nt][lane]: for K chunk kc, its k16 step s and n-tile nt
  // (gate nt / NTU, units (nt % NTU) * 8 + 0..7), lane (g, c) holds the 4
  // bf16 of unit row g at k = 32 kc + 8 c + 4 s .. + 3: the B operand of
  // the step, one conflict-free 8-byte load.
  uint2* wf = reinterpret_cast<uint2*>(smem);
  float* carry = reinterpret_cast<float*>(smem + (size_t)H * 3 * U * 2);
  float* part = carry + (size_t)p.pairs * 32 * U;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp % p.wm, wk = warp / p.wm;
  const bool busy = wk < p.wk;
  const int kspan = NK / p.wk, kb = wk * kspan, ke = kb + kspan;
  const bool prof = p.stamps != nullptr && threadIdx.x == 0;
  long long acc_t[SCAN_STAGES] = {0, 0, 0, 0, 0};
  long long t0 = clock64();

  // The weight slice, SCAN_WLOAD items of 8 values a thread in flight (one
  // or two 16-byte loads each where the parameter's rows are contiguous).
  const bool wvec =
      dp.w_scol == 1 && (dp.w_srow * (dp.w_f32 ? 4 : 2)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dp.w) % 16 == 0;
  for (int it0 = threadIdx.x; it0 < NK * NT * 32;
       it0 += SCAN_WLOAD * SCAN_THREADS) {
    float f[SCAN_WLOAD][8];
#pragma unroll
    for (int q = 0; q < SCAN_WLOAD; ++q) {
      const int it = it0 + q * SCAN_THREADS;
      const int l = it & 31, nt = (it >> 5) % NT, kc = (it >> 5) / NT;
      const int u = u0 + (nt % NTU) * 8 + (l >> 2);
      const long long base = (long long)((nt / NTU) * H + u) * dp.w_srow +
                             (long long)(kc * 32 + 8 * (l & 3)) * dp.w_scol;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[q][e] = 0.f;
      if (it >= NK * NT * 32 || u >= H) continue;
      if (wvec && dp.w_f32) {
        const float4* src = reinterpret_cast<const float4*>(
            static_cast<const float*>(dp.w) + base);
        const float4 x = __ldg(src), y = __ldg(src + 1);
        f[q][0] = x.x, f[q][1] = x.y, f[q][2] = x.z, f[q][3] = x.w;
        f[q][4] = y.x, f[q][5] = y.y, f[q][6] = y.z, f[q][7] = y.w;
      } else if (wvec) {
        load8(static_cast<const bf16*>(dp.w) + base, f[q]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const long long o = base + e * dp.w_scol;
          f[q][e] = dp.w_f32 ? static_cast<const float*>(dp.w)[o]
                             : bf2f(static_cast<const bf16*>(dp.w)[o]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < SCAN_WLOAD; ++q) {
      const int it = it0 + q * SCAN_THREADS;
      if (it >= NK * NT * 32) break;
      const int l = it & 31, nt = (it >> 5) % NT, kc = (it >> 5) / NT;
      const int u = u0 + (nt % NTU) * 8 + (l >> 2);
      const uint4 v = make_uint4(pack_bf2(f[q][0], f[q][1]),
                                 pack_bf2(f[q][2], f[q][3]),
                                 pack_bf2(f[q][4], f[q][5]),
                                 pack_bf2(f[q][6], f[q][7]));
      if (SAVE && dp.w_out != nullptr && u < H)
        *reinterpret_cast<uint4*>(dp.w_out + (size_t)((nt / NTU) * H + u) * H +
                                  kc * 32 + 8 * (l & 3)) = v;
      uint2* dst = wf + (size_t)kc * 2 * NT * 32 + nt * 32 + l;
      dst[0] = make_uint2(v.x, v.y);
      dst[NT * 32] = make_uint2(v.z, v.w);
    }
  }
  for (int i = threadIdx.x; i < p.pairs * 32 * U; i += SCAN_THREADS)
    carry[i] = 0.f;
  // This thread's bhh: gate q, unit (jj * 8 + 2c + e).
  float bh[3][NTU][2];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int jj = 0; jj < NTU; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = u0 + jj * 8 + 2 * c + e;
        bh[q][jj][e] = u < H ? dp.bhh[q * H + u] : 0.f;
      }
  __syncthreads();
  if (prof) acc_t[0] += clock64() - t0;

  const int Tmax = max(p.dir[0].T, p.dir[1].T);
  const int rounds = (p.pairs + p.wm - 1) / p.wm;
  for (int s = 0; s < Tmax; ++s) {
    if (s > 0) {
      if (prof) t0 = clock64();
      grid_barrier(p.bar, gridDim.x * (unsigned)s);
      if (prof) acc_t[1] += clock64() - t0;
    }
    if (s >= dp.T) continue;
    const int t = dp.reverse ? dp.T - 1 - s : s;
    const bf16* hin = dp.hb + (size_t)((s + 1) & 1) * B * H;
    bf16* hout = dp.hb + (size_t)(s & 1) * B * H;
    const bf16* gi_t = dp.gi + (size_t)t * B * H3;
    for (int rd = 0; rd < rounds; ++rd) {
      if (prof) t0 = clock64();
      const int pair = rd * p.wm + wm;
      const bool mine = busy && pair < p.pairs;
      const bool lead = mine && wk == 0;
      const int row0 = pair * 32;
      float acc[SCAN_MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
      // gi[t] of this thread's epilogue elements, loaded before the product.
      unsigned gv[SCAN_MT][2][3][NTU];
#pragma unroll
      for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + mt * 16 + hh * 8 + g;
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int jj = 0; jj < NTU; ++jj) {
              const int u = u0 + jj * 8 + 2 * c;
              gv[mt][hh][q][jj] =
                  lead && row < B && u < H
                      ? __ldg(reinterpret_cast<const unsigned*>(
                            gi_t + (size_t)row * H3 + q * H + u))
                      : 0u;
            }
        }
      // Step 0 starts from h = 0: its product is zero.
      if (mine && s > 0) {
        const uint4* ap[SCAN_MT][2];
        bool ok[SCAN_MT][2];
#pragma unroll
        for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + mt * 16 + hh * 8 + g;
            ok[mt][hh] = row < B;
            ap[mt][hh] = reinterpret_cast<const uint4*>(
                hin + (size_t)(ok[mt][hh] ? row : 0) * H + 8 * c);
          }
        uint4 a[SCAN_KDEPTH][SCAN_MT][2];
        auto load = [&](int st, int kc) {
#pragma unroll
          for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              a[st][mt][hh] = ok[mt][hh] ? __ldcg(ap[mt][hh] + kc * 4)
                                         : make_uint4(0, 0, 0, 0);
        };
#pragma unroll
        for (int st = 0; st < SCAN_KDEPTH; ++st)
          if (kb + st < ke) load(st, kb + st);
        if (prof) {
          const long long t1 = stamp_after(a[0][0][0].x ^ a[0][1][1].w);
          acc_t[2] += t1 - t0;
          t0 = t1;
        }
        // Both k16 steps of a chunk over every tile in turn, so that an
        // accumulator's two products are 2 * NT mma apart (the mma helper is
        // volatile asm, kept in source order).
        for (int kc = kb; kc < ke; kc += SCAN_KDEPTH) {
#pragma unroll
          for (int st = 0; st < SCAN_KDEPTH; ++st) {
            if (kc + st >= ke) break;
#pragma unroll
            for (int s16 = 0; s16 < 2; ++s16) {
              const uint2* wrow =
                  wf + (size_t)((kc + st) * 2 + s16) * NT * 32 + lane;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const uint2 b = wrow[nt * 32];
#pragma unroll
                for (int mt = 0; mt < SCAN_MT; ++mt) {
                  const uint4 lo = a[st][mt][0], hi = a[st][mt][1];
                  const unsigned af[4] = {s16 ? lo.z : lo.x, s16 ? hi.z : hi.x,
                                          s16 ? lo.w : lo.y,
                                          s16 ? hi.w : hi.y};
                  mma_bf16(acc[mt][nt], af, b.x, b.y);
                }
              }
            }
            if (kc + st + SCAN_KDEPTH < ke) load(st, kc + st + SCAN_KDEPTH);
          }
        }
      }
      if (p.wk > 1) {
        // The K split's partial sums meet in a fixed order.
        float* mypart =
            part + (size_t)((wk - 1) * p.wm + wm) * SCAN_MT * NT * 4 * 32;
        if (mine && wk > 0) {
#pragma unroll
          for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                mypart[((mt * NT + nt) * 4 + q) * 32 + lane] = acc[mt][nt][q];
        }
        __syncthreads();
        if (lead) {
          for (int w = 1; w < p.wk; ++w) {
            const float* src =
                part + (size_t)((w - 1) * p.wm + wm) * SCAN_MT * NT * 4 * 32;
#pragma unroll
            for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  acc[mt][nt][q] += src[((mt * NT + nt) * 4 + q) * 32 + lane];
          }
        }
      }
      if (prof) {
        const long long t1 = clock64();
        acc_t[3] += t1 - t0;
        t0 = t1;
      }
      if (lead) {
#pragma unroll
        for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int lrow = mt * 16 + hh * 8 + g, row = row0 + lrow;
            if (row >= B) continue;
#pragma unroll
            for (int jj = 0; jj < NTU; ++jj) {
              const int i = jj * 8 + 2 * c, u = u0 + i;
              if (u >= H) continue;
              float hnew[2], hp[2], rg[2], zg[2], ng[2], hn[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float gr = acc[mt][jj][hh * 2 + e] + bh[0][jj][e];
                const float gz = acc[mt][NTU + jj][hh * 2 + e] + bh[1][jj][e];
                hn[e] = acc[mt][2 * NTU + jj][hh * 2 + e] + bh[2][jj][e];
                const float ir = __uint_as_float(
                    e ? gv[mt][hh][0][jj] & 0xffff0000u
                      : gv[mt][hh][0][jj] << 16);
                const float iz = __uint_as_float(
                    e ? gv[mt][hh][1][jj] & 0xffff0000u
                      : gv[mt][hh][1][jj] << 16);
                const float in = __uint_as_float(
                    e ? gv[mt][hh][2][jj] & 0xffff0000u
                      : gv[mt][hh][2][jj] << 16);
                rg[e] = sigmoid_f32(ir + gr);
                zg[e] = sigmoid_f32(iz + gz);
                ng[e] = tanhf(in + rg[e] * hn[e]);
                hp[e] = carry[(size_t)(pair * 32 + lrow) * U + i + e];
                hnew[e] = (1.0f - zg[e]) * ng[e] + zg[e] * hp[e];
                carry[(size_t)(pair * 32 + lrow) * U + i + e] = hnew[e];
              }
              const unsigned hb2 = pack_bf2(hnew[0], hnew[1]);
              const size_t o = (size_t)row * H + u;
              *reinterpret_cast<unsigned*>(hout + o) = hb2;
              *reinterpret_cast<unsigned*>(dp.ys + (size_t)t * B * H + o) =
                  hb2;
              if constexpr (SAVE) {
                // h_n is saved before the reset product: the backward's dr
                // reads it.
                const size_t so = (size_t)t * B * H + o;
                *reinterpret_cast<float2*>(dp.s_hprev + so) =
                    make_float2(hp[0], hp[1]);
                *reinterpret_cast<float2*>(dp.s_r + so) =
                    make_float2(rg[0], rg[1]);
                *reinterpret_cast<float2*>(dp.s_z + so) =
                    make_float2(zg[0], zg[1]);
                *reinterpret_cast<float2*>(dp.s_n + so) =
                    make_float2(ng[0], ng[1]);
                *reinterpret_cast<float2*>(dp.s_hn + so) =
                    make_float2(hn[0], hn[1]);
              }
            }
          }
      }
      if (p.wk > 1) __syncthreads();
      if (prof) acc_t[4] += clock64() - t0;
    }
  }
  if (prof) {
    for (int i = 0; i < SCAN_STAGES; ++i)
      p.stamps[(size_t)blockIdx.x * SCAN_STAGES + i] = acc_t[i];
  }
}

// ---------------------------------------------------------------------------
// The persistent backward scan
// ---------------------------------------------------------------------------

// clock64() stamps of the profiled backward launch, per CTA: weight load,
// saved-state prefetch, barrier wait, exposed bf16(dgh) load, product (+
// the K-split reduction), epilogue.
constexpr int BWD_STAGES = 6;

// One direction: g = dL/dys [T, B, H] bf16; the saving scan's f32 state
// [T, B, H] (h_prev, r, z, n, h_n); w the bf16 [3H, H] rounding of the
// parameter (row j, column k at w[j * H + k]); dgi [T, B, 3H] (f32, or
// bf16 where dgi_bf16), dgh [T, B, 3H] f32 and dghb = bf16(dgh), which is
// also the next step's matrix operand. `reverse` is the forward scan's.
struct BwdParams {
  const bf16* g;
  const float *hprev, *r, *z, *n, *hn;
  const bf16* w;
  void* dgi;
  float* dgh;
  bf16* dghb;
  int T, reverse, dgi_bf16;
  int B, H, wm, wk, pairs;
  unsigned* bar;      // grid-barrier counter, zero at launch
  long long* stamps;  // [grid, BWD_STAGES] or null
};

// Shared memory of one backward CTA: the weight slice Whh[:, units] (3H x U
// bf16), dh * z of its units for every 32-row pair (f32: the carry's first
// term) and the K split's partial sums ((wk - 1) * wm pairs of U/8 tiles).
static long long bwd_smem_bytes(int B, int H, int units, int wm, int wk) {
  const long long pairs = (B + 31) / 32;
  return (long long)3 * H * units * 2 + pairs * 32 * units * 4 +
         (long long)(wk - 1) * wm * (units / 8) * SCAN_MT * 4 * 32 * 4;
}

template <int NTU>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
    gru_bwd_kernel(const BwdParams p) {
  constexpr int U = 8 * NTU;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, B = p.B, H3 = 3 * H, NK = H3 / 32;
  const int u0 = blockIdx.x * U;
  // wf[kc][s][nt][lane]: for K chunk kc (32 rows j of Whh), its k16 step s
  // and unit tile nt, lane (g, c) holds the 4 bf16 Whh[j, u0 + 8 nt + g],
  // j = 32 kc + 8 c + 4 s .. + 3: the B operand, permuted in K as the
  // forward's (one 16-byte load of a bf16(dgh) row covers a chunk).
  uint2* wf = reinterpret_cast<uint2*>(smem);
  float* cz = reinterpret_cast<float*>(smem + (size_t)H3 * U * 2);
  float* part = cz + (size_t)p.pairs * 32 * U;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp % p.wm, wk = warp / p.wm;
  const bool busy = wk < p.wk;
  const int kspan = NK / p.wk, kb = wk * kspan, ke = kb + kspan;
  const bool prof = p.stamps != nullptr && threadIdx.x == 0;
  long long acc_t[BWD_STAGES] = {0, 0, 0, 0, 0, 0};
  long long t0 = clock64();

  // The slice: row j of Whh over the tile's 8 units is one 16-byte load,
  // scattered into the fragment order (one time; SCAN_WLOAD in flight).
  const int items = H3 * NTU;
  for (int it0 = threadIdx.x; it0 < items; it0 += SCAN_WLOAD * SCAN_THREADS) {
    uint4 v[SCAN_WLOAD];
#pragma unroll
    for (int q = 0; q < SCAN_WLOAD; ++q) {
      const int it = it0 + q * SCAN_THREADS;
      const int j = it / NTU, ub = u0 + (it % NTU) * 8;
      v[q] = it < items && ub < H
                 ? __ldg(reinterpret_cast<const uint4*>(p.w + (size_t)j * H +
                                                        ub))
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < SCAN_WLOAD; ++q) {
      const int it = it0 + q * SCAN_THREADS;
      if (it >= items) break;
      const int j = it / NTU, nt = it % NTU;
      const int kc = j >> 5, kr = j & 31;
      const int cc = kr >> 3, s16 = (kr >> 2) & 1, e = kr & 3;
      const unsigned short* vals =
          reinterpret_cast<const unsigned short*>(&v[q]);
      unsigned short* dst = reinterpret_cast<unsigned short*>(
          wf + ((size_t)(kc * 2 + s16) * NTU + nt) * 32);
#pragma unroll
      for (int gg = 0; gg < 8; ++gg) dst[(gg * 4 + cc) * 4 + e] = vals[gg];
    }
  }
  for (int i = threadIdx.x; i < p.pairs * 32 * U; i += SCAN_THREADS)
    cz[i] = 0.f;
  __syncthreads();
  if (prof) acc_t[0] += clock64() - t0;

  const size_t plane = (size_t)B * H, plane3 = (size_t)B * H3;
  const int rounds = (p.pairs + p.wm - 1) / p.wm;
  for (int s = 0; s < p.T; ++s) {
    // The backward visits the forward's rows in reverse order.
    const int t = p.reverse ? s : p.T - 1 - s;
    const int tprev = p.reverse ? s - 1 : p.T - s;
    for (int rd = 0; rd < rounds; ++rd) {
      if (prof) t0 = clock64();
      const int pair = rd * p.wm + wm;
      const bool mine = busy && pair < p.pairs;
      const bool lead = mine && wk == 0;
      const int row0 = pair * 32;
      // This thread's saved state at row t, loaded before the barrier:
      // g, h_prev, r, z, n, h_n of its two rows of each tile and its two
      // units of each unit tile.
      unsigned sg[SCAN_MT][2][NTU];
      float2 sv[5][SCAN_MT][2][NTU];
#pragma unroll
      for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + mt * 16 + hh * 8 + g;
#pragma unroll
          for (int jj = 0; jj < NTU; ++jj) {
            const int u = u0 + jj * 8 + 2 * c;
            const bool ok = lead && row < B && u < H;
            const size_t o = (size_t)t * plane + (size_t)row * H + u;
            sg[mt][hh][jj] =
                ok ? __ldg(reinterpret_cast<const unsigned*>(p.g + o)) : 0u;
            const float* src[5] = {p.hprev, p.r, p.z, p.n, p.hn};
#pragma unroll
            for (int k = 0; k < 5; ++k)
              sv[k][mt][hh][jj] =
                  ok ? __ldg(reinterpret_cast<const float2*>(src[k] + o))
                     : make_float2(0.f, 0.f);
          }
        }
      if (prof) {
        const long long t1 = clock64();
        acc_t[1] += t1 - t0;
        t0 = t1;
      }
      if (rd == 0 && s > 0) {
        grid_barrier(p.bar, gridDim.x * (unsigned)s);
        if (prof) {
          const long long t1 = clock64();
          acc_t[2] += t1 - t0;
          t0 = t1;
        }
      }
      float acc[SCAN_MT][NTU][4];
#pragma unroll
      for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTU; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
      // The first step has no carry: its product is not formed.
      if (mine && s > 0) {
        const bf16* a_t = p.dghb + (size_t)tprev * plane3;
        const uint4* ap[SCAN_MT][2];
        bool ok[SCAN_MT][2];
#pragma unroll
        for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + mt * 16 + hh * 8 + g;
            ok[mt][hh] = row < B;
            ap[mt][hh] = reinterpret_cast<const uint4*>(
                a_t + (size_t)(ok[mt][hh] ? row : 0) * H3 + 8 * c);
          }
        uint4 a[SCAN_KDEPTH][SCAN_MT][2];
        auto load = [&](int st, int kc) {
#pragma unroll
          for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              a[st][mt][hh] = ok[mt][hh] ? __ldcg(ap[mt][hh] + kc * 4)
                                         : make_uint4(0, 0, 0, 0);
        };
#pragma unroll
        for (int st = 0; st < SCAN_KDEPTH; ++st)
          if (kb + st < ke) load(st, kb + st);
        if (prof) {
          const long long t1 = stamp_after(a[0][0][0].x ^ a[0][1][1].w);
          acc_t[3] += t1 - t0;
          t0 = t1;
        }
        for (int kc = kb; kc < ke; kc += SCAN_KDEPTH) {
#pragma unroll
          for (int st = 0; st < SCAN_KDEPTH; ++st) {
            if (kc + st >= ke) break;
#pragma unroll
            for (int s16 = 0; s16 < 2; ++s16) {
              const uint2* wrow =
                  wf + (size_t)((kc + st) * 2 + s16) * NTU * 32 + lane;
#pragma unroll
              for (int nt = 0; nt < NTU; ++nt) {
                const uint2 b = wrow[nt * 32];
#pragma unroll
                for (int mt = 0; mt < SCAN_MT; ++mt) {
                  const uint4 lo = a[st][mt][0], hi = a[st][mt][1];
                  const unsigned af[4] = {s16 ? lo.z : lo.x, s16 ? hi.z : hi.x,
                                          s16 ? lo.w : lo.y,
                                          s16 ? hi.w : hi.y};
                  mma_bf16(acc[mt][nt], af, b.x, b.y);
                }
              }
            }
            if (kc + st + SCAN_KDEPTH < ke) load(st, kc + st + SCAN_KDEPTH);
          }
        }
      }
      if (p.wk > 1) {
        // The K split's partial sums meet in a fixed order.
        float* mypart =
            part + (size_t)((wk - 1) * p.wm + wm) * SCAN_MT * NTU * 4 * 32;
        if (mine && wk > 0 && s > 0) {
#pragma unroll
          for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NTU; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                mypart[((mt * NTU + nt) * 4 + q) * 32 + lane] = acc[mt][nt][q];
        }
        __syncthreads();
        if (lead && s > 0) {
          for (int w = 1; w < p.wk; ++w) {
            const float* src =
                part + (size_t)((w - 1) * p.wm + wm) * SCAN_MT * NTU * 4 * 32;
#pragma unroll
            for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < NTU; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  acc[mt][nt][q] += src[((mt * NTU + nt) * 4 + q) * 32 + lane];
          }
        }
      }
      if (prof) {
        const long long t1 = clock64();
        acc_t[4] += t1 - t0;
        t0 = t1;
      }
      if (lead) {
        // dh = g + carry, carry = dh' * z' + bf16(dgh') @ Whh^T of the step
        // just done; then the gate gradients in the order of operations of
        // `_gru_bwd_kernel` (fused_attention.py:2462-2467).
#pragma unroll
        for (int mt = 0; mt < SCAN_MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int lrow = mt * 16 + hh * 8 + g, row = row0 + lrow;
            if (row >= B) continue;
#pragma unroll
            for (int jj = 0; jj < NTU; ++jj) {
              const int i = jj * 8 + 2 * c, u = u0 + i;
              if (u >= H) continue;
              float* czp = cz + (size_t)(pair * 32 + lrow) * U + i;
              const unsigned gb = sg[mt][hh][jj];
              const float gv[2] = {__uint_as_float(gb << 16),
                                   __uint_as_float(gb & 0xffff0000u)};
              const float2 hp2 = sv[0][mt][hh][jj], r2 = sv[1][mt][hh][jj];
              const float2 z2 = sv[2][mt][hh][jj], n2 = sv[3][mt][hh][jj];
              const float2 hn2 = sv[4][mt][hh][jj];
              const float hp[2] = {hp2.x, hp2.y}, rg[2] = {r2.x, r2.y};
              const float zg[2] = {z2.x, z2.y}, ng[2] = {n2.x, n2.y};
              const float hn[2] = {hn2.x, hn2.y};
              float dr[2], dzp[2], dn[2], dnr[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float carry =
                    s > 0 ? czp[e] + acc[mt][jj][hh * 2 + e] : 0.f;
                const float dh = gv[e] + carry;
                const float dz = dh * (hp[e] - ng[e]);
                dn[e] = (dh * (1.0f - zg[e])) * (1.0f - ng[e] * ng[e]);
                dr[e] = (dn[e] * hn[e]) * (rg[e] * (1.0f - rg[e]));
                dzp[e] = dz * (zg[e] * (1.0f - zg[e]));
                dnr[e] = dn[e] * rg[e];
                czp[e] = dh * zg[e];
              }
              const size_t o3 = (size_t)t * plane3 + (size_t)row * H3 + u;
              const float q0[3][2] = {{dr[0], dr[1]}, {dzp[0], dzp[1]},
                                      {dn[0], dn[1]}};
              const float q1[3][2] = {{dr[0], dr[1]}, {dzp[0], dzp[1]},
                                      {dnr[0], dnr[1]}};
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                const size_t o = o3 + (size_t)q * H;
                if (p.dgi_bf16)
                  *reinterpret_cast<unsigned*>(static_cast<bf16*>(p.dgi) + o) =
                      pack_bf2(q0[q][0], q0[q][1]);
                else
                  *reinterpret_cast<float2*>(static_cast<float*>(p.dgi) + o) =
                      make_float2(q0[q][0], q0[q][1]);
                *reinterpret_cast<float2*>(p.dgh + o) =
                    make_float2(q1[q][0], q1[q][1]);
                *reinterpret_cast<unsigned*>(p.dghb + o) =
                    pack_bf2(q1[q][0], q1[q][1]);
              }
            }
          }
      }
      if (p.wk > 1) __syncthreads();
      if (prof) acc_t[5] += clock64() - t0;
    }
  }
  if (prof) {
    for (int i = 0; i < BWD_STAGES; ++i)
      p.stamps[(size_t)blockIdx.x * BWD_STAGES + i] = acc_t[i];
  }
}

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

// The card's SM count and the shared memory a block may opt in to, for
// the host's plan.
extern "C" int pmce_gru_device_limits(int device, int* sm_count,
                                      int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(
      sm_count, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  return static_cast<int>(e);
}

template <int NTU, bool SAVE>
static cudaError_t launch_scan(const ScanParams& p, int grid, long long smem,
                               cudaStream_t stream) {
  auto kernel = gru_scan_kernel<NTU, SAVE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<ScanParams*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(SCAN_THREADS), args,
                                     static_cast<size_t>(smem), stream);
}

// ptrs: per direction gi, w, bhh, ys, hb, s_hprev, s_r, s_z, s_n, s_hn,
// w_out (the last six null unless save); ints: per direction T, reverse,
// w_f32, w_srow, w_scol. The plan (units, wm, wk, smem) comes from the
// host's `gru_plan`; the launch refuses a plan whose shared memory is not
// this file's layout, and a grid that cannot be co-resident fails with
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int pmce_gru_scan(void* const* ptrs, const long long* ints,
                             int dirs, int B, int H, int units, int wm,
                             int wk, int save, long long smem, void* bar,
                             void* stamps, void* stream) {
  if (dirs < 1 || dirs > 2 || B <= 0 || H <= 0 || H % 64 != 0 ||
      (units != 8 && units != 16 && units != 24) || wm < 1 || wk < 1 ||
      wm * wk > SCAN_WARPS || (H / 64) % wk != 0 ||
      smem != scan_smem_bytes(B, H, units, wm, wk))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanParams p{};
  for (int d = 0; d < dirs; ++d) {
    void* const* q = ptrs + 11 * d;
    const long long* n = ints + 5 * d;
    p.dir[d] = ScanDir{static_cast<const bf16*>(q[0]), q[1],
                       static_cast<const float*>(q[2]),
                       static_cast<bf16*>(q[3]), static_cast<bf16*>(q[4]),
                       static_cast<float*>(q[5]), static_cast<float*>(q[6]),
                       static_cast<float*>(q[7]), static_cast<float*>(q[8]),
                       static_cast<float*>(q[9]), static_cast<bf16*>(q[10]),
                       n[3], n[4], static_cast<int>(n[0]),
                       static_cast<int>(n[1]), static_cast<int>(n[2])};
  }
  p.B = B;
  p.H = H;
  p.groups = (H + units - 1) / units;
  p.wm = wm;
  p.wk = wk;
  p.pairs = (B + 31) / 32;
  p.bar = static_cast<unsigned*>(bar);
  p.stamps = static_cast<long long*>(stamps);
  const int grid = dirs * p.groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (units * 2 + (save ? 1 : 0)) {
    case 16: e = launch_scan<1, false>(p, grid, smem, s); break;
    case 17: e = launch_scan<1, true>(p, grid, smem, s); break;
    case 32: e = launch_scan<2, false>(p, grid, smem, s); break;
    case 33: e = launch_scan<2, true>(p, grid, smem, s); break;
    case 48: e = launch_scan<3, false>(p, grid, smem, s); break;
    default: e = launch_scan<3, true>(p, grid, smem, s); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int NTU>
static cudaError_t launch_bwd(const BwdParams& p, int grid, long long smem,
                              cudaStream_t stream) {
  auto kernel = gru_bwd_kernel<NTU>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<BwdParams*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(SCAN_THREADS), args,
                                     static_cast<size_t>(smem), stream);
}

// The whole backward scan of one direction in one cooperative launch.
// ptrs: g, h_prev, r, z, n, h_n, w (bf16 [3H, H]), dgi, dgh, dghb. The plan
// (units, wm, wk, smem) comes from the host's `gru_bwd_plan`; the launch
// refuses a plan whose shared memory is not this file's layout, and a grid
// that cannot be co-resident fails with cudaErrorCooperativeLaunchTooLarge.
extern "C" int pmce_gru_bwd_scan(void* const* ptrs, int T, int reverse,
                                 int dgi_bf16, int B, int H, int units,
                                 int wm, int wk, long long smem, void* bar,
                                 void* stamps, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % 64 != 0 ||
      (units != 8 && units != 16 && units != 24) || wm < 1 || wk < 1 ||
      wm * wk > SCAN_WARPS || (3 * H / 32) % wk != 0 ||
      smem != bwd_smem_bytes(B, H, units, wm, wk))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  p.g = static_cast<const bf16*>(ptrs[0]);
  p.hprev = static_cast<const float*>(ptrs[1]);
  p.r = static_cast<const float*>(ptrs[2]);
  p.z = static_cast<const float*>(ptrs[3]);
  p.n = static_cast<const float*>(ptrs[4]);
  p.hn = static_cast<const float*>(ptrs[5]);
  p.w = static_cast<const bf16*>(ptrs[6]);
  p.dgi = ptrs[7];
  p.dgh = static_cast<float*>(ptrs[8]);
  p.dghb = static_cast<bf16*>(ptrs[9]);
  p.T = T;
  p.reverse = reverse;
  p.dgi_bf16 = dgi_bf16;
  p.B = B;
  p.H = H;
  p.wm = wm;
  p.wk = wk;
  p.pairs = (B + 31) / 32;
  p.bar = static_cast<unsigned*>(bar);
  p.stamps = static_cast<long long*>(stamps);
  const int grid = (H + units - 1) / units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (units) {
    case 8: e = launch_bwd<1>(p, grid, smem, s); break;
    case 16: e = launch_bwd<2>(p, grid, smem, s); break;
    default: e = launch_bwd<3>(p, grid, smem, s); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_gru_error_string)
