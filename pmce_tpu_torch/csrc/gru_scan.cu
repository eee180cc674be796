// The GRU recurrence for Hopper (sm_90a): a persistent, weight-stationary
// scan of one or two directions in one launch (serving and the saving
// forward of training), and the per-step launches of its backward.
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
//   f32 sums (`gru_bwd_first_kernel`, `gru_bwd_step_kernel`).
//
// What bounds the forward on this card: the steps are sequential and each
// needs the whole previous state of its direction. Whh in bf16 is 6 MB a
// direction at H = 1024, too big for one SM but not for the card's shared
// memory. A step at B = 256 is a [256, 1024] x [1024, 3072] product
// (1.6 GFLOP): 16 steps of both directions bound the scan at 0.052 ms of
// tensor-core time, far below a launch per step. What the design pays
// instead is the read of every step's h (512 KB at B = 256) by every CTA
// from L2, one grid barrier a step, and the one-time weight load.
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
// The backward stays one launch per step: each block owns 16 batch rows and
// 16 hidden units and runs column u of bf16(dgh_t) @ Whh^T over K = 3H on
// the tensor cores (WMMA, Whh^T read from the bf16 [3H, H] rounding the
// saving forward wrote), the carry, and then the gate gradients of the step
// the backward visits next for the same units; one gate-only launch starts
// it.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

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
// The backward: one launch per step
// ---------------------------------------------------------------------------

constexpr int KSPLIT = 4;  // warps per backward block, each one quarter of K

// What the backward reads at one step: g = dL/dys[t] (bf16 [B, H]) and the
// forward's saved state of that step.
struct StepState {
  const bf16* g;
  const float *hprev, *r, *z, *n, *hn;
};

// What it writes at one step: dgi and dgh (f32 [B, 3H]) and dgh rounded to
// bf16 (the next launch's matrix operand, [Bp, 3H], rows >= B zero).
struct StepGrads {
  float *dgi, *dgh;
  bf16* dghb;
};

// The gate gradients at (row, u) given dh = dL/dh_t, in the order of
// operations of `_gru_bwd_kernel` (fused_attention.py:2462-2467).
__device__ __forceinline__ void gate_grads(float dh, int row, int u, int H,
                                           const StepState& s,
                                           const StepGrads& d) {
  const size_t o = (size_t)row * H + u;
  const float hp = s.hprev[o], r = s.r[o], z = s.z[o], n = s.n[o];
  const float hn = s.hn[o];
  const float dz = dh * (hp - n);
  const float dn = (dh * (1.0f - z)) * (1.0f - n * n);
  const float dr = (dn * hn) * (r * (1.0f - r));
  const float dzp = dz * (z * (1.0f - z));
  const float dnr = dn * r;
  const size_t o3 = (size_t)row * 3 * H + u;
  d.dgi[o3] = dr;
  d.dgi[o3 + H] = dzp;
  d.dgi[o3 + 2 * H] = dn;
  d.dgh[o3] = dr;
  d.dgh[o3 + H] = dzp;
  d.dgh[o3 + 2 * H] = dnr;
  d.dghb[o3] = f2bf(dr);
  d.dghb[o3 + H] = f2bf(dzp);
  d.dghb[o3 + 2 * H] = f2bf(dnr);
}

// The first step of the backward (the forward's last): no carry yet, so
// dh = g; writes dh [B, H] f32 for the next launch.
__global__ void gru_bwd_first_kernel(StepState s, StepGrads d, float* dh,
                                     int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const float v = bf2f(s.g[i]);
  dh[i] = v;
  gate_grads(v, i / H, i % H, H, s, d);
}

// One later step. In: dghb_t = bf16(dgh) of the step just done (all units),
// wb the bf16 [3H, H] Whh (Whh^T as a row-major [K = 3H, N = H] matrix), z_t
// its saved z, dh its dL/dh. The block's 16 x 16 tile of carry = dh * z +
// dghb_t @ Whh^T becomes dL/dh of the step visited next (dh = g + carry, in
// place), whose gate gradients `nx` / `dnx` it writes.
__global__ void __launch_bounds__(KSPLIT * 32)
    gru_bwd_step_kernel(const bf16* dghb_t, const bf16* wb,
                        const float* z_t, float* dh, StepState nx,
                        StepGrads dnx, int B, int H) {
  __shared__ __align__(32) float part[KSPLIT][16 * 16];
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * 16, r0 = blockIdx.y * 16;
  const int H3 = 3 * H;
  const int kspan = H3 / KSPLIT, k_begin = warp * kspan;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
  for (int k = k_begin; k < k_begin + kspan; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, dghb_t + (size_t)r0 * H3 + k, H3);
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w;
    wmma::load_matrix_sync(w, wb + (size_t)k * H + u0, H);
    wmma::mma_sync(acc, a, w, acc);
  }
  wmma::store_matrix_sync(part[warp], acc, 16, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < 256; e += KSPLIT * 32) {
    const int r = r0 + e / 16, u = u0 + e % 16;
    if (r >= B) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < KSPLIT; ++w) sum += part[w][e];
    const size_t o = (size_t)r * H + u;
    const float carry = dh[o] * z_t[o] + sum;
    const float dhn = bf2f(nx.g[o]) + carry;
    dh[o] = dhn;
    gate_grads(dhn, r, u, H, nx, dnx);
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

extern "C" int pmce_gru_bwd_first(const void* g, const float* hprev,
                                  const float* r, const float* z,
                                  const float* n, const float* hn,
                                  float* dgi, float* dgh, void* dghb,
                                  float* dh, int B, int H, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256, blocks = (B * H + threads - 1) / threads;
  gru_bwd_first_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      StepState{static_cast<const bf16*>(g), hprev, r, z, n, hn},
      StepGrads{dgi, dgh, static_cast<bf16*>(dghb)}, dh, B, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pmce_gru_bwd_step(const void* dghb_t, const void* wb,
                                 const float* z_t, float* dh, const void* g,
                                 const float* hprev, const float* r,
                                 const float* z, const float* n,
                                 const float* hn, float* dgi, float* dgh,
                                 void* dghb_next, int B, int Bp, int H,
                                 void* stream) {
  // K = 3H splits into KSPLIT spans of whole 16-wide steps; the grid tiles
  // H and Bp by 16.
  if (H % (16 * KSPLIT) != 0 || Bp % 16 != 0 || Bp < B || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H / 16, Bp / 16);
  gru_bwd_step_kernel<<<grid, KSPLIT * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dghb_t), static_cast<const bf16*>(wb), z_t,
      dh, StepState{static_cast<const bf16*>(g), hprev, r, z, n, hn},
      StepGrads{dgi, dgh, static_cast<bf16*>(dghb_next)}, B, H);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_gru_error_string)
