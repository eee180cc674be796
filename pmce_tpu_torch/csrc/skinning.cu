// Linear blend skinning for Hopper (sm_90a), full f32.
//
// Replaces: pmce_tpu/smpl/kernels.py `_skinning_kernel` (entry
// `fused_skinning`), the Pallas kernel that blends each vertex tile's
// per-joint transforms on the MXU ([12, J] @ [J, V_tile] at HIGHEST
// precision) and applies the blended 3x4 transform to the posed vertices.
//
// What bounds it on this card: at B = 256, V = 6890, J = 24 the blend is
// 2 * 12 * 24 * V * B = 1.02 GFLOP of f32 multiply-adds (about 15 us at the
// 67 TFLOP/s of the CUDA cores; tensor cores are not used, TF32 would cost
// the layer its 0.001 mm parity), against 43 MB of vertices in and out
// (about 13 us at 3.35 TB/s). The two are close; the FMAs bound it.
//
// Design: register-blocked, so that the FMAs and not the shared-memory
// loads set the pace. A thread owns 4 consecutive vertices, a block of 128
// threads a tile of 512 vertices and a chunk of bodies (the host's plan:
// about three blocks an SM, all resident at once). The block stages its
// tile of skinning weights in shared memory once, transposed to [J][512]
// (each vertex's row of J weights read as 16-byte words where the rows are
// 16-byte aligned), and rows 0-2 of its bodies' 4x4 transforms, 3 float4 a
// joint. Per body and joint a thread then makes one 16-byte load of its 4
// vertices' weights and 3 broadcast 16-byte loads of the joint's 12
// transform entries, for 48 FMAs into 48 accumulators in registers (the
// [B, V, 12] blended tensor never exists), and applies the blended
// transforms to its vertices, read and written as 12 consecutive floats
// by the widest words their address allows (3 float4 where it is 16-byte
// aligned: every body where V is a multiple of 4, the even bodies at V =
// 6890; 6 float2 for the odd ones). The
// ragged vertex edge (6890 = 4 * 1722 + 2) is masked. The blend's sums run
// over the joints in order, and each vertex's arithmetic is the
// one-thread-a-vertex kernel's that this replaced, operation for operation.
//
// ptxas -v (sm_90a): 79 registers, no spills; 60,672 B of dynamic shared
// memory at J = 24 and 10 bodies a block (the plan at B = 256).

#include "common.cuh"

constexpr int SK_NTH = 128;               // threads a block
constexpr int SK_VPT = 4;                 // vertices a thread
constexpr int SK_TILE = SK_NTH * SK_VPT;  // vertices a block
constexpr int SK_MAXJ = 32;               // joints
constexpr int SK_MAXBB = 16;              // bodies a block

// 12 consecutive floats by the widest loads (stores) their address allows.
__device__ __forceinline__ void load12(const float* p, float (&v)[12]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z,
            v[4 * i + 3] = x.w;
    }
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = x.x, v[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = __ldg(p + i);
  }
}
__device__ __forceinline__ void store12(float* p, const float (&v)[12]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i] = v[i];
  }
}

__global__ void __launch_bounds__(SK_NTH)
    skinning_kernel(const float* __restrict__ v_posed,
                    const float* __restrict__ A,  // [B, J, 4, 4]
                    const float* __restrict__ W,  // [V, J]
                    float* __restrict__ out, int B, int V, int J, int bpb) {
  extern __shared__ float4 sk_smem[];
  float* Wt = reinterpret_cast<float*>(sk_smem);  // [J][SK_TILE]
  float4* As = sk_smem + J * SK_TILE / 4;         // [bpb][J][3] rows 0-2
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * SK_TILE;
  const int b0 = blockIdx.y * bpb;
  const int nb = min(bpb, B - b0);

  // The tile's weights, a vertex a thread at a time (consecutive threads
  // store consecutive addresses of a joint's row).
  const bool w16 =
      (J & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  for (int i = tid; i < SK_TILE; i += SK_NTH) {
    const int v = v0 + i;
    if (w16) {
      const float4* src = reinterpret_cast<const float4*>(W + (size_t)v * J);
      for (int j4 = 0; j4 < J / 4; ++j4) {
        const float4 w = v < V ? __ldg(src + j4) : make_float4(0, 0, 0, 0);
        float* dst = Wt + 4 * j4 * SK_TILE + i;
        dst[0] = w.x;
        dst[SK_TILE] = w.y;
        dst[2 * SK_TILE] = w.z;
        dst[3 * SK_TILE] = w.w;
      }
    } else {
      for (int j = 0; j < J; ++j)
        Wt[j * SK_TILE + i] = v < V ? __ldg(W + (size_t)v * J + j) : 0.f;
    }
  }
  // Rows 0-2 of each body's transforms: 3 float4 a joint.
  const float4* A4 = reinterpret_cast<const float4*>(A) + (size_t)b0 * J * 4;
  for (int e = tid; e < nb * J * 3; e += SK_NTH) {
    const int bj = e / 3;
    As[e] = __ldg(A4 + bj * 4 + (e - 3 * bj));
  }
  __syncthreads();

  const int v = v0 + SK_VPT * tid;
  if (v >= V) return;
  const int nv = min(SK_VPT, V - v);
  const float* wrow = Wt + SK_VPT * tid;
  for (int bb = 0; bb < nb; ++bb) {
    float t[SK_VPT][12];
#pragma unroll
    for (int i = 0; i < SK_VPT; ++i)
#pragma unroll
      for (int k = 0; k < 12; ++k) t[i][k] = 0.f;
    const float4* Ab = As + bb * J * 3;
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
      const float4 w4 = *reinterpret_cast<const float4*>(wrow + j * SK_TILE);
      const float4 r0 = Ab[3 * j], r1 = Ab[3 * j + 1], r2 = Ab[3 * j + 2];
      const float w[SK_VPT] = {w4.x, w4.y, w4.z, w4.w};
      const float m[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                           r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
#pragma unroll
      for (int i = 0; i < SK_VPT; ++i)
#pragma unroll
        for (int k = 0; k < 12; ++k) t[i][k] = fmaf(w[i], m[k], t[i][k]);
    }
    const size_t o = ((size_t)(b0 + bb) * V + v) * 3;
    float p[12], q[12];
    if (nv == SK_VPT) {
      load12(v_posed + o, p);
    } else {
#pragma unroll
      for (int e = 0; e < 12; ++e) p[e] = e < 3 * nv ? v_posed[o + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SK_VPT; ++i)
#pragma unroll
      for (int m = 0; m < 3; ++m)
        q[3 * i + m] =
            fmaf(t[i][4 * m], p[3 * i],
                 fmaf(t[i][4 * m + 1], p[3 * i + 1],
                      fmaf(t[i][4 * m + 2], p[3 * i + 2], t[i][4 * m + 3])));
    if (nv == SK_VPT) {
      store12(out + o, q);
    } else {
#pragma unroll
      for (int e = 0; e < 12; ++e)
        if (e < 3 * nv) out[o + e] = q[e];
    }
  }
}

// bpb: bodies a block (the host's plan, 1 .. 16); the grid is ceil(V / 512)
// vertex tiles by ceil(B / bpb) chunks of bodies.
extern "C" int pmce_skinning(const float* v_posed, const float* A,
                             const float* W, float* out, int B, int V, int J,
                             int bpb, void* stream) {
  if (J <= 0 || J > SK_MAXJ || B <= 0 || V <= 0 || bpb <= 0 ||
      bpb > SK_MAXBB || reinterpret_cast<uintptr_t>(A) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (J * SK_TILE + bpb * J * 12) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      skinning_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((V + SK_TILE - 1) / SK_TILE, (B + bpb - 1) / bpb);
  skinning_kernel<<<grid, SK_NTH, smem, static_cast<cudaStream_t>(stream)>>>(
      v_posed, A, W, out, B, V, J, bpb);
  return static_cast<int>(cudaGetLastError());
}

PMCE_EXPORT_ERROR_STRING(pmce_skin_error_string)
