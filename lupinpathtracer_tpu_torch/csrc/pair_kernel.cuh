// The ablation variants B6' of kernel B6: closest hit of superleaf-sorted
// rays against their work item's superleaf, one template for all of them.
//
// Replaces the modified copies of
// lupinpathtracer_tpu/kernels/pallas_bvh.py::_pair_kernel that
// tools/prof_pair.py::make_kernel builds (pallas_call at :276).
// pair_variants.cu instantiates every variant. V0 is the earlier design of
// B6 itself, as it shipped before pair_intersect.cuh replaced it, and the
// yardstick of that redesign: the two agree bit for bit.
//
// What bounds it: operations. Each (ray, superleaf) pair costs SP triangles
// x four 10-term dot products plus the epilogue (~81 f32 operations each);
// bytes are the sorted rays in, the hit records out and each item's
// (4, 10, SP) coefficient slice (655 KB at SP = 4096, read from L2/HBM once
// per item). Design: one block per work item, one thread per lane of its
// PB-ray block; the block streams the slice through shared memory in
// TC-triangle stages and every thread keeps its best hit in registers with
// a strict <, so the lowest local index wins a tie (pallas_bvh.py:499).
// Lanes outside [lo, hi) compute nothing and write nothing: items sharing a
// block write disjoint lanes and may run in any order. Items past the valid
// count (read from device memory, no host sync) and items with lo == hi
// return at once. Plain f32 throughout: the TPU's bf16 3-pass product and
// its winner recompute (pallas_bvh.py:471-542) are not needed.
//
// Two-level scenes (pallas_bvh.py:422-439): with an instance word per item
// the item's rays move to mesh space by the instance's 12 inverse-transform
// scalars; the direction is not normalised, so t stays world-scaled.
//
// Variants (tools/prof_pair.py:1-17), each with a plain version in
// kernels/bvh.py::pair_intersect_plain(variant=):
//   V0  the earlier B6 (one block per work item).
//   V1  selection t by rsqrt(det^2) and sign tests instead of the divide;
//       the winner's t, u, v, det recomputed exactly from its coefficients.
//   V2  tracks (t, index) only; u, v, det come out zero.
//   V3  V1's selection without the recompute: (selection t, index) only.
//   V4  V0 with the largest triangle tile that fits a block's shared memory
//       (the host picks TC: 1024 triangles = 160 KB for SP >= 1024).
//   V5  evaluate-only floor: all four products, t = min(nt), no validity.
// An all-empty grid (every lo == hi) is a launch of V0 with such items.

#pragma once

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace lupin_bvh {

constexpr int PAIR_V0 = 0, PAIR_V1 = 1, PAIR_V2 = 2, PAIR_V3 = 3, PAIR_V5 = 5;
constexpr int PAIR_TC = 256;  // V0's triangles per shared-memory stage (40 KB)

struct PairArgs {
  const int* blk;
  const int* msl;
  const int* lo;
  const int* hi;
  const int* n_items;
  const int* inst;   // per-item instance index, or nullptr
  const float* txf;  // (n_inst, 12) inverse transforms, or nullptr
  const float* rox;
  const float* roy;
  const float* roz;
  const float* rdx;
  const float* rdy;
  const float* rdz;
  const float* W;
  long long T;
  int n_cap, SP, PB, P;
  float eps;
  float* t;
  float* u;
  float* v;
  float* det;
  int* li;
};

template <int V, int TC>
__global__ void pair_kernel(const PairArgs a) {
  extern __shared__ float sw[];  // (4 * 10, TC)
  const int k = blockIdx.x;
  if (k >= *a.n_items) return;
  const int l = a.lo[k], h = a.hi[k];
  if (h <= l) return;  // uniform over the block
  const int pos = a.blk[k] * a.PB + threadIdx.x;
  const bool live = pos >= l && pos < h && pos < a.P;

  float r[10];
  if (live) {
    float ox = a.rox[pos], oy = a.roy[pos], oz = a.roz[pos];
    float dx = a.rdx[pos], dy = a.rdy[pos], dz = a.rdz[pos];
    if (a.inst != nullptr) {
      const float* m = a.txf + (size_t)a.inst[k] * 12;
      const float tx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
      const float ty = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
      const float tz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
      const float ex = m[0] * dx + m[1] * dy + m[2] * dz;
      const float ey = m[4] * dx + m[5] * dy + m[6] * dz;
      const float ez = m[8] * dx + m[9] * dy + m[10] * dz;
      ox = tx; oy = ty; oz = tz;
      dx = ex; dy = ey; dz = ez;
    }
    r[0] = dx; r[1] = dy; r[2] = dz;
    r[3] = oy * dz - oz * dy;
    r[4] = oz * dx - ox * dz;
    r[5] = ox * dy - oy * dx;
    r[6] = ox; r[7] = oy; r[8] = oz; r[9] = 1.0f;
  }
  const float* Ws = a.W + (size_t)a.msl[k] * a.SP;
  float bt = F32_MAX, bu = 0.0f, bv = 0.0f, bdet = 0.0f;
  int bidx = 0;
  for (int base = 0; base < a.SP; base += TC) {
    const int n = min(TC, a.SP - base);
    __syncthreads();
    for (int i = threadIdx.x; i < 40 * n; i += blockDim.x) {
      const int row = i / n;  // c * 10 + k
      const int j = i - row * n;
      sw[row * TC + j] = Ws[(size_t)row * a.T + base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      float m[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* w = sw + c * 10 * TC + j;
        float acc = r[0] * w[0];
#pragma unroll
        for (int q = 1; q < 10; ++q) acc = acc + r[q] * w[q * TC];
        m[c] = acc;
      }
      const float det = m[0];
      if constexpr (V == PAIR_V5) {
        // Keep the three unused products alive at no cost.
        asm volatile("" ::"f"(m[0]), "f"(m[1]), "f"(m[2]));
        bt = nmin(bt, m[3]);
      } else if constexpr (V == PAIR_V1 || V == PAIR_V3) {
        const float ad = rsqrtf(det * det);
        float t = m[3] * ad;
        t = det < 0.0f ? -t : t;
        const bool valid = (m[1] * det >= 0.0f) && (m[2] * det >= 0.0f) &&
                           ((det - m[1] - m[2]) * det >= 0.0f) && (t >= a.eps);
        const float tt = valid ? t : F32_MAX;
        if (tt < bt) {
          bt = tt;
          bidx = base + j;
        }
      } else {
        const float d = 1.0f / det;
        const float t = m[3] * d;
        const float u = m[1] * d;
        const float v = m[2] * d;
        const bool valid =
            (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t >= a.eps);
        const float tt = valid ? t : F32_MAX;
        if (tt < bt) {
          bt = tt;
          bidx = base + j;
          if constexpr (V == PAIR_V0) {
            bu = u;
            bv = v;
            bdet = det;
          }
        }
      }
    }
  }
  if (!live) return;
  if constexpr (V == PAIR_V1) {
    // Exact t, u, v, det of the selected triangle.
    float m[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* w = Ws + (size_t)c * 10 * a.T + bidx;
      float acc = r[0] * w[0];
#pragma unroll
      for (int q = 1; q < 10; ++q) acc = acc + r[q] * w[(size_t)q * a.T];
      m[c] = acc;
    }
    const float d = 1.0f / m[0];
    if (bt < F32_MAX) {
      bt = m[3] * d;
      bu = m[1] * d;
      bv = m[2] * d;
      bdet = m[0];
    }
  }
  a.t[pos] = bt;
  a.u[pos] = bu;
  a.v[pos] = bv;
  a.det[pos] = bdet;
  a.li[pos] = bidx;
}

// One block of PB threads per item; shared memory above 48 KB is opted in.
template <int V, int TC>
int launch_pair(const PairArgs& a, void* stream) {
  if (a.PB < 1 || a.PB > 1024) return (int)cudaErrorInvalidValue;
  if ((a.inst == nullptr) != (a.txf == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.n_cap == 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * 4 * 10 * TC;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_kernel<V, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_kernel<V, TC><<<a.n_cap, a.PB, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace lupin_bvh
