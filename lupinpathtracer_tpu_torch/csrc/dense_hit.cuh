// The dense closest-hit loop of B1/B2 (dense_intersect.cu) and B3 (mega.cu):
// one ray against groups of four triangles of the packed coefficient table
// (kernels/bvh.py::pair_table, (ceil(T / 4), 40, 4): coefficient c * 10 + k
// of triangles 4g..4g+3 is the float4 at 40 g + c * 10 + k), folded into
// the running minimum in index order.
//
// The arithmetic of kernels/dense_intersect.py: R = [d, o x d, o, 1] dotted
// with each coefficient row in order k = 0..9, separately rounded multiplies
// and adds (-fmad=false), the epilogue d = 1/det; t = nt*d; u = nu*d;
// v = nv*d; valid = u >= 0 && v >= 0 && u + v <= 1 && t >= eps, and a
// strict-< argmin, so the lowest index wins a tie. The four triangles of a
// group are evaluated together (16 independent sums of 10 terms, one 16-byte
// load per coefficient of the four), then folded one after another. With `pre` (eps > 0) a triangle is dropped before the
// divide when its numerators already make it invalid (tri_test.cuh): it
// drops only triangles the epilogue rejects. The padding triangles past T are all
// zero (det = 0, never valid), so any T works.

#pragma once

#include "tri_test.cuh"

namespace lupin_dense {

constexpr float HIT_F32_MAX = 3.4028235e38f;

template <bool SMEM>
__device__ __forceinline__ float4 tab4(const float4* p) {
  if constexpr (SMEM) return *p;
  return __ldg(p);
}

// Groups [g0, g0 + ng) of the table, w pointing at group g0 (in shared
// memory where SMEM, else read through L1), against the ray r, folded into
// (bt, bu, bv, bdet, bidx); a triangle's index is 4 * group + lane.
template <bool SMEM>
__device__ __forceinline__ void fold_groups(const float4* __restrict__ w, int g0,
                                            int ng, const float (&r)[10],
                                            float eps, bool pre, float& bt,
                                            float& bu, float& bv, float& bdet,
                                            int& bidx) {
  for (int g = 0; g < ng; ++g) {
    const float4* wg = w + (size_t)g * 40;
    float4 m4[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 x = tab4<SMEM>(wg + cc * 10);
      float4 acc = make_float4(r[0] * x.x, r[0] * x.y, r[0] * x.z, r[0] * x.w);
#pragma unroll
      for (int k = 1; k < 10; ++k) {
        const float4 y = tab4<SMEM>(wg + cc * 10 + k);
        acc.x = acc.x + r[k] * y.x;
        acc.y = acc.y + r[k] * y.y;
        acc.z = acc.z + r[k] * y.z;
        acc.w = acc.w + r[k] * y.w;
      }
      m4[cc] = acc;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float det = lupin_tri::lane_of(m4[0], k), nu = lupin_tri::lane_of(m4[1], k);
      const float nv = lupin_tri::lane_of(m4[2], k), nt = lupin_tri::lane_of(m4[3], k);
      if (pre && lupin_tri::surely_invalid(det, nu, nv, nt)) continue;
      const float d = 1.0f / det;
      const float t = nt * d;
      const float u = nu * d;
      const float v = nv * d;
      const bool valid = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t >= eps);
      const float tt = valid ? t : HIT_F32_MAX;
      if (tt < bt) {
        bt = tt;
        bu = u;
        bv = v;
        bdet = det;
        bidx = 4 * (g0 + g) + k;
      }
    }
  }
}

}  // namespace lupin_dense
