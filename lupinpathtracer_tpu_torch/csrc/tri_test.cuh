// The sign pre-test that B3 (mega.cu) and B6 (pair_intersect.cuh) run on a
// ray/triangle test's four dot products before the divide.
//
// The reference epilogue (kernels/dense_intersect.py, pallas_bvh.py:499):
// d = 1/det; t = nt*d, u = nu*d, v = nv*d; valid = u >= 0 && v >= 0 &&
// u + v <= 1 && t >= eps. surely_invalid is true only where that epilogue
// surely rejects the triangle, for eps > 0, so a caller may skip the divide
// there and keep the result bit for bit. Flipping the numerators by det's
// sign bit (exact) leaves un, vn, tn with u = un * |d| etc.:
// - tn > 0 fails: t is <= +0 or NaN, below eps.
// - un < -|det| * 2^-24: u is negative and not -0 (|u| > 2^-24 is far above
//   the subnormals; a |det| so small that the threshold underflows makes
//   1/det huge or infinite, and u -inf). Same for vn.
// - un + vn > |det| * (1 + 2^-16): the exact (un + vn) / |det| exceeds
//   1 + 2^-16 less a few roundings of 2^-24 each, so the rounded u + v is
//   above 1 (an overflow of the sum or an infinite 1/det leaves it inf or
//   NaN; a threshold that overflows drops nothing).
// Any NaN makes the reference reject too.

#pragma once

namespace lupin_tri {

__device__ __forceinline__ bool surely_invalid(float det, float nu, float nv,
                                               float nt) {
  const unsigned sd = __float_as_uint(det) & 0x80000000u;
  const float dn = fabsf(det);
  const float un = __uint_as_float(__float_as_uint(nu) ^ sd);
  const float vn = __uint_as_float(__float_as_uint(nv) ^ sd);
  const float tn = __uint_as_float(__float_as_uint(nt) ^ sd);
  const float thr = dn * 5.9604644775390625e-8f;  // 2^-24, exact
  return !(tn > 0.0f) || un < -thr || vn < -thr ||
         un + vn > dn * 1.0000152587890625f;  // 1 + 2^-16, exact
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

}  // namespace lupin_tri
