// Device helpers shared by B4 (packet.cu) and B5-B7 (bvh.cu): the slab test
// with NaN-propagating min/max, the 4-triangle test loop of B4 and B6
// (test_tris, on the packed coefficient table), the lookup of the work item
// that covers a sorted position (B6 and B7), and the IA_* rows of one
// BVH hit -- the winner's packed attribute row interpolated at its
// barycentrics and, for two-level items, rotated by the instance normal
// matrix, as
// lupinpathtracer_tpu/kernels/pallas_bvh.py::_attr_kernel (:750-825) and
// pallas_packet.py::_attr_phase (:784-809) compute them. The plain versions
// are kernels/bvh.slab, kernels/bvh.interp_rows and
// kernels/bvh.rotate_rows.

#pragma once

#include "tri_test.cuh"

namespace lupin_bvh {

constexpr float F32_MAX = 3.4028235e38f;
constexpr int TOP_FAN = 8;

// min/max that propagate NaN, as jnp.minimum/maximum and torch do.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Slab test (pathtracer.wgsl:2906-2918), in the order of kernels/bvh.slab.
__device__ __forceinline__ void slab(const float o[3], const float iv[3],
                                     const float* lo, const float* hi,
                                     float& t_near, float& t_far) {
  const float tx1 = (lo[0] - o[0]) * iv[0], tx2 = (hi[0] - o[0]) * iv[0];
  const float ty1 = (lo[1] - o[1]) * iv[1], ty2 = (hi[1] - o[1]) * iv[1];
  const float tz1 = (lo[2] - o[2]) * iv[2], tz2 = (hi[2] - o[2]) * iv[2];
  t_far = nmin(nmin(nmax(tx1, tx2), nmax(ty1, ty2)), nmax(tz1, tz2));
  t_near = nmax(nmax(nmin(tx1, tx2), nmin(ty1, ty2)), nmin(tz1, tz2));
}

// Attribute columns (kernels/dense_intersect.py ATTR_*).
constexpr int A_N0 = 0, A_N1 = 3, A_N2 = 6, A_GN = 9, A_UV0 = 12, A_UV1 = 14,
              A_UV2 = 16, A_HAS_UV = 18, A_C0 = 19, A_C1 = 23, A_C2 = 27,
              A_TAN = 31, A_BIT = 34, A_DET_SIGN = 58, A_MAT_ID = 59;

// The columns of one attribute row that write_rows reads, in registers, read
// as 16-byte loads of the row's touched 32-byte sectors: columns 0-31
// (normals, geometric normal, texcoords, has_uv, colours), 32-39 with
// tangents (tangent, bitangent) and 56-59 (det sign, mat id). The row must
// be 16-byte aligned. Indexed like the row itself; every index write_rows
// uses is a constant once it is inlined, so nothing goes to local memory.
struct RowRegs {
  float4 q[10];
  float4 q14;
  __device__ __forceinline__ void load(const float4* __restrict__ a, bool tangents) {
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = __ldg(a + i);
    q[8] = q[9] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tangents) {
      q[8] = __ldg(a + 8);
      q[9] = __ldg(a + 9);
    }
    q14 = __ldg(a + 14);
  }
  __device__ __forceinline__ float operator[](int c) const {
    if (c >= 56) return lupin_tri::lane_of(q14, c - 56);
    return lupin_tri::lane_of(q[c >> 2], c & 3);
  }
};

template <class Row>
__device__ __forceinline__ float interp(const Row& a, int s0, int s1, int s2,
                                        int c, float hw, float hu, float hv) {
  return a[s0 + c] * hw + a[s1 + c] * hu + a[s2 + c] * hv;
}

// v <- M v for a row-major 3x3 M, each component summed left to right.
__device__ __forceinline__ void rot3(const float* m, float v[3]) {
  const float x = v[0], y = v[1], z = v[2];
  v[0] = m[0] * x + m[1] * y + m[2] * z;
  v[1] = m[3] * x + m[4] * y + m[5] * z;
  v[2] = m[6] * x + m[7] * y + m[8] * z;
}

// Writes awout (16 or 24) rows of the attribute row a (a pointer into the
// table, or RowRegs), row r at out[r * stride]. Two-level items
// (pallas_bvh.py:788-825) pass the winner's instance normal matrix nm (9
// floats) and material override ovr: the normals and tangent frame are
// rotated, the geometric normal is renormalised and mat_id becomes ovr,
// both only where ovr >= 0.
template <class Row>
__device__ __forceinline__ void write_row_values(const Row& a, float hu, float hv,
                                                 int awout, float* out,
                                                 size_t stride,
                                                 const float* nm, int ovr) {
  const float hw = 1.0f - hu - hv;
  float n[3], gn[3], tn[3] = {0.0f, 0.0f, 0.0f}, bt[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    n[c] = interp(a, A_N0, A_N1, A_N2, c, hw, hu, hv);
    gn[c] = a[A_GN + c];
    if (awout >= 24) {
      tn[c] = a[A_TAN + c];
      bt[c] = a[A_BIT + c];
    }
  }
  if (nm != nullptr) {
    rot3(nm, n);
    rot3(nm, gn);
    if (ovr >= 0) {
      const float l2 = gn[0] * gn[0] + gn[1] * gn[1] + gn[2] * gn[2];
      const float inv = 1.0f / sqrtf(nmax(l2, 1e-30f));
      for (int c = 0; c < 3; ++c) gn[c] = gn[c] * inv;
    }
    if (awout >= 24) {
      rot3(nm, tn);
      rot3(nm, bt);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[(size_t)(0 + c) * stride] = n[c];
    out[(size_t)(3 + c) * stride] = gn[c];
    out[(size_t)(9 + c) * stride] = interp(a, A_C0, A_C1, A_C2, c, hw, hu, hv);
  }
  out[6 * stride] = interp(a, A_UV0, A_UV1, A_UV2, 0, hw, hu, hv);
  out[7 * stride] = interp(a, A_UV0, A_UV1, A_UV2, 1, hw, hu, hv);
  out[8 * stride] = a[A_HAS_UV];
  out[12 * stride] = interp(a, A_C0, A_C1, A_C2, 3, hw, hu, hv);
  out[13 * stride] = a[A_DET_SIGN];
  out[14 * stride] = ovr >= 0 ? (float)ovr : a[A_MAT_ID];
  out[15 * stride] = 0.0f;
  if (awout >= 24) {
    for (int c = 0; c < 3; ++c) {
      out[(size_t)(16 + c) * stride] = tn[c];
      out[(size_t)(19 + c) * stride] = bt[c];
    }
    out[22 * stride] = 0.0f;
    out[23 * stride] = 0.0f;
  }
}

// write_row_values on the table's row a; a == nullptr writes zeros (a miss).
__device__ __forceinline__ void write_rows(const float* a, float hu, float hv,
                                           int awout, float* out,
                                           size_t stride,
                                           const float* nm = nullptr,
                                           int ovr = -1) {
  if (a == nullptr) {
    for (int r = 0; r < awout; ++r) out[(size_t)r * stride] = 0.0f;
    return;
  }
  write_row_values(a, hu, hv, awout, out, stride, nm, ovr);
}

// Work items (kernels/bvh.py's module note): item k covers the sorted
// positions [cov_start, cov_end), those of [lo[k], hi[k]) inside ray block
// blk[k] of PB lanes and below P, empty when lo >= hi. Items are ordered by
// the positions they cover (kernels/intersect.py::_wf_work_items), so B6
// and B7 find the item that covers a position by search (tile_items, then
// covering); kernels/bvh.py::pair_item_map is the same lookup in PyTorch.
__device__ __forceinline__ int cov_start(const int* blk, const int* lo, int PB,
                                         int k) {
  return max(lo[k], blk[k] * PB);
}
__device__ __forceinline__ int cov_end(const int* blk, const int* hi, int PB,
                                       int P, int k) {
  return min(min(hi[k], blk[k] * PB + PB), P);
}

// First k in [lo_k, hi_k) with cov_start(k) > x, hi_k if none: each round
// the 32 lanes probe evenly spaced items and keep the bracket between the
// last probe at or below x and the first above it. Called by a whole warp;
// every lane returns the same value.
__device__ int warp_upper_bound(const int* blk, const int* lo, int PB,
                                int lo_k, int hi_k, int x) {
  const int lane = threadIdx.x & 31;
  while (lo_k < hi_k) {
    const long long len = hi_k - lo_k;
    const int k = lo_k + (int)(len * lane / 32);
    const unsigned m = __ballot_sync(0xffffffffu, cov_start(blk, lo, PB, k) > x);
    if (m == 0u) {
      lo_k += (int)(len * 31 / 32) + 1;
      continue;
    }
    const int f = __ffs(m) - 1;
    const int kf = lo_k + (int)(len * f / 32);
    if (f > 0) lo_k += (int)(len * (f - 1) / 32) + 1;
    hi_k = kf;
  }
  return lo_k;
}

// The candidates [kb, ke) among the first n items for the positions
// [p0, p0 + span): from the first item starting where the last item that
// starts at or before p0 starts, to the first starting at p0 + span. Called
// by a whole warp; every lane returns the same values.
__device__ __forceinline__ void tile_items(const int* blk, const int* lo, int PB,
                                           int n, int p0, int span, int& kb,
                                           int& ke) {
  const int u = warp_upper_bound(blk, lo, PB, 0, n, p0);
  kb = 0;
  if (u > 0) {
    const int v = cov_start(blk, lo, PB, u - 1);
    kb = (u > 1 && cov_start(blk, lo, PB, u - 2) < v)
             ? u - 1 : warp_upper_bound(blk, lo, PB, 0, u, v - 1);
  }
  ke = warp_upper_bound(blk, lo, PB, kb, n, p0 + span - 1);
}

// Of nc candidates whose cov_start / cov_end are c[] / e[] (in shared
// memory), the one that covers pos: the last starting at or before it (a
// non-empty one among equal starts), if pos is below its end; -1 if none.
__device__ __forceinline__ int covering(const int* c, const int* e, int nc,
                                        int pos) {
  int l = 0, h = nc;  // first index with start > pos
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (c[mid] > pos) h = mid; else l = mid + 1;
  }
  int i = l - 1;
  while (i > 0 && c[i - 1] == c[i] && e[i] <= c[i]) --i;
  return (i >= 0 && pos < e[i]) ? i : -1;
}

// Triangles [base, base + n) (n a multiple of 4) of one slice against the
// ray r, folded into the running minimum in index order: w points at the
// slice's triangle base in the packed layout (coefficient q of triangles
// 4i..4i+3 at w + 160 i + 4 q); GLOBAL reads it through L1/L2, else from
// shared memory.
template <bool GLOBAL>
__device__ __forceinline__ void test_tris(const float* w, int n, int base,
                                          const float* r, float eps, bool pre,
                                          float& bt, float& bu, float& bv,
                                          float& bdet, int& bidx) {
  for (int j = 0; j < n; j += 4) {
    float4 m4[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float4 acc;
#pragma unroll
      for (int q = 0; q < 10; ++q) {
        const float4* src = reinterpret_cast<const float4*>(w + 40 * j + 4 * (c * 10 + q));
        const float4 y = GLOBAL ? __ldg(src) : *src;
        if (q == 0) {
          acc = make_float4(r[0] * y.x, r[0] * y.y, r[0] * y.z, r[0] * y.w);
        } else {
          acc.x = acc.x + r[q] * y.x;
          acc.y = acc.y + r[q] * y.y;
          acc.z = acc.z + r[q] * y.z;
          acc.w = acc.w + r[q] * y.w;
        }
      }
      m4[c] = acc;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float det = lupin_tri::lane_of(m4[0], k), nu = lupin_tri::lane_of(m4[1], k);
      const float nv = lupin_tri::lane_of(m4[2], k), ntn = lupin_tri::lane_of(m4[3], k);
      if (pre && lupin_tri::surely_invalid(det, nu, nv, ntn)) continue;
      const float d = 1.0f / det;
      const float tq = ntn * d;
      const float uq = nu * d;
      const float vq = nv * d;
      const bool valid = (uq >= 0.0f) && (vq >= 0.0f) && (uq + vq <= 1.0f) && (tq >= eps);
      const float tt = valid ? tq : F32_MAX;
      if (tt < bt) {
        bt = tt;
        bu = uq;
        bv = vq;
        bdet = det;
        bidx = base + j + k;
      }
    }
  }
}

}  // namespace lupin_bvh
