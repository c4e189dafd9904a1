// The BVH route's bounce batches: closest hit by one thread per ray walking
// the binary BVH of a single-level scene with a short stack.
//
// Replaces no Pallas kernel. It is the walk the reference runs on GPUs
// (bvh_custom.wgsl:195-288): near child first, a child pushed only while its
// entry distance is below the best hit. The JAX package re-shaped that walk
// into the superleaf wavefront for the TPU, which has no per-lane control
// flow or gathers (accel/superleaf.py): rounds of B5 top traversal, a sort
// by superleaf, B6 over each superleaf's whole stride, an un-sort and a
// per-ray min, with a host sync per round. An H100 has per-lane control flow
// and gathers, so kernels/intersect.py sends the bounce batches of
// single-level scenes here, one launch a batch. kernels/walk.py::walk_plain
// is the plain version, bit for bit.
//
// Per triangle the arithmetic is B6's (bvh_common.cuh::test_tris): the ray's
// ten features R = [d, o x d, o, 1], four ten-term dot products against the
// triangle's rows of the packed coefficient table (kernels/bvh.py::
// pair_table), the sign pre-test (tri_test.cuh), the IEEE divide and the
// validity test, at -fmad=false. A triangle's t, u, v and det therefore equal
// B6's. Within a leaf the strict < runs in index order; across leaves an
// equal t goes to the lower triangle id, so the winner does not depend on
// the visit order. Ids index the padded superleaf soup, as the wavefront's.
//
// Boxes. The walk must not cull a box that holds a hit the triangle test
// accepts. The test accepts points a rounding error outside a triangle, and
// a leaf's box is its triangles' exact bounds, so each ray widens every box
// by delta = 2^-16 (|o|max + M), M the root box's largest coordinate
// magnitude: the slab distances are taken from o + delta to the low planes
// and from o - delta to the high ones, at no cost per box. t_far is scaled by
// 1 + 2 gamma_3 (Ize 2013) and min/max ignore a NaN (an origin on a slab
// plane with 1/d infinite), so neither culls such a box.
//
// Nodes (scene/flatten.py::pack_bvh_nodes): 32 bytes each, (min.xyz, first) and
// (max.xyz, count) with the ints' bits in the w lanes; the two children of
// an internal node are adjacent, so a step reads both boxes and both
// (first, count) pairs as four 16-byte loads. The stack holds a pushed
// child's (first, count) and its entry distance; a popped entry whose
// distance is no longer below the best hit is dropped.
//
// What bounds it on an H100: per ray, a step reads 64 bytes of nodes and
// makes two slab tests (26 operations each); a leaf reads the 640-byte
// groups of four triangles that cover it and tests each triangle (81
// operations). On SPD tetra (4.19M triangles, 2.1M nodes, 67 MB of nodes) a
// bounce batch of 262,144 lanes makes 10 steps and 1.4 triangle tests a
// lane, and reads 21 MB of distinct nodes and 52 MB of distinct groups:
// counting each byte once, bytes bound it (25 us at 3.35 TB/s against 2.5
// us of operations). A ray's loads depend one on the next, so latency, not
// either bound, sets its time (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_test.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STACK = 27;  // accel/bvh.py BVH_MAX_DEPTH + 2
constexpr float F32_MAX = 3.4028235e38f;
constexpr float PAD = 1.52587890625e-05f;  // 2^-16
constexpr float FAR_SCALE = 1.0000003576278687f;  // 1 + 3 * 2^-23 >= 1 + 2 gamma_3

struct WalkArgs {
  const float4* nodes;  // (2 * n_nodes) float4
  const float* W;       // pair_table: (T / 4, 40, 4)
  const float* rox;
  const float* roy;
  const float* roz;
  const float* rdx;
  const float* rdy;
  const float* rdz;
  const bool* active;  // or nullptr
  int n;
  float eps;
  float* t;
  float* u;
  float* v;
  float* det;
  int* tri;
};

struct Ray {
  float r[10];      // features
  float op[3];      // o + delta: low planes
  float om[3];      // o - delta: high planes
  float iv[3];
};

// The entry distance of a box, or F32_MAX where the ray misses it.
__device__ __forceinline__ float box_entry(const Ray& ray, const float4& lo,
                                           const float4& hi) {
  const float ax = (lo.x - ray.op[0]) * ray.iv[0], bx = (hi.x - ray.om[0]) * ray.iv[0];
  const float ay = (lo.y - ray.op[1]) * ray.iv[1], by = (hi.y - ray.om[1]) * ray.iv[1];
  const float az = (lo.z - ray.op[2]) * ray.iv[2], bz = (hi.z - ray.om[2]) * ray.iv[2];
  const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz)) * FAR_SCALE;
  return (tn <= tf && tf >= 0.0f) ? tn : F32_MAX;
}

// Triangles [first, first + count) against the ray, through the groups of
// four that cover them.
__device__ __forceinline__ void test_leaf(const WalkArgs& a, const Ray& ray,
                                          int first, int count, bool pre,
                                          float& bt, float& bu, float& bv,
                                          float& bdet, int& bidx) {
  const int end = first + count;
  for (int g = first >> 2; 4 * g < end; ++g) {
    const float4* w = reinterpret_cast<const float4*>(a.W) + (size_t)g * 40;
    float4 m4[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float4 acc;
#pragma unroll
      for (int q = 0; q < 10; ++q) {
        const float4 y = __ldg(w + c * 10 + q);
        const float rq = ray.r[q];
        if (q == 0) {
          acc = make_float4(rq * y.x, rq * y.y, rq * y.z, rq * y.w);
        } else {
          acc.x = acc.x + rq * y.x;
          acc.y = acc.y + rq * y.y;
          acc.z = acc.z + rq * y.z;
          acc.w = acc.w + rq * y.w;
        }
      }
      m4[c] = acc;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * g + k;
      if (j < first || j >= end) continue;
      const float det = lupin_tri::lane_of(m4[0], k), nu = lupin_tri::lane_of(m4[1], k);
      const float nv = lupin_tri::lane_of(m4[2], k), nt = lupin_tri::lane_of(m4[3], k);
      if (pre && lupin_tri::surely_invalid(det, nu, nv, nt)) continue;
      const float d = 1.0f / det;
      const float tq = nt * d;
      const float uq = nu * d;
      const float vq = nv * d;
      const bool valid = (uq >= 0.0f) && (vq >= 0.0f) && (uq + vq <= 1.0f) && (tq >= a.eps);
      if (valid && (tq < bt || (tq == bt && j < bidx))) {
        bt = tq;
        bu = uq;
        bv = vq;
        bdet = det;
        bidx = j;
      }
    }
  }
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
lupin_walk_kernel(const WalkArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  float bt = F32_MAX, bu = 0.0f, bv = 0.0f, bdet = 0.0f;
  int bidx = 0;
  if (a.active == nullptr || a.active[i]) {
    const float ox = a.rox[i], oy = a.roy[i], oz = a.roz[i];
    const float dx = a.rdx[i], dy = a.rdy[i], dz = a.rdz[i];
    Ray ray;
    ray.r[0] = dx; ray.r[1] = dy; ray.r[2] = dz;
    ray.r[3] = oy * dz - oz * dy;
    ray.r[4] = oz * dx - ox * dz;
    ray.r[5] = ox * dy - oy * dx;
    ray.r[6] = ox; ray.r[7] = oy; ray.r[8] = oz; ray.r[9] = 1.0f;
    ray.iv[0] = 1.0f / dx; ray.iv[1] = 1.0f / dy; ray.iv[2] = 1.0f / dz;
    const float4 root_lo = __ldg(a.nodes), root_hi = __ldg(a.nodes + 1);
    const float M = fmaxf(fmaxf(fmaxf(fabsf(root_lo.x), fabsf(root_lo.y)), fabsf(root_lo.z)),
                          fmaxf(fmaxf(fabsf(root_hi.x), fabsf(root_hi.y)), fabsf(root_hi.z)));
    const float delta = (fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz)) + M) * PAD;
    ray.op[0] = ox + delta; ray.op[1] = oy + delta; ray.op[2] = oz + delta;
    ray.om[0] = ox - delta; ray.om[1] = oy - delta; ray.om[2] = oz - delta;
    const bool pre = a.eps > 0.0f;

    int st_first[STACK], st_count[STACK];
    float st_t[STACK];
    int sp = 0;
    int first = __float_as_int(root_lo.w), count = __float_as_int(root_hi.w);
    for (;;) {
      // Down the internal nodes to a leaf, or to nothing left to visit.
      while (count == 0) {
        const float4* c = a.nodes + 2 * (size_t)first;
        const float4 l_lo = __ldg(c), l_hi = __ldg(c + 1);
        const float4 r_lo = __ldg(c + 2), r_hi = __ldg(c + 3);
        const float tl = box_entry(ray, l_lo, l_hi);
        const float tr = box_entry(ray, r_lo, r_hi);
        const bool go_l = tl < bt, go_r = tr < bt;
        if (go_l && go_r) {
          const bool left_near = tl <= tr;
          const float4& n_lo = left_near ? l_lo : r_lo;
          const float4& n_hi = left_near ? l_hi : r_hi;
          const float4& f_lo = left_near ? r_lo : l_lo;
          const float4& f_hi = left_near ? r_hi : l_hi;
          st_first[sp] = __float_as_int(f_lo.w);
          st_count[sp] = __float_as_int(f_hi.w);
          st_t[sp] = left_near ? tr : tl;
          ++sp;
          first = __float_as_int(n_lo.w);
          count = __float_as_int(n_hi.w);
        } else if (go_l || go_r) {
          first = __float_as_int(go_l ? l_lo.w : r_lo.w);
          count = __float_as_int(go_l ? l_hi.w : r_hi.w);
        } else {
          count = -1;  // pop below
        }
        if (count < 0) {
          while (sp > 0 && !(st_t[sp - 1] < bt)) --sp;
          if (sp == 0) break;
          --sp;
          first = st_first[sp];
          count = st_count[sp];
        }
      }
      if (count <= 0) break;
      test_leaf(a, ray, first, count, pre, bt, bu, bv, bdet, bidx);
      while (sp > 0 && !(st_t[sp - 1] < bt)) --sp;
      if (sp == 0) break;
      --sp;
      first = st_first[sp];
      count = st_count[sp];
    }
  }
  a.t[i] = bt;
  a.u[i] = bu;
  a.v[i] = bv;
  a.det[i] = bdet;
  a.tri[i] = bidx;
}

// One launch over n rays on `stream`; returns cudaGetLastError(). The node
// table and the coefficient table must be 16-byte aligned.
extern "C" int lupin_walk(const float* nodes, const float* W, const float* rox,
                          const float* roy, const float* roz, const float* rdx,
                          const float* rdy, const float* rdz, const bool* active,
                          int n, float eps, float* t, float* u, float* v,
                          float* det, int* tri, void* stream) {
  if ((((uintptr_t)nodes) | ((uintptr_t)W)) & 15u) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const WalkArgs a{reinterpret_cast<const float4*>(nodes), W, rox, roy, roz, rdx,
                   rdy, rdz, active, n, eps, t, u, v, det, tri};
  lupin_walk_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
