// Kernel B3: the fused dense path-tracing megakernel.
//
// Replaces lupinpathtracer_tpu/kernels/pallas_mega.py::mega_pathtrace_spp
// (pallas_call at :622; _mega_kernel :306 with _isect_attrs :125,
// _sample_lights_k :233 and _lights_pdf_k :277). The plain version it is held
// against is the port's render/integrators.pathtrace_spp (the wavefront
// loop, STANDARD and NAIVE), whose per-lane semantics it reproduces: the
// same PCG streams and draw order (including the unconditional
// transmittance and delta draws kept for stream parity), camera rays,
// dense closest hit with the winner's attribute row, material point, the
// smooth BSDF lobes the gate admits (matte, glossy, gltfpbr), the 50/50
// BSDF/light mix with alias light sampling and the exact dense light pdf,
// Russian roulette after bounce 3, clamp_radiance on every finished sample,
// and in-place regeneration until every lane has run its spp samples.
//
// What bounds it on an H100: operations. Per path segment a lane spends
// ~81 f32 operations per scene triangle on the closest hit (the Cornell box
// has 36) and a few hundred more on shading, light sampling and the light
// pdf, against ~50 bytes of device-memory traffic per pixel for the whole
// render (pixel ids in, four accumulators out).
//
// Design. The TPU kernel runs each block of 1024 pixel lanes in lockstep
// over a while-loop, with the intersection as MXU matmuls and every table
// lookup as an exact one-hot matmul (Mosaic has no vector gather). On this
// card each thread owns one pixel lane and runs its own loop with
// data-dependent control flow (the reference's own WGSL design): a lane that
// finishes a sample respawns its next one at once, so the lockstep tail is
// a warp's, not a block's. What held that design back was the closest hit:
// 40 scalar loads per triangle test against ~81 operations, and an IEEE
// divide on every triangle. Now:
// - The triangle table is packed once per matrix (kernels/bvh.py
//   pair_table, B6's layout) into groups of four triangles, (ceil(T/4),
//   40, 4): one 16-byte load reads one coefficient of four triangles, 10
//   loads per triangle, and the four are evaluated together (16
//   independent sums), then folded into the running minimum in index
//   order (the loop of dense_hit.cuh, shared with B1/B2). A block stages
//   the table in shared memory when it is at most TRI_SMEM_TRIS triangles
//   (the Cornell box: 36, 5.8 KB); above that every lane reads the same
//   group at the same time through L1, which serves the broadcast (the
//   gate admits 2,048 triangles, 320 KB, more than a block can hold).
// - The light table (v0, area | e1 | e2 per light triangle, 48 bytes) is
//   packed and staged the same way, for the light pdf's loop over every
//   light triangle and for light sampling.
// - Before the divide a triangle is dropped when its numerators against
//   det already make it invalid (tri_test.cuh, the same test as B6's): it
//   drops only triangles the reference rejects, and only for eps > 0.
// - Occupancy from measurement (tools/prof_mega.py; PERF.md has the
//   sweep, NVIDIA H100 80GB HBM3 at 700 W): asked for at least 1 block
//   per SM, ptxas gives the shared-table build 87 registers (5 blocks of
//   128 threads per SM), asked for none 72 (7 blocks); asking for 8 blocks
//   per SM (64 registers, 36 bytes of spills) was the fastest of those and
//   10, 12 and 16 on the Cornell main path, 10% under 1 block and 5% under
//   none. TRI_SMEM_TRIS keeps 8 blocks' tables in an SM's 228 KB:
//   8 x (20 KB + 3 KB of lights + 1 KB reserved).
// - The lockstep tail: a warp waits for its lane with the most path
//   segments; on the Cornell main path the warps' efficiency (the sum of
//   n_traced over 32 x the sum of each warp's largest) is 90% (chip_smoke
//   prints it), so pixels are not handed to threads dynamically.
// The per-lane code after the closest hit (materials, BSDF, lights, the
// camera, PCG) is shade_common.cuh's, shared with the BVH route's shading
// step (shade.cu).
// Everything is f32 with separately rounded multiplies and adds
// (-fmad=false), IEEE division and square root, i.e. the `precise=True`
// semantics of the Pallas kernel (pallas_mega.py:27-32), not its
// hand-split bf16 products; every sum keeps the plain version's order, so
// the packing changes no bit of the result.
//
// Two modes, one path loop (the kernel's second template argument):
// - acc mode (lupin_mega_pathtrace): the caller passes each lane's pixel id
//   and coordinates and gets back the lane's sample sum and n_traced
//   (integrators.pathtrace_spp's outputs; the sharded samples mode sums
//   them across entries before it blends).
// - dispatch mode (lupin_mega_dispatch): a whole dense render dispatch in
//   one launch. A lane computes its pixel from its index and the tile
//   (render/renderer.py::_pixel_batch's order), and after the path loop
//   writes its pixel of the new image as renderer.py::_accumulate_and_store
//   does (the mean, the clamp, the progressive blend) and, where asked,
//   adds its n_traced to the dispatch's segment count.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_hit.cuh"
#include "shade_common.cuh"
#include "tri_test.cuh"

// Scalar arguments, mirrored by kernels/mega.py::_Params. Outside the
// anonymous namespace: the exported entry point takes a pointer to it.
struct Params {
  float cam[12];
  float lens, film_w, film_h, focus, aperture, res_x, res_y, eps,
      max_radiance, ortho_scale;
  uint32_t accum, seed;
  int sample_offset, spp, max_bounces, use_nee, is_ortho, n_tris, a_stride,
      num_lights, n_light_tris, type_mask, n_pix;
  // The dispatch mode only: the f32 factors of the store (the reciprocal of
  // spp; the previous image's and the new color's blend weights), the
  // tile's origin and width, the image's size, whether lanes take the
  // 16x16-swizzled order, whether the store blends.
  float inv_spp, keep, weight;
  int tile_x, tile_y, tile_w, img_w, img_h, swizzle, blend;
};

namespace {

constexpr int THREADS = 128;
// Largest triangle table staged in shared memory (20 KB).
constexpr int TRI_SMEM_TRIS = 128;

// Packed attribute columns (kernels/dense_intersect.py ATTR_*): the vertex
// normals and the material block (shade_common.cuh's M_* from there).
constexpr int A_N0 = 0, A_N1 = 3, A_N2 = 6, A_MAT_COLOR = 37;

// ---------------------------------------------------------- closest hit ----
// kernels/dense_intersect.py (B2's arithmetic): R = [d, o x d, o, 1] dotted
// with the coefficients in order k = 0..9, strict-< argmin, here over the
// packed (Tg, 40, 4) groups by B1/B2's loop (dense_hit.cuh); padding
// triangles are all zero and never valid.

template <bool SMEM>
__device__ __forceinline__ void closest_hit(const float4* __restrict__ Wg, int Tg, float eps,
                            F3 ro, F3 rd, float& bt, float& bu, float& bv,
                            int& bidx) {
  const F3 c = cross(ro, rd);
  const float r[10] = {rd.x, rd.y, rd.z, c.x, c.y, c.z, ro.x, ro.y, ro.z, 1.0f};
  float bdet = 0.0f;  // not read: ptxas drops it
  bt = F32_MAX;
  bu = 0.0f;
  bv = 0.0f;
  bidx = 0;
  lupin_dense::fold_groups<SMEM>(Wg, 0, Tg, r, eps, eps > 0.0f, bt, bu, bv, bdet, bidx);
}

// ------------------------------------------------------------- material ----
// render/materials.py, attrs route: the winner's attribute row.

__device__ Mat material_point(const float* __restrict__ a) {
  return material_at(a + A_MAT_COLOR);
}

__device__ F3 shading_normal(const float* __restrict__ a, float u, float v) {
  const F3 n0 = f3(__ldg(a + A_N0), __ldg(a + A_N0 + 1), __ldg(a + A_N0 + 2));
  const F3 n1 = f3(__ldg(a + A_N1), __ldg(a + A_N1 + 1), __ldg(a + A_N1 + 2));
  const F3 n2 = f3(__ldg(a + A_N2), __ldg(a + A_N2 + 1), __ldg(a + A_N2 + 2));
  const float w = 1.0f - u - v;
  return normalize(add(add(mul(n0, w), mul(n1, u)), mul(n2, v)));
}

// ---------------------------------------------------------- the kernel ----

// The dispatch mode's pixel of a lane, in renderer.py::_pixel_batch's lane
// order: 16x16 swizzled where both tile dims are multiples of 16
// (p.swizzle), else row-major; px = gy * W + gx in i32.
__device__ __forceinline__ void lane_pixel(const Params& p, int lane, uint32_t& px, int& gx,
                                           int& gy) {
  if (p.swizzle) {
    const int t = lane >> 8, w = lane & 255, ntx = p.tile_w >> 4;
    gx = p.tile_x + (t % ntx) * 16 + (w & 15);
    gy = p.tile_y + (t / ntx) * 16 + (w >> 4);
  } else {
    gx = p.tile_x + lane % p.tile_w;
    gy = p.tile_y + lane / p.tile_w;
  }
  px = (uint32_t)gy * (uint32_t)p.img_w + (uint32_t)gx;
}

// The dispatch mode's outputs.
struct Store {
  const float* prev;          // (H, W, 3) the image blended into, not written
  float* out;                 // (H, W, 3) the new image
  unsigned long long* count;  // the dispatch's segment count, zero before; null: none asked for
  unsigned long long* clear;  // zeroed for the stream's next count (count's other slot)
};

// torch.clamp_min(x, 0) on the card: a NaN stays NaN, else fmaxf.
__device__ __forceinline__ float clamp0(float x) { return isnan(x) ? x : fmaxf(x, 0.0f); }

// renderer.py::_accumulate_and_store for one pixel, at flat index `pix` of
// the image (-1: a lane past the image, in an edge tile, stores nothing):
// color = clamp_min(acc * (1 / spp), 0), the f32 reciprocal multiply
// PyTorch's CUDA division by a host scalar computes; blended,
// clamp_min(prev * keep + color * weight, 0), each product rounded on its
// own (-fmad=false).
__device__ __forceinline__ void store_pixel(const Params& p, const Store& st, int pix, F3 acc) {
  if (pix < 0) return;
  const size_t i = 3 * (size_t)pix;
  const float c[3] = {acc.x, acc.y, acc.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float col = clamp0(c[k] * p.inv_spp);
    if (p.blend) col = clamp0(st.prev[i + k] * p.keep + col * p.weight);
    st.out[i + k] = col;
  }
}

// Dynamic shared memory: the light table (Tl x 48 B), then, with SMEM, the
// triangle table (Tg x 640 B). At least 8 blocks per SM: the fastest
// setting of tools/prof_mega.py's sweep (the note above), which rebuilds
// this file with the second argument changed. DISPATCH selects the mode
// (the note at the top): pix, gxs, gys and the acc outputs serve the acc
// mode, st the dispatch mode.
template <bool SMEM, bool DISPATCH>
__global__ void __launch_bounds__(THREADS, 8)
mega_kernel(Params p, const int* __restrict__ pix, const int* __restrict__ gxs,
            const int* __restrict__ gys, const float4* __restrict__ Wg,
            const float* __restrict__ A, Lights L, float* __restrict__ acc_x,
            float* __restrict__ acc_y, float* __restrict__ acc_z,
            int* __restrict__ n_traced_out, Store st) {
  extern __shared__ __align__(16) float4 tabs[];
  const int Tg = (p.n_tris + 3) / 4;
  const int nl4 = p.n_light_tris * (LIGHT_COLS / 4);
  const float4* lsrc = reinterpret_cast<const float4*>(L.tab);
  for (int i = threadIdx.x; i < nl4; i += THREADS) tabs[i] = __ldg(lsrc + i);
  const float4* W = Wg;
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < Tg * 40; i += THREADS) tabs[nl4 + i] = __ldg(Wg + i);
    W = tabs + nl4;
  }
  __syncthreads();
  const float* lt = reinterpret_cast<const float*>(tabs);

  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= p.n_pix) return;
  int gx, gy;
  uint32_t px;
  int pix_out = -1;  // the dispatch mode's store index, held from here: its
                     // exit needs no more (deriving it there from gx and gy
                     // made the path loop 4.5% slower, PERF.md)
  if constexpr (DISPATCH) {
    lane_pixel(p, lane, px, gx, gy);
    if (gx < p.img_w && gy < p.img_h) pix_out = (int)px;
    if (st.clear != nullptr && lane == 0) *st.clear = 0;
  } else {
    px = (uint32_t)pix[lane];
    gx = gxs[lane];
    gy = gys[lane];
  }
  const bool nee = p.use_nee != 0;
  const bool have_lights = p.num_lights > 0;

  uint32_t s = init_state(px, p.accum, p.seed, (uint32_t)p.sample_offset);
  F3 ro, rd;
  camera_ray(p, gx, gy, s, ro, rd);
  F3 weight = f3(1.0f, 1.0f, 1.0f);
  F3 radiance = f3(0.0f, 0.0f, 0.0f);
  F3 acc = f3(0.0f, 0.0f, 0.0f);
  int bounce = 0, sample_idx = 0, n_traced = 0;

  for (;;) {
    ++n_traced;
    float t, u, v;
    int idx;
    closest_hit<SMEM>(W, Tg, p.eps, ro, rd, t, u, v, idx);
    bool alive = t < F32_MAX;

    if (alive) {
      next_f32(s);  // transmittance draws (stream parity)
      next_f32(s);
      const float* a = A + (size_t)idx * p.a_stride;
      const Mat m = material_point(a);
      const F3 normal = shading_normal(a, u, v);
      shade_hit(p, L, lt, nee, have_lights, m, normal, t, bounce, s, ro, rd, weight,
                radiance, alive);
    }

    const int bounce_next = bounce + 1;
    if (alive && bounce_next <= p.max_bounces) {
      bounce = bounce_next;
      continue;
    }
    // Path done: accumulate, then respawn this pixel's next sample.
    acc = add(acc, clamp_radiance(radiance, p.max_radiance));
    ++sample_idx;
    if (sample_idx >= p.spp) break;
    s = init_state(px, p.accum, p.seed, (uint32_t)(sample_idx + p.sample_offset));
    camera_ray(p, gx, gy, s, ro, rd);
    weight = f3(1.0f, 1.0f, 1.0f);
    radiance = f3(0.0f, 0.0f, 0.0f);
    bounce = 0;
  }
  if constexpr (DISPATCH) {
    store_pixel(p, st, pix_out, acc);
    // The segment count (renderer.py's stats["rays"]), one atomic per lane
    // (the compiler aggregates a warp's): a warp reduction here, with or
    // without a last-block finish, made the path loop 3-4% slower.
    if (st.count != nullptr) atomicAdd(st.count, (unsigned long long)n_traced);
  } else {
    acc_x[lane] = acc.x;
    acc_y[lane] = acc.y;
    acc_z[lane] = acc.z;
    n_traced_out[lane] = n_traced;
  }
}

template <bool SMEM, bool DISPATCH>
int launch_mega(const Params& p, const int* pix, const int* gx, const int* gy,
                const float4* Wg, const float* A, const Lights& L, float* acc_x,
                float* acc_y, float* acc_z, int* n_traced, const Store& st,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * LIGHT_COLS * p.n_light_tris +
                      (SMEM ? sizeof(float4) * 40 * ((p.n_tris + 3) / 4) : 0);
  const int blocks = (p.n_pix + THREADS - 1) / THREADS;
  mega_kernel<SMEM, DISPATCH><<<blocks, THREADS, smem, stream>>>(
      p, pix, gx, gy, Wg, A, L, acc_x, acc_y, acc_z, n_traced, st);
  return (int)cudaGetLastError();
}

// Either mode's launch: the tables' checks, the triangle table's place.
template <bool DISPATCH>
int launch(const Params* params, const int* pix, const int* gx, const int* gy,
           const float* Wg, const float* A, const float* lt, const float* la_thresh,
           const int* la_alias, const int* alias_offset, const int* alias_size,
           const int* tri_offset, float* acc_x, float* acc_y, float* acc_z,
           int* n_traced, const Store& st, void* stream) {
  if ((((uintptr_t)Wg) | ((uintptr_t)lt)) & 15u) return (int)cudaErrorInvalidValue;
  if (params->n_light_tris > 64) return (int)cudaErrorInvalidValue;  // the gate's
  const Lights L{lt, la_thresh, la_alias, alias_offset, alias_size, tri_offset};
  const float4* W4 = reinterpret_cast<const float4*>(Wg);
  const cudaStream_t s = (cudaStream_t)stream;
  if (params->n_tris <= TRI_SMEM_TRIS)
    return launch_mega<true, DISPATCH>(*params, pix, gx, gy, W4, A, L, acc_x, acc_y,
                                       acc_z, n_traced, st, s);
  return launch_mega<false, DISPATCH>(*params, pix, gx, gy, W4, A, L, acc_x, acc_y,
                                      acc_z, n_traced, st, s);
}

}  // namespace

// Wg: the packed triangle table (ceil(n_tris / 4), 40, 4); lt: the packed
// light table (n_light_tris, 12); both 16-byte aligned (kernels/mega.py).
// The acc mode: per lane of the caller's pixel arrays its sample sum and
// n_traced.
extern "C" int lupin_mega_pathtrace(const Params* params, const int* pix,
                                    const int* gx, const int* gy, const float* Wg,
                                    const float* A, const float* lt,
                                    const float* la_thresh, const int* la_alias,
                                    const int* alias_offset, const int* alias_size,
                                    const int* tri_offset, float* acc_x,
                                    float* acc_y, float* acc_z, int* n_traced,
                                    void* stream) {
  return launch<false>(params, pix, gx, gy, Wg, A, lt, la_thresh, la_alias,
                       alias_offset, alias_size, tri_offset, acc_x, acc_y, acc_z,
                       n_traced, Store{}, stream);
}

// The dispatch mode: the tile's pixels of `out` from `prev` (both (H, W, 3)
// f32); with `count` non-null (zero before the launch) the dispatch's
// segment count added there, and `clear`, the slot the stream's next count
// uses, zeroed.
extern "C" int lupin_mega_dispatch(const Params* params, const float* Wg,
                                   const float* A, const float* lt,
                                   const float* la_thresh, const int* la_alias,
                                   const int* alias_offset, const int* alias_size,
                                   const int* tri_offset, const float* prev,
                                   float* out, unsigned long long* count,
                                   unsigned long long* clear, void* stream) {
  return launch<true>(params, nullptr, nullptr, nullptr, Wg, A, lt, la_thresh,
                      la_alias, alias_offset, alias_size, tri_offset, nullptr,
                      nullptr, nullptr, nullptr, Store{prev, out, count, clear},
                      stream);
}
