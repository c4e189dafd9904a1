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
// Everything is f32 with separately rounded multiplies and adds
// (-fmad=false), IEEE division and square root, i.e. the `precise=True`
// semantics of the Pallas kernel (pallas_mega.py:27-32), not its
// hand-split bf16 products; every sum keeps the plain version's order, so
// the packing changes no bit of the result.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_hit.cuh"
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
};

namespace {

constexpr float F32_MAX = 3.4028235e38f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;  // float(2 * pi)
constexpr float MIN_ROUGHNESS = (float)(0.03 * 0.03);
constexpr int THREADS = 128;
// Largest triangle table staged in shared memory (20 KB).
constexpr int TRI_SMEM_TRIS = 128;
constexpr int LIGHT_COLS = 12;  // v0.xyz, area, e1.xyz, 0, e2.xyz, 0

// Material types (core/types.py) and packed attribute columns
// (kernels/dense_intersect.py ATTR_*).
constexpr int MATTE = 0, GLOSSY = 1, REFLECTIVE = 2, TRANSPARENT = 3,
              REFRACTIVE = 4, VOLUMETRIC = 6, GLTFPBR = 7;
constexpr int A_N0 = 0, A_N1 = 3, A_N2 = 6, A_MAT_COLOR = 37,
              A_MAT_EMISSION = 41, A_MAT_TYPE = 47, A_MAT_ROUGHNESS = 48,
              A_MAT_METALLIC = 49, A_MAT_IOR = 50;

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ F3 f3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ F3 add(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 sub(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ F3 mul(F3 a, F3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ F3 mul(F3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ F3 neg(F3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(F3 a, F3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ bool all_zero(F3 a) { return a.x == 0.0f && a.y == 0.0f && a.z == 0.0f; }
__device__ __forceinline__ bool is_finite3(F3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
// torch.clamp_min / clamp_max / maximum semantics: a NaN stays NaN.
__device__ __forceinline__ float cmin_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float cmax_hi(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return cmax_hi(cmin_lo(x, lo), hi);
}
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float max_comp(F3 a) { return nanmax(a.x, nanmax(a.y, a.z)); }
__device__ __forceinline__ float zero_nonfinite(float x) { return isfinite(x) ? x : 0.0f; }
__device__ __forceinline__ F3 normalize(F3 a) {
  const float n = cmin_lo(sqrtf(dot(a, a)), 1e-20f);
  return {a.x / n, a.y / n, a.z / n};
}

// ---------------------------------------------------------------- PCG32 ----
// core/rng.py: same constants, same output permutation, same u32 -> f32
// mapping through the i32 reinterpretation.

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = x ^ (x >> 17);
  x = x * 0xED5AD4BBu;
  x = x ^ (x >> 11);
  x = x * 0xAC4C1B51u;
  x = x ^ (x >> 15);
  x = x * 0x31848BABu;
  x = x ^ (x >> 14);
  return x;
}

__device__ __forceinline__ uint32_t init_state(uint32_t pix, uint32_t accum,
                                               uint32_t seed, uint32_t sample) {
  return hash_u32((pix * 19349663u) ^ (accum * 83492791u) ^
                  (seed * 73856093u) ^ (sample * 2654435769u));
}

__device__ __forceinline__ float next_f32(uint32_t& s) {
  s = s * 747796405u + 2891336453u;
  uint32_t word = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  word = (word >> 22) ^ word;
  const int wi = (int)word;
  float f = (float)wi;
  if (wi < 0) f = f + 4294967296.0f;
  return f / 4294967296.0f;  // 4294967295 rounds to 2^32 in f32
}

// --------------------------------------------------------------- camera ----
// render/camera.py::compute_camera_ray.

__device__ void camera_ray(const Params& p, int gx, int gy, uint32_t& s,
                           F3& ro_w, F3& rd_w) {
  const float ox = next_f32(s) - 0.5f;
  const float oy = next_f32(s) - 0.5f;
  const float px = (float)gx + 0.5f;
  const float py = p.res_y - (float)gy + 0.5f;
  const float u = (px + ox) / p.res_x;
  const float v = (py + oy) / p.res_y;
  // next_in_disk
  const float rx = next_f32(s);
  const float ry = next_f32(s);
  const float r = sqrtf(ry);
  const float phi = TWO_PI_F * rx;
  const float dx = cosf(phi) * r;
  const float dy = sinf(phi) * r;
  F3 ro, rd;
  if (p.is_ortho) {
    const float qx = p.film_w * (0.5f - u) * p.ortho_scale;
    const float qy = p.film_h * (0.5f - v) * p.ortho_scale;
    const F3 e = f3(-qx + dx * p.aperture / 2.0f, -qy + dy * p.aperture / 2.0f, 0.0f);
    const F3 q = f3(-qx, -qy, -p.focus);
    F3 d = normalize(sub(q, e));
    ro = e;
    rd = f3(d.x, d.y, -d.z);
  } else {
    const float qx = p.film_w * (0.5f - u);
    const float qy = p.film_h * (0.5f - v);
    const float qz = p.lens;
    const float qlen = sqrtf(qx * qx + qy * qy + qz * qz);
    const F3 look = f3(-qx / qlen, -qy / qlen, -qz / qlen);
    const F3 lp = f3(dx * p.aperture / 2.0f, dy * p.aperture / 2.0f, 0.0f);
    const float fscale = p.focus / fabsf(look.z);
    const F3 fp = mul(look, fscale);
    F3 d = normalize(sub(fp, lp));
    ro = lp;
    rd = f3(d.x, d.y, -d.z);
  }
  const float* m = p.cam;
  ro_w = f3(m[0] * ro.x + m[1] * ro.y + m[2] * ro.z + m[3],
            m[4] * ro.x + m[5] * ro.y + m[6] * ro.z + m[7],
            m[8] * ro.x + m[9] * ro.y + m[10] * ro.z + m[11]);
  rd_w = normalize(f3(m[0] * rd.x + m[1] * rd.y + m[2] * rd.z,
                      m[4] * rd.x + m[5] * rd.y + m[6] * rd.z,
                      m[8] * rd.x + m[9] * rd.y + m[10] * rd.z));
}

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
// render/materials.py, attrs route, inside the mega gate: no textures,
// vertex colours, normal maps or volumes.

struct Mat {
  int type;
  F3 emission, color;
  float roughness, metallic, ior;
};

__device__ Mat material_point(const float* __restrict__ a) {
  Mat m;
  m.type = (int)__ldg(a + A_MAT_TYPE);
  m.emission = f3(__ldg(a + A_MAT_EMISSION), __ldg(a + A_MAT_EMISSION + 1),
                  __ldg(a + A_MAT_EMISSION + 2));
  m.color = f3(__ldg(a + A_MAT_COLOR), __ldg(a + A_MAT_COLOR + 1),
               __ldg(a + A_MAT_COLOR + 2));
  float rough = __ldg(a + A_MAT_ROUGHNESS);
  rough = rough * rough;
  const bool clamped = m.type == MATTE || m.type == GLTFPBR || m.type == GLOSSY;
  if (clamped)
    rough = clampf(rough, MIN_ROUGHNESS, 1.0f);
  else if (m.type == VOLUMETRIC)
    rough = 0.0f;
  else if (rough < MIN_ROUGHNESS)
    rough = 0.0f;
  m.roughness = rough;
  m.metallic = __ldg(a + A_MAT_METALLIC);
  m.ior = __ldg(a + A_MAT_IOR);
  return m;
}

__device__ bool is_delta(const Mat& m) {
  const bool r0 = m.roughness == 0.0f;
  return ((m.type == REFLECTIVE || m.type == REFRACTIVE || m.type == TRANSPARENT) && r0) ||
         m.type == VOLUMETRIC;
}

__device__ F3 shading_normal(const float* __restrict__ a, float u, float v) {
  const F3 n0 = f3(__ldg(a + A_N0), __ldg(a + A_N0 + 1), __ldg(a + A_N0 + 2));
  const F3 n1 = f3(__ldg(a + A_N1), __ldg(a + A_N1 + 1), __ldg(a + A_N1 + 2));
  const F3 n2 = f3(__ldg(a + A_N2), __ldg(a + A_N2 + 1), __ldg(a + A_N2 + 2));
  const float w = 1.0f - u - v;
  return normalize(add(add(mul(n0, w), mul(n1, u)), mul(n2, v)));
}

// ----------------------------------------------------------------- BSDF ----
// render/bsdf.py, the smooth lobes of the gate's material types.

__device__ F3 flip_up(F3 n, F3 o) { return dot(n, o) <= 0.0f ? neg(n) : n; }

__device__ F3 reflect(F3 w, F3 n) { return add(neg(w), mul(n, 2.0f * dot(n, w))); }

__device__ bool same_hemisphere(F3 n, F3 o, F3 i) { return dot(n, o) * dot(n, i) >= 0.0f; }

__device__ void basis_fromz(F3 v, F3& x, F3& y, F3& z) {
  z = normalize(v);
  const float sign = z.z < 0.0f ? -1.0f : 1.0f;
  const float a = -1.0f / (sign + z.z);
  const float b = z.x * z.y * a;
  x = f3(1.0f + sign * z.x * z.x * a, sign * b, -sign * z.x);
  y = f3(b, sign + z.y * z.y * a, -z.y);
}

__device__ F3 from_basis(F3 x, F3 y, F3 z, float lx, float ly, float lz) {
  return add(add(mul(x, lx), mul(y, ly)), mul(z, lz));
}

__device__ float fresnel_dielectric(float eta, F3 n, F3 o) {
  const float cosw = fabsf(dot(n, o));
  const float sin2 = 1.0f - cosw * cosw;
  const float eta2 = eta * eta;
  const float cos2t = 1.0f - sin2 / eta2;
  const float t0 = sqrtf(cmin_lo(cos2t, 0.0f));
  const float t1 = eta * t0;
  const float t2 = eta * cosw;
  const float rs = (cosw - t1) / (cosw + t1);
  const float rp = (t0 - t2) / (t0 + t2);
  const float f = (rs * rs + rp * rp) / 2.0f;
  return cos2t < 0.0f ? 1.0f : f;
}

__device__ F3 fresnel_schlick(F3 color, F3 n, F3 o) {
  const float cosine = dot(n, o);
  const float p = powf(clampf(1.0f - fabsf(cosine), 0.0f, 1.0f), 5.0f);
  const F3 f = f3(color.x + (1.0f - color.x) * p, color.y + (1.0f - color.y) * p,
                  color.z + (1.0f - color.z) * p);
  return all_zero(color) ? f3(0.0f, 0.0f, 0.0f) : f;
}

__device__ F3 gltf_reflectivity(const Mat& m) {
  const float r0 = ((m.ior - 1.0f) * (m.ior - 1.0f)) / ((m.ior + 1.0f) * (m.ior + 1.0f));
  return f3(r0 * (1.0f - m.metallic) + m.color.x * m.metallic,
            r0 * (1.0f - m.metallic) + m.color.y * m.metallic,
            r0 * (1.0f - m.metallic) + m.color.z * m.metallic);
}

__device__ float microfacet_distribution(float rough, F3 n, F3 h) {
  const float cosine = dot(n, h);
  const float r2 = rough * rough;
  const float c2 = cosine * cosine;
  const float denom = c2 * r2 + 1.0f - c2;
  const float d = r2 / (PI_F * denom * denom);
  return cosine <= 0.0f ? 0.0f : d;
}

__device__ float shadowing1(float rough, F3 n, F3 h, F3 dir) {
  const float cosine = dot(n, dir);
  const float cosineh = dot(h, dir);
  const float r2 = rough * rough;
  const float c2 = cosine * cosine;
  const float g = 2.0f * fabsf(cosine) /
                  (fabsf(cosine) + sqrtf(cmin_lo(c2 - r2 * c2 + r2, 0.0f)));
  return cosine * cosineh <= 0.0f ? 0.0f : g;
}

__device__ float shadowing(float rough, F3 n, F3 h, F3 o, F3 i) {
  return shadowing1(rough, n, h, o) * shadowing1(rough, n, h, i);
}

__device__ F3 sample_microfacet(float rough, F3 n, float rx, float ry) {
  const float phi = TWO_PI_F * rx;
  const float theta = atanf(rough * sqrtf(ry / cmin_lo(1.0f - ry, 1e-12f)));
  const float st = sinf(theta);
  F3 x, y, z;
  basis_fromz(n, x, y, z);
  return normalize(from_basis(x, y, z, cosf(phi) * st, sinf(phi) * st, cosf(theta)));
}

__device__ float sample_microfacet_pdf(float rough, F3 n, F3 h) {
  const float cosine = dot(n, h);
  return cosine < 0.0f ? 0.0f : microfacet_distribution(rough, n, h) * cosine;
}

__device__ F3 sample_hemisphere_cos(F3 n, float rx, float ry) {
  const float z = sqrtf(ry);
  const float r = sqrtf(cmin_lo(1.0f - z * z, 0.0f));
  const float phi = TWO_PI_F * rx;
  F3 bx, by, bz;
  basis_fromz(n, bx, by, bz);
  return normalize(from_basis(bx, by, bz, r * cosf(phi), r * sinf(phi), z));
}

__device__ float sample_hemisphere_cos_pdf(F3 n, F3 d) {
  const float cosw = dot(n, d);
  return cosw <= 0.0f ? 0.0f : cosw / PI_F;
}

// The lobe a lane takes: its own type when the scene has it, else the
// first present type (bsdf._dispatch: a select chain over present types).
__device__ int lobe(int type, int mask) {
  if (mask & (1 << type)) return type;
  return __ffs(mask) - 1;
}

__device__ F3 sample_bsdfcos(const Mat& m, int mask, F3 n, F3 o, float rnl,
                             float rx, float ry) {
  const F3 zero = f3(0.0f, 0.0f, 0.0f);
  if (m.roughness == 0.0f) return zero;
  const F3 up = flip_up(n, o);
  const int t = lobe(m.type, mask);
  if (t == MATTE) return sample_hemisphere_cos(up, rx, ry);
  float f;
  if (t == GLOSSY) {
    f = fresnel_dielectric(m.ior, up, o);
  } else {  // GLTFPBR
    const F3 fs = fresnel_schlick(gltf_reflectivity(m), up, o);
    f = (fs.x + fs.y + fs.z) / 3.0f;
  }
  const F3 h = sample_microfacet(m.roughness, up, rx, ry);
  F3 refl = reflect(o, h);
  refl = same_hemisphere(up, o, refl) ? refl : zero;
  const F3 diff = sample_hemisphere_cos(up, rx, ry);
  return rnl < f ? refl : diff;
}

__device__ F3 eval_bsdfcos(const Mat& m, int mask, F3 n, F3 o, F3 i) {
  const F3 zero = f3(0.0f, 0.0f, 0.0f);
  if (m.roughness == 0.0f) return zero;
  const bool masked = dot(n, i) * dot(n, o) <= 0.0f;
  const int t = lobe(m.type, mask);
  F3 out;
  if (t == MATTE) {
    out = mul(m.color, fabsf(dot(n, i)) / PI_F);
  } else if (t == GLOSSY) {
    const F3 up = flip_up(n, o);
    const float f1 = fresnel_dielectric(m.ior, up, o);
    const F3 h = normalize(add(i, o));
    const float f = fresnel_dielectric(m.ior, h, i);
    const float d = microfacet_distribution(m.roughness, up, h);
    const float g = shadowing(m.roughness, up, h, o, i);
    const float absin = fabsf(dot(up, i));
    const float spec = f * d * g / (4.0f * dot(up, o) * dot(up, i)) * absin;
    const float k = (1.0f - f1) / PI_F * absin;
    out = f3(m.color.x * k + spec, m.color.y * k + spec, m.color.z * k + spec);
  } else {  // GLTFPBR
    const F3 refl = gltf_reflectivity(m);
    const F3 up = flip_up(n, o);
    const F3 f1 = fresnel_schlick(refl, up, o);
    const F3 h = normalize(add(i, o));
    const F3 f = fresnel_schlick(refl, h, i);
    const float d = microfacet_distribution(m.roughness, up, h);
    const float g = shadowing(m.roughness, up, h, o, i);
    const float absin = fabsf(dot(up, i));
    const float cosk = absin / PI_F;
    const float sk = d * g / (4.0f * dot(up, o) * dot(up, i)) * absin;
    const float dm = 1.0f - m.metallic;
    out = f3(m.color.x * dm * (1.0f - f1.x) * cosk + f.x * sk,
             m.color.y * dm * (1.0f - f1.y) * cosk + f.y * sk,
             m.color.z * dm * (1.0f - f1.z) * cosk + f.z * sk);
  }
  if (masked) out = zero;
  return f3(zero_nonfinite(out.x), zero_nonfinite(out.y), zero_nonfinite(out.z));
}

__device__ float sample_bsdfcos_pdf(const Mat& m, int mask, F3 n, F3 o, F3 i) {
  if (m.roughness == 0.0f) return 0.0f;
  const bool masked = dot(n, i) * dot(n, o) <= 0.0f;
  const F3 up = flip_up(n, o);
  const int t = lobe(m.type, mask);
  float p;
  if (t == MATTE) {
    p = sample_hemisphere_cos_pdf(up, i);
  } else {
    const F3 h = normalize(add(o, i));
    float f;
    if (t == GLOSSY) {
      f = fresnel_dielectric(m.ior, up, o);
    } else {  // GLTFPBR
      const F3 fs = fresnel_schlick(gltf_reflectivity(m), up, o);
      f = (fs.x + fs.y + fs.z) / 3.0f;
    }
    p = f * sample_microfacet_pdf(m.roughness, up, h) / (4.0f * fabsf(dot(o, h))) +
        (1.0f - f) * sample_hemisphere_cos_pdf(up, i);
  }
  if (masked) p = 0.0f;
  return zero_nonfinite(p);
}

// --------------------------------------------------------------- lights ----
// render/lights.py: uniform light pick, alias triangle pick, uniform point
// on the triangle; the pdf is the exact sum over all light triangles.

struct Lights {
  const float* tab;  // (Tl, LIGHT_COLS) packed light table, staged per block
  const float* thresh;
  const int* alias;
  const int* alias_offset;  // (L,)
  const int* alias_size;
  const int* tri_offset;
};

// Light triangle i's v0, e1, e2 and its light's area from the packed row.
__device__ __forceinline__ void light_tri(const float* row, F3& v0, F3& e1,
                                          F3& e2, float& area) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  const float4 c = *reinterpret_cast<const float4*>(row + 8);
  v0 = f3(a.x, a.y, a.z);
  area = a.w;
  e1 = f3(b.x, b.y, b.z);
  e2 = f3(c.x, c.y, c.z);
}

__device__ F3 sample_light(const Params& p, const Lights& L, const float* lt,
                           F3 pos, uint32_t& s) {
  const int nl = p.num_lights;
  const float r_pick = next_f32(s);
  const int pick = min((int)(r_pick * (float)nl), nl - 1);
  const float r_bin = next_f32(s);
  const float r_thr = next_f32(s);
  const float ra = next_f32(s);
  const float rb = next_f32(s);
  const int li = max(0, min(pick, nl - 1));
  const int off = __ldg(L.alias_offset + li);
  const int size = __ldg(L.alias_size + li);
  const int idx = min((int)(r_bin * (float)size), size - 1);
  const int gi = off + idx;
  const int tri = r_thr >= __ldg(L.thresh + gi) ? __ldg(L.alias + gi) : idx;
  const float sq = sqrtf(ra);
  const float tu = 1.0f - sq;
  const float tv = rb * sq;
  const int gt = __ldg(L.tri_offset + li) + tri;
  F3 v0, e1, e2;
  float area;
  light_tri(lt + (size_t)gt * LIGHT_COLS, v0, e1, e2, area);
  const F3 q = add(add(v0, mul(e1, tu)), mul(e2, tv));
  return normalize(sub(q, pos));
}

// intersect._ray_tri per light triangle, summed in triangle order.
__device__ float lights_pdf(const Params& p, const float* lt, F3 pos, F3 inc) {
  const int Tl = p.n_light_tris;
  float pdf = 0.0f;
  for (int i = 0; i < Tl; ++i) {
    F3 v0, e1, e2;
    float area;
    light_tri(lt + i * LIGHT_COLS, v0, e1, e2, area);
    const F3 n = cross(e1, e2);
    const F3 rov0 = sub(pos, v0);
    const F3 q = cross(rov0, inc);
    const float det = dot(inc, n);
    const float d = 1.0f / det;
    const float u = d * -dot(q, e2);
    const float v = d * dot(q, e1);
    float t = d * -dot(n, rov0);
    const bool valid = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t >= p.eps);
    t = valid ? t : F32_MAX;
    const F3 n_hat = normalize(n);
    const float cos_theta = fabsf(dot(inc, n_hat));
    const float term = (t * t) / cmin_lo(cos_theta * area, 1e-20f);
    pdf = pdf + (valid ? term : 0.0f);
  }
  return pdf / (float)p.num_lights;
}

// ---------------------------------------------------------- the kernel ----

__device__ F3 clamp_radiance(F3 r, float max_radiance) {
  if (!is_finite3(r)) r = f3(0.0f, 0.0f, 0.0f);
  const float peak = max_comp(r);
  const float scale = peak > max_radiance ? max_radiance / cmin_lo(peak, 1e-20f) : 1.0f;
  return mul(r, scale);
}

// Dynamic shared memory: the light table (Tl x 48 B), then, with SMEM, the
// triangle table (Tg x 640 B). At least 8 blocks per SM: the fastest
// setting of tools/prof_mega.py's sweep (the note above), which rebuilds
// this file with the second argument changed.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS, 8)
mega_kernel(Params p, const int* __restrict__ pix, const int* __restrict__ gxs,
            const int* __restrict__ gys, const float4* __restrict__ Wg,
            const float* __restrict__ A, Lights L, float* __restrict__ acc_x,
            float* __restrict__ acc_y, float* __restrict__ acc_z,
            int* __restrict__ n_traced_out) {
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
  const uint32_t px = (uint32_t)pix[lane];
  const int gx = gxs[lane];
  const int gy = gys[lane];
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
      const F3 outgoing = neg(rd);
      const F3 pos = add(ro, mul(rd, t));
      radiance = add(radiance, mul(weight, m.emission));
      const bool nd = !is_delta(m);

      const float r_choice = next_f32(s);
      const float rnl = next_f32(s);
      const float rx = next_f32(s);
      const float ry = next_f32(s);
      const F3 bdir = sample_bsdfcos(m, p.type_mask, normal, outgoing, rnl, rx, ry);
      F3 incoming;
      float pdf;
      if (nee) {
        const F3 ldir = have_lights ? sample_light(p, L, lt, pos, s) : f3(0.0f, 0.0f, 0.0f);
        incoming = r_choice < 0.5f ? bdir : ldir;
        const float lp = have_lights ? lights_pdf(p, lt, pos, incoming) : 0.0f;
        pdf = 0.5f * sample_bsdfcos_pdf(m, p.type_mask, normal, outgoing, incoming) +
              0.5f * lp;
      } else {
        incoming = bdir;
        pdf = sample_bsdfcos_pdf(m, p.type_mask, normal, outgoing, incoming);
      }
      const bool dead = all_zero(incoming);
      const F3 f = eval_bsdfcos(m, p.type_mask, normal, outgoing, incoming);
      const float pc = cmin_lo(pdf, 0.0f);
      const F3 factor = f3(f.x / pc, f.y / pc, f.z / pc);
      if (nd && dead) alive = false;
      if (nd && !dead) weight = mul(weight, factor);
      next_f32(s);  // delta draw (stream parity)
      if (!nd) incoming = f3(0.0f, 0.0f, 0.0f);  // no delta lobes in the gate
      if (alive) {
        ro = pos;
        rd = incoming;
      }
      alive = alive && !all_zero(weight) && is_finite3(weight);
      const float rr = next_f32(s);
      const bool rr_on = alive && bounce > 3;
      const float survive = cmax_hi(max_comp(weight), 0.99f);
      if (rr_on && rr >= survive) alive = false;
      if (rr_on && rr < survive) {
        const float sv = cmin_lo(survive, 1e-12f);
        weight = f3(weight.x / sv, weight.y / sv, weight.z / sv);
      }
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
  acc_x[lane] = acc.x;
  acc_y[lane] = acc.y;
  acc_z[lane] = acc.z;
  n_traced_out[lane] = n_traced;
}

template <bool SMEM>
int launch_mega(const Params& p, const int* pix, const int* gx, const int* gy,
                const float4* Wg, const float* A, const Lights& L, float* acc_x,
                float* acc_y, float* acc_z, int* n_traced, cudaStream_t stream) {
  const size_t smem = sizeof(float) * LIGHT_COLS * p.n_light_tris +
                      (SMEM ? sizeof(float4) * 40 * ((p.n_tris + 3) / 4) : 0);
  const int blocks = (p.n_pix + THREADS - 1) / THREADS;
  mega_kernel<SMEM><<<blocks, THREADS, smem, stream>>>(
      p, pix, gx, gy, Wg, A, L, acc_x, acc_y, acc_z, n_traced);
  return (int)cudaGetLastError();
}

}  // namespace

// Wg: the packed triangle table (ceil(n_tris / 4), 40, 4); lt: the packed
// light table (n_light_tris, 12); both 16-byte aligned (kernels/mega.py).
extern "C" int lupin_mega_pathtrace(const Params* params, const int* pix,
                                    const int* gx, const int* gy, const float* Wg,
                                    const float* A, const float* lt,
                                    const float* la_thresh, const int* la_alias,
                                    const int* alias_offset, const int* alias_size,
                                    const int* tri_offset, float* acc_x,
                                    float* acc_y, float* acc_z, int* n_traced,
                                    void* stream) {
  if ((((uintptr_t)Wg) | ((uintptr_t)lt)) & 15u) return (int)cudaErrorInvalidValue;
  if (params->n_light_tris > 64) return (int)cudaErrorInvalidValue;  // the gate's
  const Lights L{lt, la_thresh, la_alias, alias_offset, alias_size, tri_offset};
  const float4* W4 = reinterpret_cast<const float4*>(Wg);
  const cudaStream_t st = (cudaStream_t)stream;
  if (params->n_tris <= TRI_SMEM_TRIS)
    return launch_mega<true>(*params, pix, gx, gy, W4, A, L, acc_x, acc_y, acc_z,
                             n_traced, st);
  return launch_mega<false>(*params, pix, gx, gy, W4, A, L, acc_x, acc_y, acc_z,
                            n_traced, st);
}
