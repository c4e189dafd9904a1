// The per-lane path-tracing code of kernel B3 (mega.cu) and of the BVH
// route's shading step (shade.cu): f32 vector math, PCG32, the camera ray,
// the material point, the smooth BSDF lobes of the megakernel gate (matte,
// glossy, gltfpbr), light sampling with its exact pdf, clamp_radiance, and
// one bounce at a surface hit (`shade_hit`). Each is the counterpart of the
// port's PyTorch function named beside it, with the same PCG draws in the
// same order; f32 with separately rounded multiplies and adds (-fmad=false),
// IEEE division and square root.
//
// Everything sits in an anonymous namespace: each including source gets its
// own internal copy, so the compiler inlines and allocates as it did when
// this code lived in mega.cu. The functions that read a kernel's scalars take
// its `Params` as a template argument: each source declares its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float F32_MAX = 3.4028235e38f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;  // float(2 * pi)
constexpr float MIN_ROUGHNESS = (float)(0.03 * 0.03);
constexpr int LIGHT_COLS = 12;  // v0.xyz, area, e1.xyz, 0, e2.xyz, 0

// Material types (core/types.py).
constexpr int MATTE = 0, GLOSSY = 1, REFLECTIVE = 2, TRANSPARENT = 3,
              REFRACTIVE = 4, VOLUMETRIC = 6, GLTFPBR = 7;
// A material's columns from the start of its block: the attribute row's
// material block (kernels/dense_intersect.py, ATTR_MAT_COLOR at column 37
// to ATTR_MAT_IOR) and a row of kernels/shade.py's material table.
constexpr int M_COLOR = 0, M_EMISSION = 4, M_TYPE = 10, M_ROUGHNESS = 11,
              M_METALLIC = 12, M_IOR = 13;

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

template <class P>
__device__ void camera_ray(const P& p, int gx, int gy, uint32_t& s, F3& ro_w,
                           F3& rd_w) {
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

// ------------------------------------------------------------- material ----
// render/materials.py inside the megakernel gate (no textures, vertex
// colours, normal maps or volumes): the material's fields, the roughness
// squared and cleaned up.

struct Mat {
  int type;
  F3 emission, color;
  float roughness, metallic, ior;
};

// The material whose block starts at `b` (M_* columns).
__device__ Mat material_at(const float* __restrict__ b) {
  Mat m;
  m.type = (int)__ldg(b + M_TYPE);
  m.emission = f3(__ldg(b + M_EMISSION), __ldg(b + M_EMISSION + 1),
                  __ldg(b + M_EMISSION + 2));
  m.color = f3(__ldg(b + M_COLOR), __ldg(b + M_COLOR + 1), __ldg(b + M_COLOR + 2));
  float rough = __ldg(b + M_ROUGHNESS);
  rough = rough * rough;
  const bool clamped = m.type == MATTE || m.type == GLTFPBR || m.type == GLOSSY;
  if (clamped)
    rough = clampf(rough, MIN_ROUGHNESS, 1.0f);
  else if (m.type == VOLUMETRIC)
    rough = 0.0f;
  else if (rough < MIN_ROUGHNESS)
    rough = 0.0f;
  m.roughness = rough;
  m.metallic = __ldg(b + M_METALLIC);
  m.ior = __ldg(b + M_IOR);
  return m;
}

__device__ bool is_delta(const Mat& m) {
  const bool r0 = m.roughness == 0.0f;
  return ((m.type == REFLECTIVE || m.type == REFRACTIVE || m.type == TRANSPARENT) && r0) ||
         m.type == VOLUMETRIC;
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

template <class P>
__device__ F3 sample_light(const P& p, const Lights& L, const float* lt, F3 pos,
                           uint32_t& s) {
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
template <class P>
__device__ float lights_pdf(const P& p, const float* lt, F3 pos, F3 inc) {
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

// ------------------------------------------------------------ a bounce ----
// render/integrators.py::clamp_radiance, on every finished sample.
__device__ F3 clamp_radiance(F3 r, float max_radiance) {
  if (!is_finite3(r)) r = f3(0.0f, 0.0f, 0.0f);
  const float peak = max_comp(r);
  const float scale = peak > max_radiance ? max_radiance / cmin_lo(peak, 1e-20f) : 1.0f;
  return mul(r, scale);
}

// One bounce of a lane whose ray hit, at distance t, a surface of material
// m with shading normal `normal` (render/integrators.py::_pathtrace_snd's
// shade block inside the megakernel gate, after the two transmittance draws,
// which are the caller's): the emission, the 50/50 BSDF/light mix (`nee`,
// STANDARD) or BSDF sampling (NAIVE), the weight, the delta draw kept for
// stream parity, the continuation ray into ro and rd, then the weight's
// viability and Russian roulette after bounce 3 (_Path.end_of_bounce).
// `alive` is true on entry and false on return where the path ends.
template <class P>
__device__ __forceinline__ void shade_hit(const P& p, const Lights& L, const float* lt,
                                          bool nee, bool have_lights, const Mat& m,
                                          F3 normal, float t, int bounce, uint32_t& s,
                                          F3& ro, F3& rd, F3& weight, F3& radiance,
                                          bool& alive) {
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

}  // namespace
