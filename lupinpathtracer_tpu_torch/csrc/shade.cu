// The BVH route's shading step: one launch a loop iteration of
// render/integrators.py::_pathtrace_snd (STANDARD and NAIVE, with path
// regeneration), between two wavefront traces.
//
// The plain version it is held against is that loop's PyTorch step, which
// kernels/shade.py runs for tensors on the CPU: from each lane's hit record
// (the closest hit, its distance, and the wavefront's interpolated
// attributes: the shading normal and the material id of kernels/intersect.py
// InterpAttrs) and its loop state, the `shade` block (emission, material
// point, shading normal, the 50/50 BSDF/light mix with its light pdf or
// plain BSDF sampling, the delta draw), _Path.end_of_bounce (the weight's
// viability, Russian roulette after bounce 3, the end of the path and the
// respawn of the pixel's next sample with its camera ray) and the
// regeneration half of _Path.advance (clamp_radiance into acc, the resets),
// then the count of slot A's rays. It writes slot A's ray, the state and the
// mask in place for the next trace. A second entry computes every lane's
// first sample (its state and camera ray) ahead of the loop.
//
// Per-lane semantics are B3's (mega.cu), whose per-lane code this kernel
// shares (shade_common.cuh): the same PCG draws in the same order, f32 with
// separately rounded multiplies and adds (-fmad=false), IEEE division and
// square root. The plain step draws on every lane, alive or not, so a lane
// whose path is not alive at this bounce draws as many numbers as a shaded
// one and uses none of them: every (pixel, sample) stream stays the plain
// step's.
//
// What bounds it on an H100: bytes. A lane reads its hit record (13 bytes
// with the attributes it uses), its state (~100 bytes: the ray, the weight,
// the radiance, the counters, the PCG state and the mask) and its pixel, and
// writes ~70 bytes back; the acc rows only where a sample ends. Its
// arithmetic (one bounce's BSDF and light math, ~500 f32 operations) is
// about a tenth of the memory time at 3.35 TB/s against 67 TFLOP/s.
//
// The lanes' state lives in two row-major buffers that kernels/shade.py
// owns for the loop (F_* rows of f32, C_* rows of int32), so a launch takes
// two pointers for it and every access is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_common.cuh"

// Scalar arguments, mirrored by kernels/shade.py::_Params: the fields of
// mega.cu's Params that the shared code reads, and the lane count. Outside
// the anonymous namespace: the exported entry point takes a pointer to it.
struct Params {
  float cam[12];
  float lens, film_w, film_h, focus, aperture, res_x, res_y, eps,
      max_radiance, ortho_scale;
  uint32_t accum, seed;
  int sample_offset, spp, max_bounces, use_nee, is_ortho, num_lights,
      n_light_tris, type_mask, n_pix;
};

// The lanes' arrays, each of n_pix entries (the state buffers n_pix a row),
// mirrored by kernels/shade.py::_Lanes.
struct Lanes {
  const bool* hit;  // the hit record: hit or miss, the distance
  const float* dst;
  const float* nx;  // InterpAttrs.n, the interpolated shading normal
  const float* ny;
  const float* nz;
  const int* mat_id;          // InterpAttrs.mat_id
  const int* pix;             // the lane's pixel id and coordinates
  const int* gx;
  const int* gy;
  const long long* offs;      // per-lane sample offsets, or null: Params.sample_offset
  float* f;                   // (F_ROWS, n_pix) f32 state
  int* c;                     // (C_ROWS, n_pix) int32 state
  long long* state;           // the u32 PCG state, held in int64
  bool* alive;                // the lane's path is alive (slot A's mask)
};

namespace {

constexpr int THREADS = 256;
constexpr int MAT_COLS = 16;  // kernels/shade.py's material table
// Rows of the state buffers (kernels/shade.py F_*, C_*).
constexpr int F_RO = 0, F_RD = 3, F_WEIGHT = 6, F_RADIANCE = 9, F_ACC = 12;
constexpr int C_BOUNCE = 0, C_SAMPLE = 1, C_N_BOUNCES = 2, C_N_TRACED = 3;

__device__ __forceinline__ F3 load3(const float* f, int row, int n, int lane) {
  return f3(f[(size_t)row * n + lane], f[(size_t)(row + 1) * n + lane],
            f[(size_t)(row + 2) * n + lane]);
}

__device__ __forceinline__ void store3(float* f, int row, int n, int lane, F3 v) {
  f[(size_t)row * n + lane] = v.x;
  f[(size_t)(row + 1) * n + lane] = v.y;
  f[(size_t)(row + 2) * n + lane] = v.z;
}

// Every lane's first sample: its PCG state and camera ray into the state
// and the ro and rd rows (the rays of the loop's first trace). The loop's
// camera rays are then all this file's, whichever of a pixel's sample
// streams spawns them.
__global__ void __launch_bounds__(THREADS) lupin_shade_kernel_first(Params p, Lanes ln) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= p.n_pix) return;
  const long long off = ln.offs != nullptr ? ln.offs[lane] : (long long)p.sample_offset;
  uint32_t s = init_state((uint32_t)ln.pix[lane], p.accum, p.seed, (uint32_t)off);
  F3 ro, rd;
  camera_ray(p, ln.gx[lane], ln.gy[lane], s, ro, rd);
  ln.state[lane] = (long long)s;
  store3(ln.f, F_RO, p.n_pix, lane, ro);
  store3(ln.f, F_RD, p.n_pix, lane, rd);
}

// One shading step. Dynamic shared memory: the light table (Tl x 48 B), as
// B3 stages it.
__global__ void __launch_bounds__(THREADS)
lupin_shade_kernel(Params p, Lanes ln, const float* __restrict__ mats, Lights L) {
  extern __shared__ __align__(16) float4 tabs[];
  const int nl4 = p.n_light_tris * (LIGHT_COLS / 4);
  const float4* lsrc = reinterpret_cast<const float4*>(L.tab);
  for (int i = threadIdx.x; i < nl4; i += THREADS) tabs[i] = __ldg(lsrc + i);
  __syncthreads();
  const float* lt = reinterpret_cast<const float*>(tabs);

  const int n = p.n_pix;
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const bool nee = p.use_nee != 0;
  const bool have_lights = p.num_lights > 0;
  int* c = ln.c;

  uint32_t s = (uint32_t)ln.state[lane];
  F3 ro = load3(ln.f, F_RO, n, lane);
  F3 rd = load3(ln.f, F_RD, n, lane);
  F3 weight = load3(ln.f, F_WEIGHT, n, lane);
  F3 radiance = load3(ln.f, F_RADIANCE, n, lane);
  int bounce = c[C_BOUNCE * n + lane];
  const bool was_alive = ln.alive[lane];
  bool alive = was_alive && ln.hit[lane];

  if (alive) {
    c[C_N_BOUNCES * n + lane] += 1;
    next_f32(s);  // transmittance draws (stream parity)
    next_f32(s);
    const Mat m = material_at(mats + (size_t)ln.mat_id[lane] * MAT_COLS);
    const F3 normal = normalize(f3(ln.nx[lane], ln.ny[lane], ln.nz[lane]));
    shade_hit(p, L, lt, nee, have_lights, m, normal, ln.dst[lane], bounce, s, ro, rd,
              weight, radiance, alive);
  } else {
    // The draws of a shaded lane, unused: transmittance 2, the mix 4, the
    // light sample 5, delta 1, roulette 1.
    const int draws = 8 + (nee && have_lights ? 5 : 0);
    for (int k = 0; k < draws; ++k) next_f32(s);
  }

  // The end of the path: its clamped radiance into acc, then the pixel's
  // next sample in the lane, if it has one.
  const bool done = was_alive && (!alive || bounce + 1 > p.max_bounces);
  bool spawn = false;
  if (done) {
    const int sample_idx = c[C_SAMPLE * n + lane] + 1;
    c[C_SAMPLE * n + lane] = sample_idx;
    store3(ln.f, F_ACC, n, lane,
           add(load3(ln.f, F_ACC, n, lane), clamp_radiance(radiance, p.max_radiance)));
    spawn = sample_idx < p.spp;
    if (spawn) {
      const long long off = ln.offs != nullptr ? ln.offs[lane] : (long long)p.sample_offset;
      s = init_state((uint32_t)ln.pix[lane], p.accum, p.seed,
                     (uint32_t)((long long)sample_idx + off));
      camera_ray(p, ln.gx[lane], ln.gy[lane], s, ro, rd);
      weight = f3(1.0f, 1.0f, 1.0f);
      radiance = f3(0.0f, 0.0f, 0.0f);
    }
  }
  const bool alive_next = (alive && !done) || spawn;

  ln.state[lane] = (long long)s;
  store3(ln.f, F_RO, n, lane, ro);
  store3(ln.f, F_RD, n, lane, rd);
  store3(ln.f, F_WEIGHT, n, lane, weight);
  store3(ln.f, F_RADIANCE, n, lane, radiance);
  c[C_BOUNCE * n + lane] = spawn ? 0 : bounce + 1;
  if (alive_next) c[C_N_TRACED * n + lane] += 1;
  ln.alive[lane] = alive_next;
}

}  // namespace

// One shading step over params->n_pix lanes. mats: the material table
// (M, MAT_COLS); lt: the packed light table (n_light_tris, LIGHT_COLS),
// 16-byte aligned; then the alias tables (kernels/mega.py light_tables).
extern "C" int lupin_shade_step(const Params* params, const Lanes* lanes,
                                const float* mats, const float* lt,
                                const float* la_thresh, const int* la_alias,
                                const int* alias_offset, const int* alias_size,
                                const int* tri_offset, void* stream) {
  if (((uintptr_t)lt) & 15u) return (int)cudaErrorInvalidValue;
  if (params->n_light_tris > 64) return (int)cudaErrorInvalidValue;  // the gate's
  if (params->n_pix <= 0) return 0;
  const Lights L{lt, la_thresh, la_alias, alias_offset, alias_size, tri_offset};
  const size_t smem = sizeof(float) * LIGHT_COLS * params->n_light_tris;
  const int blocks = (params->n_pix + THREADS - 1) / THREADS;
  lupin_shade_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(*params, *lanes, mats, L);
  return (int)cudaGetLastError();
}

// Every lane's first sample: its state and camera ray into lanes->state and
// the ro and rd rows of lanes->f (six rows suffice).
extern "C" int lupin_shade_first(const Params* params, const Lanes* lanes, void* stream) {
  if (params->n_pix <= 0) return 0;
  const int blocks = (params->n_pix + THREADS - 1) / THREADS;
  lupin_shade_kernel_first<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*params, *lanes);
  return (int)cudaGetLastError();
}
