// Kernels B1/B2: dense closest hit, every ray against every triangle.
//
// Replaces lupinpathtracer_tpu/kernels/pallas_intersect.py:
//   B1 dense_closest_hit_pallas        (_kernel, pallas_call at :361)
//   B2 dense_closest_hit_attrs_pallas  (_kernel_attrs / _kernel_attrs_body,
//                                       pallas_call at :298)
//
// What bounds them on an H100. B1: operations, ~81 f32 operations per
// ray/triangle pair (four 10-term dot products and the epilogue) against
// 40 bytes of ray in and 20 of record out. B2 adds the winner's 128-column
// attribute row, transposed to (128, B): 512 bytes written per ray, which
// at the Cornell box's 36 triangles is 9 of every 10 bytes the kernel must
// move, so B2 is bound by its stores. The earlier design (one thread per
// ray over the unpacked (4, 10, T) matrix staged in a fixed 40 KB of shared
// memory, each thread loading its winner's row one scalar at a time) ran
// B2 at 45% of its byte bound and B1 at 19% of its operation bound. What
// held it back, and what this design does about each:
//
// - Too few warps in flight. 40 KB of static shared memory per block of
//   128 threads capped an SM at 5 blocks (20 warps). Now the stage is
//   dynamic and sized to what it holds: min(Tg, STAGE_GROUPS) groups of
//   four triangles (the Cornell box: 9 groups, 5.8 KB), and for B2 at
//   least the attribute tiles (below), which reuse it (16.5 KB); the
//   registers, not shared memory, now set the occupancy.
//   __launch_bounds__(THREADS, MIN_BLOCKS) holds ptxas to the 64
//   registers of 8 blocks (32 warps) per SM, which the hit loop needs
//   without spilling: at 10 or 12 blocks (48 or 40 registers) it spills
//   and both kernels ran slower on the card (tools/prof_dense.py sweeps
//   MIN_BLOCKS; PERF.md has the times).
// - Scattered attribute loads. Each thread loaded its own winner's 128
//   columns, so one warp load touched up to 32 rows of 512 bytes. Now the
//   warp transposes its 32 rays' rows through shared memory: per chunk of
//   TILE_W = 32 columns, eight lanes read one ray's 128-byte quarter row as
//   16-byte loads, four rays per warp instruction (each 512 coalesced
//   bytes), into a 32 x (32 + 1) tile (the pad keeps both the row writes
//   and the column reads free of bank conflicts); the warp then writes each
//   column as one 128-byte store of 32 consecutive rays into
//   attr_out[c * B + ray]. Winner indices travel by shuffles; a miss (or a
//   lane past B) reads nothing and writes a zero row, and lanes past B
//   store nothing.
// - The hit phase read 4-byte coefficients and paid an integer divide per
//   staged element. It is now B3's loop (dense_hit.cuh) on the packed
//   groups of kernels/bvh.py::pair_table: one 16-byte shared-memory
//   broadcast carries one coefficient of four triangles, the four are
//   evaluated together and folded in index order, and with eps > 0 the
//   exact sign pre-test (tri_test.cuh) skips the divide of a triangle the
//   epilogue rejects. The stage copy is a flat float4 copy.
//
// B1 is the same kernel with the attribute phase compiled out (ATTRS =
// false). Numerics match the plain PyTorch version (dense_intersect.py) bit
// for bit: dot products summed in order k = 0..9 with separate multiply and
// add (-fmad=false), IEEE division, a strict-< argmin in index order (the
// lowest index wins a tie, as the Pallas per-block min index followed by
// its strict cross-block compare), and the winner's row copied as it is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_hit.cuh"

namespace {

constexpr float F32_MAX = 3.4028235e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;       // per SM: 32 warps, 64 registers a thread
constexpr int STAGE_GROUPS = 26;    // groups of 4 triangles per stage (16,640 B)
constexpr int TILE_W = 32;          // attribute columns per tile chunk
constexpr int TILE_FLOATS = 32 * (TILE_W + 1);  // one warp's tile (4,224 B)

// The block's dynamic shared memory: a stage of the table, reused by B2's
// four warps' tiles after the hit phase.
constexpr size_t smem_bytes(int Tg, bool attrs) {
  const size_t stage = sizeof(float4) * 40 * (Tg < STAGE_GROUPS ? Tg : STAGE_GROUPS);
  const size_t tiles = attrs ? sizeof(float) * (THREADS / 32) * TILE_FLOATS : 0;
  return stage > tiles ? stage : tiles;
}

template <bool ATTRS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_hit_kernel(const float* __restrict__ R, const float4* __restrict__ Wg,
                 const float* __restrict__ A, int B, int Tg, int a_stride,
                 int aw, float eps,
                 float* __restrict__ t_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, float* __restrict__ det_out,
                 int* __restrict__ idx_out, float* __restrict__ attr_out) {
  extern __shared__ __align__(16) float4 smem[];
  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool live = ray < B;

  float r[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) r[k] = live ? R[(size_t)ray * 10 + k] : 0.0f;

  float bt = F32_MAX, bu = 0.0f, bv = 0.0f, bdet = 0.0f;
  int bidx = 0;
  const bool pre = eps > 0.0f;
  for (int g0 = 0; g0 < Tg; g0 += STAGE_GROUPS) {
    const int ng = min(STAGE_GROUPS, Tg - g0);
    if (g0 > 0) __syncthreads();
    for (int i = threadIdx.x; i < 40 * ng; i += THREADS)
      smem[i] = __ldg(Wg + (size_t)g0 * 40 + i);
    __syncthreads();
    if (live)
      lupin_dense::fold_groups<true>(smem, g0, ng, r, eps, pre, bt, bu, bv, bdet, bidx);
  }
  if (live) {
    t_out[ray] = bt;
    u_out[ray] = bu;
    v_out[ray] = bv;
    det_out[ray] = bdet;
    idx_out[ray] = bidx;
  }
  if constexpr (ATTRS) {
    // The warp-cooperative transpose of the winners' rows.
    __syncthreads();  // the stage becomes the tiles
    const int lane = threadIdx.x & 31;
    const int ray0 = ray - lane;
    if (ray0 >= B) return;  // the whole warp is past B
    float* tile = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * TILE_FLOATS;
    const int row = (live && bt < F32_MAX) ? bidx : -1;
    const int sub = lane >> 3;        // which of four rays this lane reads
    const int col = 4 * (lane & 7);   // its four columns of the chunk
    for (int c0 = 0; c0 < aw; c0 += TILE_W) {
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const int rw = __shfl_sync(FULL, row, j + sub);
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (rw >= 0 && c0 + col < aw)
          x = __ldg(reinterpret_cast<const float4*>(A + (size_t)rw * a_stride + c0 + col));
        float* d = tile + (j + sub) * (TILE_W + 1) + col;
        d[0] = x.x;
        d[1] = x.y;
        d[2] = x.z;
        d[3] = x.w;
      }
      __syncwarp();
      const int nc = min(TILE_W, aw - c0);
      if (live) {
#pragma unroll 8
        for (int c = 0; c < nc; ++c)
          attr_out[(size_t)(c0 + c) * B + ray] = tile[lane * (TILE_W + 1) + c];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// R (B, 10); Wg the packed coefficient table (ceil(T / 4), 40, 4)
// (kernels/bvh.py::pair_table), 16-byte aligned; A (T, a_stride) row-major,
// its first aw columns read, 16-byte aligned with a_stride and aw multiples
// of 4, or null (B1). Outputs t/u/v/det (B,) f32, idx (B,) i32, attr
// (aw, B) f32 or null. Returns cudaGetLastError() after the launch.
extern "C" int lupin_dense_closest_hit(const float* R, const float* Wg,
                                       const float* A, int B, int T,
                                       int a_stride, int aw, float eps,
                                       float* t, float* u, float* v,
                                       float* det, int* idx, float* attr,
                                       void* stream) {
  if (B <= 0) return (int)cudaGetLastError();  // empty outputs: no pointers
  if (((uintptr_t)Wg & 15u) != 0) return (int)cudaErrorInvalidValue;
  if (A != nullptr && ((((uintptr_t)A) & 15u) != 0 || a_stride % 4 != 0 ||
                       aw % 4 != 0 || aw > a_stride || attr == nullptr))
    return (int)cudaErrorInvalidValue;
  const int Tg = (T + 3) / 4;
  const int blocks = (B + THREADS - 1) / THREADS;
  const float4* W4 = reinterpret_cast<const float4*>(Wg);
  const cudaStream_t st = (cudaStream_t)stream;
  if (A != nullptr)
    dense_hit_kernel<true><<<blocks, THREADS, smem_bytes(Tg, true), st>>>(
        R, W4, A, B, Tg, a_stride, aw, eps, t, u, v, det, idx, attr);
  else
    dense_hit_kernel<false><<<blocks, THREADS, smem_bytes(Tg, false), st>>>(
        R, W4, nullptr, B, Tg, 0, 0, eps, t, u, v, det, idx, nullptr);
  return (int)cudaGetLastError();
}
