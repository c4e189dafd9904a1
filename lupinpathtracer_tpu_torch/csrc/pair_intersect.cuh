// Kernel B6: closest hit of superleaf-sorted rays against their work item's
// superleaf, one thread per sorted position.
//
// Replaces lupinpathtracer_tpu/kernels/pallas_bvh.py::_pair_kernel (:385,
// pallas_call at :665). The function is that of pair_kernel.cuh's V0 (the
// earlier design of this kernel, now the baseline of the B6' ablation) and
// of kernels/bvh.py::pair_intersect_plain, bit for bit: per covered sorted
// position the lowest local index among the triangles with the least valid
// t (a strict <, pallas_bvh.py:499), its u, v, det; uncovered positions are
// left as the caller prefilled them.
//
// What bounds it on an H100: operations. Each (ray, superleaf) pair costs SP
// triangles x four 10-term dot products plus the validity test (~81 f32
// operations each, separately rounded: at -fmad=false the f32 pipe issues
// half the rate the 67 TFLOP/s peak counts); bytes are the sorted rays in,
// the records out and each distinct coefficient slice once. The earlier
// design (one block of 256 threads per work item) ran far from that bound,
// and the design answers each reason:
//
// - Idle lanes. A block per item left the lanes outside the item's
//   [lo, hi) idle: 65% of the threads had a pair on the 2M-triangle
//   terrain, 2.3% on the 100k-instance field (5.8 pairs per item), and
//   every block staged its whole 40 KB slice for those few lanes. Here a
//   block takes a tile of 256 consecutive sorted positions (a persistent
//   grid walks the tiles), and each thread finds the item that covers its
//   position: items are ordered by the positions they cover (block-
//   monotone, kernels/intersect.py::_wf_work_items), so one warp-wide
//   32-way search over the item starts brackets the tile's items, which
//   the block loads into shared memory, and each thread binary-searches
//   them. n_items is read on the device: no host sync.
// - Each distinct slice once per block. A tile spans a few mesh superleaves
//   where pairs are dense (1-3 on the terrain's first rounds; ~4 on the
//   instanced field, where ~40 items share them). The block counts its
//   threads per superleaf (a hash in shared memory); every superleaf of 32
//   threads or more is staged, one tile of its slice per ring stage, by
//   cp.async (16-byte, L2 only) into a two-stage ring, the next tile's copy
//   in flight while this one is tested. The staged groups start 16 bytes
//   apart modulo 128, so the distinct addresses a quarter warp reads fall
//   in different banks. Where pairs are sparse (a later round spreads a
//   few thousand pairs over hundreds of superleaves: up to 145 in one
//   tile) staging every slice would serialise the block on copies of a
//   few triangles each, so a warp with a lane outside the staged
//   superleaves reads its lanes' own slices from L1/L2 instead, in the
//   same layout. The kernel reads the coefficients packed once per matrix
//   (kernels/bvh.py::pair_table: (T/4, 40, 4), coefficient q of triangles
//   4i..4i+3 at 160 i + 4 q): one 16-byte load reads one coefficient of
//   four triangles, 10 loads per triangle, and a group's 640 bytes are
//   contiguous. In the (4, 10, T) matrix they lie on 40 rows 11 MB apart
//   on the terrain, and the L1/L2 route of the later rounds paid for that.
//   A design with two rays per thread sharing each load was faster on the
//   camera batches' first rounds and slower on the bounce rounds, where a
//   thread's two rays straddle superleaves, so it was not kept (PERF.md):
//   the shared-memory data path is not what bounds this kernel.
// - Few tiles. A late round (a few thousand pairs, or a straggler round of
//   a few dozen) fills a handful of tiles, and each thread would scan its
//   whole superleaf alone (4096 triangles on the terrain), one dependent
//   step after another on a mostly idle card. Below PAIR_SPLIT_UNITS
//   (kernels/bvh.py, 4,096: ~16 waves of the grid) units of (tile, chunk),
//   each tile's triangles are split into chunks of at least 64, one unit
//   each; a unit writes its partial minimum to scratch, and the last unit
//   of the tile to finish (a counter per tile) merges them in chunk order
//   with the same strict <, which is the whole scan's winner. The budget
//   also splits the terrain's first round (1,260 tiles) in 3, so that few
//   blocks idle through the grid's last wave.
// - The per-triangle chain. Four triangles are evaluated together (16
//   independent sums of 10 terms), then folded into the running minimum in
//   index order. Before the IEEE divide a triangle is dropped when its
//   numerators against det already make it invalid (tri_test.cuh
//   surely_invalid: signs and u + v against det, with margins that keep it
//   exact); that is off unless eps > 0.
//
// Plain f32, -fmad=false, every dot product summed in the plain version's
// order: the result does not depend on the tile size, the grid, the
// grouping, the route of the loads or the split. Two-level scenes (pallas_bvh.py:
// 422-439): with an instance word per item, the thread's ray moves to mesh
// space by the instance's 12 inverse-transform scalars in bvh.mesh_space's
// order; the direction is not normalised, so t stays world-scaled.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_common.cuh"
#include "pair_kernel.cuh"
#include "tri_test.cuh"

namespace lupin_bvh {

constexpr int PI_THREADS = 256;         // sorted positions per tile
constexpr int PI_STAGE_FLOATS = 5248;   // one ring stage (20.5 KB): 128 triangles of one slice
constexpr int PI_STAGES = 2;
constexpr int PI_DENSE_MIN = 32;        // threads of a superleaf that make it staged
constexpr int PI_DENSE_MAX = PI_THREADS / PI_DENSE_MIN;
constexpr int PI_HASH = 512;            // superleaf hash, load <= 1/2
constexpr int PI_SPLIT_MIN = 64;        // least triangles of a split tile's chunk
                                        // (bvh.py::pair_split mirrors the split)

// Scratch of the split: the partial (t, u, v, det, index) of each (tile,
// chunk) unit, five arrays of cap x PI_THREADS, and one counter per tile,
// zero at the launch.
struct PairSplit {
  float* part;
  int* cnt;
  int cap;  // units the scratch holds
};

struct PairTile {
  int kb, ke, n_dense, last;
  int item_c[PI_THREADS];  // first covered position of each candidate item
  int item_e[PI_THREADS];  // one past its last
  int htab[PI_HASH];       // superleaf id or -1
  int hcount[PI_HASH];     // its threads in the tile
  int hdense[PI_HASH];     // its staged group, -1 if read through L1/L2
  int dm[PI_DENSE_MAX];    // staged group -> mesh superleaf
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Stage triangles [base, base + n) of the nd staged groups into one ring
// buffer, group g at g * RS, in the packed layout (40 floats a triangle,
// contiguous in the table).
__device__ __forceinline__ void stage_tile(const PairArgs& a, const int* dm,
                                           float* buf, int nd, int RS, int base,
                                           int n) {
  const int per_group = 10 * n;  // 16-byte copies
  for (int i = threadIdx.x; i < nd * per_group; i += PI_THREADS) {
    const int g = i / per_group;
    const int r = i - g * per_group;
    const float* src = a.W + ((size_t)dm[g] * a.SP + base) * 40 + 4 * r;
    cp_async16(buf + g * RS + 4 * r, src);
  }
  asm volatile("cp.async.commit_group;\n");
}

// 2 blocks per SM: 128 registers (16 B of spills).
__global__ void __launch_bounds__(PI_THREADS, 2)
pair_hit_kernel(const PairArgs a, const PairSplit sp) {
  extern __shared__ __align__(16) float ring[];  // PI_STAGES x PI_STAGE_FLOATS
  __shared__ PairTile s;
  const int tid = threadIdx.x;
  const int n = *a.n_items;
  if (n <= 0) return;
  // Positions past the last item's are covered by no item.
  const int end = max(cov_start(a.blk, a.lo, a.PB, n - 1),
                      cov_end(a.blk, a.hi, a.PB, a.P, n - 1));
  const bool pre = a.eps > 0.0f;
  // Too few tiles to fill the card (a late round's few thousand pairs): each
  // tile's triangles are split into KS chunks of KC, one unit each, and the
  // last unit of a tile to finish merges the partial minima in chunk order.
  const int n_tiles = (end + PI_THREADS - 1) / PI_THREADS;
  int KS = (n_tiles > 0 && n_tiles < sp.cap)
               ? min(max(a.SP / PI_SPLIT_MIN, 1), sp.cap / n_tiles) : 1;
  const int KC = (((a.SP + KS - 1) / KS) + 3) & ~3;
  KS = (a.SP + KC - 1) / KC;

  for (int unit = blockIdx.x; unit < n_tiles * KS; unit += gridDim.x) {
    const int tile = unit / KS;
    const int k0 = (unit - tile * KS) * KC;
    const int k1 = min(a.SP, k0 + KC);
    const int p0 = tile * PI_THREADS;
    const int pos = p0 + tid;
    __syncthreads();  // the previous tile is done with s
    if (tid < 32) {
      int kb, ke;  // the tile's candidate items
      tile_items(a.blk, a.lo, a.PB, n, p0, PI_THREADS, kb, ke);
      if (tid == 0) {
        s.kb = kb;
        s.ke = ke;
        s.n_dense = 0;
      }
    }
    for (int i = tid; i < PI_HASH; i += PI_THREADS) {
      s.htab[i] = -1;
      s.hcount[i] = 0;
    }
    __syncthreads();
    const int kb = s.kb, ke = s.ke;
    if (kb >= ke) continue;  // uniform

    // The item covering pos: the last candidate starting at or before it
    // (a non-empty one among equal starts), if pos is below its end.
    int item = -1;
    for (int cb = kb; cb < ke; cb += PI_THREADS) {
      const int nc = min(PI_THREADS, ke - cb);
      if (cb > kb) __syncthreads();
      if (tid < nc) {
        s.item_c[tid] = cov_start(a.blk, a.lo, a.PB, cb + tid);
        s.item_e[tid] = cov_end(a.blk, a.hi, a.PB, a.P, cb + tid);
      }
      __syncthreads();
      const int i = covering(s.item_c, s.item_e, nc, pos);
      if (i >= 0) item = cb + i;
    }

    // Count the block's threads per mesh superleaf (one hash insert per
    // distinct value per warp), then stage the superleaves of at least
    // PI_DENSE_MIN threads.
    const int key = item >= 0 ? a.msl[item] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    int slot = 0;
    if ((tid & 31) == __ffs(peers) - 1 && key >= 0) {
      int hh = (int)(((unsigned)key * 2654435761u) >> 23);  // 9 bits
      for (;;) {
        const int old = atomicCAS(&s.htab[hh], -1, key);
        if (old == -1 || old == key) break;
        hh = (hh + 1) & (PI_HASH - 1);
      }
      atomicAdd(&s.hcount[hh], __popc(peers));
      slot = hh;
    }
    slot = __shfl_sync(0xffffffffu, slot, __ffs(peers) - 1);

    // The ray, in mesh space for two-level items.
    float r[10];
    if (item >= 0) {
      float ox = a.rox[pos], oy = a.roy[pos], oz = a.roz[pos];
      float dx = a.rdx[pos], dy = a.rdy[pos], dz = a.rdz[pos];
      if (a.inst != nullptr) {
        const float* m = a.txf + (size_t)a.inst[item] * 12;
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
    __syncthreads();
    for (int i = tid; i < PI_HASH; i += PI_THREADS) {
      int g = -1;
      if (s.htab[i] >= 0 && s.hcount[i] >= PI_DENSE_MIN) {
        g = atomicAdd(&s.n_dense, 1);
        s.dm[g] = s.htab[i];
      }
      s.hdense[i] = g;
    }
    __syncthreads();
    const int nd = s.n_dense;  // uniform, <= PI_DENSE_MAX
    const int group = key >= 0 ? s.hdense[slot] : -1;
    // A warp reads from the ring only if every lane with a pair is staged.
    const bool staged = __all_sync(0xffffffffu, item < 0 || group >= 0);
    const int TC = nd > 0 ? min(((PI_STAGE_FLOATS / nd - 4) / 40) & ~3, k1 - k0) : k1 - k0;
    const int RS = 40 * TC + 4;
    const int ntile = (k1 - k0 + TC - 1) / TC;
    const float* own = a.W + (size_t)max(key, 0) * a.SP * 40;  // this lane's slice
    float bt = F32_MAX, bu = 0.0f, bv = 0.0f, bdet = 0.0f;
    int bidx = 0;

    if (nd > 0) stage_tile(a, s.dm, ring, nd, RS, k0, min(TC, k1 - k0));
    for (int t = 0; t < ntile; ++t) {
      const int base = k0 + t * TC;
      const int n_t = min(TC, k1 - base);
      if (nd > 0) {
        if (t + 1 < ntile)
          stage_tile(a, s.dm, ring + ((t + 1) & 1) * PI_STAGE_FLOATS, nd, RS,
                     base + TC, min(TC, k1 - base - TC));
        else
          asm volatile("cp.async.commit_group;\n");
        asm volatile("cp.async.wait_group 1;\n");
        __syncthreads();
      }
      if (item >= 0) {
        if (staged)
          test_tris<false>(ring + (t & 1) * PI_STAGE_FLOATS + group * RS, n_t,
                           base, r, a.eps, pre, bt, bu, bv, bdet, bidx);
        else
          test_tris<true>(own + 40 * base, n_t, base, r, a.eps, pre, bt, bu, bv,
                          bdet, bidx);
      }
      if (nd > 0) __syncthreads();  // this buffer is refilled two tiles on
    }
    if (KS > 1) {
      const size_t cap = (size_t)sp.cap * PI_THREADS;
      const size_t at = (size_t)unit * PI_THREADS + tid;
      sp.part[at] = bt;
      sp.part[cap + at] = bu;
      sp.part[2 * cap + at] = bv;
      sp.part[3 * cap + at] = bdet;
      sp.part[4 * cap + at] = __int_as_float(bidx);
      __threadfence();
      __syncthreads();
      if (tid == 0) s.last = atomicAdd(&sp.cnt[tile], 1) == KS - 1;
      __syncthreads();
      if (!s.last) continue;  // uniform
      __threadfence();
      // Chunks in index order, strict <: the sequential scan's winner.
      // All five loads of a chunk are issued before its compare.
      for (int c = 0; c < KS; ++c) {
        const size_t q = (size_t)(tile * KS + c) * PI_THREADS + tid;
        const float tq = __ldcg(sp.part + q), uq = __ldcg(sp.part + cap + q);
        const float vq = __ldcg(sp.part + 2 * cap + q);
        const float dq = __ldcg(sp.part + 3 * cap + q);
        const int iq = __float_as_int(__ldcg(sp.part + 4 * cap + q));
        if (c == 0 || tq < bt) {
          bt = tq;
          bu = uq;
          bv = vq;
          bdet = dq;
          bidx = iq;
        }
      }
    }
    if (item >= 0) {
      a.t[pos] = bt;
      a.u[pos] = bu;
      a.v[pos] = bv;
      a.det[pos] = bdet;
      a.li[pos] = bidx;
    }
  }
}

// A persistent grid of as many blocks as fit on the card at once; shared
// memory above 48 KB is opted in. sp.cnt must be zero. Internal linkage:
// each loaded library keeps its own grid_max (the static local of an
// inline function with external linkage is one GNU-unique object across
// every library loaded in the process).
static inline int launch_pair_intersect(const PairArgs& a, const PairSplit& sp,
                                 void* stream) {
  if (a.PB < 1 || sp.cap < 1) return (int)cudaErrorInvalidValue;
  if ((a.inst == nullptr) != (a.txf == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.SP % 4 != 0 || a.T % 4 != 0 || ((uintptr_t)a.W & 15u) != 0)
    return (int)cudaErrorInvalidValue;  // 16-byte copies of 4 triangles
  if (a.n_cap == 0 || a.P == 0) return (int)cudaGetLastError();
  static int grid_max = 0;
  const size_t smem = sizeof(float) * PI_STAGES * PI_STAGE_FLOATS;
  if (grid_max == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_hit_kernel,
                                                      PI_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    grid_max = max(1, sms * per_sm);
  }
  pair_hit_kernel<<<grid_max, PI_THREADS, smem, (cudaStream_t)stream>>>(a, sp);
  return (int)cudaGetLastError();
}

}  // namespace lupin_bvh
