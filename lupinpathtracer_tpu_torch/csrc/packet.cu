// Kernel B4: closest hit of each camera ray through the top tree and its
// superleaves, with the winner's interpolated attribute rows on request.
//
// Replaces lupinpathtracer_tpu/kernels/pallas_packet.py::packet_traverse
// (pallas_call at :1011; _packet_kernel :303, _attr_phase :730).
//
// What bounds it on an H100: operations. A ray visits a few superleaves and,
// in each, the sub-chunks its box test admits; every admitted triangle costs
// four 10-term dot products and the epilogue (~81 f32 operations, each
// separately rounded at -fmad=false) on 40 coefficient floats. The top rows
// and sub-chunk boxes are small and stay in L1/L2; neighbouring camera rays
// visit the same chunks, so the coefficients are shared.
//
// Design: a packet per warp. The TPU kernel walks the top tree once per
// block of rays (SMEM stack, one bitmask per pop, a DMA of each visited
// superleaf); here the 32 lanes of a warp -- 32 consecutive lanes of the
// renderer's 16x16-swizzled batch, a 16x2 pixel strip -- walk one stack in
// shared memory. An entry holds the node reference and a 32-bit owner mask:
// the lanes for which the node lies on their own walk. An internal pop
// slab-tests the row's 8 children for each owner lane against that lane's
// best t (the row read as 16-byte broadcasts of the packed top rows,
// kernels/bvh.py::top_rows); a child is pushed, in child-slot order, when
// any lane hits it, with the ballot of those lanes as its owner mask. A leaf
// pop tests the sub-chunk boxes for each owner lane (its best t at the pop);
// each lane then intersects its admitted chunks in ascending order, the
// warp stepping all lanes' k-th chunks together, so the lanes of one chunk
// read each 4-triangle group of the packed coefficient table
// (kernels/bvh.py::pair_table, 640 contiguous bytes) as the same 16-byte
// broadcasts through L1 and test four triangles per step with the exact
// sign pre-test before the divide (bvh_common.cuh::test_tris, B6's loop).
// The earlier design, one thread per ray with its stack in device memory,
// read each triangle as 40 scalar loads from rows 11 MB apart, with the
// warp's lanes at different depths, leaves and chunks.
//
// The split. Where neighbouring rays reach different leaves (the instanced
// fields: ~4 owner lanes per leaf pop of the 100k field's camera batch) the
// packet runs those leaves one after another. So where a leaf's sub-chunks
// are short (at most PK_SPLIT_CHUNK = 128 triangles), a packet that pops a
// leaf of fewer than PK_SPLIT = 8 owners continues as per-lane walks: each
// lane's own entries of the shared stack, bottom to top, become its own
// stack (in local memory: reserved in shared memory it slowed the packets
// further), and its walk goes on alone. On
// the 100k field's camera batch that took B4 from 2.96 to 1.09 ms; on the
// terrain's 512-triangle chunks it lost (lanes wait on each other's long
// chunk loops: 18.05 ms against 10.57 ms without it), so it is compiled
// only into the short-chunk instantiation. Occupancy: the packets without
// the split keep 7 blocks of 128 threads per SM (at most 72 registers, a
// few bytes of spills: 10.8 ms on the terrain, against 13.0 ms at the 77
// registers and 6 blocks ptxas picks alone); with the split, 6 (NVIDIA H100
// 80GB HBM3 at 700 W; tools/prof_packet.py, PERF.md).
//
// Why this is exact. Restricted to the entries one lane owns, the shared
// stack is that lane's own stack at every step: a pop of an entry it does
// not own leaves its entries alone, and its pushes land on top in child-slot
// order as its own walk pushes them. The warp always pops the top entry, so
// the lane's entries are popped in the order of its own walk, and its best t
// changes only at its own leaf pops: every box and triangle test sees the
// same best t as in the per-ray walk, and the strict-< winner (the lowest
// index on a tie) is the same, bit for bit. The split hands each lane the
// same stack. The shared stack never holds more than 7 * top_depth + 1
// entries, nor does a lane's own, below SM = 7 * top_depth + 18
// (kernels/packet.py::stack_size; SM <= PK_STACK, which the route's gate
// and the wrapper keep), so its guards (sp < SM) are never taken. They
// differ from the per-ray walk's, which reads the root at a pop past SM
// (and then walks without end): a pop past SM here reads an entry no lane
// owns. Counting each lane's own entries to reproduce that cost the
// terrain's packets 18-20% in a branch never taken (PERF.md), so the
// guards only keep the shared stack in bounds.
//
// Balance: a persistent grid takes 32-lane tiles from a counter, so warps
// whose tile is sky take the next tile while the ridge's tiles run.
//
// Two-level scenes (pallas_packet.py:405-467): a leaf id is a global
// (instance x mesh superleaf) id. At a leaf pop each owner lane reads the
// leaf's 64-byte gsl_meta row and moves its ray to mesh space (leaf_frame);
// the sub-chunk boxes and coefficients are those of the mesh superleaf, and
// the winner is gref * SP + lane. One mode: the JAX package's resident and
// streamed tables are a limit of the TPU's SMEM.
//
// The attribute phase reads the winner's row directly (the TPU's one-hot
// fetch was a gather) and interpolates it as _attr_phase does
// (bvh_common.cuh::write_rows).
//
// Numerics match the plain version (kernels/packet.py) bit for bit: built
// with -fmad=false and no fast-math, dot products summed in order k = 0..9,
// IEEE division, min/max that propagate NaN. Plain f32 throughout: the
// TPU's bf16 3-pass candidate filter and exact winner recompute
// (pallas_packet.py:486-549) are not needed.

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace lupin_packet {

using namespace lupin_bvh;

constexpr int PK_WARPS = 4;
constexpr int PK_THREADS = 32 * PK_WARPS;
constexpr int PK_STACK = 128;  // largest SM the stacks hold
constexpr int PK_SPLIT = 8;    // a leaf of fewer owner lanes ends the packet,
constexpr int PK_SPLIT_CHUNK = 128;  // where sub-chunks are this short
constexpr unsigned FULL = 0xffffffffu;

struct PacketArgs {
  const float4* geo;  // (rows, 8, 2): [lo.xyz, hi.x], [hi.yz, isleaf, 0]
  const int* refs;    // (rows, 8): (child_ref << 1) | is_leaf
  const float* sub;   // (n_msl, nsub, 8)
  const float *rox, *roy, *roz, *rdx, *rdy, *rdz;
  const int* active;
  const float* W;     // packed coefficients (T / 4, 40, 4)
  int SP, nsub, SM, B;
  float eps;
  const float* A;
  int aw, awout;
  const float* gmeta;  // two-level: (n_gsl, meta_cols)
  int meta_cols;
  int* tiles;          // tile counter, zero at the launch
  float *t, *u, *v, *det;
  int* tri;
  float* ia;
};

// Slab test against the box [lo, hi] of a slot whose used marker is `used`,
// pruned by best t.
__device__ __forceinline__ bool box_hit(const float o[3], const float iv[3],
                                        const float lo[3], const float hi[3],
                                        float used, float bt) {
  float near, far;
  slab(o, iv, lo, hi, near, far);
  return far >= near && far > 0.0f && near < bt && used > -0.5f;
}

// A leaf pop of one lane: its ray in the leaf's mesh space (two-level: the
// leaf's gsl_meta row [msl, inst, inst_inv(12)], direction not normalised,
// so t stays world-scaled and the world-space best t prunes the mesh-space
// boxes), the feature row rl of that ray and the bits of the sub-chunk
// boxes it hits with its best t at the pop. wref is the superleaf whose
// boxes and coefficients the leaf reads.
template <bool TWO_LEVEL>
__device__ __forceinline__ unsigned leaf_frame(const PacketArgs& a, int ref,
                                               const float o[3], const float d[3],
                                               const float iv[3], const float r[10],
                                               float bt, int& wref, float rl[10]) {
  float ol[3] = {o[0], o[1], o[2]}, ivl[3] = {iv[0], iv[1], iv[2]};
#pragma unroll
  for (int k = 0; k < 10; ++k) rl[k] = r[k];
  wref = ref;
  if constexpr (TWO_LEVEL) {
    const float* row = a.gmeta + (size_t)ref * a.meta_cols;
    wref = (int)row[0];
    const float* m = row + 2;
    const float lx = m[0] * o[0] + m[1] * o[1] + m[2] * o[2] + m[3];
    const float ly = m[4] * o[0] + m[5] * o[1] + m[6] * o[2] + m[7];
    const float lz = m[8] * o[0] + m[9] * o[1] + m[10] * o[2] + m[11];
    const float ex = m[0] * d[0] + m[1] * d[1] + m[2] * d[2];
    const float ey = m[4] * d[0] + m[5] * d[1] + m[6] * d[2];
    const float ez = m[8] * d[0] + m[9] * d[1] + m[10] * d[2];
    rl[0] = ex; rl[1] = ey; rl[2] = ez;
    rl[3] = ly * ez - lz * ey;
    rl[4] = lz * ex - lx * ez;
    rl[5] = lx * ey - ly * ex;
    rl[6] = lx; rl[7] = ly; rl[8] = lz;
    ol[0] = lx; ol[1] = ly; ol[2] = lz;
    ivl[0] = 1.0f / ex; ivl[1] = 1.0f / ey; ivl[2] = 1.0f / ez;
  }
  const float* sb = a.sub + (size_t)wref * a.nsub * 8;
  unsigned bits = 0u;
  for (int s = 0; s < a.nsub; ++s) {
    const float* g = sb + s * 8;
    if (box_hit(ol, ivl, g, g + 3, g[6], bt)) bits |= 1u << s;
  }
  return bits;
}

template <bool TWO_LEVEL, bool SPLIT>
__global__ void __launch_bounds__(PK_THREADS, SPLIT ? 6 : 7)
packet_kernel(const PacketArgs a) {
  __shared__ int2 stacks[PK_WARPS][PK_STACK];  // (node ref, owner mask)
  int2* st = stacks[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int n_tiles = (a.B + 31) >> 5;
  const int spb = a.SP / a.nsub;
  const bool pre = a.eps > 0.0f;
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(a.tiles, 1);
    tile = __shfl_sync(FULL, tile, 0);
    if (tile >= n_tiles) return;
    const int i = tile * 32 + lane;
    const bool in = i < a.B;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
    if (in) {
      ox = a.rox[i]; oy = a.roy[i]; oz = a.roz[i];
      dx = a.rdx[i]; dy = a.rdy[i]; dz = a.rdz[i];
    }
    const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
    const float iv[3] = {1.0f / dx, 1.0f / dy, 1.0f / dz};
    const float r[10] = {dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                         ox * dy - oy * dx, ox, oy, oz, 1.0f};
    float bt = F32_MAX, bu = 0.0f, bv = 0.0f, bd = 0.0f;
    int bi = 0;

    // The packet: the warp walks one shared stack.
    const unsigned root = __ballot_sync(FULL, in && a.active[i] != 0);
    int sp = 0;
    if (root != 0u) {
      if (lane == 0) st[0] = make_int2(0, (int)root);  // root row, internal
      sp = 1;
    }
    __syncwarp();
    bool split = false;
    while (sp > 0) {
      --sp;
      const int2 e = sp < a.SM ? st[sp] : make_int2(0, 0);
      __syncwarp();  // every lane has read the entry a push may overwrite
      const bool own = ((unsigned)e.y >> lane) & 1u;
      const int ref = e.x >> 1;
      if ((e.x & 1) == 0) {
        unsigned hits = 0u;
        if (own) {
          const float4* row = a.geo + (size_t)ref * (TOP_FAN * 2);
#pragma unroll
          for (int c = 0; c < TOP_FAN; ++c) {
            const float4 p = row[2 * c], q = row[2 * c + 1];
            const float lo[3] = {p.x, p.y, p.z}, hi[3] = {p.w, q.x, q.y};
            if (box_hit(o, iv, lo, hi, q.z, bt)) hits |= 1u << c;
          }
        }
        const int* rr = a.refs + (size_t)ref * TOP_FAN;
#pragma unroll
        for (int c = 0; c < TOP_FAN; ++c) {  // child-slot order
          const unsigned m = __ballot_sync(FULL, (hits >> c) & 1u);
          if (m != 0u) {
            if (lane == 0 && sp < a.SM) st[sp] = make_int2(rr[c], (int)m);
            ++sp;
          }
        }
        __syncwarp();
        continue;
      }
      if (SPLIT && __popc((unsigned)e.y) < PK_SPLIT) {  // the lanes have spread out
        ++sp;
        split = true;
        break;
      }
      // Each owner lane's chunks in ascending order, the warp stepping all
      // lanes' k-th chunks together (as many steps as the busiest lane has
      // chunks); the lanes on one chunk read it together.
      unsigned bits = 0u;
      int wref = ref;
      float rl[10];
      if (own) bits = leaf_frame<TWO_LEVEL>(a, ref, o, d, iv, r, bt, wref, rl);
      while (__any_sync(FULL, bits != 0u)) {
        if (bits != 0u) {
          const int s = __ffs(bits) - 1;
          bits &= bits - 1u;
          test_tris<true>(a.W + ((size_t)wref * a.SP + (size_t)s * spb) * 40, spb,
                          ref * a.SP + s * spb, rl, a.eps, pre, bt, bu, bv, bd, bi);
        }
      }
    }
    if (SPLIT && split) {
      // Per-lane walks from here: each lane's own entries, bottom to top,
      // are its own stack at this point of its walk.
      int ps[PK_STACK];
      int psp = 0;
      for (int k = 0; k < sp && k < a.SM; ++k) {
        const int2 f = st[k];
        if (((unsigned)f.y >> lane) & 1u) ps[psp++] = f.x;
      }
      __syncwarp();  // the shared stack is read before the next tile's use
      while (psp > 0) {
        --psp;
        const int pref = psp < a.SM ? ps[psp] : 0;
        const int ref = pref >> 1;
        if ((pref & 1) == 0) {
          const float4* row = a.geo + (size_t)ref * (TOP_FAN * 2);
          const int* rr = a.refs + (size_t)ref * TOP_FAN;
#pragma unroll
          for (int c = 0; c < TOP_FAN; ++c) {
            const float4 p = row[2 * c], q = row[2 * c + 1];
            const float lo[3] = {p.x, p.y, p.z}, hi[3] = {p.w, q.x, q.y};
            if (box_hit(o, iv, lo, hi, q.z, bt)) {
              if (psp < a.SM) ps[psp] = rr[c];
              ++psp;
            }
          }
          continue;
        }
        int wref;
        float rl[10];
        unsigned bits = leaf_frame<TWO_LEVEL>(a, ref, o, d, iv, r, bt, wref, rl);
        while (bits != 0u) {
          const int s = __ffs(bits) - 1;
          bits &= bits - 1u;
          test_tris<true>(a.W + ((size_t)wref * a.SP + (size_t)s * spb) * 40, spb,
                          ref * a.SP + s * spb, rl, a.eps, pre, bt, bu, bv, bd, bi);
        }
      }
    }
    if (in) {
      a.t[i] = bt;
      a.u[i] = bu;
      a.v[i] = bv;
      a.det[i] = bd;
      a.tri[i] = bi;
      if (a.awout > 0) {
        const float* ar = bt < F32_MAX ? a.A + (size_t)bi * a.aw : nullptr;
        write_rows(ar, bu, bv, a.awout, a.ia + i, (size_t)a.B);
      }
    }
  }
}

// Internal linkage: a static local of an inline function would be one
// object across every library loaded in the process.
template <bool TWO_LEVEL, bool SPLIT>
static int launch(const PacketArgs& a, cudaStream_t st) {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, packet_kernel<TWO_LEVEL, SPLIT>, PK_THREADS, 0);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int need = ((a.B + 31) / 32 + PK_WARPS - 1) / PK_WARPS;
  packet_kernel<TWO_LEVEL, SPLIT><<<need < grid ? need : grid, PK_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace lupin_packet

// geo (rows, 8, 8) f32 and refs (rows, 8) i32 (kernels/bvh.py::top_rows),
// sub (n_msl, nsub, 8) f32; rays (B,) f32, active (B,) i32; W the packed
// coefficient table (T / 4, 40, 4) (kernels/bvh.py::pair_table); A (T', aw)
// or unused when awout = 0; two_level: gmeta (n_gsl, meta_cols) f32, else
// null. tiles: one i32, zero. Outputs t/u/v/det (B,) f32, tri (B,) i32, ia
// (awout, B) f32. Returns cudaGetLastError().
extern "C" int lupin_packet_traverse(
    const float* geo, const int* refs, const float* sub, const float* rox,
    const float* roy, const float* roz, const float* rdx, const float* rdy,
    const float* rdz, const int* active, const float* W, int SP, int nsub,
    int SM, int B, float eps, const float* A, int aw, int awout, int two_level,
    const float* gmeta, int meta_cols, int* tiles, float* t, float* u,
    float* v, float* det, int* tri, float* ia, void* stream) {
  using namespace lupin_packet;
  if (nsub < 1 || nsub > 32 || SP % (4 * nsub) != 0 || SM < 1 || SM > PK_STACK)
    return (int)cudaErrorInvalidValue;
  if (two_level && (awout != 0 || gmeta == nullptr || meta_cols < 14))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const PacketArgs a{reinterpret_cast<const float4*>(geo), refs, sub, rox, roy,
                     roz, rdx, rdy, rdz, active, W, SP, nsub, SM, B, eps, A,
                     aw, awout, gmeta, meta_cols, tiles, t, u, v, det, tri, ia};
  const cudaStream_t st = (cudaStream_t)stream;
  if (SP / nsub <= PK_SPLIT_CHUNK)
    return two_level ? launch<true, true>(a, st) : launch<false, true>(a, st);
  return two_level ? launch<true, false>(a, st) : launch<false, false>(a, st);
}
