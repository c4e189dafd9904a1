// Kernel B4: per-ray closest hit through the top tree and its superleaves,
// with the winner's interpolated attribute rows on request.
//
// Replaces lupinpathtracer_tpu/kernels/pallas_packet.py::packet_traverse
// (pallas_call at :1011; _packet_kernel :303, _attr_phase :730).
//
// What bounds it on an H100: operations, then latency. A ray visits a few
// superleaves and, in each, the sub-chunks its box test admits; every
// admitted triangle costs four 10-term dot products and the epilogue
// (~81 f32 operations) on 40 coefficient floats. The top table (a few tens
// of KB) and the sub-chunk boxes stay in L1/L2; the coefficient reads are
// shared by neighbouring camera rays, which visit the same chunks.
//
// Design. The TPU kernel walks the top tree once per block of 256 rays
// (SMEM stack, one bitmask per pop, a DMA of each leaf's coefficient block
// and an MXU evaluation of the whole block against it), because a TPU has
// no per-lane control flow. A GPU thread has, so here each thread walks the
// tree for its own ray -- the per-thread traversal the packet emulated.
// The stack lives in a (SM, B) scratch array (SM = 7*top_depth + 18), so a
// warp's stack accesses are coalesced when its lanes share a depth. An
// internal pop slab-tests all 8 children against the ray's best t (empty
// slots carry a box that passes the slab test: masked on the used marker)
// and pushes hits in child-slot order. A leaf pop tests the NSUB sub-chunk
// boxes with the best t at the pop, then intersects each admitted chunk's
// triangles in order with a strict < against the running best, so the
// lowest index wins a tie. The attribute phase reads the winner's row
// directly (the TPU's one-hot fetch was a gather) and interpolates it as
// _attr_phase does (bvh_common.cuh).
//
// Two-level scenes (pallas_packet.py:405-467): a leaf id is a global
// (instance x mesh superleaf) id. At a leaf pop the ray moves to mesh space
// by the instance's 12 inverse-transform scalars (direction not normalised,
// so t stays world-scaled and the world-space best t prunes the mesh-space
// sub-chunk boxes), the sub-chunk boxes and coefficients are those of the
// mesh superleaf, and the winner is gref * SP + lane. MODE 1 reads the mesh
// superleaf and instance of a leaf from the gsl_msl / gsl_inst tables and
// the transform from inst_inv (the TPU's SMEM-resident mode); MODE 2 reads
// one 64-byte gsl_meta row [msl, inst, inst_inv(12), 0, 0] per leaf visit
// (the TPU's TL_STREAM mode, for tables too large for its SMEM). Both give
// the same results; the split follows the JAX package's routing.
//
// Numerics match the plain version (kernels/packet.py) bit for bit: built
// with -fmad=false and no fast-math, dot products summed in order k = 0..9,
// IEEE division, min/max that propagate NaN. Plain f32 throughout: the
// TPU's bf16 3-pass candidate filter and exact winner recompute
// (pallas_packet.py:486-549) are not needed.

#include <cuda_runtime.h>

#include "bvh_common.cuh"

namespace {

using namespace lupin_bvh;

constexpr int THREADS = 128;

// Slab test against box g = [lo.xyz, hi.xyz, used], pruned by best t.
__device__ __forceinline__ bool box_hit(const float o[3], const float iv[3],
                                        const float* g, float bt) {
  float near, far;
  slab(o, iv, g, g + 3, near, far);
  return far >= near && far > 0.0f && near < bt && g[6] > -0.5f;
}

// MODE 0: single-level; 1: two-level, resident tables; 2: two-level,
// streamed gsl_meta rows.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
packet_kernel(const float* __restrict__ geo, const int* __restrict__ refs,
              const float* __restrict__ sub, const float* __restrict__ rox,
              const float* __restrict__ roy, const float* __restrict__ roz,
              const float* __restrict__ rdx, const float* __restrict__ rdy,
              const float* __restrict__ rdz, const int* __restrict__ active,
              const float* __restrict__ W, long long T, int SP, int nsub,
              int SM, int B, float eps, const float* __restrict__ A, int aw,
              int awout, const int* __restrict__ gmsl,
              const int* __restrict__ ginst, const float* __restrict__ txf,
              const float* __restrict__ gmeta, int meta_cols,
              int* __restrict__ stack, float* __restrict__ t_out,
              float* __restrict__ u_out, float* __restrict__ v_out,
              float* __restrict__ det_out, int* __restrict__ tri_out,
              float* __restrict__ ia_out) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= B) return;
  const float ox = rox[lane], oy = roy[lane], oz = roz[lane];
  const float dx = rdx[lane], dy = rdy[lane], dz = rdz[lane];
  const float o[3] = {ox, oy, oz};
  const float iv[3] = {1.0f / dx, 1.0f / dy, 1.0f / dz};
  const float r[10] = {dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                       ox * dy - oy * dx, ox, oy, oz, 1.0f};
  const int spb = SP / nsub;

  float bt = F32_MAX, bu = 0.0f, bv = 0.0f, bd = 0.0f;
  int bi = 0;
  int sp = active[lane] != 0 ? 1 : 0;
  if (sp) stack[lane] = 0;  // root row, internal
  while (sp > 0) {
    sp -= 1;
    const int pref = sp < SM ? stack[(size_t)sp * B + lane] : 0;
    const int ref = pref >> 1;
    if ((pref & 1) == 0) {
      const float* row = geo + (size_t)ref * TOP_FAN * 8;
      for (int c = 0; c < TOP_FAN; ++c) {
        if (box_hit(o, iv, row + c * 8, bt)) {
          if (sp < SM) stack[(size_t)sp * B + lane] = refs[ref * TOP_FAN + c];
          ++sp;
        }
      }
      continue;
    }
    // Leaf: the ray frame of the leaf's mesh space (two-level), then the
    // sub-chunk boxes against the best t at the pop.
    int wref = ref;
    float rl[10], ol[3], ivl[3];
#pragma unroll
    for (int k = 0; k < 10; ++k) rl[k] = r[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ol[k] = o[k];
      ivl[k] = iv[k];
    }
    if constexpr (MODE != 0) {
      const float* m;
      if constexpr (MODE == 2) {
        const float* row = gmeta + (size_t)ref * meta_cols;
        wref = (int)row[0];
        m = row + 2;
      } else {
        wref = gmsl[ref];
        m = txf + (size_t)ginst[ref] * 12;
      }
      const float lx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
      const float ly = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
      const float lz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
      const float ex = m[0] * dx + m[1] * dy + m[2] * dz;
      const float ey = m[4] * dx + m[5] * dy + m[6] * dz;
      const float ez = m[8] * dx + m[9] * dy + m[10] * dz;
      rl[0] = ex; rl[1] = ey; rl[2] = ez;
      rl[3] = ly * ez - lz * ey;
      rl[4] = lz * ex - lx * ez;
      rl[5] = lx * ey - ly * ex;
      rl[6] = lx; rl[7] = ly; rl[8] = lz;
      ol[0] = lx; ol[1] = ly; ol[2] = lz;
      ivl[0] = 1.0f / ex; ivl[1] = 1.0f / ey; ivl[2] = 1.0f / ez;
    }
    const float* sb = sub + (size_t)wref * nsub * 8;
    unsigned bits = 0;
    for (int s = 0; s < nsub; ++s)
      if (box_hit(ol, ivl, sb + s * 8, bt)) bits |= 1u << s;
    for (int s = 0; s < nsub; ++s) {
      if (!((bits >> s) & 1u)) continue;
      const long long lane0 = (long long)s * spb;
      const long long base = (long long)wref * SP + lane0;
      for (int j = 0; j < spb; ++j) {
        const float* w = W + base + j;
        float m[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* wc = w + (size_t)c * 10 * T;
          float acc = rl[0] * wc[0];
#pragma unroll
          for (int k = 1; k < 10; ++k) acc = acc + rl[k] * wc[(size_t)k * T];
          m[c] = acc;
        }
        const float det = m[0];
        const float d = 1.0f / det;
        const float t = m[3] * d;
        const float u = m[1] * d;
        const float v = m[2] * d;
        const bool valid =
            (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t >= eps);
        const float tt = valid ? t : F32_MAX;
        if (tt < bt) {
          bt = tt;
          bu = u;
          bv = v;
          bd = det;
          bi = (int)((long long)ref * SP + lane0 + j);
        }
      }
    }
  }
  t_out[lane] = bt;
  u_out[lane] = bu;
  v_out[lane] = bv;
  det_out[lane] = bd;
  tri_out[lane] = bi;
  if (awout > 0) {
    const float* a = bt < F32_MAX ? A + (size_t)bi * aw : nullptr;
    write_rows(a, bu, bv, awout, ia_out + lane, (size_t)B);
  }
}

}  // namespace

// geo (rows, 8, 8) f32, refs (rows, 8) i32, sub (n_msl, nsub, 8) f32;
// rays (B,) f32, active (B,) i32; W (4, 10, T); A (T', aw) or unused when
// awout = 0. mode 1: gmsl/ginst (n_gsl,) i32 and txf (n_inst, 12) f32;
// mode 2: gmeta (n_gsl, meta_cols) f32; unused tables may be null. stack is
// (SM, B) i32 scratch. Outputs t/u/v/det (B,) f32, tri (B,) i32, ia
// (awout, B) f32. Returns cudaGetLastError().
extern "C" int lupin_packet_traverse(
    const float* geo, const int* refs, const float* sub, const float* rox,
    const float* roy, const float* roz, const float* rdx, const float* rdy,
    const float* rdz, const int* active, const float* W, long long T, int SP,
    int nsub, int SM, int B, float eps, const float* A, int aw,
    int awout, int mode, const int* gmsl, const int* ginst, const float* txf,
    const float* gmeta, int meta_cols, int* stack, float* t, float* u,
    float* v, float* det, int* tri, float* ia, void* stream) {
  if (nsub < 1 || nsub > 32 || SP % nsub != 0)
    return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2 || (mode != 0 && awout != 0) ||
      (mode == 1 && (gmsl == nullptr || ginst == nullptr || txf == nullptr)) ||
      (mode == 2 && (gmeta == nullptr || meta_cols < 14)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + THREADS - 1) / THREADS;
  const cudaStream_t st = (cudaStream_t)stream;
#define LUPIN_PACKET_LAUNCH(MODE)                                            \
  packet_kernel<MODE><<<blocks, THREADS, 0, st>>>(                           \
      geo, refs, sub, rox, roy, roz, rdx, rdy, rdz, active, W, T, SP, nsub,  \
      SM, B, eps, A, aw, awout, gmsl, ginst, txf, gmeta, meta_cols, stack, t, \
      u, v, det, tri, ia)
  if (mode == 0) LUPIN_PACKET_LAUNCH(0);
  else if (mode == 1) LUPIN_PACKET_LAUNCH(1);
  else LUPIN_PACKET_LAUNCH(2);
#undef LUPIN_PACKET_LAUNCH
  return (int)cudaGetLastError();
}
