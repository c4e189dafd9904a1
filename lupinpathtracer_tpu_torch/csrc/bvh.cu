// Kernels B5/B6/B7: the BVH wavefront's top-tree traversal, pair
// intersection and winner-attribute fetch.
//
// Replaces lupinpathtracer_tpu/kernels/pallas_bvh.py:
//   B5 top_traverse    (_top_kernel :103, pallas_call at :344)
//   B6 pair_intersect  (_pair_kernel :385, pallas_call at :665)
//   B7 attr_fetch      (_attr_kernel :707, pallas_call at :896)
//
// B5. What bounds it: neither, in practice -- it is latency-bound pointer
// chasing. Per internal pop a ray reads one 320-byte table row (the whole
// top table is a few tens of KB and stays in L1/L2) and does 8 slab tests
// (~30 f32 operations each) plus a 19-comparator sort; its bytes are the
// rays, best_t, sp, the outputs and the stack entries it pops and pushes.
// Design: one thread per ray. The TPU fetched each lane's node row with an
// exact one-hot MXU matmul because it has no per-lane gather; here a lane
// simply loads its row. The stack stays in the (S, Bp) layout the JAX
// package uses and is updated in place (a lane touches only its own
// column), so a round resumes the previous one's stack without copying it
// and a warp's stack accesses are coalesced when its lanes share a depth.
// The demand histogram is built in shared memory with atomics and flushed
// once per block.
//
// B6. The kernel, its bound and its design are in pair_intersect.cuh (one
// thread per sorted position); pair_kernel.cuh keeps the earlier design (a
// block per work item) as the baseline of the ablation in pair_variants.cu.
//
// B7. What bounds it: bytes (one 512-byte attribute row read and 64 or 96
// bytes written per winner). Design: one block per work item, one thread
// per covered lane, a direct load of the winner's row (the TPU's one-hot
// gather) and the interpolation of _attr_kernel (pallas_bvh.py:750-786).
// With an instance word per item (two-level scenes, pallas_bvh.py:788-825)
// the row is rotated by the instance's normal matrix and takes its material
// override (bvh_common.cuh::write_rows); without one the rows stay in mesh
// space and keep mat_id.
//
// Numerics match the plain PyTorch versions (kernels/bvh.py): built with
// -fmad=false and no fast-math; min/max propagate NaN like jnp/torch.

#include <cuda_runtime.h>

#include "bvh_common.cuh"
#include "pair_intersect.cuh"

namespace {

using namespace lupin_bvh;

constexpr int CH_STRIDE = 10;
constexpr int TOP_COLS = TOP_FAN * CH_STRIDE;
constexpr int CH_ISLEAF = 6, CH_H2 = 7, CH_HI8 = 8, CH_LO8 = 9;
constexpr int HIST_MAX = 4096;
constexpr int TOP_THREADS = 128;

__global__ void __launch_bounds__(TOP_THREADS)
top_kernel(const float* __restrict__ tab, const float* __restrict__ rox,
           const float* __restrict__ roy, const float* __restrict__ roz,
           const float* __restrict__ rdx, const float* __restrict__ rdy,
           const float* __restrict__ rdz, const float* __restrict__ best_t,
           const int* __restrict__ sp_in, int S, int Q, int Bp, int nslp,
           int* __restrict__ stack, int* __restrict__ sl_out,
           int* __restrict__ cnt_out, int* __restrict__ sp_out, int* __restrict__ hist,
           int* __restrict__ aabb_out) {
  __shared__ int shist[HIST_MAX];
  for (int i = threadIdx.x; i < nslp; i += TOP_THREADS) shist[i] = 0;
  __syncthreads();

  const int lane = blockIdx.x * TOP_THREADS + threadIdx.x;
  if (lane < Bp) {
    for (int q = 0; q < Q; ++q) sl_out[(size_t)q * Bp + lane] = -1;
    const float o[3] = {rox[lane], roy[lane], roz[lane]};
    const float iv[3] = {1.0f / rdx[lane], 1.0f / rdy[lane], 1.0f / rdz[lane]};
    const float bt = best_t[lane];
    int sp = sp_in[lane], cnt = 0, aabb = 0;

    while (sp > 0 && cnt < Q) {
      sp -= 1;
      const int node = sp < S ? stack[(size_t)sp * Bp + lane] : 0;
      if (node < 0) {  // leaf pop: emit
        sl_out[(size_t)cnt * Bp + lane] = -node - 1;
        if (nslp > 0) atomicAdd(&shist[-node - 1], 1);
        ++cnt;
        continue;
      }
      const float* row = tab + (size_t)node * TOP_COLS;
      float ts[TOP_FAN];
      int refs[TOP_FAN];
#pragma unroll
      for (int c = 0; c < TOP_FAN; ++c) {
        const float* g = row + c * CH_STRIDE;
        float tn, tf;
        slab(o, iv, g, g + 3, tn, tf);
        const float t_c = (tf >= tn && tf > 0.0f) ? tn : F32_MAX;
        ts[c] = g[CH_ISLEAF] > -0.5f ? t_c : F32_MAX;
        const int rid =
            (int)(g[CH_H2] * 65536.0f + g[CH_HI8] * 256.0f + g[CH_LO8]);
        refs[c] = g[CH_ISLEAF] > 0.5f ? -rid - 1 : rid;
      }
      // 19-comparator network (pallas_bvh.py:205-218), swap on strict >.
      constexpr int NET[19][2] = {
          {0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}, {4, 5}, {6, 7},
          {4, 6}, {5, 7}, {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7},
          {2, 4}, {3, 5}, {1, 2}, {3, 4}, {5, 6}};
#pragma unroll
      for (int e = 0; e < 19; ++e) {
        const int a = NET[e][0], b = NET[e][1];
        if (ts[a] > ts[b]) {
          const float tt = ts[a];
          ts[a] = ts[b];
          ts[b] = tt;
          const int rr = refs[a];
          refs[a] = refs[b];
          refs[b] = rr;
        }
      }
      bool rem[TOP_FAN];
#pragma unroll
      for (int c = 0; c < TOP_FAN; ++c) {  // near -> far: emit leaves
        const bool hit = ts[c] < bt;
        const bool em = hit && refs[c] < 0 && cnt < Q;
        if (em) {
          sl_out[(size_t)cnt * Bp + lane] = -refs[c] - 1;
          if (nslp > 0) atomicAdd(&shist[-refs[c] - 1], 1);
          ++cnt;
        }
        rem[c] = hit && !em;
      }
#pragma unroll
      for (int c = TOP_FAN - 1; c >= 0; --c) {  // far -> near: push the rest
        if (rem[c]) {
          if (sp < S) stack[(size_t)sp * Bp + lane] = refs[c];
          ++sp;
        }
      }
      aabb += TOP_FAN;
    }
    cnt_out[lane] = cnt;
    sp_out[lane] = sp;
    aabb_out[lane] = aabb;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nslp; i += TOP_THREADS)
    if (shist[i] != 0) atomicAdd(&hist[i], shist[i]);
}

__global__ void attr_kernel(const int* __restrict__ blk,
                            const int* __restrict__ msl,
                            const int* __restrict__ lo,
                            const int* __restrict__ hi,
                            const int* __restrict__ n_items,
                            const int* __restrict__ li,
                            const float* __restrict__ hu,
                            const float* __restrict__ hv,
                            const float* __restrict__ A,
                            const int* __restrict__ inst,
                            const float* __restrict__ nrm,
                            const int* __restrict__ ovr, int SP, int aw,
                            int PB, int P, int awout, float* __restrict__ out) {
  const int k = blockIdx.x;
  if (k >= *n_items) return;
  const int pos = blk[k] * PB + threadIdx.x;
  if (pos < lo[k] || pos >= hi[k] || pos >= P) return;
  const float* a = A + ((size_t)msl[k] * SP + li[pos]) * aw;
  const float* nm = nullptr;
  int o = -1;
  if (inst != nullptr) {
    nm = nrm + (size_t)inst[k] * 9;
    o = ovr[inst[k]];
  }
  write_rows(a, hu[pos], hv[pos], awout, out + pos, (size_t)P, nm, o);
}

}  // namespace

// tab (rows, 80) f32; rays/best_t (Bp,); sp_in (Bp,); stack (S, Bp),
// updated in place. Outputs sl (Q, Bp), cnt, sp, hist (nslp,) zeroed by the
// caller (nslp = 0: no histogram), aabb. Returns cudaGetLastError().
extern "C" int lupin_top_traverse(const float* tab, const float* rox,
                                  const float* roy, const float* roz,
                                  const float* rdx, const float* rdy,
                                  const float* rdz, const float* best_t,
                                  const int* sp_in, int S, int Q, int Bp,
                                  int nslp, int* stack, int* sl, int* cnt,
                                  int* sp, int* hist, int* aabb,
                                  void* stream) {
  if (nslp > HIST_MAX) return (int)cudaErrorInvalidValue;
  if (Bp == 0) return (int)cudaGetLastError();
  const int blocks = (Bp + TOP_THREADS - 1) / TOP_THREADS;
  top_kernel<<<blocks, TOP_THREADS, 0, (cudaStream_t)stream>>>(
      tab, rox, roy, roz, rdx, rdy, rdz, best_t, sp_in, S, Q, Bp, nslp, stack,
      sl, cnt, sp, hist, aabb);
  return (int)cudaGetLastError();
}

// Work items blk/msl/lo/hi (n_cap,), n_items (1,) on the device; sorted
// rays (P,); W the packed coefficient table (T / 4, 40, 4) (kernels/bvh.py
// pair_table); inst (n_cap,) with txf (n_inst, 12), or both null. Outputs
// (P,), prefilled with a miss by the caller. Items are ordered by the
// positions they cover; a persistent grid walks 256-position tiles. part
// (5 x cap x 256) and cnt (cap,), zeroed, are the scratch of a split.
extern "C" int lupin_pair_intersect(const int* blk, const int* msl,
                                    const int* lo, const int* hi,
                                    const int* n_items, const int* inst,
                                    const float* txf, const float* rox,
                                    const float* roy, const float* roz,
                                    const float* rdx, const float* rdy,
                                    const float* rdz, const float* W,
                                    long long T, int n_cap, int SP, int PB,
                                    int P, float eps, float* t, float* u,
                                    float* v, float* det, int* li,
                                    float* part, int* cnt, int cap,
                                    void* stream) {
  const PairArgs a{blk, msl, lo,  hi, n_items, inst, txf, rox, roy,
                   roz, rdx, rdy, rdz, W,      T,    n_cap, SP, PB,
                   P,   eps, t,   u,   v,      det,  li};
  return launch_pair_intersect(a, PairSplit{part, cnt, cap}, stream);
}

// Items as above; li/hu/hv (P,); A (n_msl, SP, aw); inst (n_cap,) with nrm
// (n_inst, 9) and ovr (n_inst,), or all three null. out (awout, P), zeroed
// by the caller.
extern "C" int lupin_attr_fetch(const int* blk, const int* msl, const int* lo,
                                const int* hi, const int* n_items,
                                const int* li, const float* hu,
                                const float* hv, const float* A,
                                const int* inst, const float* nrm,
                                const int* ovr, int n_cap, int SP, int aw,
                                int PB, int P, int awout, float* out,
                                void* stream) {
  if (PB < 1 || PB > 1024) return (int)cudaErrorInvalidValue;
  if ((inst == nullptr) != (nrm == nullptr) || (inst == nullptr) != (ovr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_cap == 0) return (int)cudaGetLastError();
  attr_kernel<<<n_cap, PB, 0, (cudaStream_t)stream>>>(
      blk, msl, lo, hi, n_items, li, hu, hv, A, inst, nrm, ovr, SP, aw, PB, P,
      awout, out);
  return (int)cudaGetLastError();
}
