// Kernels B5/B6/B7: the BVH wavefront's top-tree traversal, pair
// intersection and winner-attribute fetch.
//
// Replaces lupinpathtracer_tpu/kernels/pallas_bvh.py:
//   B5 top_traverse    (_top_kernel :103, pallas_call at :344)
//   B6 pair_intersect  (_pair_kernel :385, pallas_call at :665)
//   B7 attr_fetch      (_attr_kernel :707, pallas_call at :896)
//
// B5. What bounds it: latency. A round is a dependent chain of pops per
// ray: read the stack's top, read the node's row, 8 slab tests (~26 f32
// operations each), the 19-comparator sort, emits and pushes; its bytes
// are the rays, best_t, sp, the outputs and the stack entries it needs, a
// few bytes per operation. A launch lasts as long as its longest chain.
// Both shapes read the packed top rows (kernels/bvh.py::top_rows, 256
// contiguous bytes a row, the child references decoded once per scene)
// instead of 80 scalar loads at a 40-byte stride and a decode of three
// floats per child. The shape follows the launch:
// - A launch of few rays (the wavefront's compacted straggler rounds, 2,048
//   lanes, whose few live rays run the longest chains) takes eight lanes per
//   ray, one per child slot (top_kernel_x8): a pop's row is one 16-byte
//   load pair and one reference per lane, the lanes slab-test their child at
//   once and run the comparator network as six layers of shuffles (the 19
//   comparators grouped so that each element meets its comparators in their
//   order: the same permutation), and emits and pushes go by ballots and
//   prefix counts. The warp's four rays step together, one pop each per
//   step, so its lanes stay converged. The ray's stack lives in shared
//   memory for the round: an entry below the round's low-water mark is read
//   from the (S, Bp) stack the first time it is popped, pushes stay in
//   shared memory, and at the end the entries from the low-water mark up to
//   sp are written back in place; entries pushed and popped within the
//   round are never written (a later round reads a lane's entries below its
//   sp only: the tail compaction gathers whole columns,
//   kernels/intersect.py).
// - A launch of more rays than the card holds threads at eight lanes each
//   (the full-batch rounds, 147,456 lanes) is throughput-bound, and eight
//   lanes per ray issue about twice the instructions per pop; it takes one
//   thread per ray (top_kernel_x1) with the stack in the (S, Bp) array.
// The demand histogram is built in shared memory with atomics and flushed
// once per block. The earlier design was top_kernel_x1 on the unpacked
// table for every launch.
//
// B6. The kernel, its bound and its design are in pair_intersect.cuh (one
// thread per sorted position); pair_kernel.cuh keeps the earlier design (a
// block per work item) as the baseline of the ablation in pair_variants.cu.
//
// B7. What bounds it: bytes, the 160 bytes of each winner's 512-byte
// attribute row that write_rows reads (192 with tangents), its li, hu, hv,
// and 64 or 96 bytes of rows written. The earlier design ran one block of
// PB = 256 threads per work item over the static item cap n_pb + min(n_sl,
// P) (kernels/intersect.py::_wf_work_items): ~100,600 blocks (25.7 million
// threads) for 147,456 sorted positions on the 100k-instance field, whose
// items cover ~2.5 positions each, and ~2,056 blocks for a straggler batch
// of 2,048; nearly every thread exited at once, and each live one read ~40
// scalar columns of its row. Now, as B6 does, a block takes a tile of
// AT_TILE = 256 consecutive sorted positions, ceil(P / 256) tiles, one
// thread per position: a tile past the last item's positions exits at
// once, warp 0 brackets the tile's candidate items with the warp-wide
// search of bvh_common.cuh (tile_items: n_items is read on the device, no
// host sync), the block stages their covered spans in shared memory, and
// each thread binary-searches them (covering). A position no item covers
// (a miss, keyed n_sl and sorted last, or padding) keeps the caller's
// zeros. The covered thread reads its row's touched 32-byte sectors as
// 16-byte loads into registers (RowRegs; the table must be 16-byte
// aligned) and runs the interpolation of _attr_kernel (pallas_bvh.py:
// 750-786) in the plain version's order. With an instance word per item
// (two-level scenes, pallas_bvh.py:788-825) the row is rotated by the
// instance's normal matrix and takes its material override
// (bvh_common.cuh::write_row_values); without one the rows stay in mesh
// space and keep mat_id.
//
// Numerics match the plain PyTorch versions (kernels/bvh.py): built with
// -fmad=false and no fast-math; min/max propagate NaN like jnp/torch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_common.cuh"
#include "pair_intersect.cuh"

namespace {

using namespace lupin_bvh;

constexpr int HIST_MAX = 4096;
constexpr int AT_TILE = 256;  // B7: sorted positions per block
constexpr int TOP_THREADS = 128;
constexpr int TOP_RAYS = TOP_THREADS / TOP_FAN;  // rays per block

constexpr unsigned FULL = 0xffffffffu;

// One compare-exchange of the sort network between this lane (slot c of
// its ray's 8, whose first lane is base) and slot p: the lower slot keeps
// the smaller t, swapping only on a strict >. The whole warp takes part.
__device__ __forceinline__ void cmp_swap(float& t, int& r, int c, int p,
                                         int base) {
  const float tp = __shfl_sync(FULL, t, base + p);
  const int rp = __shfl_sync(FULL, r, base + p);
  const bool swap = c < p ? t > tp : (c > p && tp > t);
  if (swap) {
    t = tp;
    r = rp;
  }
}

__global__ void __launch_bounds__(TOP_THREADS)
top_kernel_x8(const float4* __restrict__ geo, const int* __restrict__ refs,
           const float* __restrict__ rox, const float* __restrict__ roy,
           const float* __restrict__ roz, const float* __restrict__ rdx,
           const float* __restrict__ rdy, const float* __restrict__ rdz,
           const float* __restrict__ best_t, const int* __restrict__ sp_in,
           int S, int Q, int Bp, int nslp, int* __restrict__ stack,
           int* __restrict__ sl_out, int* __restrict__ cnt_out,
           int* __restrict__ sp_out, int* __restrict__ hist,
           int* __restrict__ aabb_out) {
  __shared__ int shist[HIST_MAX];
  extern __shared__ int sstack[];  // TOP_RAYS x S
  for (int i = threadIdx.x; i < nslp; i += TOP_THREADS) shist[i] = 0;
  __syncthreads();

  const int c = threadIdx.x & (TOP_FAN - 1);
  const int base = threadIdx.x & 31 & ~(TOP_FAN - 1);  // the ray's first lane
  const int rb = threadIdx.x / TOP_FAN;
  const int ray = blockIdx.x * TOP_RAYS + rb;
  const bool valid = ray < Bp;
  int* st = sstack + rb * S;
  float o[3] = {0.0f, 0.0f, 0.0f}, iv[3] = {0.0f, 0.0f, 0.0f};
  float bt = 0.0f;
  int sp = 0, cnt = 0, aabb = 0;
  if (valid) {
    o[0] = rox[ray]; o[1] = roy[ray]; o[2] = roz[ray];
    iv[0] = 1.0f / rdx[ray]; iv[1] = 1.0f / rdy[ray]; iv[2] = 1.0f / rdz[ray];
    bt = best_t[ray];
    sp = sp_in[ray];
  }
  int lw = sp;  // entries [lw, sp) are in shared memory, [0, lw) in stack
  const unsigned below = (1u << c) - 1u;
  // The warp's four rays step together, one pop each per iteration, so its
  // lanes stay converged; a ray without work idles through the step.
  for (;;) {
    const bool live = sp > 0 && cnt < Q;
    if (!__any_sync(FULL, live)) break;
    int node = 0;
    if (live) {
      --sp;
      if (sp < S) {
        if (sp < lw) {
          node = stack[(size_t)sp * Bp + ray];
          lw = sp;
        } else {
          node = st[sp];
        }
      }
    }
    __syncwarp();  // every lane has read the entry a push may overwrite
    if (live && node < 0) {  // leaf pop: emit
      if (c == 0) {
        sl_out[(size_t)cnt * Bp + ray] = -node - 1;
        if (nslp > 0) atomicAdd(&shist[-node - 1], 1);
      }
      ++cnt;
    }
    const bool inner = live && node >= 0;
    float ts = F32_MAX;
    int ref = 0;
    if (inner) {
      const float4 p = geo[(size_t)node * (TOP_FAN * 2) + 2 * c];
      const float4 q = geo[(size_t)node * (TOP_FAN * 2) + 2 * c + 1];
      const int pref = refs[(size_t)node * TOP_FAN + c];
      const float lo[3] = {p.x, p.y, p.z}, hi[3] = {p.w, q.x, q.y};
      float tn, tf;
      slab(o, iv, lo, hi, tn, tf);
      const float t_c = (tf >= tn && tf > 0.0f) ? tn : F32_MAX;
      ts = q.z > -0.5f ? t_c : F32_MAX;
      ref = (pref & 1) ? -(pref >> 1) - 1 : (pref >> 1);
    }
    // The 19-comparator network (pallas_bvh.py:205-218) in six layers of
    // disjoint pairs: (0,1)(2,3)(4,5)(6,7); (0,2)(1,3)(4,6)(5,7);
    // (1,2)(5,6); (0,4)(1,5)(2,6)(3,7); (2,4)(3,5); (1,2)(3,4)(5,6).
    cmp_swap(ts, ref, c, c ^ 1, base);
    cmp_swap(ts, ref, c, c ^ 2, base);
    cmp_swap(ts, ref, c, (c == 1 || c == 2 || c == 5 || c == 6) ? c ^ 3 : c, base);
    cmp_swap(ts, ref, c, c ^ 4, base);
    cmp_swap(ts, ref, c, (c >= 2 && c <= 5) ? c ^ 6 : c, base);
    cmp_swap(ts, ref, c, (c >= 1 && c <= 6) ? ((c - 1) ^ 1) + 1 : c, base);
    // Near -> far: the k-th leaf hit is emitted while cnt + k < Q; the
    // other hits are pushed far -> near (the farthest deepest).
    const bool hit = inner && ts < bt;
    const unsigned hl = (__ballot_sync(FULL, hit && ref < 0) >> base) & 0xffu;
    const int k = __popc(hl & below);
    const bool em = hit && ref < 0 && cnt + k < Q;
    if (em) {
      sl_out[(size_t)(cnt + k) * Bp + ray] = -ref - 1;
      if (nslp > 0) atomicAdd(&shist[-ref - 1], 1);
    }
    const bool rem = hit && !em;
    const unsigned rm = (__ballot_sync(FULL, rem) >> base) & 0xffu;
    if (rem) {
      const int pos = sp + __popc(rm >> (c + 1));
      if (pos < S) st[pos] = ref;
    }
    if (inner) {
      cnt += min(__popc(hl), Q - cnt);
      sp += __popc(rm);
      aabb += TOP_FAN;
    }
    __syncwarp();  // the pushes are visible to the next pop
  }
  if (valid) {
    for (int e = lw + c; e < min(sp, S); e += TOP_FAN)
      stack[(size_t)e * Bp + ray] = st[e];
    for (int e = cnt + c; e < Q; e += TOP_FAN) sl_out[(size_t)e * Bp + ray] = -1;
    if (c == 0) {
      cnt_out[ray] = cnt;
      sp_out[ray] = sp;
      aabb_out[ray] = aabb;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nslp; i += TOP_THREADS)
    if (shist[i] != 0) atomicAdd(&hist[i], shist[i]);
}

// The 19-comparator network (pallas_bvh.py:205-218), swap on strict >.
__device__ __forceinline__ void sort8(float ts[TOP_FAN], int refs[TOP_FAN]) {
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
}

// One thread per ray, for launches with more rays than the card holds
// threads at eight lanes each: the stack stays in the (S, Bp) array, a
// pop's row is 18 wide loads of the packed rows.
__global__ void __launch_bounds__(TOP_THREADS)
top_kernel_x1(const float4* __restrict__ geo, const int* __restrict__ refs,
              const float* __restrict__ rox, const float* __restrict__ roy,
              const float* __restrict__ roz, const float* __restrict__ rdx,
              const float* __restrict__ rdy, const float* __restrict__ rdz,
              const float* __restrict__ best_t, const int* __restrict__ sp_in,
              int S, int Q, int Bp, int nslp, int* __restrict__ stack,
              int* __restrict__ sl_out, int* __restrict__ cnt_out,
              int* __restrict__ sp_out, int* __restrict__ hist,
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
      const float4* row = geo + (size_t)node * (TOP_FAN * 2);
      const int4* rr = reinterpret_cast<const int4*>(refs + (size_t)node * TOP_FAN);
      const int4 r0 = rr[0], r1 = rr[1];
      int ch[TOP_FAN] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      float ts[TOP_FAN];
#pragma unroll
      for (int c = 0; c < TOP_FAN; ++c) {
        const float4 p = row[2 * c], q = row[2 * c + 1];
        const float lo[3] = {p.x, p.y, p.z}, hi[3] = {p.w, q.x, q.y};
        float tn, tf;
        slab(o, iv, lo, hi, tn, tf);
        const float t_c = (tf >= tn && tf > 0.0f) ? tn : F32_MAX;
        ts[c] = q.z > -0.5f ? t_c : F32_MAX;
        ch[c] = (ch[c] & 1) ? -(ch[c] >> 1) - 1 : (ch[c] >> 1);
      }
      sort8(ts, ch);
      bool rem[TOP_FAN];
#pragma unroll
      for (int c = 0; c < TOP_FAN; ++c) {  // near -> far: emit leaves
        const bool hit = ts[c] < bt;
        const bool em = hit && ch[c] < 0 && cnt < Q;
        if (em) {
          sl_out[(size_t)cnt * Bp + lane] = -ch[c] - 1;
          if (nslp > 0) atomicAdd(&shist[-ch[c] - 1], 1);
          ++cnt;
        }
        rem[c] = hit && !em;
      }
#pragma unroll
      for (int c = TOP_FAN - 1; c >= 0; --c) {  // far -> near: push the rest
        if (rem[c]) {
          if (sp < S) stack[(size_t)sp * Bp + lane] = ch[c];
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

// B7: one thread per sorted position of a tile of AT_TILE.
__global__ void __launch_bounds__(AT_TILE)
attr_kernel(const int* __restrict__ blk, const int* __restrict__ msl,
            const int* __restrict__ lo, const int* __restrict__ hi,
            const int* __restrict__ n_items, const int* __restrict__ li,
            const float* __restrict__ hu, const float* __restrict__ hv,
            const float* __restrict__ A, const int* __restrict__ inst,
            const float* __restrict__ nrm, const int* __restrict__ ovr, int SP,
            int aw, int PB, int P, int awout, float* __restrict__ out) {
  __shared__ int kbe[2];
  __shared__ int item_c[AT_TILE];  // first covered position of each candidate
  __shared__ int item_e[AT_TILE];  // one past its last
  const int n = *n_items;
  if (n <= 0) return;
  const int p0 = blockIdx.x * AT_TILE;
  // Positions past the last item's are covered by no item (uniform).
  if (p0 >= max(cov_start(blk, lo, PB, n - 1), cov_end(blk, hi, PB, P, n - 1)))
    return;
  if (threadIdx.x < 32) {
    int kb, ke;
    tile_items(blk, lo, PB, n, p0, AT_TILE, kb, ke);
    if (threadIdx.x == 0) {
      kbe[0] = kb;
      kbe[1] = ke;
    }
  }
  __syncthreads();
  const int kb = kbe[0], ke = kbe[1];
  const int pos = p0 + threadIdx.x;
  int item = -1;
  for (int cb = kb; cb < ke; cb += AT_TILE) {
    const int nc = min(AT_TILE, ke - cb);
    if (cb > kb) __syncthreads();
    if (threadIdx.x < nc) {
      item_c[threadIdx.x] = cov_start(blk, lo, PB, cb + threadIdx.x);
      item_e[threadIdx.x] = cov_end(blk, hi, PB, P, cb + threadIdx.x);
    }
    __syncthreads();
    const int i = covering(item_c, item_e, nc, pos);
    if (i >= 0) item = cb + i;
  }
  if (item < 0) return;
  RowRegs row;
  row.load(reinterpret_cast<const float4*>(A + ((size_t)msl[item] * SP + li[pos]) * aw),
           awout >= 24);
  const float* nm = nullptr;
  int o = -1;
  if (inst != nullptr) {
    nm = nrm + (size_t)inst[item] * 9;
    o = ovr[inst[item]];
  }
  write_row_values(row, hu[pos], hv[pos], awout, out + pos, (size_t)P, nm, o);
}

}  // namespace

// geo (rows, 8, 8) f32 and refs (rows, 8) i32 (kernels/bvh.py::top_rows);
// rays/best_t (Bp,); sp_in (Bp,); stack (S, Bp), updated in place (entries
// below each lane's new sp). Outputs sl (Q, Bp), cnt, sp, hist (nslp,)
// zeroed by the caller (nslp = 0: no histogram), aabb. Returns
// cudaGetLastError().
extern "C" int lupin_top_traverse(const float* geo, const int* refs,
                                  const float* rox, const float* roy,
                                  const float* roz, const float* rdx,
                                  const float* rdy, const float* rdz,
                                  const float* best_t, const int* sp_in, int S,
                                  int Q, int Bp, int nslp, int* stack, int* sl,
                                  int* cnt, int* sp, int* hist, int* aabb,
                                  void* stream) {
  if (nslp > HIST_MAX || S < 1 || S > 256) return (int)cudaErrorInvalidValue;
  if (Bp == 0) return (int)cudaGetLastError();
  static int resident = 0;  // threads the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    resident = sms * per_sm;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float4* g = reinterpret_cast<const float4*>(geo);
  if ((long long)Bp * TOP_FAN <= resident) {
    top_kernel_x8<<<(Bp + TOP_RAYS - 1) / TOP_RAYS, TOP_THREADS,
                    TOP_RAYS * S * sizeof(int), st>>>(
        g, refs, rox, roy, roz, rdx, rdy, rdz, best_t, sp_in, S, Q, Bp, nslp,
        stack, sl, cnt, sp, hist, aabb);
  } else {
    top_kernel_x1<<<(Bp + TOP_THREADS - 1) / TOP_THREADS, TOP_THREADS, 0, st>>>(
        g, refs, rox, roy, roz, rdx, rdy, rdz, best_t, sp_in, S, Q, Bp, nslp,
        stack, sl, cnt, sp, hist, aabb);
  }
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

// Items as above; li/hu/hv (P,); A (n_msl, SP, aw), 16-byte aligned, aw a
// multiple of 4 and at least 60; inst (n_cap,) with nrm (n_inst, 9) and ovr
// (n_inst,), or all three null. out (awout, P), zeroed by the caller (the
// positions no item covers keep it). One block per tile of AT_TILE sorted
// positions; n_cap only tells an empty launch.
extern "C" int lupin_attr_fetch(const int* blk, const int* msl, const int* lo,
                                const int* hi, const int* n_items,
                                const int* li, const float* hu,
                                const float* hv, const float* A,
                                const int* inst, const float* nrm,
                                const int* ovr, int n_cap, int SP, int aw,
                                int PB, int P, int awout, float* out,
                                void* stream) {
  if (PB < 1) return (int)cudaErrorInvalidValue;
  if ((inst == nullptr) != (nrm == nullptr) || (inst == nullptr) != (ovr == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)A) & 15u) != 0 || aw % 4 != 0 || aw < 60)
    return (int)cudaErrorInvalidValue;  // 16-byte row reads up to column 59
  if (n_cap == 0 || P == 0) return (int)cudaGetLastError();
  attr_kernel<<<(P + AT_TILE - 1) / AT_TILE, AT_TILE, 0, (cudaStream_t)stream>>>(
      blk, msl, lo, hi, n_items, li, hu, hv, A, inst, nrm, ovr, SP, aw, PB, P,
      awout, out);
  return (int)cudaGetLastError();
}
