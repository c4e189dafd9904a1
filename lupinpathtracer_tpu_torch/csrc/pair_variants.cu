// Kernel B6': the ablation variants of the pair kernel (pair_kernel.cuh),
// for lupinpathtracer_tpu_torch/tools/prof_pair.py.
//
// Replaces lupinpathtracer_tpu/tools/prof_pair.py::run_variant /
// make_kernel (pallas_call at :276). Each variant is an instantiation of
// B6's own kernel template, so a difference in time between two of them is
// the cost of the part that differs. V4, the TPU's "TB = SP" (one pass over
// the superleaf per item), becomes the largest triangle tile that fits a
// block's 227 KB of shared memory: 1024 triangles (160 KB) for SP >= 1024,
// 512 for SP >= 512, else the shipped 256.

#include <cuda_runtime.h>

#include "pair_kernel.cuh"

using namespace lupin_bvh;

// variant: 0-5 as in pair_kernel.cuh. The other arguments are those of
// lupin_pair_intersect (bvh.cu). Returns cudaGetLastError().
extern "C" int lupin_pair_variant(int variant, const int* blk, const int* msl,
                                  const int* lo, const int* hi,
                                  const int* n_items, const int* inst,
                                  const float* txf, const float* rox,
                                  const float* roy, const float* roz,
                                  const float* rdx, const float* rdy,
                                  const float* rdz, const float* W,
                                  long long T, int n_cap, int SP, int PB,
                                  int P, float eps, float* t, float* u,
                                  float* v, float* det, int* li,
                                  void* stream) {
  const PairArgs a{blk, msl, lo,  hi, n_items, inst, txf, rox, roy,
                   roz, rdx, rdy, rdz, W,      T,    n_cap, SP, PB,
                   P,   eps, t,   u,   v,      det,  li};
  switch (variant) {
    case 0: return launch_pair<PAIR_V0, PAIR_TC>(a, stream);
    case 1: return launch_pair<PAIR_V1, PAIR_TC>(a, stream);
    case 2: return launch_pair<PAIR_V2, PAIR_TC>(a, stream);
    case 3: return launch_pair<PAIR_V3, PAIR_TC>(a, stream);
    case 4:
      if (SP >= 1024) return launch_pair<PAIR_V0, 1024>(a, stream);
      if (SP >= 512) return launch_pair<PAIR_V0, 512>(a, stream);
      return launch_pair<PAIR_V0, PAIR_TC>(a, stream);
    case 5: return launch_pair<PAIR_V5, PAIR_TC>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
