"""Occupancy sweep of kernel B1/B2 on the card: how many blocks per SM
should its registers allow?

    python3 -m lupinpathtracer_tpu_torch.tools.prof_dense [--reps N]

csrc/dense_intersect.cu asks __launch_bounds__ for MIN_BLOCKS blocks of
128 threads per SM (at most 65536 / (128 x MIN_BLOCKS) registers a
thread). This tool compiles a copy of that source for each value of
VALUES (prof_pair.build_copies) into the build directory and times each
build, in turns, at chip_smoke.py's timing shapes
(tools/replay.dense_timing_rays): B2 on 524,288 rays against the Cornell
box (36 triangles, bound by its stores) and against the box with a
520-triangle sphere (556, bound by operations), and B1 on the 262,144
camera rays against the Cornell box. Every build computes the same
function with the same operations: each output must equal the checkout's
build bit for bit. One JSON line per variant: the registers and spill
bytes ptxas reports for both instantiations of dense_hit_kernel, the mean
device time per shape (torch.profiler) and the card's name and power
limit. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import numpy as np
import torch

from ..kernels import dense_intersect as dk
from .prof_pair import build_copies, kernel_ms, ptxas_usage

VALUES = (6, 8, 10, 12)  # blocks of 4 warps per SM: 80, 64, 48, 40 registers
BOUND = "constexpr int MIN_BLOCKS = 8;"  # as csrc/dense_intersect.cu has it

# The copies of csrc/dense_intersect.cu, one per value; the shipped value's
# is the source as it is.
VARIANTS = {f"min_blocks_{v}": () if f"= {v};" in BOUND else (
    (BOUND, f"constexpr int MIN_BLOCKS = {v};"),) for v in VALUES}


def usage(log: str) -> dict:
    """{"b2" | "b1": (registers, spill store bytes)} of the two
    dense_hit_kernel instantiations in a copy's ptxas output."""

    out = {}
    for name, use in ptxas_usage(log).items():
        m = re.search(r"dense_hit_kernelILb([01])E", name)
        if m:
            out["b2" if m.group(1) == "1" else "b1"] = use
    return out


def shapes(dev) -> dict:
    """{shape: (W, R, A or None)} at chip_smoke.py's timing shapes."""

    from .. import build_scene_torch
    from ..core.types import PathtraceDesc
    from ..io import builtin
    from ..kernels import intersect
    from ..render.renderer import _camera_args
    from .replay import dense_timing_rays, sphere_cornell

    box, cams = builtin.build_scene_cornell_box()
    desc = PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    R_cam, R_wf = dense_timing_rays(_camera_args(desc), dev)
    out = {}
    for name, scene in (("cornell", build_scene_torch(box, device=dev)),
                        ("sphere_556", build_scene_torch(sphere_cornell()[0],
                                                         device=dev))):
        W = intersect.scene_tri_matrix(scene)
        out[f"b2_{name}"] = (W, R_wf, scene.wt_attr[: W.shape[2]])
        if name == "cornell":
            out["b1_cornell"] = (W, R_cam, None)
    return out


def sweep(reps: int = 10) -> dict:
    """{variant: dict(ms per shape, registers, spill_bytes)}, the variants
    timed in turns (VARIANTS, then reversed; each ms the mean of both).
    Raises if a build's output differs from the checkout's build."""

    from ..kernels import bvh, cuda_build

    dev = torch.device("cuda", 0)
    builds = {k: (dk.bind(lib), log)
              for k, (lib, log) in build_copies("dense_intersect", VARIANTS).items()}
    eps = float(np.float32(1e-3))
    cases = shapes(dev)
    shipped = cuda_build.load("dense_intersect", dk.bind)
    ref = {k: dk._launch(shipped, bvh.pair_table(W), R, eps, W.shape[2], A)
           for k, (W, R, A) in cases.items()}
    times = {v: {k: [] for k in cases} for v in VARIANTS}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for v in order:
            for k, (W, R, A) in cases.items():
                ms, out, _ = kernel_ms(lambda: dk._launch(
                    builds[v][0], bvh.pair_table(W), R, eps, W.shape[2], A),
                    "dense_hit_kernel", reps)
                if not all((a is None and b is None) or torch.equal(a, b)
                           for a, b in zip(out, ref[k])):
                    raise AssertionError(f"variant {v} changed B1/B2's output on {k}")
                times[v][k].append(ms)
    res = {}
    for v in VARIANTS:
        use = usage(builds[v][1])
        res[v] = dict(ms={k: float(np.mean(t)) for k, t in times[v].items()},
                      registers={k: u[0] for k, u in use.items()},
                      spill_bytes={k: u[1] for k, u in use.items()})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_dense: no CUDA GPU available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for v, r in sweep(ns.reps).items():
        print(json.dumps(dict(variant=v, threads_per_block=dk.THREADS, **r,
                              card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
