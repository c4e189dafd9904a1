"""Occupancy sweep of kernel B3 on the card: how many blocks per SM should
its registers allow?

    python3 -m lupinpathtracer_tpu_torch.tools.prof_mega [--reps N]

csrc/mega.cu asks __launch_bounds__ for at least 8 blocks of 128 threads
per SM (at most 65536 / (128 x 8) = 64 registers a thread). This tool
compiles a copy of that source for each value of VALUES, the bound's
second argument replaced (0: no second argument, as B3's earlier design
had it; ptxas then picks fewer registers than with 1, the loosest value),
into the build directory (prof_pair.build_copies), and times each
build on the Cornell main path's launch (512x512 pixels, 64 spp, 8
bounces, STANDARD), in turns.
Every build computes the same function with the same operations: each
output must equal the checkout's build bit for bit. One JSON line per
value: the registers and spill bytes ptxas reports for each instantiation
of mega_kernel (the triangle table in shared memory or read through L1;
the acc mode the sweep times, and the dispatch mode),
the mean device time (torch.profiler) and the card's name and power
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

from ..kernels import mega
from .prof_pair import build_copies, kernel_ms, ptxas_usage

VALUES = (0, 1, 8, 10, 12, 16)  # 16 blocks of 4 warps fill an SM's 64 warps
BOUND = "__launch_bounds__(THREADS, 8)"  # as csrc/mega.cu has it


def _bound(v: int) -> str:
    return f"__launch_bounds__(THREADS{f', {v}' if v else ''})"


# The copies of csrc/mega.cu (prof_pair.build_copies), one per value; the
# shipped value's is the source as it is.
VARIANTS = {f"min_blocks_{v}": () if _bound(v) == BOUND else ((BOUND, _bound(v)),)
            for v in VALUES}


def usage(log: str) -> dict:
    """{"smem" | "global", + ".dispatch" for the dispatch mode: (registers,
    spill store bytes)} of the mega_kernel instantiations (the triangle
    table in shared memory or read through L1; the acc or the dispatch
    mode) in a copy's ptxas output."""

    out = {}
    for name, use in ptxas_usage(log).items():
        m = re.search(r"mega_kernelILb([01])E(?:Lb([01])E)?", name)
        if m:
            key = "smem" if m.group(1) == "1" else "global"
            out[key + (".dispatch" if m.group(2) == "1" else "")] = use
    return out


def main_path_launch(dev):
    """(scene, W, the launch's arguments after W, eps) of the Cornell main
    path's B3 launch (chip_smoke.py's timing shapes)."""

    from .. import build_scene_torch
    from ..core.types import PathtraceDesc, PathtraceType
    from ..io import builtin
    from ..kernels import intersect
    from ..render.renderer import _camera_args, _pixel_batch

    cornell, cams = builtin.build_scene_cornell_box()
    scene = build_scene_torch(cornell, device=dev)
    desc = PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    gx, gy = _pixel_batch(512, 512, 0, 0, dev)
    args = (gy * 512 + gx, gx, gy, (512.0, 512.0), _camera_args(desc), False,
            0, 0, 64, int(PathtraceType.STANDARD), 8, 100.0)
    return scene, intersect.scene_tri_matrix(scene), args, float(np.float32(1e-3))


def sweep(reps: int = 3) -> dict:
    """{value: dict(ms, runs_ms, registers, spill_bytes)}, the values timed
    in turns (VALUES, then reversed; ms is the mean of both). Raises if a
    build's output differs from the checkout's build."""

    dev = torch.device("cuda", 0)
    builds = dict(zip(VALUES, build_copies("mega", VARIANTS).values()))
    scene, W, args, eps = main_path_launch(dev)
    ref = mega._launch(scene, W, *args, eps, 0)
    times = {v: [] for v in VALUES}
    for order in (VALUES, VALUES[::-1]):
        for v in order:
            ms, (acc, nt), _ = kernel_ms(
                lambda: mega._launch(scene, W, *args, eps, 0, lib=builds[v][0]),
                "mega_kernel", reps)
            if not (torch.equal(nt, ref[1])
                    and all(torch.equal(a, b) for a, b in zip(acc, ref[0]))):
                raise AssertionError(f"{v} blocks per SM changed B3's output")
            times[v].append(ms)
    out = {}
    for v in VALUES:
        use = usage(builds[v][1])
        out[v] = dict(ms=float(np.mean(times[v])), runs_ms=times[v],
                      registers={k: u[0] for k, u in use.items()},
                      spill_bytes={k: u[1] for k, u in use.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_mega: no CUDA GPU available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for v, r in sweep(ns.reps).items():
        print(json.dumps(dict(min_blocks_per_sm=v, threads_per_block=128, **r,
                              card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
