"""Kernel B5 launch by launch on the card.

    python3 -m lupinpathtracer_tpu_torch.tools.prof_top [--reps N]

B5 (kernels/bvh.py::top_traverse, csrc/bvh.cu) runs once per wavefront
round: about 40 launches per accumulation of the terrain2M main path and
57 of instanced100k, most of them a few dozen microseconds, so a launch's
fixed cost and its traversal have to be told apart launch by launch.
`main_path_launches` records every B5 launch of one accumulation of a main
path and replays each on its recorded inputs: the kernel's device time,
the plain version's wall time and the work it counts, and the kernel's
outputs held against the plain version's (sl, cnt, sp, the histogram and
the AABB counts equal; the stack below each lane's sp, the entries a later
round reads). chip_smoke.py calls it on both BVH main paths.

The kernel takes eight lanes per ray for a launch of few rays and one
thread per ray for a full batch. Run as a program, this tool compiles two
copies of csrc/bvh.cu with that choice forced (SHAPES) and replays every
main-path launch of terrain2M and instanced100k through the shipped build
and both copies (tools/prof_pair.py::build_copies), each equal to the
shipped build: one JSON line per scene with the sums over the launches of
few rays (2,048 lanes) and of full batches, and the card's name and power
limit. Needs a CUDA GPU (and nvcc for the copies).
"""

from __future__ import annotations

import torch

from ..kernels import bvh
from .prof_pair import kernel_ms_each
from .replay import one_accumulation
from .replay import record_launches as record_launches_of


def max_abs_diff(k, p, S: int) -> float:
    """The largest absolute difference between B5's outputs (sl, cnt,
    stack, sp, histogram or None, aabb) and the plain version's, the stack
    compared below each lane's sp (the entries a later round reads); inf
    where only one of them has a histogram."""

    if (k[4] is None) != (p[4] is None):
        return float("inf")
    below = torch.arange(S, device=k[3].device)[:, None] < k[3][None, :]
    pairs = [(k[i], p[i]) for i in (0, 1, 3, 5)]
    pairs.append((torch.where(below, k[2], 0), torch.where(below, p[2], 0)))
    if k[4] is not None:
        pairs.append((k[4], p[4]))
    return max(float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def record_launches(scene, desc, width: int, height: int, spp: int,
                    bounces: int, run=None) -> list:
    """[(tab, ro, rd, best_t, stack, sp, keywords)] of every B5 launch of one
    accumulation of the main path (or of run(): a debug dispatch's counting
    pass), each with copies of its inputs (the kernel updates its stack in
    place; tools/replay.record_launches)."""

    rec = record_launches_of(bvh, "top_traverse",
                             run or one_accumulation(scene, desc, width, height,
                                                     spp, bounces),
                             share=(0,))
    return [(*a, k) for a, k in rec]


def main_path_launches(scene, desc, width: int, height: int, spp: int,
                       bounces: int, reps: int = 3, run=None) -> list:
    """Every B5 launch of one accumulation of the BVH main path, recorded
    and replayed: per launch its lanes, the lanes with a stack (live), Q,
    the histogram's length (0: none), the plain version's pops, pushes,
    internal pops and distinct rows read, the emits and AABB tests, the
    kernel's device ms (prof_pair.kernel_ms_each: the launches in turn,
    three times, in a few profiler windows), the plain version's ms (CUDA
    events) and the largest difference between their outputs
    (max_abs_diff), which must be 0."""

    rec = record_launches(scene, desc, width, height, spp, bounces, run)
    real = bvh.top_traverse
    timed = kernel_ms_each([lambda r=r: real(r[0], r[1], r[2], r[3], r[4].clone(),
                                             r[5], **r[6]) for r in rec],
                           "top_kernel", reps)
    out = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for (tab, ro, rd, best_t, stack, sp, kw), (ms, by) in zip(rec, timed):
        k = real(tab, ro, rd, best_t, stack.clone(), sp, **kw)
        counts: dict = {}
        st = stack.clone()
        torch.cuda.synchronize()
        start.record()
        p = bvh.top_traverse_plain(tab, ro, rd, best_t, st, sp, counts=counts, **kw)
        end.record()
        torch.cuda.synchronize()
        err = max_abs_diff(k, p, kw["S"])
        if err != 0.0:
            raise AssertionError("B5 and its plain version disagree on a "
                                 "main-path launch")
        out.append(dict(lanes=int(sp.shape[0]), live=int((sp > 0).sum()),
                        Q=kw["Q"], hist_bins=0 if k[4] is None else int(k[4].numel()),
                        pops=counts["pops"], pushes=counts["pushes"],
                        internal_pops=counts["internal_pops"],
                        rows_read=counts["rows_read"], emits=int(k[1].sum()),
                        aabb_tests=int(k[5].sum()), max_abs_err=err,
                        ms=ms, plain_ms=start.elapsed_time(end), timed_by=by))
    return out


_SHAPE = "(long long)Bp * TOP_FAN <= resident"
SHAPES = {"eight_lanes": ((_SHAPE, "true"),), "one_lane": ((_SHAPE, "false"),)}


def shapes(scene, desc, width: int, height: int, spp: int, bounces: int,
           libs: dict, reps: int = 3) -> dict:
    """Every B5 launch of one main-path accumulation replayed through the
    shipped build and through each library of `libs` ({shape: loaded
    copy of csrc/bvh.cu}); {name: {"few": ms, "full": ms}}, the sums over
    the launches of at most 2,048 lanes and of more. Raises if a copy's
    outputs differ from the shipped build's."""

    from ..kernels import cuda_build

    rec = record_launches(scene, desc, width, height, spp, bounces)
    out = {}
    shipped = cuda_build.load("bvh", bvh.bind)
    for name, lib in {"shipped": shipped, **libs}.items():
        calls = [lambda r=r, lib=lib: bvh._top_launch(
            lib, r[0], r[1], r[2], r[3], r[4].clone(), r[5], **r[6]) for r in rec]
        timed = kernel_ms_each(calls, "top_kernel", reps)
        ref = [bvh._top_launch(shipped, r[0], r[1], r[2], r[3],
                               r[4].clone(), r[5], **r[6]) for r in rec]
        for call, k, r in zip(calls, ref, rec):
            if max_abs_diff(call(), k, r[6]["S"]) != 0.0:
                raise AssertionError(f"B5 shape {name} changed a launch's outputs")
        few = sum(ms for (ms, _), r in zip(timed, rec) if r[5].shape[0] <= 2048)
        out[name] = dict(few=few, full=sum(ms for ms, _ in timed) - few,
                         timed_by=sorted({by for _, by in timed}))
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import subprocess
    import sys

    from .. import build_scene_torch
    from ..core.types import PathtraceDesc, PathtraceType
    from ..io import synthetic
    from .prof_pair import build_copies

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_top: no CUDA GPU available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = {k: bvh.bind(v[0]) for k, v in build_copies("bvh", SHAPES).items()}
    dev = torch.device("cuda", 0)
    for name, make in (
            ("terrain2M", lambda: synthetic.build_scene_terrain(n_tris=2_000_000, seed=0)),
            ("instanced100k", lambda: synthetic.build_scene_instanced_field(
                100_000, seed=0, tris_per_mesh=64))):
        cpu_scene, cams = make()
        scene = build_scene_torch(cpu_scene, device=dev)
        desc = PathtraceDesc()
        desc.camera_transform = cams[0].transform
        desc.camera_params = cams[0].params
        desc.pathtrace_type = PathtraceType.STANDARD
        desc.advanced.max_radiance = 10.0
        res = shapes(scene, desc, 512, 288, 4, 8, libs, ns.reps)
        print(json.dumps(dict(scene=name, ms=res, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
