"""Pair-kernel ablation on the card: where does B6's time go?

    python3 -m lupinpathtracer_tpu_torch.tools.prof_pair [--reps N]

The counterpart of the JAX repo's tools/prof_pair.py. It times the variants
of kernel B6 (csrc/pair_kernel.cuh; wrapper
kernels/bvh.py::pair_intersect_variant) on one real round-1 state of the
BVH wavefront, so that the difference between two variants is the cost of
the part that differs:

  V0    B6's earlier design, a block per work item (equal to
        pair_intersect, csrc/pair_intersect.cuh, bit for bit)
  V1    selection t by rsqrt(det^2) and sign tests instead of the divide,
        the winner recomputed exactly
  V2    (t, index) only: no u, v, det
  V3    V1 + V2
  V4    the largest triangle tile that fits shared memory (1024 triangles
        for a stride >= 1024; the shipped tile is 256)
  V5    the products and min(nt), no validity (ptxas drops the three
        products kept alive only by an empty asm: not a floor)
  GRID  every item empty (lo == hi): the cost of the launch and its blocks

A round-1 state is what the first wavefront round hands B6: the camera
batch through B5, the superleaf sort and the work items
(kernels/intersect.py::_wf_pairs). Two states are timed, both 512x288
camera batches: the 2M-triangle terrain (699 superleaves of 4096
triangles) and the 100,000-instance field (about 100k superleaves of 256
triangles, each item's rays moved to mesh space in the kernel). Each line is one
variant: its mean device time over the profiler's records of the kernel,
the state, and the card's name and power limit. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .._paths import BUILD_DIR
from ..core import rng as rng_mod
from ..core.types import PathtraceDesc
from ..core.vec3 import V3
from ..kernels import bvh, cuda_build, intersect
from ..render import integrators
from ..render.renderer import _camera_args, _pixel_batch

F32_MAX = bvh.F32_MAX
VARIANTS = (*bvh.PAIR_VARIANTS, "GRID")


def kernel_ms(fn, kernel: str, reps: int):
    """(ms, out, timed_by): the mean device milliseconds of the CUDA kernel
    whose name contains `kernel`, which fn() launches once per call, over
    reps calls (torch.profiler, CUDA activity, after one warm-up call), the
    output of the last call, and "device_records". CUDA events around a
    loop of calls would also count the host's launch overhead, which is
    longer than the shortest kernels run. The profiler sometimes keeps none
    of a short window's records (and then none of an immediate repeat's
    either), so the launches sit between two pauses inside the window and a
    window that kept too few records is taken again with longer pauses.
    After that the calls are timed one by one with CUDA events, host
    overhead included, and timed_by is "events": another quantity, which
    the caller must report as such."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    for pause in (0.05, 0.5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            for _ in range(reps):
                out = fn()
            torch.cuda.synchronize()
            time.sleep(pause)
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if reps // 2 < len(spans) <= reps:
            return sum(spans) / len(spans) / 1e3, out, "device_records"
        print(f"# kernel_ms: the profiler kept {len(spans)} of {reps} records "
              f"of {kernel} (pauses of {pause} s)", file=sys.stderr, flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, out, "events"


def _records(fns, kernel: str, reps: int, pause: float = 0.05):
    """Spans (start, end) of the device records of `kernel` while fns run in
    turn reps times inside one profiler window, in start order."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pause)
        for _ in range(reps):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
        time.sleep(pause)
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and kernel in e.name)


def kernel_ms_each(calls, kernel: str, reps: int, group: int = 8):
    """[(ms, timed_by)] per call of `calls`, each launching the kernel whose
    name contains `kernel` once: a group of calls runs in turn reps times
    inside one profiler window (after a warm-up round), and each call's
    device records are averaged. The profiler drops a record of a short
    kernel now and then, and then a group's records no longer say which
    call they belong to: that group's calls get a window each, whose
    records (at least one) are all the call's; a call left with none is
    timed by kernel_ms."""

    out = []
    for g0 in range(0, len(calls), group):
        part = calls[g0:g0 + group]
        for fn in part:
            fn()
        spans = _records(part, kernel, reps)
        n = len(part)
        if len(spans) == reps * n:
            out += [(sum(spans[r * n + i][1] - spans[r * n + i][0]
                         for r in range(reps)) / reps / 1e3, "device_records")
                    for i in range(n)]
            continue
        print(f"# kernel_ms_each: the profiler kept {len(spans)} of {reps * n} "
              f"records of {kernel}; timing the group's calls one by one",
              file=sys.stderr, flush=True)
        for fn in part:
            one = _records([fn], kernel, reps)
            if one:
                out.append((sum(b - a for a, b in one) / len(one) / 1e3,
                            "device_records"))
            else:
                ms, _, by = kernel_ms(fn, kernel, reps)
                out.append((ms, by))
    return out


def build_copies(name: str, variants: dict, csrc: str = cuda_build.CSRC) -> dict:
    """{key: (loaded library, ptxas output)}: copies of <csrc>/<name>.cu
    (this checkout's sources unless `csrc` names another's), each with its
    variant's (old, new) text replacements (each old text must occur once),
    compiled into the build directory as <name>_<key>.so with the port's
    flags, -Xptxas -v and <csrc> on the include path, all nvcc processes at
    once. The profiling tools' copies of a kernel with one choice changed,
    and tools/replay.py's builds of an earlier design."""

    src = open(os.path.join(csrc, f"{name}.cu")).read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for key, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"csrc/{name}.cu must hold {old!r} once")
            text = text.replace(old, new)
        path = os.path.join(BUILD_DIR, f"{name}_{key}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = path[:-3] + ".so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", csrc, "-o", lib, path]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu ({key}):\n{log}")
        out[key] = (ctypes.CDLL(lib), log)
    return out


def ptxas_usage(log: str) -> dict:
    """{kernel's mangled name: (registers, spill store bytes)} of each entry
    function in nvcc's -Xptxas -v output, in its order."""

    usage, cur, props, spill = {}, None, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = m.group(1), 0
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur is not None and props == cur:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            usage[cur] = (int(m.group(1)), spill)
            cur = None
    return usage


def camera_rays(cam, width: int, height: int, device):
    """The first sample's camera rays of a width x height frame, in the
    renderer's lane order."""

    desc = PathtraceDesc()
    desc.camera_transform = cam.transform
    desc.camera_params = cam.params
    gx, gy = _pixel_batch(width, height, 0, 0, device)
    _, ro, rd = integrators._camera_ray_from(
        dict(cam=_camera_args(desc), is_ortho=False, gx=gx, gy=gy,
             resolution=(float(width), float(height))),
        rng_mod.init_state(gy * width + gx, 0, 0))
    return ro, rd


def round1_state(scene, ro: V3, rd: V3, Q: int = intersect.WF_Q):
    """B6's inputs in the first wavefront round of the batch (ro, rd):
    (args, kw, info) with pair_intersect(*args, W, eps, **kw), info the
    sorted keys, the sort order, n_real and the padded lane count."""

    dev = ro.x.device
    B = ro.x.shape[0]
    pad = (-B) % intersect.WF_RAY_BLOCK
    Bp = B + pad
    rop = V3(*(intersect._pad(c, pad, 0.0) for c in ro))
    rdp = V3(intersect._pad(rd.x, pad, 0.0), intersect._pad(rd.y, pad, 1.0),
             intersect._pad(rd.z, pad, 0.0))
    S = bvh.stack_depth(scene)
    c = dict(stack=torch.zeros((S, Bp), dtype=torch.int32, device=dev),
             sp=(torch.arange(Bp, device=dev) < B).to(torch.int32),
             best_t=torch.full((Bp,), F32_MAX, dtype=torch.float32, device=dev))
    args, kw, skey, order, n_real, *_ = intersect._wf_pairs(
        scene, scene.top_tab, rop, rdp, c, S=S,
        PB=intersect.WF_PAIR_BLOCK, Q=Q)
    return args, kw, dict(skey=skey, order=order, n_real=n_real, lanes=Bp)


def run_variant(variant: str, args, W, eps, kw):
    """One launch of a variant on a round-1 state; GRID is V0 over items
    that are all empty."""

    if variant == "GRID":
        blk, msl, lo, _, so, sd = args
        return bvh.pair_intersect_variant("V0", blk, msl, lo, lo, so, sd, W,
                                          eps, **kw)
    return bvh.pair_intersect_variant(variant, *args, W, eps, **kw)


def time_variants(args, W, eps, kw, reps: int = 5) -> dict:
    """{variant: (ms, output of the last launch, timed_by)} (kernel_ms)."""

    return {v: kernel_ms(lambda v=v: run_variant(v, args, W, eps, kw),
                         "pair_kernel", reps) for v in VARIANTS}


def main_path_launches(scene, desc, width: int, height: int, spp: int,
                       bounces: int, reps: int = 3, plain: bool = False,
                       run=None) -> list:
    """Every B6 launch of one accumulation of the BVH main path (or of
    run()), recorded and replayed: per launch its positions, pairs, items,
    distinct mesh superleaves, tiles of 256 positions, the mean and largest mesh superleaves per tile, the split
    the kernel takes (bvh.pair_split), and the device times of B6 and of
    V0 (its earlier design) on the same inputs (kernel_ms_each: the
    launches in a few profiler windows per kernel), which must agree bit
    for bit. With `plain`, each launch is also held equal to
    bvh.pair_intersect_plain, timed by CUDA events (plain_ms). Needs a
    CUDA GPU."""

    from .replay import _events_ms, one_accumulation, record_launches

    rec = record_launches(bvh, "pair_intersect",
                          run or one_accumulation(scene, desc, width, height, spp,
                                                  bounces),
                          share=(6, "txf_tab"))
    real = bvh.pair_intersect
    b6 = kernel_ms_each([lambda a=a, k=k: real(*a, **k) for a, k in rec],
                        "pair_hit_kernel", reps)
    v0 = kernel_ms_each([lambda a=a, k=k: bvh.pair_intersect_variant("V0", *a, **k)
                         for a, k in rec], "pair_kernel", reps)
    out = []
    for (a, k), (b6_ms, by6), (v0_ms, by0) in zip(rec, b6, v0):
        blk, msl, lo, hi, so = a[:5]
        P = so.x.shape[0]
        item = bvh.pair_item_map(blk, lo, hi, k["n_items"], k["pair_block"], P)
        pos = torch.nonzero(item >= 0)[:, 0]
        tile = pos // bvh.PAIR_TILE
        per_tile = torch.bincount(torch.unique(
            tile * scene.msl_count + msl.long()[item[pos]]) // scene.msl_count)
        per_tile = per_tile[per_tile > 0].float()
        n_tiles = int(tile.max()) + 1 if pos.numel() else 0
        got = real(*a, **k)
        if not all(torch.equal(x, y) for x, y in zip(
                got, bvh.pair_intersect_variant("V0", *a, **k))):
            raise AssertionError("B6 and V0 disagree on a main-path launch")
        p_ms = None
        if plain:
            p_ms, p = _events_ms(lambda: bvh.pair_intersect_plain(*a, **k))
            if not all(torch.equal(x, y) for x, y in zip(got, p)):
                raise AssertionError("B6 and its plain version disagree on a "
                                     "main-path launch")
        out.append(dict(
            positions=P, pairs=int(pos.numel()), items=int(k["n_items"]),
            superleaves=int(torch.unique(msl[:int(k["n_items"])]).numel()),
            tiles=int(per_tile.numel()),
            superleaves_per_tile=float(per_tile.mean()) if per_tile.numel() else 0.0,
            superleaves_per_tile_max=int(per_tile.max()) if per_tile.numel() else 0,
            split_chunks=bvh.pair_split(k["SP"], n_tiles)[0], b6_ms=b6_ms,
            v0_ms=v0_ms, plain_ms=p_ms,
            timed_by=by6 if by6 == by0 else "events"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_pair: no CUDA GPU available", file=sys.stderr)
        return 1
    from .. import build_scene_torch
    from ..io import synthetic

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    eps = float(np.float32(PathtraceDesc().advanced.ray_epsilon))
    states = {
        "terrain2M": lambda: synthetic.build_scene_terrain(
            n_tris=2_000_000, seed=0),
        "instanced100k": lambda: synthetic.build_scene_instanced_field(
            n_instances=100_000, seed=0, tris_per_mesh=64),
    }
    for name, make in states.items():
        cpu_scene, cams = make()
        scene = build_scene_torch(cpu_scene, device=dev)
        ro, rd = camera_rays(cams[0], ns.width, ns.height, dev)
        W = intersect.scene_tri_matrix(scene)
        args, kw, info = round1_state(scene, ro, rd)
        head = dict(state=name, pairs=int(info["n_real"]),
                    items=int(kw["n_items"]), stride=scene.sl_stride,
                    superleaves=scene.sl_count, card=card)
        for variant, (ms, _, timed_by) in time_variants(
                args, W, eps, kw, ns.reps).items():
            print(json.dumps(dict(variant=variant, ms=ms, timed_by=timed_by,
                                  **head)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
