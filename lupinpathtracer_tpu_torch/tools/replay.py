"""Kernels B2, B4 and B7 launch by launch on the card.

    python3 -m lupinpathtracer_tpu_torch.tools.replay [--reps N] [--baseline DIR]

`record_launches` is the one recorder of the launch replays: it wraps a
kernel wrapper while one main-path accumulation runs and keeps each call's
arguments (tools/prof_top.py replays B5 with it, tools/prof_pair.py B6).
Here it records B2 (kernels/dense_intersect.py::dense_closest_hit_attrs)
over one accumulation of the Cornell box's DIRECT wavefront, 512x512 x 16
spp x 8 bounces, and B7 (kernels/bvh.py::attr_fetch) over one accumulation
of each BVH main path, terrain2M and instanced100k at 512x288 x 4 spp x 8
bounces. Each launch is replayed through the kernel and its plain version
and every output must be equal (torch.equal); the kernel's device time per
launch comes from tools/prof_pair.kernel_ms_each, the plain version's from
CUDA events. chip_smoke.py calls b2_launches and b7_launches, and
b4_launches, on its main paths and on falsecolor dispatches (their `run`),
and adds each launch's bound.

Run as a program, with --baseline naming a checkout of an earlier commit,
it also builds that checkout's csrc/dense_intersect.cu and csrc/bvh.cu into
the build directory (their C interfaces are this checkout's) and times
both designs in turns, each output of the earlier one equal to this one's:
every replayed launch, B2 and B1 at chip_smoke.py's timing shapes (the
Cornell box and the box with a 520-triangle sphere, 524,288 rays; B1 on the
262,144 camera rays). One JSON line per path or shape, with the card's name
and power limit. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..core.vec3 import V3
from ..kernels import bvh
from ..kernels import dense_intersect as dk
from .prof_pair import kernel_ms_each


def record_launches(module, name: str, run, share=()) -> list:
    """[(args, kwargs)] of every call of `module.<name>` while run() runs.
    Each tensor argument (and each component of a V3) is cloned at the
    call, so that later writes do not reach the record, except the
    positions and keywords in `share`: the scene's tables, which the path
    never writes, kept by reference."""

    rec = []
    real = getattr(module, name)

    def copy(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, V3):
            return V3(*(c.clone() for c in x))
        return x

    def record(*a, **k):
        rec.append(([x if i in share else copy(x) for i, x in enumerate(a)],
                    {key: v if key in share else copy(v) for key, v in k.items()}))
        return real(*a, **k)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, real)
    return rec


def one_accumulation(scene, desc, width: int, height: int, spp: int, bounces: int):
    """A function that renders one accumulation of the path."""

    from .. import BakedPathtraceParams, render_progressive

    return lambda: render_progressive(
        scene, desc, BakedPathtraceParams(max_bounces=bounces, samples_per_pixel=spp),
        width, height, 1, device=scene.wt_attr.device)


def _events_ms(fn):
    """(ms, out) of one call of fn() on the card (CUDA events)."""

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None) or bool(torch.equal(x, y)) for x, y in zip(a, b))


def _timed(calls, kernel, reps, baseline_calls=None):
    """[(ms, baseline ms or None, timed_by)] per call: the kernel's and the
    earlier design's launches timed by kernel_ms_each, in turns (this
    design, the earlier, this, the earlier), each the mean of its two."""

    if baseline_calls is None:
        return [(ms, None, by) for ms, by in kernel_ms_each(calls, kernel, reps)]
    a1 = kernel_ms_each(calls, kernel, reps)
    b1 = kernel_ms_each(baseline_calls, kernel, reps)
    a2 = kernel_ms_each(calls, kernel, reps)
    b2 = kernel_ms_each(baseline_calls, kernel, reps)
    out = []
    for x1, y1, x2, y2 in zip(a1, b1, a2, b2):
        bys = {x1[1], y1[1], x2[1], y2[1]}
        out.append(((x1[0] + x2[0]) / 2, (y1[0] + y2[0]) / 2,
                    "device_records" if bys == {"device_records"} else "events"))
    return out


def b2_launches(scene, desc, width: int, height: int, spp: int, bounces: int,
                reps: int = 3, baseline=None, run=None) -> list:
    """Every B2 launch of one accumulation of the dense wavefront (desc's
    integrator), or of run() where given (a falsecolor dispatch), recorded
    and replayed: per launch its rays, triangles, attribute columns and
    hits, the kernel's device ms, the plain version's ms and, with
    `baseline` (a loaded build of an earlier dense_intersect.cu), the
    earlier design's ms. Raises unless every output equals the plain
    version's (and the earlier design's)."""

    rec = record_launches(dk, "dense_closest_hit_attrs",
                          run or one_accumulation(scene, desc, width, height, spp,
                                                  bounces),
                          share=(0, 1))
    real = dk.dense_closest_hit_attrs
    calls = [lambda a=a: real(*a) for a, _ in rec]
    base = None
    if baseline is not None:
        base = [lambda a=a: dk._launch(baseline, a[0], a[2], a[3], a[0].shape[2],
                                       a[1][: a[0].shape[2]]) for a, _ in rec]
    timed = _timed(calls, "dense_hit_kernel", reps, base)
    out = []
    for i, ((W4, A, R, eps), _) in enumerate(rec):
        k = calls[i]()
        p_ms, p = _events_ms(lambda: dk.dense_closest_hit_attrs_plain(
            W4, A[: W4.shape[2]], R, eps))
        if not _equal(k, p):
            raise AssertionError("B2 and its plain version disagree on a "
                                 "main-path launch")
        if base is not None and not _equal(base[i](), k):
            raise AssertionError("B2 and its earlier design disagree on a "
                                 "main-path launch")
        ms, b_ms, by = timed[i]
        out.append(dict(rays=int(R.shape[0]), tris=int(W4.shape[2]),
                        columns=int(A.shape[1]), hits=int((k[0] < dk.F32_MAX).sum()),
                        ms=ms, baseline_ms=b_ms, plain_ms=p_ms, timed_by=by))
    return out


def b7_launches(scene, desc, width: int, height: int, spp: int, bounces: int,
                reps: int = 3, baseline=None, run=None) -> list:
    """Every B7 launch of one accumulation of the BVH main path (or of
    run()), recorded and replayed: per launch its sorted positions, the covered ones (the
    winners), the items, the tiles of ATTR_TILE positions holding a winner,
    the distinct instances of the covering items (0 without the instance
    word), whether it writes the tangent rows, the kernel's device ms, the
    plain version's ms and, with `baseline` (a loaded build of an earlier
    bvh.cu), the earlier design's ms. Raises unless every output equals
    the plain version's (and the earlier design's)."""

    rec = record_launches(bvh, "attr_fetch",
                          run or one_accumulation(scene, desc, width, height, spp,
                                                  bounces),
                          share=(7, "nrm_tab", "ovr_tab"))
    real = bvh.attr_fetch
    calls = [lambda a=a, k=k: real(*a, **k) for a, k in rec]
    base = None
    if baseline is not None:
        base = [lambda a=a, k=k: bvh._attr_launch(baseline, *a, **k) for a, k in rec]
    timed = _timed(calls, "attr_kernel", reps, base)
    out = []
    for i, (a, kw) in enumerate(rec):
        k = calls[i]()
        p_ms, p = _events_ms(lambda: bvh.attr_fetch_plain(*a, **kw))
        if not torch.equal(k, p):
            raise AssertionError("B7 and its plain version disagree on a "
                                 "main-path launch")
        if base is not None and not torch.equal(base[i](), k):
            raise AssertionError("B7 and its earlier design disagree on a "
                                 "main-path launch")
        ms, b_ms, by = timed[i]
        out.append(dict(**attr_work(a, kw), ms=ms, baseline_ms=b_ms,
                        plain_ms=p_ms, timed_by=by))
    return out


def b4_launches(scene, run, reps: int = 3) -> list:
    """Every B4 launch of run() (kernels/packet.py::packet_traverse),
    recorded and replayed: per launch its rays, hits, whether it writes
    attribute rows, the work the plain version counts for a bound
    (packet_traverse_plain's `counts`), the kernel's device ms and the
    plain version's ms. Raises unless every output equals the plain
    version's."""

    from ..kernels import packet

    rec = record_launches(packet, "packet_traverse", run, share=(0, 4))
    real = packet.packet_traverse
    calls = [lambda a=a, k=k: real(*a, **k) for a, k in rec]
    timed = _timed(calls, "packet_kernel", reps)
    out = []
    for i, (a, kw) in enumerate(rec):
        k = calls[i]()
        counts: dict = {}
        p_ms, p = _events_ms(lambda: packet.packet_traverse_plain(
            *a, **kw, counts=counts))
        if not _equal(k, p):
            raise AssertionError("B4 and its plain version disagree on a "
                                 "recorded launch")
        ms, _, by = timed[i]
        out.append(dict(rays=int(a[1].x.shape[0]),
                        hits=int((k[0] < dk.F32_MAX).sum()),
                        attr_rows=int(k[5].shape[0]) if len(k) > 5 else 0,
                        counts=counts, ms=ms, plain_ms=p_ms, timed_by=by))
    return out


def attr_work(args, kw) -> dict:
    """What one B7 launch (bvh.attr_fetch's arguments) covers: its sorted
    positions, the covered ones (the winners), the distinct attribute rows
    they read (mesh superleaf x stride + local triangle), the items, the
    tiles of ATTR_TILE positions holding a winner, the distinct instances
    of the covering items (0 without the instance word) and whether it
    writes the tangent rows."""

    blk, msl, lo, hi, li = args[:5]
    SP = int(args[7].shape[1])
    P = int(li.shape[0])
    item = bvh.pair_item_map(blk, lo, hi, kw["n_items"], kw["pair_block"], P)
    pos = torch.nonzero(item >= 0)[:, 0]
    inst = kw["inst"]
    rows = msl.long()[item[pos]] * SP + li.long()[pos]
    return dict(positions=P, winners=int(pos.numel()),
                distinct_rows=int(torch.unique(rows).numel()),
                items=int(kw["n_items"]),
                tiles=int(torch.unique(pos // bvh.ATTR_TILE).numel()),
                instances=0 if inst is None else int(torch.unique(
                    inst.long()[item[pos]]).numel()),
                tangents=bool(kw["with_tangents"]))


def dense_timing_rays(cam, dev, seed: int = 1):
    """chip_smoke.py's timing shapes of B1 and B2: the 512x512 camera rays'
    feature rows (B1), and those followed by as many rays from points
    inside the Cornell box in seeded random directions (B2: the DIRECT
    wavefront traces camera rays, then rays from the hits)."""

    from ..core import rng as rng_mod
    from ..kernels import intersect
    from ..render import integrators
    from ..render.renderer import _pixel_batch

    gx, gy = _pixel_batch(512, 512, 0, 0, dev)
    _, ro, rd = integrators._camera_ray_from(
        dict(cam=cam, is_ortho=False, gx=gx, gy=gy, resolution=(512.0, 512.0)),
        rng_mod.init_state(gy * 512 + gx, 0, 0))
    B = ro.x.shape[0]
    rng = np.random.default_rng(seed)
    o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (B, 3))
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    R_cam = intersect.ray_features(ro, rd)
    R_wf = torch.cat([R_cam, intersect.ray_features(
        V3(*torch.tensor(o.T, dtype=torch.float32, device=dev)),
        V3(*torch.tensor(d.T, dtype=torch.float32, device=dev)))])
    return R_cam, R_wf


def sphere_cornell(n_lat: int = 14, n_lon: int = 20):
    """The Cornell box with a UV sphere of (n_lat - 1) * n_lon * 2 = 520
    triangles: 556 in all, a dense scene near the top of what B1/B2 and B3
    see (B3 reads its triangle table through L1 there, not from shared
    memory). Returns (SceneCPU, cameras)."""

    from .. import InstanceCPU, MeshCPU
    from ..io import builtin

    scene, cams = builtin.build_scene_cornell_box()
    lat = np.linspace(0.15, np.pi - 0.15, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    pts = np.asarray([[np.sin(a) * np.cos(b), np.cos(a), np.sin(a) * np.sin(b)]
                      for a in lat for b in lon], np.float32)
    idx = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            idx += [[a, b, c], [b, d, c]]
    mesh = scene.add_mesh(MeshCPU(positions=pts, indices=np.asarray(idx, np.int32),
                                  normals=pts.copy(), texcoords=None, colors=None))
    frame = np.zeros((3, 4), np.float32)
    frame[:, :3] = 0.25 * np.eye(3, dtype=np.float32)
    frame[:, 3] = (0.3, 1.2, 0.2)
    scene.instances.append(InstanceCPU(frame=frame, mesh_idx=mesh, mat_idx=0))
    return scene, cams


def _baseline_libs(root: str) -> dict:
    """{source: loaded and bound library} of the earlier checkout's
    dense_intersect.cu and bvh.cu, built into this checkout's build
    directory."""

    from .prof_pair import build_copies

    csrc = os.path.join(root, "lupinpathtracer_tpu_torch", "csrc")
    return {name: bind(build_copies(name, {"baseline": ()}, csrc=csrc)["baseline"][0])
            for name, bind in (("dense_intersect", dk.bind), ("bvh", bvh.bind))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--baseline", default=None,
                    help="a checkout of an earlier commit whose B1/B2 and B7 "
                    "designs are timed beside this one's")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("replay: no CUDA GPU available", file=sys.stderr)
        return 1
    from .. import build_scene_torch
    from ..core.types import PathtraceDesc, PathtraceType
    from ..io import builtin, synthetic
    from ..kernels import intersect
    from ..render.renderer import _camera_args

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    libs = _baseline_libs(ns.baseline) if ns.baseline else {}

    def desc_of(cams, ptype, max_radiance):
        desc = PathtraceDesc()
        desc.camera_transform = cams[0].transform
        desc.camera_params = cams[0].params
        desc.pathtrace_type = ptype
        desc.advanced.max_radiance = max_radiance
        return desc

    def report(path, runs):
        line = dict(path=path, launches=len(runs),
                    ms=sum(r["ms"] for r in runs),
                    plain_ms=sum(r["plain_ms"] for r in runs),
                    timed_by=sorted({r["timed_by"] for r in runs}), card=card)
        if libs:
            line["baseline_ms"] = sum(r["baseline_ms"] for r in runs)
        print(json.dumps(line), flush=True)

    box, cams = builtin.build_scene_cornell_box()
    cornell = build_scene_torch(box, device=dev)
    report("b2 cornell DIRECT", b2_launches(
        cornell, desc_of(cams, PathtraceType.DIRECT, 100.0), 512, 512, 16, 8,
        ns.reps, libs.get("dense_intersect")))

    # B2 and B1 at chip_smoke.py's timing shapes.
    R_cam, R_wf = dense_timing_rays(
        _camera_args(desc_of(cams, PathtraceType.STANDARD, 100.0)), dev)
    eps = float(np.float32(1e-3))
    sphere = build_scene_torch(sphere_cornell()[0], device=dev)
    for name, sc in (("cornell", cornell), ("cornell_sphere_556_tris", sphere)):
        W = intersect.scene_tri_matrix(sc)
        T = W.shape[2]
        for kernel, R, A in (("b2", R_wf, sc.wt_attr[:T]), ("b1", R_cam, None)):
            new = [lambda R=R, A=A: dk._kernel(W, R, eps, A)]
            base = None
            if libs:
                base = [lambda R=R, A=A: dk._launch(libs["dense_intersect"], W, R,
                                                    eps, T, A)]
                if not _equal(new[0](), base[0]()):
                    raise AssertionError(f"{kernel} and its earlier design disagree")
            ms, b_ms, by = _timed(new, "dense_hit_kernel", 10, base)[0]
            print(json.dumps(dict(path=f"{kernel} {name}", rays=int(R.shape[0]),
                                  tris=T, ms=ms, baseline_ms=b_ms, timed_by=by,
                                  card=card)), flush=True)

    for name, make in (
            ("terrain2M", lambda: synthetic.build_scene_terrain(n_tris=2_000_000, seed=0)),
            ("instanced100k", lambda: synthetic.build_scene_instanced_field(
                100_000, seed=0, tris_per_mesh=64))):
        cpu_scene, scams = make()
        scene = build_scene_torch(cpu_scene, device=dev)
        report(f"b7 {name}", b7_launches(
            scene, desc_of(scams, PathtraceType.STANDARD, 10.0), 512, 288, 4, 8,
            ns.reps, libs.get("bvh")))
        del scene
    return 0


if __name__ == "__main__":
    sys.exit(main())
