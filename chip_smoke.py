"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from lupinpathtracer_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, and drives the port's
main paths through its entry points:
- dense route: the progressive Cornell-box render, 512x512, 8 bounces,
  64 spp per accumulation (kernel B3, each dispatch one launch of its
  dispatch mode; at those shapes the dispatch mode's stored image and
  segment count against the plain route, pathtrace_spp and the blend, and
  the acc mode's sums against pathtrace_spp, with its warp efficiency from
  n_traced),
  the DIRECT wavefront (B2, every B2 launch of one accumulation replayed
  against its plain version: tools/replay.py) and a closest-hit query
  (B1), and a 32x32 render against the repo's golden; B3 also against its
  plain version on a box with a 520-triangle sphere (its triangle table
  read through L1), and B2 timed on that box too (556 triangles: bound by
  operations where the Cornell box's B2 is bound by its stores);
- the BVH route's shading step (csrc/shade.cu) at the spd_tetra.spd512
  cell's 262,144 lanes on SPD tetra at size factor 7: one accumulation
  through the fused step against the PyTorch step (compare_paths), its
  launches, their device time and its bound;
- BVH route: the 2M-triangle synthetic terrain (bench.py's terrain2M),
  512x288, STANDARD, 8 bounces, 4 spp per accumulation (B4 on camera rays,
  B5/B6/B7 on every bounce batch), B4-B7 against their plain versions at
  those shapes (B4 bit for bit, with the work of its 32-lane packets), and
  the Cornell box forced onto the BVH route (force_software_bvh: B6/B7)
  against the golden;
- two-level route: the 100,000-instance field (bench.py's instanced100k),
  512x288, STANDARD, 8 bounces, 4 spp per accumulation (B4 on camera rays;
  B5, B6 and B7 with the per-item instance word on every bounce batch), and
  a 2,000-instance field; on both, each kernel against its plain version
  (B4 bit for bit) and closest_hit against the brute-force two-level
  reference;
- B5 on every B5 launch of one accumulation of each BVH main path,
  replayed on its recorded inputs against its plain version
  (tools/prof_top.py), B6 against V0 (B6's earlier design) the same
  way (tools/prof_pair.py), and B7 against its plain version
  (tools/replay.py);
- the rest of the render API: MIS on the Cornell box (512x512, 16 spp,
  8 bounces: B2) and the 32x32 MIS golden on the dense and the BVH route;
  MIS on terrain2M and instanced100k (512x288, 4 spp, 8 bounces: B4 on the
  camera prologue, B5/B6/B7 on the three-slot bounce batches); on all
  three, every launch of one 1-spp accumulation replayed against its
  plain version (B6 also against V0); all 12 falsecolor AOVs on the three scenes (B2; B4 with
  attributes; B4 and B7), every launch of an ALBEDO and a NORMALS dispatch
  replayed, a 32x32 tile of each image against the same tile dispatched on
  CPU tensors; the three debug heatmaps on terrain2M (every B5 launch of
  the counting pass replayed, its aabb counts equal); the denoiser on a
  terrain2M accumulation guided by its ALBEDO and NORMALS AOVs, against
  the same call on CPU tensors; LUPIN_SPP_STREAMS K = 1, 2 and 4 on both
  BVH main paths (the traced segments equal to K = 1's, the image within
  rtol 3e-6 / atol 1e-6);
- scene files, the apps and multi-device: terrain2M written as a Yocto
  scene with a ~50 MB PLY (tools/scene_files.py) and rendered by the CLI
  (apps/render_cli.py, 512x288, 4 spp, 8 bounces, 2 accumulations, .exr
  out), the loaded scene equal to the in-memory one and the EXR equal to
  the in-memory render rounded to half; a textured Cornell scene from
  files (PNG color texture with alpha, normal map and emission texture
  on the packed RGBA8 atlas, a .hdr environment through emission_tex) and
  its variant with a 4,224-triangle UV sphere (the BVH route: B4's and
  B7's tangent rows), 256², 4 spp, 8 bounces, STANDARD, MIS, ALBEDO and
  NORMALS, a 32x32 tile against the same tile dispatched on CPU tensors,
  every B2 launch of a dense accumulation and every B4 and B7 launch of a
  BVH one replayed against its plain version; apps/golden_test.py on the
  Cornell box from files (the reference's gate; a checkpoint written and
  resumed), apps/check_kernels.py, parallel/sharding.py (tiles mode on
  meshes of 1, 2 and 4 entries of the card, images identical; samples
  mode; B3 with sample_offset 8 against its plain version) and
  apps/viewer.py (a 2-frame orbit at 128 px);
- the traversal controls: packet_gate_field, the smallest instanced field
  (120,000 instances) whose top tree passes the JAX package's 23,437-row
  TPU budget, its camera batch through B4 and through the sort wavefront
  (LUPIN_NO_PACKET), t equal on every lane, B4 bit for bit against its
  plain version; dispatch_1080p, terrain2M at 1920x1080 x 1 spp, one
  dispatch by the working-set self-bound and 40 with the self-bound's
  budget cut to force 256x256 tiles (renderer.DISPATCH_MEMORY_SHARE), the
  images identical and the peak of allocated memory within the reckoning
  (renderer.dispatch_bytes_per_lane); packet_bounce, both BVH main paths
  (instanced100k at 1 spp) by default and under LUPIN_FORCE_PACKET (B4 on
  bounce batches), the forced image against the default's, B4's first and
  last live bounce launch replayed against its plain version bit for
  bit;
- B6 and the B6' ablation variants (tools/prof_pair.py of the port) in
  turns on the round-1 states of the terrain2M and instanced100k camera
  batches, with the share of B6's threads that hold a pair in each design.
Each phase prints one JSON line (t_s: the script's clock); any failure
raises and exits nonzero. The kernels line holds each kernel's (and mode's) launches on its main path,
its error against the plain version, its device time (torch.profiler) and
the plain version's wall time (CUDA events) at the main path's shapes, and
its bound on an H100 (FP32 67 TFLOP/s, HBM 3.35 TB/s); B5's main-path
entries, and the entries named "mean per (main-path) launch", are the
means over the replayed launches, and `launches_in` names the run whose
launches an entry counts.
The last line is {"ok": true, "device": {...}}. Without a GPU it exits
nonzero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32 = 67e12  # H100 SXM FP32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
GOLDEN = os.path.join(ROOT, "tests", "goldens", "cornell_32_standard.npy")
GOLDEN_MIS = os.path.join(ROOT, "tests", "goldens", "cornell_32_mis.npy")
TERRAIN_TRIS = 2_000_000  # bench.py's terrain2M
FIELD_INSTANCES = 100_000  # bench.py's instanced100k
SMALL_FIELD_INSTANCES = 2_000  # the card tests' field, at the main path's shapes
# f32 operations per unit of work, for the bounds:
PAIR_OPS = 81  # ray/triangle: 4 ten-term dot products (76) + 1/det, 3 products, u+v
SLAB_OPS = 26  # ray/box: 6 subtractions, 6 products, 10 min/max, 4 compares
SORT_OPS = 12  # B5 per child: 19 comparators x (1 compare + 4 selects) / 8
XFORM_OPS = 33  # ray to mesh space: origin 9 products + 9 sums, direction 9 + 6
LEAF_FRAME_OPS = XFORM_OPS + 9 + 3  # B4 per leaf visit: + o x d, 3 reciprocals
ROTATE_OPS = 2 * 15 + 8  # B7 per winner: two rotations, gn's length and scale
IA_ROWS, IA_ROWS_NM = 16, 24  # B7's output rows (kernels/bvh.py)
# The shading step's row: SPD tetra (lupin_bench's generator) at this size
# factor, at the spd_tetra.spd512 cell's lanes (512x512 x 5 spp); the step's
# work does not depend on the scene's size. Bytes every lane of a launch
# reads and writes (the PCG state 8 + 8, the mask 1 + 1, the ray, weight
# and radiance 48 + 48, the bounce 4 + 4), and a shaded lane's more (the
# hit flag, distance, normal and material id 21, n_bounces 4 + 4).
SHADE_SPD_SF = 7
SHADE_LANE_BYTES, SHADE_HIT_BYTES = 122, 29
# The launch replays' depth cut: every launch of one accumulation of 1 spp
# (the main paths render 4 or 16 spp), which keeps the whole run near 420 s.
REPLAY_SPP = 1


_T0 = time.perf_counter()


def emit(phase: str, **kw):
    """One phase's JSON line, with the script's clock (t_s) at its print."""

    print(json.dumps({"phase": phase, **kw,
                      "t_s": round(time.perf_counter() - _T0, 2)}), flush=True)


def cuda_ms(fn, reps: int):
    """Mean milliseconds of fn() on the card over reps runs (CUDA events,
    after one warm-up run), and the output of the last run."""

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def kernel_ms(fn, kernel: str, reps: int):
    """(ms, out, timed_by) of the port's tools/prof_pair.py::kernel_ms: the
    mean device milliseconds of the CUDA kernel whose name contains `kernel`
    over reps calls of fn() (torch.profiler device records), the last
    call's output, and "device_records"; "events" where the profiler kept
    no records and CUDA events timed the calls, host overhead included.
    timed_by goes into the kernel's own entry of the kernels line."""

    from lupinpathtracer_tpu_torch.tools.prof_pair import kernel_ms as timed

    return timed(fn, kernel, reps)


def compare_hits(k, p, F32_MAX):
    """Holds a closest-hit kernel's (t, u, v, det, idx[, attr rows]) against
    its plain version: the share of hit lanes whose idx differs must be
    <= 1e-4, and on every lane where the hit flag and idx agree, t, u, v,
    det and the attribute rows must be equal. max_abs_err is the largest
    difference of t, u, v or det over the lanes both call a hit."""

    hk, hp = k[0] < F32_MAX, p[0] < F32_MAX
    both = hk & hp
    hit_any = hk | hp
    idx_diff = float(((k[4] != p[4]) & hit_any).sum()) / max(int(hit_any.sum()), 1)
    agree = (k[4] == p[4]) & (hk == hp)
    err = max(float((a - b)[both].abs().max()) if bool(both.any()) else 0.0
              for a, b in zip(k[:4], p[:4]))
    res = dict(rays=int(k[0].shape[0]), max_abs_err=err,
               max_abs_dt=float((k[0] - p[0])[both].abs().max()),
               idx_diff_share=idx_diff,
               hit_flag_mismatch=int((hk != hp).sum()),
               tuvdet_exact_where_idx_agrees=all(
                   bool(torch.equal(a[agree], b[agree]))
                   for a, b in zip(k[:4], p[:4])))
    if len(k) > 5:
        res["attr_rows_exact"] = bool(torch.equal(k[5][:, agree], p[5][:, agree]))
        assert res["attr_rows_exact"], res
    assert idx_diff <= 1e-4 and res["tuvdet_exact_where_idx_agrees"], res
    return res


def compare_paths(acc_k, nt_k, acc_p, nt_p):
    """Holds B3's (acc, n_traced) against the plain pathtrace_spp: n_traced
    equal on >= 99.9% of lanes, acc within rtol 2e-4 / atol 2e-5 on those
    lanes, image mean within 0.5%."""

    eq = nt_k == nt_p
    share = float(eq.float().mean())
    ok = True
    err = 0.0
    for a, b in zip(acc_k, acc_p):
        a, b = a[eq], b[eq]
        err = max(err, float((a - b).abs().max()))
        ok &= bool(torch.all((a - b).abs() <= 2e-5 + 2e-4 * b.abs()))
    mk = float(sum(x.mean() for x in acc_k))
    mp_ = float(sum(x.mean() for x in acc_p))
    rel_mean = abs(mk - mp_) / max(abs(mp_), 1e-12)
    res = dict(n_traced_equal_share=share, acc_max_abs_err=err,
               acc_within_tol=ok, mean_rel_diff=rel_mean)
    assert share >= 0.999 and ok and rel_mean <= 0.005, res
    return res


def compare_dispatch(img_k, count_k, img_p, nt_p):
    """Holds B3's dispatch mode (the stored image, the segment count)
    against the plain route (pathtrace_spp, then _accumulate_and_store):
    the count within 1e-4 of the plain n_traced sum, >= 99.9% of the
    image's values within rtol 2e-4 / atol 2e-5 (compare_paths' tolerance),
    the image mean within 0.5%."""

    count_p = int(nt_p.sum())
    gap = abs(count_k - count_p) / max(count_p, 1)
    d = (img_k - img_p).abs()
    share = float((d <= 2e-5 + 2e-4 * img_p.abs()).float().mean())
    mk, mp_ = float(img_k.mean()), float(img_p.mean())
    rel_mean = abs(mk - mp_) / max(abs(mp_), 1e-12)
    res = dict(segments=count_k, plain_segments=count_p, segments_gap=gap,
               within_tol_share=share, max_abs_err=float(d.max()),
               mean_rel_diff=rel_mean)
    assert gap <= 1e-4 and share >= 0.999 and rel_mean <= 0.005, res
    return res


def plain_ms(fn):
    """Milliseconds of one run of fn() on the card (CUDA events), and its
    output: the plain versions are slow and run once."""

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


KERNEL_GROUPS = (("B4", "packet_kernel"), ("B5", "top_kernel"),
                 ("B6", "pair_hit_kernel"), ("B7", "attr_kernel"),
                 ("walk", "lupin_walk_kernel"))


def device_profile(fn):
    """Device time of one call of fn by kernel group (torch.profiler, CUDA
    activity only, so the host is not slowed by op recording): the port's
    BVH kernels, sorts, copies/fills and every other PyTorch kernel (the
    six that take the most time, by name, with their ms and count), plus
    the busy share of the call's wall time (the union of kernel spans)."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ms: dict = {}
    n: dict = {}
    other: dict = {}
    spans = []
    # The profiler's raw records (ns): building its Python event tree costs
    # about 0.1 ms a record, minutes for a dispatch of 10^5-10^6 launches.
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        name = e.name()
        low = name.lower()
        g = next((k for k, sub in KERNEL_GROUPS if sub in name), None)
        if g is None:
            g = ("sort" if "sort" in low else
                 "copy_fill" if "memcpy" in low or "memset" in low
                 or "fill" in low else "other_torch")
        ms[g] = ms.get(g, 0.0) + (b - a) / 1e3
        n[g] = n.get(g, 0) + 1
        spans.append((a, b))
        if g == "other_torch":
            k = name[:60]
            t, c = other.get(k, (0.0, 0))
            other[k] = (t + (b - a) / 1e3, c + 1)
    busy = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(other.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy / 1e3,
                profiled_idle_share=1.0 - busy / 1e3 / wall_ms,
                device_ms_by_group=ms, kernels_by_group=n,
                top_other_torch=[[k, round(t, 3), c] for k, (t, c) in top])


def attr_row_bytes(with_tangents: bool) -> int:
    """Bytes of one attribute row that B4's attribute phase and B7 read: the
    32-byte sectors holding the columns csrc/bvh_common.cuh::write_rows
    reads (a row is 512 bytes and 512-byte aligned)."""

    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk

    spans = [dk.ATTR_N0, dk.ATTR_N1, dk.ATTR_N2, dk.ATTR_GN, dk.ATTR_UV0,
             dk.ATTR_UV1, dk.ATTR_UV2, dk.ATTR_C0, dk.ATTR_C1, dk.ATTR_C2]
    if with_tangents:
        spans += [dk.ATTR_TAN, dk.ATTR_BIT]
    cols = {c for sl in spans for c in range(sl.start, sl.stop)}
    cols |= {dk.ATTR_HAS_UV, dk.ATTR_DET_SIGN, dk.ATTR_MAT_ID}
    return 32 * len({c * 4 // 32 for c in cols})


def reset(*counters):
    for c in counters:
        for key in c:
            c[key] = 0


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def b5_bound(lanes, Q, aabb, pops, pushes, hist_len, rows_read):
    """B5's bound for one launch: the slab tests and the sort per child it
    does; bytes: rays and best_t in (28 per lane), sp in and out, the
    (Q, lanes) ids, counts and aabb out, the stack entries popped and
    pushed, the histogram where the launch makes one (hist_len bins) and
    the distinct packed top rows its internal pops read (288 B a row:
    kernels/bvh.py::top_rows)."""

    from lupinpathtracer_tpu_torch.accel.superleaf import TOP_FAN

    return bound_ms(aabb * (SLAB_OPS + SORT_OPS),
                    lanes * (28 + 2 * 4 + Q * 4 + 2 * 4) + (pops + pushes) * 4
                    + hist_len * 4 + rows_read * TOP_FAN * (8 + 1) * 4)


def b2_bound(rays, tris, columns):
    """B1/B2's bound: 81 operations per ray/triangle test; bytes: the rays'
    feature rows in (40 B), the coefficient table (160 B a triangle) and the
    attribute rows (columns x 4 B a triangle) read once, the hit records
    (20 B) and the (columns, rays) attribute rows out (columns = 0: B1)."""

    return bound_ms(rays * tris * PAIR_OPS,
                    rays * 40 + tris * 160 + rays * 20 + (tris + rays) * columns * 4)


def b7_bound(work, row_bytes):
    """B7's bound for one launch (tools/replay.attr_work): per winner the
    interpolation (11 sums of 5 operations) and, with the instance word,
    the rotations; bytes: the touched sectors of each distinct attribute
    row the winners read (read once), per winner its li, hu, hv and its
    output rows (the kernel writes only the winners' columns of the (rows,
    positions) output; the wrapper's zero fill of the others is a memset
    of its own), the items read (blk, msl, lo, hi and the instance word)
    and each distinct instance's normal matrix and override."""

    rows = IA_ROWS_NM if work["tangents"] else IA_ROWS
    inst = work["instances"]
    return bound_ms(work["winners"] * (11 * 5 + (ROTATE_OPS if inst else 0)),
                    work["distinct_rows"] * row_bytes
                    + work["winners"] * (12 + rows * 4)
                    + work["items"] * (20 if inst else 16) + inst * 40)


def b4_bound(work4, B, out_bytes, rows, sub_numel, extra_ops=0, extra_bytes=0):
    """B4's bound: the per-ray work whatever implements it, 81 operations
    per admitted ray/triangle test and 26 per box test; bytes: rays in,
    records out, each admitted sub-chunk's coefficients once, the top rows
    and sub-chunk boxes. The packets' union work is reported beside it."""

    return bound_ms(
        work4["tri_tests"] * PAIR_OPS + work4["box_tests"] * SLAB_OPS + extra_ops,
        B * 24 + out_bytes + work4["chunks"] * work4["chunk_tris"] * 160
        + rows * 8 * 36 + sub_numel * 4 + extra_bytes)


def assert_equal(k, p, what):
    """Every output of a kernel equal to its plain version's, bit for bit."""

    same = [bool(torch.equal(a, b)) for a, b in zip(k, p)]
    assert len(k) == len(p) and all(same), (what, same)


def cornell_desc(lt, cams, ptype, max_radiance=100.0):
    desc = lt.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.pathtrace_type = ptype
    desc.advanced.max_radiance = max_radiance
    return desc


def glossy_cornell(lt, builtin):
    """The Cornell box with a glossy tall box and a gltfpbr short box."""

    scene, cams = builtin.build_scene_cornell_box()
    glossy = scene.add_material(lt.Material(
        color=np.array([0.8, 0.7, 0.6, 1.0], np.float32),
        mat_type=lt.MaterialType.GLOSSY, roughness=0.3, ior=1.5))
    pbr = scene.add_material(lt.Material(
        color=np.array([0.9, 0.6, 0.3, 1.0], np.float32),
        mat_type=lt.MaterialType.GLTFPBR, roughness=0.4, metallic=0.6))
    scene.instances[5].mat_idx = pbr  # short box
    scene.instances[6].mat_idx = glossy  # tall box
    return scene, cams


def warp_efficiency(n_traced):
    """B3's lockstep efficiency: sum(n_traced) / (32 * sum over groups of
    32 consecutive lanes of their largest n_traced)."""

    nt = n_traced.long()
    pad = (-nt.shape[0]) % 32
    g = torch.cat([nt, nt.new_zeros(pad)]).reshape(-1, 32)
    return float(nt.sum()) / float(32 * g.max(dim=1).values.sum())


def pair_live_shares(blk, lo, hi, n_items, P):
    """Share of B6's threads that hold a pair, in the earlier design (a
    block of PB threads per non-empty work item) and in the redesign (a
    block of PAIR_TILE threads per tile of sorted positions that holds a
    covered one), and the pair count."""

    from lupinpathtracer_tpu_torch.kernels import bvh, intersect

    PB = intersect.WF_PAIR_BLOCK
    item = bvh.pair_item_map(blk, lo, hi, n_items, PB, P)
    pos = torch.nonzero(item >= 0)[:, 0]
    pairs = int(pos.numel())
    busy_items = int(torch.unique(item[pos]).numel())
    tiles = int(torch.unique(pos // bvh.PAIR_TILE).numel())
    return dict(pairs=pairs, old_live_share=pairs / max(busy_items * PB, 1),
                new_live_share=pairs / max(tiles * bvh.PAIR_TILE, 1),
                old_blocks=busy_items, new_tiles=tiles)


def bounce_batch(ro, rd, t, gn, F32_MAX, seed):
    """A bounce batch from camera hits: origins at the hit points (the
    camera origin on misses), directions from a seeded normal draw, turned
    to the side of the geometric normal that faces the camera."""

    from lupinpathtracer_tpu_torch.core.vec3 import V3

    dev = ro.x.device
    d = np.random.default_rng(seed).normal(size=(3, t.shape[0]))
    d /= np.linalg.norm(d, axis=0)
    d = V3(*(torch.tensor(c, dtype=torch.float32, device=dev) for c in d))
    flip = (d.x * gn.x + d.y * gn.y + d.z * gn.z) * (
        rd.x * gn.x + rd.y * gn.y + rd.z * gn.z) > 0.0
    d = V3(*(torch.where(flip, -c, c) for c in d))
    th = torch.where(t < F32_MAX, t, 0.0)
    return V3(*(a + b * th for a, b in zip(ro, rd))), d


def bvh_phases(dev, smi, scene_c, cams_c, n_tris=TERRAIN_TRIS, width=512,
               height=288, spp=4, bounces=8, timed_accums=3):
    """Phases 7-10: the terrain build, B4-B7 against their plain versions at
    the BVH main path's shapes, the BVH main path, and the Cornell box on
    the BVH route against the golden. Returns the B4-B7 kernel entries,
    the terrain's (scene, camera rays, W, eps) for the B6' phase, its
    cameras and its SceneCPU."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.core import rng as rng_mod
    from lupinpathtracer_tpu_torch.core.vec3 import V3
    from lupinpathtracer_tpu_torch.io import synthetic
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, mega, packet, walk
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.render import integrators
    from lupinpathtracer_tpu_torch.render.renderer import (
        _camera_args, _pixel_batch)
    from lupinpathtracer_tpu_torch.tools import prof_top, replay

    F32_MAX = dk.F32_MAX

    # -- 7. terrain build ----------------------------------------------------
    t0 = time.perf_counter()
    terrain, cams = synthetic.build_scene_terrain(n_tris=n_tris, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = lt.build_scene_torch(terrain, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    SP, n_sl = ts.sl_stride, ts.sl_count
    nsub = ts.sl_sub.shape[1]
    emit("terrain_build", tris=ts.num_world_tris, generate_s=gen_s,
         build_scene_torch_s=build_s, sl_stride=SP, sl_count=n_sl,
         top_rows=int(ts.top_tab.shape[0]), top_depth=ts.top_depth, nsub=nsub,
         packet_eligible=intersect.packet_eligible(ts))
    assert ts.use_bvh and not ts.two_level and not ts.top_root_is_leaf
    assert intersect.packet_eligible(ts)

    # bench.py's terrain2M render: camera 0, STANDARD, max_radiance 10.
    desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
    eps = float(np.float32(desc.advanced.ray_epsilon))
    W = intersect.scene_tri_matrix(ts)
    gx, gy = _pixel_batch(width, height, 0, 0, dev)
    _, ro, rd = integrators._camera_ray_from(
        dict(cam=_camera_args(desc), is_ortho=False, gx=gx, gy=gy,
             resolution=(float(width), float(height))),
        rng_mod.init_state(gy * width + gx, 0, 0))
    B = ro.x.shape[0]
    rows = ts.top_tab.shape[0]

    # -- 8. B4-B7 against their plain versions at the main path's shapes ---
    # B4 with attributes on the camera rays (the camera batch).
    t_b4, k4, by4 = kernel_ms(
        lambda: packet.packet_traverse(ts, ro, rd, eps, W, with_attrs=True),
        "packet_kernel", 5)
    work4: dict = {}
    p_b4, p4 = plain_ms(lambda: packet.packet_traverse_plain(
        ts, ro, rd, eps, W, with_attrs=True, counts=work4))
    res_b4 = compare_hits(k4, p4, F32_MAX)
    assert_equal(k4, p4, "B4")
    hits4 = int((k4[0] < F32_MAX).sum())
    awout = k4[5].shape[0]
    row_b = attr_row_bytes(bool(ts.any_normal_maps))
    bnd_b4 = b4_bound(work4, B, B * (20 + awout * 4) + hits4 * row_b, rows,
                      ts.sl_sub.numel())
    emit("b4_vs_plain", scene=f"terrain{n_tris}", hits=hits4,
         attr_row_bytes=row_b, bit_for_bit=True, **work4, **res_b4)

    # One bounce batch of B rays from the camera hits.
    o, d = bounce_batch(ro, rd, k4[0], V3(*k4[5][bvh.IA_GN]), F32_MAX, seed=1)
    pad = (-B) % intersect.WF_RAY_BLOCK
    Bp = B + pad
    op = V3(*(intersect._pad(c, pad, 0.0) for c in o))
    dp = V3(intersect._pad(d.x, pad, 0.0), intersect._pad(d.y, pad, 1.0),
            intersect._pad(d.z, pad, 0.0))
    S = bvh.stack_depth(ts)
    Q = intersect.WF_Q
    PB = intersect.WF_PAIR_BLOCK
    tab = ts.top_tab
    stack0 = torch.zeros((S, Bp), dtype=torch.int32, device=dev)
    sp0 = (torch.arange(Bp, device=dev) < B).to(torch.int32)
    bt0 = torch.full((Bp,), F32_MAX, dtype=torch.float32, device=dev)

    # B5: the batch's first round. It updates its stack in place, so every
    # call gets a fresh copy (the copy is not part of the kernel's record);
    # the stack is compared below each lane's sp (prof_top.max_abs_diff).
    t_b5, k5, by5 = kernel_ms(lambda: bvh.top_traverse(
        tab, op, dp, bt0, stack0.clone(), sp0, S=S, Q=Q, n_sl=n_sl),
        "top_kernel", 10)
    work5: dict = {}
    p_b5, p5 = plain_ms(lambda: bvh.top_traverse_plain(
        tab, op, dp, bt0, stack0.clone(), sp0, S=S, Q=Q, n_sl=n_sl,
        counts=work5))
    err5 = prof_top.max_abs_diff(k5, p5, S)
    aabb5 = int(k5[5].sum())
    emits5 = int(k5[1].sum())
    emit("b5_vs_plain", rays=B, lanes=Bp, Q=Q, S=S, emits=emits5,
         aabb_tests=aabb5, pending=int((k5[3] > 0).sum()), **work5,
         max_abs_err_stack_below_sp=err5, ms=t_b5, plain_ms=p_b5,
         bound_ms=b5_bound(Bp, Q, aabb5, work5["pops"], work5["pushes"],
                           0 if k5[4] is None else k5[4].numel(),
                           work5["rows_read"])[0])
    assert err5 == 0

    # B6 on the round's superleaf-sorted pairs.
    sl = k5[0].reshape(-1)
    skey, order = torch.sort(torch.where(sl >= 0, sl, n_sl), stable=True)
    ray = order % Bp
    so, sd = V3(*(c[ray] for c in op)), V3(*(c[ray] for c in dp))
    blk, sl_k, lo, hi, n_real, n_items = intersect._wf_work_items(
        skey, n_sl, PB, k5[4])
    args6 = (blk, sl_k, lo, hi, so, sd, W, eps)
    kw6 = dict(SP=SP, pair_block=PB, n_items=n_items)
    t_b6, k6, by6 = kernel_ms(lambda: bvh.pair_intersect(*args6, **kw6),
                              "pair_hit_kernel", 5)
    p_b6, p6 = plain_ms(lambda: bvh.pair_intersect_plain(*args6, **kw6))
    res_b6 = compare_hits(k6, p6, F32_MAX)
    assert res_b6["hit_flag_mismatch"] == 0, res_b6
    assert all(bool(torch.equal(a, b)) for a, b in zip(k6, p6))
    pairs, items = int(n_real), int(n_items)
    sl_used = int(torch.unique(sl_k[:items]).numel())
    bnd_b6 = bound_ms(pairs * SP * PAIR_OPS,
                      pairs * (24 + 20) + items * 16 + sl_used * SP * 160)
    emit("b6_vs_plain", items=items, superleaves=sl_used,
         pair_slots=int(skey.shape[0]),
         **pair_live_shares(blk, lo, hi, n_items, int(skey.shape[0])), **res_b6)

    # The BVH walk on the same bounce batch (its route since the walk),
    # beside the sort wavefront's rounds on it.
    def on_wf():
        return on_wavefront(lambda: intersect.closest_hit_wavefront(
            ts, o, d, eps, W=W, coherent=False))

    t_wk, k_wk, by_wk = kernel_ms(lambda: walk.walk(ts, o, d, eps, W),
                                  "lupin_walk_kernel", 5)
    r0 = intersect.ROUNDS["wavefront"]
    wf_ms, h_wf = cuda_ms(on_wf, 2)
    prof_wf = device_profile(on_wf)
    emit("walk_vs_wavefront", scene=f"terrain{n_tris}", rays=B, walk_ms=t_wk,
         walk_timed_by=by_wk, wavefront_wall_ms=wf_ms,
         wavefront_rounds=(intersect.ROUNDS["wavefront"] - r0) / 4,
         wavefront_device_busy_ms=prof_wf["device_busy_ms"],
         wavefront_device_ms_by_group=prof_wf["device_ms_by_group"],
         hits=int((k_wk[0] < F32_MAX).sum()), t_equal=bool(torch.equal(k_wk[0], h_wf.dst)),
         t_diff_lanes=int((k_wk[0] != h_wf.dst).sum()), card=smi)

    # B7 on the batch's winners, sorted as wavefront_fetch_attrs sorts them.
    h = intersect.closest_hit_wavefront(ts, o, d, eps, W=W, coherent=False)
    args7, kw7, _, _ = intersect._attr_fetch_args(ts, h)
    t_b7, k7, by7 = kernel_ms(lambda: bvh.attr_fetch(*args7, **kw7),
                         "attr_kernel", 10)
    p_b7, p7 = plain_ms(lambda: bvh.attr_fetch_plain(*args7, **kw7))
    err7 = float((k7 - p7).abs().max())
    hits7 = int(h.hit.sum())
    emit("b7_vs_plain", rays=B, hits=hits7, rows=k7.shape[0],
         rows_equal=bool(torch.equal(k7, p7)), max_abs_err=err7)
    assert torch.equal(k7, p7)
    bnd_b7 = b7_bound(replay.attr_work(args7, kw7), row_b)

    # -- 9. the BVH main path --------------------------------------------------
    counters = (bvh.LAUNCHES, packet.LAUNCHES, dk.LAUNCHES, mega.LAUNCHES,
                walk.LAUNCHES, intersect.HOST_SYNCS)
    baked = lt.BakedPathtraceParams(max_bounces=bounces, samples_per_pixel=spp)
    t0 = time.perf_counter()
    lt.render_progressive(ts, desc, baked, width, height, 1, device=dev)
    warm_s = time.perf_counter() - t0
    stats: dict = {}
    reset(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = lt.render_progressive(ts, desc, baked, width, height, timed_accums,
                                device=dev, stats=stats)
    wall = time.perf_counter() - t0
    launches = {**packet.LAUNCHES, **bvh.LAUNCHES, **walk.LAUNCHES}
    syncs = intersect.HOST_SYNCS["wavefront"]
    dense_launches = {**dk.LAUNCHES, **mega.LAUNCHES}
    emit("main_path_bvh", scene=f"terrain{n_tris}", width=width, height=height,
         integrator="STANDARD", bounces=bounces, spp=spp,
         accumulations=timed_accums, warmup_s=warm_s, wall_s=wall,
         s_per_accumulation=wall / timed_accums, rays=stats["rays"],
         mrays_per_s=stats["rays"] / wall / 1e6,
         launches_per_accumulation={k: v / timed_accums for k, v in launches.items()},
         wavefront_host_syncs_per_accumulation=syncs / timed_accums,
         dense_launches=dense_launches, image_mean=float(img.mean()),
         image_finite=bool(np.isfinite(img).all()), card=smi)
    assert all(launches[k] > 0 for k in ("packet_traverse", "walk", "attr_fetch")), launches
    assert launches["top_traverse"] == launches["pair_intersect"] == 0, launches
    assert not any(dense_launches.values()), dense_launches
    assert np.isfinite(img).all() and img.mean() > 0

    # One more accumulation under the profiler: where the device time goes.
    # The profiler slows the host (it records every launch), so the busy
    # share is also given against the unprofiled accumulation's wall time.
    prof = device_profile(lambda: lt.render_progressive(
        ts, desc, baked, width, height, 1, device=dev))
    emit("main_path_bvh_profile", accumulations=1, card=smi,
         device_busy_share_of_timed_wall=prof["device_busy_ms"] * 1e-3
         * timed_accums / wall, **prof)
    b5_replay = on_wavefront(lambda: emit_b5_launches(
        ts, desc, width, height, REPLAY_SPP, bounces, f"terrain{n_tris}", smi))
    on_wavefront(lambda: emit_b6_launches(ts, desc, width, height, REPLAY_SPP,
                                          bounces, f"terrain{n_tris}", smi))
    b7_replay = emit_b7_launches(ts, desc, width, height, REPLAY_SPP, bounces,
                                 f"terrain{n_tris}", smi)

    # -- 10. the Cornell box on the BVH route (one superleaf: B6, B7) --------
    reset(*counters)
    desc_g = cornell_desc(lt, cams_c, lt.PathtraceType.STANDARD, max_radiance=10.0)
    desc_g.force_software_bvh = True
    golden = np.load(GOLDEN)
    img_g = lt.render_progressive(
        scene_c, desc_g, lt.BakedPathtraceParams(max_bounces=8, samples_per_pixel=8),
        32, 32, 8, device=dev)
    within = float((np.abs(img_g - golden) <= 2e-3).mean())
    mean_rel = abs(float(img_g.mean()) - float(golden.mean())) / float(golden.mean())
    routed = {**packet.LAUNCHES, **bvh.LAUNCHES, **mega.LAUNCHES, **walk.LAUNCHES}
    emit("golden_bvh_route", atol=2e-3, pixels_within_atol=within,
         mean_rel_diff=mean_rel, max_abs_diff=float(np.abs(img_g - golden).max()),
         launches=routed)
    assert walk.LAUNCHES["walk"] > 0 and bvh.LAUNCHES["attr_fetch"] > 0
    assert mega.LAUNCHES["mega_pathtrace_spp"] == 0
    assert within >= 0.99 and mean_rel <= 0.01

    return [
        entry("B4 packet_traverse", "packet.cu", "lupinpathtracer_tpu/kernels/pallas_packet.py:1011",
              launches["packet_traverse"], res_b4["max_abs_err"], t_b4, p_b4,
              bnd_b4, by4),
        entry("B5 top_traverse (mean per main-path launch)", "bvh.cu",
              "lupinpathtracer_tpu/kernels/pallas_bvh.py:344",
              launches["top_traverse"], *b5_replay),
        entry("B6 pair_intersect", "pair_intersect.cuh", "lupinpathtracer_tpu/kernels/pallas_bvh.py:665",
              launches["pair_intersect"], res_b6["max_abs_err"], t_b6, p_b6,
              bnd_b6, by6),
        entry("B7 attr_fetch", "bvh.cu", "lupinpathtracer_tpu/kernels/pallas_bvh.py:896",
              launches["attr_fetch"], err7, t_b7, p_b7, bnd_b7, by7),
        entry("B7 attr_fetch (mean per main-path launch)", "bvh.cu",
              "lupinpathtracer_tpu/kernels/pallas_bvh.py:896",
              launches["attr_fetch"], *b7_replay),
    ], (ts, ro, rd, W, eps), cams, terrain


def emit_b6_launches(ts, desc, width, height, spp, bounces, tag, smi,
                     plain=False, what="STANDARD"):
    """B6 and its earlier design (V0) on every B6 launch of one main-path
    accumulation (tools/prof_pair.main_path_launches; desc's integrator,
    named by `what`): their sums, and per launch [pairs, tiles, mean and
    largest superleaves per tile, split chunks, B6 ms, V0 ms]. With
    `plain`, each launch is also held equal to its plain version, and
    replay_entry's values for the kernels line are returned."""

    from lupinpathtracer_tpu_torch.tools import prof_pair

    runs = prof_pair.main_path_launches(ts, desc, width, height, spp, bounces,
                                        plain=plain)
    emit("b6_main_path_launches", scene=tag, integrator=what, card=smi,
         launches=len(runs), equal_to_v0=True, equal_to_plain=plain or None,
         b6_ms=sum(r["b6_ms"] for r in runs), v0_ms=sum(r["v0_ms"] for r in runs),
         plain_ms=sum(r["plain_ms"] for r in runs) if plain else None,
         timed_by=sorted({r["timed_by"] for r in runs}),
         per_launch=[[r["pairs"], r["tiles"], round(r["superleaves_per_tile"], 2),
                      r["superleaves_per_tile_max"], r["split_chunks"],
                      round(r["b6_ms"], 4), round(r["v0_ms"], 4)] for r in runs])
    if plain:
        SP = ts.sl_stride
        bnds = [bound_ms(r["pairs"] * SP * PAIR_OPS,
                         r["pairs"] * (24 + 20) + r["items"] * 16
                         + r["superleaves"] * SP * 160) for r in runs]
        return replay_entry([dict(ms=r["b6_ms"], **r) for r in runs], bnds)
    return None


def replay_entry(runs, bnds, err=0.0):
    """entry()'s last arguments from a replay's launches and their bounds:
    the largest output difference (0 where the replay held each launch
    equal), the means per launch of ms, plain ms and bound (by what bounds
    the larger share of the sum), and timed_by."""

    n = max(len(runs), 1)
    by = max(("bytes", "operations"), key=lambda k: sum(b[0] for b in bnds if b[1] == k))
    timed_by = sorted({r["timed_by"] for r in runs})
    return (err, sum(r["ms"] for r in runs) / n, sum(r["plain_ms"] for r in runs) / n,
            (sum(b[0] for b in bnds) / n, by),
            timed_by[0] if timed_by == ["device_records"] else "events")


def emit_b2_launches(scene, desc, smi, width=512, height=512, spp=16, bounces=8,
                     what="DIRECT", run=None, tag="cornell"):
    """B2 on every B2 launch of one accumulation of the Cornell wavefront
    (tools/replay.b2_launches; desc's integrator, named by `what`) or of
    run() (a falsecolor dispatch), each equal to its plain version on every
    output: the sums and per launch [rays, hits, ms, plain ms, bound ms].
    Returns replay_entry's values for the kernels line."""

    from lupinpathtracer_tpu_torch.tools import replay

    runs = replay.b2_launches(scene, desc, width, height, spp, bounces, run=run)
    bnds = [b2_bound(r["rays"], r["tris"], r["columns"]) for r in runs]
    emit("b2_main_path_launches", scene=tag, integrator=what, card=smi,
         launches=len(runs), all_outputs_equal=True,
         ms=sum(r["ms"] for r in runs), plain_ms=sum(r["plain_ms"] for r in runs),
         bound_ms=sum(b[0] for b in bnds), bound_by=sorted({b[1] for b in bnds}),
         timed_by=sorted({r["timed_by"] for r in runs}),
         per_launch=[[r["rays"], r["hits"], round(r["ms"], 5), round(r["plain_ms"], 2),
                      round(b[0], 5)] for r, b in zip(runs, bnds)])
    return replay_entry(runs, bnds)


def emit_b7_launches(ts, desc, width, height, spp, bounces, tag, smi,
                     what="STANDARD", run=None):
    """B7 on every B7 launch of one main-path accumulation
    (tools/replay.b7_launches; desc's integrator, named by `what`) or of
    run(), each equal to its plain version: the sums and per launch
    [positions, winners, items, tiles, instances, ms, plain ms, bound ms].
    Returns replay_entry's values for the kernels line."""

    from lupinpathtracer_tpu_torch.tools import replay

    runs = replay.b7_launches(ts, desc, width, height, spp, bounces, run=run)
    bnds = [b7_bound(r, attr_row_bytes(r["tangents"])) for r in runs]
    emit("b7_main_path_launches", scene=tag, integrator=what, card=smi,
         launches=len(runs), tangent_rows=sorted({r["tangents"] for r in runs}),
         all_outputs_equal=True, ms=sum(r["ms"] for r in runs),
         plain_ms=sum(r["plain_ms"] for r in runs), bound_ms=sum(b[0] for b in bnds),
         bound_by=sorted({b[1] for b in bnds}),
         timed_by=sorted({r["timed_by"] for r in runs}),
         per_launch=[[r["positions"], r["winners"], r["items"], r["tiles"],
                      r["instances"], round(r["ms"], 5), round(r["plain_ms"], 2),
                      round(b[0], 6)] for r, b in zip(runs, bnds)])
    return replay_entry(runs, bnds)


def emit_b5_launches(ts, desc, width, height, spp, bounces, tag, smi,
                     what="STANDARD", run=None):
    """B5 on every B5 launch of one main-path accumulation
    (tools/prof_top.main_path_launches; desc's integrator, named by `what`)
    or of run() (a debug dispatch's counting pass), each equal to its plain
    version, aabb included: the sums, and per launch [lanes, live lanes, Q,
    pops, pushes, emits, rows read, ms, plain ms, bound ms]. Returns the
    largest output difference over the launches and the means per launch
    (ms, plain ms, bound, timed_by) for the kernels line."""

    from lupinpathtracer_tpu_torch.tools import prof_top

    runs = prof_top.main_path_launches(ts, desc, width, height, spp, bounces,
                                       run=run)
    bnds = [b5_bound(r["lanes"], r["Q"], r["aabb_tests"], r["pops"],
                     r["pushes"], r["hist_bins"], r["rows_read"]) for r in runs]
    err = max((r["max_abs_err"] for r in runs), default=0.0)
    emit("b5_main_path_launches", scene=tag, integrator=what, card=smi,
         launches=len(runs), aabb_tests=sum(r["aabb_tests"] for r in runs),
         max_abs_err_stack_below_sp=err, ms=sum(r["ms"] for r in runs),
         plain_ms=sum(r["plain_ms"] for r in runs), bound_ms=sum(b[0] for b in bnds),
         bound_by=sorted({b[1] for b in bnds}),
         timed_by=sorted({r["timed_by"] for r in runs}),
         per_launch=[[r["lanes"], r["live"], r["Q"], r["pops"], r["pushes"],
                      r["emits"], r["rows_read"], round(r["ms"], 5),
                      round(r["plain_ms"], 2), round(b[0], 6)]
                     for r, b in zip(runs, bnds)])
    return replay_entry(runs, bnds, err)


def entry(name, src, replaces, launches, err, ms, p_ms, bnd, timed_by,
          launches_in="main path"):
    """One element of the kernels line. `ms` is the kernel's device time
    where timed_by is "device_records" (kernel_ms). `launches` is the
    wrapper's launch counter over the run that `launches_in` names: the
    entry's main path, or the round-1 timing of prof_pair_phase."""

    return dict(name=name, route="cuda",
                source=f"lupinpathtracer_tpu_torch/csrc/{src}",
                replaces=replaces, launches=launches,
                max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=None, timed_by=timed_by,
                launches_in=launches_in)


def shade_phase(dev, smi, width=512, height=512, spp=5, bounces=8):
    """The BVH route's shading step (kernels/shade.py, csrc/shade.cu) at the
    spd_tetra.spd512 cell's shapes (262,144 lanes, 8 bounces, STANDARD) on
    SPD tetra at SHADE_SPD_SF: one accumulation through the fused step
    against the same accumulation through the PyTorch step (compare_paths);
    its launches (one a loop iteration) and
    their mean device ms (torch.profiler); the first iteration's launch and
    PyTorch step timed alone; the bound, the bytes its lanes read and write
    at 3.35 TB/s. Returns the kernels line's entry."""

    from torch.profiler import ProfilerActivity, profile

    from lupin_bench import port, scenes
    from lupinpathtracer_tpu_torch.core.types import PathtraceType
    from lupinpathtracer_tpu_torch.kernels import shade
    from lupinpathtracer_tpu_torch.render import integrators, renderer

    cfg = dict(scene=dict(generator="spd_tetra", args=dict(size_factor=SHADE_SPD_SF),
                          two_level=False))
    d = scenes.generate(cfg, 1)
    ts, build_s = port.build(d, False, dev)
    desc = port.path_desc(d["camera"], dict(integrator="STANDARD", max_radiance=100.0,
                                            ray_epsilon=0.001), 12345)
    cam = renderer._camera_args(desc)
    gx, gy = renderer._pixel_batch(width, height, 0, 0, dev)
    B = gx.shape[0]  # one lane a pixel: its samples regenerate in place
    ctx = integrators.make_ctx(ts, float(np.float32(1e-3)))
    std = PathtraceType.STANDARD
    regen = dict(gx=gx, gy=gy, resolution=(float(width), float(height)), cam=cam,
                 is_ortho=False, pixel_idx=gy * width + gx, accum_counter=3,
                 rng_seed=12345, spp=spp, max_radiance=100.0, sample_offset=0)

    def accumulate():
        return integrators.pathtrace_spp(
            ts, ctx, regen["pixel_idx"], gx, gy, regen["resolution"], cam, False, 3,
            12345, spp, std, bounces, 100.0)

    assert shade.applicable(ts, std, regen, gx)
    accumulate()  # builds the kernel
    torch.cuda.synchronize()
    l0, s0 = shade.LAUNCHES["shade"], dict(integrators.SHADE_STEPS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        acc_k, nt_k = accumulate()
        torch.cuda.synchronize()
    launches = shade.LAUNCHES["shade"] - l0
    assert launches == integrators.SHADE_STEPS["fused"] - s0["fused"] > 0
    assert integrators.SHADE_STEPS["plain"] == s0["plain"]
    recs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "lupin_shade_kernel(" in e.name]  # the steps, not the first rays
    timed_by = "device_records" if len(recs) == launches else "events"
    saved = shade.applicable
    shade.applicable = lambda *args: False
    try:
        t_plain_acc, (acc_p, nt_p) = cuda_ms(accumulate, 1)
    finally:
        shade.applicable = saved
    res = compare_paths(acc_k, nt_k, acc_p, nt_p)

    # The first iteration alone: the launch from a fresh copy of the
    # state each time, and the PyTorch step once.
    state = integrators.rng_mod.init_state(regen["pixel_idx"], 3, 12345, 0)
    state, ro, rd = integrators._camera_ray_from(regen, state)
    p = integrators._Path(ts, ctx, ro, rd, state, regen)
    step = shade.Step(ts, ctx, p, std, bounces)
    keep = [t.clone() for t in (step.f, step.c, step.state, step.alive)]
    hit_lanes = int((p.alive & p.hit.hit).sum())

    def first_launch():
        for t, k in zip((step.f, step.c, step.state, step.alive), keep):
            t.copy_(k)
        step(p)

    first_ms, _, first_by = kernel_ms(first_launch, "lupin_shade_kernel(", 20)
    for t, k in zip((step.f, step.c, step.state, step.alive), keep):
        t.copy_(k)
    p_ms, _ = plain_ms(lambda: step._plain(p))
    mean_ms = sum(recs) / max(len(recs), 1) / 1e3
    first_bytes = B * SHADE_LANE_BYTES + hit_lanes * SHADE_HIT_BYTES
    emit("shade_step", scene=f"spd_tetra SF {SHADE_SPD_SF}", triangles=ts.num_world_tris,
         build_s=build_s, lanes=B, spp=spp, launches_per_accum=launches,
         device_ms_per_accum=sum(recs) / 1e6, mean_launch_ms=mean_ms, timed_by=timed_by,
         first_launch_ms=first_ms, first_timed_by=first_by, first_hit_lanes=hit_lanes,
         first_bound_ms=bound_ms(0.0, first_bytes)[0], plain_step_ms=p_ms,
         plain_accum_ms=t_plain_acc, segments=int(nt_k.sum()), card=smi, **res)
    return entry("shade_step (spd_tetra.spd512 shapes, mean per launch)", "shade.cu",
                 "render/integrators.py::_pathtrace_snd's PyTorch step (no Pallas site)",
                 launches, res["acc_max_abs_err"], mean_ms, p_ms,
                 bound_ms(0.0, B * SHADE_LANE_BYTES), timed_by,
                 launches_in="one accumulation")


def on_wavefront(fn):
    """fn() with every batch that the BVH walk would take sent to the sort
    wavefront (B5, B6) instead, the route a single-level scene's bounce
    batches took before the walk: the B5 and B6 replays at a single-level
    scene's shapes run under it."""

    from lupinpathtracer_tpu_torch.kernels import intersect

    real = intersect._route

    def route(scene, x, coherent, with_counts=False):
        r = real(scene, x, coherent, with_counts)
        return "wavefront" if r == "walk" else r

    return with_attr(intersect, "_route", route, fn)


def bvh_route_kernels(ts):
    """The wrappers a BVH main path launches: B4 and B7, with the walk on a
    single-level scene's bounce batches and B5/B6 on a two-level one's."""

    return ("packet_traverse", "attr_fetch") + (
        ("top_traverse", "pair_intersect") if ts.two_level else ("walk",))


def walk_bound(work, lanes):
    """The walk's bound for one launch (walk_plain's counts): two slab
    tests a step and 81 operations a triangle tested; bytes: the rays in
    (24 B and the active byte), the records out (20 B), and the distinct
    nodes (32 B) and groups of four triangles (640 B) read, each once."""

    return bound_ms(work["steps"] * 2 * SLAB_OPS + work["tri_tests"] * PAIR_OPS,
                    lanes * (25 + 20) + work["nodes_read"] * 32
                    + work["groups_read"] * 640)


def walk_phase(dev, smi):
    """The BVH walk (kernels/walk.py, csrc/walk.cu) at the spd_tetra.spd512
    cell's shapes: SPD tetra at the configuration's size factor 10, 512x512
    x 5 spp, 8 bounces, seed 12345, through lupin_bench's loop. Every walk
    launch of one accumulation (the bounce batches) recorded and timed
    (tools/prof_pair.kernel_ms_each), the first held to walk_plain bit for
    bit with its work and bound; one accumulation's wall on the walk and
    with the walk's batches on the sort wavefront; the first samples'
    camera batch through B4 (its route) and through the walk, measured
    only. Returns the kernels line's entries."""

    from lupin_bench import cells, port, scenes
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.kernels import packet, walk
    from lupinpathtracer_tpu_torch.tools import prof_pair, replay

    with open(os.path.join(ROOT, "lupin_bench", "configs", "spd_tetra.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "lupin_bench", "traffic", "spd512.json")) as f:
        traffic = json.load(f)
    d = scenes.generate(cfg, 12345)
    ts, build_s = port.build(d, False, dev)
    loop = cells.loop_class("progressive")(ts, d, traffic, 12345, dev)
    loop.begin()

    def accum(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.step(i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    accum(0)
    walk_s = accum(1)
    wf_s = on_wavefront(lambda: accum(2))
    launches0 = walk.LAUNCHES["walk"]
    rec = replay.record_launches(walk, "walk", lambda: loop.step(3), share=(0, 4))
    assert len(rec) == walk.LAUNCHES["walk"] - launches0 > 0
    cam = replay.record_launches(packet, "packet_traverse", lambda: loop.step(4),
                                 share=(0, 4))[0]
    torch.cuda.synchronize()

    timed = prof_pair.kernel_ms_each(
        [lambda a=a, k=k: walk.walk(*a, **k) for a, k in rec], "lupin_walk_kernel", 3)
    a, k = rec[0]
    out = walk.walk(*a, **k)
    work: dict = {}
    p_ms, p = plain_ms(lambda: walk.walk_plain(ts.bvh_nodes, a[4], a[1], a[2], a[3],
                                               active=k.get("active"), counts=work))
    assert_equal(out, p, "walk")
    lanes = a[1].x.shape[0]
    live = [int(kk["active"].sum()) if kk.get("active") is not None else lanes
            for _, kk in rec]
    bnd = walk_bound(work, lanes)
    ms = [m for m, _ in timed]
    by = "device_records" if all(b == "device_records" for _, b in timed) else "events"
    emit("walk_spd512", scene="spd_tetra SF 10", triangles=ts.num_world_tris,
         nodes=int(ts.bvh_nodes.shape[0]), bvh_depth=ts.bvh_depth, build_s=build_s,
         accum_s_walk=walk_s, accum_s_wavefront=wf_s, launches=len(rec),
         lanes=lanes, live_per_launch=live, ms_per_launch=[round(m, 4) for m in ms],
         device_ms_per_accum=sum(ms), timed_by=by, first_launch_ms=ms[0],
         first_mrays_per_s=live[0] / ms[0] / 1e3, first_work=work,
         first_bound_ms=bnd[0], first_bound_by=bnd[1], first_plain_ms=p_ms,
         first_bit_for_bit=True, card=smi)

    # The camera batch: B4's route, and the walk on the same rays (measured
    # only: B4 keeps the route).
    ca, ck = cam
    ro, rd, eps, W = ca[1], ca[2], ca[3], ca[4]
    b4_ms, b4, b4_by = kernel_ms(lambda: packet.packet_traverse(*ca, **ck),
                                 "packet_kernel", 5)
    w_ms, wk, w_by = kernel_ms(lambda: walk.walk(ts, ro, rd, eps, W,
                                                 active=ck.get("active")),
                               "lupin_walk_kernel", 5)
    hit = wk[0] < dk.F32_MAX
    emit("walk_camera_batch", scene="spd_tetra SF 10", rays=ro.x.shape[0],
         b4_ms=b4_ms, b4_timed_by=b4_by, walk_ms=w_ms, walk_timed_by=w_by,
         walk_over_b4=w_ms / b4_ms, hits=int(hit.sum()),
         t_equal_share=float((wk[0] == b4[0]).float().mean()), card=smi)
    return [entry("Walk (spd512, the first bounce batch)", "walk.cu",
                  "none: the reference's bvh_custom.wgsl:195-288 walk, re-shaped by "
                  "the JAX package into B5/B6 for the TPU", len(rec), 0.0,
                  ms[0], p_ms, bnd, timed[0][1], launches_in="one accumulation")]


def two_level_kernels(ts, cams, tag, dev, width, height, brute_rays):
    """One instanced scene's kernels against their plain versions at its
    main path's shapes: B4 on the camera rays (bit for bit); B5, and B6 and
    B7 with the per-item instance word, on the first bounce batch;
    closest_hit against the brute-force reference on `brute_rays` of those
    rays. Returns {key: (max_abs_err, ms, plain
    ms, bound, timed_by)}, entry()'s last arguments, and the camera batch
    (ro, rd, W, eps)."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.core.vec3 import V3
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, packet
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.tools import prof_pair, prof_top, replay

    F32_MAX = dk.F32_MAX
    SP, n_sl, n_inst = ts.sl_stride, ts.sl_count, ts.num_instances
    rows = ts.top_tab.shape[0]
    eps = float(np.float32(lt.PathtraceDesc().advanced.ray_epsilon))
    W = intersect.scene_tri_matrix(ts)
    ro, rd = prof_pair.camera_rays(cams[0], width, height, dev)
    B = ro.x.shape[0]
    out = {}

    # B4 on the camera rays: each leaf visit also moves the ray to mesh
    # space (its 64-byte gsl_meta row read).
    work4: dict = {}
    p_b4, p4 = plain_ms(lambda: packet.packet_traverse_plain(
        ts, ro, rd, eps, W, counts=work4))
    t_b4, k4, by4 = kernel_ms(lambda: packet.packet_traverse(ts, ro, rd, eps, W),
                              "packet_kernel", 5)
    res = compare_hits(k4, p4, F32_MAX)
    assert_equal(k4, p4, "B4 two-level")
    out["b4"] = (res["max_abs_err"], t_b4, p_b4, b4_bound(
        work4, B, B * 20, rows, ts.sl_sub.numel(),
        extra_ops=work4["leaf_visits"] * LEAF_FRAME_OPS,
        extra_bytes=work4["leaf_visits"] * 64), by4)
    hits4 = int((p4[0] < F32_MAX).sum())
    emit("b4_vs_plain", scene=tag, hits=hits4, bit_for_bit=True, ms=t_b4,
         bound_ms=out["b4"][3][0], **work4, **res)
    assert hits4 > 0

    # The first bounce batch, from the camera hits.
    h_cam = intersect.closest_hit(ts, ro, rd, eps, W=W)
    gn = intersect.wavefront_fetch_attrs(ts, h_cam).gn
    o, d = bounce_batch(ro, rd, h_cam.dst, gn, F32_MAX, seed=1)
    pad = (-B) % intersect.WF_RAY_BLOCK
    Bp = B + pad
    op = V3(*(intersect._pad(c, pad, 0.0) for c in o))
    dp = V3(intersect._pad(d.x, pad, 0.0), intersect._pad(d.y, pad, 1.0),
            intersect._pad(d.z, pad, 0.0))
    S = bvh.stack_depth(ts)
    Q = intersect.WF_Q
    tab = ts.top_tab
    stack0 = torch.zeros((S, Bp), dtype=torch.int32, device=dev)
    sp0 = (torch.arange(Bp, device=dev) < B).to(torch.int32)
    bt0 = torch.full((Bp,), F32_MAX, dtype=torch.float32, device=dev)

    # B5 on that batch's first round (its stack is updated in place and
    # compared below each lane's sp).
    t_b5, k5, by5 = kernel_ms(lambda: bvh.top_traverse(
        tab, op, dp, bt0, stack0.clone(), sp0, S=S, Q=Q, n_sl=n_sl),
        "top_kernel", 5)
    work5: dict = {}
    p_b5, p5 = plain_ms(lambda: bvh.top_traverse_plain(
        tab, op, dp, bt0, stack0.clone(), sp0, S=S, Q=Q, n_sl=n_sl,
        counts=work5))
    err5 = prof_top.max_abs_diff(k5, p5, S)
    aabb5 = int(k5[5].sum())
    out["b5"] = (err5, t_b5, p_b5, b5_bound(
        Bp, Q, aabb5, work5["pops"], work5["pushes"],
        0 if k5[4] is None else k5[4].numel(), work5["rows_read"]), by5)
    emit("b5_two_level_vs_plain", scene=tag, lanes=Bp, Q=Q, S=S,
         emits=int(k5[1].sum()), aabb_tests=aabb5, histogram=k5[4] is not None,
         pending=int((k5[3] > 0).sum()), max_abs_err_stack_below_sp=err5,
         ms=t_b5, plain_ms=p_b5, bound_ms=out["b5"][3][0], **work5)
    assert err5 == 0

    # B6 on the round's pairs, each item's rays moved to mesh space by its
    # instance word in the kernel.
    c0 = dict(stack=stack0.clone(), sp=sp0, best_t=bt0)
    pre_ms, (args6, kw6, skey, _, n_real, *_) = plain_ms(
        lambda: intersect._wf_pairs(ts, tab, op, dp, c0, S=S,
                                    PB=intersect.WF_PAIR_BLOCK, Q=Q))
    assert kw6["inst"] is not None
    t_b6, k6, by6 = kernel_ms(lambda: bvh.pair_intersect(*args6, W, eps, **kw6),
                              "pair_hit_kernel", 5)
    p_b6, p6 = plain_ms(lambda: bvh.pair_intersect_plain(*args6, W, eps, **kw6))
    res6 = compare_hits(k6, p6, F32_MAX)
    assert res6["hit_flag_mismatch"] == 0, res6
    assert all(bool(torch.equal(a, b)) for a, b in zip(k6, p6))
    pairs, items = int(n_real), int(kw6["n_items"])
    msl_used = int(torch.unique(args6[1][:items]).numel())
    bnd6 = bound_ms(pairs * SP * PAIR_OPS + pairs * XFORM_OPS,
                    pairs * (24 + 20) + items * 20 + msl_used * SP * 160
                    + n_inst * 48)
    out["b6"] = (res6["max_abs_err"], t_b6, p_b6, bnd6, by6)
    emit("b6_two_level_vs_plain", scene=tag, items=items,
         item_capacity=int(args6[0].shape[0]), mesh_superleaves=msl_used,
         wf_pairs_ms=pre_ms, **pair_live_shares(
             args6[0], args6[2], args6[3], kw6["n_items"], int(skey.shape[0])),
         **res6)

    # B7 on the batch's winners, sorted as wavefront_fetch_attrs sorts them.
    h7 = intersect.closest_hit(ts, o, d, eps, W=W, coherent=False)
    args7, kw7, _, _ = intersect._attr_fetch_args(ts, h7)
    assert kw7["inst"] is not None
    t_b7, rows7, by7 = kernel_ms(lambda: bvh.attr_fetch(*args7, **kw7),
                                 "attr_kernel", 5)
    p_b7, p7 = plain_ms(lambda: bvh.attr_fetch_plain(*args7, **kw7))
    err7 = float((rows7 - p7).abs().max())
    rows_equal = bool(torch.equal(rows7, p7))
    fetch_ms, ia7 = cuda_ms(lambda: intersect.wavefront_fetch_attrs(ts, h7), 3)
    hits7 = int(h7.hit.sum())
    bnd7 = b7_bound(replay.attr_work(args7, kw7),
                    attr_row_bytes(bool(ts.any_normal_maps)))
    out["b7"] = (err7, t_b7, p_b7, bnd7, by7)
    gn2 = sum(c * c for c in ia7.gn)[h7.hit]
    emit("b7_two_level_vs_plain", scene=tag, hits=hits7,
         item_capacity=int(args7[0].shape[0]), rows_equal=rows_equal,
         max_abs_err=err7, wavefront_fetch_attrs_ms=fetch_ms,
         gn_unit_max_err=float((gn2 - 1.0).abs().max()))
    # 1 / sqrt is IEEE in the kernel and in PyTorch: equal rows.
    assert rows_equal and float((gn2 - 1.0).abs().max()) <= 1e-5

    # closest_hit on both routes against the brute-force reference.
    step = max(B // brute_rays, 1)
    res_b = {}
    for name_, (O, D) in (("camera", (ro, rd)), ("bounce", (o, d))):
        O, D = V3(*(c[::step] for c in O)), V3(*(c[::step] for c in D))
        ref = intersect.closest_hit_brute_two_level(ts, O, D, eps, W, chunk=64)
        n_ref = max(float(ref.hit.sum()), 1.0)
        for coherent in (True, False):
            h = intersect.closest_hit(ts, O, D, eps, W=W, coherent=coherent)
            both = h.hit & ref.hit
            r = dict(rays=int(O.x.shape[0]), hits=int(ref.hit.sum()),
                     hit_flag_mismatch=int((h.hit != ref.hit).sum()),
                     max_abs_dt=float((h.dst - ref.dst)[both].abs().max()),
                     same_winner_share=float((h.tri == ref.tri)[ref.hit].sum()) / n_ref)
            res_b[f"{name_}_{'b4' if coherent else 'wavefront'}"] = r
            # A grazing hit can fall on the other side of a validity test
            # when the products are summed in another order.
            assert r["hit_flag_mismatch"] <= 1e-3 * n_ref, r
            assert r["same_winner_share"] >= 0.95, r
            assert torch.allclose(h.dst[both], ref.dst[both], rtol=1e-5, atol=1e-5), r
    assert res_b["bounce_b4"]["hits"] > 0 and res_b["camera_b4"]["hits"] > 0
    emit("two_level_vs_brute_force", scene=tag, rtol=1e-5, atol=1e-5, **res_b)
    return out, (ro, rd, W, eps)


def instanced_phases(dev, smi, width=512, height=288, spp=4, bounces=8,
                     timed_accums=3):
    """The two-level route: the 100,000-instance field's build, kernels,
    main path and B5/B6 replays, and the 2,000-instance field's kernels and
    one accumulation. Returns their kernel entries, the 100k field's
    (scene, camera rays, W, eps) for the B6' phase and its cameras."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.io import synthetic
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, mega, packet
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk

    counters = (bvh.LAUNCHES, packet.LAUNCHES, dk.LAUNCHES, mega.LAUNCHES,
                intersect.HOST_SYNCS)
    baked = lt.BakedPathtraceParams(max_bounces=bounces, samples_per_pixel=spp)
    scenes = {}
    for tag, n in (("instanced100k", FIELD_INSTANCES),
                   ("instanced2k", SMALL_FIELD_INSTANCES)):
        t0 = time.perf_counter()
        field, cams = synthetic.build_scene_instanced_field(
            n_instances=n, seed=0, tris_per_mesh=64)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ts = lt.build_scene_torch(field, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        emit("instanced_build", scene=tag, instances=ts.num_instances,
             generate_s=gen_s, build_scene_torch_s=build_s, sl_count=ts.sl_count,
             msl_count=ts.msl_count, sl_stride=ts.sl_stride,
             nsub=int(ts.sl_sub.shape[1]), top_rows=int(ts.top_tab.shape[0]),
             top_depth=ts.top_depth, histogram_bins=bvh.hist_bins(ts.sl_count),
             packet_eligible=intersect.packet_eligible(ts))
        assert ts.use_bvh and ts.two_level and intersect.packet_eligible(ts)
        scenes[tag] = (ts, cams)

    kernels = []
    state = None
    for tag, (ts, cams) in scenes.items():
        big = tag == "instanced100k"
        meas, cam_batch = two_level_kernels(
            ts, cams, tag, dev, width, height, brute_rays=1024 if big else 4096)

        # The main path: bench.py's instanced100k render (camera 0, STANDARD,
        # max_radiance 10); the small field takes one accumulation of it.
        desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
        accums = timed_accums if big else 1
        t0 = time.perf_counter()
        lt.render_progressive(ts, desc, baked, width, height, 1, device=dev)
        warm_s = time.perf_counter() - t0
        stats: dict = {}
        reset(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = lt.render_progressive(ts, desc, baked, width, height, accums,
                                    device=dev, stats=stats)
        wall = time.perf_counter() - t0
        launches = {**packet.LAUNCHES, **bvh.LAUNCHES}
        dense_launches = {**dk.LAUNCHES, **mega.LAUNCHES}
        emit("main_path_instanced", scene=tag, width=width, height=height,
             integrator="STANDARD", bounces=bounces, spp=spp,
             accumulations=accums, warmup_s=warm_s, wall_s=wall,
             s_per_accumulation=wall / accums, rays=stats["rays"],
             mrays_per_s=stats["rays"] / wall / 1e6,
             launches_per_accumulation={k: v / accums for k, v in launches.items()},
             wavefront_host_syncs_per_accumulation=(
                 intersect.HOST_SYNCS["wavefront"] / accums),
             dense_launches=dense_launches, image_mean=float(img.mean()),
             image_finite=bool(np.isfinite(img).all()), card=smi)
        assert not any(dense_launches.values()), dense_launches
        assert np.isfinite(img).all() and img.mean() > 0
        for key in ("packet_traverse", "top_traverse", "pair_intersect",
                    "attr_fetch"):
            assert launches[key] > 0, launches
        if big:
            state = (ts, *cam_batch)
            big_cams = cams
            prof = device_profile(lambda: lt.render_progressive(
                ts, desc, baked, width, height, 1, device=dev))
            emit("main_path_instanced_profile", scene=tag, accumulations=1,
                 card=smi, device_busy_share_of_timed_wall=(
                     prof["device_busy_ms"] * 1e-3 * accums / wall), **prof)
            # B5's entry: the means over the replayed main-path launches.
            meas["b5"] = emit_b5_launches(ts, desc, width, height, REPLAY_SPP,
                                          bounces, tag, smi)
            emit_b6_launches(ts, desc, width, height, REPLAY_SPP, bounces, tag, smi)
            meas["b7_replay"] = emit_b7_launches(ts, desc, width, height,
                                                 REPLAY_SPP, bounces, tag, smi)

        kernels += [
            entry(f"B4 packet_traverse (two-level; {tag})",
                  "packet.cu", "lupinpathtracer_tpu/kernels/pallas_packet.py:1011",
                  launches["packet_traverse"], *meas["b4"]),
            entry(f"B5 top_traverse ({tag}; "
                  + ("mean per main-path launch)" if big else "first bounce round)"),
                  "bvh.cu", "lupinpathtracer_tpu/kernels/pallas_bvh.py:344",
                  launches["top_traverse"], *meas["b5"]),
            entry(f"B6 pair_intersect (instance word; {tag})", "pair_intersect.cuh",
                  "lupinpathtracer_tpu/kernels/pallas_bvh.py:665", launches["pair_intersect"],
                  *meas["b6"]),
            entry(f"B7 attr_fetch (instance word; {tag})", "bvh.cu",
                  "lupinpathtracer_tpu/kernels/pallas_bvh.py:896", launches["attr_fetch"],
                  *meas["b7"]),
        ]
        if big:
            kernels.append(entry(
                f"B7 attr_fetch (instance word; {tag}; mean per main-path launch)",
                "bvh.cu", "lupinpathtracer_tpu/kernels/pallas_bvh.py:896",
                launches["attr_fetch"], *meas["b7_replay"]))
    return kernels, state, big_cams


# The new phases' sizes (bench.py's widths; 16 spp on the dense MIS path
# and 8 bounces everywhere are the depth cuts PERF.md section 4 lists).
API = dict(dense_wh=(512, 512), dense_spp=16, bvh_wh=(512, 288), bvh_spp=4,
           bounces=8)


def emit_b4_launches(ts, run, tag, smi, what):
    """B4 on every B4 launch of run() (tools/replay.b4_launches), each
    equal to its plain version: the sums and per launch [rays, hits, ms,
    plain ms, bound ms]. Returns replay_entry's values for the kernels
    line."""

    from lupinpathtracer_tpu_torch.tools import replay

    runs = replay.b4_launches(ts, run)
    rows = ts.top_tab.shape[0]
    row_b = attr_row_bytes(bool(ts.any_normal_maps))
    bnds = []
    for r in runs:
        w, B = r["counts"], r["rays"]
        if ts.two_level:
            bnds.append(b4_bound(w, B, B * 20, rows, ts.sl_sub.numel(),
                                 extra_ops=w["leaf_visits"] * LEAF_FRAME_OPS,
                                 extra_bytes=w["leaf_visits"] * 64))
        else:
            bnds.append(b4_bound(w, B, B * (20 + r["attr_rows"] * 4)
                                 + (r["hits"] * row_b if r["attr_rows"] else 0),
                                 rows, ts.sl_sub.numel()))
    emit("b4_main_path_launches", scene=tag, integrator=what, card=smi,
         launches=len(runs), attr_rows=sorted({r["attr_rows"] for r in runs}),
         all_outputs_equal=True, ms=sum(r["ms"] for r in runs),
         plain_ms=sum(r["plain_ms"] for r in runs), bound_ms=sum(b[0] for b in bnds),
         bound_by=sorted({b[1] for b in bnds}),
         timed_by=sorted({r["timed_by"] for r in runs}),
         per_launch=[[r["rays"], r["hits"], r["attr_rows"], round(r["ms"], 5),
                      round(r["plain_ms"], 2), round(b[0], 6)]
                     for r, b in zip(runs, bnds)])
    return replay_entry(runs, bnds)


def timed_render(scene, desc, baked, width, height, accums, counters, dev):
    """One warm-up accumulation, then `accums` timed ones with the counters
    set to 0 just before: (warm-up s, wall s, rays, image)."""

    import lupinpathtracer_tpu_torch as lt

    t0 = time.perf_counter()
    lt.render_progressive(scene, desc, baked, width, height, 1, device=dev)
    warm_s = time.perf_counter() - t0
    stats: dict = {}
    reset(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = lt.render_progressive(scene, desc, baked, width, height, accums,
                                device=dev, stats=stats)
    return warm_s, time.perf_counter() - t0, stats["rays"], img


def dispatch_ms(fn):
    """(ms, output) of one dispatch on the card, host and device (wall
    time between two synchronizations)."""

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


B2_SITE = "lupinpathtracer_tpu/kernels/pallas_intersect.py:298"
B4_SITE = "lupinpathtracer_tpu/kernels/pallas_packet.py:1011"
B5_SITE = "lupinpathtracer_tpu/kernels/pallas_bvh.py:344"
B6_SITE = "lupinpathtracer_tpu/kernels/pallas_bvh.py:665"
B7_SITE = "lupinpathtracer_tpu/kernels/pallas_bvh.py:896"


def mis_phases(dev, smi, scene_c, cams_c, bvh_scenes, counters):
    """Phases 14-15: MIS on the dense route (Cornell 512², 16 spp: B2; the
    32² MIS golden on the dense and the BVH route) and on both BVH main
    paths (B4 on the camera prologue, B5/B6/B7 on the three-slot bounce
    batches). On each, every launch of one accumulation of 1 spp (a depth
    cut) is replayed against its plain version, B6 also against V0.
    Returns the kernel entries."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, mega, packet, walk
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.render import integrators
    from lupinpathtracer_tpu_torch.tools.replay import one_accumulation

    MIS = lt.PathtraceType.MIS
    kernels = []

    # -- 14. MIS on the dense route: outside B3's gate, the wavefront with B2.
    desc = cornell_desc(lt, cams_c, MIS)
    (dw, dh), dspp, nb = API["dense_wh"], API["dense_spp"], API["bounces"]
    baked = lt.BakedPathtraceParams(max_bounces=nb, samples_per_pixel=dspp)
    warm_s, wall, rays, img = timed_render(scene_c, desc, baked, dw, dh, 1,
                                           counters, dev)
    launches_b2 = dk.LAUNCHES["dense_closest_hit_attrs"]
    emit("main_path_mis", scene="cornell", integrator="MIS", width=dw, height=dh,
         bounces=nb, spp=dspp, accumulations=1, warmup_s=warm_s,
         s_per_accumulation=wall, rays=rays, mrays_per_s=rays / wall / 1e6,
         launches={**dk.LAUNCHES, **mega.LAUNCHES},
         host_syncs={**intersect.HOST_SYNCS, **integrators.HOST_SYNCS},
         image_mean=float(img.mean()), card=smi)
    assert launches_b2 > 0 and mega.LAUNCHES["mega_pathtrace_spp"] == 0
    assert np.isfinite(img).all() and img.mean() > 0
    kernels.append(entry(
        "B2 dense_closest_hit_attrs (Cornell MIS, mean per main-path launch)",
        "dense_intersect.cu", B2_SITE, launches_b2,
        *emit_b2_launches(scene_c, desc, smi, dw, dh, 1, nb, what="MIS"),
        launches_in="main_path_mis"))

    golden = np.load(GOLDEN_MIS)
    for route in ("dense", "bvh"):
        reset(*counters)
        desc_g = cornell_desc(lt, cams_c, MIS, max_radiance=10.0)
        desc_g.force_software_bvh = route == "bvh"
        img_g = lt.render_progressive(
            scene_c, desc_g, lt.BakedPathtraceParams(max_bounces=8, samples_per_pixel=8),
            32, 32, 8, device=dev)
        within = float((np.abs(img_g - golden) <= 2e-3).mean())
        mean_rel = abs(float(img_g.mean()) - float(golden.mean())) / float(golden.mean())
        emit("golden_mis", route=route, atol=2e-3, pixels_within_atol=within,
             mean_rel_diff=mean_rel, max_abs_diff=float(np.abs(img_g - golden).max()),
             launches={**dk.LAUNCHES, **bvh.LAUNCHES, **mega.LAUNCHES,
                       **walk.LAUNCHES})
        assert mega.LAUNCHES["mega_pathtrace_spp"] == 0
        assert (walk.LAUNCHES["walk"] > 0) == (route == "bvh")
        assert within >= 0.99 and mean_rel <= 0.01

    # -- 15. MIS on the BVH main paths.
    (w, h), spp = API["bvh_wh"], API["bvh_spp"]
    for tag, (ts, cams), accums in (("terrain2M", bvh_scenes["terrain2M"], 2),
                                    ("instanced100k", bvh_scenes["instanced100k"], 1)):
        desc = cornell_desc(lt, cams, MIS, max_radiance=10.0)
        baked = lt.BakedPathtraceParams(max_bounces=nb, samples_per_pixel=spp)
        warm_s, wall, rays, img = timed_render(ts, desc, baked, w, h, accums,
                                               counters, dev)
        launches = {**packet.LAUNCHES, **bvh.LAUNCHES, **walk.LAUNCHES}
        dense = {**dk.LAUNCHES, **mega.LAUNCHES}
        emit("main_path_bvh_mis", scene=tag, integrator="MIS", width=w, height=h,
             bounces=nb, spp=spp, accumulations=accums, warmup_s=warm_s, wall_s=wall,
             s_per_accumulation=wall / accums, rays=rays,
             mrays_per_s=rays / wall / 1e6,
             launches_per_accumulation={k: v / accums for k, v in launches.items()},
             host_syncs_per_accumulation={
                 k: v / accums for k, v in {**intersect.HOST_SYNCS,
                                            **integrators.HOST_SYNCS}.items()},
             dense_launches=dense, image_mean=float(img.mean()),
             image_finite=bool(np.isfinite(img).all()), card=smi)
        assert all(launches[k] > 0 for k in bvh_route_kernels(ts)), launches
        assert not any(dense.values()) and np.isfinite(img).all() and img.mean() > 0
        prof = device_profile(lambda: lt.render_progressive(
            ts, desc, baked, w, h, 1, device=dev))
        emit("main_path_bvh_mis_profile", scene=tag, accumulations=1, card=smi,
             device_busy_share_of_timed_wall=prof["device_busy_ms"] * 1e-3
             * accums / wall, **prof)
        run = one_accumulation(ts, desc, w, h, 1, nb)
        path = f"main_path_bvh_mis {tag}"
        kernels += [
            entry(f"B4 packet_traverse ({tag} MIS camera prologue)", "packet.cu",
                  B4_SITE, launches["packet_traverse"],
                  *emit_b4_launches(ts, run, tag, smi, "MIS"), launches_in=path),
            entry(f"B5 top_traverse ({tag} MIS, mean per main-path launch)", "bvh.cu",
                  B5_SITE, launches["top_traverse"],
                  *on_wavefront(lambda: emit_b5_launches(ts, desc, w, h, 1, nb, tag,
                                                         smi, what="MIS")),
                  launches_in=path),
            entry(f"B6 pair_intersect ({tag} MIS, mean per main-path launch)",
                  "pair_intersect.cuh", B6_SITE, launches["pair_intersect"],
                  *on_wavefront(lambda: emit_b6_launches(ts, desc, w, h, 1, nb, tag, smi,
                                                         plain=True, what="MIS")),
                  launches_in=path),
            entry(f"B7 attr_fetch ({tag} MIS, mean per main-path launch)", "bvh.cu",
                  B7_SITE, launches["attr_fetch"],
                  *emit_b7_launches(ts, desc, w, h, 1, nb, tag, smi, what="MIS"),
                  launches_in=path),
        ]
    return kernels


def aov_phases(dev, smi, scene_c, cams_c, bvh_scenes, counters):
    """Phases 16-17: all 12 falsecolor AOVs on the Cornell box (512², B2),
    terrain2M (512x288, B4 with attributes) and instanced100k (B4, B7) at
    1 spp, every B2, B4 and B7 launch of an ALBEDO and a NORMALS dispatch
    replayed, and a 32x32 tile of each image against the same tile
    dispatched on CPU tensors; the three debug heatmaps on terrain2M (every
    B5 launch of the counting pass replayed); the denoiser on a terrain2M
    accumulation guided by its ALBEDO and NORMALS AOVs, against the same
    call on CPU tensors. Returns the kernel entries."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, packet, walk
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.render import integrators

    FC = lt.FalsecolorType
    kernels = []
    scenes = [("cornell", scene_c, cams_c, *API["dense_wh"], 10.0),
              *((tag, ts, cams, *API["bvh_wh"], 10.0)
                for tag, (ts, cams) in bvh_scenes.items())]
    one = lt.BakedPathtraceParams(samples_per_pixel=1)
    guides = {}
    for tag, sc, cams, width, height, maxr in scenes:
        desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=maxr)
        cpu = sc.to("cpu")
        tiles = lt.get_num_tiles(width, height, 32)
        k_tile = tiles[0] * (tiles[1] // 2) + tiles[0] // 2  # a central tile
        tx, ty = (k_tile % tiles[0]) * 32, (k_tile // tiles[0]) * 32
        reset(*counters)
        for fc in FC:
            ms, img = dispatch_ms(lambda fc=fc: lt.pathtrace_scene_falsecolor(
                sc, lt.new_accumulation_buffer(width, height, device=dev), desc,
                one, fc))
            desc_t = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=maxr)
            desc_t.tile_params = lt.TileParams(enabled=True, tile_idx=k_tile,
                                               tile_size=32)
            t0 = time.perf_counter()
            ref = lt.pathtrace_scene_falsecolor(
                cpu, lt.new_accumulation_buffer(width, height, device="cpu"), desc_t,
                one, fc)[ty:ty + 32, tx:tx + 32]
            cpu_s = time.perf_counter() - t0
            diff = (img[ty:ty + 32, tx:tx + 32].cpu() - ref).abs().amax(-1)
            share = float((diff <= 1e-4).float().mean())
            emit("aov", scene=tag, falsecolor=fc.name, width=width, height=height,
                 spp=1, ms=ms, image_mean=float(img.mean()),
                 tile_max_abs_diff_vs_cpu=float(diff.max()),
                 tile_atol=1e-4, tile_share_within_atol=share, tile_cpu_s=cpu_s, card=smi)
            assert bool(torch.isfinite(img).all()) and share >= 0.99
            if tag == "terrain2M" and fc in (FC.ALBEDO, FC.NORMALS):
                guides[fc] = img
        launches = {**dk.LAUNCHES, **packet.LAUNCHES, **bvh.LAUNCHES}
        emit("aov_launches", scene=tag, dispatches=len(FC), launches=launches,
             host_syncs=dict(intersect.HOST_SYNCS), card=smi)
        for fc in (FC.ALBEDO, FC.NORMALS):
            def run(fc=fc):
                return lt.pathtrace_scene_falsecolor(
                    sc, lt.new_accumulation_buffer(width, height, device=dev), desc,
                    one, fc)
            what = f"falsecolor {fc.name}"
            path = f"aov {tag} (12 dispatches)"
            if tag == "cornell":
                assert launches["dense_closest_hit_attrs"] > 0
                kernels.append(entry(
                    f"B2 dense_closest_hit_attrs (Cornell {what}, mean per launch)",
                    "dense_intersect.cu", B2_SITE, launches["dense_closest_hit_attrs"],
                    *emit_b2_launches(sc, desc, smi, what=what, run=run),
                    launches_in=path))
                continue
            assert launches["packet_traverse"] > 0
            kernels.append(entry(
                f"B4 packet_traverse ({tag} {what}, mean per launch)", "packet.cu",
                B4_SITE, launches["packet_traverse"],
                *emit_b4_launches(sc, run, tag, smi, what), launches_in=path))
            if sc.two_level:
                assert launches["attr_fetch"] > 0
                kernels.append(entry(
                    f"B7 attr_fetch ({tag} {what}, mean per launch)", "bvh.cu",
                    B7_SITE, launches["attr_fetch"],
                    *emit_b7_launches(sc, desc, width, height, 1, 0, tag, smi,
                                      what=what, run=run), launches_in=path))
        del cpu

    # -- 17. the debug heatmaps and the denoiser on terrain2M.
    ts, cams = bvh_scenes["terrain2M"]
    (w, h), nb = API["bvh_wh"], API["bounces"]
    desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
    baked = lt.BakedPathtraceParams(max_bounces=nb, samples_per_pixel=API["bvh_spp"])
    for mode, hi in (("tri_checks", 40960.0), ("aabb_checks", 400.0), ("bounces", 9.0)):
        def run(mode=mode, hi=hi):
            return lt.pathtrace_scene_debug(
                ts, lt.new_accumulation_buffer(w, h, device=dev), desc, baked,
                mode, heatmap_max=hi)
        run()
        reset(*counters)
        ms, img = dispatch_ms(run)
        launches = {**packet.LAUNCHES, **bvh.LAUNCHES, **walk.LAUNCHES}
        emit("debug", scene="terrain2M", mode=mode, width=w, height=h, ms=ms,
             launches=launches,
             host_syncs={**intersect.HOST_SYNCS, **integrators.HOST_SYNCS},
             image_mean=float(img.mean()), card=smi)
        assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
        if mode == "bounces":
            assert launches["packet_traverse"] > 0 and launches["walk"] > 0
            continue
        assert launches["packet_traverse"] == 0 and launches["top_traverse"] > 0
        kernels.append(entry(
            f"B5 top_traverse (terrain2M debug {mode} counting pass, mean per launch)",
            "bvh.cu", B5_SITE, launches["top_traverse"],
            *emit_b5_launches(ts, desc, w, h, 1, 0, "terrain2M", smi,
                              what=f"debug {mode}", run=run),
            launches_in=f"debug {mode} terrain2M"))

    color = lt.render_progressive(ts, desc, baked, w, h, 1, device=dev)
    color = torch.from_numpy(color).to(dev)
    args = (color, guides[FC.ALBEDO], guides[FC.NORMALS])
    d = lt.DenoiseDesc()
    kw = dict(iterations=d.iterations, sigma_color=d.sigma_color,
              sigma_albedo=d.sigma_albedo, sigma_normal=d.sigma_normal)
    ms, out = cuda_ms(lambda: lt.denoise(*args, **kw), 3)
    t0 = time.perf_counter()
    ref = lt.denoise(*(a.cpu() for a in args), **kw)
    cpu_s = time.perf_counter() - t0
    err = float((out.cpu() - ref).abs().max())
    emit("denoise", scene="terrain2M", width=w, height=h, guides=["ALBEDO", "NORMALS"],
         iterations=d.iterations, ms=ms, cpu_s=cpu_s, max_abs_err_vs_cpu=err,
         noisy_mean=float(color.mean()), denoised_mean=float(out.mean()), card=smi)
    assert bool(torch.isfinite(out).all()) and err <= 1e-4
    return kernels


def streams_phase(dev, smi, bvh_scenes, counters):
    """Phase 18: LUPIN_SPP_STREAMS K = 1, 2 and 4 (spp 4) on both BVH main
    paths, K = 1 the control: per K one warm-up and one timed accumulation
    (s, Mrays/s, launches, host syncs) and one profiled (device busy, the
    other PyTorch launches); the traced segments equal to K = 1's, the
    image within rtol 3e-6 / atol 1e-6 of it."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, packet
    from lupinpathtracer_tpu_torch.render import integrators

    (w, h), spp, nb = API["bvh_wh"], API["bvh_spp"], API["bounces"]
    baked = lt.BakedPathtraceParams(max_bounces=nb, samples_per_pixel=spp)
    try:
        for tag, (ts, cams) in bvh_scenes.items():
            desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
            base = None
            for K in (1, 2, 4):
                os.environ["LUPIN_SPP_STREAMS"] = str(K)
                mem0 = torch.cuda.memory_stats(dev)
                warm_s, wall, rays, img = timed_render(ts, desc, baked, w, h, 1,
                                                       counters, dev)
                mem1 = torch.cuda.memory_stats(dev)
                alloc = {k: mem1.get(k, 0) - mem0.get(k, 0) for k in (
                    "num_device_alloc", "num_device_free", "num_alloc_retries")}
                alloc["peak_allocated_gb"] = mem1.get("allocated_bytes.all.peak", 0) / 1e9
                launches = {**packet.LAUNCHES, **bvh.LAUNCHES}
                syncs = {**intersect.HOST_SYNCS, **integrators.HOST_SYNCS}
                prof = device_profile(lambda: lt.render_progressive(
                    ts, desc, baked, w, h, 1, device=dev))
                if base is None:
                    base = (rays, img)
                same = bool(np.allclose(img, base[1], rtol=3e-6, atol=1e-6))
                other = {g: n for g, n in prof["kernels_by_group"].items()
                         if g not in dict(KERNEL_GROUPS)}
                emit("spp_streams", scene=tag, K=K, spp=spp, bounces=nb, width=w,
                     top_other_torch=prof["top_other_torch"],
                     height=h, warmup_s=warm_s, s_per_accumulation=wall, rays=rays,
                     mrays_per_s=rays / wall / 1e6, launches=launches, host_syncs=syncs,
                     other_torch_launches=other,
                     device_busy_ms=prof["device_busy_ms"],
                     device_busy_share_of_timed_wall=prof["device_busy_ms"] * 1e-3 / wall,
                     allocator_over_warmup_and_timed=alloc,
                     rays_equal_k1=rays == base[0], image_within_tol_of_k1=same,
                     image_max_abs_diff_vs_k1=float(np.abs(img - base[1]).max()),
                     card=smi)
                assert rays == base[0] and same
    finally:
        os.environ.pop("LUPIN_SPP_STREAMS", None)


# -- PR 8: scene files, the apps and multi-device (phases 19-24) -------------

# Scene files are written here (gitignored) and removed at the end of the phases.
SCENES_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke_scenes")
TEXTURED_LAT = 33  # the UV sphere: 2 * 32 * 66 = 4,224 triangles (BVH route)
TEXTURED_SIZE = 256  # the textured renders' width and height
B3_SITE = "lupinpathtracer_tpu/kernels/pallas_mega.py:622"


def _scene_cpu_equal(a, b, uv_atol):
    """Meshes, instances, materials, environments of two SceneCPUs equal
    (texcoords within uv_atol); returns the largest texcoord difference."""

    uv_err = 0.0
    assert len(a.meshes) == len(b.meshes) and len(a.instances) == len(b.instances)
    for ma, mb in zip(a.meshes, b.meshes):
        assert np.array_equal(ma.positions, mb.positions)
        assert np.array_equal(np.asarray(ma.indices, np.int64),
                              np.asarray(mb.indices, np.int64))
        for f in ("normals", "colors", "texcoords"):
            x, y = getattr(ma, f), getattr(mb, f)
            assert (x is None) == (y is None), f
            if x is None:
                continue
            if f == "texcoords":
                uv_err = max(uv_err, float(np.abs(x - y).max()))
                assert uv_err <= uv_atol, uv_err
            else:
                assert np.array_equal(x, y), f
    for ia, ib in zip(a.instances, b.instances):
        assert np.array_equal(ia.frame, ib.frame)
        assert (ia.mesh_idx, ia.mat_idx) == (ib.mesh_idx, ib.mat_idx)
    for xa, xb in zip(a.materials, b.materials):
        for f in xa.__dataclass_fields__:
            assert np.array_equal(np.asarray(getattr(xa, f)),
                                  np.asarray(getattr(xb, f))), f
    for ea, eb in zip(a.environments, b.environments):
        assert np.array_equal(ea.transform, eb.transform)
        assert np.array_equal(ea.emission, eb.emission)
    return uv_err


def files_terrain_phase(dev, smi, terrain, ts, cams, counters):
    """Phase 19: terrain2M written as a Yocto scene with one ~60 MB PLY
    (tools/scene_files.py), rendered by the CLI (apps/render_cli.py, on
    the card) at the BVH main path's settings, 2 accumulations, .exr out.
    The loaded scene equals the in-memory one (texcoords within 6e-8); the
    EXR equals the in-memory render_progressive of the same scene, rounded
    to half, on >= 99.9% of pixels, none off by more than one half ulp."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.apps import render_cli
    from lupinpathtracer_tpu_torch.io import exr, yocto_json
    from lupinpathtracer_tpu_torch.kernels import bvh, packet, walk
    from lupinpathtracer_tpu_torch.tools import scene_files

    (w, h), spp, nb = API["bvh_wh"], API["bvh_spp"], API["bounces"]
    t0 = time.perf_counter()
    path = scene_files.write_scene_dir(SCENES_DIR, "terrain2M", terrain, cams)
    write_s = time.perf_counter() - t0
    ply_mb = os.path.getsize(os.path.join(SCENES_DIR, "terrain2M", "shapes",
                                          "shape0.ply")) / 1e6
    out = os.path.join(SCENES_DIR, "terrain2M.exr")
    reset(*counters)
    times = render_cli.main([path, "--width", str(w), "--height", str(h), "--spp",
                             str(spp), "--bounces", str(nb), "--max-radiance", "10",
                             "--accums", "2", "--out", out])
    launches = {**packet.LAUNCHES, **bvh.LAUNCHES, **walk.LAUNCHES}
    t0 = time.perf_counter()
    loaded, lcams = yocto_json.load_scene_yoctogl_v24(path)
    parse_s = time.perf_counter() - t0
    uv_err = _scene_cpu_equal(terrain, loaded, 6e-8)
    assert all(np.array_equal(a.transform, b.transform) for a, b in zip(cams, lcams))
    desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
    ref = lt.render_progressive(ts, desc, lt.BakedPathtraceParams(
        max_bounces=nb, samples_per_pixel=spp), w, h, 2, device=dev)
    half = ref.astype(np.float16)
    got = exr.read_exr(out)[..., :3]
    ulp = np.spacing(np.abs(half)).astype(np.float32)
    diff = np.abs(got - half.astype(np.float32))
    equal_share = float((diff == 0).mean())
    emit("files_terrain", tris=ts.num_world_tris, ply_mb=ply_mb, write_s=write_s,
         cli_load_s=times["load_s"], load_again_s=parse_s,
         build_scene_torch_s=times["build_s"],
         s_per_accumulation=times["render_s"] / 2, launches=launches,
         texcoord_max_abs_diff=uv_err, exr_equal_share=equal_share,
         exr_max_diff_in_half_ulps=float((diff / ulp).max()),
         image_mean=float(got.mean()), card=smi)
    assert all(launches[k] > 0 for k in bvh_route_kernels(ts)), launches
    assert equal_share >= 0.999 and bool((diff <= ulp).all())


def files_textured_phase(dev, smi, counters):
    """Phase 20: textures and an environment from files. The Cornell walls,
    a quad with a 256² color texture (alpha < 1 on part of it), a normal
    map and an emission texture (PNG: the packed RGBA8 atlas), a 512x256
    .hdr environment through emission_tex; and a variant with a UV sphere
    of 4,224 triangles with the normal-mapped material (the BVH route: B4's
    and B7's tangent rows). Both at 256², 4 spp, 8 bounces under STANDARD
    and MIS (1 warm-up, 1 timed accumulation), and ALBEDO and NORMALS
    dispatches; a 32x32 tile over the alpha region dispatched on the card
    against the same tile dispatched on CPU tensors (the same batch: the
    alpha skip couples the lanes of a batch), >= 99% of pixels within 1e-4.
    Every B2 launch of one dense accumulation and every B4 and B7 launch
    of one BVH accumulation replayed against its plain version. Returns
    the kernel entries."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.io import yocto_json
    from lupinpathtracer_tpu_torch.kernels import bvh, mega, packet
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.tools import scene_files
    from lupinpathtracer_tpu_torch.tools.replay import one_accumulation

    size, spp, nb = TEXTURED_SIZE, 4, API["bounces"]
    k_tile, tx, ty = 27, 96, 96  # tile (3, 3): about half its pixels see alpha
    baked = lt.BakedPathtraceParams(max_bounces=nb, samples_per_pixel=spp)
    kernels = []
    for tag, lat in (("textured_dense", 0), ("textured_bvh", TEXTURED_LAT)):
        t0 = time.perf_counter()
        path = scene_files.write_scene_dir(SCENES_DIR, tag, *scene_files.textured_cornell(
            tex_size=256, env_wh=(512, 256), sphere_lat=lat))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene, cams = yocto_json.load_scene_yoctogl_v24(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ts = lt.build_scene_torch(scene, device=dev)
        build_s = time.perf_counter() - t0
        cpu = ts.to("cpu")
        assert ts.mat_tex_ldr and ts.env_has_tex and ts.any_normal_maps and ts.has_alpha
        assert ts.use_bvh == (lat > 0) and not mega.applicable(ts, 0)
        emit("files_textured_scene", scene=tag, tris=ts.num_world_tris,
             textures=len(scene.textures), write_s=write_s, load_s=load_s,
             build_scene_torch_s=build_s, packed_rgba8_atlas=bool(ts.mat_tex_ldr),
             textures_png=[t["uri"] for t in json.load(open(path))["textures"]],
             card=smi)
        for what in ("STANDARD", "MIS", "ALBEDO", "NORMALS"):
            pt = (lt.PathtraceType[what] if what in ("STANDARD", "MIS")
                  else lt.PathtraceType.STANDARD)
            desc = cornell_desc(lt, cams, pt, max_radiance=10.0)

            def dispatch(sc, d, device, what=what):
                buf = lt.new_accumulation_buffer(size, size, device=device)
                if what in ("STANDARD", "MIS"):
                    return lt.pathtrace_scene(sc, buf, d, baked)
                return lt.pathtrace_scene_falsecolor(
                    sc, buf, d, lt.BakedPathtraceParams(samples_per_pixel=1),
                    lt.FalsecolorType[what])

            if what in ("STANDARD", "MIS"):
                warm_s, wall, rays, img = timed_render(ts, desc, baked, size, size, 1,
                                                       counters, dev)
                ms = wall * 1e3
            else:
                dispatch(ts, desc, dev)
                reset(*counters)
                ms, img = dispatch_ms(lambda: dispatch(ts, desc, dev))
                img = img.cpu().numpy()
                warm_s, rays = None, None
            launches = {**dk.LAUNCHES, **mega.LAUNCHES, **packet.LAUNCHES, **bvh.LAUNCHES}
            if what == "STANDARD":
                main_launches = launches  # the main path's run, for the kernels line
            desc_t = cornell_desc(lt, cams, pt, max_radiance=10.0)
            desc_t.tile_params = lt.TileParams(enabled=True, tile_idx=k_tile, tile_size=32)
            desc_t.accum_params.accumulate = True
            k = dispatch(ts, desc_t, dev)[ty:ty + 32, tx:tx + 32].cpu()
            t0 = time.perf_counter()
            p = dispatch(cpu, desc_t, "cpu")[ty:ty + 32, tx:tx + 32]
            cpu_s = time.perf_counter() - t0
            diff = (k - p).abs().amax(-1)
            share = float((diff <= 1e-4).float().mean())
            emit("files_textured", scene=tag, dispatch=what, width=size, height=size,
                 spp=spp if what in ("STANDARD", "MIS") else 1, bounces=nb,
                 ms=ms, warmup_s=warm_s, rays=rays,
                 mrays_per_s=rays / ms * 1e-3 if rays else None, launches=launches,
                 image_mean=float(img.mean()), tile_max_abs_diff_vs_cpu=float(diff.max()),
                 tile_atol=1e-4, tile_share_within_atol=share, tile_cpu_s=cpu_s,
                 card=smi)
            assert np.isfinite(img).all() and img.mean() > 0 and share >= 0.99
            assert launches["mega_pathtrace_spp"] == 0
            if lat:
                assert launches["packet_traverse"] > 0, launches
            else:
                assert launches["dense_closest_hit_attrs"] > 0, launches
        desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
        run = one_accumulation(ts, desc, size, size, REPLAY_SPP, nb)
        launches = main_launches
        path_name = f"files_textured {tag} STANDARD"
        if not lat:
            kernels.append(entry(
                "B2 dense_closest_hit_attrs (textured dense from files, mean per launch)",
                "dense_intersect.cu", B2_SITE, launches["dense_closest_hit_attrs"],
                *emit_b2_launches(ts, desc, smi, size, size, REPLAY_SPP, nb,
                                  what="STANDARD", tag=tag),
                launches_in=path_name))
            continue
        kernels += [
            entry("B4 packet_traverse (textured BVH from files, tangent rows, mean per "
                  "launch)",
                  "packet.cu", B4_SITE, launches["packet_traverse"],
                  *emit_b4_launches(ts, run, tag, smi, "STANDARD"),
                  launches_in=path_name),
            entry("B7 attr_fetch (textured BVH from files, tangent rows, mean per "
                  "launch)", "bvh.cu", B7_SITE, launches["attr_fetch"],
                  *emit_b7_launches(ts, desc, size, size, REPLAY_SPP, nb, tag, smi),
                  launches_in=path_name),
        ]
        del cpu
    return kernels


def golden_files_phase(dev, smi, counters):
    """Phase 21: apps/golden_test.py on the card, on the Cornell box written
    as a scene dir whose render_cam0.hdr is tests/goldens/cornell_32_standard
    .npy (io/hdr.py): 80 samples (8 accumulations of 10 spp) under the
    reference's gate (max RGB distance <= 5.0); again with --ckpt (the tiled
    path, which writes a checkpoint), and a third time, which resumes at the
    last accumulation. B3 runs on a scene that came from files."""

    import contextlib
    import io as io_mod

    from lupinpathtracer_tpu_torch.apps import golden_test
    from lupinpathtracer_tpu_torch.io import builtin, hdr
    from lupinpathtracer_tpu_torch.kernels import mega
    from lupinpathtracer_tpu_torch.tools import scene_files

    root = os.path.join(SCENES_DIR, "golden")
    scene_files.write_scene_dir(root, "cornell", *builtin.build_scene_cornell_box())
    hdr.write_hdr(os.path.join(root, "cornell", "render_cam0.hdr"), np.load(GOLDEN))
    base = ["--scenes", root, "--scene", "cornell", "--samples", "80",
            "--out_dir", os.path.join(SCENES_DIR, "golden_out")]
    for run, extra in (("untiled", []), ("ckpt", ["--ckpt"]), ("resume", ["--ckpt"])):
        reset(*counters)
        text = io_mod.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            (res,) = golden_test.main(base + extra)
        wall = time.perf_counter() - t0
        lines = text.getvalue()
        resumed = "resumed at accum 8/8" in lines
        emit("golden_files", run=run, max_dist=res[3], ds4_rmse=res[4], ok=res[2],
             epsilon=golden_test.EPSILON, wall_s=wall, resumed_at_last=resumed,
             checkpoint_written="ckpt @ accum 8/8" in lines,
             b3_launches=mega.LAUNCHES["mega_pathtrace_spp"], card=smi)
        assert res[2] is True and res[3] <= golden_test.EPSILON
        assert (mega.LAUNCHES["mega_pathtrace_spp"] > 0) == (run != "resume")
        if run == "ckpt":
            assert "ckpt @ accum 8/8" in lines and not resumed
        assert resumed == (run == "resume"), lines


def check_kernels_phase(smi):
    """Phase 22: apps/check_kernels.main() on the card, every check OK."""

    import contextlib
    import io as io_mod

    from lupinpathtracer_tpu_torch.apps import check_kernels

    text = io_mod.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        check_kernels.main()
    lines = [ln.strip() for ln in text.getvalue().splitlines() if ln.strip()]
    emit("check_kernels", wall_s=time.perf_counter() - t0,
         ok=[ln for ln in lines if ln.startswith("OK")],
         failed=[ln for ln in lines if ln.startswith("FAIL")], card=smi)
    assert lines[-1] == "all kernel checks passed", lines


def sharding_phase(dev, smi, scene_c, cams_c, terrain_ts, terrain_cams, counters):
    """Phase 23: parallel/sharding.py on meshes of 1, 2 and 4 entries of the
    one card (entries time-share it): tiles mode on the Cornell box (B3)
    and terrain2M at 512x288, 4 spp, 8 bounces, 1 accumulation, the images
    identical across mesh sizes; samples mode on the Cornell box at n = 2
    (B3 with sample_offset = i * spp); then B3 alone with sample_offset = 8
    against its plain version at 64², 8 spp (B3's tolerance). Returns B3's
    kernel entry for that mode."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, mega, packet, walk
    from lupinpathtracer_tpu_torch.parallel import sharding
    from lupinpathtracer_tpu_torch.render import integrators
    from lupinpathtracer_tpu_torch.render.renderer import _camera_args, _pixel_batch

    (w, h), spp, nb = API["bvh_wh"], API["bvh_spp"], API["bounces"]
    baked = lt.BakedPathtraceParams(max_bounces=nb, samples_per_pixel=spp)
    for tag, ts, cams, maxr in (("cornell", scene_c, cams_c, 100.0),
                                ("terrain2M", terrain_ts, terrain_cams, 10.0)):
        desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=maxr)
        images = {}
        for n in (1, 2, 4):
            mesh = sharding.make_tile_mesh(n, [dev])
            reset(*counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images[n] = sharding.render_progressive_sharded(ts, desc, baked, w, h, 1,
                                                            mesh=mesh)
            wall = time.perf_counter() - t0
            emit("sharding", scene=tag, mode="tiles", entries=n, device=str(dev),
                 width=w, height=h, spp=spp, bounces=nb, accumulations=1,
                 wall_s=wall, time_shared_on_one_card=True,
                 launches={**mega.LAUNCHES, **packet.LAUNCHES, **bvh.LAUNCHES},
                 identical_to_1=bool(np.array_equal(images[n], images[1])),
                 image_mean=float(images[n].mean()), card=smi)
            assert np.array_equal(images[n], images[1]) and images[n].mean() > 0
            if tag == "cornell":
                assert mega.LAUNCHES["mega_pathtrace_spp"] == n
            else:
                assert walk.LAUNCHES["walk"] > 0
    desc = cornell_desc(lt, cams_c, lt.PathtraceType.STANDARD)
    reset(*counters)
    t0 = time.perf_counter()
    img = sharding.render_progressive_sharded(scene_c, desc, baked, w, h, 1,
                                              mesh=sharding.make_tile_mesh(2, [dev]),
                                              mode="samples")
    wall = time.perf_counter() - t0
    launches_b3 = mega.LAUNCHES["mega_pathtrace_spp"]
    emit("sharding", scene="cornell", mode="samples", entries=2, device=str(dev),
         width=w, height=h, spp=spp, bounces=nb, accumulations=1, wall_s=wall,
         time_shared_on_one_card=True, launches=dict(mega.LAUNCHES),
         image_mean=float(img.mean()), card=smi)
    assert launches_b3 == 2 and np.isfinite(img).all() and img.mean() > 0

    eps = float(np.float32(1e-3))
    W = intersect.scene_tri_matrix(scene_c)
    gx, gy = _pixel_batch(64, 64, 0, 0, dev)
    off = 8
    args = (gy * 64 + gx, gx, gy, (64.0, 64.0), _camera_args(desc), False, 0, 0, 8,
            int(lt.PathtraceType.STANDARD), nb, 100.0)
    t_k, (acc_k, nt_k), by = kernel_ms(
        lambda: mega.mega_pathtrace_spp(scene_c, W, *args, eps, sample_offset=off),
        "mega_kernel", 5)
    ctx = integrators.make_ctx(scene_c, eps)
    p_ms, (acc_p, nt_p) = cuda_ms(
        lambda: integrators.pathtrace_spp(scene_c, ctx, *args, sample_offset=off), 1)
    res = compare_paths(acc_k, nt_k, acc_p, nt_p)
    acc_0, _ = mega.mega_pathtrace_spp(scene_c, W, *args, eps)
    emit("b3_sample_offset_vs_plain", pixels=4096, spp=8, sample_offset=off,
         bounces=nb, differs_from_offset_0=not bool(torch.equal(acc_0.x, acc_k.x)),
         card=smi, **res)
    assert not torch.equal(acc_0.x, acc_k.x)
    T, Tl, B = scene_c.num_world_tris, scene_c.lt_v0.shape[1], 4096
    bnd = bound_ms(int(nt_k.sum()) * (T * PAIR_OPS + Tl * 60), B * 12 + B * 16 + T * 416)
    return [entry("B3 mega_pathtrace_spp (sample_offset 8, 64², 8 spp)", "mega.cu",
                  B3_SITE, launches_b3, res["acc_max_abs_err"], t_k, p_ms, bnd, by,
                  launches_in="sharding samples mode, 2 entries")]


def viewer_phase(smi):
    """Phase 24: apps/viewer.py on the card: a 2-frame orbit of the Cornell
    box at 128 px, 4 accumulations, --denoise --preview-normals (PNG)."""

    from lupinpathtracer_tpu_torch.apps import viewer

    out = os.path.join(SCENES_DIR, "frames")
    t0 = time.perf_counter()
    viewer.main(["--out", out, "--orbit", "2", "--width", "128", "--accums", "4",
                 "--denoise", "--preview-normals"])
    files = sorted(os.listdir(out))
    emit("viewer", frames=files, wall_s=time.perf_counter() - t0, card=smi)
    assert files == ["frame000.png", "frame000_preview.png", "frame001.png",
                     "frame001_preview.png"]


def file_phases(dev, smi, scene_c, cams_c, terrain, terrain_ts, terrain_cams,
                counters):
    """Phases 19-24 (scene files, the apps, multi-device); the scene files
    are written under chiprun_out/chip_smoke_scenes/ in the checkout and
    removed after. Returns the kernel entries."""

    import shutil

    shutil.rmtree(SCENES_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        files_terrain_phase(dev, smi, terrain, terrain_ts, terrain_cams, counters)
        kernels = files_textured_phase(dev, smi, counters)
        golden_files_phase(dev, smi, counters)
        check_kernels_phase(smi)
        kernels += sharding_phase(dev, smi, scene_c, cams_c, terrain_ts,
                                  terrain_cams, counters)
        viewer_phase(smi)
        emit("file_phases", seconds=time.perf_counter() - t0, card=smi)
    finally:
        shutil.rmtree(SCENES_DIR, ignore_errors=True)
    return kernels


# -- the traversal controls (phases 25-27) -------------------------------------

# The JAX package's packet gate in top rows: its VMEM budget for the
# lane-padded top tree (intersect.py:113-138), 96,000,000 B over 8 children
# x 128 lanes x 4 B a row.
JAX_GATE_ROWS = 96_000_000 // (8 * 128 * 4)  # 23,437
FIELD_ROWS = 22_912  # instanced100k's top rows (its instanced_build line)
HD = (1920, 1080)


def with_env(env: dict, fn):
    """fn() with the variables in `env` set, each removed after."""

    os.environ.update(env)
    try:
        return fn()
    finally:
        for k in env:
            os.environ.pop(k, None)


def with_attr(obj, name: str, value, fn):
    """fn() with obj.name set to `value`, restored after."""

    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        return fn()
    finally:
        setattr(obj, name, old)


def packet_gate_phase(dev, smi, counters, width=512, height=288):
    """Phase 25, packet_gate_field: the smallest instanced field (a multiple
    of 5,000 instances of 64-triangle meshes, one mesh superleaf each)
    whose top tree has more than JAX_GATE_ROWS rows, which the JAX package
    sends to its sort wavefront. Its camera batch through B4 (the port has
    no TPU budget) and, under LUPIN_NO_PACKET, through the wavefront: t
    equal on every lane, the winner except at exact-t ties; B4 against its
    plain version, bit for bit, with its bound. Returns B4's kernel
    entry."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.io import synthetic
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, packet
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.scene import flatten
    from lupinpathtracer_tpu_torch.tools import prof_pair

    # Reckoned from instanced100k (rows about linear in the instances),
    # then the next multiples of 5,000 until the built tree passes the
    # budget: its fill is not monotone in the instance count.
    n = -(-JAX_GATE_ROWS * FIELD_INSTANCES // (FIELD_ROWS * 5000)) * 5000
    tried = []
    t0 = time.perf_counter()
    while True:
        field, cams = synthetic.build_scene_instanced_field(
            n_instances=n, seed=0, tris_per_mesh=64)
        arrays, statics = flatten.flatten_numpy(field)
        rows = int(arrays["top_tab"].shape[0])
        tried.append([n, rows])
        if rows > JAX_GATE_ROWS:
            break
        n += 5000
        assert n + 2 <= intersect.PACKET_MAX_GSL, tried
    search_s = time.perf_counter() - t0
    ts = flatten.scene_from_numpy(arrays, statics, dev)
    del field, arrays
    eligible = intersect.packet_eligible(ts)
    assert ts.two_level and ts.sl_count <= intersect.PACKET_MAX_GSL and eligible

    eps = float(np.float32(lt.PathtraceDesc().advanced.ray_epsilon))
    W = intersect.scene_tri_matrix(ts)
    ro, rd = prof_pair.camera_rays(cams[0], width, height, dev)
    B = ro.x.shape[0]

    def hit_b4():
        return intersect.closest_hit(ts, ro, rd, eps, W=W)

    def hit_wf():
        return with_env({"LUPIN_NO_PACKET": "1"}, hit_b4)

    hit_b4(), hit_wf()  # warm-up
    reset(*counters)
    ms_b4, h4 = dispatch_ms(hit_b4)
    l_b4 = {**packet.LAUNCHES, **bvh.LAUNCHES}
    reset(*counters)
    ms_wf, hw = dispatch_ms(hit_wf)
    l_wf = {**packet.LAUNCHES, **bvh.LAUNCHES}
    assert l_b4["packet_traverse"] == 1 and l_b4["top_traverse"] == 0, l_b4
    assert l_wf["packet_traverse"] == 0 and l_wf["top_traverse"] > 0, l_wf
    t_equal = bool(torch.equal(h4.dst, hw.dst)) and bool(torch.equal(h4.hit, hw.hit))
    ties = int(((h4.tri != hw.tri) & h4.hit).sum())

    t_k, k4, by4 = kernel_ms(lambda: packet.packet_traverse(ts, ro, rd, eps, W),
                             "packet_kernel", 5)
    work4: dict = {}
    p_ms, p4 = plain_ms(lambda: packet.packet_traverse_plain(
        ts, ro, rd, eps, W, counts=work4))
    res = compare_hits(k4, p4, dk.F32_MAX)
    assert_equal(k4, p4, "B4 on the gate field")
    bnd = b4_bound(work4, B, B * 20, rows, ts.sl_sub.numel(),
                   extra_ops=work4["leaf_visits"] * LEAF_FRAME_OPS,
                   extra_bytes=work4["leaf_visits"] * 64)
    emit("packet_gate_field", instances=n, search=tried, search_s=search_s,
         top_rows=rows, jax_gate_rows=JAX_GATE_ROWS, sl_count=ts.sl_count,
         top_depth=ts.top_depth, packet_eligible=eligible, rays=B,
         hits=int(h4.hit.sum()), b4_route_ms=ms_b4, wavefront_route_ms=ms_wf,
         launches_b4_route=l_b4, launches_wavefront_route=l_wf,
         t_equal_every_lane=t_equal, winner_differs_at_exact_t_ties=ties,
         b4_ms=t_k, b4_plain_ms=p_ms, b4_bound_ms=bnd[0], b4_bound_by=bnd[1],
         b4_share_of_bound=bnd[0] / t_k, lane_share=work4["lane_share"],
         timed_by=by4, bit_for_bit=True, card=smi)
    assert t_equal and ties <= 1e-4 * B
    del ts, W
    torch.cuda.empty_cache()
    return [entry(f"B4 packet_traverse (two-level; gate field, {n} instances, "
                  f"{rows} top rows)", "packet.cu", B4_SITE, l_b4["packet_traverse"],
                  res["max_abs_err"], t_k, p_ms, bnd, by4,
                  launches_in="packet_gate_field camera batch")]


def dispatch_1080p_phase(dev, smi, ts, cams, counters, spp=1, bounces=8):
    """Phase 26, dispatch_1080p: terrain2M, STANDARD, 1920x1080 x 1 spp x
    8 bounces, one accumulation, by default (the working-set self-bound:
    one dispatch) and with renderer.DISPATCH_MEMORY_SHARE cut to twice one
    256² tile's working set (256² tiles); per run the dispatches,
    wall, segments, Mrays/s, kernel launches, PyTorch launches (one
    profiled accumulation) and the peak of allocated memory above the
    allocation before the run, against dispatch_bytes_per_lane x lanes.
    The images must be identical (every path's random stream keys on its
    pixel, and each kernel's result on a lane does not depend on the other
    lanes of its batch)."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, packet
    from lupinpathtracer_tpu_torch.render import integrators, renderer

    w, h = HD
    desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
    baked = lt.BakedPathtraceParams(max_bounces=bounces, samples_per_pixel=spp)
    per_lane = renderer.dispatch_bytes_per_lane(ts, baked, int(desc.pathtrace_type))
    reckoned = per_lane * w * h
    mem = renderer.device_memory_bytes(dev)
    out = {}
    for run, share in (("default", renderer.DISPATCH_MEMORY_SHARE),
                       ("tiles_256", 2 * 256 * 256 * per_lane / mem)):
        def render(stats=None):
            return lt.render_progressive(ts, desc, baked, w, h, 1, device=dev,
                                         stats=stats)

        def with_share(fn):
            return with_attr(renderer, "DISPATCH_MEMORY_SHARE", share, fn)

        tiles = with_share(lambda: renderer.dispatch_tiles(
            ts, (h, w), baked, int(desc.pathtrace_type), dev))
        calls = []
        real = renderer._render_pathtrace
        renderer._render_pathtrace = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            stats: dict = {}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset(*counters)
            t0 = time.perf_counter()
            img = with_share(lambda: render(stats))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) - base
            launches = {**packet.LAUNCHES, **bvh.LAUNCHES}
            syncs = {**intersect.HOST_SYNCS, **integrators.HOST_SYNCS}
            dispatches = len(calls)
        finally:
            renderer._render_pathtrace = real
        prof = with_share(lambda: device_profile(render))
        out[run] = img
        emit("dispatch_1080p", run=run, width=w, height=h, spp=spp, bounces=bounces,
             integrator="STANDARD", memory_share=share, tile=tiles,
             dispatches=dispatches, wall_s=wall,
             rays=stats["rays"], mrays_per_s=stats["rays"] / wall / 1e6,
             launches=launches, host_syncs=syncs,
             torch_launches_by_group=prof["kernels_by_group"],
             torch_launches=sum(prof["kernels_by_group"].values()),
             device_busy_ms=prof["device_busy_ms"],
             device_busy_share_of_wall=prof["device_busy_ms"] * 1e-3 / wall,
             bytes_per_lane=per_lane, reckoned_gb=reckoned / 1e9,
             peak_allocated_above_start_gb=peak / 1e9,
             allocated_at_start_gb=base / 1e9, device_memory_gb=mem / 1e9,
             peak_within_reckoning=peak <= reckoned, card=smi)
        assert peak <= reckoned and base + peak < mem / 2, (peak, reckoned, base)
        n_tiles = 1 if tiles is None else np.prod(lt.get_num_tiles(w, h, tiles))
        assert dispatches == n_tiles and tiles == (256 if run == "tiles_256" else None)
        assert np.isfinite(img).all() and img.mean() > 0
    diff = np.any(out["default"] != out["tiles_256"], axis=-1)
    emit("dispatch_1080p_images", identical=not diff.any(),
         pixels_differing=int(diff.sum()),
         max_abs_diff=float(np.abs(out["default"] - out["tiles_256"]).max()), card=smi)
    assert diff.mean() <= 1e-4


def b4_replay(ts, rec_args, smi, reps=3):
    """One recorded B4 launch, equal to the plain version bit for bit: the
    kernel's ms, the plain ms, the bound, the lane share of the batch's
    packets, and the lanes whose winner differs from the sort wavefront's
    on the same rays (exact-t ties)."""

    from lupinpathtracer_tpu_torch.kernels import intersect, packet
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk

    a, kw = rec_args
    scene, ro, rd, eps, W = a
    act = kw.get("active")
    B = ro.x.shape[0]
    ms, k, by = kernel_ms(lambda: packet.packet_traverse(*a, **kw),
                          "packet_kernel", reps)
    work: dict = {}
    p_ms, p = plain_ms(lambda: packet.packet_traverse_plain(*a, **kw, counts=work))
    assert_equal(k, p, "B4 replay")
    hits = int((p[0] < dk.F32_MAX).sum())
    rows = scene.top_tab.shape[0]
    if scene.two_level:
        bnd = b4_bound(work, B, B * 20, rows, scene.sl_sub.numel(),
                       extra_ops=work["leaf_visits"] * LEAF_FRAME_OPS,
                       extra_bytes=work["leaf_visits"] * 64)
    else:
        awout = p[5].shape[0] if len(p) > 5 else 0
        bnd = b4_bound(work, B, B * (20 + awout * 4)
                       + (hits * attr_row_bytes(bool(scene.any_normal_maps)) if awout else 0),
                       rows, scene.sl_sub.numel())
    hw = with_env({"LUPIN_NO_PACKET": "1"}, lambda: intersect.closest_hit_wavefront(
        scene, ro, rd, eps, W=W, active=act, coherent=False))
    both = hw.hit & (p[0] < dk.F32_MAX)
    return dict(rays=B, active=B if act is None else int(act.sum()), hits=hits,
                ms=ms, plain_ms=p_ms, bound_ms=bnd[0], bound_by=bnd[1],
                lane_share=work["lane_share"],
                t_equal_wavefront=bool(torch.equal(hw.dst, p[0])),
                winner_differs_from_wavefront=int(((hw.tri != p[4]) & both).sum()),
                timed_by=by, bit_for_bit=True)


# packet_bounce's depth cut: instanced100k at 1 spp keeps the three control
# phases near 120 s (PERF.md section 4).
BOUNCE_SPP = {"instanced100k": 1}


def packet_bounce_phase(dev, smi, bvh_scenes, counters):
    """Phase 27, packet_bounce: both BVH main paths (512x288 x 4 spp x 8
    bounces, STANDARD; instanced100k at BOUNCE_SPP's 1 spp; 1 warm-up + 1
    timed and 1 profiled accumulation)
    on two routes: the default (B4 on camera rays; on bounces the BVH walk
    on terrain2M, the sort wavefront on instanced100k) and
    LUPIN_FORCE_PACKET=1 (B4 on every batch). Per route the
    wall, Mrays/s, launches, syncs, device busy share and B4's mean device
    ms per launch in the profiled accumulation; the forced image against
    the default's (the segments within 0.1%, >= 99.9% of pixels within
    1e-4 relative). Then B4's first and last live bounce launch of a 1-spp
    forced accumulation (REPLAY_SPP) replayed against the plain version
    (b4_replay), and the camera batch's lane share. Returns B4's
    bounce-batch kernel entries."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, packet
    from lupinpathtracer_tpu_torch.render import integrators
    from lupinpathtracer_tpu_torch.tools import replay

    (w, h), nb = API["bvh_wh"], API["bounces"]
    force = {"LUPIN_FORCE_PACKET": "1"}
    routes = (("default", {}), ("force_packet", force))
    kernels = []
    for tag, (ts, cams) in bvh_scenes.items():
        spp = BOUNCE_SPP.get(tag, API["bvh_spp"])
        baked = lt.BakedPathtraceParams(max_bounces=nb, samples_per_pixel=spp)
        desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
        base = None
        b4_launches = {}
        for route, env in routes:
            warm_s, wall, rays, img = with_env(env, lambda: timed_render(
                ts, desc, baked, w, h, 1, counters, dev))
            launches = {**packet.LAUNCHES, **bvh.LAUNCHES}
            b4_launches[route] = launches["packet_traverse"]
            syncs = {**intersect.HOST_SYNCS, **integrators.HOST_SYNCS}
            prof = with_env(env, lambda: device_profile(lambda: lt.render_progressive(
                ts, desc, baked, w, h, 1, device=dev)))
            n_b4 = prof["kernels_by_group"].get("B4", 0)
            other = {g: c for g, c in prof["kernels_by_group"].items()
                     if g not in dict(KERNEL_GROUPS)}
            if base is None:
                base = (rays, img)
            rel = np.abs(img - base[1]) <= 1e-4 * np.abs(base[1])
            within = float(np.all(rel, axis=-1).mean())
            emit("packet_bounce", scene=tag, route=route, env=env, width=w, height=h,
                 spp=spp, bounces=nb, warmup_s=warm_s, s_per_accumulation=wall,
                 rays=rays, mrays_per_s=rays / wall / 1e6, launches=launches,
                 other_torch_launches=other,
                 other_torch_launches_total=sum(other.values()), host_syncs=syncs,
                 device_busy_ms=prof["device_busy_ms"],
                 device_busy_share_of_wall=prof["device_busy_ms"] * 1e-3 / wall,
                 device_ms_by_group=prof["device_ms_by_group"],
                 b4_mean_ms_per_launch_profiled=(
                     prof["device_ms_by_group"].get("B4", 0.0) / n_b4 if n_b4 else None),
                 rays_rel_diff_vs_default=abs(rays - base[0]) / base[0],
                 pixels_within_rel_1e4_of_default=within,
                 image_max_abs_diff_vs_default=float(np.abs(img - base[1]).max()),
                 card=smi)
            assert abs(rays - base[0]) <= 1e-3 * base[0] and within >= 0.999
            assert np.isfinite(img).all() and img.mean() > 0
            if route != "default":
                assert launches["packet_traverse"] > 1, launches

        # B4's launches of a 1-spp forced accumulation: the camera batch,
        # then one per bounce.
        rec = with_env(force, lambda: replay.record_launches(
            packet, "packet_traverse",
            replay.one_accumulation(ts, desc, w, h, REPLAY_SPP, nb), share=(0, 4)))
        cam = rec[0]
        cam_work: dict = {}
        packet.packet_traverse_plain(*cam[0], **cam[1], counts=cam_work)
        # The last launch with a live lane: the loop's final launch may hold
        # none (every path ended).
        last = max(i for i, (_, k) in enumerate(rec)
                   if k.get("active") is None or bool(k["active"].any()))
        reps = {}
        for which, i in (("first_bounce", 1), ("last_live_bounce", last)):
            reps[which] = b4_replay(ts, rec[i], smi)
            emit("packet_bounce_b4_replay", scene=tag, launch=which, index=i,
                 launches_recorded=len(rec), card=smi, **reps[which])
        emit("packet_bounce_camera_lane_share", scene=tag,
             lane_share=cam_work["lane_share"], card=smi)
        rs = list(reps.values())
        ms = sum(r["ms"] for r in rs) / len(rs)
        bnd = (sum(r["bound_ms"] for r in rs) / len(rs), rs[0]["bound_by"])
        p_ms = sum(r["plain_ms"] for r in rs) / len(rs)
        by = "device_records" if all(r["timed_by"] == "device_records"
                                     for r in rs) else "events"
        emit("packet_bounce_b4", scene=tag, route="force_packet", mean_ms=ms,
             bound_ms=bnd[0], share_of_bound=bnd[0] / ms,
             mean_lane_share=sum(r["lane_share"] for r in rs) / len(rs),
             launches_per_accumulation=b4_launches["force_packet"], card=smi)
        kernels.append(entry(
            f"B4 packet_traverse ({tag}; bounce batches; mean of the first and "
            "last live bounce launch)", "packet.cu", B4_SITE,
            b4_launches["force_packet"], 0.0, ms, p_ms, bnd, by,
            launches_in="packet_bounce force_packet"))
    return kernels


# f32 operations per ray/triangle test of each B6' variant: V1 and V3 trade
# the divide and three products for det^2, rsqrt, a product, a negation,
# three sign products and two subtractions; V5 keeps the four dot products
# and one min.
VARIANT_OPS = {"V0": PAIR_OPS, "V1": 85, "V2": PAIR_OPS, "V3": 85,
               "V4": PAIR_OPS, "V5": 77, "GRID": 0}


def prof_pair_phase(states, smi, reps=5):
    """B6 and B6': the redesigned kernel and the pair-kernel variants on the
    round-1 state of each camera batch in `states` ({name: (scene, ro, rd,
    W, eps)}), timed in turns: B6, V0-V5, GRID, B6, V0. V0 (B6's earlier
    design) and V4 must equal B6 bit for bit and each variant its plain
    version on what it returns. Returns one kernel entry for B6 and one per
    variant and state, each with the launches its counter took here."""

    from lupinpathtracer_tpu_torch.kernels import bvh
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.tools import prof_pair

    entries = []
    for name, (scene, ro, rd, W, eps) in states.items():
        args, kw, info = prof_pair.round1_state(scene, ro, rd)
        pairs, items, SP = int(info["n_real"]), int(kw["n_items"]), scene.sl_stride
        msl_used = int(torch.unique(args[1][:items]).numel())
        two_level = kw["inst"] is not None
        reset(bvh.LAUNCHES)
        n_launch = {}

        def variant_ms(v):
            before = bvh.LAUNCHES["pair_intersect_variant"]
            res = kernel_ms(lambda: prof_pair.run_variant(v, args, W, eps, kw),
                            "pair_kernel", reps)
            n_launch[v] = n_launch.get(v, 0) + bvh.LAUNCHES["pair_intersect_variant"] - before
            return res

        b6_ms = [kernel_ms(lambda: bvh.pair_intersect(*args, W, eps, **kw),
                           "pair_hit_kernel", reps)]
        timed = {v: variant_ms(v) for v in prof_pair.VARIANTS}
        b6_ms.append(kernel_ms(lambda: bvh.pair_intersect(*args, W, eps, **kw),
                               "pair_hit_kernel", reps))
        v0_again = variant_ms("V0")
        b6 = b6_ms[-1][1]
        b6_launches = bvh.LAUNCHES["pair_intersect"]
        p_ms, p = plain_ms(lambda: bvh.pair_intersect_plain(*args, W, eps, **kw))
        assert all(bool(torch.equal(a, b)) for a, b in zip(b6, p))
        bytes6 = items * (20 if two_level else 16) + pairs * (24 + 20) + msl_used * SP * 160
        ops6 = pairs * SP * PAIR_OPS + (pairs * XFORM_OPS if two_level else 0)
        b6_by = [x[2] for x in b6_ms]
        entries.append(entry(
            f"B6 pair_intersect ({name} round 1)", "pair_intersect.cuh",
            "lupinpathtracer_tpu/kernels/pallas_bvh.py:665", b6_launches,
            max(float((a - b).abs().max()) for a, b in zip(b6[:4], p[:4])),
            sum(x[0] for x in b6_ms) / 2, p_ms, bound_ms(ops6, bytes6),
            "device_records" if all(b == "device_records" for b in b6_by) else "events",
            launches_in="round-1 timing"))
        report = {}
        for variant, (ms, k, by) in timed.items():
            pargs = args if variant != "GRID" else (*args[:3], args[2], *args[4:])
            p_ms, p = plain_ms(lambda: bvh.pair_intersect_plain(
                *pargs, W, eps, variant="V0" if variant == "GRID" else variant,
                **kw))
            # The error is read from the outputs (t, u, v, det).
            if variant in ("V1", "V3"):
                err = compare_hits(k, p, dk.F32_MAX)["max_abs_err"]
            else:
                err = max(float((a - b).abs().max()) for a, b in zip(k[:4], p[:4]))
                assert all(bool(torch.equal(a, b)) for a, b in zip(k, p)), variant
            if variant in ("V0", "V4"):
                assert all(bool(torch.equal(a, b)) for a, b in zip(k, b6)), variant
            if variant == "V2":
                assert torch.equal(k[0], b6[0]) and torch.equal(k[4], b6[4])
            if variant == "GRID":
                assert bool((k[0] == dk.F32_MAX).all())
            live = variant != "GRID"
            bnd = bound_ms(pairs * SP * VARIANT_OPS[variant]
                           + (pairs * XFORM_OPS if two_level and live else 0),
                           items * (20 if two_level else 16)
                           + (pairs * (24 + 20) + msl_used * SP * 160 if live else 0))
            report[variant] = ms
            v_ms = (ms + v0_again[0]) / 2 if variant == "V0" else ms
            if variant == "V0":
                by = by if v0_again[2] == by else "events"
            entries.append(entry(
                f"B6' pair variant {variant} ({name} round 1)"
                + (": B6's earlier design" if variant == "V0" else ""),
                {"V0": "pair_kernel.cuh", "GRID": "pair_kernel.cuh"}.get(
                    variant, "pair_variants.cu"),
                "tools/prof_pair.py:276", n_launch[variant],
                err, v_ms, p_ms, bnd, by, launches_in="round-1 timing"))
        emit("prof_pair", state=name, items=items, stride=SP,
             mesh_superleaves=msl_used, reps=reps, ms=report,
             b6_ms=[x[0] for x in b6_ms], v0_ms=[timed["V0"][0], v0_again[0]],
             b6_over_v0=sum(x[0] for x in b6_ms) / (timed["V0"][0] + v0_again[0]),
             v0_equals_b6=True, card=smi,
             **pair_live_shares(args[0], args[2], args[3], kw["n_items"],
                                int(info["skey"].shape[0])))
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.core import rng as rng_mod
    from lupinpathtracer_tpu_torch.core import vec3 as v3
    from lupinpathtracer_tpu_torch.core.vec3 import V3
    from lupinpathtracer_tpu_torch.io import builtin
    from lupinpathtracer_tpu_torch.kernels import cuda_build, intersect, mega, walk
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.render import integrators
    from lupinpathtracer_tpu_torch.render.renderer import (
        _accumulate_and_store, _camera_args, _pixel_batch)
    from lupinpathtracer_tpu_torch.tools import replay

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 0. card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    report = cuda_build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: v[0] for k, v in report.items()},
         ptxas={k: [ln for ln in v[1].splitlines() if "registers" in ln or "spill" in ln]
                for k, v in report.items()})

    cornell, cams = builtin.build_scene_cornell_box()
    scene = lt.build_scene_torch(cornell, device=dev)
    eps = float(np.float32(1e-3))
    W = intersect.scene_tri_matrix(scene)
    T = scene.num_world_tris

    # -- 2. B1 / B2 against their plain versions -------------------------------
    cam = _camera_args(cornell_desc(lt, cams, lt.PathtraceType.STANDARD))
    gx, gy = _pixel_batch(512, 512, 0, 0, dev)
    st = rng_mod.init_state(gy * 512 + gx, 0, 0)
    _, ro, rd = integrators._camera_ray_from(
        dict(cam=cam, is_ortho=False, gx=gx, gy=gy, resolution=(512.0, 512.0)), st)
    rng = np.random.default_rng(0)
    n_rand = 65536
    o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n_rand, 3))
    d = rng.normal(size=(n_rand, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t = torch.tensor(o.T, dtype=torch.float32, device=dev)
    d_t = torch.tensor(d.T, dtype=torch.float32, device=dev)
    R_cam = intersect.ray_features(ro, rd)
    R_all = torch.cat([R_cam, intersect.ray_features(V3(*o_t), V3(*d_t))])
    A = scene.wt_attr[:T]
    k = dk.dense_closest_hit_attrs(W, scene.wt_attr, R_all, eps)
    p = dk.dense_closest_hit_attrs_plain(W, A, R_all, eps)
    k1 = dk.dense_closest_hit(W, R_all, eps)
    torch.cuda.synchronize()
    res = compare_hits(k, p, dk.F32_MAX)
    b1_same = all(bool(torch.equal(a, b)) for a, b in zip(k1, k[:5]))
    emit("b1_b2_vs_plain", tris=T, b1_equals_b2_hit=b1_same, bit_for_bit=True, **res)
    assert b1_same
    assert_equal(k, p, "B2")

    # -- 3. B3 against its plain version (the port's pathtrace_spp) ------------
    glossy_scene = lt.build_scene_torch(glossy_cornell(lt, builtin)[0], device=dev)
    sphere_scene = lt.build_scene_torch(replay.sphere_cornell()[0], device=dev)
    assert not sphere_scene.use_bvh and sphere_scene.num_world_tris == 556
    gx64, gy64 = _pixel_batch(64, 64, 0, 0, dev)
    pix64 = gy64 * 64 + gx64
    for name, sc in (("cornell", scene), ("cornell_glossy_gltfpbr", glossy_scene),
                     ("cornell_sphere_556_tris", sphere_scene)):
        Wsc = intersect.scene_tri_matrix(sc)
        for ptype in (lt.PathtraceType.STANDARD, lt.PathtraceType.NAIVE):
            assert mega.applicable(sc, ptype)
            args = (pix64, gx64, gy64, (64.0, 64.0), cam, False, 3, 0, 4,
                    int(ptype), 8, 10.0)
            acc_k, nt_k = mega.mega_pathtrace_spp(sc, Wsc, *args, eps)
            ctx = integrators.make_ctx(sc, eps)
            acc_p, nt_p = integrators.pathtrace_spp(sc, ctx, *args)
            torch.cuda.synchronize()
            emit("b3_vs_plain", scene=name, ptype=ptype.name, pixels=4096,
                 spp=4, bounces=8, tris=sc.num_world_tris,
                 **compare_paths(acc_k, nt_k, acc_p, nt_p))

    # -- 4. main path ----------------------------------------------------------
    # Route 1 (the Cornell box inside the megakernel gate): B3.
    for c in (dk.LAUNCHES, mega.LAUNCHES):
        for key in c:
            c[key] = 0
    desc = cornell_desc(lt, cams, lt.PathtraceType.STANDARD)
    baked = lt.BakedPathtraceParams(max_bounces=8, samples_per_pixel=64)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = lt.render_progressive(scene, desc, baked, 512, 512, 4, device=dev,
                                 stats=stats)
    wall = time.perf_counter() - t0
    launches_b3 = mega.LAUNCHES["mega_dispatch"]
    assert launches_b3 > 0 and launches_b3 == mega.LAUNCHES["mega_pathtrace_spp"]
    assert np.isfinite(img).all() and img.mean() > 0
    assert dk.LAUNCHES["dense_closest_hit_attrs"] == 0
    emit("main_path_mega", scene="cornell", width=512, height=512, bounces=8,
         spp=64, accumulations=4, wall_s=wall, rays=stats["rays"],
         mrays_per_s=stats["rays"] / wall / 1e6, image_mean=float(img.mean()),
         launches=dict(mega.LAUNCHES), card=smi)
    rays_main = stats["rays"]

    # Route 2 (dense scenes outside the gate, here the direct-lighting
    # integrator): the wavefront loop through B2.
    for key in dk.LAUNCHES:
        dk.LAUNCHES[key] = 0
    mega.LAUNCHES["mega_pathtrace_spp"] = 0
    desc_d = cornell_desc(lt, cams, lt.PathtraceType.DIRECT)
    baked_d = lt.BakedPathtraceParams(max_bounces=8, samples_per_pixel=16)
    stats_d: dict = {}
    t0 = time.perf_counter()
    img_d = lt.render_progressive(scene, desc_d, baked_d, 512, 512, 2,
                                   device=dev, stats=stats_d)
    wall_d = time.perf_counter() - t0
    launches_b2 = dk.LAUNCHES["dense_closest_hit_attrs"]
    assert launches_b2 > 0 and mega.LAUNCHES["mega_pathtrace_spp"] == 0
    assert np.isfinite(img_d).all() and img_d.mean() > 0
    emit("main_path_wavefront", scene="cornell", integrator="DIRECT", width=512,
         height=512, bounces=8, spp=16, accumulations=2, wall_s=wall_d,
         s_per_accumulation=wall_d / 2, rays=stats_d["rays"],
         mrays_per_s=stats_d["rays"] / wall_d / 1e6,
         image_mean=float(img_d.mean()), launches=dict(dk.LAUNCHES), card=smi)
    b2_replay = emit_b2_launches(scene, desc_d, smi, spp=REPLAY_SPP)

    # Route 3 (the dense closest-hit query, intersect.closest_hit, on the
    # main path's 512x512 camera rays): B1.
    dk.LAUNCHES["dense_closest_hit"] = 0
    h = intersect.closest_hit(scene, ro, rd, eps)
    torch.cuda.synchronize()
    launches_b1 = dk.LAUNCHES["dense_closest_hit"]
    assert launches_b1 > 0 and bool(h.hit.any())
    emit("closest_hit_query", rays=int(ro.x.shape[0]),
         hit_share=float(h.hit.float().mean()), launches=launches_b1)

    # -- 5. golden -------------------------------------------------------------
    golden = np.load(GOLDEN)
    desc_g = cornell_desc(lt, cams, lt.PathtraceType.STANDARD, max_radiance=10.0)
    baked_g = lt.BakedPathtraceParams(max_bounces=8, samples_per_pixel=8)
    img_g = lt.render_progressive(scene, desc_g, baked_g, 32, 32, 8, device=dev)
    within = float((np.abs(img_g - golden) <= 2e-3).mean())
    mean_rel = abs(float(img_g.mean()) - float(golden.mean())) / float(golden.mean())
    emit("golden", atol=2e-3, pixels_within_atol=within, mean_rel_diff=mean_rel,
         max_abs_diff=float(np.abs(img_g - golden).max()))
    assert within >= 0.99 and mean_rel <= 0.01

    # -- 6. kernels against their plain versions at the main path's shapes ---
    # The outputs of the timed runs are compared, so each kernel's error in
    # the kernels line comes from the shapes it is timed at.
    B = 512 * 512
    # B1: the main path's 512x512 camera rays. B2: DIRECT traces 2 rays
    # per lane, camera rays, then as many rays from inside the box
    # (tools/replay.dense_timing_rays).
    R_main, R_wf = replay.dense_timing_rays(cam, dev)
    t_b1, k, by1 = kernel_ms(lambda: dk.dense_closest_hit(W, R_main, eps),
                        "dense_hit_kernel", 20)
    p_b1, p = cuda_ms(lambda: dk.dense_closest_hit_plain(W, R_main, eps), 3)
    res_b1 = compare_hits(k, p, dk.F32_MAX)
    assert_equal(k, p, "B1 at the timing shape")
    t_b2, k, by2 = kernel_ms(
        lambda: dk.dense_closest_hit_attrs(W, scene.wt_attr, R_wf, eps),
        "dense_hit_kernel", 20)
    p_b2, p = cuda_ms(lambda: dk.dense_closest_hit_attrs_plain(W, A, R_wf, eps), 3)
    res_b2 = compare_hits(k, p, dk.F32_MAX)
    assert_equal(k, p, "B2 at the timing shape")
    # B2 where operations bound it: the same rays against the box with a
    # 520-triangle sphere (556 triangles, 139 groups: six shared-memory
    # stages), near the top of the dense gate.
    Ws = intersect.scene_tri_matrix(sphere_scene)
    Ts = Ws.shape[2]
    As = sphere_scene.wt_attr[:Ts]
    before = dk.LAUNCHES["dense_closest_hit_attrs"]
    t_b2s, k, by2s = kernel_ms(
        lambda: dk.dense_closest_hit_attrs(Ws, sphere_scene.wt_attr, R_wf, eps),
        "dense_hit_kernel", 10)
    launches_b2s = dk.LAUNCHES["dense_closest_hit_attrs"] - before
    p_b2s, p = plain_ms(lambda: dk.dense_closest_hit_attrs_plain(Ws, As, R_wf, eps))
    res_b2s = compare_hits(k, p, dk.F32_MAX)
    assert_equal(k, p, "B2 on the sphere box")
    pix = gy * 512 + gx
    b3_args = (pix, gx, gy, (512.0, 512.0), cam, False, 0, 0, 64,
               int(lt.PathtraceType.STANDARD), 8, 100.0)
    before = mega.LAUNCHES["mega_pathtrace_spp"]
    t_b3, (acc_k, nt), by3 = kernel_ms(
        lambda: mega.mega_pathtrace_spp(scene, W, *b3_args, eps),
        "mega_kernel", 3)
    launches_b3_acc = mega.LAUNCHES["mega_pathtrace_spp"] - before
    ctx = integrators.make_ctx(scene, eps)
    p_b3, (acc_p, nt_p) = cuda_ms(
        lambda: integrators.pathtrace_spp(scene, ctx, *b3_args), 1)
    res_b3 = compare_paths(acc_k, nt, acc_p, nt_p)
    # B3's dispatch mode, the main path's launch: one dispatch of the
    # progressive render at its shapes, blending into a previous image
    # (counter 3), against the plain route on the same inputs.
    prev = torch.rand((512, 512, 3), generator=torch.Generator().manual_seed(5)).to(dev)
    d_counter = 3
    t_b3d, (img_k, cnt_k), by3d = kernel_ms(
        lambda: mega.mega_dispatch(scene, prev, cam, False, (0, 0), (512, 512),
                                   d_counter, 0, 64, lt.PathtraceType.STANDARD, 8,
                                   100.0, eps, True, True),
        "mega_kernel", 3)
    cnt_k = int(cnt_k)
    d_args = (pix, gx, gy, (512.0, 512.0), cam, False, d_counter, 0, 64,
              int(lt.PathtraceType.STANDARD), 8, 100.0)

    def plain_dispatch():
        acc, n_tr = integrators.pathtrace_spp(scene, ctx, *d_args)
        return _accumulate_and_store(prev, v3.to_rows(acc / 64.0), gx, gy, d_counter,
                                     True, full_frame=True), n_tr

    p_b3d, (img_p, nt_dp) = plain_ms(plain_dispatch)
    res_b3d = compare_dispatch(img_k, cnt_k, img_p, nt_dp)
    emit("kernels_vs_plain_main_shapes", b1=res_b1, b2=res_b2, b2_sphere=res_b2s,
         b3=dict(pixels=B, spp=64, bounces=8, max_radiance=100.0,
                 warp_efficiency=warp_efficiency(nt), **res_b3),
         b3_dispatch=dict(pixels=B, spp=64, bounces=8, max_radiance=100.0,
                          counter=d_counter, accumulate=True, **res_b3d))
    segs = int(nt.sum())
    Tl = scene.lt_v0.shape[1]
    aw = scene.wt_attr.shape[1]
    bnd_b1 = bound_ms(B * T * PAIR_OPS, B * 40 + T * 160 + B * 20)
    Bw = R_wf.shape[0]
    bnd_b2 = b2_bound(Bw, T, aw)
    bnd_b2s = b2_bound(Bw, Ts, aw)
    # Per path segment: the closest hit plus the light pdf's per-triangle
    # ray/triangle test (~60 ops); shading and sampling are not counted, so
    # this bound is a lower one.
    bnd_b3 = bound_ms(segs * (T * PAIR_OPS + Tl * 60), B * 12 + B * 16 + T * 416)
    kernels = [
        entry("B1 dense_closest_hit", "dense_intersect.cu",
              "lupinpathtracer_tpu/kernels/pallas_intersect.py:361", launches_b1,
              res_b1["max_abs_err"], t_b1, p_b1, bnd_b1, by1),
        entry("B2 dense_closest_hit_attrs", "dense_intersect.cu",
              "lupinpathtracer_tpu/kernels/pallas_intersect.py:298", launches_b2,
              res_b2["max_abs_err"], t_b2, p_b2, bnd_b2, by2),
        entry("B2 dense_closest_hit_attrs (Cornell DIRECT, mean per main-path launch)",
              "dense_intersect.cu", "lupinpathtracer_tpu/kernels/pallas_intersect.py:298",
              launches_b2, *b2_replay),
        entry(f"B2 dense_closest_hit_attrs (sphere box, {Ts} triangles)",
              "dense_intersect.cu", "lupinpathtracer_tpu/kernels/pallas_intersect.py:298",
              launches_b2s, res_b2s["max_abs_err"], t_b2s, p_b2s, bnd_b2s, by2s,
              launches_in="sphere-box timing"),
        entry("B3 mega_pathtrace_spp (dispatch mode)", "mega.cu",
              "lupinpathtracer_tpu/kernels/pallas_mega.py:622", launches_b3,
              res_b3d["max_abs_err"], t_b3d, p_b3d, bnd_b3, by3d),
        entry("B3 mega_pathtrace_spp (acc mode)", "mega.cu",
              "lupinpathtracer_tpu/kernels/pallas_mega.py:622", launches_b3_acc,
              res_b3["acc_max_abs_err"], t_b3, p_b3, bnd_b3, by3,
              launches_in="acc-mode timing"),
    ]
    emit("timing_shapes", b1_rays=B, b2_rays=Bw, tris=T, b2_sphere_tris=Ts,
         b1_smem_bytes=dk.smem_bytes(T, False), b2_smem_bytes=dk.smem_bytes(T, True),
         threads_per_block=dk.THREADS, min_blocks_per_sm=dk.MIN_BLOCKS,
         b3_pixels=B, b3_spp=64,
         b3_segments=segs, b3_dispatch_segments=cnt_k, main_path_rays=rays_main,
         card=smi,
         total_s=time.perf_counter() - t_start)

    # -- 6b. the BVH route's shading step at the spd cell's shapes -----------
    kernels.append(shade_phase(dev, smi))
    kernels += walk_phase(dev, smi)

    # -- 7-10. the BVH route -----------------------------------------------
    bvh_kernels, terrain_state, terrain_cams, terrain_cpu = bvh_phases(
        dev, smi, scene, cams)
    emit("bvh_phases_done", total_s=time.perf_counter() - t_start)

    # -- 11-13. the two-level route ------------------------------------------
    inst_kernels, field_state, field_cams = instanced_phases(dev, smi)
    emit("instanced_phases_done", total_s=time.perf_counter() - t_start)

    # -- 14-18. the rest of the render API: MIS, AOVs, debug, denoise, streams
    from lupinpathtracer_tpu_torch.kernels import bvh, packet

    bvh_scenes = {"terrain2M": (terrain_state[0], terrain_cams),
                  "instanced100k": (field_state[0], field_cams)}
    counters = (dk.LAUNCHES, mega.LAUNCHES, bvh.LAUNCHES, packet.LAUNCHES,
                walk.LAUNCHES, intersect.HOST_SYNCS, integrators.HOST_SYNCS)
    api_kernels = mis_phases(dev, smi, scene, cams, bvh_scenes, counters)
    emit("mis_phases_done", total_s=time.perf_counter() - t_start)
    api_kernels += aov_phases(dev, smi, scene, cams, bvh_scenes, counters)
    emit("aov_phases_done", total_s=time.perf_counter() - t_start)
    streams_phase(dev, smi, bvh_scenes, counters)
    emit("streams_phase_done", total_s=time.perf_counter() - t_start)

    # -- 19-24. scene files, the apps and multi-device -------------------------
    api_kernels += file_phases(dev, smi, scene, cams, terrain_cpu, terrain_state[0],
                               terrain_cams, counters)
    del terrain_cpu
    emit("file_phases_done", total_s=time.perf_counter() - t_start)

    # -- 25-27. the traversal controls ----------------------------------------
    api_kernels += packet_gate_phase(dev, smi, counters)
    emit("packet_gate_phase_done", total_s=time.perf_counter() - t_start)
    dispatch_1080p_phase(dev, smi, terrain_state[0], terrain_cams, counters)
    emit("dispatch_1080p_phase_done", total_s=time.perf_counter() - t_start)
    api_kernels += packet_bounce_phase(dev, smi, bvh_scenes, counters)
    emit("packet_bounce_phase_done", total_s=time.perf_counter() - t_start)

    # -- the B6' variants on both round-1 states ------------------------------
    kernels += bvh_kernels + inst_kernels + api_kernels + prof_pair_phase(
        {"terrain2M": terrain_state, "instanced100k": field_state}, smi)
    emit("done", total_s=time.perf_counter() - t_start,
         kernels_timed_by_events_not_device_records=[
             k["name"] for k in kernels if k["timed_by"] != "device_records"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
