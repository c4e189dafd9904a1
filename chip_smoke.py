"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from lupinpathtracer_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, and drives the port's
main paths through its entry points:
- dense route: the progressive Cornell-box render, 512x512, 8 bounces,
  64 spp per accumulation (kernel B3), the DIRECT wavefront (B2) and a
  closest-hit query (B1), and a 32x32 render against the repo's golden;
- BVH route: the 2M-triangle synthetic terrain (bench.py's terrain2M),
  512x288, STANDARD, 8 bounces, 4 spp per accumulation (B4 on camera rays,
  B5/B6/B7 on every bounce batch), B4-B7 against their plain versions at
  those shapes, and the Cornell box forced onto the BVH route
  (force_software_bvh: B6/B7) against the golden.
Each phase prints one JSON line; any failure raises and exits nonzero. The
kernels line holds each kernel's launches on its main path, its error
against the plain version, its device time (torch.profiler) and the plain
version's wall time (CUDA events) at the main path's shapes, and its bound
on an H100 (FP32 67 TFLOP/s, HBM 3.35 TB/s).
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
TERRAIN_TRIS = 2_000_000  # bench.py's terrain2M
# f32 operations per unit of work, for the bounds:
PAIR_OPS = 81  # ray/triangle: 4 ten-term dot products (76) + 1/det, 3 products, u+v
SLAB_OPS = 26  # ray/box: 6 subtractions, 6 products, 10 min/max, 4 compares
SORT_OPS = 12  # B5 per child: 19 comparators x (1 compare + 4 selects) / 8


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    """Mean device milliseconds of the CUDA kernel whose name contains
    `kernel`, which fn() launches once per call, over reps calls
    (torch.profiler, CUDA activity, after one warm-up call), and the output
    of the last call. CUDA events around a loop of calls would also count
    the host's launch overhead, which is longer than the shortest kernels
    (B5, B7) run. The profiler can drop a launch's record, so the mean is
    over the records it kept, which must be most of them."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    assert reps // 2 < len(spans) <= reps, (kernel, len(spans), reps)
    return sum(spans) / len(spans) / 1e3, out


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
                 ("B6", "pair_kernel"), ("B7", "attr_kernel"))


def device_profile(fn):
    """Device time of one call of fn by kernel group (torch.profiler, CUDA
    activity only, so the host is not slowed by op recording): the port's
    BVH kernels, sorts, copies/fills and every other PyTorch kernel, plus
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
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        low = e.name.lower()
        g = next((k for k, sub in KERNEL_GROUPS if sub in e.name), None)
        if g is None:
            g = ("sort" if "sort" in low else
                 "copy_fill" if "memcpy" in low or "memset" in low
                 or "fill" in low else "other_torch")
        ms[g] = ms.get(g, 0.0) + (b - a) / 1e3
        n[g] = n.get(g, 0) + 1
        spans.append((a, b))
    busy = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy / 1e3,
                profiled_idle_share=1.0 - busy / 1e3 / wall_ms,
                device_ms_by_group=ms, kernels_by_group=n)


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
    the BVH route against the golden. Returns the B4-B7 kernel entries."""

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.accel.superleaf import TOP_COLS, TOP_FAN
    from lupinpathtracer_tpu_torch.core import rng as rng_mod
    from lupinpathtracer_tpu_torch.core.vec3 import V3
    from lupinpathtracer_tpu_torch.io import synthetic
    from lupinpathtracer_tpu_torch.kernels import bvh, intersect, mega, packet
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.render import integrators
    from lupinpathtracer_tpu_torch.render.renderer import (
        _camera_args, _pixel_batch)

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
    t_b4, k4 = kernel_ms(
        lambda: packet.packet_traverse(ts, ro, rd, eps, W, with_attrs=True),
        "packet_kernel", 5)
    work4: dict = {}
    p_b4, p4 = plain_ms(lambda: packet.packet_traverse_plain(
        ts, ro, rd, eps, W, with_attrs=True, counts=work4))
    res_b4 = compare_hits(k4, p4, F32_MAX)
    assert res_b4["hit_flag_mismatch"] == 0, res_b4
    hits4 = int((k4[0] < F32_MAX).sum())
    awout = k4[5].shape[0]
    row_b = attr_row_bytes(bool(ts.any_normal_maps))
    bnd_b4 = bound_ms(
        work4["tri_tests"] * PAIR_OPS + work4["box_tests"] * SLAB_OPS,
        B * 24 + B * (20 + awout * 4) + hits4 * row_b
        + work4["chunks"] * work4["chunk_tris"] * 160
        + rows * TOP_FAN * 36 + ts.sl_sub.numel() * 4)
    emit("b4_vs_plain", hits=hits4, attr_row_bytes=row_b, **work4, **res_b4)

    # One bounce batch of B rays from the camera hits.
    o, d = bounce_batch(ro, rd, k4[0], V3(*k4[5][bvh.IA_GN]), F32_MAX, seed=1)
    pad = (-B) % intersect.WF_RAY_BLOCK
    Bp = B + pad
    op = V3(*(intersect._pad(c, pad, 0.0) for c in o))
    dp = V3(intersect._pad(d.x, pad, 0.0), intersect._pad(d.y, pad, 1.0),
            intersect._pad(d.z, pad, 0.0))
    S = bvh.stack_depth(ts)
    Q = intersect.WF_Q_DIVERGENT
    PB = intersect.WF_PAIR_BLOCK
    tab = ts.top_tab.float()
    stack0 = torch.zeros((S, Bp), dtype=torch.int32, device=dev)
    sp0 = (torch.arange(Bp, device=dev) < B).to(torch.int32)
    bt0 = torch.full((Bp,), F32_MAX, dtype=torch.float32, device=dev)

    # B5: the batch's first round. It updates its stack in place, so every
    # call (the warm-up and the timed ones) gets a fresh copy made ahead.
    reps5 = 10
    stacks = iter([stack0.clone() for _ in range(reps5 + 1)])
    t_b5, k5 = kernel_ms(lambda: bvh.top_traverse(
        tab, op, dp, bt0, next(stacks), sp0, S=S, Q=Q, n_sl=n_sl),
        "top_kernel", reps5)
    work5: dict = {}
    p_b5, p5 = plain_ms(lambda: bvh.top_traverse_plain(
        tab, op, dp, bt0, stack0.clone(), sp0, S=S, Q=Q, n_sl=n_sl,
        counts=work5))
    b5_equal = [a is b if a is None else bool(torch.equal(a, b))
                for a, b in zip(k5, p5)]
    err5 = max(float((a.long() - b.long()).abs().max())
               for a, b in zip(k5, p5) if a is not None)
    aabb5 = int(k5[5].sum())
    emits5 = int(k5[1].sum())
    emit("b5_vs_plain", rays=B, lanes=Bp, Q=Q, S=S, emits=emits5,
         aabb_tests=aabb5, pending=int((k5[3] > 0).sum()), **work5,
         outputs_equal=b5_equal, max_abs_err=err5)
    assert all(b5_equal) and err5 == 0, b5_equal
    # Bytes: rays and best_t in (28 per lane), sp in and out, the (Q, Bp)
    # ids, counts and aabb out, the stack entries popped and pushed, the
    # histogram and the top table.
    bnd_b5 = bound_ms(aabb5 * (SLAB_OPS + SORT_OPS),
                      Bp * (28 + 2 * 4 + Q * 4 + 2 * 4)
                      + (work5["pops"] + work5["pushes"]) * 4
                      + bvh.hist_bins(n_sl) * 4 + rows * TOP_COLS * 4)

    # B6 on the round's superleaf-sorted pairs.
    sl = k5[0].reshape(-1)
    skey, order = torch.sort(torch.where(sl >= 0, sl, n_sl), stable=True)
    ray = order % Bp
    so, sd = V3(*(c[ray] for c in op)), V3(*(c[ray] for c in dp))
    blk, sl_k, lo, hi, n_real, n_items = intersect._wf_work_items(
        skey, n_sl, PB, k5[4])
    args6 = (blk, sl_k, lo, hi, so, sd, W, eps)
    kw6 = dict(SP=SP, pair_block=PB, n_items=n_items)
    t_b6, k6 = kernel_ms(lambda: bvh.pair_intersect(*args6, **kw6),
                         "pair_kernel", 5)
    p_b6, p6 = plain_ms(lambda: bvh.pair_intersect_plain(*args6, **kw6))
    res_b6 = compare_hits(k6, p6, F32_MAX)
    assert res_b6["hit_flag_mismatch"] == 0, res_b6
    pairs, items = int(n_real), int(n_items)
    sl_used = int(torch.unique(sl_k[:items]).numel())
    bnd_b6 = bound_ms(pairs * SP * PAIR_OPS,
                      pairs * (24 + 20) + items * 16 + sl_used * SP * 160)
    emit("b6_vs_plain", pairs=pairs, items=items, superleaves=sl_used,
         pair_slots=int(skey.shape[0]), **res_b6)

    # B7 on the batch's winners, sorted as wavefront_fetch_attrs sorts them.
    h = intersect.closest_hit_wavefront(ts, o, d, eps, W=W, coherent=False)
    args7, kw7, _, _ = intersect._attr_fetch_args(ts, h)
    t_b7, k7 = kernel_ms(lambda: bvh.attr_fetch(*args7, **kw7),
                         "attr_kernel", 10)
    p_b7, p7 = plain_ms(lambda: bvh.attr_fetch_plain(*args7, **kw7))
    err7 = float((k7 - p7).abs().max())
    hits7 = int(h.hit.sum())
    emit("b7_vs_plain", rays=B, hits=hits7, rows=k7.shape[0],
         rows_equal=bool(torch.equal(k7, p7)), max_abs_err=err7)
    assert torch.equal(k7, p7)
    bnd_b7 = bound_ms(hits7 * 11 * 5, hits7 * (row_b + 12)
                      + k7.numel() * 4 + int(args7[0].shape[0]) * 16)

    # -- 9. the BVH main path --------------------------------------------------
    counters = (bvh.LAUNCHES, packet.LAUNCHES, dk.LAUNCHES, mega.LAUNCHES,
                intersect.HOST_SYNCS)
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
    launches = {**packet.LAUNCHES, **bvh.LAUNCHES}
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
    assert all(v > 0 for v in launches.values()), launches
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
    routed = {**packet.LAUNCHES, **bvh.LAUNCHES, **mega.LAUNCHES}
    emit("golden_bvh_route", atol=2e-3, pixels_within_atol=within,
         mean_rel_diff=mean_rel, max_abs_diff=float(np.abs(img_g - golden).max()),
         launches=routed)
    assert bvh.LAUNCHES["pair_intersect"] > 0 and bvh.LAUNCHES["attr_fetch"] > 0
    assert mega.LAUNCHES["mega_pathtrace_spp"] == 0
    assert within >= 0.99 and mean_rel <= 0.01

    def entry(name, src, replaces, key, err, ms, p_ms, bnd):
        return dict(name=name, route="cuda",
                    source=f"lupinpathtracer_tpu_torch/csrc/{src}",
                    replaces=f"lupinpathtracer_tpu/kernels/{replaces}",
                    launches=launches[key], max_abs_err=err, ms=ms,
                    plain_ms=p_ms, bound_ms=bnd[0], bound_by=bnd[1],
                    library_ms=None)

    return [
        entry("B4 packet_traverse", "packet.cu", "pallas_packet.py:1011",
              "packet_traverse", res_b4["max_abs_err"], t_b4, p_b4, bnd_b4),
        entry("B5 top_traverse", "bvh.cu", "pallas_bvh.py:344", "top_traverse",
              err5, t_b5, p_b5, bnd_b5),
        entry("B6 pair_intersect", "bvh.cu", "pallas_bvh.py:665",
              "pair_intersect", res_b6["max_abs_err"], t_b6, p_b6, bnd_b6),
        entry("B7 attr_fetch", "bvh.cu", "pallas_bvh.py:896", "attr_fetch",
              err7, t_b7, p_b7, bnd_b7),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.core import rng as rng_mod
    from lupinpathtracer_tpu_torch.core.vec3 import V3
    from lupinpathtracer_tpu_torch.io import builtin
    from lupinpathtracer_tpu_torch.kernels import cuda_build, intersect, mega
    from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
    from lupinpathtracer_tpu_torch.render import integrators
    from lupinpathtracer_tpu_torch.render.renderer import (
        _camera_args, _pixel_batch)

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
    emit("b1_b2_vs_plain", tris=T, b1_equals_b2_hit=b1_same, **res)
    assert b1_same

    # -- 3. B3 against its plain version (the port's pathtrace_spp) ------------
    glossy_scene = lt.build_scene_torch(glossy_cornell(lt, builtin)[0], device=dev)
    gx64, gy64 = _pixel_batch(64, 64, 0, 0, dev)
    pix64 = gy64 * 64 + gx64
    for name, sc in (("cornell", scene), ("cornell_glossy_gltfpbr", glossy_scene)):
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
                 spp=4, bounces=8, **compare_paths(acc_k, nt_k, acc_p, nt_p))

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
    launches_b3 = mega.LAUNCHES["mega_pathtrace_spp"]
    assert launches_b3 > 0 and np.isfinite(img).all() and img.mean() > 0
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
         rays=stats_d["rays"], mrays_per_s=stats_d["rays"] / wall_d / 1e6,
         image_mean=float(img_d.mean()), launches=dict(dk.LAUNCHES), card=smi)

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
    R_main = R_cam  # the main path's 512x512 camera rays
    # DIRECT traces 2 rays per lane: camera rays, then as many rays from
    # inside the box.
    o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (B, 3))
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    R_wf = torch.cat([R_cam, intersect.ray_features(
        V3(*torch.tensor(o.T, dtype=torch.float32, device=dev)),
        V3(*torch.tensor(d.T, dtype=torch.float32, device=dev)))])
    t_b1, k = kernel_ms(lambda: dk.dense_closest_hit(W, R_main, eps),
                        "dense_hit_kernel", 20)
    p_b1, p = cuda_ms(lambda: dk.dense_closest_hit_plain(W, R_main, eps), 3)
    res_b1 = compare_hits(k, p, dk.F32_MAX)
    t_b2, k = kernel_ms(
        lambda: dk.dense_closest_hit_attrs(W, scene.wt_attr, R_wf, eps),
        "dense_hit_kernel", 20)
    p_b2, p = cuda_ms(lambda: dk.dense_closest_hit_attrs_plain(W, A, R_wf, eps), 3)
    res_b2 = compare_hits(k, p, dk.F32_MAX)
    pix = gy * 512 + gx
    b3_args = (pix, gx, gy, (512.0, 512.0), cam, False, 0, 0, 64,
               int(lt.PathtraceType.STANDARD), 8, 100.0)
    t_b3, (acc_k, nt) = kernel_ms(
        lambda: mega.mega_pathtrace_spp(scene, W, *b3_args, eps),
        "mega_kernel", 3)
    ctx = integrators.make_ctx(scene, eps)
    p_b3, (acc_p, nt_p) = cuda_ms(
        lambda: integrators.pathtrace_spp(scene, ctx, *b3_args), 1)
    res_b3 = compare_paths(acc_k, nt, acc_p, nt_p)
    emit("kernels_vs_plain_main_shapes", b1=res_b1, b2=res_b2,
         b3=dict(pixels=B, spp=64, bounces=8, max_radiance=100.0, **res_b3))
    segs = int(nt.sum())
    Tl = scene.lt_v0.shape[1]
    aw = scene.wt_attr.shape[1]
    bnd_b1 = bound_ms(B * T * PAIR_OPS, B * 40 + T * 160 + B * 20)
    Bw = R_wf.shape[0]
    bnd_b2 = bound_ms(Bw * T * PAIR_OPS, Bw * 40 + T * 160 + Bw * 20
                      + T * aw * 4 + Bw * aw * 4)
    # Per path segment: the closest hit plus the light pdf's per-triangle
    # ray/triangle test (~60 ops); shading and sampling are not counted, so
    # this bound is a lower one.
    bnd_b3 = bound_ms(segs * (T * PAIR_OPS + Tl * 60), B * 12 + B * 16 + T * 416)
    kernels = [
        dict(name="B1 dense_closest_hit", route="cuda",
             source="lupinpathtracer_tpu_torch/csrc/dense_intersect.cu",
             replaces="lupinpathtracer_tpu/kernels/pallas_intersect.py:361",
             launches=launches_b1, max_abs_err=res_b1["max_abs_err"],
             ms=t_b1, plain_ms=p_b1,
             bound_ms=bnd_b1[0], bound_by=bnd_b1[1], library_ms=None),
        dict(name="B2 dense_closest_hit_attrs", route="cuda",
             source="lupinpathtracer_tpu_torch/csrc/dense_intersect.cu",
             replaces="lupinpathtracer_tpu/kernels/pallas_intersect.py:298",
             launches=launches_b2, max_abs_err=res_b2["max_abs_err"],
             ms=t_b2, plain_ms=p_b2,
             bound_ms=bnd_b2[0], bound_by=bnd_b2[1], library_ms=None),
        dict(name="B3 mega_pathtrace_spp", route="cuda",
             source="lupinpathtracer_tpu_torch/csrc/mega.cu",
             replaces="lupinpathtracer_tpu/kernels/pallas_mega.py:622",
             launches=launches_b3, max_abs_err=res_b3["acc_max_abs_err"],
             ms=t_b3, plain_ms=p_b3,
             bound_ms=bnd_b3[0], bound_by=bnd_b3[1], library_ms=None),
    ]
    emit("timing_shapes", b1_rays=B, b2_rays=Bw, tris=T, b3_pixels=B, b3_spp=64,
         b3_segments=segs, main_path_rays=rays_main, card=smi,
         total_s=time.perf_counter() - t_start)

    # -- 7-10. the BVH route -----------------------------------------------
    kernels += bvh_phases(dev, smi, scene, cams)
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
