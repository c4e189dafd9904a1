"""Render dispatch API: pathtrace / falsecolor / debug with progressive
accumulation and tiling.

The counterpart of lupinpathtracer_tpu/render/renderer.py (the reference's
pathtrace_scene, _falsecolor and _debug, renderer.rs:768-1040; the
progressive blend, pathtracer.wgsl:279-288). A dispatch renders one tile
(or the whole frame) as one flat ray batch. Path tracing: scenes that pass
the megakernel gate run through kernel B3 (kernels/mega.py; on the card the
whole dispatch, from pixel ids to the stored image, is one launch); the rest
(MIS always) through the wavefront loop (render/integrators.py): dense
scenes with kernel B2, BVH scenes, single-level and two-level (instanced),
with kernels B4 (camera rays) and B5/B6/B7 (bounces). The falsecolor AOVs
trace camera rays (B2; B4, with B7 on two-level scenes); the debug
heatmaps count a camera ray's traversal tests (B5/B6) or its bounces.

The one environment knob, read at each dispatch as in the JAX package:
LUPIN_SPP_STREAMS (concurrent sample streams per pixel on the wavefront
route, integrators.pathtrace_spp; 1 unless it is >= 1 and divides spp).
The self-bounding split of a BVH frame (dispatch_tiles) splits a frame
only where its working set, dispatch_bytes_per_lane per pixel, would pass
half of the device's memory.
"""

from __future__ import annotations

import dataclasses
import os
import weakref

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core import trace
from ..core import vec3 as v3
from ..core.device import resolve_device
from ..core.types import (
    BakedPathtraceParams,
    FalsecolorType,
    PathtraceDesc,
    PathtraceType,
    get_num_tiles,
)
from ..kernels import intersect, mega
from . import integrators
from .materials import compute_shading_normal, get_material_point, is_mat_delta

# Host syncs of the dispatch: the read of stats["rays"]. A measurement
# counter like intersect.HOST_SYNCS: set to 0 before a run, read after.
HOST_SYNCS = {"rays": 0}


def _tile_geometry(image_shape, desc: PathtraceDesc):
    """The tile size and origin of a dispatch."""

    H, W = image_shape[:2]
    tp = desc.tile_params
    if tp.enabled:
        ts = int(tp.tile_size)
        nx, _ = get_num_tiles(W, H, ts)
        tx = (int(tp.tile_idx) % max(nx, 1)) * ts
        ty = (int(tp.tile_idx) // max(nx, 1)) * ts
        return (min(ts, W), min(ts, H)), (tx, ty)
    return (W, H), (0, 0)


def _camera_args(desc: PathtraceDesc) -> dict:
    p = desc.camera_params
    return dict(
        cam_transform=np.asarray(desc.camera_transform, np.float32),
        lens=float(np.float32(p.lens)),
        film=float(np.float32(p.film)),
        aspect=float(np.float32(p.aspect)),
        focus=float(np.float32(p.focus)),
        aperture=float(np.float32(p.aperture)),
    )


_SWIZZLE_TILE = 16


def _pixel_batch(tw, th, origin_x, origin_y, device):
    """Pixel ids of a tile, in 16x16-swizzled lane order when the dims allow
    (renderer.py:79-102); results do not depend on the lane order."""

    ts = _SWIZZLE_TILE
    if tw % ts == 0 and th % ts == 0:
        lane = torch.arange(tw * th, dtype=torch.int32, device=device)
        t = lane // (ts * ts)
        w = lane % (ts * ts)
        ntx = tw // ts
        gx = origin_x + (t % ntx) * ts + (w % ts)
        gy = origin_y + (t // ntx) * ts + (w // ts)
        return gx, gy
    xs = torch.arange(tw, dtype=torch.int32, device=device)
    ys = torch.arange(th, dtype=torch.int32, device=device)
    gx = (origin_x + xs)[None, :].expand(th, tw).reshape(-1)
    gy = (origin_y + ys)[:, None].expand(th, tw).reshape(-1)
    return gx, gy


def _accumulate_and_store(image, color, gx, gy, accum_counter: int,
                          accumulate: bool, full_frame: bool = False):
    """Progressive blend (pathtracer.wgsl:279-288) + bounds-dropped store;
    returns the new image (the input is not modified)."""

    color = torch.clamp_min(color, 0.0)
    weight = np.float32(1.0) / np.float32(max(accum_counter, 1))
    keep = float(np.float32(1.0) - weight)
    weight = float(weight)
    do_blend = accumulate and accum_counter != 0

    def blend(prev, col):
        if not do_blend:
            return col
        return torch.clamp_min(prev * keep + col * weight, 0.0)

    H, W = image.shape[:2]
    if full_frame:
        ts = _SWIZZLE_TILE
        if H % ts == 0 and W % ts == 0:
            # Swizzled lane order: the identity map is a transpose.
            prev = (image.reshape(H // ts, ts, W // ts, ts, 3)
                    .permute(0, 2, 1, 3, 4).reshape(-1, 3))
            return (blend(prev, color).reshape(H // ts, W // ts, ts, ts, 3)
                    .permute(0, 2, 1, 3, 4).reshape(image.shape).contiguous())
        return blend(image.reshape(-1, 3), color).reshape(image.shape)
    inb = (gx < W) & (gy < H)
    gxl, gyl = gx[inb].long(), gy[inb].long()
    out = image.clone()
    out[gyl, gxl] = blend(image[gyl, gxl], color[inb])
    return out


def _render_pathtrace(scene, image, cam, origin_x, origin_y, accum_counter,
                      rng_seed, ray_epsilon, max_radiance, tile_wh, spp,
                      max_bounces, ptype, is_ortho, accumulate, stats=None):
    if mega.applicable(scene, ptype) and image.is_cuda:
        # On the card the whole dispatch is one B3 launch: the pixel ids,
        # the blend and store and the segment count are its entry and exit.
        out, rays = mega.mega_dispatch(
            scene, image, cam, is_ortho, (origin_x, origin_y), tile_wh,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            ray_epsilon, accumulate, count=stats is not None)
    else:
        H, W = image.shape[:2]
        tw, th = tile_wh
        gx, gy = _pixel_batch(tw, th, origin_x, origin_y, image.device)
        pixel_idx = gy * W + gx
        resolution = (float(W), float(H))
        ctx = integrators.make_ctx(scene, ray_epsilon)

        # All spp in one wavefront with in-place path regeneration: B3's
        # plain version for scenes inside the gate (here on the CPU), one
        # stream as in B3.
        acc, n_traced = integrators.pathtrace_spp(
            scene, ctx, pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            streams=1 if mega.applicable(scene, ptype) else _streams(spp),
        )
        rays = n_traced.sum()
        out = _accumulate_and_store(image, v3.to_rows(acc / float(spp)), gx, gy,
                                    accum_counter, accumulate,
                                    full_frame=(tw, th) == (W, H))
    if stats is not None:
        stats["rays"] = stats.get("rays", 0) + trace.sync(
            HOST_SYNCS, "rays", rays, int)
    return out


def _runtime_checks(scene, baked: BakedPathtraceParams):
    """Dispatch-time validation of the flattened scene's index tables, once
    per scene object (renderer.rs:487-499)."""

    if not baked.with_runtime_checks:
        return
    key = id(scene)
    if key in _VALIDATED_SCENES:
        return
    checks = {
        "wt_mat": (int(scene.wt_mat.max()), max(scene.num_materials, 1)),
        "wt_inst": (int(scene.wt_inst.max()), max(scene.num_instances, 1)),
        "mat_tex": (int(scene.mat_tex.max()), max(scene.num_textures, 1)),
        "gsl_msl": (int(scene.gsl_msl.max()), max(scene.msl_count, 1)),
        "lt_light": (int(scene.lt_light.max()), max(scene.num_lights, 1)),
    }
    for name, (mx, n) in checks.items():
        if mx >= n:
            raise ValueError(
                f"scene validation: {name} max index {mx} out of range {n}"
            )
    if not bool(torch.isfinite(scene.mat_color).all()):
        raise ValueError("scene validation: non-finite material colors")
    _VALIDATED_SCENES.add(key)
    # Purge on GC: CPython reuses id()s.
    weakref.finalize(scene, _VALIDATED_SCENES.discard, key)


_VALIDATED_SCENES: set = set()

# Self-bounding dispatch (renderer.py:358-380; renderer.rs:651-681: no
# dispatch grows unbounded). Without explicit tiling, a BVH frame whose
# working set would pass half of the device's memory is split into square
# tiles (the largest power of two from 1024 down to the floor, renderer.py's
# search): the other half holds the scene, the image and the allocator's
# slack, which share the device with the dispatch. The JAX package bounds
# rays x superleaf stride instead: its budget sizes a dense
# f32[rays, 4, stride] fetch tensor in TPU HBM, which the port never builds.
DISPATCH_TILE_FLOOR = 128
DISPATCH_MEMORY_SHARE = 0.5

# Bytes per pair slot of a wavefront round (Q slots a lane): B5's superleaf
# id, the sort key and its mask, the sorted key, the order (int64), the
# radix sort's double buffers and index iota (20), the pair's ray index
# (int64) and gathered ray (24), B6's five outputs (20), the valid-slot
# mask and its iota (9), the masked t and the global id (12) and the five
# un-sorted copies (20).
_PAIR_BYTES = 4 + 5 + 4 + 8 + 20 + 8 + 24 + 20 + 9 + 12 + 20
# 4-byte words per lane of the integrator: the path's carried state (ray,
# hit record, weight, radiance, volume slot, counters, sample index, acc,
# the regeneration inputs: ~48 words) and one bounce's temporaries (the
# material point, normals, positions, sampled directions, the respawned
# camera rays: ~144 words). The attribute rows come on top.
_PATH_WORDS = 48 + 144


def dispatch_bytes_per_lane(scene, baked: BakedPathtraceParams, ptype: int) -> int:
    """Bytes the port holds live per pixel lane during one pathtrace
    dispatch of a BVH scene: per traced ray (MIS traces three slots a lane,
    DIRECT two), the wavefront's stack (bk.stack_depth int32 rows, twice:
    the straggler scatter copies it), its sp and best_* rows (twice, the
    round's and the next), the padded rays and WF_Q pair slots, and B7's
    attribute rows (IA_ROWS[_NM]: its output, the scatter's and the mask's
    copies) with its sort; per lane the integrator's state and temporaries
    and the carried attribute rows; times the sample streams
    (LUPIN_SPP_STREAMS) the dispatch runs."""

    from ..kernels import bvh as bk

    S = bk.stack_depth(scene)
    ia = bk.IA_ROWS_NM if scene.any_normal_maps else bk.IA_ROWS
    slots = {int(PathtraceType.MIS): 3, int(PathtraceType.DIRECT): 2}.get(int(ptype), 1)
    wavefront = 2 * 4 * S + 2 * 6 * 4 + 6 * 4 + intersect.WF_Q * _PAIR_BYTES
    fetch = 3 * ia * 4 + 48
    path = (_PATH_WORDS + ia) * 4
    return _streams(int(baked.samples_per_pixel)) * (slots * (wavefront + fetch) + path)


def device_memory_bytes(device) -> int:
    """The memory a dispatch on `device` shares: the card's
    (torch.cuda.get_device_properties), or on the CPU the host's
    physical memory."""

    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def dispatch_tiles(scene, image_shape, baked: BakedPathtraceParams,
                   ptype: int, device):
    """The self-bound's tile size, or None when the frame is one dispatch:
    lanes x dispatch_bytes_per_lane against DISPATCH_MEMORY_SHARE of
    device_memory_bytes, tiles no smaller than DISPATCH_TILE_FLOOR."""

    H, W = image_shape[:2]
    per_lane = dispatch_bytes_per_lane(scene, baked, ptype)
    budget = int(DISPATCH_MEMORY_SHARE * device_memory_bytes(device))
    if W * H * per_lane <= budget:
        return None
    ts = 1024
    while ts > DISPATCH_TILE_FLOOR and ts * ts * per_lane > budget:
        ts //= 2
    return ts


def _streams(spp: int) -> int:
    """LUPIN_SPP_STREAMS as a dispatch applies it: 1 unless it is >= 1 and
    divides spp."""

    streams = int(os.environ.get("LUPIN_SPP_STREAMS", "1"))
    return 1 if streams < 1 or spp % streams else streams


def _dispatch_setup(scene, image, desc: PathtraceDesc,
                    baked: BakedPathtraceParams):
    """What every dispatch does first: the device check, the runtime
    checks and the backend choice. Returns (scene, tile size, origin)."""

    if image.device != scene.device:
        raise ValueError(f"image on {image.device}, scene on {scene.device}")
    _runtime_checks(scene, baked)
    return (_select_backend(scene, desc), *_tile_geometry(image.shape, desc))


def _select_backend(scene, desc: PathtraceDesc):
    """Per-dispatch traversal choice (renderer.py:207-220; renderer.rs:764,
    :772): `force_software_bvh` puts a dense scene on the BVH wavefront
    (every scene carries superleaf tables)."""

    if desc.force_software_bvh and not scene.use_bvh and scene.sl_count > 0:
        return dataclasses.replace(scene, statics={**scene.statics, "use_bvh": True})
    return scene


def pathtrace_scene(scene, image, desc: PathtraceDesc,
                    baked: BakedPathtraceParams, stats: dict | None = None):
    """Renders spp samples of the selected integrator into `image`
    (renderer.rs:768-842) and returns the new image. `image` and the scene
    must lie on one device. With a `stats` dict, adds the dispatch's traced
    ray segments (the sum of n_traced) to stats["rays"]; this is a
    measurement hook (the JAX API has no such argument) and costs one
    device-to-host sync per dispatch (HOST_SYNCS["rays"]), so leave it None
    otherwise. The call is the `dispatch` span of core/trace.py."""

    with trace.span(trace.DISPATCH):
        return _pathtrace_scene(scene, image, desc, baked, stats)


def _pathtrace_scene(scene, image, desc: PathtraceDesc,
                     baked: BakedPathtraceParams, stats: dict | None):
    scene, tile_wh, (tx, ty) = _dispatch_setup(scene, image, desc, baked)

    def one(tile_wh, tx, ty, image):
        return _render_pathtrace(
            scene, image, _camera_args(desc), tx, ty,
            int(desc.accum_params.counter), int(desc.advanced.rng_seed),
            float(np.float32(desc.advanced.ray_epsilon)),
            float(np.float32(desc.advanced.max_radiance)),
            tile_wh=tile_wh,
            spp=int(baked.samples_per_pixel),
            max_bounces=int(baked.max_bounces),
            ptype=int(desc.pathtrace_type),
            is_ortho=bool(desc.camera_params.is_orthographic),
            accumulate=bool(desc.accum_params.accumulate),
            stats=stats,
        )

    if not desc.tile_params.enabled and scene.use_bvh and scene.sl_count:
        H, W = image.shape[:2]
        ts = dispatch_tiles(scene, image.shape, baked, int(desc.pathtrace_type),
                            image.device)
        if ts is not None:
            nx, ny = get_num_tiles(W, H, ts)
            for idx in range(nx * ny):
                tx, ty = (idx % nx) * ts, (idx // nx) * ts
                image = one((min(ts, W - tx), min(ts, H - ty)), tx, ty, image)
            return image
    return one(tile_wh, tx, ty, image)


# ---------------------------------------------------------------------------
# Falsecolor AOVs (renderer.py:390-563; renderer.rs:872-948,
# pathtracer.wgsl:298-452)
# ---------------------------------------------------------------------------

# The AOVs that trace through the stochastic alpha skip (renderer.py:421).
_ALPHA_SKIP_AOVS = (
    FalsecolorType.ALBEDO, FalsecolorType.NORMALS,
    FalsecolorType.NORMALS_UNSIGNED, FalsecolorType.FRONTFACING,
    FalsecolorType.EMISSION, FalsecolorType.ROUGHNESS, FalsecolorType.METALLIC,
)
_MATERIAL_AOVS = (
    FalsecolorType.ALBEDO, FalsecolorType.EMISSION, FalsecolorType.ROUGHNESS,
    FalsecolorType.METALLIC, FalsecolorType.OPACITY, FalsecolorType.IS_DELTA,
)


def _id_of(scene, hit, kind: str):
    """The debug AOVs' id of each hit ("mat", "inst" or "tri"). Two-level
    scenes index the mesh-space soup through the global (instance x
    superleaf) id; world-soup scenes read the per-triangle columns."""

    tri = hit.tri.long()
    if scene.two_level:
        gsl = tri // scene.sl_stride
        inst = scene.gsl_inst[gsl]
        if kind == "inst":
            return inst
        if kind == "mat":
            return scene.inst_mat[inst.long()]
        mtri = scene.gsl_msl[gsl].long() * scene.sl_stride + tri % scene.sl_stride
        return scene.wt_tri[mtri]
    return {"mat": scene.wt_mat, "inst": scene.wt_inst, "tri": scene.wt_tri}[kind][tri]


def _hash_color(idx) -> v3.V3:
    """hash_color (pathtracer.wgsl:546-573): three sequential PCG words,
    each converted to f32 with one rounding to nearest, over 4294967295.0
    (2^32 in f32)."""

    state = rng_mod.as_u32(idx)
    outs = []
    for _ in range(3):
        state, w = rng_mod.next_u32(state)
        outs.append(w.to(torch.float32) / 4294967295.0)
    return v3.V3(*outs)


def _falsecolor_sample(scene, ctx, ro, rd, state, fc_type: int):
    """One AOV sample per lane (renderer.py:420-478); misses are black."""

    B = ro.x.shape[0]
    if fc_type in _ALPHA_SKIP_AOVS:
        hit, attrs, state = integrators.ray_skip_alpha(
            scene, ctx, ro, rd, state,
            torch.ones(B, dtype=torch.bool, device=ro.x.device))
    else:
        hit, attrs = intersect.closest_hit_attrs(scene, ro, rd, ctx["eps"],
                                                 W=ctx["W"])
    if fc_type in _MATERIAL_AOVS:
        mp = get_material_point(scene, hit, attrs)

    def gray(s_):
        return v3.V3(s_, s_, s_)

    if fc_type == FalsecolorType.ALBEDO:
        col = mp.color
    elif fc_type == FalsecolorType.NORMALS:
        col = compute_shading_normal(scene, hit, attrs)
    elif fc_type == FalsecolorType.NORMALS_UNSIGNED:
        col = compute_shading_normal(scene, hit, attrs) * 0.5 + 0.5
    elif fc_type == FalsecolorType.FRONTFACING:
        col = gray((~hit.backside).to(torch.float32))
    elif fc_type == FalsecolorType.EMISSION:
        col = mp.emission
    elif fc_type == FalsecolorType.ROUGHNESS:
        col = gray(mp.roughness)
    elif fc_type == FalsecolorType.METALLIC:
        col = gray(mp.metallic)
    elif fc_type == FalsecolorType.OPACITY:
        col = gray(mp.opacity)
    elif fc_type == FalsecolorType.MAT_TYPE:
        col = _hash_color(_id_of(scene, hit, "mat"))
    elif fc_type == FalsecolorType.IS_DELTA:
        col = gray(is_mat_delta(mp).to(torch.float32))
    elif fc_type == FalsecolorType.INSTANCE:
        col = _hash_color(_id_of(scene, hit, "inst"))
    elif fc_type == FalsecolorType.TRI:
        col = _hash_color(_id_of(scene, hit, "tri"))
    else:
        col = 0.0
    return v3.where(hit.hit, col, 0.0), state


def _camera_rays(gx, gy, W, H, cam, is_ortho, state):
    """(state, ro, rd) of one jittered camera ray per lane."""

    return integrators._camera_ray_from(
        dict(cam=cam, is_ortho=is_ortho, gx=gx, gy=gy,
             resolution=(float(W), float(H))), state)


def _render_falsecolor(scene, image, cam, origin_x, origin_y, accum_counter,
                       rng_seed, ray_epsilon, tile_wh, spp, fc_type, is_ortho,
                       accumulate):
    """spp AOV samples of a tile, sample s from init_state(pixel, accum,
    seed, s) (renderer.py:486-535)."""

    H, W = image.shape[:2]
    tw, th = tile_wh
    gx, gy = _pixel_batch(tw, th, origin_x, origin_y, image.device)
    pixel_idx = gy * W + gx
    ctx = integrators.make_ctx(scene, ray_epsilon)
    acc = v3.zeros(tw * th, image.device)
    for s in range(spp):
        state = rng_mod.init_state(pixel_idx, accum_counter, rng_seed, s)
        state, ro, rd = _camera_rays(gx, gy, W, H, cam, is_ortho, state)
        col, _ = _falsecolor_sample(scene, ctx, ro, rd, state, fc_type)
        acc = acc + col
    color = v3.to_rows(acc / float(spp))
    return _accumulate_and_store(image, color, gx, gy, accum_counter,
                                 accumulate, full_frame=(tw, th) == (W, H))


def pathtrace_scene_falsecolor(scene, image, desc: PathtraceDesc,
                               baked: BakedPathtraceParams,
                               falsecolor_type: FalsecolorType):
    """Renders spp samples of one AOV into `image` (renderer.rs:872-948)
    and returns the new image."""

    scene, tile_wh, (tx, ty) = _dispatch_setup(scene, image, desc, baked)
    return _render_falsecolor(
        scene, image, _camera_args(desc), tx, ty,
        int(desc.accum_params.counter), int(desc.advanced.rng_seed),
        float(np.float32(desc.advanced.ray_epsilon)), tile_wh=tile_wh,
        spp=int(baked.samples_per_pixel), fc_type=int(falsecolor_type),
        is_ortho=bool(desc.camera_params.is_orthographic),
        accumulate=bool(desc.accum_params.accumulate),
    )


# ---------------------------------------------------------------------------
# Debug heatmaps (renderer.py:571-722; renderer.rs:966-1040,
# pathtracer.wgsl:457-502, :2806-2874)
# ---------------------------------------------------------------------------


def _select(conds, choices, default):
    """jnp.select: the choice of the first true condition, else default."""

    out = default
    for c, v in reversed(list(zip(conds, choices))):
        out = torch.where(c, v, out)
    return out


def get_heatmap_color(val, lo, hi):
    """Wavelength heatmap (pathtracer.wgsl:2806-2874) of (B,) values over
    [lo, hi]; returns (B, 3). lo and hi are taken as float32."""

    lo = torch.tensor(np.float32(lo), device=val.device)
    hi = torch.tensor(np.float32(hi), device=val.device)
    wl = 380.0 + 370.0 * torch.clamp_min(val - lo, 0.0) / torch.clamp_min(
        hi - lo, 1e-20)
    z = torch.zeros_like(wl)
    o = torch.ones_like(wl)
    bands = [wl <= 380.0, wl <= 440.0, wl <= 490.0, wl <= 510.0, wl <= 580.0,
             wl <= 645.0, wl <= 780.0]
    r = _select(bands, [z, -(wl - 440.0) / 60.0 / 3.0, z, z,
                        (wl - 510.0) / 70.0, o, o], o)
    g = _select(bands, [z, z, (wl - 440.0) / 50.0, o, o,
                        -(wl - 645.0) / 65.0, z], o)
    b = _select(bands[:5], [z, 0.8 * o, o, -(wl - 510.0) / 20.0, z], z)
    color = torch.stack([r, g, b], dim=-1)
    factor = _select(
        [wl < 420.0, wl < 701.0, wl < 781.0],
        [0.3 + 0.7 * (wl - 380.0) / 40.0, o, 0.3 + 0.7 * (780.0 - wl) / 80.0],
        o,
    )
    return torch.pow(torch.clamp_min(factor[..., None] * color, 0.0), 0.8)


DEBUG_MODES = ("tri_checks", "aabb_checks", "bounces")


def _render_debug(scene, image, cam, origin_x, origin_y, accum_counter,
                  rng_seed, ray_epsilon, heatmap_min, heatmap_max, tile_wh,
                  mode, max_bounces, is_ortho, accumulate):
    """One camera ray per pixel and its heatmap (renderer.py:629-689):
    the tri or AABB tests of its closest-hit query (count_traversal), or
    the bounces of one STANDARD path without regeneration."""

    if mode not in DEBUG_MODES:
        raise ValueError(f"debug mode {mode!r} is not one of {DEBUG_MODES}")
    H, W = image.shape[:2]
    tw, th = tile_wh
    gx, gy = _pixel_batch(tw, th, origin_x, origin_y, image.device)
    pixel_idx = gy * W + gx
    ctx = integrators.make_ctx(scene, ray_epsilon)
    state = rng_mod.init_state(pixel_idx, accum_counter, rng_seed, 0)
    state, ro, rd = _camera_rays(gx, gy, W, H, cam, is_ortho, state)
    if mode == "bounces":
        _, _, n_bounces, _ = integrators.pathtrace(
            scene, ctx, ro, rd, state, int(PathtraceType.STANDARD), max_bounces)
        val = n_bounces
    else:
        tri_checks, aabb_checks = intersect.count_traversal(
            scene, ro, rd, ray_epsilon)
        val = tri_checks if mode == "tri_checks" else aabb_checks
    color = get_heatmap_color(val.to(torch.float32), heatmap_min, heatmap_max)
    return _accumulate_and_store(image, color, gx, gy, accum_counter,
                                 accumulate, full_frame=(tw, th) == (W, H))


def pathtrace_scene_debug(scene, image, desc: PathtraceDesc,
                          baked: BakedPathtraceParams, mode: str = "tri_checks",
                          heatmap_min: float = 0.0, heatmap_max: float = 10.0):
    """Renders a debug heatmap ("tri_checks", "aabb_checks" or "bounces")
    into `image` (renderer.rs:966-1040) and returns the new image."""

    scene, tile_wh, (tx, ty) = _dispatch_setup(scene, image, desc, baked)
    return _render_debug(
        scene, image, _camera_args(desc), tx, ty,
        int(desc.accum_params.counter), int(desc.advanced.rng_seed),
        float(np.float32(desc.advanced.ray_epsilon)), heatmap_min, heatmap_max,
        tile_wh=tile_wh, mode=mode, max_bounces=int(baked.max_bounces),
        is_ortho=bool(desc.camera_params.is_orthographic),
        accumulate=bool(desc.accum_params.accumulate),
    )


def new_accumulation_buffer(width: int, height: int, device="cuda"):
    """Fresh float32 (H, W, 3) render target on `device`."""

    device = resolve_device(device)
    return torch.zeros((height, width, 3), dtype=torch.float32, device=device)


def render_progressive(scene, desc: PathtraceDesc, baked: BakedPathtraceParams,
                       width: int, height: int, accumulations: int,
                       progress: bool = False, device="cuda",
                       stats: dict | None = None):
    """Headless accumulation loop (lupin_examples/src/example1.rs:39-53) on
    `device` (the scene is moved there if needed); returns a numpy image.
    `stats` is passed to every pathtrace_scene call."""

    device = resolve_device(device)
    if scene.device != device:
        scene = scene.to(device)
    image = new_accumulation_buffer(width, height, device)
    for i in range(accumulations):
        desc.accum_params.accumulate = True
        desc.accum_params.counter = i
        image = pathtrace_scene(scene, image, desc, baked, stats)
        if progress and (i % 10 == 0 or i == accumulations - 1):
            print(f"  accumulation {i + 1}/{accumulations}", flush=True)
    return image.cpu().numpy()
