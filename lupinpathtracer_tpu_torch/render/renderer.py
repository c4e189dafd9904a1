"""Render dispatch API: progressive path tracing with accumulation and tiling.

The counterpart of the pathtrace half of lupinpathtracer_tpu/render/renderer.py
(the reference's pathtrace_scene, renderer.rs:768-842; the progressive blend,
pathtracer.wgsl:279-288). A dispatch renders one tile (or the whole frame)
as one flat ray batch. Scenes that pass the megakernel gate run through
kernel B3 (kernels/mega.py); the rest through the wavefront loop
(render/integrators.py): dense scenes with kernel B2, BVH scenes,
single-level and two-level (instanced), with kernels B4 (camera rays) and
B5/B6/B7 (bounces).

Not ported yet, and raising NotImplementedError: the MIS integrator
(ROADMAP.md Queue A item 5), the falsecolor and debug dispatches (item 10).
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..core import vec3 as v3
from ..core.device import resolve_device
from ..core.types import (
    BakedPathtraceParams,
    PathtraceDesc,
    PathtraceType,
    get_num_tiles,
)
from ..kernels import mega
from . import integrators

AOV_TODO = ("the falsecolor and debug dispatches are not ported yet: "
            "ROADMAP.md Queue A item 10")


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
    H, W = image.shape[:2]
    tw, th = tile_wh
    gx, gy = _pixel_batch(tw, th, origin_x, origin_y, image.device)
    pixel_idx = gy * W + gx
    resolution = (float(W), float(H))
    ctx = integrators.make_ctx(scene, ray_epsilon)

    # All spp in one wavefront with in-place path regeneration; scenes
    # inside the gate take the fused megakernel (on the CPU its plain
    # version is that same wavefront loop).
    if mega.applicable(scene, ptype):
        acc, n_traced = mega.mega_pathtrace_spp(
            scene, ctx["W"], pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            ray_epsilon,
        )
    else:
        acc, n_traced = integrators.pathtrace_spp(
            scene, ctx, pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
        )
    if stats is not None:
        stats["rays"] = stats.get("rays", 0) + int(n_traced.sum())
    color = v3.to_rows(acc / float(spp))
    return _accumulate_and_store(image, color, gx, gy, accum_counter,
                                 accumulate, full_frame=(tw, th) == (W, H))


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

# Self-bounding dispatch (renderer.py:358-380): without explicit tiling, a
# BVH frame whose rays x superleaf stride exceeds this budget is split into
# square tiles (largest power of two from 1024 down to the floor).
DISPATCH_RAY_STRIDE_BUDGET = 700_000_000
DISPATCH_TILE_FLOOR = 128


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
    device-to-host sync per dispatch, so leave it None otherwise."""

    if int(desc.pathtrace_type) == int(PathtraceType.MIS):
        raise NotImplementedError(integrators.MIS_TODO)
    if image.device != scene.device:
        raise ValueError(f"image on {image.device}, scene on {scene.device}")
    _runtime_checks(scene, baked)
    scene = _select_backend(scene, desc)
    tile_wh, (tx, ty) = _tile_geometry(image.shape, desc)

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
        stride = max(int(scene.sl_stride), 1)
        if W * H * stride > DISPATCH_RAY_STRIDE_BUDGET:
            ts = 1024
            while (ts > DISPATCH_TILE_FLOOR
                   and ts * ts * stride > DISPATCH_RAY_STRIDE_BUDGET):
                ts //= 2
            nx, ny = get_num_tiles(W, H, ts)
            for idx in range(nx * ny):
                tx, ty = (idx % nx) * ts, (idx // nx) * ts
                image = one((min(ts, W - tx), min(ts, H - ty)), tx, ty, image)
            return image
    return one(tile_wh, tx, ty, image)


def pathtrace_scene_falsecolor(scene, image, desc, baked, falsecolor_type):
    raise NotImplementedError(AOV_TODO)


def pathtrace_scene_debug(scene, image, desc, baked, mode="tri_checks",
                          heatmap_min=0.0, heatmap_max=10.0):
    raise NotImplementedError(AOV_TODO)


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
