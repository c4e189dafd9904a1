"""Kernel B3: the fused dense path-tracing megakernel.

The counterpart of lupinpathtracer_tpu/kernels/pallas_mega.py. One launch
runs all spp samples of every pixel of a batch to completion: camera rays,
dense closest hit with the winner's attribute row, materials, the smooth
BSDF lobes, the 50/50 BSDF/light mix (STANDARD) or BSDF-only sampling
(NAIVE), Russian roulette, radiance clamping and in-place regeneration
(csrc/mega.cu). Its plain version is the port's wavefront loop,
render/integrators.pathtrace_spp, with the same PCG streams and draw order,
which the wrapper runs for tensors on the CPU.

Two modes of the one kernel, chosen by the caller: `mega_pathtrace_spp`
(the acc mode) takes pixel arrays and returns each lane's sample sum and
n_traced; `mega_dispatch` (the dispatch mode) is a whole dense render
dispatch in one launch, from the tile's pixel ids to the stored image and
the segment count, the route render/renderer.py takes on the card.

The kernel reads two tables packed for 16-byte loads, each built once: the
coefficient matrix in groups of four triangles (kernels/bvh.py::pair_table,
B6's layout, kept on the matrix) and the light triangles' geometry with
their light's area (`pack_light_table`, kept on the scene).

`applicable` is the JAX package's static gate: every feature the kernel
does not implement must be statically absent; scenes outside it take the
wavefront route.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import trace
from ..core.device import on_cpu
from ..core.types import PathtraceType

# Kernel launches (counted only where the kernel is launched):
# "mega_pathtrace_spp" every B3 launch of either mode, "mega_dispatch" those
# of the dispatch mode.
LAUNCHES = {"mega_pathtrace_spp": 0, "mega_dispatch": 0}

MAX_LIGHT_TRIS = 64
LIGHT_COLS = 12  # csrc/shade_common.cuh: v0.xyz, area, e1.xyz, 0, e2.xyz, 0


def in_gate(scene, ptype: int) -> bool:
    """The features B3's per-lane code implements (csrc/shade_common.cuh),
    all the scene and integrator may use: STANDARD or NAIVE, no alpha,
    environments, volumes, delta materials, normal maps, vertex colours or
    uv textures, at most MAX_LIGHT_TRIS light triangles. B3 (`applicable`)
    and the BVH route's shading step (kernels/shade.py) share it."""

    return (
        not scene.instances_empty
        and not scene.has_alpha
        and scene.envs_empty
        and not scene.any_volumetric
        and not scene.any_delta
        and not scene.any_normal_maps
        and not scene.any_vert_colors
        and not (scene.num_textures > 0 and scene.any_uv)
        and int(ptype) in (int(PathtraceType.STANDARD), int(PathtraceType.NAIVE))
        and (scene.lights_empty or scene.lt_v0.shape[1] <= MAX_LIGHT_TRIS)
    )


def applicable(scene, ptype: int) -> bool:
    """Static gate (pallas_mega.py:76-92): a dense scene inside in_gate."""

    return not scene.use_bvh and in_gate(scene, ptype)


class _Params(ctypes.Structure):
    """Mirror of `Params` in csrc/mega.cu."""

    _fields_ = (
        [("cam", ctypes.c_float * 12)]
        + [(n, ctypes.c_float) for n in (
            "lens", "film_w", "film_h", "focus", "aperture", "res_x", "res_y",
            "eps", "max_radiance", "ortho_scale")]
        + [("accum", ctypes.c_uint32), ("seed", ctypes.c_uint32)]
        + [(n, ctypes.c_int) for n in (
            "sample_offset", "spp", "max_bounces", "use_nee", "is_ortho",
            "n_tris", "a_stride", "num_lights", "n_light_tris", "type_mask",
            "n_pix")]
        + [(n, ctypes.c_float) for n in ("inv_spp", "keep", "weight")]
        + [(n, ctypes.c_int) for n in (
            "tile_x", "tile_y", "tile_w", "img_w", "img_h", "swizzle", "blend")]
    )


def bind(lib):
    """Declares the entry points' signatures on a loaded build of
    csrc/mega.cu, once: cuda_build.load calls it where it opens the
    library, the variant tools on their copies. Returns `lib`."""

    lib.lupin_mega_pathtrace.restype = ctypes.c_int
    lib.lupin_mega_pathtrace.argtypes = [ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 16
    lib.lupin_mega_dispatch.restype = ctypes.c_int
    lib.lupin_mega_dispatch.argtypes = [ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 13
    return lib


def pack_light_table(scene):
    """(Tl, LIGHT_COLS) f32: per light triangle v0, its light's area, e1,
    0, e2, 0 (the arrays lights.py reads: lt_v0/lt_e1/lt_e2 and
    light_area[lt_light])."""

    area = scene.light_area[scene.lt_light.long()].to(torch.float32)
    z = torch.zeros_like(area)
    cols = [*scene.lt_v0, area, *scene.lt_e1, z, *scene.lt_e2, z]
    return torch.stack([c.to(torch.float32) for c in cols], dim=1).contiguous()


def _light_table(scene):
    """pack_light_table(scene), built once per scene and kept on it."""

    table = scene.__dict__.get("_mega_light_table")
    if table is None:
        table = scene.__dict__["_mega_light_table"] = pack_light_table(scene)
    return table


def mega_pathtrace_spp(
    scene, W4, pixel_idx, gx, gy, resolution, cam, is_ortho: bool,
    accum_counter, rng_seed, spp: int, ptype: int, max_bounces: int,
    max_radiance, eps, sample_offset: int = 0,
):
    """Drop-in replacement for integrators.pathtrace_spp on scenes passing
    `applicable`. Returns (acc V3 summed over spp, n_traced i32)."""

    from ..render import integrators

    if not applicable(scene, ptype):
        raise ValueError("scene/integrator outside the megakernel gate")
    B = pixel_idx.shape[0]
    for name, x in (("pixel_idx", pixel_idx), ("gx", gx), ("gy", gy)):
        if x.shape != (B,) or x.dtype != torch.int32:
            raise TypeError(f"{name} must be (B,) int32")
    if on_cpu(W4):
        ctx = integrators.make_ctx(scene, eps)
        ctx["W"] = W4
        return integrators.pathtrace_spp(
            scene, ctx, pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            sample_offset=sample_offset,
        )
    return _launch(scene, W4, pixel_idx, gx, gy, resolution, cam, is_ortho,
                   accum_counter, rng_seed, spp, ptype, max_bounces,
                   max_radiance, eps, sample_offset)


def light_tables(scene):
    """(tensors, pointers) of the light tables B3 and the BVH route's
    shading step read, built once and kept on the scene: the packed light
    table and the alias tables, contiguous, in the entry points' order."""

    cached = scene.__dict__.get("_light_tables")
    if cached is None:
        tabs = [_light_table(scene), scene.la_thresh.contiguous(),
                scene.la_alias.contiguous(), scene.light_alias_offset.contiguous(),
                scene.light_alias_size.contiguous(),
                scene.light_tri_offset.contiguous()]
        cached = scene.__dict__["_light_tables"] = (tabs, [t.data_ptr() for t in tabs])
    return cached


def _tables(scene):
    """(tensors, pointers) of B3's per-scene tables, built once and kept on
    the scene: the attribute rows, then light_tables."""

    cached = scene.__dict__.get("_mega_tables")
    if cached is None:
        tabs, ptrs = light_tables(scene)
        attr = scene.wt_attr.contiguous()
        cached = scene.__dict__["_mega_tables"] = ([attr, *tabs], [attr.data_ptr(), *ptrs])
    return cached


def _base_params(scene, resolution, cam, is_ortho, spp, ptype, max_bounces,
                 max_radiance, eps, n_pix, sample_offset=0):
    """Params of a launch with the counter and seed at 0 and the dispatch
    mode's fields unset."""

    from ..render.camera import camera_scalars

    lt = light_tables(scene)[0][0]
    c = camera_scalars(cam["cam_transform"], cam["lens"], cam["film"],
                       cam["aspect"], cam["focus"], cam["aperture"], resolution)
    nl = 0 if scene.lights_empty else scene.num_lights
    return _Params(
        cam=(ctypes.c_float * 12)(*[v for row in c["m"] for v in row]),
        lens=c["lens"], film_w=c["film_w"], film_h=c["film_h"],
        focus=c["focus"], aperture=c["aperture"], res_x=c["res_x"],
        res_y=c["res_y"], eps=float(eps), max_radiance=float(max_radiance),
        ortho_scale=c["ortho_scale"], sample_offset=int(sample_offset),
        spp=int(spp), max_bounces=int(max_bounces),
        use_nee=int(int(ptype) == int(PathtraceType.STANDARD)),
        is_ortho=int(bool(is_ortho)), n_tris=scene.num_world_tris,
        a_stride=scene.wt_attr.shape[1], num_lights=nl,
        n_light_tris=lt.shape[0] if nl else 0,
        type_mask=sum(1 << t for t in scene.present_mat_types), n_pix=int(n_pix),
    )


def _launch(scene, W4, pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            eps, sample_offset, lib=None):
    """The acc mode's launch, through `lib` if given (another build of
    csrc/mega.cu: tools/prof_mega.py's occupancy sweep); up to the launch
    call's return, the `b3.launch` span of core/trace.py."""

    with trace.span("b3.launch"):
        from ..core.vec3 import V3
        from . import cuda_build
        from .bvh import pair_table

        dev = W4.device
        for x in (pixel_idx, gx, gy, scene.wt_attr):
            if x.device != dev:
                raise ValueError("all inputs must be on the scene's device")
        if W4.dtype != torch.float32:
            raise TypeError("W4 must be float32")
        T = scene.num_world_tris
        if W4.shape != (4, 10, T):
            raise ValueError(f"W4 must be (4, 10, {T}), got {tuple(W4.shape)}")
        Wp = pair_table(W4)
        _, ptrs = _tables(scene)
        B = pixel_idx.shape[0]
        p = _base_params(scene, resolution, cam, is_ortho, spp, ptype,
                         max_bounces, max_radiance, eps, B, sample_offset)
        p.accum = int(accum_counter) & 0xFFFFFFFF
        p.seed = int(rng_seed) & 0xFFFFFFFF
        acc = [torch.empty(B, dtype=torch.float32, device=dev) for _ in range(3)]
        n_traced = torch.empty(B, dtype=torch.int32, device=dev)
        lib = cuda_build.load("mega", bind) if lib is None else bind(lib)
        if B > 0:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.lupin_mega_pathtrace(
                    ctypes.byref(p), pixel_idx.contiguous().data_ptr(),
                    gx.contiguous().data_ptr(), gy.contiguous().data_ptr(),
                    Wp.data_ptr(), *ptrs, *[a.data_ptr() for a in acc],
                    n_traced.data_ptr(), stream)
    if B > 0:
        cuda_build.check(rc, "mega_pathtrace_spp")
        LAUNCHES["mega_pathtrace_spp"] += 1
    return V3(*acc), n_traced


# The dispatch mode's lane order: 16x16 tiles (render/renderer.py
# _SWIZZLE_TILE; csrc/mega.cu lane_pixel).
SWIZZLE = 16

# The segment count's two slots per (device, stream), zeroed once: a counted
# dispatch adds into one and zeroes the other, which the stream's next
# counted dispatch adds into, so no launch zeroes a count. [the slots' two
# 0-dim views, the slot the next count uses].
_COUNTS: dict = {}


def dispatch_fields(image_shape, tile_wh, origin) -> dict:
    """The tile's Params fields of the dispatch mode: its lanes run
    render/renderer.py::_pixel_batch's order, 16x16-swizzled where both
    tile dims are multiples of SWIZZLE, else row-major. The kernel indexes
    pixels and lanes in i32: an image or tile of 2**31 pixels or more
    raises."""

    H, W = image_shape[:2]
    tw, th = int(tile_wh[0]), int(tile_wh[1])
    if max(H * W, tw * th) >= 2**31:
        raise ValueError(f"{W}x{H} image, {tw}x{th} tile: the dispatch mode "
                         "indexes pixels in int32")
    return dict(tile_x=int(origin[0]), tile_y=int(origin[1]), tile_w=tw,
                img_w=int(W), img_h=int(H),
                swizzle=int(tw % SWIZZLE == 0 and th % SWIZZLE == 0), n_pix=tw * th)


def mega_dispatch(scene, image, cam, is_ortho, origin, tile_wh, accum_counter,
                  rng_seed, spp, ptype, max_bounces, max_radiance, eps,
                  accumulate, count):
    """A dense render dispatch as one B3 launch (render/renderer.py's route
    on the card for scenes inside the gate): the tile's pixels in
    _pixel_batch's order, each stored into a new image as
    _accumulate_and_store stores it. `image`, a CUDA (H, W, 3) float32
    image, is not written. Returns (the new image, the dispatch's traced
    segments as an int64 device scalar where `count`, else None: a slot
    that the stream's second counted dispatch after this one reuses, so
    read it before then). The `b3.launch` span of core/trace.py.

    What does not change between dispatches of one view is built once and
    kept on the scene: the tables (_tables) and the Params of the last
    (camera, shape, settings), so that per dispatch only the counter, the
    seed, the blend and the output pointers are set."""

    with trace.span("b3.launch"):
        from . import cuda_build
        from .bvh import pair_table
        from .intersect import scene_tri_matrix

        if not applicable(scene, ptype):
            raise ValueError("scene/integrator outside the megakernel gate")
        if image.dtype != torch.float32:
            raise TypeError(f"the image must be float32, got {image.dtype}")
        dev = image.device
        H, W = image.shape[:2]
        Wp = pair_table(scene_tri_matrix(scene))
        _, ptrs = _tables(scene)
        key = (cam["cam_transform"].tobytes(), cam["lens"], cam["film"],
               cam["aspect"], cam["focus"], cam["aperture"], bool(is_ortho),
               tuple(image.shape), tuple(tile_wh), tuple(origin), int(spp),
               int(ptype), int(max_bounces), float(max_radiance), float(eps))
        plan = scene.__dict__.get("_mega_plan")
        if plan is None or plan[0] != key:
            fields = dispatch_fields(image.shape, tile_wh, origin)
            base = _base_params(scene, (float(W), float(H)), cam, is_ortho, spp,
                                ptype, max_bounces, max_radiance, eps,
                                fields.pop("n_pix"))
            for name, v in fields.items():
                setattr(base, name, v)
            base.inv_spp = float(np.float32(1.0) / np.float32(spp))
            plan = scene.__dict__["_mega_plan"] = (key, base)
        p = _Params.from_buffer_copy(plan[1])
        p.accum = int(accum_counter) & 0xFFFFFFFF
        p.seed = int(rng_seed) & 0xFFFFFFFF
        weight = np.float32(1.0) / np.float32(max(accum_counter, 1))
        p.keep, p.weight = float(np.float32(1.0) - weight), float(weight)
        p.blend = int(bool(accumulate) and accum_counter != 0)
        image = image.contiguous()
        full = (p.tile_x, p.tile_y, p.tile_w, p.n_pix) == (0, 0, W, W * H)
        out = torch.empty_like(image) if full else image.clone()
        lib = cuda_build.load("mega", bind)
        if p.n_pix == 0:
            return out, torch.zeros((), dtype=torch.int64, device=dev) if count else None
        total = clear = None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if count:
                slots = _COUNTS.get((dev.index, stream))
                if slots is None:
                    slots = _COUNTS[(dev.index, stream)] = [
                        tuple(torch.zeros(2, dtype=torch.int64, device=dev)), 0]
                total, clear = slots[0][slots[1]], slots[0][1 - slots[1]]
            rc = lib.lupin_mega_dispatch(
                ctypes.byref(p), Wp.data_ptr(), *ptrs, image.data_ptr(),
                out.data_ptr(), None if total is None else total.data_ptr(),
                None if clear is None else clear.data_ptr(), stream)
    cuda_build.check(rc, "mega_dispatch")
    if count:
        # The slots turn only after a launch: one that failed added and
        # zeroed nothing, so the next count adds into this slot, still zero.
        slots[1] = 1 - slots[1]
    LAUNCHES["mega_pathtrace_spp"] += 1
    LAUNCHES["mega_dispatch"] += 1
    return out, total
