"""Kernel B3: the fused dense path-tracing megakernel.

The counterpart of lupinpathtracer_tpu/kernels/pallas_mega.py. One launch
runs all spp samples of every pixel of a batch to completion: camera rays,
dense closest hit with the winner's attribute row, materials, the smooth
BSDF lobes, the 50/50 BSDF/light mix (STANDARD) or BSDF-only sampling
(NAIVE), Russian roulette, radiance clamping and in-place regeneration
(csrc/mega.cu). Its plain version is the port's wavefront loop,
render/integrators.pathtrace_spp, with the same PCG streams and draw order,
which the wrapper runs for tensors on the CPU.

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

import torch

from ..core import trace
from ..core.device import on_cpu
from ..core.types import PathtraceType

# Kernel launches (counted only where the kernel is launched).
LAUNCHES = {"mega_pathtrace_spp": 0}

MAX_LIGHT_TRIS = 64
LIGHT_COLS = 12  # csrc/mega.cu: v0.xyz, area, e1.xyz, 0, e2.xyz, 0


def applicable(scene, ptype: int) -> bool:
    """Static gate (pallas_mega.py:76-92)."""

    return (
        not scene.use_bvh
        and not scene.instances_empty
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
    )


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


def _launch(scene, W4, pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            eps, sample_offset, lib=None):
    """The kernel's launch, through `lib` if given (another build of
    csrc/mega.cu: tools/prof_mega.py's occupancy sweep); up to the launch
    call's return, the `b3.launch` span of core/trace.py."""

    with trace.span("b3.launch"):
        from ..core.vec3 import V3
        from ..render.camera import camera_scalars
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
        Wp, lt = pair_table(W4), _light_table(scene)
        A = scene.wt_attr.contiguous()
        c = camera_scalars(cam["cam_transform"], cam["lens"], cam["film"],
                           cam["aspect"], cam["focus"], cam["aperture"], resolution)
        nl = 0 if scene.lights_empty else scene.num_lights
        p = _Params(
            cam=(ctypes.c_float * 12)(*[v for row in c["m"] for v in row]),
            lens=c["lens"], film_w=c["film_w"], film_h=c["film_h"],
            focus=c["focus"], aperture=c["aperture"], res_x=c["res_x"],
            res_y=c["res_y"], eps=float(eps), max_radiance=float(max_radiance),
            ortho_scale=c["ortho_scale"],
            accum=int(accum_counter) & 0xFFFFFFFF, seed=int(rng_seed) & 0xFFFFFFFF,
            sample_offset=int(sample_offset), spp=int(spp),
            max_bounces=int(max_bounces),
            use_nee=int(int(ptype) == int(PathtraceType.STANDARD)),
            is_ortho=int(bool(is_ortho)), n_tris=T, a_stride=A.shape[1],
            num_lights=nl, n_light_tris=lt.shape[0] if nl else 0,
            type_mask=sum(1 << t for t in scene.present_mat_types),
            n_pix=pixel_idx.shape[0],
        )
        tabs = [scene.la_thresh.contiguous(), scene.la_alias.contiguous(),
                scene.light_alias_offset.contiguous(),
                scene.light_alias_size.contiguous(),
                scene.light_tri_offset.contiguous()]
        B = pixel_idx.shape[0]
        acc = [torch.empty(B, dtype=torch.float32, device=dev) for _ in range(3)]
        n_traced = torch.empty(B, dtype=torch.int32, device=dev)
        if lib is None:
            lib = cuda_build.load("mega")
        fn = lib.lupin_mega_pathtrace
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 16
        if B > 0:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = fn(ctypes.byref(p), pixel_idx.contiguous().data_ptr(),
                        gx.contiguous().data_ptr(), gy.contiguous().data_ptr(),
                        Wp.data_ptr(), A.data_ptr(), lt.data_ptr(),
                        *[t.data_ptr() for t in tabs],
                        *[a.data_ptr() for a in acc], n_traced.data_ptr(), stream)
    if B > 0:
        cuda_build.check(rc, "mega_pathtrace_spp")
        LAUNCHES["mega_pathtrace_spp"] += 1
    return V3(*acc), n_traced
