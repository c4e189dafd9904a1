"""Path-tracing integrators: standard, naive and direct.

The counterpart of lupinpathtracer_tpu/render/integrators.py (the
reference's pathtrace_standard :588-733, pathtrace_naive :942-1059 and
pathtrace_direct :1062-1245 in pathtracer.wgsl). The whole ray batch
advances together; every divergence point (miss, delta vs smooth, in-volume
vs surface, Russian roulette, zero-direction death) is an `alive` or branch
mask, and the JAX package's `lax.while_loop` is a Python loop. The same
semantics are kept exactly: the 50/50 one-sample BSDF/light mix
(pathtracer.wgsl:640-658), the one-slot volume "stack" toggle (:667-681),
Russian roulette after bounce 3 (:724-729), the stochastic alpha skip
(bvh_custom.wgsl:154-180), in-place path regeneration, and the same PCG
streams and draw order, so results match the JAX package lane by lane.

The MIS integrator (`_pathtrace_mis`) is not ported yet (ROADMAP.md Queue A
item 5).
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..core import vec3 as v3
from ..core.types import MAX_OPACITY_BOUNCES, PathtraceType
from ..core.vec3 import V3
from ..kernels import intersect
from . import bsdf, lights
from .camera import compute_camera_ray
from .materials import (
    compute_shading_normal,
    get_emission,
    get_material_point,
    get_opacity,
    is_mat_delta,
    is_mat_volumetric,
)

MIS_TODO = "the MIS integrator is not ported yet: ROADMAP.md Queue A item 5"


def make_ctx(scene, eps):
    """Per-render precomputation: the triangle coefficient matrix (dense
    scenes and the superleaf wavefront both use it) and, for many light
    triangles, the light-triangle matrix of the pdf pass."""

    W = (None if scene.use_bvh and scene.sl_count == 0
         else intersect.scene_tri_matrix(scene))
    small_lights = scene.lt_v0.shape[1] <= lights.SMALL_LIGHT_TRIS
    Wl = (None if (scene.lights_empty or small_lights)
          else lights.light_tri_matrix(scene))
    return dict(eps=eps, W=W, Wl=Wl)


def _blend_attrs(mask, a, b):
    """Per-lane select of either attribute layout: the dense (AW, B) rows
    along their lane axis, an InterpAttrs leaf by leaf."""

    if isinstance(a, intersect.InterpAttrs):
        return a.map(lambda x, y: torch.where(mask, x, y), b)
    return torch.where(mask[None, :], a, b)


def ray_skip_alpha(scene, ctx, ro, rd, state, mask, active=None,
                   coherent=True):
    """ray_skip_alpha_stochastically (bvh_custom.wgsl:154-180): re-cast
    through lanes whose opacity test fails, accumulating distance. Opaque
    scenes (static has_alpha False) pay exactly one intersection.
    `coherent=False` marks a divergent bounce batch (BVH scenes then skip
    kernel B4 for the sort wavefront)."""

    hit, attrs = intersect.closest_hit_attrs(
        scene, ro, rd, ctx["eps"], W=ctx["W"], active=active,
        coherent=coherent,
    )
    if not scene.has_alpha:
        return hit, attrs, state

    op = get_opacity(scene, hit, attrs)
    state, r0 = rng_mod.next_f32(state)
    recast = mask & hit.hit & (op < 1.0) & (r0 >= op)
    ro_c = [torch.where(recast, o + d * hit.dst, o)
            for o, d in zip(ro, rd)]
    dst_acc = hit.dst
    i = 0
    while bool(recast.any()) and i < MAX_OPACITY_BOUNCES - 1:
        nh, nat = intersect.closest_hit_attrs(
            scene, V3(*ro_c), rd, ctx["eps"], W=ctx["W"], active=recast,
            coherent=coherent,
        )
        hit = nh.map(lambda a, b: torch.where(recast, a, b), hit)
        if attrs is not None:
            attrs = _blend_attrs(recast, nat, attrs)
        dst_acc = torch.where(recast, dst_acc + nh.dst, dst_acc)
        op2 = get_opacity(scene, hit, attrs)
        state, r = rng_mod.next_f32(state)
        recast2 = recast & hit.hit & (op2 < 1.0) & (r >= op2)
        ro_c = [torch.where(recast2, o + d * nh.dst, o)
                for o, d in zip(ro_c, rd)]
        recast = recast2
        i += 1
    # Distance stays relative to the ORIGINAL origin (bvh_custom.wgsl:176-178).
    hit.dst = dst_acc
    return hit, attrs, state


def _sample_surface_common(scene, ctx, mp, normal, outgoing, hit_pos, state,
                           use_nee):
    """Non-delta continuation direction + weight factor (the 50/50 mix of
    pathtracer.wgsl:640-658 with NEE, plain BSDF sampling otherwise)."""

    state, r_choice = rng_mod.next_f32(state)
    state, rnl = rng_mod.next_f32(state)
    state, rx, ry = rng_mod.next_vec2(state)
    types = scene.present_mat_types
    bdir = bsdf.sample_bsdfcos(mp, normal, outgoing, rnl, rx, ry, types)
    if use_nee:
        state, ldir = lights.sample_lights(scene, hit_pos, outgoing, state)
        incoming = v3.where(r_choice < 0.5, bdir, ldir)
        pdf = 0.5 * bsdf.sample_bsdfcos_pdf(
            mp, normal, outgoing, incoming, types
        ) + 0.5 * lights.sample_lights_pdf(
            scene, hit_pos, incoming, ctx["eps"], ctx["Wl"]
        )
    else:
        incoming = bdir
        pdf = bsdf.sample_bsdfcos_pdf(mp, normal, outgoing, incoming, types)
    dead = v3.all_zero(incoming)
    f = bsdf.eval_bsdfcos(mp, normal, outgoing, incoming, types)
    factor = f / torch.clamp_min(pdf, 0.0)
    return state, incoming, factor, dead


def _sample_volume_common(scene, ctx, vol_den, vol_sca, vol_aniso, outgoing,
                          hit_pos, state, use_nee):
    """In-volume continuation (pathtracer.wgsl:686-715)."""

    state, vr = rng_mod.next_f32(state)
    state, vx, vy = rng_mod.next_vec2(state)
    sdir = bsdf.sample_scattering(vol_den, vol_aniso, outgoing, vx, vy)
    if use_nee:
        state, ldir = lights.sample_lights(scene, hit_pos, outgoing, state)
        incoming = v3.where(vr < 0.5, sdir, ldir)
        pdf = 0.5 * bsdf.sample_scattering_pdf(
            vol_den, vol_aniso, outgoing, incoming
        ) + 0.5 * lights.sample_lights_pdf(
            scene, hit_pos, incoming, ctx["eps"], ctx["Wl"]
        )
    else:
        incoming = sdir
        pdf = bsdf.sample_scattering_pdf(vol_den, vol_aniso, outgoing, incoming)
    dead = v3.all_zero(incoming)
    f = bsdf.eval_scattering(vol_den, vol_sca, vol_aniso, outgoing, incoming)
    factor = f / torch.clamp_min(pdf, 0.0)
    return state, incoming, factor, dead


def _camera_ray_from(regen, state):
    """Fresh camera ray for a lane's next sample (the regen respawn)."""

    state, ox = rng_mod.next_f32(state)
    state, oy = rng_mod.next_f32(state)
    cam = regen["cam"]
    return compute_camera_ray(
        cam["cam_transform"], cam["lens"], cam["film"], cam["aspect"],
        cam["focus"], cam["aperture"], regen["is_ortho"], regen["gx"],
        regen["gy"], regen["resolution"], ox - 0.5, oy - 0.5, state,
    )


def pathtrace_spp(
    scene, ctx, pixel_idx, gx, gy, resolution, cam, is_ortho: bool,
    accum_counter, rng_seed, spp: int, ptype: int, max_bounces: int,
    max_radiance, sample_offset=0,
):
    """All spp samples of a pixel batch as ONE wavefront with path
    regeneration: a lane that finishes sample s respawns sample s+1 of its
    own pixel in place (integrators.py:241-304, streams=1). Returns
    (acc V3 = sum over spp of clamp_radiance(sample), n_traced)."""

    if ptype == PathtraceType.MIS:
        raise NotImplementedError(MIS_TODO)
    regen = dict(
        gx=gx, gy=gy, resolution=resolution, cam=cam, is_ortho=is_ortho,
        pixel_idx=pixel_idx, accum_counter=accum_counter, rng_seed=rng_seed,
        spp=spp, max_radiance=max_radiance, sample_offset=sample_offset,
    )
    state = rng_mod.init_state(pixel_idx, accum_counter, rng_seed, sample_offset)
    state, ro, rd = _camera_ray_from(regen, state)
    return _pathtrace_snd(scene, ctx, ro, rd, state, ptype, max_bounces, regen)


def _transmit(scene, vol_den, vol_len, alive, hit, weight, tr1, tr2):
    """Volume transmittance entry (pathtracer.wgsl:611-620)."""

    if scene.any_volumetric:
        in_med = alive & (vol_len > 0)
        vdst = bsdf.sample_transmittance(vol_den, hit.dst, tr1, tr2)
        t_w = bsdf.eval_transmittance(vol_den, vdst) / torch.clamp_min(
            bsdf.sample_transmittance_pdf(vol_den, vdst, hit.dst), 1e-30
        )
        weight = v3.where(in_med, weight * t_w, weight)
        in_volume = in_med & (vdst < hit.dst)
    else:
        vdst = hit.dst
        in_volume = torch.zeros_like(alive)
    return vdst, in_volume, weight


def _slice_attrs(attrs, lo, hi):
    if isinstance(attrs, intersect.InterpAttrs):
        return attrs.map(lambda a: a[lo:hi])
    return None if attrs is None else attrs[:, lo:hi]


def _pathtrace_snd(scene, ctx, ro, rd, state, ptype, max_bounces, regen):
    """Shared loop for STANDARD / NAIVE / DIRECT with path regeneration,
    one batched trace call per bounce (integrators.py:324-592). DIRECT adds
    slot B for its explicit light ray. The bounce counter is per lane and
    finished lanes respawn their pixel's next sample in place. (The JAX
    loop's non-regenerating mode serves only the debug dispatch, ROADMAP.md
    Queue A item 10.)"""

    B, dev = ro.x.shape[0], ro.x.device
    is_direct = ptype == PathtraceType.DIRECT
    use_nee = ptype in (PathtraceType.STANDARD, PathtraceType.DIRECT)
    has_light_ray = is_direct and not (scene.lights_empty and scene.envs_empty)
    types = scene.present_mat_types
    zeros = v3.zeros(B, dev)

    alive = torch.ones(B, dtype=torch.bool, device=dev)
    hit, attrs, state = ray_skip_alpha(scene, ctx, ro, rd, state, alive)

    bounce = torch.zeros(B, dtype=torch.int32, device=dev)
    weight = v3.full(B, 1.0, dev)
    radiance = zeros
    vol_den = zeros
    vol_sca = zeros
    vol_aniso = torch.zeros(B, dtype=torch.float32, device=dev)
    vol_len = torch.zeros(B, dtype=torch.int32, device=dev)
    next_emission = torch.ones(B, dtype=torch.bool, device=dev)
    n_traced = torch.ones(B, dtype=torch.int32, device=dev)
    sample_idx = torch.zeros(B, dtype=torch.int32, device=dev)
    acc = zeros

    while bool(alive.any()):
        entry_alive = alive

        # Miss: environment (direct gates on next_emission, :1075-1080).
        miss_m = alive & ~hit.hit
        if not scene.envs_empty:
            env = lights.sample_environments(scene, rd)
            env_mask = miss_m & next_emission if is_direct else miss_m
            radiance = radiance + v3.where(env_mask, weight * env, zeros)
        alive = alive & hit.hit

        state, tr1 = rng_mod.next_f32(state)
        state, tr2 = rng_mod.next_f32(state)
        vdst, in_volume, weight = _transmit(
            scene, vol_den, vol_len, alive, hit, weight, tr1, tr2
        )
        surf = alive & ~in_volume

        outgoing = -rd
        mp = get_material_point(scene, hit, attrs)
        normal = compute_shading_normal(scene, hit, attrs)
        pos_surf = ro + rd * hit.dst
        pos_vol = ro + rd * vdst if scene.any_volumetric else pos_surf

        # Surface emission.
        em_mask = surf & next_emission if is_direct else surf
        radiance = radiance + v3.where(em_mask, weight * mp.emission, zeros)

        delta = is_mat_delta(mp)
        nd = surf & ~delta
        dl = surf & delta

        # DIRECT: explicit light ray each bounce (traced in slot B below).
        weight_pre = weight
        if has_light_ray:
            state, ldir = lights.sample_lights(scene, pos_surf, outgoing, state)
            lpdf = lights.sample_lights_pdf(
                scene, pos_surf, ldir, ctx["eps"], ctx["Wl"]
            )
            lf = bsdf.eval_bsdfcos(mp, normal, outgoing, ldir, types)
            do_l = nd & v3.all_nonzero(lf) & (lpdf > 0.0)
        if is_direct:
            next_emission = torch.where(
                nd, False, torch.where(dl, True, next_emission)
            )

        # Non-delta continuation.
        state, inc_nd, f_nd, dead_nd = _sample_surface_common(
            scene, ctx, mp, normal, outgoing, pos_surf, state, use_nee
        )
        alive = alive & ~(nd & dead_nd)
        nd_ok = nd & ~dead_nd
        weight = v3.where(nd_ok, weight * f_nd, weight)

        # Delta continuation (absent without delta-capable types).
        state, rnl_d = rng_mod.next_f32(state)
        if scene.any_delta:
            inc_d = bsdf.sample_delta(mp, normal, outgoing, rnl_d, types)
            dead_d = v3.all_zero(inc_d)
            alive = alive & ~(dl & dead_d)
            dl_ok = dl & ~dead_d
            f_d = bsdf.eval_delta(mp, normal, outgoing, inc_d, types) / (
                torch.clamp_min(
                    bsdf.sample_delta_pdf(mp, normal, outgoing, inc_d, types), 0.0
                )
            )
            weight = v3.where(dl_ok, weight * f_d, weight)
        else:
            inc_d = zeros

        incoming = v3.where(dl, inc_d, inc_nd)

        # Volume slot toggle (pathtracer.wgsl:667-681).
        if scene.any_volumetric:
            crossing = (
                surf & alive & is_mat_volumetric(mp)
                & (v3.dot(normal, outgoing) * v3.dot(normal, incoming) < 0.0)
            )
            push = crossing & (vol_len == 0)
            pop = crossing & (vol_len > 0)
            vol_den = v3.where(push, mp.density, vol_den)
            vol_sca = v3.where(push, mp.scattering, vol_sca)
            vol_aniso = torch.where(push, mp.sc_anisotropy, vol_aniso)
            vol_len = vol_len + push.to(torch.int32) - pop.to(torch.int32)

            # In-volume continuation.
            state, inc_v, f_v, dead_v = _sample_volume_common(
                scene, ctx, vol_den, vol_sca, vol_aniso, outgoing, pos_vol,
                state, use_nee,
            )
            alive = alive & ~(in_volume & dead_v)
            v_ok = in_volume & ~dead_v
            weight = v3.where(v_ok, weight * f_v, weight)
            incoming = v3.where(in_volume, inc_v, incoming)

        new_ro = v3.where(in_volume, pos_vol, pos_surf)
        ro_cont = v3.where(alive, new_ro, ro)
        rd_cont = v3.where(alive, incoming, rd)

        # Weight viability (pathtracer.wgsl:719).
        alive = alive & ~v3.all_zero(weight) & v3.is_finite(weight)

        # Russian roulette after bounce 3 (pathtracer.wgsl:724-729).
        state, rr = rng_mod.next_f32(state)
        rr_on = alive & (bounce > 3)
        survive = torch.clamp_max(v3.max_comp(weight), 0.99)
        alive = alive & ~(rr_on & (rr >= survive))
        weight = v3.where(rr_on & (rr < survive),
                          weight / torch.clamp_min(survive, 1e-12), weight)

        # --- path-end bookkeeping, then ONE combined trace ---
        bounce_next = bounce + 1
        done = entry_alive & (~alive | (bounce_next > max_bounces))
        sample_idx = sample_idx + done.to(torch.int32)
        spawn = done & (sample_idx < regen["spp"])
        st_new = rng_mod.init_state(
            regen["pixel_idx"], regen["accum_counter"], regen["rng_seed"],
            sample_idx + regen["sample_offset"],
        )
        st_new, ro_n, rd_n = _camera_ray_from(regen, st_new)
        ro_a = v3.where(spawn, ro_n, ro_cont)
        rd_a = v3.where(spawn, rd_n, rd_cont)
        state_a = torch.where(spawn, st_new, state)
        ne_a = torch.where(spawn, True, next_emission)
        alive_next = (alive & ~done) | spawn

        active_a = alive_next
        if has_light_ray:
            ro3 = v3.cat(ro_a, pos_surf)
            rd3 = v3.cat(rd_a, ldir)
            mask3 = torch.cat([active_a, torch.zeros_like(active_a)])
            active3 = torch.cat([active_a, do_l])
            state3 = torch.cat([state_a, state_a])
        else:
            ro3, rd3, mask3, active3, state3 = ro_a, rd_a, active_a, active_a, state_a
        hit3, attrs3, state3 = ray_skip_alpha(
            scene, ctx, ro3, rd3, state3, mask3, active=active3,
            coherent=False,
        )
        state_a = state3[:B]
        hit_a = hit3.map(lambda a: a[:B])
        attrs_a = _slice_attrs(attrs3, 0, B)
        n_traced = n_traced + active_a.to(torch.int32)

        if has_light_ray:
            hit_b = hit3.map(lambda a: a[B:])
            attrs_b = _slice_attrs(attrs3, B, 2 * B)
            l_em = get_emission(scene, hit_b, attrs_b)
            if not scene.envs_empty:
                l_em = v3.where(hit_b.hit, l_em,
                                lights.sample_environments(scene, ldir))
            else:
                l_em = v3.where(hit_b.hit, l_em, zeros)
            radiance = radiance + v3.where(
                do_l, weight_pre * lf * l_em * (1.0 / lpdf), zeros
            )
            n_traced = n_traced + do_l.to(torch.int32)

        ro, rd, state = ro_a, rd_a, state_a
        hit, attrs = hit_a, attrs_a
        next_emission = ne_a
        alive = alive_next
        acc = acc + v3.where(
            done, clamp_radiance(radiance, regen["max_radiance"]), zeros
        )
        bounce = torch.where(spawn, 0, bounce_next)
        weight = v3.where(spawn, 1.0, weight)
        radiance = v3.where(spawn, 0.0, radiance)
        vol_len = torch.where(spawn, 0, vol_len)

    return acc, n_traced


def clamp_radiance(radiance: V3, max_radiance) -> V3:
    """Firefly control (pathtracer.wgsl:1774-1783)."""

    finite = v3.is_finite(radiance)
    radiance = v3.where(finite, radiance, 0.0)
    peak = v3.max_comp(radiance)
    over = peak > max_radiance
    scale = torch.where(
        over,
        torch.full_like(peak, max_radiance) / torch.clamp_min(peak, 1e-20),
        1.0,
    )
    return radiance * scale
