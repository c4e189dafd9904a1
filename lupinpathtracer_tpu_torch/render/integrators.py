"""Path-tracing integrators: standard, MIS, naive and direct.

The counterpart of lupinpathtracer_tpu/render/integrators.py (the
reference's pathtrace_standard :588-733, pathtrace_mis :737-933,
pathtrace_naive :942-1059 and pathtrace_direct :1062-1245 in
pathtracer.wgsl). The whole ray batch
advances together; every divergence point (miss, delta vs smooth, in-volume
vs surface, Russian roulette, zero-direction death) is an `alive` or branch
mask, and the JAX package's `lax.while_loop` is a Python loop. The same
semantics are kept exactly: the 50/50 one-sample BSDF/light mix
(pathtracer.wgsl:640-658), the two-strategy MIS with the power-2 heuristic
(and the JAX package's two deliberate deviations from the reference's MIS
edge cases, integrators.py:24-38), the one-slot volume "stack" toggle (:667-681),
Russian roulette after bounce 3 (:724-729), the stochastic alpha skip
(bvh_custom.wgsl:154-180), in-place path regeneration, and the same PCG
streams and draw order, so results match the JAX package lane by lane.
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


# Host syncs of the integrators' bounce loops (each loop condition reads a
# device value). A measurement counter like intersect.HOST_SYNCS: set to 0
# before a run, read after.
HOST_SYNCS = {"bounce_loop": 0}


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


def pathtrace(scene, ctx, ro, rd, state, ptype: int, max_bounces: int):
    """One full path per lane, no regeneration (integrators.py:217-223);
    returns (radiance V3, state, n_bounces, n_traced). The debug
    dispatch's "bounces" heatmap reads n_bounces."""

    if ptype == PathtraceType.MIS:
        return _pathtrace_mis(scene, ctx, ro, rd, state, max_bounces)
    return _pathtrace_snd(scene, ctx, ro, rd, state, ptype, max_bounces)


def pathtrace_spp(
    scene, ctx, pixel_idx, gx, gy, resolution, cam, is_ortho: bool,
    accum_counter, rng_seed, spp: int, ptype: int, max_bounces: int,
    max_radiance, sample_offset=0, streams: int = 1,
):
    """All spp samples of a pixel batch as ONE wavefront with path
    regeneration: a lane that finishes sample s respawns sample s+1 of its
    own pixel in place (integrators.py:241-304). Returns (acc V3 = sum over
    spp of clamp_radiance(sample), n_traced).

    `streams` = K > 1 (where K divides spp) runs K concurrent sample
    streams per pixel: the lanes are tiled K times and stream k
    regenerates samples k*spp/K .. (k+1)*spp/K - 1, so the (pixel, sample)
    RNG streams and the sample set are those of K = 1 and only the order
    of the float additions differs; each bounce batch carries K times the
    rays (integrators.py:263-287)."""

    if streams > 1 and spp % streams == 0:
        K = streams
        Bq = pixel_idx.shape[0]
        offs = sample_offset + (
            torch.arange(K, dtype=torch.int64, device=pixel_idx.device)
            * (spp // K)).repeat_interleave(Bq)
        acc, n_traced = pathtrace_spp(
            scene, ctx, pixel_idx.repeat(K), gx.repeat(K), gy.repeat(K),
            resolution, cam, is_ortho, accum_counter, rng_seed, spp // K,
            ptype, max_bounces, max_radiance, sample_offset=offs,
        )
        return (V3(*(c.reshape(K, Bq).sum(0) for c in acc)),
                n_traced.reshape(K, Bq).sum(0))

    regen = dict(
        gx=gx, gy=gy, resolution=resolution, cam=cam, is_ortho=is_ortho,
        pixel_idx=pixel_idx, accum_counter=accum_counter, rng_seed=rng_seed,
        spp=spp, max_radiance=max_radiance, sample_offset=sample_offset,
    )
    state = rng_mod.init_state(pixel_idx, accum_counter, rng_seed, sample_offset)
    state, ro, rd = _camera_ray_from(regen, state)
    if ptype == PathtraceType.MIS:
        return _pathtrace_mis(scene, ctx, ro, rd, state, max_bounces, regen)
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
    """Lanes lo:hi of either attribute layout: the dense (AW, B) rows along
    their lane axis, an InterpAttrs leaf by leaf; None stays None."""

    if isinstance(attrs, intersect.InterpAttrs):
        return attrs.map(lambda a: a[lo:hi])
    return None if attrs is None else attrs[:, lo:hi]


class _Path:
    """The loop state of one wavefront of paths (the JAX loops' carry).
    With `regen`, the bounce counter is per lane and finished lanes respawn
    their pixel's next sample in place (sample_idx, acc); without it, the
    counter is one int and the loop ends at max_bounces."""

    def __init__(self, scene, ctx, ro, rd, state, regen):
        B, dev = ro.x.shape[0], ro.x.device
        zeros = v3.zeros(B, dev)
        self.regen = regen
        self.ro, self.rd = ro, rd
        self.alive = torch.ones(B, dtype=torch.bool, device=dev)
        self.hit, self.attrs, self.state = ray_skip_alpha(
            scene, ctx, ro, rd, state, self.alive)
        self.bounce = 0 if regen is None else torch.zeros(
            B, dtype=torch.int32, device=dev)
        self.weight = v3.full(B, 1.0, dev)
        self.radiance = zeros
        self.vol_den = zeros
        self.vol_sca = zeros
        self.vol_aniso = torch.zeros(B, dtype=torch.float32, device=dev)
        self.vol_len = torch.zeros(B, dtype=torch.int32, device=dev)
        self.next_emission = torch.ones(B, dtype=torch.bool, device=dev)
        self.n_bounces = torch.zeros(B, dtype=torch.int32, device=dev)
        self.n_traced = torch.ones(B, dtype=torch.int32, device=dev)
        self.sample_idx = torch.zeros(B, dtype=torch.int32, device=dev)
        self.acc = zeros

    def running(self, max_bounces) -> bool:
        if self.regen is None and self.bounce > max_bounces:
            return False
        HOST_SYNCS["bounce_loop"] += 1
        return bool(self.alive.any())

    def volume_toggle(self, scene, ctx, surf, alive, in_volume, mp, normal,
                      outgoing, incoming, pos_vol, weight, state, use_nee):
        """The one-slot volume "stack" (pathtracer.wgsl:667-681) and the
        in-volume continuation (:686-715). Returns (alive, weight,
        incoming, state)."""

        crossing = (
            surf & alive & is_mat_volumetric(mp)
            & (v3.dot(normal, outgoing) * v3.dot(normal, incoming) < 0.0)
        )
        push = crossing & (self.vol_len == 0)
        pop = crossing & (self.vol_len > 0)
        self.vol_den = v3.where(push, mp.density, self.vol_den)
        self.vol_sca = v3.where(push, mp.scattering, self.vol_sca)
        self.vol_aniso = torch.where(push, mp.sc_anisotropy, self.vol_aniso)
        self.vol_len = self.vol_len + push.to(torch.int32) - pop.to(torch.int32)
        state, inc_v, f_v, dead_v = _sample_volume_common(
            scene, ctx, self.vol_den, self.vol_sca, self.vol_aniso, outgoing,
            pos_vol, state, use_nee,
        )
        alive = alive & ~(in_volume & dead_v)
        v_ok = in_volume & ~dead_v
        weight = v3.where(v_ok, weight * f_v, weight)
        incoming = v3.where(in_volume, inc_v, incoming)
        return alive, weight, incoming, state

    def end_of_bounce(self, alive, weight, state, ro_cont, rd_cont,
                      max_bounces):
        """Weight viability (pathtracer.wgsl:719), Russian roulette after
        bounce 3 (:724-729), then the path-end bookkeeping ahead of the
        bounce's one trace: with regen, a lane whose path ends gives slot A
        to its pixel's next sample. Returns (done, spawn, alive_next, alive,
        weight, ro_a, rd_a, state_a, ne_a): slot A's ray, state and
        next_emission."""

        alive = alive & ~v3.all_zero(weight) & v3.is_finite(weight)
        state, rr = rng_mod.next_f32(state)
        rr_on = alive & (self.bounce > 3)
        survive = torch.clamp_max(v3.max_comp(weight), 0.99)
        alive = alive & ~(rr_on & (rr >= survive))
        weight = v3.where(rr_on & (rr < survive),
                          weight / torch.clamp_min(survive, 1e-12), weight)

        regen = self.regen
        bounce_next = self.bounce + 1
        done = self.alive & (~alive | (bounce_next > max_bounces))
        if regen is None:
            return (done, None, alive & ~done, alive, weight, ro_cont,
                    rd_cont, state, self.next_emission)
        self.sample_idx = self.sample_idx + done.to(torch.int32)
        spawn = done & (self.sample_idx < regen["spp"])
        st_new = rng_mod.init_state(
            regen["pixel_idx"], regen["accum_counter"], regen["rng_seed"],
            self.sample_idx + regen["sample_offset"],
        )
        st_new, ro_n, rd_n = _camera_ray_from(regen, st_new)
        return (done, spawn, (alive & ~done) | spawn, alive, weight,
                v3.where(spawn, ro_n, ro_cont), v3.where(spawn, rd_n, rd_cont),
                torch.where(spawn, st_new, state),
                torch.where(spawn, True, self.next_emission))

    def advance(self, done, spawn, alive_next, ro_a, rd_a, state_a, ne_a,
                hit_a, attrs_a):
        """Carries slot A into the next bounce; with regen, adds the
        finished samples to acc and resets the respawned lanes."""

        self.ro, self.rd, self.state = ro_a, rd_a, state_a
        self.hit, self.attrs = hit_a, attrs_a
        self.next_emission = ne_a
        self.alive = alive_next
        if self.regen is None:
            self.bounce += 1
            return
        self.acc = self.acc + v3.where(
            done, clamp_radiance(self.radiance, self.regen["max_radiance"]), 0.0)
        self.bounce = torch.where(spawn, 0, self.bounce + 1)
        self.weight = v3.where(spawn, 1.0, self.weight)
        self.radiance = v3.where(spawn, 0.0, self.radiance)
        self.vol_len = torch.where(spawn, 0, self.vol_len)

    def result(self):
        if self.regen is not None:
            return self.acc, self.n_traced
        return self.radiance, self.state, self.n_bounces, self.n_traced


def _delta_continue(scene, mp, normal, outgoing, dl, alive, weight, state):
    """Delta continuation (absent without delta-capable types)."""

    state, rnl_d = rng_mod.next_f32(state)
    if not scene.any_delta:
        return alive, weight, v3.zeros(dl.shape[0], dl.device), state
    types = scene.present_mat_types
    inc_d = bsdf.sample_delta(mp, normal, outgoing, rnl_d, types)
    dead_d = v3.all_zero(inc_d)
    alive = alive & ~(dl & dead_d)
    dl_ok = dl & ~dead_d
    f_d = bsdf.eval_delta(mp, normal, outgoing, inc_d, types) / (
        torch.clamp_min(
            bsdf.sample_delta_pdf(mp, normal, outgoing, inc_d, types), 0.0
        )
    )
    return alive, v3.where(dl_ok, weight * f_d, weight), inc_d, state


def _pathtrace_snd(scene, ctx, ro, rd, state, ptype, max_bounces, regen=None):
    """Shared loop for STANDARD / NAIVE / DIRECT, one batched trace call
    per bounce (integrators.py:324-592). DIRECT adds slot B for its
    explicit light ray. With `regen` (pathtrace_spp) finished lanes respawn
    their pixel's next sample in place; without it (pathtrace) the loop
    ends after max_bounces."""

    B, dev = ro.x.shape[0], ro.x.device
    is_direct = ptype == PathtraceType.DIRECT
    use_nee = ptype in (PathtraceType.STANDARD, PathtraceType.DIRECT)
    has_light_ray = is_direct and not (scene.lights_empty and scene.envs_empty)
    types = scene.present_mat_types
    zeros = v3.zeros(B, dev)
    p = _Path(scene, ctx, ro, rd, state, regen)

    while p.running(max_bounces):
        alive, ro, rd = p.alive, p.ro, p.rd
        weight, state, hit, attrs = p.weight, p.state, p.hit, p.attrs
        next_emission = p.next_emission

        # Miss: environment (direct gates on next_emission, :1075-1080).
        miss_m = alive & ~hit.hit
        if not scene.envs_empty:
            env = lights.sample_environments(scene, rd)
            env_mask = miss_m & next_emission if is_direct else miss_m
            p.radiance = p.radiance + v3.where(env_mask, weight * env, zeros)
        alive = alive & hit.hit
        p.n_bounces = p.n_bounces + alive.to(torch.int32)

        state, tr1 = rng_mod.next_f32(state)
        state, tr2 = rng_mod.next_f32(state)
        vdst, in_volume, weight = _transmit(
            scene, p.vol_den, p.vol_len, alive, hit, weight, tr1, tr2
        )
        surf = alive & ~in_volume

        outgoing = -rd
        mp = get_material_point(scene, hit, attrs)
        normal = compute_shading_normal(scene, hit, attrs)
        pos_surf = ro + rd * hit.dst
        pos_vol = ro + rd * vdst if scene.any_volumetric else pos_surf

        # Surface emission.
        em_mask = surf & next_emission if is_direct else surf
        p.radiance = p.radiance + v3.where(em_mask, weight * mp.emission, zeros)

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
            p.next_emission = torch.where(
                nd, False, torch.where(dl, True, next_emission)
            )

        # Non-delta continuation.
        state, inc_nd, f_nd, dead_nd = _sample_surface_common(
            scene, ctx, mp, normal, outgoing, pos_surf, state, use_nee
        )
        alive = alive & ~(nd & dead_nd)
        nd_ok = nd & ~dead_nd
        weight = v3.where(nd_ok, weight * f_nd, weight)

        alive, weight, inc_d, state = _delta_continue(
            scene, mp, normal, outgoing, dl, alive, weight, state)
        incoming = v3.where(dl, inc_d, inc_nd)

        if scene.any_volumetric:
            alive, weight, incoming, state = p.volume_toggle(
                scene, ctx, surf, alive, in_volume, mp, normal, outgoing,
                incoming, pos_vol, weight, state, use_nee)

        new_ro = v3.where(in_volume, pos_vol, pos_surf)
        (done, spawn, alive_next, alive, weight, ro_a, rd_a, state_a,
         ne_a) = p.end_of_bounce(alive, weight, state,
                                 v3.where(alive, new_ro, ro),
                                 v3.where(alive, incoming, rd), max_bounces)
        p.weight = weight

        # --- ONE combined trace ---
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
        p.n_traced = p.n_traced + active_a.to(torch.int32)

        if has_light_ray:
            hit_b = hit3.map(lambda a: a[B:])
            attrs_b = _slice_attrs(attrs3, B, 2 * B)
            l_em = get_emission(scene, hit_b, attrs_b)
            if not scene.envs_empty:
                l_em = v3.where(hit_b.hit, l_em,
                                lights.sample_environments(scene, ldir))
            else:
                l_em = v3.where(hit_b.hit, l_em, zeros)
            p.radiance = p.radiance + v3.where(
                do_l, weight_pre * lf * l_em * (1.0 / lpdf), zeros
            )
            p.n_traced = p.n_traced + do_l.to(torch.int32)

        p.advance(done, spawn, alive_next, ro_a, rd_a, state3[:B], ne_a,
                  hit3.map(lambda a: a[:B]), _slice_attrs(attrs3, 0, B))

    return p.result()


def _pathtrace_mis(scene, ctx, ro, rd, state, max_bounces, regen=None):
    """Classic two-strategy MIS with the power-2 heuristic
    (integrators.py:610-918; pathtracer.wgsl:737-933), one batched trace
    call per bounce over three slots:

      slot A: the continuation ray (the BSDF sample on non-delta surfaces,
              the delta or phase sample otherwise), or on a lane whose
              path just ended the respawned camera ray of its next sample;
      slot B: the light-strategy ray;
      slot C: the BSDF-strategy ray of a lane whose path dies this bounce
              (its direct term still counts while slot A respawns).

    Slot A's hit rides into the next bounce, so no ray is traced twice. The
    JAX package's two deliberate deviations from the reference hold here
    too (integrators.py:24-38): the next bounce always continues from the
    freshly traced BSDF-sample hit, and a zero pdf drops only that
    strategy's term (the 1e-30 guards); a miss adds the environment
    unconditionally (pathtracer.wgsl:758)."""

    B, dev = ro.x.shape[0], ro.x.device
    types = scene.present_mat_types
    zeros = v3.zeros(B, dev)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    p = _Path(scene, ctx, ro, rd, state, regen)

    while p.running(max_bounces):
        alive, ro, rd = p.alive, p.ro, p.rd
        weight, state, hit, attrs = p.weight, p.state, p.hit, p.attrs
        next_emission = p.next_emission

        miss_m = alive & ~hit.hit
        if not scene.envs_empty:
            env = lights.sample_environments(scene, rd)
            p.radiance = p.radiance + v3.where(miss_m, weight * env, zeros)
        alive = alive & hit.hit
        p.n_bounces = p.n_bounces + alive.to(torch.int32)

        state, tr1 = rng_mod.next_f32(state)
        state, tr2 = rng_mod.next_f32(state)
        vdst, in_volume, weight = _transmit(
            scene, p.vol_den, p.vol_len, alive, hit, weight, tr1, tr2
        )
        surf = alive & ~in_volume

        outgoing = -rd
        mp = get_material_point(scene, hit, attrs)
        normal = compute_shading_normal(scene, hit, attrs)
        pos_surf = ro + rd * hit.dst
        pos_vol = ro + rd * vdst if scene.any_volumetric else pos_surf

        em_mask = surf & next_emission
        p.radiance = p.radiance + v3.where(em_mask, weight * mp.emission, zeros)

        delta = is_mat_delta(mp)
        nd = surf & ~delta
        dl = surf & delta

        # --- the strategies' directions and gates (no traces yet) ---
        state, rnl = rng_mod.next_f32(state)
        state, rx, ry = rng_mod.next_vec2(state)
        bdir = bsdf.sample_bsdfcos(mp, normal, outgoing, rnl, rx, ry, types)
        state, ldir = lights.sample_lights(scene, pos_surf, outgoing, state)
        b_ok = v3.any_nonzero(bdir)
        l_ok = v3.any_nonzero(ldir)

        def strategy_terms(mdir, is_light, active):
            f = bsdf.eval_bsdfcos(mp, normal, outgoing, mdir, types)
            lp = lights.sample_lights_pdf(
                scene, pos_surf, mdir, ctx["eps"], ctx["Wl"]
            )
            bp = bsdf.sample_bsdfcos_pdf(mp, normal, outgoing, mdir, types)
            if is_light:
                mw = bsdf.mis_heuristic(lp, bp) / torch.clamp_min(lp, 1e-30)
            else:
                mw = bsdf.mis_heuristic(bp, lp) / torch.clamp_min(bp, 1e-30)
            # The reference's gate: all(bsdfcos != 0) && mis_weight != 0
            # (pathtracer.wgsl:790).
            go = active & v3.all_nonzero(f) & (mw != 0.0)
            return f, mw, go, bp

        # The weight BEFORE the indirect factor feeds both strategies.
        weight_pre = weight
        f_b, mw_b, go_b, bp_b = strategy_terms(bdir, False, nd & b_ok)
        # A zero BSDF sample skips the light strategy too (:775).
        f_l, mw_l, go_l, _ = strategy_terms(ldir, True, nd & b_ok & l_ok)

        # Indirect continuation along the BSDF sample (:855-858), with the
        # strategy's eval and pdf.
        alive = alive & ~(nd & ~b_ok)
        nd_ok = nd & b_ok
        weight = v3.where(nd_ok, weight * (f_b / torch.clamp_min(bp_b, 0.0)),
                          weight)
        p.next_emission = torch.where(nd, False, next_emission)

        alive, weight, inc_d, state = _delta_continue(
            scene, mp, normal, outgoing, dl, alive, weight, state)
        p.next_emission = torch.where(dl, True, p.next_emission)
        incoming = v3.where(dl, inc_d, bdir)

        if scene.any_volumetric:
            alive, weight, incoming, state = p.volume_toggle(
                scene, ctx, surf, alive, in_volume, mp, normal, outgoing,
                incoming, pos_vol, weight, state, True)
            p.next_emission = torch.where(in_volume, True, p.next_emission)

        new_ro = v3.where(in_volume, pos_vol, pos_surf)
        (done, spawn, alive_next, alive, weight, ro_a, rd_a, state_a,
         ne_a) = p.end_of_bounce(alive, weight, state,
                                 v3.where(alive, new_ro, ro),
                                 v3.where(alive, incoming, rd), max_bounces)
        p.weight = weight

        # --- ONE combined trace: [continuation/respawn | light | dying
        # BSDF]. Only slot A's lanes with next_emission run the stochastic
        # alpha skip (strategy rays intersect plainly, :835).
        active_a = alive_next
        active_c = go_b & done
        hit3, attrs3, state3 = ray_skip_alpha(
            scene, ctx, v3.cat(ro_a, pos_surf, pos_surf),
            v3.cat(rd_a, ldir, bdir), torch.cat([state_a, state_a, state_a]),
            torch.cat([active_a & ne_a, no, no]),
            active=torch.cat([active_a, go_l, active_c]), coherent=False,
        )
        hit_a, hit_b, hit_c = (hit3.map(lambda a, k=k: a[k * B:(k + 1) * B])
                               for k in range(3))
        attrs_a, attrs_b, attrs_c = (_slice_attrs(attrs3, k * B, (k + 1) * B)
                                     for k in range(3))
        p.n_traced = (p.n_traced + active_a.to(torch.int32)
                      + go_l.to(torch.int32) + active_c.to(torch.int32))

        # --- the strategies' contributions (emission at their hits) ---
        def strat_contrib(mdir, mhit, mattrs, f, mw, go):
            em = get_emission(scene, mhit, mattrs)
            if not scene.envs_empty:
                em = v3.where(mhit.hit, em, lights.sample_environments(scene, mdir))
            else:
                em = v3.where(mhit.hit, em, zeros)
            contrib = v3.nan_to_zero(weight_pre * f * em * mw)
            return v3.where(go, contrib, zeros)

        # The BSDF strategy's hit is slot A on surviving lanes (it is the
        # next bounce), slot C on dying ones.
        bhit = hit_c.map(lambda c_, a_: torch.where(done, c_, a_), hit_a)
        battrs = (None if attrs_a is None
                  else _blend_attrs(done, attrs_c, attrs_a))
        p.radiance = p.radiance + strat_contrib(bdir, bhit, battrs, f_b, mw_b, go_b)
        p.radiance = p.radiance + strat_contrib(ldir, hit_b, attrs_b, f_l, mw_l, go_l)

        p.advance(done, spawn, alive_next, ro_a, rd_a, state3[:B], ne_a,
                  hit_a, attrs_a)

    return p.result()


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
