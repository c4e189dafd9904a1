"""Material point evaluation and shading normals.

The counterpart of lupinpathtracer_tpu/render/materials.py
(get_material_point, pathtracer.wgsl:1267-1342; compute_shading_normal,
:1344-1384; the delta/volumetric predicates, :1418-1441). Two routes feed a
hit's attributes:
- attrs route: the dense intersector (kernel B2) returns the winner's packed
  attribute row, transposed to (ATTR_WIDTH, B), so each attribute is a row;
- BVH route: kernel B4 or B7 returns the winner's attributes already
  interpolated at the hit (kernels/intersect.InterpAttrs); material fields
  are looked up from its mat_id;
- gather route (attrs=None): gathers from the component-major (k, Tw)
  world-triangle tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import vec3 as v3
from ..core.tables import sel_by_id
from ..core.types import MIN_ROUGHNESS, MaterialType
from ..core.vec3 import V3
from ..kernels import dense_intersect as pk
from ..kernels.intersect import InterpAttrs
from ..kernels.texture import sample_texture, srgb_to_linear


@dataclass
class MaterialPoint:
    """Evaluated material sample (pathtracer.wgsl:1247-1261), batched."""

    mat_type: torch.Tensor  # (B,) i32
    emission: V3
    color: V3
    opacity: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    ior: torch.Tensor
    density: V3
    scattering: V3
    sc_anisotropy: torch.Tensor
    tr_depth: torch.Tensor


def _interp(a0, a1, a2, u, v):
    w = 1.0 - u - v
    return a0 * w + a1 * u + a2 * v


def _a_v3(attrs, sl) -> V3:
    return V3(attrs[sl.start], attrs[sl.start + 1], attrs[sl.start + 2])


def _a_v2(attrs, sl):
    return attrs[sl.start], attrs[sl.start + 1]


def _a_v4(attrs, sl):
    return _a_v3(attrs, sl), attrs[sl.start + 3]


def _tri(hit):
    return hit.tri.long()


def hit_texcoords(scene, hit, attrs=None):
    """Interpolated UVs + per-lane availability flag; returns (u, v, has)."""

    if not scene.any_uv:
        z = torch.zeros_like(hit.u)
        return z, z, torch.zeros_like(hit.hit)
    if isinstance(attrs, InterpAttrs):
        return attrs.tu, attrs.tv, attrs.has_uv
    if attrs is not None:
        u0, v0 = _a_v2(attrs, pk.ATTR_UV0)
        u1, v1 = _a_v2(attrs, pk.ATTR_UV1)
        u2, v2 = _a_v2(attrs, pk.ATTR_UV2)
        has = attrs[pk.ATTR_HAS_UV] > 0
    else:
        t = _tri(hit)
        u0, v0 = scene.wt_uv0[0][t], scene.wt_uv0[1][t]
        u1, v1 = scene.wt_uv1[0][t], scene.wt_uv1[1][t]
        u2, v2 = scene.wt_uv2[0][t], scene.wt_uv2[1][t]
        has = scene.wt_has_uv[t] > 0
    return (_interp(u0, u1, u2, hit.u, hit.v),
            _interp(v0, v1, v2, hit.u, hit.v), has)


def _mat_fields(scene, hit, attrs):
    """Per-lane material row (attrs route: packed row; BVH route: the
    material table at mat_id; else gathers)."""

    if isinstance(attrs, InterpAttrs):
        mid = attrs.mat_id
        return dict(
            base_color=V3(*(sel_by_id(scene.mat_color[c], mid) for c in range(3))),
            base_alpha=sel_by_id(scene.mat_color[3], mid),
            emission=V3(*(sel_by_id(scene.mat_emission[c], mid) for c in range(3))),
            scattering=V3(*(sel_by_id(scene.mat_scattering[c], mid)
                            for c in range(3))),
            mtype=sel_by_id(scene.mat_type, mid),
            roughness=sel_by_id(scene.mat_roughness, mid),
            metallic=sel_by_id(scene.mat_metallic, mid),
            ior=sel_by_id(scene.mat_ior, mid),
            aniso=sel_by_id(scene.mat_sc_anisotropy, mid),
            tr_depth=sel_by_id(scene.mat_tr_depth, mid),
            tex=[sel_by_id(scene.mat_tex[k], mid) for k in range(5)],
        )
    if attrs is not None:
        color_rgb, color_a = _a_v4(attrs, pk.ATTR_MAT_COLOR)
        return dict(
            base_color=color_rgb,
            base_alpha=color_a,
            emission=_a_v3(attrs, pk.ATTR_MAT_EMISSION),
            scattering=_a_v3(attrs, pk.ATTR_MAT_SCATTERING),
            mtype=attrs[pk.ATTR_MAT_TYPE].to(torch.int32),
            roughness=attrs[pk.ATTR_MAT_ROUGHNESS],
            metallic=attrs[pk.ATTR_MAT_METALLIC],
            ior=attrs[pk.ATTR_MAT_IOR],
            aniso=attrs[pk.ATTR_MAT_ANISO],
            tr_depth=attrs[pk.ATTR_MAT_TRDEPTH],
            tex=[attrs[pk.ATTR_MAT_TEX.start + k].to(torch.int32)
                 for k in range(5)],
        )
    mat = scene.wt_mat[_tri(hit)].long()
    return dict(
        base_color=v3.gather(scene.mat_color, mat),
        base_alpha=scene.mat_color[3][mat],
        emission=v3.gather(scene.mat_emission, mat),
        scattering=v3.gather(scene.mat_scattering, mat),
        mtype=scene.mat_type[mat],
        roughness=scene.mat_roughness[mat],
        metallic=scene.mat_metallic[mat],
        ior=scene.mat_ior[mat],
        aniso=scene.mat_sc_anisotropy[mat],
        tr_depth=scene.mat_tr_depth[mat],
        tex=[scene.mat_tex[k][mat] for k in range(5)],
    )


def get_material_point(scene, hit, attrs=None) -> MaterialPoint:
    mf = _mat_fields(scene, hit, attrs)
    u, v, has_uv = hit_texcoords(scene, hit, attrs)
    B, dev = hit.u.shape[0], hit.u.device
    use_tex = scene.num_textures > 0 and scene.any_uv

    def tex_sample(slot):
        # Texture fetches apply only where the mesh has texcoords
        # (pathtracer.wgsl:1285-1311); slots no material binds are skipped.
        if not use_tex or not scene.tex_slot_used[slot]:
            ones = torch.ones(B, dtype=torch.float32, device=dev)
            return V3(ones, ones, ones), ones
        ti = torch.where(has_uv, mf["tex"][slot], -1)
        return sample_texture(scene, ti, u, v, packed=True)

    color_rgb, color_a = tex_sample(0)
    if use_tex:
        color_rgb = srgb_to_linear(color_rgb)
    emission_rgb, _ = tex_sample(1)
    rm_rgb, _ = tex_sample(2)
    roughness_sample = rm_rgb.y  # green channel
    metallic_sample = rm_rgb.z  # blue channel
    scattering_rgb, _ = tex_sample(3)

    if scene.any_vert_colors and isinstance(attrs, InterpAttrs):
        vert_rgb, vert_a = attrs.vc, attrs.vca  # interpolated in-kernel
    elif scene.any_vert_colors:
        if attrs is not None:
            c0, a0 = _a_v4(attrs, pk.ATTR_C0)
            c1, a1 = _a_v4(attrs, pk.ATTR_C1)
            c2, a2 = _a_v4(attrs, pk.ATTR_C2)
        else:
            t = _tri(hit)
            c0, a0 = v3.gather(scene.wt_c0, t), scene.wt_c0[3][t]
            c1, a1 = v3.gather(scene.wt_c1, t), scene.wt_c1[3][t]
            c2, a2 = v3.gather(scene.wt_c2, t), scene.wt_c2[3][t]
        w = 1.0 - hit.u - hit.v
        vert_rgb = c0 * w + c1 * hit.u + c2 * hit.v
        vert_a = _interp(a0, a1, a2, hit.u, hit.v)
    else:
        vert_rgb = v3.full(B, 1.0, dev)
        vert_a = torch.ones(B, dtype=torch.float32, device=dev)

    mtype = mf["mtype"]
    color = color_rgb * mf["base_color"] * vert_rgb
    opacity = color_a * mf["base_alpha"] * vert_a
    emission = emission_rgb * mf["emission"]
    roughness = roughness_sample * mf["roughness"]
    roughness = roughness * roughness
    tr_depth = mf["tr_depth"]
    if scene.any_volumetric:
        is_dense_medium = (
            (mtype == MaterialType.REFRACTIVE)
            | (mtype == MaterialType.VOLUMETRIC)
            | (mtype == MaterialType.SUBSURFACE)
        )
        density = v3.where(
            is_dense_medium,
            -v3.vlog(v3.vclip(color, 1e-4, 1.0)) / tr_depth,
            v3.zeros(B, dev),
        )
    else:
        density = v3.zeros(B, dev)
    scattering = scattering_rgb * mf["scattering"]
    metallic = metallic_sample * mf["metallic"]

    # Roughness cleanup rules (pathtracer.wgsl:1330-1339).
    clamped = (
        (mtype == MaterialType.MATTE)
        | (mtype == MaterialType.GLTFPBR)
        | (mtype == MaterialType.GLOSSY)
    )
    roughness = torch.where(
        clamped,
        torch.clamp(roughness, MIN_ROUGHNESS, 1.0),
        torch.where(
            mtype == MaterialType.VOLUMETRIC,
            0.0,
            torch.where(roughness < MIN_ROUGHNESS, 0.0, roughness),
        ),
    )

    return MaterialPoint(
        mat_type=mtype, emission=emission, color=color, opacity=opacity,
        roughness=roughness, metallic=metallic, ior=mf["ior"],
        density=density, scattering=scattering, sc_anisotropy=mf["aniso"],
        tr_depth=tr_depth,
    )


def get_opacity(scene, hit, attrs=None):
    """Opacity of a hit only (color-texture alpha x material alpha x vertex
    alpha, pathtracer.wgsl:1285-1316), equal to get_material_point's."""

    B, dev = hit.u.shape[0], hit.u.device
    if isinstance(attrs, InterpAttrs):
        base_alpha = sel_by_id(scene.mat_color[3], attrs.mat_id)
        tex0 = sel_by_id(scene.mat_tex[0], attrs.mat_id)
        vert_a = (attrs.vca if scene.any_vert_colors
                  else torch.ones(B, dtype=torch.float32, device=dev))
    elif attrs is not None:
        base_alpha = attrs[pk.ATTR_MAT_COLOR.start + 3]
        tex0 = attrs[pk.ATTR_MAT_TEX.start].to(torch.int32)
        if scene.any_vert_colors:
            vert_a = _interp(attrs[pk.ATTR_C0.start + 3],
                             attrs[pk.ATTR_C1.start + 3],
                             attrs[pk.ATTR_C2.start + 3], hit.u, hit.v)
        else:
            vert_a = torch.ones(B, dtype=torch.float32, device=dev)
    else:
        t = _tri(hit)
        mat = scene.wt_mat[t].long()
        base_alpha = scene.mat_color[3][mat]
        tex0 = scene.mat_tex[0][mat]
        if scene.any_vert_colors:
            vert_a = _interp(scene.wt_c0[3][t], scene.wt_c1[3][t],
                             scene.wt_c2[3][t], hit.u, hit.v)
        else:
            vert_a = torch.ones(B, dtype=torch.float32, device=dev)

    if scene.num_textures > 0 and scene.any_uv and scene.tex_slot_used[0]:
        u, v, has_uv = hit_texcoords(scene, hit, attrs)
        ti = torch.where(has_uv, tex0, -1)
        _, color_a = sample_texture(scene, ti, u, v, packed=True)
    else:
        color_a = torch.ones(B, dtype=torch.float32, device=dev)
    return color_a * base_alpha * vert_a


def compute_shading_normal(scene, hit, attrs=None) -> V3:
    """compute_shading_normal (pathtracer.wgsl:1344-1384): interpolate baked
    world-space vertex normals; optional UV-tangent-frame normal mapping."""

    if isinstance(attrs, InterpAttrs):
        n = v3.normalize(attrs.n)  # interpolated in-kernel
    else:
        if attrs is not None:
            n0 = _a_v3(attrs, pk.ATTR_N0)
            n1 = _a_v3(attrs, pk.ATTR_N1)
            n2 = _a_v3(attrs, pk.ATTR_N2)
        else:
            t = _tri(hit)
            n0 = v3.gather(scene.wt_n0, t)
            n1 = v3.gather(scene.wt_n1, t)
            n2 = v3.gather(scene.wt_n2, t)
        w = 1.0 - hit.u - hit.v
        n = v3.normalize(n0 * w + n1 * hit.u + n2 * hit.v)

    if scene.any_normal_maps:
        u, v2_, has_uv = hit_texcoords(scene, hit, attrs)
        if isinstance(attrs, InterpAttrs):
            ntex = torch.where(
                has_uv, sel_by_id(scene.mat_tex[4], attrs.mat_id), -1)
            tangent, bitangent = attrs.tan, attrs.bit
        elif attrs is not None:
            ntex = torch.where(
                has_uv, attrs[pk.ATTR_MAT_TEX.start + 4].to(torch.int32), -1
            )
            tangent = _a_v3(attrs, pk.ATTR_TAN)
            bitangent = _a_v3(attrs, pk.ATTR_BIT)
        else:
            t = _tri(hit)
            ntex = torch.where(
                has_uv, scene.mat_tex[4][scene.wt_mat[t].long()], -1
            )
            tangent = v3.gather(scene.wt_tan, t)
            bitangent = v3.gather(scene.wt_bit, t)
        use_nm = ntex >= 0
        nm_rgb, _ = sample_texture(scene, ntex, u, v2_, packed=True)
        n_tex = nm_rgb * 2.0 - 1.0
        # Orthonormal frame with bitangent-handedness flip
        # (pathtracer.wgsl:1368-1379).
        t_o = v3.normalize(tangent - n * v3.dot(tangent, n))
        b_o = v3.normalize(v3.cross(n, t_o))
        flip = v3.dot(b_o, bitangent) < 0.0
        n_tex = v3.where(flip, -n_tex, n_tex)
        mapped = v3.normalize(t_o * n_tex.x + b_o * n_tex.y + n * n_tex.z)
        n = v3.where(use_nm, mapped, n)
    return n


def is_mat_delta(mp: MaterialPoint):
    """pathtracer.wgsl:1418-1424."""

    r0 = mp.roughness == 0.0
    t = mp.mat_type
    return (
        ((t == MaterialType.REFLECTIVE) & r0)
        | ((t == MaterialType.REFRACTIVE) & r0)
        | ((t == MaterialType.TRANSPARENT) & r0)
        | (t == MaterialType.VOLUMETRIC)
    )


def is_mat_volumetric(mp: MaterialPoint):
    """pathtracer.wgsl:1426-1431."""

    t = mp.mat_type
    return (
        (t == MaterialType.REFRACTIVE)
        | (t == MaterialType.VOLUMETRIC)
        | (t == MaterialType.SUBSURFACE)
    )


def get_emission(scene, hit, attrs=None) -> V3:
    """Emission of a hit only (emission texture x material emission,
    pathtracer.wgsl:1290-1295), equal to get_material_point's."""

    mf = _mat_fields(scene, hit, attrs)
    if not (scene.num_textures > 0 and scene.any_uv and scene.tex_slot_used[1]):
        return mf["emission"]
    u, v, has_uv = hit_texcoords(scene, hit, attrs)
    ti = torch.where(has_uv, mf["tex"][1], -1)
    emission_rgb, _ = sample_texture(scene, ti, u, v, packed=True)
    return emission_rgb * mf["emission"]
