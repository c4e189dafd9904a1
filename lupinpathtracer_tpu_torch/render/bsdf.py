"""BSDF library: sample / eval / pdf triplets for all 8 material models.

The counterpart of lupinpathtracer_tpu/render/bsdf.py (the reference's
Yocto/GL-derived shading code: pathtracer.wgsl:1443-1555 fresnel and
microfacet, :1789-1918 sampling, :1951-2095 eval, :2097-2229 pdf,
:2231-2404 delta variants, :1920-1949 + :2406-2422 volumetrics). Vectors
and colours are component-wise V3 batches; the per-material `switch` is a
select over only the material types the scene uses, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core import vec3 as v3
from ..core.rng import PI
from ..core.types import MaterialType
from ..core.vec3 import V3


def _zeros(ref) -> V3:
    z = torch.zeros_like(ref)
    return V3(z, z, z)


def normalize(a: V3) -> V3:
    return v3.normalize(a)


def reflect(w: V3, n: V3) -> V3:
    """pathtracer.wgsl:2440-2443."""

    return -w + n * (2.0 * v3.dot(n, w))


def refract(w: V3, n: V3, inv_eta) -> V3:
    """pathtracer.wgsl:2445-2451; zero on total internal reflection."""

    cosine = v3.dot(n, w)
    k = 1.0 + inv_eta * inv_eta * (cosine * cosine - 1.0)
    out = -w * inv_eta + n * (inv_eta * cosine - torch.sqrt(torch.clamp_min(k, 0.0)))
    return v3.where(k < 0.0, _zeros(cosine), out)


def same_hemisphere(normal: V3, outgoing: V3, incoming: V3):
    return v3.dot(normal, outgoing) * v3.dot(normal, incoming) >= 0.0


def basis_fromz(v: V3):
    """Pixar orthonormal basis (pathtracer.wgsl:2424-2434)."""

    z = v3.normalize(v)
    sign = torch.where(z.z < 0.0, -1.0, 1.0)
    a = -1.0 / (sign + z.z)
    b = z.x * z.y * a
    x = V3(1.0 + sign * z.x * z.x * a, sign * b, -sign * z.x)
    y = V3(b, sign + z.y * z.y * a, -z.y)
    return x, y, z


def from_basis(x: V3, y: V3, z: V3, lx, ly, lz) -> V3:
    return x * lx + y * ly + z * lz


def flip_up(normal: V3, outgoing: V3) -> V3:
    """up_normal = dot(n, o) <= 0 ? -n : n."""

    return v3.where(v3.dot(normal, outgoing) <= 0.0, -normal, normal)


# ---------------------------------------------------------------------------
# Fresnel / microfacet (pathtracer.wgsl:1443-1555)
# ---------------------------------------------------------------------------


def reflectivity_to_eta(color: V3) -> V3:
    r = v3.vclip(color, 0.0, 0.99)
    s = v3.vsqrt(r)
    return (1.0 + s) / (1.0 - s)


def eta_to_reflectivity_s(eta):
    """Scalar eta variant (gltfpbr uses vec3f(ior))."""

    return ((eta - 1.0) * (eta - 1.0)) / ((eta + 1.0) * (eta + 1.0))


def fresnel_schlick_v(color: V3, normal: V3, out_dir: V3) -> V3:
    cosine = v3.dot(normal, out_dir)
    p = torch.pow(torch.clamp(1.0 - torch.abs(cosine), 0.0, 1.0), 5.0)
    f = color + (1.0 - color) * p
    return v3.where(v3.all_zero(color), _zeros(cosine), f)


def fresnel_dielectric(eta, normal: V3, outgoing: V3):
    cosw = torch.abs(v3.dot(normal, outgoing))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - sin2 / eta2
    t0 = torch.sqrt(torch.clamp_min(cos2t, 0.0))
    t1 = eta * t0
    t2 = eta * cosw
    rs = (cosw - t1) / (cosw + t1)
    rp = (t0 - t2) / (t0 + t2)
    f = (rs * rs + rp * rp) / 2.0
    return torch.where(cos2t < 0.0, 1.0, f)  # total internal reflection


def fresnel_conductor(eta: V3, normal: V3, outgoing: V3) -> V3:
    """etak == 0 specialization (the only form the reference calls)."""

    cosw_raw = v3.dot(normal, outgoing)
    cosw = torch.clamp(cosw_raw, -1.0, 1.0)
    cos2 = cosw * cosw
    sin2 = torch.clamp(1.0 - cos2, 0.0, 1.0)

    def chan(e):
        e2 = e * e
        t0 = e2 - sin2
        a2b2 = torch.abs(t0)
        t1 = a2b2 + cos2
        a = torch.sqrt(torch.clamp_min((a2b2 + t0) / 2.0, 0.0))
        t2 = 2.0 * a * cosw
        rs = (t1 - t2) / (t1 + t2)
        t3 = cos2 * a2b2 + sin2 * sin2
        t4 = t2 * sin2
        rp = rs * (t3 - t4) / (t3 + t4)
        return (rp + rs) / 2.0

    f = V3(chan(eta.x), chan(eta.y), chan(eta.z))
    return v3.where(cosw_raw <= 0.0, _zeros(cosw), f)


def microfacet_distribution(roughness, normal: V3, halfway: V3):
    """GGX (pathtracer.wgsl:1506-1522)."""

    cosine = v3.dot(normal, halfway)
    r2 = roughness * roughness
    c2 = cosine * cosine
    denom = c2 * r2 + 1.0 - c2
    d = r2 / (PI * denom * denom)
    return torch.where(cosine <= 0.0, 0.0, d)


def _microfacet_shadowing1(roughness, normal: V3, halfway: V3, direction: V3):
    cosine = v3.dot(normal, direction)
    cosineh = v3.dot(halfway, direction)
    r2 = roughness * roughness
    c2 = cosine * cosine
    g = 2.0 * torch.abs(cosine) / (
        torch.abs(cosine) + torch.sqrt(torch.clamp_min(c2 - r2 * c2 + r2, 0.0))
    )
    return torch.where(cosine * cosineh <= 0.0, 0.0, g)


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return _microfacet_shadowing1(
        roughness, normal, halfway, outgoing
    ) * _microfacet_shadowing1(roughness, normal, halfway, incoming)


def sample_microfacet(roughness, normal: V3, rn_x, rn_y) -> V3:
    """GGX NDF sampling (pathtracer.wgsl:1878-1893)."""

    phi = 2.0 * PI * rn_x
    theta = torch.atan(roughness * torch.sqrt(rn_y / torch.clamp_min(1.0 - rn_y, 1e-12)))
    st = torch.sin(theta)
    x, y, z = basis_fromz(normal)
    return v3.normalize(
        from_basis(x, y, z, torch.cos(phi) * st, torch.sin(phi) * st,
                   torch.cos(theta))
    )


def sample_microfacet_pdf(roughness, normal: V3, halfway: V3):
    cosine = v3.dot(normal, halfway)
    return torch.where(
        cosine < 0.0, 0.0,
        microfacet_distribution(roughness, normal, halfway) * cosine,
    )


def sample_hemisphere_cos(normal: V3, rn_x, rn_y) -> V3:
    """pathtracer.wgsl:2192-2199."""

    z = torch.sqrt(rn_y)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * rn_x
    bx, by, bz = basis_fromz(normal)
    return v3.normalize(
        from_basis(bx, by, bz, r * torch.cos(phi), r * torch.sin(phi), z)
    )


def sample_hemisphere_cos_pdf(normal: V3, direction: V3):
    cosw = v3.dot(normal, direction)
    return torch.where(cosw <= 0.0, 0.0, cosw / PI)


# ---------------------------------------------------------------------------
# Per-material sample / eval / pdf (smooth lobes)
# ---------------------------------------------------------------------------


def _sample_matte(mp, normal, outgoing, rnl, rx, ry):
    up = flip_up(normal, outgoing)
    return sample_hemisphere_cos(up, rx, ry)


def _sample_glossy(mp, normal, outgoing, rnl, rx, ry):
    up = flip_up(normal, outgoing)
    f = fresnel_dielectric(mp.ior, up, outgoing)
    halfway = sample_microfacet(mp.roughness, up, rx, ry)
    refl = reflect(outgoing, halfway)
    refl = v3.where(same_hemisphere(up, outgoing, refl), refl, _zeros(rnl))
    diff = sample_hemisphere_cos(up, rx, ry)
    return v3.where(rnl < f, refl, diff)


def _sample_reflective(mp, normal, outgoing, rnl, rx, ry):
    up = flip_up(normal, outgoing)
    halfway = sample_microfacet(mp.roughness, up, rx, ry)
    refl = reflect(outgoing, halfway)
    return v3.where(same_hemisphere(up, outgoing, refl), refl, _zeros(rnl))


def _sample_transparent(mp, normal, outgoing, rnl, rx, ry):
    up = flip_up(normal, outgoing)
    halfway = sample_microfacet(mp.roughness, up, rx, ry)
    f = fresnel_dielectric(mp.ior, halfway, outgoing)
    refl = reflect(outgoing, halfway)
    refl = v3.where(same_hemisphere(up, outgoing, refl), refl, _zeros(rnl))
    trans = -reflect(reflect(outgoing, halfway), up)
    trans = v3.where(same_hemisphere(up, outgoing, trans), _zeros(rnl), trans)
    return v3.where(rnl < f, refl, trans)


def _sample_refractive(mp, normal, outgoing, rnl, rx, ry):
    entering = v3.dot(normal, outgoing) >= 0.0
    up = v3.where(entering, normal, -normal)
    halfway = sample_microfacet(mp.roughness, up, rx, ry)
    rel_ior = torch.where(entering, mp.ior, 1.0 / mp.ior)
    f = fresnel_dielectric(rel_ior, halfway, outgoing)
    refl = reflect(outgoing, halfway)
    refl = v3.where(same_hemisphere(up, outgoing, refl), refl, _zeros(rnl))
    trans = refract(outgoing, halfway, torch.where(entering, 1.0 / mp.ior, mp.ior))
    trans = v3.where(same_hemisphere(up, outgoing, trans), _zeros(rnl), trans)
    return v3.where(rnl < f, refl, trans)


def _gltf_reflectivity(mp) -> V3:
    r0 = eta_to_reflectivity_s(mp.ior)
    return V3(
        r0 * (1.0 - mp.metallic) + mp.color.x * mp.metallic,
        r0 * (1.0 - mp.metallic) + mp.color.y * mp.metallic,
        r0 * (1.0 - mp.metallic) + mp.color.z * mp.metallic,
    )


def _sample_gltfpbr(mp, normal, outgoing, rnl, rx, ry):
    up = flip_up(normal, outgoing)
    fs = fresnel_schlick_v(_gltf_reflectivity(mp), up, outgoing)
    f = v3.mean_comp(fs)
    halfway = sample_microfacet(mp.roughness, up, rx, ry)
    refl = reflect(outgoing, halfway)
    refl = v3.where(same_hemisphere(up, outgoing, refl), refl, _zeros(rnl))
    diff = sample_hemisphere_cos(up, rx, ry)
    return v3.where(rnl < f, refl, diff)


_SMOOTH_SAMPLERS = {
    int(MaterialType.MATTE): _sample_matte,
    int(MaterialType.GLOSSY): _sample_glossy,
    int(MaterialType.REFLECTIVE): _sample_reflective,
    int(MaterialType.TRANSPARENT): _sample_transparent,
    int(MaterialType.REFRACTIVE): _sample_refractive,
    int(MaterialType.SUBSURFACE): _sample_refractive,
    int(MaterialType.GLTFPBR): _sample_gltfpbr,
}


def _smooth_types(types):
    if types is None:
        types = tuple(_SMOOTH_SAMPLERS.keys())
    return tuple(t for t in types if t != int(MaterialType.VOLUMETRIC))


def _dispatch(table, types, mp, args, zero):
    ts = _smooth_types(types)
    if not ts:
        return zero
    out = table[ts[0]](mp, *args)
    for t in ts[1:]:
        mask = mp.mat_type == t
        other = table[t](mp, *args)
        out = (v3.where(mask, other, out) if isinstance(out, V3)
               else torch.where(mask, other, out))
    return out


def sample_bsdfcos(mp, normal, outgoing, rnl, rx, ry, types=None) -> V3:
    """Dispatch (pathtracer.wgsl:2039-2056); zero for roughness==0 lanes."""

    out = _dispatch(_SMOOTH_SAMPLERS, types, mp,
                    (normal, outgoing, rnl, rx, ry), _zeros(rnl))
    return v3.where(mp.roughness == 0.0, _zeros(rnl), out)


def _eval_matte(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    f = mp.color * (torch.abs(v3.dot(normal, incoming)) / PI)
    return v3.where(mask, _zeros(mp.ior), f)


def _eval_glossy(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    up = flip_up(normal, outgoing)
    f1 = fresnel_dielectric(mp.ior, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_dielectric(mp.ior, halfway, incoming)
    d = microfacet_distribution(mp.roughness, up, halfway)
    g = microfacet_shadowing(mp.roughness, up, halfway, outgoing, incoming)
    absin = torch.abs(v3.dot(up, incoming))
    spec = f * d * g / (4.0 * v3.dot(up, outgoing) * v3.dot(up, incoming)) * absin
    out = mp.color * ((1.0 - f1) / PI * absin) + spec
    return v3.where(mask, _zeros(mp.ior), out)


def _eval_reflective(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    up = flip_up(normal, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_conductor(reflectivity_to_eta(mp.color), halfway, incoming)
    d = microfacet_distribution(mp.roughness, up, halfway)
    g = microfacet_shadowing(mp.roughness, up, halfway, outgoing, incoming)
    out = f * (
        d * g / (4.0 * v3.dot(up, outgoing) * v3.dot(up, incoming))
        * torch.abs(v3.dot(up, incoming))
    )
    return v3.where(mask, _zeros(mp.ior), out)


def _eval_transparent(mp, normal, outgoing, incoming):
    up = flip_up(normal, outgoing)
    same = v3.dot(normal, incoming) * v3.dot(normal, outgoing) >= 0.0
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(mp.ior, h_r, outgoing)
    d_r = microfacet_distribution(mp.roughness, up, h_r)
    g_r = microfacet_shadowing(mp.roughness, up, h_r, outgoing, incoming)
    spec_s = (
        f_r * d_r * g_r / (4.0 * v3.dot(up, outgoing) * v3.dot(up, incoming))
        * torch.abs(v3.dot(up, incoming))
    )
    spec = V3(spec_s, spec_s, spec_s)
    reflected = reflect(-incoming, up)
    h_t = normalize(reflected + outgoing)
    f_t = fresnel_dielectric(mp.ior, h_t, outgoing)
    d_t = microfacet_distribution(mp.roughness, up, h_t)
    g_t = microfacet_shadowing(mp.roughness, up, h_t, outgoing, reflected)
    trans = mp.color * (
        (1.0 - f_t) * d_t * g_t
        / (4.0 * v3.dot(up, outgoing) * v3.dot(up, reflected))
        * torch.abs(v3.dot(up, reflected))
    )
    return v3.where(same, spec, trans)


def _eval_refractive(mp, normal, outgoing, incoming):
    entering = v3.dot(normal, outgoing) >= 0.0
    up = v3.where(entering, normal, -normal)
    rel_ior = torch.where(entering, mp.ior, 1.0 / mp.ior)
    same = v3.dot(normal, incoming) * v3.dot(normal, outgoing) >= 0.0
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(rel_ior, h_r, outgoing)
    d_r = microfacet_distribution(mp.roughness, up, h_r)
    g_r = microfacet_shadowing(mp.roughness, up, h_r, outgoing, incoming)
    spec = (
        f_r * d_r * g_r
        / torch.abs(4.0 * v3.dot(normal, outgoing) * v3.dot(normal, incoming))
        * torch.abs(v3.dot(normal, incoming))
    )
    # transmission ([Walter 2007] eq. 21)
    sgn = torch.where(entering, 1.0, -1.0)
    h_t = -normalize(incoming * rel_ior + outgoing) * sgn
    f_t = fresnel_dielectric(rel_ior, h_t, outgoing)
    d_t = microfacet_distribution(mp.roughness, up, h_t)
    g_t = microfacet_shadowing(mp.roughness, up, h_t, outgoing, incoming)
    denom = rel_ior * v3.dot(h_t, incoming) + v3.dot(h_t, outgoing)
    trans = (
        torch.abs(
            v3.dot(outgoing, h_t) * v3.dot(incoming, h_t)
            / (v3.dot(outgoing, normal) * v3.dot(incoming, normal))
        )
        * (1.0 - f_t)
        * d_t
        * g_t
        / (denom * denom)
        * torch.abs(v3.dot(normal, incoming))
    )
    out = torch.where(same, spec, trans)
    return V3(out, out, out)


def _eval_gltfpbr(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    reflectivity = _gltf_reflectivity(mp)
    up = flip_up(normal, outgoing)
    f1 = fresnel_schlick_v(reflectivity, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_schlick_v(reflectivity, halfway, incoming)
    d = microfacet_distribution(mp.roughness, up, halfway)
    g = microfacet_shadowing(mp.roughness, up, halfway, outgoing, incoming)
    absin = torch.abs(v3.dot(up, incoming))
    diff = mp.color * (1.0 - mp.metallic) * (1.0 - f1) * (absin / PI)
    spec = f * (d * g / (4.0 * v3.dot(up, outgoing) * v3.dot(up, incoming)) * absin)
    return v3.where(mask, _zeros(mp.ior), diff + spec)


_SMOOTH_EVALS = {
    int(MaterialType.MATTE): _eval_matte,
    int(MaterialType.GLOSSY): _eval_glossy,
    int(MaterialType.REFLECTIVE): _eval_reflective,
    int(MaterialType.TRANSPARENT): _eval_transparent,
    int(MaterialType.REFRACTIVE): _eval_refractive,
    int(MaterialType.SUBSURFACE): _eval_refractive,
    int(MaterialType.GLTFPBR): _eval_gltfpbr,
}


def eval_bsdfcos(mp, normal, outgoing, incoming, types=None) -> V3:
    out = _dispatch(_SMOOTH_EVALS, types, mp, (normal, outgoing, incoming),
                    _zeros(mp.ior))
    out = v3.where(mp.roughness == 0.0, _zeros(mp.ior), out)
    return v3.nan_to_zero(out)


def _pdf_matte(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    up = flip_up(normal, outgoing)
    return torch.where(mask, 0.0, sample_hemisphere_cos_pdf(up, incoming))


def _pdf_glossy(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    up = flip_up(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    f = fresnel_dielectric(mp.ior, up, outgoing)
    p = f * sample_microfacet_pdf(mp.roughness, up, halfway) / (
        4.0 * torch.abs(v3.dot(outgoing, halfway))
    ) + (1.0 - f) * sample_hemisphere_cos_pdf(up, incoming)
    return torch.where(mask, 0.0, p)


def _pdf_reflective(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    up = flip_up(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    p = sample_microfacet_pdf(mp.roughness, up, halfway) / (
        4.0 * torch.abs(v3.dot(outgoing, halfway))
    )
    return torch.where(mask, 0.0, p)


def _pdf_transparent(mp, normal, outgoing, incoming):
    up = flip_up(normal, outgoing)
    same = v3.dot(normal, incoming) * v3.dot(normal, outgoing) >= 0.0
    h_r = normalize(incoming + outgoing)
    p_r = fresnel_dielectric(mp.ior, h_r, outgoing) * sample_microfacet_pdf(
        mp.roughness, up, h_r
    ) / (4.0 * torch.abs(v3.dot(outgoing, h_r)))
    reflected = reflect(-incoming, up)
    h_t = normalize(reflected + outgoing)
    p_t = (
        (1.0 - fresnel_dielectric(mp.ior, h_t, outgoing))
        * sample_microfacet_pdf(mp.roughness, up, h_t)
        / (4.0 * torch.abs(v3.dot(outgoing, h_t)))
    )
    return torch.where(same, p_r, p_t)


def _pdf_refractive(mp, normal, outgoing, incoming):
    entering = v3.dot(normal, outgoing) >= 0.0
    up = v3.where(entering, normal, -normal)
    rel_ior = torch.where(entering, mp.ior, 1.0 / mp.ior)
    same = v3.dot(normal, incoming) * v3.dot(normal, outgoing) >= 0.0
    h_r = normalize(incoming + outgoing)
    p_r = fresnel_dielectric(rel_ior, h_r, outgoing) * sample_microfacet_pdf(
        mp.roughness, up, h_r
    ) / (4.0 * torch.abs(v3.dot(outgoing, h_r)))
    sgn = torch.where(entering, 1.0, -1.0)
    h_t = -normalize(incoming * rel_ior + outgoing) * sgn
    denom = rel_ior * v3.dot(h_t, incoming) + v3.dot(h_t, outgoing)
    p_t = (
        (1.0 - fresnel_dielectric(rel_ior, h_t, outgoing))
        * sample_microfacet_pdf(mp.roughness, up, h_t)
        * torch.abs(v3.dot(h_t, incoming))
        / (denom * denom)
    )
    return torch.where(same, p_r, p_t)


def _pdf_gltfpbr(mp, normal, outgoing, incoming):
    mask = v3.dot(normal, incoming) * v3.dot(normal, outgoing) <= 0.0
    up = flip_up(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    f = v3.mean_comp(fresnel_schlick_v(_gltf_reflectivity(mp), up, outgoing))
    p = f * sample_microfacet_pdf(mp.roughness, up, halfway) / (
        4.0 * torch.abs(v3.dot(outgoing, halfway))
    ) + (1.0 - f) * sample_hemisphere_cos_pdf(up, incoming)
    return torch.where(mask, 0.0, p)


_SMOOTH_PDFS = {
    int(MaterialType.MATTE): _pdf_matte,
    int(MaterialType.GLOSSY): _pdf_glossy,
    int(MaterialType.REFLECTIVE): _pdf_reflective,
    int(MaterialType.TRANSPARENT): _pdf_transparent,
    int(MaterialType.REFRACTIVE): _pdf_refractive,
    int(MaterialType.SUBSURFACE): _pdf_refractive,
    int(MaterialType.GLTFPBR): _pdf_gltfpbr,
}


def sample_bsdfcos_pdf(mp, normal, outgoing, incoming, types=None):
    out = _dispatch(_SMOOTH_PDFS, types, mp, (normal, outgoing, incoming),
                    torch.zeros_like(mp.ior))
    out = torch.where(mp.roughness == 0.0, 0.0, out)
    return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


# ---------------------------------------------------------------------------
# Delta lobes (pathtracer.wgsl:2231-2404)
# ---------------------------------------------------------------------------


_DELTA_TYPES = (
    int(MaterialType.REFLECTIVE),
    int(MaterialType.TRANSPARENT),
    int(MaterialType.REFRACTIVE),
    int(MaterialType.VOLUMETRIC),
)


def _delta_types(types):
    """The delta lobe set restricted to the scene's materials (the
    reference's delta switch has no subsurface case)."""

    if types is None:
        return _DELTA_TYPES
    return tuple(t for t in _DELTA_TYPES if t in types)


def sample_delta(mp, normal, outgoing, rnl, types=None) -> V3:
    t = mp.mat_type
    ts = _delta_types(types)
    out = _zeros(rnl)

    if int(MaterialType.REFLECTIVE) in ts or int(MaterialType.TRANSPARENT) in ts:
        up = flip_up(normal, outgoing)
        refl = reflect(outgoing, up)
        if int(MaterialType.REFLECTIVE) in ts:
            out = v3.where(t == MaterialType.REFLECTIVE, refl, out)
        if int(MaterialType.TRANSPARENT) in ts:
            f_tr = fresnel_dielectric(mp.ior, up, outgoing)
            trans = v3.where(rnl < f_tr, refl, -outgoing)
            out = v3.where(t == MaterialType.TRANSPARENT, trans, out)

    if int(MaterialType.REFRACTIVE) in ts:
        entering = v3.dot(normal, outgoing) >= 0.0
        up_r = v3.where(entering, normal, -normal)
        rel_ior = torch.where(entering, mp.ior, 1.0 / mp.ior)
        f_re = fresnel_dielectric(rel_ior, up_r, outgoing)
        refr = v3.where(
            rnl < f_re,
            reflect(outgoing, up_r),
            refract(outgoing, up_r, 1.0 / rel_ior),
        )
        refr = v3.where(torch.abs(mp.ior - 1.0) < 1e-3, -outgoing, refr)
        out = v3.where(t == MaterialType.REFRACTIVE, refr, out)

    if int(MaterialType.VOLUMETRIC) in ts:
        out = v3.where(t == MaterialType.VOLUMETRIC, -outgoing, out)
    return v3.where(mp.roughness != 0.0, _zeros(rnl), out)


def eval_delta(mp, normal, outgoing, incoming, types=None) -> V3:
    t = mp.mat_type
    ts = _delta_types(types)
    prod = v3.dot(normal, incoming) * v3.dot(normal, outgoing)
    same_side = prod >= 0.0
    opp = prod <= 0.0
    out = _zeros(prod)

    if int(MaterialType.REFLECTIVE) in ts or int(MaterialType.TRANSPARENT) in ts:
        up = flip_up(normal, outgoing)
        if int(MaterialType.REFLECTIVE) in ts:
            refl = fresnel_conductor(reflectivity_to_eta(mp.color), up, outgoing)
            refl = v3.where(opp, _zeros(prod), refl)
            out = v3.where(t == MaterialType.REFLECTIVE, refl, out)
        if int(MaterialType.TRANSPARENT) in ts:
            f_tr = fresnel_dielectric(mp.ior, up, outgoing)
            trans = v3.where(
                same_side, V3(f_tr, f_tr, f_tr), mp.color * (1.0 - f_tr)
            )
            out = v3.where(t == MaterialType.TRANSPARENT, trans, out)

    if int(MaterialType.REFRACTIVE) in ts:
        entering = v3.dot(normal, outgoing) >= 0.0
        up_r = v3.where(entering, normal, -normal)
        rel_ior = torch.where(entering, mp.ior, 1.0 / mp.ior)
        f_re = fresnel_dielectric(rel_ior, up_r, outgoing)
        refr_s = torch.where(
            same_side, f_re, (1.0 / (rel_ior * rel_ior)) * (1.0 - f_re)
        )
        refr_s = torch.where(
            torch.abs(mp.ior - 1.0) < 1e-3, torch.where(opp, 1.0, 0.0), refr_s
        )
        out = v3.where(t == MaterialType.REFRACTIVE, V3(refr_s, refr_s, refr_s), out)

    if int(MaterialType.VOLUMETRIC) in ts:
        pass_s = torch.where(same_side, 0.0, 1.0)
        out = v3.where(t == MaterialType.VOLUMETRIC, V3(pass_s, pass_s, pass_s), out)
    return v3.where(mp.roughness != 0.0, _zeros(prod), out)


def sample_delta_pdf(mp, normal, outgoing, incoming, types=None):
    t = mp.mat_type
    ts = _delta_types(types)
    prod = v3.dot(normal, incoming) * v3.dot(normal, outgoing)
    same_side = prod >= 0.0
    out = torch.zeros_like(prod)

    if int(MaterialType.REFLECTIVE) in ts:
        refl = torch.where(prod <= 0.0, 0.0, 1.0)
        out = torch.where(t == MaterialType.REFLECTIVE, refl, out)

    if int(MaterialType.TRANSPARENT) in ts:
        up = flip_up(normal, outgoing)
        f_tr = fresnel_dielectric(mp.ior, up, outgoing)
        trans = torch.where(same_side, f_tr, 1.0 - f_tr)
        out = torch.where(t == MaterialType.TRANSPARENT, trans, out)

    if int(MaterialType.REFRACTIVE) in ts:
        entering = v3.dot(normal, outgoing) >= 0.0
        up_r = v3.where(entering, normal, -normal)
        rel_ior = torch.where(entering, mp.ior, 1.0 / mp.ior)
        f_re = fresnel_dielectric(rel_ior, up_r, outgoing)
        refr = torch.where(same_side, f_re, 1.0 - f_re)
        refr = torch.where(
            torch.abs(mp.ior - 1.0) < 1e-3, torch.where(prod < 0.0, 1.0, 0.0), refr
        )
        out = torch.where(t == MaterialType.REFRACTIVE, refr, out)

    if int(MaterialType.VOLUMETRIC) in ts:
        passthrough = torch.where(same_side, 0.0, 1.0)
        out = torch.where(t == MaterialType.VOLUMETRIC, passthrough, out)
    return torch.where(mp.roughness != 0.0, 0.0, out)


# ---------------------------------------------------------------------------
# Volumetric transmittance + Henyey-Greenstein phase
# ---------------------------------------------------------------------------


def sample_transmittance(density: V3, max_distance, rl, rd):
    """Channel-stratified exponential distance sampling
    (pathtracer.wgsl:1895-1901)."""

    channel = torch.clamp((rl * 3.0).to(torch.int32), 0, 2)
    dch = torch.where(
        channel == 0, density.x, torch.where(channel == 1, density.y, density.z)
    )
    distance = torch.where(
        dch == 0.0, 3.4e38, -torch.log(1.0 - rd) / torch.clamp_min(dch, 1e-30)
    )
    return torch.minimum(distance, max_distance)


def eval_transmittance(density: V3, distance) -> V3:
    return v3.vexp(-density * distance)


def sample_transmittance_pdf(density: V3, distance, max_distance):
    """pathtracer.wgsl:2406-2413."""

    inside = v3.sum_comp(density * v3.vexp(-density * distance)) / 3.0
    surface = v3.sum_comp(v3.vexp(-density * max_distance)) / 3.0
    return torch.where(distance < max_distance, inside, surface)


def _hg_cos_theta(aniso, rn_y):
    iso = 1.0 - 2.0 * rn_y
    sq = (1.0 - aniso * aniso) / (1.0 + aniso - 2.0 * aniso * rn_y)
    aniso_ct = (1.0 + aniso * aniso - sq * sq) / (
        2.0 * torch.where(aniso == 0, 1.0, aniso)
    )
    return torch.where(torch.abs(aniso) < 1e-3, iso, aniso_ct)


def sample_scattering(vol_density: V3, vol_aniso, outgoing, rx, ry):
    """HG phase sampling (pathtracer.wgsl:1903-1918); zero when density==0."""

    cos_theta = _hg_cos_theta(vol_aniso, ry)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * PI * rx
    bx, by, bz = basis_fromz(-outgoing)
    out = from_basis(bx, by, bz, sin_theta * torch.cos(phi),
                     sin_theta * torch.sin(phi), cos_theta)
    return v3.where(v3.all_zero(vol_density), _zeros(rx), out)


def _hg_phase(aniso, cosine):
    denom = 1.0 + aniso * aniso - 2.0 * aniso * cosine
    return (1.0 - aniso * aniso) / (
        4.0 * PI * denom * torch.sqrt(torch.clamp_min(denom, 1e-20))
    )


def eval_scattering(vol_density, vol_scattering, vol_aniso, outgoing, incoming) -> V3:
    cosine = -v3.dot(outgoing, incoming)
    phase = _hg_phase(vol_aniso, cosine)
    out = vol_scattering * vol_density * phase
    return v3.where(v3.all_zero(vol_density), _zeros(cosine), out)


def sample_scattering_pdf(vol_density, vol_aniso, outgoing, incoming):
    cosine = -v3.dot(outgoing, incoming)
    return torch.where(v3.all_zero(vol_density), 0.0, _hg_phase(vol_aniso, cosine))


def mis_heuristic(this_pdf, other_pdf):
    """Power-2 heuristic (pathtracer.wgsl:935-938)."""

    return (this_pdf * this_pdf) / (this_pdf * this_pdf + other_pdf * other_pdf)
