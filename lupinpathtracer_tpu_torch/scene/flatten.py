"""Scene flattening: SceneCPU -> SceneTorch, a dataclass of tensors.

The counterpart of lupinpathtracer_tpu/scene/flatten.py. The host build is
a copy of the JAX package's numpy code (`flatten_numpy`): the same
concatenated, component-major tables, the same superleaf repacking of the
triangle soup (dense scenes included, so triangle ids and attribute rows
come out in the same order) and the same packed attribute matrix. Only the
last step differs: `scene_from_numpy` makes torch tensors on a given
device instead of jax arrays. The same function carries a JAX SceneTPU
across (its arrays via np.asarray), so both packages can compute on
identical inputs.

The BVH fields (`top_tab`, `sl_sub`, `gsl_*`, `bvh_*`) are built and
carried, but nothing in this package reads them yet.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..accel import alias_table as alias_mod
from ..accel import bvh as bvh_mod
from ..core import math3d
from ..core.device import resolve_device
from .scene import SceneCPU, validate_scene

# Scenes at or below this many world triangles use the dense intersector;
# larger scenes traverse the world BVH.
DEFAULT_DENSE_MAX_TRIS = 2048

# Seconds of the last build, by phase, from the host clock read at each
# phase boundary: the host BVH build ("bvh") and the superleaf build (the
# superleaf tables, the soup's repack into them and a two-level top table:
# "superleaf"), both set by flatten_numpy, the rest of flatten_numpy
# (validation, instancing, the world soup, attributes: "flatten"), and the
# copy to the device ("device"), set by build_scene_torch. A measurement
# record like intersect.HOST_SYNCS (lupin_bench's scene.bvh_build_s reads
# "bvh" and "superleaf").
BUILD_S = {"bvh": 0.0, "superleaf": 0.0, "flatten": 0.0, "device": 0.0}

STATIC_FIELDS = (
    "num_meshes", "num_instances", "num_materials", "num_envs", "num_lights",
    "num_textures", "num_world_tris", "use_bvh", "bvh_depth",
    "bvh_leaf_size", "sl_count", "sl_stride", "two_level", "msl_count",
    "top_depth", "top_root_is_leaf", "has_alpha", "envs_empty",
    "lights_empty", "instances_empty", "present_mat_types", "any_uv",
    "tex_slot_used", "any_vert_normals", "any_vert_colors",
    "any_normal_maps", "any_volumetric", "any_delta", "mat_tex_ldr",
    "env_has_tex",
)

ARRAY_FIELDS = (
    # mesh-level arrays (concatenated over meshes)
    "verts_pos", "verts_normal", "verts_uv", "verts_color", "tri_indices",
    "mesh_has_normals", "mesh_has_uv", "mesh_has_color",
    # instances
    "inst_inv", "inst_fwd", "inst_normal_mat", "inst_mesh", "inst_mat",
    "inst_det_sign",
    # world-space triangle soup, superleaf order, component-major (k, Tw)
    "wt_v0", "wt_e1", "wt_e2", "wt_inst", "wt_tri", "wt_mat",
    "wt_n0", "wt_n1", "wt_n2", "wt_gn", "wt_uv0", "wt_uv1", "wt_uv2",
    "wt_has_uv", "wt_c0", "wt_c1", "wt_c2", "wt_tan", "wt_bit",
    "wt_attr",  # (Tw, ATTR_WIDTH) packed rows, kernels/dense_intersect.py
    # world BVH + superleaf tables (carried for the BVH slice)
    "bvh_min", "bvh_max", "bvh_first", "bvh_count", "top_tab", "sl_sub",
    "gsl_inst", "gsl_msl", "gsl_meta",
    # materials, component-major
    "mat_color", "mat_emission", "mat_scattering", "mat_type",
    "mat_roughness", "mat_metallic", "mat_ior", "mat_sc_anisotropy",
    "mat_tr_depth", "mat_tex",
    # texture atlas
    "tex_data", "tex_data_u32", "tex_offset", "tex_width", "tex_height",
    # environments
    "env_emission", "env_tex", "env_rot",
    # lights + alias tables
    "light_inst", "light_area", "la_prob", "la_thresh", "la_alias",
    "light_alias_offset", "light_alias_size", "ea_prob", "ea_thresh",
    "ea_alias", "env_alias_offset",
    # light triangles in world space (linear order, for NEE + pdf)
    "lt_v0", "lt_e1", "lt_e2", "lt_light", "light_tri_offset",
    "light_tri_count",
)


@dataclass
class SceneTorch:
    """Flattened scene: the static fields as Python values and every table
    as a tensor on one device (see ARRAY_FIELDS for the groups; the field
    meanings are those of the JAX SceneTPU)."""

    statics: dict
    tensors: dict

    def __getattr__(self, name):
        d = self.__dict__
        if name in d.get("statics", {}):
            return d["statics"][name]
        if name in d.get("tensors", {}):
            return d["tensors"][name]
        raise AttributeError(name)

    @property
    def device(self) -> torch.device:
        return self.tensors["wt_v0"].device

    def to(self, device) -> "SceneTorch":
        device = torch.device(device)
        return dataclasses.replace(
            self, tensors={k: v.to(device) for k, v in self.tensors.items()}
        )


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _at_least_one(a: np.ndarray) -> np.ndarray:
    return a if a.shape[0] > 0 else np.zeros((1,) + a.shape[1:], a.dtype)


def flatten_numpy(
    scene: SceneCPU,
    dense_max_tris: int = DEFAULT_DENSE_MAX_TRIS,
    bvh_leaf_size: int = 4,
    validate: bool = True,
    two_level: bool | None = None,
    sl_stride_opt: int | None = None,
) -> SceneTPU:
    """Flatten + build acceleration structures on the host (numpy).

    Returns (arrays, statics): every tensor field of SceneTorch as a numpy
    array, and every static field. `scene_from_numpy` moves them to a device.

    two_level=None auto-enables the TLAS->BLAS analog (mesh-space
    superleaves shared across instances; see bvh_custom.wgsl:7-110) when
    instance expansion would multiply triangle memory >=4x; True/False
    force it. Two-level device memory scales with UNIQUE mesh triangles."""

    t_start = time.perf_counter()
    if validate:
        validate_scene(scene)
    BUILD_S["bvh"] = BUILD_S["superleaf"] = 0.0

    nm = len(scene.meshes)
    ni = len(scene.instances)
    nmat = len(scene.materials)
    ne = len(scene.environments)
    nt = len(scene.textures)

    mesh_tris = [m.indices.shape[0] for m in scene.meshes]
    exp_tris = sum(mesh_tris[i.mesh_idx] for i in scene.instances)
    used_mesh_ids = sorted({i.mesh_idx for i in scene.instances})
    uniq_tris = sum(mesh_tris[m] for m in used_mesh_ids)
    if two_level is None:
        two_level = (
            exp_tris > dense_max_tris
            and ni > 0
            and exp_tris >= 4 * max(uniq_tris, 1)
        )
    two_level = bool(two_level) and ni > 0 and uniq_tris > 0

    # ---- mesh-level concatenation ----
    v_off = np.zeros(nm + 1, np.int64)
    t_off = np.zeros(nm + 1, np.int64)
    for i, m in enumerate(scene.meshes):
        v_off[i + 1] = v_off[i] + m.positions.shape[0]
        t_off[i + 1] = t_off[i] + m.indices.shape[0]
    V = int(v_off[-1])
    Tm = int(t_off[-1])

    verts_pos = np.zeros((max(V, 1), 3), np.float32)
    verts_normal = np.zeros((max(V, 1), 3), np.float32)
    verts_uv = np.zeros((max(V, 1), 2), np.float32)
    verts_color = np.ones((max(V, 1), 4), np.float32)
    tri_indices = np.zeros((max(Tm, 1), 3), np.int32)
    mesh_has_normals = np.zeros(max(nm, 1), np.int32)
    mesh_has_uv = np.zeros(max(nm, 1), np.int32)
    mesh_has_color = np.zeros(max(nm, 1), np.int32)

    for i, m in enumerate(scene.meshes):
        a, b = int(v_off[i]), int(v_off[i + 1])
        verts_pos[a:b] = m.positions
        if m.normals is not None:
            verts_normal[a:b] = m.normals[:, :3]
            mesh_has_normals[i] = 1
        if m.texcoords is not None:
            verts_uv[a:b] = m.texcoords
            mesh_has_uv[i] = 1
        if m.colors is not None:
            verts_color[a:b] = m.colors
            mesh_has_color[i] = 1
        ta, tb = int(t_off[i]), int(t_off[i + 1])
        tri_indices[ta:tb] = m.indices.astype(np.int64) + a

    # ---- instances ----
    inst_inv = np.zeros((max(ni, 1), 3, 4), np.float32)
    inst_fwd = np.zeros((max(ni, 1), 3, 4), np.float32)
    inst_nrm = np.zeros((max(ni, 1), 3, 3), np.float32)
    inst_mesh = np.zeros(max(ni, 1), np.int32)
    inst_mat = np.zeros(max(ni, 1), np.int32)
    inst_det_sign = np.ones(max(ni, 1), np.float32)
    if ni:
        # Batched equivalents of math3d.frame_inverse / normal_matrix /
        # det-sign: 3 np.linalg calls per instance dominated flatten past
        # ~100k instances. Matches the scalar helpers: inverse in f64,
        # cast f32, translation via the f32 inverse.
        frames_all = np.stack(
            [inst.frame for inst in scene.instances]
        ).astype(np.float32)
        inst_fwd[:ni] = frames_all
        a64 = frames_all[:, :, :3].astype(np.float64)
        inv64 = np.linalg.inv(a64)
        rinv = inv64.astype(np.float32)
        inst_inv[:ni, :, :3] = rinv
        inst_inv[:ni, :, 3] = -np.einsum(
            "iab,ib->ia", rinv, frames_all[:, :, 3]
        )
        inst_nrm[:ni] = np.transpose(inv64, (0, 2, 1)).astype(np.float32)
        inst_mesh[:ni] = [inst.mesh_idx for inst in scene.instances]
        inst_mat[:ni] = [inst.mat_idx for inst in scene.instances]
        inst_det_sign[:ni] = np.where(
            np.linalg.det(a64) < 0.0, -1.0, 1.0
        ).astype(np.float32)

    # ---- world-space triangle soup with baked per-tri shading attributes ----
    def _nrm(a):
        return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)

    cols = {
        k: []
        for k in (
            "v0", "e1", "e2", "inst", "tri", "mat",
            "n0", "n1", "n2", "gn",
            "uv0", "uv1", "uv2", "has_uv",
            "c0", "c1", "c2", "tan", "bit",
        )
    }
    if two_level:
        # Mesh-space soup over UNIQUE meshes; instances become per-work-item
        # ray/normal transforms in the wavefront kernels. Material and
        # instance columns are per-instance and get overridden there.
        from .scene import InstanceCPU as _ICPU

        _ident = np.eye(3, 4, dtype=np.float32)
        soup_iter = [
            (m, _ICPU(frame=_ident, mesh_idx=m, mat_idx=0))
            for m in used_mesh_ids
        ]
    else:
        soup_iter = list(enumerate(scene.instances))
    for i, inst in soup_iter:
        m = scene.meshes[inst.mesh_idx]
        nt_mesh = m.indices.shape[0]
        if nt_mesh == 0:
            continue
        wp = math3d.transform_points(inst.frame, m.positions)
        tri = m.indices.astype(np.int64)
        v0 = wp[tri[:, 0]]
        v1 = wp[tri[:, 1]]
        v2 = wp[tri[:, 2]]
        cols["v0"].append(v0)
        cols["e1"].append(v1 - v0)
        cols["e2"].append(v2 - v0)
        cols["inst"].append(np.full(nt_mesh, i, np.int32))
        cols["tri"].append(
            (np.arange(nt_mesh, dtype=np.int64) + t_off[inst.mesh_idx]).astype(np.int32)
        )
        cols["mat"].append(np.full(nt_mesh, inst.mat_idx, np.int32))

        nrm_mat = math3d.normal_matrix(inst.frame)
        p0 = m.positions[tri[:, 0]]
        p1 = m.positions[tri[:, 1]]
        p2 = m.positions[tri[:, 2]]
        # compute_tri_geom_normal (pathtracer.wgsl:2561-2576): object-space
        # cross(v2-v0, v1-v0) through the inverse-transpose.
        gn = _nrm(_nrm(np.cross(p2 - p0, p1 - p0)) @ nrm_mat.T)
        cols["gn"].append(gn)
        if m.normals is not None:
            nw = m.normals[:, :3] @ nrm_mat.T  # unnormalized; interp commutes
            cols["n0"].append(nw[tri[:, 0]])
            cols["n1"].append(nw[tri[:, 1]])
            cols["n2"].append(nw[tri[:, 2]])
        else:
            cols["n0"].append(gn)
            cols["n1"].append(gn)
            cols["n2"].append(gn)
        if m.texcoords is not None:
            cols["uv0"].append(m.texcoords[tri[:, 0]])
            cols["uv1"].append(m.texcoords[tri[:, 1]])
            cols["uv2"].append(m.texcoords[tri[:, 2]])
            cols["has_uv"].append(np.ones(nt_mesh, np.int32))
            # Per-tri tangent frame (pathtracer.wgsl:1692-1727).
            t0 = m.texcoords[tri[:, 0]]
            t1 = m.texcoords[tri[:, 1]]
            t2 = m.texcoords[tri[:, 2]]
            p = p1 - p0
            q = p2 - p0
            sx = t1[:, 0] - t0[:, 0]
            sy = t2[:, 0] - t0[:, 0]
            tx = t1[:, 1] - t0[:, 1]
            ty = t2[:, 1] - t0[:, 1]
            div = sx * ty - sy * tx
            safe = np.where(div != 0.0, div, 1.0)[:, None]
            tan_l = np.where(
                (div != 0.0)[:, None],
                (ty[:, None] * p - tx[:, None] * q) / safe,
                np.array([1.0, 0.0, 0.0], np.float32),
            )
            bit_l = np.where(
                (div != 0.0)[:, None],
                (sx[:, None] * q - sy[:, None] * p) / safe,
                np.array([0.0, 1.0, 0.0], np.float32),
            )
            cols["tan"].append(_nrm(tan_l @ nrm_mat.T))
            cols["bit"].append(_nrm(bit_l @ nrm_mat.T))
        else:
            cols["uv0"].append(np.zeros((nt_mesh, 2), np.float32))
            cols["uv1"].append(np.zeros((nt_mesh, 2), np.float32))
            cols["uv2"].append(np.zeros((nt_mesh, 2), np.float32))
            cols["has_uv"].append(np.zeros(nt_mesh, np.int32))
            cols["tan"].append(_nrm(np.broadcast_to(nrm_mat.T[0], (nt_mesh, 3))))
            cols["bit"].append(_nrm(np.broadcast_to(nrm_mat.T[1], (nt_mesh, 3))))
        if m.colors is not None:
            cols["c0"].append(m.colors[tri[:, 0]])
            cols["c1"].append(m.colors[tri[:, 1]])
            cols["c2"].append(m.colors[tri[:, 2]])
        else:
            cols["c0"].append(np.ones((nt_mesh, 4), np.float32))
            cols["c1"].append(np.ones((nt_mesh, 4), np.float32))
            cols["c2"].append(np.ones((nt_mesh, 4), np.float32))

    def _cat(name, width, dtype=np.float32):
        if cols[name]:
            return np.concatenate(cols[name]).astype(dtype)
        shape = (0,) if width == 0 else (0, width)
        return np.zeros(shape, dtype)

    wt = {
        "v0": _cat("v0", 3), "e1": _cat("e1", 3), "e2": _cat("e2", 3),
        "inst": _cat("inst", 0, np.int32), "tri": _cat("tri", 0, np.int32),
        "mat": _cat("mat", 0, np.int32),
        "n0": _cat("n0", 3), "n1": _cat("n1", 3), "n2": _cat("n2", 3),
        "gn": _cat("gn", 3),
        "uv0": _cat("uv0", 2), "uv1": _cat("uv1", 2), "uv2": _cat("uv2", 2),
        "has_uv": _cat("has_uv", 0, np.int32),
        "c0": _cat("c0", 4), "c1": _cat("c1", 4), "c2": _cat("c2", 4),
        "tan": _cat("tan", 3), "bit": _cat("bit", 3),
    }
    wt_v0, wt_e1, wt_e2 = wt["v0"], wt["e1"], wt["e2"]
    Tw = wt_v0.shape[0]

    # ---- lights + alias tables (object-space areas, data_structures.rs:20-113) ----
    light_inst_l, light_area_l = [], []
    la_prob_l, la_thresh_l, la_alias_l = [], [], []
    light_alias_offset_l, light_alias_size_l = [], []
    lt_v0_l, lt_e1_l, lt_e2_l, lt_light_l = [], [], [], []
    light_tri_offset_l, light_tri_count_l = [], []
    a_cursor = 0
    t_cursor = 0
    for i, inst in enumerate(scene.instances):
        mat = scene.materials[inst.mat_idx]
        mesh = scene.meshes[inst.mesh_idx]
        if not np.any(np.asarray(mat.emission)[:3] != 0.0):
            continue
        if mesh.indices.shape[0] == 0:
            continue
        tri = mesh.indices.astype(np.int64)
        p0 = mesh.positions[tri[:, 0]]
        p1 = mesh.positions[tri[:, 1]]
        p2 = mesh.positions[tri[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
        total = float(areas.sum())
        if total <= 0.0:
            continue
        prob, thresh, alias = alias_mod.build_alias_table(areas)
        light_idx = len(light_inst_l)
        light_inst_l.append(i)
        light_area_l.append(total)
        la_prob_l.append(prob)
        la_thresh_l.append(thresh)
        la_alias_l.append(alias.astype(np.int32))
        light_alias_offset_l.append(a_cursor)
        light_alias_size_l.append(prob.shape[0])
        a_cursor += prob.shape[0]
        # world-space light triangles, linear order
        wp0 = math3d.transform_points(inst.frame, p0)
        wp1 = math3d.transform_points(inst.frame, p1)
        wp2 = math3d.transform_points(inst.frame, p2)
        lt_v0_l.append(wp0.astype(np.float32))
        lt_e1_l.append((wp1 - wp0).astype(np.float32))
        lt_e2_l.append((wp2 - wp0).astype(np.float32))
        lt_light_l.append(np.full(tri.shape[0], light_idx, np.int32))
        light_tri_offset_l.append(t_cursor)
        light_tri_count_l.append(tri.shape[0])
        t_cursor += tri.shape[0]
    nl = len(light_inst_l)

    # ---- environment alias tables (sin-latitude weighting, :65-98) ----
    ea_prob_l, ea_thresh_l, ea_alias_l, env_alias_offset_l = [], [], [], []
    ea_cursor = 0
    env_emission = np.zeros((max(ne, 1), 3), np.float32)
    env_tex = np.full(max(ne, 1), -1, np.int32)
    env_rot = np.tile(np.eye(3, dtype=np.float32), (max(ne, 1), 1, 1))
    for e, env in enumerate(scene.environments):
        env_emission[e] = np.asarray(env.emission, np.float32)[:3]
        ti = int(env.emission_tex_idx) & 0xFFFFFFFF
        scale = env_emission[e]
        if ti != 0xFFFFFFFF:
            env_tex[e] = ti
            pix = scene.textures[ti].data  # (H,W,4) raw values
        else:
            pix = np.ones((1, 1, 4), np.float32)
        env_rot[e] = np.asarray(env.transform, np.float32)[:3, :3]
        h, w = pix.shape[:2]
        ys = (np.arange(h, dtype=np.float32) + 0.5) * np.pi / h
        pe = np.max(pix[..., :3] * scale[None, None, :], axis=-1)
        weights = pe * np.sin(ys)[:, None]
        if not np.any(scale > 0.0):
            weights = np.ones_like(weights)
        prob, thresh, alias = alias_mod.build_alias_table(weights.ravel())
        if prob.shape[0] == 0:  # all-zero emission texture: uniform fallback
            prob, thresh, alias = alias_mod.build_alias_table(
                np.ones(h * w, np.float32)
            )
        ea_prob_l.append(prob)
        ea_thresh_l.append(thresh)
        ea_alias_l.append(alias.astype(np.int32))
        env_alias_offset_l.append(ea_cursor)
        ea_cursor += prob.shape[0]

    # ---- world BVH + superleaf decomposition ----
    use_bvh = two_level or Tw > dense_max_tris
    sl_count = 0
    sl_stride = 0
    msl_count = 0
    top_depth = 1
    top_root_is_leaf = False
    top_tab = np.zeros((1, 1), np.float32)
    sl_sub_arr = np.zeros((1, 8, 8), np.float32)  # (1, NSUB, 8) dummy
    gsl_inst = np.zeros(1, np.int32)
    gsl_msl = np.zeros(1, np.int32)
    if two_level:
        # Two-level analog of the reference's TLAS->BLAS walk
        # (bvh_custom.wgsl:7-110; data_structures.rs:545-641): mesh-space
        # superleaves built ONCE per unique mesh, a condensed top tree over
        # every (instance x mesh-superleaf) world AABB, and per-work-item
        # ray transforms in the pair kernel (unnormalized direction keeps t
        # world-scaled, bvh_custom.wgsl:30-35).
        from ..accel import superleaf as sl_mod

        if sl_stride_opt:
            stride = sl_stride_opt
        else:
            stride = sl_mod.pick_stride(Tw)
            # The top table scales with G = sum over instances of their
            # mesh's superleaf count, NOT with unique mesh triangles: grow
            # the stride until G <= 262144, the JAX package's layout rule
            # (lupinpathtracer_tpu/scene/flatten.py:571; its bound is a TPU
            # memory budget), kept so that this scene is array-equal to the
            # JAX package's. The card's kernels read the table from device
            # memory at any size.
            tri_of_inst = np.array(
                [mesh_tris[inst.mesh_idx] for inst in scene.instances],
                np.int64,
            )
            while stride < 8192:
                g_now = int(np.sum(-(-tri_of_inst // stride)))
                g_next = int(np.sum(-(-tri_of_inst // (stride * 2))))
                # Stop when the table fits — or when doubling no longer
                # shrinks it (instance-count-bound scenes of small meshes:
                # growing the stride only inflated gref*stride+lane
                # triangle ids toward i32 overflow for nothing).
                if g_now <= 262144 or g_next >= g_now:
                    break
                stride *= 2
        orders, valids = [], []
        msl_lo_l, msl_hi_l, msl_sub_l = [], [], []
        msl_of_mesh = {}
        off = 0
        cursor = 0
        for m in used_mesh_ids:
            ntm = mesh_tris[m]
            if ntm == 0:
                msl_of_mesh[m] = (cursor, 0)
                continue
            lo_m, hi_m = bvh_mod.tri_bounds(
                wt_v0[off : off + ntm],
                wt_v0[off : off + ntm] + wt_e1[off : off + ntm],
                wt_v0[off : off + ntm] + wt_e2[off : off + ntm],
            )
            t0 = time.perf_counter()
            tree_m = bvh_mod.build_bvh(lo_m, hi_m, max_leaf_size=bvh_leaf_size)
            t1 = time.perf_counter()
            sls_m = sl_mod.build_superleaves(
                tree_m, ntm, stride=stride, tri_lo=lo_m, tri_hi=hi_m
            )
            BUILD_S["bvh"] += t1 - t0
            BUILD_S["superleaf"] += time.perf_counter() - t1
            orders.append(sls_m.order.astype(np.int64) + off)
            valids.append(sls_m.valid)
            msl_lo_l.append(sls_m.sl_lo)
            msl_hi_l.append(sls_m.sl_hi)
            msl_sub_l.append(sls_m.sl_sub)
            msl_of_mesh[m] = (cursor, sls_m.sl_count)
            cursor += sls_m.sl_count
            off += ntm
        order = np.concatenate(orders)
        valid = np.concatenate(valids)
        for k in wt:
            wt[k] = wt[k][order]
        wt["e1"][~valid] = 0.0
        wt["e2"][~valid] = 0.0
        msl_count = cursor
        msl_lo = np.concatenate(msl_lo_l)
        msl_hi = np.concatenate(msl_hi_l)
        # Mesh-space sub-chunk AABBs, indexed by MESH superleaf (the packet
        # kernel tests them with instance-transformed rays).
        sl_sub_arr = np.concatenate(msl_sub_l)

        # Vectorized (instance x mesh-superleaf) expansion: a Python loop
        # over G pairs dominates flatten time past ~100k instances. The
        # 8-corner transform matches math3d.transform_aabb (base.rs:
        # 1113-1134); bf16 outward rounding in build_top_table keeps the
        # result conservative.
        frames = frames_all  # (ni, 3, 4) f32 — two_level implies ni > 0
        offs = np.array(
            [msl_of_mesh[inst.mesh_idx][0] for inst in scene.instances],
            np.int64,
        )
        cnts = np.array(
            [msl_of_mesh[inst.mesh_idx][1] for inst in scene.instances],
            np.int64,
        )
        g_inst = np.repeat(np.arange(ni, dtype=np.int64), cnts)
        G = int(g_inst.shape[0])
        start = np.cumsum(cnts) - cnts
        g_msl = offs[g_inst] + (np.arange(G, dtype=np.int64) - start[g_inst])
        A = frames[g_inst, :, :3]  # (G,3,3)
        tvec = frames[g_inst, :, 3]  # (G,3)
        corner_mask = np.array(
            [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
            np.float32,
        )  # (8,3)
        lo_g = msl_lo[g_msl]
        hi_g = msl_hi[g_msl]
        corners = (
            lo_g[:, None, :] * (1.0 - corner_mask)
            + hi_g[:, None, :] * corner_mask
        )  # (G,8,3)
        tc = np.einsum("gij,gcj->gci", A, corners) + tvec[:, None, :]
        g_lo = tc.min(axis=1).astype(np.float32)
        g_hi = tc.max(axis=1).astype(np.float32)
        # Child refs are three 8-bit bf16 factors -> 16.7M addressable
        # (renderer.rs:317-319's 1M-instance envelope fits).
        assert 1 <= G < (1 << 24), (
            f"two-level top tree: {G} instance-superleaves exceeds the "
            "3-factor reference encoding"
        )
        # Padded-soup triangle ids are gref*stride + lane in i32 (both
        # traversal backends); an overflowing encoding returns hits with
        # silently wrong instance/attribute bindings (caught at 1M
        # instances x stride 8192).
        assert G * stride <= 2**31 - 1, (
            f"two-level triangle ids overflow i32: {G} instance-superleaves"
            f" x stride {stride}; pass a smaller sl_stride_opt"
        )
        if G > 262144:
            import warnings

            warnings.warn(
                f"two-level top tree over {G} instance-superleaves: past the"
                " JAX package's layout bound (262144). Bounce batches take"
                " the sort wavefront as always; camera batches take it too"
                " beyond intersect.PACKET_MAX_GSL (131072) superleaves"
                " (kernels/intersect.py::packet_eligible). A larger superleaf"
                " stride (sl_stride_opt) gives fewer, larger superleaves.",
                stacklevel=2,
            )
        gsl_inst = np.asarray(g_inst, np.int32)
        gsl_msl = np.asarray(g_msl, np.int32)
        t0 = time.perf_counter()
        top_tab, _rows, top_root_is_leaf, top_depth = sl_mod.build_top_table(
            np.asarray(g_lo, np.float32), np.asarray(g_hi, np.float32)
        )
        BUILD_S["superleaf"] += time.perf_counter() - t0
        sl_count = G
        sl_stride = stride
        Tw_padded = order.shape[0]
        # No jnp masked-stack fallback for two-level: placeholders.
        bvh_min = np.zeros((1, 3), np.float32)
        bvh_max = np.zeros((1, 3), np.float32)
        bvh_first = np.zeros(1, np.int32)
        bvh_count = np.zeros(1, np.int32)
        bvh_depth = 1
    elif Tw > 0:
        # Superleaf tables are built for EVERY single-level scene — dense
        # scenes included — so both traversal backends exist and
        # PathtraceDesc.force_software_bvh can flip per dispatch, matching
        # the reference's build_sw_and_hw + per-dispatch pipeline selection
        # (data_structures.rs:694-699, renderer.rs:764, :772).
        from ..accel import superleaf as sl_mod

        t0 = time.perf_counter()
        lo, hi = bvh_mod.tri_bounds(wt_v0, wt_v0 + wt_e1, wt_v0 + wt_e2)
        tree = bvh_mod.build_bvh(lo, hi, max_leaf_size=bvh_leaf_size)
        t1 = time.perf_counter()
        sls = sl_mod.build_superleaves(
            tree, Tw, stride=sl_stride_opt, tri_lo=lo, tri_hi=hi
        )
        # Repack the soup into fixed-stride superleaf blocks (the wavefront
        # kernel addresses a superleaf's triangles purely by its id).
        order = sls.order.astype(np.int64)
        for k in wt:
            wt[k] = wt[k][order]
        # Degenerate the padding rows so they can never report a hit
        # (det = 0 -> invalid in every intersector).
        inval = ~sls.valid
        wt["e1"][inval] = 0.0
        wt["e2"][inval] = 0.0
        BUILD_S["bvh"] = t1 - t0
        BUILD_S["superleaf"] = time.perf_counter() - t1
        # Remap the legacy (CPU/jnp) traversal's leaf ranges into the
        # repacked soup: a SAH leaf is inside one superleaf, so its range
        # stays contiguous.
        leaf = tree.tri_count > 0
        bvh_first = tree.first_or_begin.copy()
        bvh_first[leaf] = sls.bvhpos_to_padded[tree.first_or_begin[leaf]]
        bvh_min, bvh_max = tree.aabb_min, tree.aabb_max
        bvh_count = tree.tri_count
        bvh_depth = tree.depth
        sl_count = sls.sl_count
        sl_stride = sls.stride
        msl_count = sls.sl_count
        # Identity maps: single-level scenes ARE their own mesh space.
        gsl_inst = np.zeros(max(sl_count, 1), np.int32)
        gsl_msl = np.arange(max(sl_count, 1), dtype=np.int32)
        top_depth = sls.top_depth
        top_root_is_leaf = sls.top_root_is_leaf
        top_tab = sls.top_tab
        if sls.sl_sub is not None:
            sl_sub_arr = sls.sl_sub
        Tw_padded = sls.order.shape[0]
    else:
        bvh_min = np.zeros((1, 3), np.float32)
        bvh_max = np.zeros((1, 3), np.float32)
        bvh_first = np.zeros(1, np.int32)
        bvh_count = np.array([Tw], np.int32)
        bvh_depth = 1
        Tw_padded = Tw

    # Pad the triangle soup: to a lane multiple for the dense MXU kernel, plus
    # slack so leaf-block gathers (begin + leaf_size) never run off the end.
    pad_to = max(((Tw_padded + 127) // 128) * 128, 128) + bvh_leaf_size
    for k in wt:
        wt[k] = _pad_rows(wt[k], pad_to)
    wt_v0, wt_e1, wt_e2 = wt["v0"], wt["e1"], wt["e2"]

    # ---- materials ----
    mat_color = np.zeros((max(nmat, 1), 4), np.float32)
    mat_color[:, 3] = 1.0
    mat_emission = np.zeros((max(nmat, 1), 3), np.float32)
    mat_scattering = np.zeros((max(nmat, 1), 3), np.float32)
    mat_type = np.zeros(max(nmat, 1), np.int32)
    mat_roughness = np.zeros(max(nmat, 1), np.float32)
    mat_metallic = np.zeros(max(nmat, 1), np.float32)
    mat_ior = np.full(max(nmat, 1), 1.5, np.float32)
    mat_aniso = np.zeros(max(nmat, 1), np.float32)
    mat_trd = np.full(max(nmat, 1), 0.01, np.float32)
    mat_tex = np.full((max(nmat, 1), 5), -1, np.int32)
    for i, mat in enumerate(scene.materials):
        mat_color[i] = np.asarray(mat.color, np.float32)
        mat_emission[i] = np.asarray(mat.emission, np.float32)[:3]
        mat_scattering[i] = np.asarray(mat.scattering, np.float32)[:3]
        mat_type[i] = int(mat.mat_type)
        mat_roughness[i] = mat.roughness
        mat_metallic[i] = mat.metallic
        mat_ior[i] = mat.ior
        mat_aniso[i] = mat.sc_anisotropy
        mat_trd[i] = mat.tr_depth
        for k, name in enumerate(
            (
                "color_tex_idx",
                "emission_tex_idx",
                "roughness_tex_idx",
                "scattering_tex_idx",
                "normal_tex_idx",
            )
        ):
            t = int(getattr(mat, name)) & 0xFFFFFFFF
            mat_tex[i, k] = -1 if t == 0xFFFFFFFF else t

    # ---- texture atlas ----
    tex_offset = np.zeros(max(nt, 1), np.int32)
    tex_w = np.ones(max(nt, 1), np.int32)
    tex_h = np.ones(max(nt, 1), np.int32)
    tex_is_ldr = np.zeros(max(nt, 1), bool)
    if nt:
        chunks = []
        cursor = 0
        for i, tex in enumerate(scene.textures):
            h, w = tex.data.shape[:2]
            tex_offset[i] = cursor
            tex_w[i] = w
            tex_h[i] = h
            d = tex.data.reshape(-1, 4).astype(np.float32)
            chunks.append(d)
            # 8-bit-exact in [0,1]: the packed u32 atlas reproduces it
            # bit-for-bit (PNG/JPG loads are k/255).
            q = np.round(d * 255.0)
            tex_is_ldr[i] = bool(
                (d >= 0.0).all() and (d <= 1.0).all()
                and np.array_equal(q / 255.0, d)
            )
            cursor += h * w
        tex_data = np.concatenate(chunks, axis=0)
    else:
        tex_data = np.ones((1, 4), np.float32)

    # ---- alpha usage (gates the stochastic alpha-skip loop) ----
    # Scanned once per USED material/mesh, not per instance: a full
    # texture-alpha .min() per instance made flatten O(instances x
    # texture pixels) on exactly the 100k-instance scenes this round
    # vectorized everything else for.
    has_alpha = False
    for mi in {inst.mat_idx for inst in scene.instances}:
        mat = scene.materials[mi]
        if float(np.asarray(mat.color)[3]) < 1.0:
            has_alpha = True
        t = int(mat.color_tex_idx) & 0xFFFFFFFF
        if (
            t != 0xFFFFFFFF and nt
            and float(scene.textures[t].data[..., 3].min()) < 1.0
        ):
            has_alpha = True
    for mi in {inst.mesh_idx for inst in scene.instances}:
        mesh = scene.meshes[mi]
        if mesh.colors is not None and float(mesh.colors[:, 3].min()) < 1.0:
            has_alpha = True

    # ---- packed attribute matrix (dense Pallas kernel's in-kernel fetch;
    # the BVH wavefront's attr_fetch reads the same rows per superleaf) ----
    if Tw > 0:
        from ..kernels import dense_intersect as pk

        Tp = wt["v0"].shape[0]
        A = np.zeros((Tp, pk.ATTR_WIDTH), np.float32)
        A[:, pk.ATTR_N0] = wt["n0"]
        A[:, pk.ATTR_N1] = wt["n1"]
        A[:, pk.ATTR_N2] = wt["n2"]
        A[:, pk.ATTR_GN] = wt["gn"]
        A[:, pk.ATTR_UV0] = wt["uv0"]
        A[:, pk.ATTR_UV1] = wt["uv1"]
        A[:, pk.ATTR_UV2] = wt["uv2"]
        A[:, pk.ATTR_HAS_UV] = wt["has_uv"]
        A[:, pk.ATTR_C0] = wt["c0"]
        A[:, pk.ATTR_C1] = wt["c1"]
        A[:, pk.ATTR_C2] = wt["c2"]
        A[:, pk.ATTR_TAN] = wt["tan"]
        A[:, pk.ATTR_BIT] = wt["bit"]
        mid = wt["mat"].astype(np.int64)
        A[:, pk.ATTR_MAT_COLOR] = mat_color[mid]
        A[:, pk.ATTR_MAT_EMISSION] = mat_emission[mid]
        A[:, pk.ATTR_MAT_SCATTERING] = mat_scattering[mid]
        A[:, pk.ATTR_MAT_TYPE] = mat_type[mid]
        A[:, pk.ATTR_MAT_ROUGHNESS] = mat_roughness[mid]
        A[:, pk.ATTR_MAT_METALLIC] = mat_metallic[mid]
        A[:, pk.ATTR_MAT_IOR] = mat_ior[mid]
        A[:, pk.ATTR_MAT_ANISO] = mat_aniso[mid]
        A[:, pk.ATTR_MAT_TRDEPTH] = mat_trd[mid]
        A[:, pk.ATTR_MAT_TEX] = mat_tex[mid]
        if two_level:
            # Mesh-space soup: wt["inst"] holds MESH ids here, and the
            # object-space intersection already carries the reference's
            # backside sign (closest_hit bypasses the det fixup), so this
            # column is never consumed on the two-level path. Bake 1.0
            # instead of indexing the per-INSTANCE array with mesh ids —
            # that crashed flatten whenever a used mesh id >= num_instances.
            A[:, pk.ATTR_DET_SIGN] = 1.0
        else:
            A[:, pk.ATTR_DET_SIGN] = inst_det_sign[
                wt["inst"].astype(np.int64)
            ]
        A[:, pk.ATTR_MAT_ID] = wt["mat"]
        A[:, pk.ATTR_INST_ID] = wt["inst"]
        A[:, pk.ATTR_TRI_ID] = wt["tri"]
        wt_attr = A
    else:
        from ..kernels import dense_intersect as pk

        wt_attr = np.zeros((1, pk.ATTR_WIDTH), np.float32)

    # ---- static feature flags over materials/meshes actually used ----
    from ..core.types import MaterialType as MT

    used_mats = {inst.mat_idx for inst in scene.instances}
    used_meshes = {inst.mesh_idx for inst in scene.instances}
    present_types = sorted(
        {int(scene.materials[m].mat_type) for m in used_mats}
    ) or [int(MT.MATTE)]
    any_uv = any(scene.meshes[m].texcoords is not None for m in used_meshes)
    any_vn = any(scene.meshes[m].normals is not None for m in used_meshes)
    any_vc = any(scene.meshes[m].colors is not None for m in used_meshes)
    any_nm = any_uv and any(
        (int(scene.materials[m].normal_tex_idx) & 0xFFFFFFFF) != 0xFFFFFFFF
        for m in used_mats
    )
    _slot_fields = (
        "color_tex_idx", "emission_tex_idx", "roughness_tex_idx",
        "scattering_tex_idx",
    )
    tex_slot_used = tuple(
        any(
            (int(getattr(scene.materials[m], f)) & 0xFFFFFFFF) != 0xFFFFFFFF
            for m in used_mats
        )
        for f in _slot_fields
    )
    # Every texture any used material binds (all 5 slots) is 8-bit-exact ->
    # material fetches take the packed-u32 path.
    _mat_tex_ids = {
        (int(getattr(scene.materials[m], f)) & 0xFFFFFFFF)
        for m in used_mats
        for f in _slot_fields + ("normal_tex_idx",)
    } - {0xFFFFFFFF}
    mat_tex_ldr = bool(_mat_tex_ids) and all(
        tex_is_ldr[t] for t in _mat_tex_ids
    )
    if mat_tex_ldr:
        q = np.clip(np.round(tex_data * 255.0), 0, 255).astype(np.uint32)
        tex_data_u32 = (
            q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)
        )
    else:
        tex_data_u32 = np.zeros(1, np.uint32)
    vol_types = {int(MT.REFRACTIVE), int(MT.VOLUMETRIC), int(MT.SUBSURFACE)}
    any_vol = bool(vol_types & set(present_types))
    delta_types = {
        int(MT.REFLECTIVE),
        int(MT.REFRACTIVE),
        int(MT.TRANSPARENT),
        int(MT.VOLUMETRIC),
    }
    any_delta = bool(delta_types & set(present_types))

    def cat_or_zero(lst, dtype):
        if lst:
            return np.concatenate(lst).astype(dtype)
        return np.zeros(1, dtype)

    def cat_rows_or_zero(lst):
        if lst:
            return np.concatenate(lst).astype(np.float32)
        return np.zeros((1, 3), np.float32)

    # Per-global-superleaf streaming metadata for the packet kernel's
    # HBM-resident two-level mode (kernels/pallas_packet.py TL_STREAM):
    # one 64-byte row [msl, inst, inst_inv(12), 0, 0] DMA'd per leaf visit
    # instead of SMEM-resident gsl/transform tables, so the instance
    # envelope is not SMEM-bound (renderer.rs:317-319 allows 1M instances).
    # msl/inst ride as f32 (exact to 2^24 — matches the 3-factor child-ref
    # encoding's 16.7M cap).
    # Rows are padded to the 128-lane tile: Mosaic only DMAs lane-tile-
    # aligned extents along the minor dim, and a 16-wide row is rejected
    # ("Slice shape along dimension 1 must be aligned to tiling (128)";
    # same class as the WROWS coefficient padding). The port keeps the
    # layout so its tables match the JAX package's.
    if two_level:
        inv12 = inst_inv.reshape(-1, 12)
        gsl_meta = np.zeros((gsl_msl.shape[0], 128), np.float32)
        gsl_meta[:, 0] = gsl_msl
        gsl_meta[:, 1] = gsl_inst
        gsl_meta[:, 2:14] = inv12[gsl_inst]
    else:
        gsl_meta = np.zeros((1, 128), np.float32)
    statics = dict(
        num_meshes=nm,
        num_instances=ni,
        num_materials=nmat,
        num_envs=ne,
        num_lights=nl,
        num_textures=nt,
        num_world_tris=Tw,
        use_bvh=bool(use_bvh),
        bvh_depth=int(bvh_depth),
        bvh_leaf_size=int(bvh_leaf_size),
        sl_count=int(sl_count),
        sl_stride=int(sl_stride),
        two_level=bool(two_level),
        msl_count=int(msl_count),
        top_depth=int(top_depth),
        top_root_is_leaf=bool(top_root_is_leaf),
        has_alpha=bool(has_alpha),
        envs_empty=ne == 0,
        lights_empty=nl == 0,
        instances_empty=ni == 0 or Tw == 0,
        present_mat_types=tuple(present_types),
        any_uv=bool(any_uv),
        tex_slot_used=tex_slot_used,
        any_vert_normals=bool(any_vn),
        any_vert_colors=bool(any_vc),
        any_normal_maps=bool(any_nm),
        any_volumetric=bool(any_vol),
        any_delta=bool(any_delta),
        mat_tex_ldr=bool(mat_tex_ldr),
        env_has_tex=tuple(bool(t >= 0) for t in env_tex),
    )
    arrays = dict(
        verts_pos=verts_pos,
        verts_normal=verts_normal,
        verts_uv=verts_uv,
        verts_color=verts_color,
        tri_indices=tri_indices,
        mesh_has_normals=mesh_has_normals,
        mesh_has_uv=mesh_has_uv,
        mesh_has_color=mesh_has_color,
        inst_inv=inst_inv,
        inst_fwd=inst_fwd,
        inst_normal_mat=inst_nrm,
        inst_mesh=inst_mesh,
        inst_mat=inst_mat,
        inst_det_sign=inst_det_sign,
        wt_attr=wt_attr,
        bvh_min=np.ascontiguousarray(bvh_min.T),
        bvh_max=np.ascontiguousarray(bvh_max.T),
        bvh_first=np.asarray(bvh_first, np.int32),
        bvh_count=np.asarray(bvh_count, np.int32),
        top_tab=np.asarray(top_tab, np.float32),
        sl_sub=sl_sub_arr,
        gsl_inst=gsl_inst,
        gsl_msl=gsl_msl,
        gsl_meta=gsl_meta,
        mat_color=mat_color.T,
        mat_emission=mat_emission.T,
        mat_scattering=mat_scattering.T,
        mat_type=mat_type,
        mat_roughness=mat_roughness,
        mat_metallic=mat_metallic,
        mat_ior=mat_ior,
        mat_sc_anisotropy=mat_aniso,
        mat_tr_depth=mat_trd,
        mat_tex=mat_tex.T,
        tex_data=np.ascontiguousarray(tex_data.T),
        tex_data_u32=tex_data_u32,
        tex_offset=tex_offset,
        tex_width=tex_w,
        tex_height=tex_h,
        env_emission=env_emission,
        env_tex=env_tex,
        env_rot=env_rot,
        light_inst=(
            np.asarray(light_inst_l, np.int32) if nl else np.zeros(1, np.int32)
        ),
        light_area=(
            np.asarray(light_area_l, np.float32) if nl else np.ones(1, np.float32)
        ),
        la_prob=cat_or_zero(la_prob_l, np.float32),
        la_thresh=cat_or_zero(la_thresh_l, np.float32),
        la_alias=cat_or_zero(la_alias_l, np.int32),
        light_alias_offset=(
            np.asarray(light_alias_offset_l, np.int32) if nl else np.zeros(1, np.int32)
        ),
        light_alias_size=(
            np.asarray(light_alias_size_l, np.int32) if nl else np.ones(1, np.int32)
        ),
        ea_prob=cat_or_zero(ea_prob_l, np.float32),
        ea_thresh=cat_or_zero(ea_thresh_l, np.float32),
        ea_alias=cat_or_zero(ea_alias_l, np.int32),
        env_alias_offset=(
            np.asarray(env_alias_offset_l, np.int32) if ne else np.zeros(1, np.int32)
        ),
        lt_v0=cat_rows_or_zero(lt_v0_l).T,
        lt_e1=cat_rows_or_zero(lt_e1_l).T,
        lt_e2=cat_rows_or_zero(lt_e2_l).T,
        lt_light=cat_or_zero(lt_light_l, np.int32),
        light_tri_offset=(
            np.asarray(light_tri_offset_l, np.int32) if nl else np.zeros(1, np.int32)
        ),
        light_tri_count=(
            np.asarray(light_tri_count_l, np.int32) if nl else np.zeros(1, np.int32)
        ),
    )
    for k in ("v0", "e1", "e2", "n0", "n1", "n2", "gn", "uv0", "uv1", "uv2",
              "c0", "c1", "c2", "tan", "bit"):
        arrays["wt_" + k] = wt[k].T
    for k in ("inst", "tri", "mat", "has_uv"):
        arrays["wt_" + k] = wt[k]
    BUILD_S["flatten"] = (time.perf_counter() - t_start - BUILD_S["bvh"]
                          - BUILD_S["superleaf"])
    return arrays, statics


def _to_tensor(name: str, a, device) -> torch.Tensor:
    """One SceneTPU/flatten array as a tensor: float32/int32 as they are,
    the packed RGBA8 atlas (u32) as int64 holding the u32 value, the
    bf16-rounded top table as bfloat16 (as the JAX scene stores it)."""

    a = np.asarray(a)
    if name == "top_tab":
        return torch.from_numpy(
            np.ascontiguousarray(a.astype(np.float32))
        ).to(device=device, dtype=torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    elif a.dtype == np.bool_:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)  # owned copy


def pack_bvh_nodes(bvh_min, bvh_max, bvh_first, bvh_count) -> np.ndarray:
    """The binary BVH as the walk kernel reads it (kernels/walk.py,
    csrc/walk.cu): (n_nodes, 8) f32, per node 32 bytes (min.xyz, first)
    and (max.xyz, count), the two ints' bits in the float lanes, from the
    component-major (3, n_nodes) boxes and the per-node ints."""

    first = np.asarray(bvh_first, np.int32)
    out = np.empty((first.shape[0], 8), np.float32)
    out[:, 0:3] = np.asarray(bvh_min, np.float32).T
    out[:, 3] = first.view(np.float32)
    out[:, 4:7] = np.asarray(bvh_max, np.float32).T
    out[:, 7] = np.asarray(bvh_count, np.int32).view(np.float32)
    return out


def scene_from_numpy(arrays: dict, statics: dict, device) -> SceneTorch:
    """Build a SceneTorch from numpy arrays and static fields: the output of
    `flatten_numpy`, or a JAX SceneTPU carried across
    (`{f: np.asarray(getattr(tpu, f)) for f in ARRAY_FIELDS}` and
    `{f: getattr(tpu, f) for f in STATIC_FIELDS}`). A single-level scene
    with a BVH also gets `bvh_nodes`, its node table packed for the walk
    kernel (pack_bvh_nodes)."""

    device = torch.device(device)
    tensors = {f: _to_tensor(f, arrays[f], device) for f in ARRAY_FIELDS}
    if not statics["two_level"] and statics["sl_count"] > 0:
        tensors["bvh_nodes"] = torch.from_numpy(pack_bvh_nodes(
            arrays["bvh_min"], arrays["bvh_max"], arrays["bvh_first"],
            arrays["bvh_count"])).to(device)
    return SceneTorch(statics={f: statics[f] for f in STATIC_FIELDS},
                      tensors=tensors)


def build_scene_torch(scene: SceneCPU, device="cuda", **kwargs) -> SceneTorch:
    """Flatten + build acceleration structures + move to `device` (CUDA by
    default; raises when no GPU is present). kwargs go to flatten_numpy.
    Sets BUILD_S."""

    device = resolve_device(device)
    arrays, statics = flatten_numpy(scene, **kwargs)
    t0 = time.perf_counter()
    ts = scene_from_numpy(arrays, statics, device)
    if ts.device.type == "cuda":
        torch.cuda.synchronize(ts.device)
    BUILD_S["device"] = time.perf_counter() - t0
    return ts
