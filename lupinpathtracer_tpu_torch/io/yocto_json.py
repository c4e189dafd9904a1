"""Yocto/GL v2.4 JSON scene loader.

A copy of lupinpathtracer_tpu/io/yocto_json.py (the port imports nothing of
the JAX package; it reads the port's own core/math3d.py, core/types.py and
scene/scene.py), a rebuild of the reference's scene parser
(lupin_loader/src/loader.rs:331-911). The reference hand-rolls a byte-level
JSON parser because Rust; the scene files are plain JSON, so we use the
stdlib parser and keep the *semantics*:

- handedness conversion to left-handed: C*M*C for camera frames
  (loader.rs:402), C*M for instance frames (loader.rs:653) and environment
  frames (loader.rs:345-349, 470-475), with C = diag(1,1,-1).
- materials: same key set and defaults (parse_material_yocto_v24,
  loader.rs:770-911); "opacity" lands in color.w.
- shapes are binary PLY files resolved relative to the scene file.
- textures load lazily by uri; environment textures additionally keep CPU
  pixels for alias-table construction (loader.rs:725-762) — here all texture
  pixels are host-resident anyway.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core import math3d
from ..core.types import (
    CameraParams,
    Environment,
    Material,
    MaterialType,
    SceneCamera,
    SENTINEL_IDX,
)
from ..scene.scene import InstanceCPU, SceneCPU
from . import ply as ply_io
from . import textures as tex_io

_MAT_TYPES = {
    "matte": MaterialType.MATTE,
    "glossy": MaterialType.GLOSSY,
    "reflective": MaterialType.REFLECTIVE,
    "transparent": MaterialType.TRANSPARENT,
    "refractive": MaterialType.REFRACTIVE,
    "subsurface": MaterialType.SUBSURFACE,
    "volume": MaterialType.VOLUMETRIC,
    "gltfpbr": MaterialType.GLTFPBR,
}


def _parse_material(m: dict) -> Material:
    mat = Material()
    if "color" in m:
        c = np.asarray(m["color"], np.float32)
        mat.color = np.array([c[0], c[1], c[2], 1.0], np.float32)
    if "opacity" in m:
        mat.color = mat.color.copy()
        mat.color[3] = float(m["opacity"])
    if "emission" in m:
        e = np.asarray(m["emission"], np.float32)
        mat.emission = np.array([e[0], e[1], e[2], 0.0], np.float32)
    if "scattering" in m:
        s = np.asarray(m["scattering"], np.float32)
        mat.scattering = np.array([s[0], s[1], s[2], 0.0], np.float32)
    mat.roughness = float(m.get("roughness", mat.roughness))
    mat.metallic = float(m.get("metallic", mat.metallic))
    mat.ior = float(m.get("ior", mat.ior))
    mat.sc_anisotropy = float(m.get("scanisotropy", mat.sc_anisotropy))
    mat.tr_depth = float(m.get("trdepth", mat.tr_depth))
    mat.mat_type = _MAT_TYPES.get(m.get("type", ""), mat.mat_type)
    for json_key, attr in (
        ("color_tex", "color_tex_idx"),
        ("emission_tex", "emission_tex_idx"),
        ("roughness_tex", "roughness_tex_idx"),
        ("scattering_tex", "scattering_tex_idx"),
        ("normal_tex", "normal_tex_idx"),
    ):
        if json_key in m:
            setattr(mat, attr, int(m[json_key]))
    return mat


def load_scene_yoctogl_v24(path) -> tuple[SceneCPU, list[SceneCamera]]:
    """Parse scene JSON + referenced PLYs/textures into a SceneCPU."""

    parent = os.path.dirname(os.path.abspath(path))
    with open(path, "r") as f:
        doc = json.load(f)

    scene = SceneCPU()
    cameras: list[SceneCamera] = []

    for cam in doc.get("cameras", []):
        sc = SceneCamera()
        p = CameraParams()
        if "frame" in cam:
            sc.transform = math3d.convert_camera_frame(
                math3d.frame_from_yocto(cam["frame"])
            )
        else:
            sc.transform = math3d.frame_identity()
        p.aspect = float(cam.get("aspect", p.aspect))
        p.focus = float(cam.get("focus", p.focus))
        p.aperture = float(cam.get("aperture", p.aperture))
        p.lens = float(cam.get("lens", p.lens))
        p.film = float(cam.get("film", p.film))
        p.is_orthographic = bool(cam.get("orthographic", p.is_orthographic))
        sc.params = p
        cameras.append(sc)

    tex_paths: list[str | None] = []
    for tex in doc.get("textures", []):
        uri = tex.get("uri", "")
        tex_paths.append(os.path.join(parent, uri) if uri else None)

    for env_doc in doc.get("environments", []):
        env = Environment()
        conv = math3d.frame_identity()
        conv[:, :3] = math3d.HANDEDNESS
        frame = (
            math3d.frame_from_yocto(env_doc["frame"])
            if "frame" in env_doc
            else math3d.frame_identity()
        )
        env.transform = math3d.frame_to_mat4(math3d.frame_compose(conv, frame))
        if "emission" in env_doc:
            env.emission = np.asarray(env_doc["emission"], np.float32)
        if "emission_tex" in env_doc:
            env.emission_tex_idx = int(env_doc["emission_tex"])
        scene.environments.append(env)

    for mdoc in doc.get("materials", []):
        scene.add_material(_parse_material(mdoc))

    for shape in doc.get("shapes", []):
        uri = shape.get("uri", "")
        full = os.path.join(parent, uri)
        ext = os.path.splitext(uri)[1].lower()
        if ext != ".ply":
            raise ValueError(f"unsupported shape format: {uri}")
        scene.add_mesh(ply_io.load_mesh_ply(full))

    for idoc in doc.get("instances", []):
        inst = InstanceCPU()
        frame = (
            math3d.frame_from_yocto(idoc["frame"])
            if "frame" in idoc
            else math3d.frame_identity()
        )
        inst.frame = math3d.convert_instance_frame(frame)
        inst.mat_idx = int(idoc.get("material", 0))
        inst.mesh_idx = int(idoc.get("shape", 0))
        scene.add_instance(inst)

    for tp in tex_paths:
        if tp is None:
            # Keep index alignment for unset uris (degenerate 1x1 white).
            from ..scene.scene import TextureCPU

            scene.add_texture(TextureCPU(data=np.ones((1, 1, 4), np.float32)))
        else:
            scene.add_texture(tex_io.load_texture(tp))

    return scene, cameras
