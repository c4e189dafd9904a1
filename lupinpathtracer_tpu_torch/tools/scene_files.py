"""Scene files from in-memory scenes: the inverse of io/ply.py and
io/yocto_json.py.

`write_ply` stores a MeshCPU as a binary little-endian PLY that
io/ply.load_mesh_ply reads back: every vertex property as a float (the
loader reads each one as little-endian f32, colors included), v stored as
1 - v (the loader flips it back in f32, so texcoords return within one
ulp of 1.0), faces as triangles. `write_yocto` stores a SceneCPU and its
cameras as a Yocto/GL v2.4 JSON scene with one PLY per mesh and one image
per texture; io/yocto_json.load_scene_yoctogl_v24 reads it back. It
inverts the loader's rules: `_parse_material` field by field, the yocto
frame layout (x, y, z axes and origin as columns) and the two handedness
conversions (C*M*C for cameras, C*M for instances and environments, with
C = diag(1, 1, -1)), which are involutions and so exact.

`textured_cornell` builds the scene that carries textures and an
environment through the renderer: the Cornell walls and light, a quad
with a color texture (alpha below 1 on part of it unless `opaque`), a
normal map and an emission texture, an HDR lat-long environment through
`emission_tex`, and optionally a UV sphere with the normal-mapped
material (enough triangles take the BVH route).

Test and card tooling (tests/test_torch_io.py, tests/test_torch_apps.py,
chip_smoke.py); no render path imports it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core import math3d
from ..core.types import Environment, Material, MaterialType, SENTINEL_IDX
from ..scene.scene import InstanceCPU, MeshCPU, SceneCPU, TextureCPU

# The inverse of yocto_json._MAT_TYPES.
_MAT_NAMES = {
    MaterialType.MATTE: "matte",
    MaterialType.GLOSSY: "glossy",
    MaterialType.REFLECTIVE: "reflective",
    MaterialType.TRANSPARENT: "transparent",
    MaterialType.REFRACTIVE: "refractive",
    MaterialType.SUBSURFACE: "subsurface",
    MaterialType.VOLUMETRIC: "volume",
    MaterialType.GLTFPBR: "gltfpbr",
}
_TEX_KEYS = (
    ("color_tex", "color_tex_idx"),
    ("emission_tex", "emission_tex_idx"),
    ("roughness_tex", "roughness_tex_idx"),
    ("scattering_tex", "scattering_tex_idx"),
    ("normal_tex", "normal_tex_idx"),
)
_UNSET = int(SENTINEL_IDX) & 0xFFFFFFFF


def _handedness() -> np.ndarray:
    c = math3d.frame_identity()
    c[:, :3] = math3d.HANDEDNESS
    return c


def _yocto_frame(frame: np.ndarray) -> list:
    """math3d.frame_from_yocto's inverse: the columns, x axis first."""

    return [float(v) for v in np.asarray(frame, np.float32).T.reshape(-1)]


def write_ply(path, mesh: MeshCPU) -> None:
    """Binary little-endian PLY of `mesh` (positions, and normals, uvs and
    RGBA colors where the mesh has them)."""

    cols = [("x", "y", "z")]
    arrays = [np.asarray(mesh.positions, np.float32)]
    if mesh.normals is not None:
        cols.append(("nx", "ny", "nz"))
        arrays.append(np.asarray(mesh.normals, np.float32))
    if mesh.texcoords is not None:
        uv = np.asarray(mesh.texcoords, np.float32)
        cols.append(("u", "v"))
        arrays.append(np.stack([uv[:, 0], np.float32(1.0) - uv[:, 1]], axis=1))
    if mesh.colors is not None:
        cols.append(("red", "green", "blue", "alpha"))
        arrays.append(np.asarray(mesh.colors, np.float32))
    verts = np.ascontiguousarray(np.concatenate(arrays, axis=1), "<f4")
    idx = np.asarray(mesh.indices).reshape(-1, 3).astype("<u4")
    faces = np.empty((idx.shape[0], 13), np.uint8)
    faces[:, 0] = 3
    faces[:, 1:] = idx.view(np.uint8).reshape(-1, 12)
    names = [n for group in cols for n in group]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {verts.shape[0]}",
              *(f"property float {n}" for n in names),
              f"element face {idx.shape[0]}",
              "property list uchar uint vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(verts.tobytes())
        f.write(faces.tobytes())


def material_doc(mat: Material) -> dict:
    """yocto_json._parse_material's inverse, every key written."""

    c = np.asarray(mat.color, np.float32)
    doc = {
        "type": _MAT_NAMES[MaterialType(int(mat.mat_type))],
        "color": [float(v) for v in c[:3]],
        "opacity": float(c[3]),
        "emission": [float(v) for v in np.asarray(mat.emission, np.float32)[:3]],
        "scattering": [float(v) for v in np.asarray(mat.scattering, np.float32)[:3]],
        "roughness": float(mat.roughness),
        "metallic": float(mat.metallic),
        "ior": float(mat.ior),
        "scanisotropy": float(mat.sc_anisotropy),
        "trdepth": float(mat.tr_depth),
    }
    for key, attr in _TEX_KEYS:
        t = int(getattr(mat, attr)) & 0xFFFFFFFF
        if t != _UNSET:
            doc[key] = t
    return doc


def write_texture(path, tex: TextureCPU) -> None:
    """One texture as an image file that io/textures.load_texture reads:
    .png holds 8-bit RGBA (exact for k/255 data, as PNG loads are), .hdr
    and .exr linear RGB(A) (Radiance RGBE and half floats)."""

    ext = os.path.splitext(str(path))[1].lower()
    data = np.asarray(tex.data, np.float32)
    if ext in (".hdr", ".exr"):
        from ..io import textures as tex_io

        tex_io.save_texture(path, data, srgb_encode=False)
        return
    from PIL import Image

    q = np.clip(np.round(data * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(q, "RGBA").save(path)


def write_yocto(path, scene: SceneCPU, cameras) -> str:
    """Writes `scene` and `cameras` as the Yocto JSON file `path`, its
    meshes as shapes/shapeN.ply and its textures beside it as
    textures/texN.hdr (HDR textures) or textures/texN.png (the rest).
    Returns path."""

    root = os.path.dirname(os.path.abspath(path))
    os.makedirs(os.path.join(root, "shapes"), exist_ok=True)
    C = _handedness()
    doc: dict = {"cameras": [
        {
            "frame": _yocto_frame(math3d.frame_compose(
                math3d.frame_compose(C, cam.transform), C)),
            "aspect": float(cam.params.aspect),
            "focus": float(cam.params.focus),
            "aperture": float(cam.params.aperture),
            "lens": float(cam.params.lens),
            "film": float(cam.params.film),
            "orthographic": bool(cam.params.is_orthographic),
        }
        for cam in cameras
    ]}
    texs = []
    if scene.textures:
        os.makedirs(os.path.join(root, "textures"), exist_ok=True)
    for i, tex in enumerate(scene.textures):
        uri = f"textures/tex{i}{'.hdr' if tex.is_hdr else '.png'}"
        write_texture(os.path.join(root, uri), tex)
        texs.append({"uri": uri})
    doc["textures"] = texs
    envs = []
    for env in scene.environments:
        e = {
            "frame": _yocto_frame(math3d.frame_compose(
                C, np.asarray(env.transform, np.float32)[:3, :4])),
            "emission": [float(v) for v in np.asarray(env.emission, np.float32)],
        }
        t = int(env.emission_tex_idx) & 0xFFFFFFFF
        if t != _UNSET:
            e["emission_tex"] = t
        envs.append(e)
    doc["environments"] = envs
    doc["materials"] = [material_doc(m) for m in scene.materials]
    shapes = []
    for i, mesh in enumerate(scene.meshes):
        uri = f"shapes/shape{i}.ply"
        write_ply(os.path.join(root, uri), mesh)
        shapes.append({"uri": uri})
    doc["shapes"] = shapes
    doc["instances"] = [
        {"frame": _yocto_frame(math3d.frame_compose(C, inst.frame)),
         "shape": int(inst.mesh_idx), "material": int(inst.mat_idx)}
        for inst in scene.instances
    ]
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def _k255(a: np.ndarray) -> np.ndarray:
    """Values on the 8-bit lattice (what a PNG load gives)."""

    return (np.clip(np.round(a * 255.0), 0, 255) / 255.0).astype(np.float32)


def _uv_sphere(n_lat: int, n_lon: int, radius: float, center):
    """A UV sphere of 2 * (n_lat - 1) * n_lon triangles with normals and
    texcoords (u around, v from pole to pole), seam vertices duplicated."""

    lat = np.linspace(0.05, np.pi - 0.05, n_lat)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    a, b = np.meshgrid(lat, lon, indexing="ij")
    nrm = np.stack([np.sin(a) * np.cos(b), np.cos(a), np.sin(a) * np.sin(b)],
                   axis=-1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([b / (2.0 * np.pi), a / np.pi], axis=-1).reshape(-1, 2)
    idx = []
    row = n_lon + 1
    for i in range(n_lat - 1):
        for j in range(n_lon):
            p, q = i * row + j, i * row + j + 1
            r, s = (i + 1) * row + j, (i + 1) * row + j + 1
            idx += [[p, r, q], [q, r, s]]
    pos = (nrm * np.float32(radius) + np.asarray(center, np.float32)).astype(np.float32)
    return MeshCPU(positions=pos, indices=np.asarray(idx, np.uint32), normals=nrm,
                   texcoords=uv.astype(np.float32), colors=None)


def textured_cornell(tex_size: int = 256, env_wh=(512, 256), sphere_lat: int = 0,
                     opaque: bool = False, seed: int = 0):
    """The Cornell walls and light with a textured quad (color texture,
    normal map, emission texture; all on the 8-bit lattice, so the packed
    RGBA8 atlas takes them), an HDR environment of env_wh pixels through
    `emission_tex`, and with sphere_lat > 0 a UV sphere of
    2 * (sphere_lat - 1) * 2 * sphere_lat triangles with the normal-mapped
    material. The color texture's alpha is 1 where `opaque`, else below 1
    on a checker of its texels. Returns (SceneCPU, cameras)."""

    from ..io import builtin

    base, cams = builtin.build_scene_cornell_box()
    rng = np.random.default_rng(seed)
    walls = (0, 1, 2, 3, 4, 7)  # floor, ceiling, back, right, left, light
    scene = SceneCPU(materials=base.materials)
    for k, i in enumerate(walls):
        scene.add_mesh(base.meshes[base.instances[i].mesh_idx])
        scene.add_instance(InstanceCPU(frame=base.instances[i].frame, mesh_idx=k,
                                       mat_idx=base.instances[i].mat_idx))
    n = tex_size
    y, x = np.mgrid[0:n, 0:n] / float(n)
    col = np.stack([0.5 + 0.4 * np.sin(12 * x), 0.5 + 0.4 * np.cos(9 * y),
                    0.3 + 0.3 * x * y, np.ones_like(x)], axis=-1)
    if not opaque:
        checker = ((np.mgrid[0:n, 0:n] // max(n // 8, 1)).sum(0) % 2) == 1
        col[..., 3] = np.where(checker & (x < 0.5), 0.35, 1.0)
    tilt = rng.normal(scale=0.25, size=(n, n, 2))
    nz = 1.0 / np.sqrt(1.0 + (tilt ** 2).sum(-1, keepdims=True))
    nmap = np.concatenate([tilt * nz, nz], axis=-1) * 0.5 + 0.5
    emis = np.stack([x, 1.0 - y, 0.5 * np.ones_like(x)], axis=-1) * (
        ((np.mgrid[0:n, 0:n] // max(n // 4, 1)).sum(0) % 2) == 0)[..., None]
    t_col = scene.add_texture(TextureCPU(data=_k255(col)))
    t_nrm = scene.add_texture(TextureCPU(data=_k255(
        np.concatenate([nmap, np.ones((n, n, 1))], axis=-1))))
    t_emi = scene.add_texture(TextureCPU(data=_k255(
        np.concatenate([emis, np.ones((n, n, 1))], axis=-1))))
    ew, eh = env_wh
    v, u = np.mgrid[0:eh, 0:ew] / np.array([eh, ew], np.float64)[:, None, None]
    sky = np.stack([0.6 + 0.4 * u, 0.7 + 0.2 * np.cos(6 * u), 1.2 - v],
                   axis=-1) * (1.0 - 0.8 * v)[..., None]
    sky += np.exp(-((u - 0.3) ** 2 + (v - 0.25) ** 2) * 400.0)[..., None] * 40.0
    sky = np.concatenate([sky, np.ones_like(u)[..., None]], axis=-1)
    t_env = scene.add_texture(TextureCPU(data=sky.astype(np.float32), is_hdr=True))
    mat = scene.add_material(Material(
        color=np.array([0.9, 0.9, 0.9, 1.0], np.float32), mat_type=MaterialType.GLOSSY,
        roughness=0.35, emission=np.array([0.8, 0.8, 0.8, 0.0], np.float32),
        color_tex_idx=t_col, normal_tex_idx=t_nrm, emission_tex_idx=t_emi))
    quad = scene.add_mesh(MeshCPU(
        positions=np.array([[-0.6, 0.3, 0.4], [0.6, 0.3, 0.4], [0.6, 1.5, 0.4],
                            [-0.6, 1.5, 0.4]], np.float32),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.uint32),
        normals=np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (4, 1)),
        texcoords=np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)))
    scene.add_instance(InstanceCPU(frame=math3d.frame_identity(), mesh_idx=quad,
                                   mat_idx=mat))
    if sphere_lat > 0:
        sph_mat = scene.add_material(Material(
            color=np.array([0.8, 0.75, 0.7, 1.0], np.float32),
            mat_type=MaterialType.GLOSSY, roughness=0.25, normal_tex_idx=t_nrm))
        sph = scene.add_mesh(_uv_sphere(sphere_lat, 2 * sphere_lat, 0.35,
                                        (0.35, 0.4, -0.3)))
        scene.add_instance(InstanceCPU(frame=math3d.frame_identity(), mesh_idx=sph,
                                       mat_idx=sph_mat))
    c, s = np.cos(0.4), np.sin(0.4)
    scene.environments.append(Environment(
        emission=np.array([1.0, 1.0, 1.0], np.float32), emission_tex_idx=t_env,
        transform=np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                           np.float32)))
    return scene, cams


def write_scene_dir(root, name: str, scene: SceneCPU, cameras) -> str:
    """The corpus layout, <root>/<name>/<name>.json (apps/golden_test.py
    discovers scenes so); returns the JSON path."""

    os.makedirs(os.path.join(root, name), exist_ok=True)
    return write_yocto(os.path.join(root, name, f"{name}.json"), scene, cameras)

