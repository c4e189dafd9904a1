"""PyTorch port, scene and image files: the port's io/ply.py, io/exr.py,
io/textures.py and io/yocto_json.py against the JAX package's on the same
bytes, written into tmp_path by the port's tools/scene_files.py or by hand
(the reference corpus is not needed), and scene_files' writers against the
in-memory scenes they wrote.

Tolerances: loaders equal exactly (array-equal, field by field); a scene
written and read back equal exactly but for texcoords, within 6e-8 (the
PLY stores 1 - v and the loader flips it back in f32: one ulp near 1.0).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from lupinpathtracer_tpu.io import exr as jexr
from lupinpathtracer_tpu.io import ply as jply
from lupinpathtracer_tpu.io import textures as jtex
from lupinpathtracer_tpu.io import yocto_json as jyocto
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.io import builtin as tbuiltin
from lupinpathtracer_tpu_torch.io import exr as texr
from lupinpathtracer_tpu_torch.io import ply as tply
from lupinpathtracer_tpu_torch.io import synthetic as tsyn
from lupinpathtracer_tpu_torch.io import textures as ttex
from lupinpathtracer_tpu_torch.io import yocto_json as tyocto
from lupinpathtracer_tpu_torch.scene import flatten as tflatten
from lupinpathtracer_tpu_torch.tools import scene_files

UV_ATOL = 6e-8


# -- helpers ------------------------------------------------------------------


def _same(a, b, what, atol=0.0):
    assert (a is None) == (b is None), what
    if a is None:
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if atol:
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def assert_mesh_equal(a, b, uv_atol=0.0):
    _same(a.positions, b.positions, "positions")
    _same(np.asarray(a.indices).astype(np.int64),
          np.asarray(b.indices).astype(np.int64), "indices")
    _same(a.normals, b.normals, "normals")
    _same(a.texcoords, b.texcoords, "texcoords", uv_atol)
    _same(a.colors, b.colors, "colors")


def assert_scene_cpu_equal(a, b, uv_atol=0.0, textures=True):
    """Two SceneCPUs (of either package) equal field by field."""

    assert len(a.meshes) == len(b.meshes)
    for ma, mb in zip(a.meshes, b.meshes):
        assert_mesh_equal(ma, mb, uv_atol)
    assert len(a.instances) == len(b.instances)
    for ia, ib in zip(a.instances, b.instances):
        _same(ia.frame, ib.frame, "frame")
        assert (ia.mesh_idx, ia.mat_idx) == (ib.mesh_idx, ib.mat_idx)
    assert len(a.materials) == len(b.materials)
    for xa, xb in zip(a.materials, b.materials):
        for f in xa.__dataclass_fields__:
            _same(np.asarray(getattr(xa, f)), np.asarray(getattr(xb, f)), f)
            assert type(getattr(xa, f)).__name__ == type(getattr(xb, f)).__name__, f
    assert len(a.environments) == len(b.environments)
    for ea, eb in zip(a.environments, b.environments):
        _same(ea.transform, eb.transform, "env transform")
        _same(ea.emission, eb.emission, "env emission")
        assert ea.emission_tex_idx == eb.emission_tex_idx
    if textures:
        assert len(a.textures) == len(b.textures)
        for ta, tb in zip(a.textures, b.textures):
            _same(ta.data, tb.data, "texture")
            assert ta.is_hdr == tb.is_hdr


def assert_cameras_equal(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        _same(ca.transform, cb.transform, "camera")
        for f in ca.params.__dataclass_fields__:
            assert getattr(ca.params, f) == getattr(cb.params, f), f


def _write_ply(path, header_lines, verts, faces):
    with open(path, "wb") as f:
        f.write(("\n".join(header_lines) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(faces)


def _faces(polys):
    out = b""
    for p in polys:
        out += bytes([len(p)]) + np.asarray(p, "<u4").tobytes()
    return out


def _header(props, nv, nf, end=True):
    return (["ply", "format binary_little_endian 1.0", "comment test",
             f"element vertex {nv}"] + [f"property float {p}" for p in props]
            + [f"element face {nf}", "property list uchar uint vertex_indices"]
            + (["end_header"] if end else []))


# -- PLY ------------------------------------------------------------------------

_ALL = ("x", "y", "z", "nx", "ny", "nz", "u", "v", "red", "green", "blue", "alpha")


@pytest.mark.parametrize("case", ["attrs", "quads", "mixed"])
def test_ply_matches_jax(tmp_path, rng, case):
    """Positions, normals, uvs (v flipped) and colors read as floats; quads
    (uniform arity, the fast path) and quads with pentagons (the byte
    walk) fan-triangulated: both loaders array-equal."""

    nv = 12
    verts = rng.uniform(-1, 1, (nv, len(_ALL))).astype(np.float32)
    polys = {"attrs": [[0, 1, 2], [3, 4, 5], [9, 10, 11]],
             "quads": [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]],
             "mixed": [[0, 1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11]]}[case]
    p = tmp_path / "m.ply"
    _write_ply(p, _header(_ALL, nv, len(polys)), verts, _faces(polys))
    j, t = jply.load_mesh_ply(p), tply.load_mesh_ply(p)
    assert_mesh_equal(j, t)
    assert t.indices.dtype == np.uint32
    assert t.indices.shape[0] == sum(len(q) - 2 for q in polys)
    np.testing.assert_array_equal(t.indices[0], polys[0][:3])
    np.testing.assert_array_equal(t.texcoords[:, 1], np.float32(1.0) - verts[:, 7])


@pytest.mark.parametrize("case", ["no_end_header", "partial_normals", "index_range"])
def test_ply_errors_match_jax(tmp_path, case):
    nv = 4
    props = ("x", "y", "z", "nx") if case == "partial_normals" else ("x", "y", "z")
    verts = np.zeros((nv, len(props)), np.float32)
    polys = [[0, 1, 7]] if case == "index_range" else [[0, 1, 2]]
    p = tmp_path / "bad.ply"
    _write_ply(p, _header(props, nv, 1, end=case != "no_end_header"), verts,
               _faces(polys))
    with pytest.raises(jply.PlyError):
        jply.load_mesh_ply(p)
    with pytest.raises(tply.PlyError):
        tply.load_mesh_ply(p)


# -- EXR ------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["half", "exact_halves", "incompressible",
                                  "odd_height", "rgba"])
def test_exr_round_trip_matches_jax(tmp_path, rng, case):
    """tests/test_exr.py's round trips: the port's writer gives the JAX
    writer's bytes, and both readers the same pixels (half quantization
    only)."""

    img = {
        "half": lambda: rng.uniform(0.0, 8.0, (37, 53, 3)),
        "exact_halves": lambda: rng.uniform(0, 4, (16, 16, 3)).astype(np.float16),
        "incompressible": lambda: rng.standard_normal((18, 24, 3)),
        "odd_height": lambda: rng.uniform(0, 1, (35, 8, 3)),
        "rgba": lambda: rng.uniform(0, 2, (20, 30, 4)),
    }[case]().astype(np.float32)
    pj, pt = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(pj, img)
    texr.write_exr(pt, img)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    back = texr.read_exr(pt)
    np.testing.assert_array_equal(back, jexr.read_exr(pt))
    assert back.shape == img.shape[:2] + (4,) and (back[..., 3] == 1.0).all()
    np.testing.assert_array_equal(back[..., :3],
                                  img[..., :3].astype(np.float16).astype(np.float32))


def test_exr_rejects_non_exr(tmp_path):
    p = str(tmp_path / "bogus.exr")
    with open(p, "wb") as f:
        f.write(b"not an exr at all")
    for mod in (jexr, texr):
        with pytest.raises(ValueError):
            mod.read_exr(p)


# -- textures ---------------------------------------------------------------------


@pytest.mark.parametrize("ext", [".hdr", ".exr", ".png"])
def test_texture_load_save_matches_jax(tmp_path, rng, ext):
    """load_texture on files of either saver equal to the JAX package's;
    a PNG loads 8-bit RGBA exactly (k/255) and scene_files' PNG writer
    keeps alpha."""

    if ext == ".png":
        data = (rng.integers(0, 256, (9, 13, 4)) / 255.0).astype(np.float32)
    else:
        data = rng.uniform(0, 3, (9, 13, 4)).astype(np.float32)
    pt, pj = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    ttex.save_texture(pt, data, srgb_encode=False)
    jtex.save_texture(pj, data, srgb_encode=False)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for p in (pt, pj):
        t, j = ttex.load_texture(p), jtex.load_texture(p)
        np.testing.assert_array_equal(t.data, j.data)
        assert t.is_hdr == j.is_hdr == (ext != ".png")
    if ext == ".png":
        pr = str(tmp_path / "rgba.png")
        scene_files.write_texture(pr, tl.TextureCPU(data=data))
        t = ttex.load_texture(pr)
        np.testing.assert_array_equal(t.data, data)
        np.testing.assert_array_equal(t.data, jtex.load_texture(pr).data)


def test_hdr_textures_need_no_pil(tmp_path, rng, monkeypatch):
    """PIL is imported only for LDR files: .hdr and .exr load and save
    with PIL unavailable."""

    monkeypatch.setitem(sys.modules, "PIL", None)
    data = rng.uniform(0, 3, (5, 7, 4)).astype(np.float32)
    for ext in (".hdr", ".exr"):
        p = str(tmp_path / f"t{ext}")
        ttex.save_texture(p, data)
        assert ttex.load_texture(p).data.shape == (5, 7, 4)
    with pytest.raises(ImportError):
        ttex.save_texture(str(tmp_path / "t.png"), data)


# -- Yocto scenes -------------------------------------------------------------------


def _yocto_scene():
    """textured_cornell at a small size plus an orthographic camera, a
    material with every key of _parse_material, and rotated and scaled
    instance frames."""

    scene, cams = scene_files.textured_cornell(tex_size=8, env_wh=(16, 8),
                                               sphere_lat=5)
    ortho = tl.SceneCamera(
        transform=np.array([[0, 0, 1, -4], [0, 1, 0, 1], [-1, 0, 0, 0.5]], np.float32),
        params=tl.CameraParams(is_orthographic=True, lens=0.05, film=0.036,
                               aspect=1.5, focus=5.0, aperture=0.01))
    full = scene.add_material(tl.Material(
        color=np.array([0.2, 0.4, 0.6, 0.75], np.float32),
        emission=np.array([0.5, 0.25, 0.125, 0.0], np.float32),
        scattering=np.array([0.3, 0.2, 0.1, 0.0], np.float32),
        mat_type=tl.MaterialType.SUBSURFACE, roughness=0.3, metallic=0.6,
        ior=1.33, sc_anisotropy=0.2, tr_depth=0.05, color_tex_idx=0,
        emission_tex_idx=2, roughness_tex_idx=1, scattering_tex_idx=0,
        normal_tex_idx=1))
    c, s = np.cos(0.7), np.sin(0.7)
    scene.instances[-1].frame = np.array(
        [[c * 0.5, 0, s * 0.5, 0.1], [0, 0.5, 0, 0.2], [-s * 0.5, 0, c * 0.5, -0.3]],
        np.float32)
    scene.instances[-1].mat_idx = full
    return scene, cams + [ortho]


def _load_both(path):
    return jyocto.load_scene_yoctogl_v24(path), tyocto.load_scene_yoctogl_v24(path)


def test_yocto_matches_jax(tmp_path):
    """A scene with cameras (one orthographic), an environment with a frame
    and emission_tex, every material key, an empty texture uri and
    instances with frames: both loaders give field-equal SceneCPUs and
    cameras, and the JAX SceneTPU carried across (scene_from_numpy) equals
    build_scene_torch of the port's load, tensor by tensor."""

    scene, cams = _yocto_scene()
    path = scene_files.write_yocto(str(tmp_path / "s.json"), scene, cams)
    with open(path) as f:
        doc = json.load(f)
    doc["textures"].append({"uri": ""})
    doc["materials"][-1]["roughness_tex"] = len(doc["textures"]) - 1
    with open(path, "w") as f:
        json.dump(doc, f)
    (js, jc), (ts_cpu, tc) = _load_both(path)
    assert_scene_cpu_equal(js, ts_cpu)
    assert_cameras_equal(jc, tc)
    assert tc[-1].params.is_orthographic and not tc[0].params.is_orthographic
    np.testing.assert_array_equal(ts_cpu.textures[-1].data, np.ones((1, 1, 4)))
    assert ts_cpu.materials[-1].roughness_tex_idx == len(ts_cpu.textures) - 1

    tpu = build_scene_tpu(js)
    carried = tflatten.scene_from_numpy(
        {f: np.asarray(getattr(tpu, f)) for f in tflatten.ARRAY_FIELDS},
        {f: getattr(tpu, f) for f in tflatten.STATIC_FIELDS}, "cpu")
    ts = tl.build_scene_torch(ts_cpu, device="cpu")
    assert carried.statics == ts.statics
    for f in tflatten.ARRAY_FIELDS:
        a, b = getattr(carried, f), getattr(ts, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert ts.any_normal_maps and ts.env_has_tex and ts.mat_tex_ldr


def _round_trip_scene(name):
    if name == "cornell":
        return tbuiltin.build_scene_cornell_box()
    if name == "terrain":
        return tsyn.build_scene_terrain(n_tris=2048, seed=0)
    return scene_files.textured_cornell(tex_size=16, env_wh=(32, 16), sphere_lat=6)


@pytest.mark.parametrize("name", ["cornell", "terrain", "textured"])
def test_scene_files_round_trip(tmp_path, name):
    """tools/scene_files writes the scene and its cameras; the port's and
    the JAX loader read them back: positions, indices, normals, colors,
    frames, materials, cameras and environments equal, texcoords within
    6e-8, 8-bit textures equal (the HDR environment within RGBE's
    rounding: 2^-7 of each pixel's largest channel)."""

    scene, cams = _round_trip_scene(name)
    path = scene_files.write_scene_dir(str(tmp_path), name, scene, cams)
    assert os.path.basename(path) == f"{name}.json"
    (js, jc), (ts, tc) = _load_both(path)
    assert_scene_cpu_equal(ts, js)
    assert_scene_cpu_equal(scene, ts, uv_atol=UV_ATOL, textures=False)
    assert_cameras_equal(cams, tc)
    for a, b in zip(scene.textures, ts.textures):
        assert a.is_hdr == b.is_hdr
        if not a.is_hdr:
            np.testing.assert_array_equal(a.data, b.data)
        else:  # RGBE: 8 mantissa bits under the pixel's largest channel
            peak = a.data[..., :3].max(-1, keepdims=True)
            assert (np.abs(b.data - a.data) <= 2.0 ** -7 * peak).all()
