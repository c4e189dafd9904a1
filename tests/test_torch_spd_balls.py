"""The benchmark's SPD `balls` scene (lupin_bench/generators/spd_balls.py,
configuration spd_balls): the sphereflake's published counts, every child
tangent to its parent at a third of its radius, the icosphere (closed, wound
outward, 20 * 4 ** s triangles), a scene that ignores the seed, the converted
view and lights, the configuration's stated shape, the flattened scene inside
the fused shading's gate (no delta material), and the port against the plain
reference (lupin_bench/reference.py) on the CPU at size factor 2 with 1
subdivision, on the two-level route. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spd_balls.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lupin_bench import cells, port, scenes  # noqa: E402
from lupin_bench.reference import (  # noqa: E402
    Reference, frame_segments, progressive_pixels)
from lupinpathtracer_tpu_torch.core.types import PathtraceType  # noqa: E402
from lupinpathtracer_tpu_torch.kernels import mega  # noqa: E402
from lupinpathtracer_tpu_torch.render.camera import compute_camera_ray  # noqa: E402

generate = scenes.generator("spd_balls")
SPD = generate.__globals__  # the generator's constants and helpers


def _config(sf, subdivisions):
    return dict(scene=dict(generator="spd_balls",
                           args=dict(size_factor=sf, subdivisions=subdivisions),
                           two_level=True))


def _n_spheres(sf):
    return (9 ** (sf + 1) - 1) // 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sf", [0, 1, 2, 3])
def test_sphere_count_is_nine_to_the_sf_plus_one_less_one_over_eight(sf):
    d = generate(seed=1, size_factor=sf, subdivisions=1)
    n = _n_spheres(sf)
    assert len(SPD["spheres"](sf)[1]) == n
    assert len(d["frames"]) == n + 4  # the floor and three lights
    assert (d["inst_mesh"][:n] == 0).all() and (d["inst_mat"][:n] == 0).all()
    assert list(d["inst_mesh"][n:]) == [1, 2, 3, 4]
    assert list(d["inst_mat"][n:]) == [1, 2, 2, 2]


def _children(sf):
    """(parent, child) index pairs of balls.c's preorder: a sphere at
    level L is followed by its 9 subtrees of (9 ** (SF - L) - 1) / 8."""

    out = []

    def walk(i, level):
        nxt = i + 1
        for _ in range(9 if level < sf else 0):
            out.append((i, nxt))
            nxt = walk(nxt, level + 1)
        return nxt

    assert walk(0, 0) == _n_spheres(sf)
    return out


@pytest.mark.parametrize("sf", [1, 3])
def test_every_child_touches_its_parent_at_a_third_of_its_radius(sf):
    c, r = SPD["spheres"](sf)
    assert r[0] == 0.5 and np.array_equal(c[0], [0.0, 0.0, 0.0])
    pairs = np.asarray(_children(sf))
    p, k = pairs[:, 0], pairs[:, 1]
    assert np.allclose(r[k], r[p] / 3.0, rtol=1e-12)
    dist = np.linalg.norm(c[k] - c[p], axis=1)
    assert np.allclose(dist, r[p] + r[k], rtol=1e-12)
    # Siblings never overlap: at most touching.
    for i in np.unique(p):
        kids = k[p == i]
        gap = np.linalg.norm(c[kids][:, None] - c[kids][None], axis=-1)
        np.fill_diagonal(gap, np.inf)
        assert (gap >= 2 * r[kids[0]] * (1 - 1e-9)).all()
    # The root's children: three above its equator, six on it.
    z = np.sort(c[k[p == 0]][:, 2])
    assert np.allclose(z[:6], 0.0, atol=1e-12) and (z[6:] > 0.5).all()
    frames = generate(seed=1, size_factor=sf, subdivisions=0)["frames"]
    n = _n_spheres(sf)
    assert np.allclose(frames[:n, :, 3], c, atol=1e-6)
    for a in range(3):
        assert np.allclose(frames[:n, a, a], r, rtol=1e-6)


@pytest.mark.parametrize("s", [0, 1, 2, 3])
def test_icosphere_is_closed_unit_and_wound_outward(s):
    m = SPD["icosphere"](s)
    p = m["positions"].astype(np.float64)
    idx = m["indices"].astype(np.int64)
    assert idx.shape == (20 * 4 ** s, 3) and p.shape == (10 * 4 ** s + 2, 3)
    assert m["indices"].dtype == np.uint32
    assert np.allclose(np.linalg.norm(p, axis=1), 1.0, atol=1e-6)
    assert np.array_equal(m["normals"], m["positions"])
    # Closed and consistently wound: every directed edge once, its reverse
    # once.
    edges = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [2, 0]]])
    directed = {tuple(e) for e in edges}
    assert len(directed) == len(edges)
    assert all((b, a) in directed for a, b in directed)
    v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    out = np.einsum("ij,ij->i", np.cross(v1 - v0, v2 - v0), v0 + v1 + v2)
    assert (out > 0).all()


def test_the_scene_ignores_the_seed():
    a = generate(seed=1, size_factor=2, subdivisions=1)
    b = generate(seed=2**40 + 7, size_factor=2, subdivisions=1)
    for ma, mb in zip(a["meshes"], b["meshes"]):
        for f in ("positions", "indices", "normals"):
            assert (ma[f] is None and mb[f] is None) or np.array_equal(ma[f], mb[f])
    for f in ("frames", "inst_mesh", "inst_mat"):
        assert np.array_equal(a[f], b[f])
    for k in a["camera"]:
        assert np.array_equal(a["camera"][k], b["camera"][k])
    for ka, kb in zip(a["materials"], b["materials"]):
        assert all(np.array_equal(ka[f], kb[f]) for f in ka)


def test_the_cameras_centre_ray_passes_through_at_and_the_lights_face_it():
    cam = generate(seed=1, size_factor=0, subdivisions=0)["camera"]
    gx = torch.tensor([719], dtype=torch.int32)
    gy = torch.tensor([720], dtype=torch.int32)
    _, ro, rd = compute_camera_ray(
        cam["transform"], cam["lens"], cam["film"], cam["aspect"], cam["focus"],
        cam["aperture"], cam["is_orthographic"], gx, gy, (1440.0, 1440.0),
        torch.full((1,), 0.5), torch.full((1,), -0.5),
        torch.zeros(1, dtype=torch.int64))
    o = np.array([c.item() for c in ro], np.float64)
    d = np.array([c.item() for c in rd], np.float64)
    at = np.asarray(SPD["AT"])
    t = np.dot(at - o, d)
    assert np.linalg.norm(o + t * d - at) < 1e-3
    assert t == pytest.approx(cam["focus"], rel=1e-5)
    assert np.allclose(o, SPD["FROM"], atol=1e-6)
    assert cam["lens"] == pytest.approx(0.028971, abs=1e-6)
    d = generate(seed=1, size_factor=0, subdivisions=0)
    for k, pos in enumerate(SPD["LIGHTS"]):
        q = d["meshes"][2 + k]
        p = q["positions"].astype(np.float64)
        v0, v1, v2 = (p[q["indices"][:, j].astype(np.int64)] for j in range(3))
        n = np.cross(v1 - v0, v2 - v0)
        assert 0.5 * np.linalg.norm(n, axis=1).sum() == pytest.approx(0.25, rel=1e-5)
        assert np.allclose(p.mean(0), pos, atol=1e-6)
        assert (n @ -np.asarray(pos) > 0).all()
    assert np.array_equal(d["materials"][2]["emission"][:3], [100.0] * 3)
    assert d["materials"][0]["mat_type"] == scenes.GLOSSY
    assert d["materials"][1]["mat_type"] == scenes.MATTE


def test_the_configuration_states_the_generators_shape():
    with open(os.path.join(ROOT, "lupin_bench", "configs", "spd_balls.json")) as f:
        cfg = json.load(f)
    args = cfg["scene"]["args"]
    sf = args["size_factor"]
    assert sf == cfg["size_factor"] and cfg["scene"]["two_level"] is True
    assert cfg["reduced"] == [] and cfg["chips"] == 1
    d = generate(seed=1, **args)
    shape = cfg["shape"]
    sphere, floor = d["meshes"][0], d["meshes"][1]
    assert shape["spheres"] == _n_spheres(sf) == 66430
    assert shape["instances"] == len(d["frames"]) == 66434
    assert shape["meshes"] == len(d["meshes"])
    assert shape["sphere_triangles"] == sphere["indices"].shape[0] == 1280
    assert shape["sphere_vertices"] == sphere["positions"].shape[0] == 642
    assert shape["floor_triangles"] == floor["indices"].shape[0]
    assert shape["light_triangles"] == sum(m["indices"].shape[0]
                                           for m in d["meshes"][2:]) == 6
    assert shape["materials"] == len(d["materials"])
    assert {"procedure", "view", "camera", "tessellation", "floor", "lights",
            "material", "background"} <= set(cfg["assumed"])
    assert "balls.c" in cfg["source"]
    for k, v in shape["camera"].items():
        assert d["camera"][k] == pytest.approx(v)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == "spd_balls")
    assert entry["file"] == "lupin_bench/configs/spd_balls.json"
    assert len(entry["source"]) <= 200
    cell = cells.load(ROOT, "spd_balls.golden_bvh")
    t = cell["traffic"]
    assert (t["width"], t["height"], t["spp"], t["accumulations"]) == (
        1440, 1440, 10, 100)
    assert shape["resolution"] == [t["width"], t["height"]]
    assert t["render"] == dict(integrator="STANDARD", max_bounces=8,
                               max_radiance=10.0, ray_epsilon=0.001)


def test_the_flattened_scene_is_two_level_inside_the_fused_shading_gate():
    """No delta material (the spheres are glossy), 6 light triangles: the
    BVH route's shading runs as one kernel a loop iteration on the card."""

    d = scenes.generate(_config(2, 1), 3)
    ts, _ = port.build(d, True, "cpu")
    assert ts.use_bvh and ts.two_level and not ts.any_delta
    assert ts.lt_v0.shape[1] == 6
    assert mega.in_gate(ts, int(PathtraceType.STANDARD))


def test_reference_equals_the_port_on_the_cpu():
    """Size factor 2 (91 spheres) with 1 subdivision (80 triangles a
    sphere), two-level: the port's image and per-accumulation segments
    equal the reference's bit for bit over 3 accumulations at 32x18 and 2
    spp (both transform each ray into mesh space with the same float32
    arithmetic and test the same triangles)."""

    d = scenes.generate(_config(2, 1), 5)
    ts, _ = port.build(d, True, "cpu")
    assert ts.two_level and ts.sl_count > 1
    with open(os.path.join(ROOT, "lupin_bench", "traffic", "golden_bvh.json")) as f:
        traffic = dict(json.load(f), width=32, height=18, spp=2, accumulations=3)
    loop = cells.loop_class("progressive")(ts, d, traffic, 12345, "cpu")
    loop.begin()
    for i in range(3):
        loop.step(i)
    img, accums = loop.checked(3)
    assert accums == 3
    ref = Reference(d, True, "cpu")
    gx = (torch.arange(32 * 18) % 32).int()
    gy = (torch.arange(32 * 18) // 32).int()
    args = (float(np.float32(0.001)), 8, float(np.float32(10.0)))
    rimg, seg = progressive_pixels(ref, d["camera"], gx, gy, 32, 18, 12345, 3, 2,
                                   *args)
    assert torch.equal(img.reshape(-1, 3), rimg)
    assert float(rimg.sum()) > 0
    assert int(seg.sum()) == sum(loop.unit_rays)
    for c in range(3):
        assert frame_segments(ref, d["camera"], 32, 18, 12345, c, 2,
                              *args) == loop.unit_rays[c]


def test_the_generator_and_reference_import_neither_jax_nor_the_port():
    code = ("import sys\nsys.path.insert(0, %r)\n"
            "import lupin_bench.reference\nfrom lupin_bench import scenes\n"
            "scenes.generator('spd_balls')(seed=1, size_factor=1, subdivisions=1)\n"
            "print('\\n'.join(sys.modules))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True)
    top = {m.split(".")[0] for m in out.stdout.split()}
    assert not top & {"jax", "jaxlib", "flax", "lupinpathtracer_tpu",
                      "lupinpathtracer_tpu_torch"}
