"""The BVH walk (kernels/walk.py, csrc/walk.cu): the closest hit of a
single-level scene's bounce batch by one thread per ray down the binary BVH,
which kernels/intersect.py takes on the card for such batches.

On the CPU: `walk_plain`, the kernel's plain version, against the plain
superleaf wavefront (the route it replaces) and against every triangle
tested (no tree) on SPD tetra at size factors 3 and 4 (lupin_bench's
generator) and a small synthetic terrain, over random bounce rays from the
surfaces, grazing rays leaving a surface, inactive lanes, axis-parallel
rays with origins on the boxes' planes and rays aimed at shared vertices,
edges and leaf-box faces: t the least t of every triangle on every lane,
the winner the lowest triangle id at it; t equal to the wavefront's
wherever the wavefront reaches that t (it misses some on two of the sets,
WAVEFRONT_MISSES, and is never nearer), and there the winner, u, v and the
backside flag too wherever no other triangle has that t; against
closest_hit_bvh, the JAX package's stack walk, within that file's
tolerances; a BVH built with a low depth cap (leaves of more than four
triangles); the route gate over the scene's level, the tensors' device, the
debug counts and B4, and ROUTES and the launch counters; the walk route,
run on CPU tensors through walk_plain, equal to the wavefront route, and a
render through it equal to the plain reference bit for bit; the device
reader kernels.walk_ms_per_accum.

On the card (marked `gpu`; they skip without a CUDA GPU): the kernel equals
walk_plain bit for bit and t equals the CUDA wavefront's on every lane, on
SPD tetra and the terrain; a small SPD render through the walk against the
same seed through the wavefront (the spd cell's limits, the segments
equal); every bounce batch of a render on the walk. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bvh_walk.py
"""

import functools
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core.vec3 import V3
from lupinpathtracer_tpu_torch.io import synthetic
from lupinpathtracer_tpu_torch.kernels import bvh as bk
from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
from lupinpathtracer_tpu_torch.kernels import intersect, packet, walk
from lupinpathtracer_tpu_torch.render import integrators
from lupinpathtracer_tpu_torch.scene import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lupin_bench import cells, port, scenes  # noqa: E402
from lupin_bench.reference import Reference, progressive_pixels  # noqa: E402

EPS = float(np.float32(1e-3))  # the spd cell's ray epsilon
F32_MAX = dk.F32_MAX


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    for name in ("LUPIN_NO_PACKET", "LUPIN_FORCE_PACKET"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd_desc(sf):
    return scenes.generate(dict(scene=dict(generator="spd_tetra",
                                           args=dict(size_factor=sf),
                                           two_level=False)), 5)


def _spd(sf, device="cpu"):
    ts, _ = port.build(_spd_desc(sf), False, device)
    return ts


def _terrain(device="cpu", n_tris=4096):
    scene, _ = synthetic.build_scene_terrain(n_tris=n_tris, seed=0)
    return tl.build_scene_torch(scene, device=device)


@functools.lru_cache(maxsize=None)
def _scene(name):
    return _spd(int(name[3:])) if name.startswith("spd") else _terrain()


def _soup(ts):
    """The padded soup's real triangles: (ids, v0, e1, e2) as (n,) and
    (n, 3) float64 numpy arrays (padding rows have e1 = e2 = 0)."""

    v0, e1, e2 = (getattr(ts, k).double().numpy().T for k in ("wt_v0", "wt_e1", "wt_e2"))
    n = ts.msl_count * ts.sl_stride
    real = np.nonzero(np.abs(np.cross(e1[:n], e2[:n])).sum(1) > 0)[0]
    return real, v0[real], e1[real], e2[real]


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ray_sets(ts, seed, n=1024):
    """Named (origins, directions, active) float32 ray sets."""

    rng = np.random.default_rng(seed)
    ids, v0, e1, e2 = _soup(ts)
    pick = rng.integers(0, len(ids), n)
    a, b = rng.random(n), rng.random(n)
    flip = a + b > 1.0
    a, b = np.where(flip, 1.0 - a, a), np.where(flip, 1.0 - b, b)
    p = v0[pick] + a[:, None] * e1[pick] + b[:, None] * e2[pick]
    nrm = _unit(np.cross(e1[pick], e2[pick]))
    d = _unit(rng.normal(size=(n, 3)))
    side = np.sign((d * nrm).sum(1, keepdims=True))
    lo = ts.bvh_min.numpy().T
    hi = ts.bvh_max.numpy().T
    root_lo, root_hi = lo[0], hi[0]
    span = root_hi - root_lo
    out = {}
    # Bounce rays from the surfaces, away from them.
    out["bounce"] = (p, d * side, None)
    # Grazing rays leaving a surface: nearly tangent, a hair to either side.
    tang = _unit(np.cross(nrm, rng.normal(size=(n, 3))))
    out["grazing"] = (p, _unit(tang + 1e-3 * np.where(rng.random((n, 1)) < 0.5, -nrm, nrm)),
                      None)
    # Inactive lanes among bounce rays.
    out["inactive"] = (p, -d * side, rng.random(n) < 0.6)
    # Axis-parallel rays, each origin's other two coordinates on the planes
    # of a node's box.
    o = root_lo + rng.random((n, 3)) * span
    node = rng.integers(0, lo.shape[0], n)
    axis = rng.integers(0, 3, n)
    dax = np.zeros((n, 3))
    dax[np.arange(n), axis] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    for k in range(3):
        plane = np.where(rng.random(n) < 0.5, lo[node, k], hi[node, k])
        start = np.where(dax[:, k] > 0, root_lo[k] - 0.5 * span[k],
                         root_hi[k] + 0.5 * span[k])
        o[:, k] = np.where(axis == k, start, plane)
    out["axis"] = (o, dax, None)
    # Rays aimed at shared vertices, edge midpoints and leaf-box faces from
    # points around the scene.
    src = root_lo - 0.5 * span + rng.random((n, 3)) * 2.0 * span
    vert = v0[pick] + np.where(rng.random((n, 1)) < 0.5, e1[pick], 0.0)
    edge = v0[pick] + 0.5 * e1[pick]
    leaf = np.nonzero(ts.bvh_count.numpy() > 0)[0]
    lf = leaf[rng.integers(0, len(leaf), n)]
    face = lo[lf] + rng.random((n, 3)) * (hi[lf] - lo[lf])
    k = rng.integers(0, 3, n)
    face[np.arange(n), k] = np.where(rng.random(n) < 0.5, lo[lf, k], hi[lf, k])
    for name, tgt in (("vertex", vert), ("edge", edge), ("box_face", face)):
        out[name] = (src, _unit(tgt - src), None)
    return out


def _v3(x):
    return V3(*(torch.tensor(np.ascontiguousarray(x[:, k]), dtype=torch.float32)
                for k in range(3)))


def _brute(ts, W, ro, rd):
    """Every triangle tested, no tree: per lane the least valid t and the
    lowest id at it, and how many triangles share that t."""

    R = intersect.ray_features(ro, rd)
    t_all, _, _ = dk.dense_epilogue(*dk.dense_numerators(R, W), EPS)
    best, idx = t_all.min(dim=1)
    ties = ((t_all == best[:, None]) & (best[:, None] < F32_MAX)).sum(1)
    return best, idx.to(torch.int32), ties


def _check_against_wavefront(ts, o, d, act):
    """walk_plain against every triangle tested and the plain wavefront:
    t is the least t on every lane and the winner the lowest id at it; the
    wavefront never finds a nearer hit, and wherever it finds the least t
    (every lane but its misses) t is equal and, where no other triangle
    has that t, the winner, u, v and the backside flag too. Returns (hit
    lanes, tie lanes, lanes where the wavefront missed the least t)."""

    ro, rd = _v3(o), _v3(d)
    active = None if act is None else torch.tensor(act)
    W = intersect._wavefront_tri_matrix(ts, intersect.scene_tri_matrix(ts))
    t, u, v, det, tri = walk.walk_plain(ts.bvh_nodes, W, ro, rd, EPS, active=active)
    best, first, ties = _brute(ts, W, ro, rd)
    if active is not None:
        best = torch.where(active, best, F32_MAX)
        off = ~active
        assert torch.equal(t[off], torch.full_like(t[off], F32_MAX))
        assert not bool((tri[off].ne(0) | u[off].ne(0) | v[off].ne(0) | det[off].ne(0)).any())
    assert torch.equal(t, best)
    hit = t < F32_MAX
    assert torch.equal(tri[hit], first[hit])
    h = intersect.closest_hit_wavefront(ts, ro, rd, EPS, W=W, active=active,
                                        coherent=False)
    assert bool((t <= h.dst).all())
    reached = h.dst == t
    unique = hit & (ties == 1) & reached
    for a, b in ((tri, h.tri), (u, h.u), (v, h.v), (det > 0.0, h.backside)):
        assert torch.equal(a[unique], b[unique])
    return int(hit.sum()), int((hit & (ties > 1)).sum()), int((~reached).sum())


RAY_SETS = ("bounce", "grazing", "inactive", "axis", "vertex", "edge", "box_face")
# The ray sets on which the wavefront misses hits: B5's slab test lets a NaN
# (an origin on a top-tree box plane, 1/d infinite) cull a box, and a
# superleaf box rounded outward to bfloat16 has no margin where its planes
# already are bfloat16 values (SPD's dyadic vertices), so a ray through a
# vertex on such a plane can pass outside it.
WAVEFRONT_MISSES = ("axis", "vertex")


@pytest.mark.parametrize("name", ["spd3", "spd4", "terrain"])
@pytest.mark.parametrize("rays", RAY_SETS)
def test_walk_plain_equals_the_wavefront_and_every_triangle(name, rays):
    ts = _scene(name)
    assert not ts.two_level and ts.sl_count > 0
    o, d, act = _ray_sets(ts, 7)[rays]
    hits, ties, missed = _check_against_wavefront(ts, o, d, act)
    assert 0 < hits and ties <= hits
    if rays not in WAVEFRONT_MISSES:
        assert missed == 0
    if rays == "axis":
        assert missed > 0  # the case the walk's slab test is built for


def test_walk_plain_against_the_stack_walk():
    """closest_hit_bvh (cross-product arithmetic, unpadded boxes) within
    tests/test_torch_controls.py's tolerances on the bounce rays: hit
    flags equal, the winner equal on >= 95% of hits, t within rtol 5e-4 /
    atol 1e-5 where the winners agree."""

    for name in ("spd4", "terrain"):
        ts = _scene(name)
        o, d, _ = _ray_sets(ts, 11)["bounce"]
        ro, rd = _v3(o), _v3(d)
        W = intersect._wavefront_tri_matrix(ts, intersect.scene_tri_matrix(ts))
        t, _, _, _, tri = walk.walk_plain(ts.bvh_nodes, W, ro, rd, EPS)
        ref = intersect.closest_hit_bvh(ts, ro, rd, EPS)
        hit = t < F32_MAX
        n_hit = int(hit.sum())
        assert n_hit > 0 and torch.equal(hit, ref.hit)
        same = (tri == ref.tri) & hit
        assert int(same.sum()) >= 0.95 * n_hit
        torch.testing.assert_close(t[same], ref.dst[same], rtol=5e-4, atol=1e-5)


def test_walk_counts_its_work():
    ts = _scene("spd4")
    o, d, _ = _ray_sets(ts, 3)["bounce"]
    W = intersect._wavefront_tri_matrix(ts, intersect.scene_tri_matrix(ts))
    counts = {}
    out = walk.walk_plain(ts.bvh_nodes, W, _v3(o), _v3(d), EPS, counts=counts)
    again = walk.walk_plain(ts.bvh_nodes, W, _v3(o), _v3(d), EPS)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert counts["steps"] > 0 and counts["leaves"] > 0
    assert counts["leaves"] <= counts["tri_tests"] <= 4 * counts["leaves"]
    assert counts["leaves"] <= counts["groups"] <= 2 * counts["leaves"]
    assert 0 < counts["nodes_read"] <= ts.bvh_nodes.shape[0]
    assert 0 < counts["groups_read"] <= counts["groups"]


def test_a_low_depth_cap_gives_large_leaves(monkeypatch):
    """A BVH built with its depth capped at 5 (accel/bvh.py: a leaf at the
    cap keeps every triangle it has): leaves of tens of triangles, each
    tested through the groups of four that cover it."""

    real = flatten.bvh_mod.build_bvh
    monkeypatch.setattr(flatten.bvh_mod, "build_bvh",
                        functools.partial(real, max_depth=5))
    ts = _spd(4)
    counts = ts.bvh_count.numpy()
    assert ts.bvh_depth == 5 and counts.max() > 4 * ts.bvh_leaf_size
    for rays in ("bounce", "inactive", "edge", "box_face"):
        o, d, act = _ray_sets(ts, 5)[rays]
        hits, _, missed = _check_against_wavefront(ts, o, d, act)
        assert hits > 0 and missed == 0


def test_the_node_table_packs_the_bvh():
    ts = _scene("spd3")
    nodes = ts.bvh_nodes
    assert nodes.dtype == torch.float32 and nodes.shape == (ts.bvh_count.shape[0], 8)
    assert torch.equal(nodes[:, 0:3], ts.bvh_min.T)
    assert torch.equal(nodes[:, 4:7], ts.bvh_max.T)
    assert torch.equal(nodes[:, 3].contiguous().view(torch.int32), ts.bvh_first)
    assert torch.equal(nodes[:, 7].contiguous().view(torch.int32), ts.bvh_count)
    assert ts.bvh_depth + 2 <= walk.STACK
    two = _field()
    assert "bvh_nodes" not in two.tensors


@functools.lru_cache(maxsize=None)
def _field():
    scene, _ = synthetic.build_scene_instanced_field(40, seed=0, tris_per_mesh=64)
    ts = tl.build_scene_torch(scene, device="cpu")
    assert ts.two_level
    return ts


def test_the_route_follows_the_input(monkeypatch):
    """_route: the walk for a single-level bounce batch on the card; the
    wavefront for two-level scenes, the debug counts and CPU tensors; B4
    for camera batches where eligible, and for bounce batches only under
    LUPIN_FORCE_PACKET; no B4 under LUPIN_NO_PACKET."""

    one, two = _scene("spd4"), _field()
    card, cpu = types.SimpleNamespace(is_cuda=True), types.SimpleNamespace(is_cuda=False)
    cam = "packet" if intersect.packet_eligible(one) else "wavefront"
    assert cam == "packet"
    R = intersect._route
    assert R(one, card, False) == "walk"
    assert R(one, cpu, False) == "wavefront"
    assert R(one, card, False, with_counts=True) == "wavefront"
    assert R(two, card, False) == "wavefront"
    assert R(one, card, True) == "packet" and R(one, cpu, True) == "packet"
    assert R(one, card, True, with_counts=True) == "wavefront"
    monkeypatch.setenv("LUPIN_FORCE_PACKET", "1")
    assert R(one, card, False) == "packet"
    monkeypatch.delenv("LUPIN_FORCE_PACKET")
    monkeypatch.setenv("LUPIN_NO_PACKET", "1")
    assert R(one, card, True) == "wavefront" and R(one, card, False) == "walk"


def test_routes_count_batches_and_cpu_launches_nothing():
    ts = _scene("terrain")
    assert ts.use_bvh and intersect.packet_eligible(ts)
    o, d, _ = _ray_sets(ts, 2)["bounce"]
    ro, rd = _v3(o), _v3(d)
    for c in (intersect.ROUTES, walk.LAUNCHES, bk.LAUNCHES, packet.LAUNCHES):
        for k in c:
            c[k] = 0
    intersect.closest_hit(ts, ro, rd, EPS, coherent=False)
    intersect.closest_hit_attrs(ts, ro, rd, EPS, coherent=False)
    intersect.closest_hit_attrs(ts, ro, rd, EPS, coherent=True)
    intersect.count_traversal(ts, ro, rd, EPS)
    assert intersect.ROUTES == {"walk": 0, "wavefront": 3, "packet": 1}
    assert walk.LAUNCHES == {"walk": 0}
    assert not any(bk.LAUNCHES.values()) and not any(packet.LAUNCHES.values())


def _walk_everywhere(monkeypatch):
    """Routes every batch the gate would send to the walk on the card to
    the walk on CPU tensors too (walk_plain)."""

    real = intersect._route

    def route(scene, x, coherent, with_counts=False):
        return real(scene, types.SimpleNamespace(is_cuda=True), coherent, with_counts)

    monkeypatch.setattr(intersect, "_route", route)


def test_the_walk_route_equals_the_wavefront_route(monkeypatch):
    """closest_hit_attrs through the walk route (walk_plain on the CPU)
    against the wavefront route: hit, t and backside on every lane, the
    winner, u, v and B7's attributes wherever the winners agree (all but
    exact-t ties)."""

    ts = _scene("terrain")
    o, d, act = _ray_sets(ts, 4)["inactive"]
    ro, rd, active = _v3(o), _v3(d), torch.tensor(act)
    h0, a0 = intersect.closest_hit_attrs(ts, ro, rd, EPS, active=active, coherent=False)
    _walk_everywhere(monkeypatch)
    intersect.ROUTES["walk"] = 0
    h1, a1 = intersect.closest_hit_attrs(ts, ro, rd, EPS, active=active, coherent=False)
    assert intersect.ROUTES["walk"] == 1
    assert torch.equal(h0.hit, h1.hit) and torch.equal(h0.dst, h1.dst)
    same = h0.tri == h1.tri
    assert float(same.float().mean()) >= 0.99
    for x, y in ((h0.u, h1.u), (h0.v, h1.v), (h0.backside, h1.backside),
                 (a0.n.x, a1.n.x), (a0.gn.z, a1.gn.z), (a0.mat_id, a1.mat_id)):
        assert torch.equal(x[same], y[same])
    assert not bool(h1.hit[~active].any())


def test_a_render_through_the_walk_equals_the_reference(monkeypatch):
    """tests/test_torch_spd_tetra.py's check with every bounce batch on the
    walk (walk_plain): SPD tetra at size factor 5, 32x18 x 2 spp, 3
    accumulations, the image and every accumulation's segments equal to the
    plain reference's bit for bit."""

    d = _spd_desc(5)
    ts, _ = port.build(d, False, "cpu")
    _walk_everywhere(monkeypatch)
    intersect.ROUTES["walk"] = 0
    with open(os.path.join(ROOT, "lupin_bench", "traffic", "spd512.json")) as f:
        traffic = dict(json.load(f), width=32, height=18, spp=2, accumulations=3)
    loop = cells.loop_class("progressive")(ts, d, traffic, 12345, "cpu")
    loop.begin()
    for i in range(3):
        loop.step(i)
    img, accums = loop.checked(3)
    assert accums == 3 and intersect.ROUTES["walk"] > 0
    ref = Reference(d, False, "cpu")
    gx = (torch.arange(32 * 18) % 32).int()
    gy = (torch.arange(32 * 18) // 32).int()
    args = (EPS, 8, float(np.float32(100.0)))
    rimg, seg = progressive_pixels(ref, d["camera"], gx, gy, 32, 18, 12345, 3, 2, *args)
    assert torch.equal(img.reshape(-1, 3), rimg)
    assert int(seg.sum()) == sum(loop.unit_rays)


def test_the_walk_reader():
    path = os.path.join(ROOT, "lupin_bench", "metrics", "kernels.walk_ms_per_accum.py")
    spec = importlib.util.spec_from_file_location("walk_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ev = [("lupin_walk_kernel(WalkArgs)", 0, 2_000_000),
          ("lupin_walk_kernel(WalkArgs)", 5_000_000, 6_000_000),
          ("pair_hit_kernel", 0, 9_000_000)]
    rec = dict(loop="progressive", trace=dict(events=ev, units=3))
    assert mod.read(rec) == pytest.approx(1.0)
    rec["trace"]["events"] = ev[2:]
    assert mod.read(rec) is None
    assert mod.read(dict(loop="progressive", trace=None)) is None
    from lupin_bench.records import kernel_of
    assert kernel_of("lupin_walk_kernel(WalkArgs)") is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def _bounce_batch(ts, dev, width, height, seed):
    """The camera batch's hits (B4 with attributes) turned into a bounce
    batch: origins at the hits (the camera on misses), directions from a
    seeded normal draw on the side of the geometric normal facing the
    camera."""

    from lupinpathtracer_tpu_torch.core import rng as rng_mod
    from lupinpathtracer_tpu_torch.render.renderer import _camera_args, _pixel_batch

    cam = ts.__dict__.get("_test_camera")
    gx, gy = _pixel_batch(width, height, 0, 0, dev)
    _, ro, rd = integrators._camera_ray_from(
        dict(cam=_camera_args(cam), is_ortho=False, gx=gx, gy=gy,
             resolution=(float(width), float(height))),
        rng_mod.init_state(gy * width + gx, 0, 0))
    W = intersect.scene_tri_matrix(ts)
    h, a = intersect.closest_hit_attrs(ts, ro, rd, EPS, W=W, coherent=True)
    g = np.random.default_rng(seed).normal(size=(3, h.dst.shape[0]))
    g /= np.linalg.norm(g, axis=0)
    d = V3(*(torch.tensor(c, dtype=torch.float32, device=dev) for c in g))
    flip = (d.x * a.gn.x + d.y * a.gn.y + d.z * a.gn.z) * (
        rd.x * a.gn.x + rd.y * a.gn.y + rd.z * a.gn.z) > 0.0
    d = V3(*(torch.where(flip, -c, c) for c in d))
    th = torch.where(h.hit, h.dst, 0.0)
    o = V3(*(p + q * th for p, q in zip(ro, rd)))
    active = torch.rand(h.dst.shape[0], generator=torch.Generator().manual_seed(seed)) < 0.9
    return o, d, active.to(dev), W


def _card_scenes(dev):
    spd_desc = _spd_desc(7)
    spd, _ = port.build(spd_desc, False, dev)
    spd.__dict__["_test_camera"] = port.path_desc(
        spd_desc["camera"], dict(integrator="STANDARD", max_radiance=100.0,
                                 ray_epsilon=EPS), 1)
    terrain, cams = synthetic.build_scene_terrain(n_tris=200_000, seed=0)
    ter = tl.build_scene_torch(terrain, device=dev)
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    ter.__dict__["_test_camera"] = desc
    return {"spd7": spd, "terrain200k": ter}


@pytest.mark.gpu
def test_kernel_equals_plain_and_the_wavefront_on_card(cuda_device, monkeypatch):
    """On SPD tetra (size factor 7) and a 200k-triangle terrain, a 256x256
    bounce batch with inactive lanes: the kernel equals walk_plain bit for
    bit, and its t equals the CUDA wavefront's (B5/B6) on every lane, the
    winner too wherever no other triangle shares the t."""

    for name, ts in _card_scenes(cuda_device).items():
        o, d, active, W = _bounce_batch(ts, cuda_device, 256, 256, seed=3)
        Wm = intersect._wavefront_tri_matrix(ts, W)
        walk.LAUNCHES["walk"] = 0
        k = walk.walk(ts, o, d, EPS, Wm, active=active)
        torch.cuda.synchronize()
        assert walk.LAUNCHES["walk"] == 1
        p = walk.walk_plain(ts.bvh_nodes, Wm, o, d, EPS, active=active)
        assert all(torch.equal(a, b) for a, b in zip(k, p)), name
        with monkeypatch.context() as m:
            m.setattr(intersect, "_route", lambda *a, **kw: "wavefront")
            h = intersect.closest_hit_wavefront(ts, o, d, EPS, W=W, active=active,
                                                coherent=False)
        assert torch.equal(k[0], h.dst), (name, int((k[0] != h.dst).sum()))
        hit = k[0] < F32_MAX
        assert int(hit.sum()) > 0
        agree = float(((k[4] == h.tri) | ~hit).float().mean())
        assert agree >= 0.999, (name, agree)


@pytest.mark.gpu
def test_spd_render_walk_against_wavefront_on_card(cuda_device, monkeypatch):
    """SPD tetra at size factor 6, 64x64 x 2 spp, 4 accumulations through
    lupin_bench's loop, once with the walk (the route on the card) and once
    with every walk batch sent to the wavefront, the same seed: the images
    within the spd cell's limits (radiance_mismatch_share 0.5,
    radiance_sum_gap 0.01) and the segments equal; every bounce batch of
    the walk run on the walk."""

    d = _spd_desc(6)
    with open(os.path.join(ROOT, "lupin_bench", "traffic", "spd512.json")) as f:
        traffic = dict(json.load(f), width=64, height=64, spp=2, accumulations=4)

    def render():
        ts, _ = port.build(d, False, cuda_device)
        loop = cells.loop_class("progressive")(ts, d, traffic, 2**33 + 5, cuda_device)
        loop.begin()
        for i in range(4):
            loop.step(i)
        img, _ = loop.checked(4)
        torch.cuda.synchronize()
        return img.float().cpu(), list(loop.unit_rays)

    for c in (intersect.ROUTES, integrators.SHADE_STEPS):
        for k in c:
            c[k] = 0
    img_w, seg_w = render()
    steps = sum(integrators.SHADE_STEPS.values())
    assert intersect.ROUTES["walk"] == steps > 0, (intersect.ROUTES, steps)
    assert intersect.ROUTES["wavefront"] == 0
    real = intersect._route
    monkeypatch.setattr(intersect, "_route", lambda s, x, c, w=False: (
        "wavefront" if real(s, x, c, w) == "walk" else real(s, x, c, w)))
    img_f, seg_f = render()
    assert seg_w == seg_f
    a, b = img_w.reshape(-1, 3), img_f.reshape(-1, 3)
    lit = (a.abs().sum(1) > 0) | (b.abs().sum(1) > 0)
    off = ((a - b).abs() > 1e-3 * b.abs() + 1e-4).any(1) & lit
    assert float(off.sum()) / max(int(lit.sum()), 1) <= 0.5
    assert abs(float(a.sum()) - float(b.sum())) <= 0.01 * abs(float(b.sum()))
