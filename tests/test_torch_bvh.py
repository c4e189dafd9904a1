"""PyTorch port, BVH kernels: the plain versions of kernels B4-B7
(lupinpathtracer_tpu_torch/kernels/packet.py and bvh.py) against the JAX
package on the same scenes, rays and work items, plus the copied synthetic
terrain. JAX's Pallas kernels run in interpret mode here, as its own CPU
tests run them; the CUDA kernels run only on a card (tests/test_torch_gpu.py,
chip_smoke.py).

Scenes: the ~1.5k-triangle sphere-and-quad scene of tests/test_wavefront.py
built with dense_max_tris=64 in both packages (several superleaves at
stride 256), and build_scene_terrain(n_tris=2048).

Tolerances (tests/test_wavefront.py:124-134): B5 equal exactly (same f32
slab tests, same comparator network); B6 and B4 hit flags equal, t within
rtol 5e-4 / atol 1e-5 (the JAX kernels select candidates with a bf16 3-pass
product, the port in plain f32), winning triangle equal on >= 95% of hits
(shared edges); B7 rows within 1e-6 (the same interpolation; the JAX
kernel multiplies by an identity normal matrix)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.core import vec3 as jv3
from lupinpathtracer_tpu.io import synthetic as jsyn
from lupinpathtracer_tpu.kernels import intersect as jint
from lupinpathtracer_tpu.kernels import pallas_bvh as jpb
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core import vec3 as tv3
from lupinpathtracer_tpu_torch.io import synthetic as tsyn
from lupinpathtracer_tpu_torch.kernels import bvh as tbvh
from lupinpathtracer_tpu_torch.kernels import intersect as tint
from lupinpathtracer_tpu_torch.kernels import packet as tpk

EPS = 1e-4
PB = 256


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Runs each test on one PyTorch thread: the suite runs in several
    worker processes at once, and PyTorch's intra-op thread pools in all of
    them oversubscribe the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_scene(pkg):
    """tests/test_wavefront.py::_tri_sphere_scene through either package:
    a UV sphere and a ground quad, ~1.5k triangles."""

    n_lat, n_lon = 24, 32
    lat = np.linspace(0.1, np.pi - 0.1, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    pts = [[np.sin(a) * np.cos(b), np.cos(a) + 1.5, np.sin(a) * np.sin(b)]
           for a in lat for b in lon]
    pts = np.asarray(pts, np.float32)
    idx = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            idx += [[a, b, c], [b, d, c]]
    base = pts.shape[0]
    quad = np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32)
    pts = np.concatenate([pts, quad])
    idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    mesh = pkg.MeshCPU(positions=pts, indices=np.asarray(idx, np.int32))
    inst = pkg.InstanceCPU(frame=np.eye(3, 4, dtype=np.float32), mesh_idx=0,
                           mat_idx=0)
    return pkg.SceneCPU(meshes=[mesh], instances=[inst],
                        materials=[pkg.Material()], environments=[], textures=[])


def terrain_scene(pkg):
    syn = jsyn if pkg is jl else tsyn
    return syn.build_scene_terrain(n_tris=2048, seed=0)[0]


SCENES = {"spheres": (sphere_scene, dict(dense_max_tris=64), 3.0),
          "terrain": (terrain_scene, {}, 10.0)}


def both(name):
    build, kw, span = SCENES[name]
    tpu = build_scene_tpu(build(jl), **kw)
    ts = tl.build_scene_torch(build(tl), device="cpu", **kw)
    assert tpu.use_bvh and ts.use_bvh and not ts.two_level and ts.sl_count >= 2
    return tpu, ts, span


def rays(B, span, seed):
    """Origins in a box around the scene, unit directions from a normal
    draw; the same float32 values for both packages."""

    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (3, B)).astype(np.float32)
    o[1] = rng.uniform(0.2, 0.5 * span, B)
    d = rng.normal(size=(3, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    j = (jv3.V3(*map(jnp.asarray, o)), jv3.V3(*map(jnp.asarray, d)))
    t = (tv3.V3(*map(torch.from_numpy, o)), tv3.V3(*map(torch.from_numpy, d)))
    return j, t


def T(x):
    return torch.from_numpy(np.array(x))


def test_terrain_copy_array_equal():
    """The port's copy of io/synthetic gives the JAX generator's scene."""

    (js, jc), (ts, tc) = (jsyn.build_scene_terrain(n_tris=2048, seed=3),
                          tsyn.build_scene_terrain(n_tris=2048, seed=3))
    assert len(js.meshes) == len(ts.meshes) and len(js.instances) == len(ts.instances)
    for a, b in zip(js.meshes, ts.meshes):
        for f in ("positions", "indices", "normals", "texcoords", "colors"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    for a, b in zip(js.instances, ts.instances):
        np.testing.assert_array_equal(a.frame, b.frame)
        assert (a.mesh_idx, a.mat_idx) == (b.mesh_idx, b.mat_idx)
    for a, b in zip(js.materials, ts.materials):
        np.testing.assert_array_equal(a.color, b.color)
        np.testing.assert_array_equal(a.emission, b.emission)
        assert (int(a.mat_type), a.roughness) == (int(b.mat_type), b.roughness)
    np.testing.assert_array_equal(jc[0].transform, tc[0].transform)
    assert vars(jc[0].params) == vars(tc[0].params)


def _stack_size(scene):
    return 7 * scene.top_depth + 10


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_b5_top_traverse_plain_matches_jax(name):
    """Two resumed rounds at Q = 2 (so stacks carry over), the second with
    a tightened best_t: every output equal."""

    tpu, ts, span = both(name)
    (jro, jrd), (tro, trd) = rays(512, span, seed=5)
    S, Q, n_sl = _stack_size(ts), 2, ts.sl_count
    jstack = jnp.zeros((S, 512), jnp.int32)
    jsp = jnp.ones(512, jnp.int32)
    jbt = jnp.full(512, jint.F32_MAX)
    tstack, tsp, tbt = T(jstack), T(jsp), T(jbt)
    ref_t = np.asarray(jint.closest_hit_bvh(tpu, jro, jrd, EPS).dst)
    for rnd in range(2):
        j = jpb.top_traverse(tpu.top_tab, jro, jrd, jbt, jstack, jsp, S=S, Q=Q,
                             n_sl=n_sl)
        t = tbvh.top_traverse(ts.top_tab, tro, trd, tbt, tstack, tsp, S=S, Q=Q,
                              n_sl=n_sl)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert t[2] is tstack  # the stack is updated in place
        assert int(t[0].max()) < n_sl
        if rnd == 0:
            assert (t[1] > 0).any() and (t[3] > 0).any()  # emits; stacks left
        jstack, jsp, tstack, tsp = j[2], j[3], t[2], t[3]
        # Round 2 prunes with a best_t between the true hit and infinity.
        hit = ref_t < 1e30
        bt = np.where(hit, np.where(hit, ref_t, 0) * 1.5, jint.F32_MAX)
        jbt, tbt = jnp.asarray(bt.astype(np.float32)), T(bt.astype(np.float32))


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_closest_hit_bvh_matches_jax(name):
    """The port's masked-stack walk, the card tests' reference, against the
    JAX walk: hit flags equal, t within rtol 5e-4 / atol 1e-5, winners equal
    on >= 95% of hits, and the same barycentrics and backside there."""

    tpu, ts, span = both(name)
    (jro, jrd), (tro, trd) = rays(512, span, seed=10)
    ref = jint.closest_hit_bvh(tpu, jro, jrd, EPS)
    got = tint.closest_hit_bvh(ts, tro, trd, EPS)
    hit = np.asarray(ref.hit)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.dst.numpy()[hit], np.asarray(ref.dst)[hit],
                               rtol=5e-4, atol=1e-5)
    same = (got.tri.numpy() == np.asarray(ref.tri)) & hit
    assert same[hit].mean() >= 0.95
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.backside.numpy()[same],
                                  np.asarray(ref.backside)[same])


def _jax_round_items(tpu, jro, jrd, Q=8):
    """One JAX top round, the superleaf sort and the JAX work items."""

    B = jro.x.shape[0]
    S = _stack_size(tpu)
    sl, *_, cnt_sl, _ = jpb.top_traverse(
        tpu.top_tab, jro, jrd, jnp.full(B, jint.F32_MAX),
        jnp.zeros((S, B), jnp.int32), jnp.ones(B, jnp.int32), S=S, Q=Q,
        n_sl=tpu.sl_count)
    pair = np.asarray(sl).reshape(-1)
    key = np.where(pair >= 0, pair, tpu.sl_count).astype(np.int32)
    order = np.argsort(key, kind="stable")
    items = jint._wf_work_items(jnp.asarray(key[order]), tpu.sl_count, PB,
                                cnt_sl)
    return key[order], order % B, items, cnt_sl


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_work_items_match_jax(name):
    """The port's _wf_work_items (histogram and searchsorted branches)
    gives the JAX package's items."""

    tpu, ts, span = both(name)
    (jro, jrd), _ = rays(512, span, seed=6)
    skey, _, items, cnt_sl = _jax_round_items(tpu, jro, jrd)
    for hist in (T(cnt_sl), None):
        got = tint._wf_work_items(T(skey), ts.sl_count, PB, hist)
        for a, b in zip(items, got):
            np.testing.assert_array_equal(b.numpy().reshape(-1),
                                          np.asarray(a).reshape(-1))


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_b6_pair_intersect_plain_matches_jax(name):
    tpu, ts, span = both(name)
    (jro, jrd), _ = rays(512, span, seed=7)
    skey, ray, (blk, sl, lo, hi, n_real, n_items), _ = _jax_round_items(tpu, jro, jrd)
    o = np.stack([np.asarray(c)[ray] for c in jro])
    d = np.stack([np.asarray(c)[ray] for c in jrd])
    W = jint.scene_tri_matrix(tpu)
    jt, _, _, _, jli = map(np.asarray, jpb.pair_intersect(
        blk, sl, lo, hi, jv3.V3(*map(jnp.asarray, o)),
        jv3.V3(*map(jnp.asarray, d)), W, EPS, SP=tpu.sl_stride, pair_block=PB,
        n_items_dyn=n_items))
    t, _, _, _, li = (x.numpy() for x in tbvh.pair_intersect(
        T(blk), T(sl), T(lo), T(hi), tv3.V3(*map(T, o)), tv3.V3(*map(T, d)),
        tint.scene_tri_matrix(ts), EPS, SP=ts.sl_stride, pair_block=PB,
        n_items=T(n_items)))
    n = int(n_real)
    jt, jli, t, li = jt[:n], jli[:n], t[:n], li[:n]
    hit = jt < 1e30
    assert hit.any() and n > 0
    np.testing.assert_array_equal(t < 1e30, hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=5e-4, atol=1e-5)
    assert (li[hit] == jli[hit]).mean() >= 0.95


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_b7_attr_fetch_plain_matches_jax(name):
    """Winners from the JAX stack walk, sorted by superleaf as
    wavefront_fetch_attrs sorts them, through both attr kernels."""

    tpu, ts, span = both(name)
    (jro, jrd), _ = rays(512, span, seed=8)
    h = jint.closest_hit_bvh(tpu, jro, jrd, EPS)
    SP, n_sl = tpu.sl_stride, tpu.sl_count
    hit, tri = np.asarray(h.hit), np.asarray(h.tri)
    key = np.where(hit, tri // SP, n_sl).astype(np.int32)
    order = np.argsort(key, kind="stable")
    li = np.where(hit, tri % SP, 0).astype(np.int32)[order]
    u, v = np.asarray(h.u)[order], np.asarray(h.v)[order]
    blk, sl, lo, hi, n_real, n_items = jint._wf_work_items(
        jnp.asarray(key[order]), n_sl, PB)
    A3 = tpu.wt_attr[: tpu.msl_count * SP].reshape(tpu.msl_count, SP, -1)
    ja = np.asarray(jpb.attr_fetch(blk, sl, lo, hi, jnp.asarray(li),
                                   jnp.asarray(u), jnp.asarray(v), A3,
                                   pair_block=PB, n_items_dyn=n_items))
    tA3 = ts.wt_attr[: ts.msl_count * SP].reshape(ts.msl_count, SP, -1)
    ta = tbvh.attr_fetch(T(blk), T(sl), T(lo), T(hi), T(li), T(u), T(v), tA3,
                         pair_block=PB, n_items=T(n_items)).numpy()
    n = int(n_real)
    assert ta.shape == ja.shape == (tbvh.IA_ROWS, 512) and n > 0
    np.testing.assert_allclose(ta[:, :n], ja[:, :n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_b4_packet_plain_matches_jax(name):
    """B4 with attributes against the JAX stack walk plus the JAX
    wavefront_fetch_attrs, and its active mask."""

    tpu, ts, span = both(name)
    (jro, jrd), (tro, trd) = rays(500, span, seed=9)
    ref = jint.closest_hit_bvh(tpu, jro, jrd, EPS)
    ia_ref = jint.wavefront_fetch_attrs(tpu, ref)
    W = tint.scene_tri_matrix(ts)
    t, u, v, det, tri, ia = (x.numpy() for x in tpk.packet_traverse(
        ts, tro, trd, EPS, W, with_attrs=True))
    hit = np.asarray(ref.hit)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(t < 1e30, hit)
    np.testing.assert_allclose(t[hit], np.asarray(ref.dst)[hit], rtol=5e-4, atol=1e-5)
    same = (tri == np.asarray(ref.tri)) & hit
    assert same[hit].mean() >= 0.95
    np.testing.assert_allclose(u[same], np.asarray(ref.u)[same], rtol=1e-4, atol=1e-5)
    rows = {tbvh.IA_N.start: ia_ref.n.x, tbvh.IA_GN.start + 1: ia_ref.gn.y,
            tbvh.IA_TU: ia_ref.tu, tbvh.IA_DET_SIGN: ia_ref.det_sign,
            tbvh.IA_MAT_ID: ia_ref.mat_id}
    for r, ref_row in rows.items():
        np.testing.assert_allclose(ia[r][same], np.asarray(ref_row)[same],
                                   rtol=1e-4, atol=1e-5, err_msg=str(r))
    assert not ia[:, ~hit].any()
    act = np.random.default_rng(2).random(500) < 0.6
    t2, *_, ia2 = tpk.packet_traverse(ts, tro, trd, EPS, W, active=T(act),
                                      with_attrs=True)
    assert (t2.numpy()[~act] == tbvh.F32_MAX).all() and not ia2.numpy()[:, ~act].any()
    np.testing.assert_array_equal(t2.numpy()[act], t[act])
