"""PyTorch port, two-level (instanced) scenes on the CPU against the JAX
package, its Pallas kernels in interpret mode: the flatten's two-level
tables, kernels B6 and B7 with the per-item instance word, kernel B4's
one two-level mode against both of the JAX kernel's, the routing of
closest_hit / closest_hit_attrs (the port's one instance route against both
of the JAX package's), a render, and the plain versions of the B6'
variants.

Scenes (tests/test_two_level.py): five transformed instances of one UV
sphere (one mirrored) over a ground quad under a quad light, built with
dense_max_tris=64 and two_level=True in both packages; and one rotated,
translated plate of a single superleaf (dense_max_tris=16).

Tolerances, as tests/test_torch_bvh.py states them for B4-B7: hit flags
equal, t within rtol 5e-4 / atol 1e-5 (the JAX kernels select candidates
with a bf16 3-pass product, the port in plain f32), winners equal on >= 95%
of hits; B7 rows within 1e-6 on lanes with the same winner (JAX normalises
the rotated geometric normal with rsqrt, the port with 1 / sqrt). The
render: >= 99% of pixels within 2e-3 and the mean within 1%."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.core import vec3 as jv3
from lupinpathtracer_tpu.kernels import intersect as jint
from lupinpathtracer_tpu.kernels import pallas_bvh as jpb
from lupinpathtracer_tpu.kernels import pallas_packet as jpk
from lupinpathtracer_tpu.render import renderer as jrenderer
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core import vec3 as tv3
from lupinpathtracer_tpu_torch.kernels import bvh as tbvh
from lupinpathtracer_tpu_torch.kernels import intersect as tint
from lupinpathtracer_tpu_torch.kernels import packet as tpk

from test_torch_bvh import PB, T
from test_torch_scene import _assert_scene_equal

EPS = 1e-4
B = 256  # rays per case: interpret-mode Pallas is slow


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Runs each test on one PyTorch thread: the suite runs in several
    worker processes at once, and PyTorch's intra-op thread pools in all of
    them oversubscribe the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def instanced_scene(pkg, n_inst=5):
    """tests/test_two_level.py::_instanced_scene through either package."""

    n_lat, n_lon = 12, 16
    lat = np.linspace(0.15, np.pi - 0.15, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    pts = np.asarray([[np.sin(a) * np.cos(b), np.cos(a), np.sin(a) * np.sin(b)]
                      for a in lat for b in lon], np.float32)
    idx = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            idx += [[a, b, c], [b, d, c]]
    sphere = pkg.MeshCPU(positions=pts, indices=np.asarray(idx, np.int32),
                         normals=pts.copy(), texcoords=None, colors=None)
    quad = pkg.MeshCPU(
        positions=np.array([[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]],
                           np.float32),
        indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=None, texcoords=None, colors=None)
    lamp = pkg.MeshCPU(
        positions=np.array([[-1, 6, -1], [1, 6, -1], [1, 6, 1], [-1, 6, 1]],
                           np.float32),
        indices=np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
        normals=None, texcoords=None, colors=None)
    m_gray, m_red, m_glossy, m_light = (pkg.Material() for _ in range(4))
    m_red.color = np.array([0.8, 0.2, 0.2, 1.0], np.float32)
    m_glossy.mat_type = int(pkg.MaterialType.GLOSSY)
    m_glossy.roughness = 0.2
    m_light.emission = np.array([12.0, 12.0, 12.0], np.float32)
    insts = []
    rng = np.random.default_rng(7)
    for i in range(n_inst):
        frame = np.zeros((3, 4), np.float32)
        frame[:, :3] = _rot_y(rng.uniform(0, 6.28)) * (0.5 + 0.3 * (i % 3))
        if i == 2:  # one mirrored instance: the det-sign path
            frame[:, 2] *= -1.0
        frame[:, 3] = (np.float32(-3 + 3 * (i % 3)), np.float32(1.0),
                       np.float32(-3 + 3 * (i // 3)))
        insts.append(pkg.InstanceCPU(frame=frame, mesh_idx=0, mat_idx=i % 3))
    eye = np.eye(3, 4, dtype=np.float32)
    insts.append(pkg.InstanceCPU(frame=eye, mesh_idx=1, mat_idx=0))
    insts.append(pkg.InstanceCPU(frame=eye, mesh_idx=2, mat_idx=3))
    return pkg.SceneCPU(meshes=[sphere, quad, lamp], instances=insts,
                        materials=[m_gray, m_red, m_glossy, m_light],
                        environments=[], textures=[])


PLATE_FRAME = np.concatenate(
    [_rot_y(0.7), np.array([[5.0], [2.0], [-3.0]], np.float32)], axis=1)


def plate_scene(pkg):
    """tests/test_two_level.py:444-477: one instance of a 162-triangle
    plate, far from the origin: a single superleaf."""

    n = 10
    g = np.linspace(-1, 1, n, dtype=np.float32)
    xx, zz = np.meshgrid(g, g)
    pts = np.stack([xx, 0.3 * np.sin(3 * xx) * np.cos(3 * zz), zz], -1)
    idx = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            idx += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    mesh = pkg.MeshCPU(positions=pts.reshape(-1, 3),
                       indices=np.asarray(idx, np.int32), normals=None,
                       texcoords=None, colors=None)
    mat = pkg.Material()
    mat.color = np.array([0.7, 0.7, 0.7, 1.0], np.float32)
    return pkg.SceneCPU(
        meshes=[mesh], materials=[mat], environments=[], textures=[],
        instances=[pkg.InstanceCPU(frame=PLATE_FRAME, mesh_idx=0, mat_idx=0)])


SCENES = {"instanced": (instanced_scene, 64), "plate": (plate_scene, 16)}


def _shell_rays(seed):
    """Rays from a shell of radius 10 aimed at the instances, with some
    aimed past the ground quad so that hits and misses both occur."""

    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, B)).astype(np.float32)
    o /= np.linalg.norm(o, axis=0, keepdims=True)
    o *= 10.0
    tgt = rng.uniform(-3, 3, size=(3, B)).astype(np.float32)
    tgt[:, ::5] *= 6.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d.astype(np.float32)


def _plate_rays(seed):
    """Rays from above the plate at its interior, and some past it."""

    rng = np.random.default_rng(seed)
    R, tr = PLATE_FRAME[:, :3], PLATE_FRAME[:, 3]
    loc = np.stack([rng.uniform(-0.7, 0.7, B), np.zeros(B),
                    rng.uniform(-0.7, 0.7, B)]).astype(np.float32)
    loc[:, ::5] *= 3.0
    tgt = R @ loc + tr[:, None]
    up = R @ np.array([0.0, 1.0, 0.0], np.float32)
    o = tgt + up[:, None] * 6.0 + rng.normal(scale=0.5, size=(3, B)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _v3s(o, d):
    return ((jv3.V3(*map(jnp.asarray, o)), jv3.V3(*map(jnp.asarray, d))),
            (tv3.V3(*map(torch.from_numpy, o)), tv3.V3(*map(torch.from_numpy, d))))


@pytest.fixture(scope="module")
def env():
    """The JAX side's routing knobs for the whole module: no packet probe
    at scene build, and an explicit route per call (`sort_route`)."""

    mp = pytest.MonkeyPatch()
    mp.setenv("LUPIN_SKIP_PROBE", "1")
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def scenes(env):
    out = {}
    for name, (build, dmt) in SCENES.items():
        tpu = build_scene_tpu(build(jl), dense_max_tris=dmt, two_level=True)
        ts = tl.build_scene_torch(build(tl), device="cpu", dense_max_tris=dmt,
                                  two_level=True)
        assert tpu.two_level and ts.two_level
        out[name] = (tpu, ts)
    assert out["instanced"][1].sl_count > out["instanced"][1].msl_count >= 3
    assert out["plate"][1].top_root_is_leaf and out["plate"][1].sl_count == 1
    return out


@pytest.fixture(scope="module")
def jax_hits(scenes, env):
    """The JAX closest hit (sort route, in-kernel instance tables) and its
    attributes on each scene's rays, computed once."""

    out = {}
    with env.context() as m:
        m.setenv("LUPIN_NO_PACKET", "1")
        for name, make in (("instanced", _shell_rays), ("plate", _plate_rays)):
            o, d = make(21)
            (jro, jrd), _ = _v3s(o, d)
            tpu = scenes[name][0]
            h = jint.closest_hit(tpu, jro, jrd, jnp.float32(EPS), coherent=False)
            out[name] = (o, d, h, jint.wavefront_fetch_attrs(tpu, h))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_two_level_scene_tensors_equal_jax(scenes, name):
    """Every field of the two-level flatten, gsl_inst / gsl_msl / gsl_meta /
    inst_inv / inst_normal_mat / inst_mat among them, equals the JAX
    array; and scene_from_numpy carries the JAX arrays across unchanged."""

    from lupinpathtracer_tpu_torch.scene import flatten as tflatten

    tpu, ts = scenes[name]
    _assert_scene_equal(tpu, ts)
    assert ts.gsl_meta.shape == (ts.sl_count, 128)
    arrays = {f: np.asarray(getattr(tpu, f)) for f in tflatten.ARRAY_FIELDS}
    statics = {f: getattr(tpu, f) for f in tflatten.STATIC_FIELDS}
    carried = tflatten.scene_from_numpy(arrays, statics, "cpu")
    for f in ("gsl_inst", "gsl_msl", "gsl_meta", "inst_inv", "inst_normal_mat",
              "inst_mat", "sl_sub", "top_tab"):
        assert torch.equal(getattr(carried, f), getattr(ts, f)), f


def _hits_match(t, tri, ref_t, ref_tri, need_miss=True):
    hit = np.asarray(ref_t) < 1e30
    assert hit.any() and ((~hit).any() or not need_miss)
    np.testing.assert_array_equal(t < 1e30, hit)
    np.testing.assert_allclose(t[hit], np.asarray(ref_t)[hit], rtol=5e-4, atol=1e-5)
    same = (tri == np.asarray(ref_tri)) & hit
    assert same[hit].mean() >= 0.95
    return same


def test_b6_instance_transform_plain_matches_jax(scenes):
    """pair_intersect with inst / txf_tab on the items of one JAX top round,
    and the same items on rays moved to mesh space ahead of the kernel."""

    tpu, ts = scenes["instanced"]
    o, d = _shell_rays(22)
    (jro, jrd), _ = _v3s(o, d)
    S = 7 * tpu.top_depth + 10
    sl, *_, cnt_sl, _ = jpb.top_traverse(
        tpu.top_tab, jro, jrd, jnp.full(B, jint.F32_MAX),
        jnp.zeros((S, B), jnp.int32), jnp.ones(B, jnp.int32), S=S, Q=8,
        n_sl=tpu.sl_count)
    pair = np.asarray(sl).reshape(-1)
    key = np.where(pair >= 0, pair, tpu.sl_count).astype(np.int32)
    order = np.argsort(key, kind="stable")
    skey, ray = key[order], order % B
    blk, sl_k, lo, hi, n_real, n_items = jint._wf_work_items(
        jnp.asarray(skey), tpu.sl_count, PB, cnt_sl)
    jm, ji, jtx, _, _ = jint._item_instancing(tpu, sl_k)
    so, sd = o[:, ray], d[:, ray]
    SP = tpu.sl_stride
    jt, _, _, jdet, jli = map(np.asarray, jpb.pair_intersect(
        blk, sl_k, lo, hi, jv3.V3(*map(jnp.asarray, so)),
        jv3.V3(*map(jnp.asarray, sd)), jint.scene_tri_matrix(tpu), EPS, SP=SP,
        pair_block=PB, msl=jm, inst=ji, txf_tab=jtx, n_items_dyn=n_items))
    tm, ti_, ttx, _, _ = tint._item_instancing(ts, T(sl_k))
    for a, b in ((tm, jm), (ti_, ji), (ttx, jtx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    W = tint.scene_tri_matrix(ts)
    tso, tsd = tv3.V3(*map(T, so)), tv3.V3(*map(T, sd))
    kw = dict(SP=SP, pair_block=PB, n_items=T(n_items))
    got = tbvh.pair_intersect(T(blk), tm, T(lo), T(hi), tso, tsd, W, EPS,
                              inst=ti_, txf_tab=ttx, **kw)
    n = int(n_real)
    t, det, li = (got[i].numpy()[:n] for i in (0, 3, 4))
    same = _hits_match(t, li, jt[:n], jli[:n])
    np.testing.assert_array_equal(det[same] > 0, jdet[:n][same] > 0)
    # Rays moved to mesh space in PyTorch, B6 without the instance word.
    m12 = ts.inst_inv.reshape(-1, 12)[
        ts.gsl_inst[T(skey).clamp(max=ts.sl_count - 1).long()].long()]
    mo, md = tbvh.mesh_space(m12, tso, tsd)
    pre = tbvh.pair_intersect(T(blk), tm, T(lo), T(hi), tv3.V3(*mo),
                              tv3.V3(*md), W, EPS, **kw)
    for a, b in zip(got, pre):
        assert torch.equal(a[:n], b[:n])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_b7_instance_rotation_plain_matches_jax(scenes, jax_hits, name):
    """attr_fetch with inst / nrm_tab / ovr_tab on the JAX winners, sorted
    by superleaf as wavefront_fetch_attrs sorts them."""

    tpu, ts = scenes[name]
    _, _, h, _ = jax_hits[name]
    SP, n_sl = tpu.sl_stride, tpu.sl_count
    hit, tri = np.asarray(h.hit), np.asarray(h.tri)
    key = np.where(hit, tri // SP, n_sl).astype(np.int32)
    order = np.argsort(key, kind="stable")
    li = np.where(hit, tri % SP, 0).astype(np.int32)[order]
    u, v = np.asarray(h.u)[order], np.asarray(h.v)[order]
    blk, sl_k, lo, hi, n_real, n_items = jint._wf_work_items(
        jnp.asarray(key[order]), n_sl, PB)
    jm, ji, _, jnrm, jovr = jint._item_instancing(tpu, sl_k)
    A3 = tpu.wt_attr[: tpu.msl_count * SP].reshape(tpu.msl_count, SP, -1)
    ja = np.asarray(jpb.attr_fetch(
        blk, jm, lo, hi, jnp.asarray(li), jnp.asarray(u), jnp.asarray(v), A3,
        pair_block=PB, inst=ji, nrm_tab=jnrm, ovr_tab=jovr, n_items_dyn=n_items))
    tm, ti_, _, tnrm, tovr = tint._item_instancing(ts, T(sl_k))
    np.testing.assert_array_equal(tnrm.numpy(), np.asarray(jnrm))
    np.testing.assert_array_equal(tovr.numpy(), np.asarray(jovr))
    tA3 = ts.wt_attr[: ts.msl_count * SP].reshape(ts.msl_count, SP, -1)
    ta = tbvh.attr_fetch(T(blk), tm, T(lo), T(hi), T(li), T(u), T(v), tA3,
                         pair_block=PB, n_items=T(n_items), inst=ti_,
                         nrm_tab=tnrm, ovr_tab=tovr).numpy()
    n = int(n_real)
    assert ta.shape == ja.shape == (tbvh.IA_ROWS, B) and n > 0
    np.testing.assert_allclose(ta[:, :n], ja[:, :n], rtol=0, atol=1e-6)
    gn = ta[tbvh.IA_GN, :n]
    np.testing.assert_allclose((gn ** 2).sum(0), 1.0, atol=1e-5)
    inst = np.asarray(tpu.gsl_inst)[key[order][:n]]
    np.testing.assert_array_equal(ta[tbvh.IA_MAT_ID, :n],
                                  np.asarray(tpu.inst_mat)[inst])


def test_b4_two_level_modes_match_jax(scenes, env):
    """packet_traverse, plain version: the port's one two-level mode (each
    leaf's gsl_meta row) matches the JAX kernel in both of its routings,
    resident and TL_STREAM (LUPIN_PACKET_STREAM=1), and the brute-force
    reference; the active mask makes inactive lanes miss and leaves the
    others' hits as they were."""

    tpu, ts = scenes["instanced"]
    o, d = _shell_rays(23)
    (jro, jrd), (tro, trd) = _v3s(o, d)
    W = tint.scene_tri_matrix(ts)
    assert jpk.smem_tables_fit(tpu)
    res = tpk.packet_traverse(ts, tro, trd, EPS, W)
    t, tri = res[0].numpy(), res[4].numpy()
    jW = jint.scene_tri_matrix(tpu)
    jres = jpk.packet_traverse(tpu, jro, jrd, EPS, jW)
    with env.context() as m:
        m.setenv("LUPIN_PACKET_STREAM", "1")
        assert not jpk.smem_tables_fit(tpu)
        jstm = jpk.packet_traverse(tpu, jro, jrd, EPS, jW)
    for jr in (jres, jstm):
        same = _hits_match(t, tri, np.asarray(jr[0]), np.asarray(jr[4]))
        np.testing.assert_allclose(res[1].numpy()[same], np.asarray(jr[1])[same],
                                   rtol=1e-4, atol=1e-5)
    brute = tint.closest_hit_brute_two_level(ts, tro, trd, EPS, W)
    _hits_match(t, tri, brute.dst.numpy(), brute.tri.numpy())
    act = np.random.default_rng(2).random(B) < 0.6
    t2 = tpk.packet_traverse(ts, tro, trd, EPS, W, active=T(act))[0].numpy()
    assert (t2[~act] == tbvh.F32_MAX).all()
    np.testing.assert_array_equal(t2[act], t[act])
    with pytest.raises(ValueError, match="wavefront_fetch_attrs"):
        tpk.packet_traverse(ts, tro, trd, EPS, W, with_attrs=True)


def _attrs_match(ia, ia_ref, same):
    for f in ("n", "gn", "vc"):
        for a, b in zip(getattr(ia, f), getattr(ia_ref, f)):
            np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                       rtol=1e-4, atol=1e-5, err_msg=f)
    for f in ("tu", "tv", "vca", "det_sign"):
        np.testing.assert_allclose(getattr(ia, f).numpy()[same],
                                   np.asarray(getattr(ia_ref, f))[same],
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(ia.mat_id.numpy()[same],
                                  np.asarray(ia_ref.mat_id)[same])


def _jax_large_instance_hits(tpu, o, d, monkeypatch):
    """The JAX sort route with INST_SMEM_MAX = 0 (tests/test_two_level.py:
    531-589): rays moved to mesh space and rows rotated in XLA around its
    kernels; the port has only the route with the instance word."""

    (jro, jrd), _ = _v3s(o, d)
    with monkeypatch.context() as m:
        m.setattr(jint, "INST_SMEM_MAX", 0)
        m.setenv("LUPIN_NO_PACKET", "1")
        jh = jint.closest_hit(tpu, jro, jrd, jnp.float32(EPS), coherent=False)
        return jh, jint.wavefront_fetch_attrs(tpu, jh)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("inst_smem_max", [jint.INST_SMEM_MAX, 0],
                         ids=["in_kernel", "large_instance"])
def test_closest_hit_attrs_routes_match_jax(scenes, jax_hits, monkeypatch,
                                            name, inst_smem_max):
    """closest_hit_attrs, coherent (B4; the single-superleaf shortcut on the
    plate) and not (B5/B6, B7, always with the instance word), against the
    JAX sort route with its in-kernel instance tables and, with the JAX
    package's INST_SMEM_MAX = 0, against its large-instance route (rays
    transformed and rows rotated in XLA), and against the brute-force
    reference. No det-sign fixup: backside equals JAX's."""

    tpu, ts = scenes[name]
    o, d, jh, jia = jax_hits[name]
    if inst_smem_max == 0:
        jh, jia = _jax_large_instance_hits(tpu, o, d, monkeypatch)
    _, (tro, trd) = _v3s(o, d)
    W = tint.scene_tri_matrix(ts)
    brute = tint.closest_hit_brute_two_level(ts, tro, trd, EPS, W)
    act = np.random.default_rng(4).random(B) < 0.8
    for coherent in (True, False):
        h, ia = tint.closest_hit_attrs(ts, tro, trd, EPS, coherent=coherent)
        assert isinstance(ia, tint.InterpAttrs)
        same = _hits_match(h.dst.numpy(), h.tri.numpy(), jh.dst, jh.tri)
        _hits_match(h.dst.numpy(), h.tri.numpy(), brute.dst.numpy(),
                    brute.tri.numpy())
        np.testing.assert_array_equal(h.backside.numpy()[same],
                                      np.asarray(jh.backside)[same])
        _attrs_match(ia, jia, same)
        miss = ~h.hit.numpy()
        assert not ia.n.x.numpy()[miss].any() and not ia.mat_id.numpy()[miss].any()
        h2 = tint.closest_hit(ts, tro, trd, EPS, W=W, active=T(act),
                              coherent=coherent)
        assert not h2.hit.numpy()[~act].any()
        np.testing.assert_array_equal(h2.dst.numpy()[act], h.dst.numpy()[act])


def test_instance_routes_equal_each_other(scenes, jax_hits, monkeypatch):
    """The port's one two-level route of the sort wavefront (B6/B7 with the
    instance word) against the JAX package's large-instance route and the
    brute-force reference: hit flags equal, t and winners to the module's
    tolerances, rows to JAX's where the winners agree."""

    tpu, ts = scenes["instanced"]
    o, d, _, _ = jax_hits["instanced"]
    _, (tro, trd) = _v3s(o, d)
    jh, jia = _jax_large_instance_hits(tpu, o, d, monkeypatch)
    h, ia = tint.closest_hit_attrs(ts, tro, trd, EPS, coherent=False)
    same = _hits_match(h.dst.numpy(), h.tri.numpy(), jh.dst, jh.tri)
    _attrs_match(ia, jia, same)
    brute = tint.closest_hit_brute_two_level(ts, tro, trd, EPS,
                                             tint.scene_tri_matrix(ts))
    _hits_match(h.dst.numpy(), h.tri.numpy(), brute.dst.numpy(),
                brute.tri.numpy())


def test_large_instance_route_matches_jax_large_instance_route(scenes, env,
                                                                monkeypatch):
    """INST_SMEM_MAX = 0 in the JAX package (tests/test_two_level.py:
    531-589): the JAX package's XLA pre-transform and rotation tail against
    the port's one route, the instance word in B6 and B7."""

    tpu, ts = scenes["instanced"]
    o, d = _shell_rays(24)
    (jro, jrd), (tro, trd) = _v3s(o, d)
    monkeypatch.setattr(jint, "INST_SMEM_MAX", 0)
    monkeypatch.setenv("LUPIN_NO_PACKET", "1")
    jh = jint.closest_hit(tpu, jro, jrd, jnp.float32(EPS), coherent=False)
    jia = jint.wavefront_fetch_attrs(tpu, jh)
    h, ia = tint.closest_hit_attrs(ts, tro, trd, EPS, coherent=False)
    same = _hits_match(h.dst.numpy(), h.tri.numpy(), jh.dst, jh.tri)
    _attrs_match(ia, jia, same)


def _cam_desc(pkg):
    cam = np.zeros((3, 4), np.float32)
    cam[:, :3] = np.eye(3)
    cam[:, 3] = (0.0, 2.0, -12.0)
    desc = pkg.PathtraceDesc()
    desc.camera_transform = cam
    desc.advanced.max_radiance = 10.0
    return desc


def test_two_level_render_matches_jax(scenes):
    """The slice as a whole: render_progressive of the instanced scene,
    32x24, 3 bounces, 2 spp (B4 on the camera batch, B5/B6/B7 on the
    bounces, glossy and matte instances, a mirrored one, the quad light),
    against the JAX render."""

    tpu, ts = scenes["instanced"]
    baked = dict(max_bounces=3, samples_per_pixel=2)
    stats = {}
    img = tl.render_progressive(ts, _cam_desc(tl), tl.BakedPathtraceParams(**baked),
                                32, 24, 1, device="cpu", stats=stats)
    jimg = np.asarray(jrenderer.render_progressive(
        tpu, _cam_desc(jl), jl.BakedPathtraceParams(**baked), 32, 24, 1))
    assert img.shape == (24, 32, 3) and np.isfinite(img).all() and img.mean() > 0
    assert (np.abs(img - jimg) <= 2e-3).mean() >= 0.99
    assert abs(img.mean() - jimg.mean()) <= 0.01 * jimg.mean()
    assert stats["rays"] > 32 * 24 * 2


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pair_variant_plain_versions(scenes, jax_hits, name):
    """B6': V0 and V4 equal pair_intersect_plain; V1 picks V0's winner on
    all but near-tie lanes (>= 99%) with V0's t, u, v, det there to 1e-5
    relative; V2 returns V0's (t, index) and V3 V1's index, with u, v, det
    zero; V5 returns min(nt) <= every hit's t numerator; an all-empty grid
    leaves every lane a miss."""

    from lupinpathtracer_tpu_torch.tools import prof_pair

    _, ts = scenes[name]
    o, d, _, _ = jax_hits[name]
    _, (tro, trd) = _v3s(o, d)
    W = tint.scene_tri_matrix(ts)
    if ts.top_root_is_leaf:
        blk = torch.arange(B // PB, dtype=torch.int32)
        msl_k, inst_k, txf, _, _ = tint._item_instancing(ts, torch.zeros_like(blk))
        args = (blk, msl_k, blk * PB, blk * PB + PB, tro, trd)
        kw = dict(SP=ts.sl_stride, pair_block=PB, inst=inst_k, txf_tab=txf)
    else:
        args, kw, _ = prof_pair.round1_state(ts, tro, trd)
    base = tbvh.pair_intersect_plain(*args, W, EPS, **kw)
    out = {v: prof_pair.run_variant(v, args, W, EPS, kw) for v in prof_pair.VARIANTS}
    hit = base[0] < 1e30
    assert bool(hit.any())
    for v in ("V0", "V4"):
        for a, b in zip(out[v], base):
            assert torch.equal(a, b), v
    same = (out["V1"][4] == base[4]) & hit
    assert torch.equal(out["V1"][0] < 1e30, hit)
    assert float(same.sum()) >= 0.99 * float(hit.sum())
    for a, b in zip(out["V1"][:4], base[:4]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-6)
    assert torch.equal(out["V2"][0], base[0]) and torch.equal(out["V2"][4], base[4])
    assert torch.equal(out["V3"][4], out["V1"][4])
    for v in ("V2", "V3", "V5"):
        assert not any(bool(x.any()) for x in out[v][1:4]), v
    assert not bool(out["V5"][4].any())
    assert bool((out["GRID"][0] == tbvh.F32_MAX).all())
    with pytest.raises(ValueError, match="unknown pair variant"):
        tbvh.pair_intersect_variant("V9", *args, W, EPS, **kw)
