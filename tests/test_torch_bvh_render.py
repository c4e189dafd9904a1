"""PyTorch port, the BVH route end to end on the CPU: the wavefront's
routing (kernel B4 for coherent batches, rounds of B5/B6 plus B7 for
bounce batches, the single-superleaf shortcut) against the JAX package's
closest_hit_wavefront (its sort route in interpret mode) and its
masked-stack walk, then a BVH render, a force_software_bvh render and a
two-level render (tests/test_torch_two_level.py holds those to JAX).

Tolerances: hit flags equal, t within rtol 5e-4 / atol 1e-5 and winning
triangles equal on >= 95% of hits (tests/test_wavefront.py:124-134);
attributes on lanes with the same winner within rtol 1e-4 / atol 1e-5 (the
barycentrics come from two formulations of the same intersection). Renders:
>= 99% of pixels within 2e-3, image mean within 1%, n_traced equal on
>= 99% of lanes (a shared-edge tie can send a lane down another path)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.io import builtin as jbuiltin
from lupinpathtracer_tpu.io import synthetic as jsyn
from lupinpathtracer_tpu.kernels import intersect as jint
from lupinpathtracer_tpu.render import integrators as jintg
from lupinpathtracer_tpu.render import renderer as jrenderer
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.io import builtin as tbuiltin
from lupinpathtracer_tpu_torch.io import synthetic as tsyn
from lupinpathtracer_tpu_torch.kernels import intersect as tint
from lupinpathtracer_tpu_torch.render import integrators as tintg
from lupinpathtracer_tpu_torch.render import renderer as trenderer

from test_torch_bvh import EPS, T, both, rays

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cornell_32_standard.npy")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Runs each test on one PyTorch thread: the suite runs in several
    worker processes at once, and PyTorch's intra-op thread pools in all of
    them oversubscribe the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hits_match(got, ref_hit, ref_t, ref_tri):
    hit = np.asarray(ref_hit)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.dst.numpy()[hit], np.asarray(ref_t)[hit],
                               rtol=5e-4, atol=1e-5)
    same = got.tri.numpy() == np.asarray(ref_tri)
    assert same[hit].mean() >= 0.95
    return same & hit


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_closest_hit_wavefront_routes_match_jax(name, monkeypatch):
    """Both routes of the port's closest_hit_wavefront against the JAX sort
    wavefront (interpret mode) and the JAX stack walk, with an active mask."""

    tpu, ts, span = both(name)
    (jro, jrd), (tro, trd) = rays(600, span, seed=11)
    act = np.random.default_rng(3).random(600) < 0.8
    ref = jint.closest_hit_bvh(tpu, jro, jrd, EPS)
    with monkeypatch.context() as m:
        # The JAX sort route; the port reads the switch too, so it is set
        # around the JAX call only.
        m.setenv("LUPIN_NO_PACKET", "1")
        jw = jint.closest_hit_wavefront(tpu, jro, jrd, EPS,
                                        active=jnp.asarray(act), coherent=False)
    ref_hit = np.asarray(ref.hit) & act
    np.testing.assert_array_equal(np.asarray(jw.hit), ref_hit)
    tint.HOST_SYNCS["wavefront"] = 0
    for coherent in (True, False):
        got = tint.closest_hit_wavefront(ts, tro, trd, EPS, active=T(act),
                                         coherent=coherent)
        _hits_match(got, ref_hit, ref.dst, ref.tri)
        _hits_match(got, jw.hit, jw.dst, jw.tri)
    # The packet route does not sync; the sort route syncs once per round
    # check (600 lanes pad to one 2048-lane block: tail rounds only).
    assert tint.HOST_SYNCS["wavefront"] >= 2


def test_single_superleaf_shortcut_matches_jax():
    """A scene of one superleaf (the Cornell box on the BVH route): B6 over
    every ray block, no top traversal."""

    tpu = build_scene_tpu(jbuiltin.build_scene_cornell_box()[0], dense_max_tris=8)
    ts = tl.build_scene_torch(tbuiltin.build_scene_cornell_box()[0],
                              device="cpu", dense_max_tris=8)
    assert ts.use_bvh and ts.top_root_is_leaf
    (jro, jrd), (tro, trd) = rays(300, 0.8, seed=12)
    ref = jint.closest_hit_bvh(tpu, jro, jrd, EPS)
    jw = jint.closest_hit_wavefront(tpu, jro, jrd, EPS)
    for coherent in (True, False):
        got = tint.closest_hit_wavefront(ts, tro, trd, EPS, coherent=coherent)
        _hits_match(got, ref.hit, ref.dst, ref.tri)
        _hits_match(got, jw.hit, jw.dst, jw.tri)


@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_closest_hit_attrs_routes_match_jax(name):
    """closest_hit_attrs on both routes (B4 fused attributes; the sort
    wavefront plus wavefront_fetch_attrs) against the JAX stack walk with
    its det-sign fixup and the JAX wavefront_fetch_attrs."""

    tpu, ts, span = both(name)
    (jro, jrd), (tro, trd) = rays(600, span, seed=13)
    act = np.random.default_rng(4).random(600) < 0.8
    jh = jint.closest_hit(tpu, jro, jrd, EPS, active=jnp.asarray(act))
    ia_ref = jint.wavefront_fetch_attrs(tpu, jh)
    outs = []
    for coherent in (True, False):
        h, ia = tint.closest_hit_attrs(ts, tro, trd, EPS, active=T(act),
                                       coherent=coherent)
        assert isinstance(ia, tint.InterpAttrs)
        same = _hits_match(h, jh.hit, jh.dst, jh.tri)
        np.testing.assert_array_equal(h.backside.numpy()[same],
                                      np.asarray(jh.backside)[same])
        for a, b in ((ia.n.x, ia_ref.n.x), (ia.gn.z, ia_ref.gn.z),
                     (ia.tv, ia_ref.tv), (ia.vca, ia_ref.vca),
                     (ia.det_sign, ia_ref.det_sign)):
            np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(ia.mat_id.numpy()[same],
                                      np.asarray(ia_ref.mat_id)[same])
        miss = ~h.hit.numpy()
        assert not ia.n.x.numpy()[miss].any() and not ia.mat_id.numpy()[miss].any()
        outs.append((h, ia))
    # The two routes agree with each other exactly where they pick the same
    # triangle: both evaluate it in plain f32.
    (h1, a1), (h2, a2) = outs
    s = (h1.tri == h2.tri) & h1.hit
    assert torch.equal(h1.dst[s], h2.dst[s]) and torch.equal(a1.n.y[s], a2.n.y[s])


def _terrain_desc(pkg, cams):
    desc = pkg.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.pathtrace_type = pkg.PathtraceType.STANDARD
    desc.advanced.max_radiance = 10.0
    return desc


def test_bvh_render_matches_jax():
    """render_progressive of the 2048-triangle terrain (single-level BVH:
    B4 camera rays, B5/B6/B7 bounces) at 64x36, 2 spp, 4 bounces, 2
    accumulations, against the JAX CPU render; plus pathtrace_spp's
    n_traced lane by lane."""

    js, jc = jsyn.build_scene_terrain(n_tris=2048)
    tsc, tc = tsyn.build_scene_terrain(n_tris=2048)
    tpu = build_scene_tpu(js)
    ts = tl.build_scene_torch(tsc, device="cpu")
    assert ts.use_bvh and not ts.two_level and ts.sl_count > 1
    baked = dict(max_bounces=4, samples_per_pixel=2)
    stats = {}
    img = tl.render_progressive(ts, _terrain_desc(tl, tc),
                                tl.BakedPathtraceParams(**baked), 64, 36, 2,
                                device="cpu", stats=stats)
    jimg = np.asarray(jrenderer.render_progressive(
        tpu, _terrain_desc(jl, jc), jl.BakedPathtraceParams(**baked), 64, 36, 2))
    assert img.shape == (36, 64, 3) and np.isfinite(img).all() and img.mean() > 0
    assert (np.abs(img - jimg) <= 2e-3).mean() >= 0.99
    assert abs(img.mean() - jimg.mean()) <= 0.01 * jimg.mean()
    assert stats["rays"] > 64 * 36 * 2

    W, H = 64, 36
    gx = np.tile(np.arange(W, dtype=np.int32), H)
    gy = np.repeat(np.arange(H, dtype=np.int32), W)
    pix = (gy * W + gx).astype(np.int32)
    jacc, jnt = jintg.pathtrace_spp(
        tpu, jintg.make_ctx(tpu, jnp.float32(1e-3)),
        jnp.asarray(pix.astype(np.uint32)), jnp.asarray(gx), jnp.asarray(gy),
        (jnp.float32(W), jnp.float32(H)),
        jrenderer._camera_args(_terrain_desc(jl, jc)), False, jnp.uint32(1),
        jnp.uint32(0), 2, int(jl.PathtraceType.STANDARD), 4, jnp.float32(10.0))
    tacc, tnt = tintg.pathtrace_spp(
        ts, tintg.make_ctx(ts, float(np.float32(1e-3))), T(pix), T(gx), T(gy),
        (W, H), trenderer._camera_args(_terrain_desc(tl, tc)), False, 1, 0, 2,
        int(tl.PathtraceType.STANDARD), 4, 10.0)
    assert (tnt.numpy() == np.asarray(jnt)).mean() >= 0.99


def test_force_software_bvh_cornell_golden():
    """The Cornell box forced onto the BVH route (one superleaf: B6 and B7)
    against the pinned 32x32 golden: >= 99% of pixels within 2e-3, image
    mean within 1% (the dense route's golden rule)."""

    golden = np.load(GOLDEN)
    scene, cams = tbuiltin.build_scene_cornell_box()
    ts = tl.build_scene_torch(scene, device="cpu")
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.advanced.max_radiance = 10.0
    desc.force_software_bvh = True
    assert trenderer._select_backend(ts, desc).use_bvh and not ts.use_bvh
    img = tl.render_progressive(
        ts, desc, tl.BakedPathtraceParams(max_bounces=8, samples_per_pixel=8),
        32, 32, 8, device="cpu")
    assert np.isfinite(img).all()
    assert (np.abs(img - golden) <= 2e-3).mean() >= 0.99
    assert abs(img.mean() - golden.mean()) <= 0.01 * golden.mean()


def test_two_level_scene_raises():
    """Instanced (two-level) scenes no longer raise (the name is kept from
    when they did): pathtrace_scene renders the 6-instance grid field,
    finite and lit, and progressively the same as a second call."""

    from test_torch_scene import grid_field

    ts = tl.build_scene_torch(grid_field(tl, tbuiltin), device="cpu")
    assert ts.two_level and ts.use_bvh
    _, cams = tbuiltin.build_scene_cornell_box()
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    baked = tl.BakedPathtraceParams(max_bounces=2, samples_per_pixel=2)
    img0 = tl.new_accumulation_buffer(16, 16, device="cpu")
    img = tl.pathtrace_scene(ts, img0, desc, baked)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0
    assert torch.equal(img, tl.pathtrace_scene(ts, img0, desc, baked))
