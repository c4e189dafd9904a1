"""PyTorch port, the falsecolor AOVs, the debug heatmaps and the denoiser
on the CPU, against the JAX package on the same scenes and seeds: every
FalsecolorType through pathtrace_scene_falsecolor on a dense Cornell box
(B2's plain version), on the same box forced onto the BVH route (B6/B7)
and on the five-instance field of tests/test_torch_two_level.py (B4, B7
with the instance word); hash_color bit for bit; the heatmap's colour
bands across every edge; count_traversal on every route and the three
debug modes; and the à-trous denoiser with and without its guides.

Tolerances: AOV images within 1e-5 on >= 99% of pixels on the dense route
and >= 95% on the BVH routes (the winning triangle is held equal on >= 95%
of hits there, tests/test_torch_bvh.py); the heatmap within 1 ulp-scale
rtol 1e-6 (XLA's and PyTorch's pow); counts equal exactly on >= 99% of
rays (a ray whose best t ties a superleaf's entry prunes differently
otherwise); the denoiser at rtol 1e-5 / atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.core import rng as jrng
from lupinpathtracer_tpu.denoise import atrous as jatrous
from lupinpathtracer_tpu.io import builtin as jbuiltin
from lupinpathtracer_tpu.io import synthetic as jsyn
from lupinpathtracer_tpu.kernels import intersect as jint
from lupinpathtracer_tpu.render import renderer as jrenderer
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core import rng as trng
from lupinpathtracer_tpu_torch.io import builtin as tbuiltin
from lupinpathtracer_tpu_torch.io import synthetic as tsyn
from lupinpathtracer_tpu_torch.kernels import intersect as tint
from lupinpathtracer_tpu_torch.render import renderer as trenderer

from test_torch_render import _desc
from test_torch_scene import cornell_glossy
from test_torch_two_level import _cam_desc, instanced_scene

FC = tl.FalsecolorType
PT = tl.PathtraceType
EPS = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Runs each test on one PyTorch thread: the suite runs in several
    worker processes at once, and PyTorch's intra-op thread pools in all of
    them oversubscribe the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def routes():
    """{route: (JAX scene, port scene, JAX desc, port desc, share)}: the
    glossy Cornell box on the dense route and forced onto the BVH route,
    and the five-instance field; `share` is the least share of pixels that
    must agree."""

    mp = pytest.MonkeyPatch()
    mp.setenv("LUPIN_SKIP_PROBE", "1")
    tpu = build_scene_tpu(cornell_glossy(jl, jbuiltin))
    ts = tl.build_scene_torch(cornell_glossy(tl, tbuiltin), device="cpu")
    out = {"dense": (tpu, ts, _desc(jl, PT.STANDARD), _desc(tl, PT.STANDARD), 0.99)}
    jd, td = _desc(jl, PT.STANDARD), _desc(tl, PT.STANDARD)
    jd.force_software_bvh = td.force_software_bvh = True
    out["bvh"] = (tpu, ts, jd, td, 0.95)
    out["two_level"] = (
        build_scene_tpu(instanced_scene(jl), dense_max_tris=64, two_level=True),
        tl.build_scene_torch(instanced_scene(tl), device="cpu", dense_max_tris=64,
                             two_level=True),
        _cam_desc(jl), _cam_desc(tl), 0.95)
    yield out
    mp.undo()


@pytest.mark.parametrize("fc", list(FC), ids=lambda f: f.name)
@pytest.mark.parametrize("route", ["dense", "bvh", "two_level"])
def test_falsecolor_matches_jax(routes, route, fc):
    """pathtrace_scene_falsecolor, 16x12, 2 spp, accumulated onto a
    previous frame (accumulation counter 1)."""

    tpu, ts, jd, td, share = routes[route]
    baked = dict(max_bounces=2, samples_per_pixel=2)
    prev = np.random.default_rng(2).uniform(0, 1, (12, 16, 3)).astype(np.float32)
    for d in (jd, td):
        d.accum_params.counter = 1
        d.accum_params.accumulate = True
    img = trenderer.pathtrace_scene_falsecolor(
        ts, torch.from_numpy(prev), td, tl.BakedPathtraceParams(**baked), fc)
    jimg = np.asarray(jrenderer.pathtrace_scene_falsecolor(
        tpu, jnp.asarray(prev), jd, jl.BakedPathtraceParams(**baked), fc))
    img = img.numpy()
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert not np.array_equal(img, prev)
    close = np.isclose(img, jimg, rtol=0, atol=1e-5).all(axis=-1)
    assert close.mean() >= share, (route, fc.name, close.mean())


def test_hash_color_bit_for_bit():
    """The three PCG words to f32 (one rounding to nearest) over
    4294967295.0, bit for bit, on ids across the whole u32 range."""

    ids = np.random.default_rng(0).integers(0, 2**32, 20000, dtype=np.uint64)
    ids[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    got = trenderer._hash_color(torch.from_numpy(ids.astype(np.int64)))
    ref = jrenderer._hash_color(jnp.asarray(ids.astype(np.uint32)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))


def test_heatmap_color_across_band_edges():
    """get_heatmap_color on values whose wavelengths sit on, and one f32
    step either side of, every band edge (jnp.select's first true case
    wins), below the range and above it."""

    lo, hi = 2.0, 39.0
    edges = np.array([380, 420, 440, 490, 510, 580, 645, 701, 780, 781], np.float32)
    vals = lo + (edges - 380.0) / 370.0 * (hi - lo)
    vals = np.concatenate([vals, np.nextafter(vals, np.float32(-1e9)),
                           np.nextafter(vals, np.float32(1e9)),
                           np.linspace(lo - 3, hi + 3, 2001, dtype=np.float32),
                           [lo, hi, 0.0, 1e6]]).astype(np.float32)
    got = trenderer.get_heatmap_color(torch.from_numpy(vals), lo, hi).numpy()
    ref = np.asarray(jrenderer.get_heatmap_color(jnp.asarray(vals),
                                                 jnp.float32(lo), jnp.float32(hi)))
    assert got.shape == (vals.shape[0], 3) and (got >= 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert np.array_equal(got == 0.0, ref == 0.0)


def _rays(W, H, jdesc, tdesc):
    """Both packages' jittered camera rays of a WxH frame (sample 0)."""

    from lupinpathtracer_tpu.render import integrators as jintg
    from lupinpathtracer_tpu_torch.render import integrators as tintg

    gx = np.tile(np.arange(W, dtype=np.int32), H)
    gy = np.repeat(np.arange(H, dtype=np.int32), W)
    pix = gy * W + gx
    _, jro, jrd = jintg._camera_ray_from(
        dict(cam=jrenderer._camera_args(jdesc), is_ortho=False,
             gx=jnp.asarray(gx), gy=jnp.asarray(gy),
             resolution=(jnp.float32(W), jnp.float32(H))),
        jrng.init_state(jnp.asarray(pix.astype(np.uint32)), 0, 0, 0))
    _, tro, trd = tintg._camera_ray_from(
        dict(cam=trenderer._camera_args(tdesc), is_ortho=False,
             gx=torch.from_numpy(gx), gy=torch.from_numpy(gy),
             resolution=(W, H)),
        trng.init_state(torch.from_numpy(pix), 0, 0, 0))
    return (jro, jrd), (tro, trd)


def _counts_match(got, ref, share=0.99):
    for g, r in zip(got, ref):
        same = g.numpy() == np.asarray(r)
        assert same.mean() >= share, same.mean()
    assert int(got[0].sum()) > 0


def test_count_traversal_single_level_matches_jax(monkeypatch):
    """The 2048-triangle terrain's camera rays: the port's count_traversal
    (the wavefront's counts, B5's slab tests and B6's triangles) against
    the JAX wavefront's with_counts in interpret mode, and the port's stack
    walk counts against the JAX count_traversal (its stack walk on the
    CPU)."""

    monkeypatch.setenv("LUPIN_SKIP_PROBE", "1")
    js, jc = jsyn.build_scene_terrain(n_tris=2048)
    tsc, tc = tsyn.build_scene_terrain(n_tris=2048)
    tpu, ts = build_scene_tpu(js), tl.build_scene_torch(tsc, device="cpu")
    assert ts.use_bvh and not ts.two_level and ts.sl_count > 1
    jd, td = tl.PathtraceDesc(), tl.PathtraceDesc()
    for d in (jd, td):
        d.camera_transform = tc[0].transform
        d.camera_params = tc[0].params
    (jro, jrd), (tro, trd) = _rays(24, 16, jd, td)
    _, jcnt = jint.closest_hit_wavefront(tpu, jro, jrd, jnp.float32(EPS),
                                         with_counts=True)
    cnt = tint.count_traversal(ts, tro, trd, EPS)
    _counts_match(cnt, jcnt)
    hw, wcnt = tint.closest_hit_wavefront(ts, tro, trd, EPS, with_counts=True)
    assert all(torch.equal(a, b) for a, b in zip(wcnt, cnt))
    assert bool(hw.hit.any())
    _, bcnt = tint.closest_hit_bvh(ts, tro, trd, EPS, with_counts=True)
    _counts_match(bcnt, jint.count_traversal(tpu, jro, jrd, jnp.float32(EPS)))


def test_count_traversal_two_level_dense_and_leaf_match_jax(routes):
    """count_traversal on the five-instance field (the wavefront, with the
    straggler compaction: a batch above WF_TAIL_C lanes) and the dense
    Cornell box (every triangle, no AABB test) against the JAX
    count_traversal; the box on the BVH route (the single-superleaf
    shortcut: its stride of triangles) against the JAX wavefront's counts
    (the JAX count_traversal takes its stack walk there on the CPU)."""

    for route, W, H in (("two_level", 64, 40), ("dense", 12, 12), ("bvh", 12, 12)):
        tpu, ts, jd, td, _ = routes[route]
        ts = trenderer._select_backend(ts, td)
        tpu = jrenderer._select_backend(tpu, jd)
        (jro, jrd), (tro, trd) = _rays(W, H, jd, td)
        got = tint.count_traversal(ts, tro, trd, EPS)
        if route == "bvh":
            _, ref = jint.closest_hit_wavefront(tpu, jro, jrd, jnp.float32(EPS),
                                                with_counts=True)
        else:
            ref = jint.count_traversal(tpu, jro, jrd, jnp.float32(EPS))
        _counts_match(got, ref)
        if route == "dense":
            assert (got[0] == ts.num_world_tris).all() and (got[1] == 0).all()
        if route == "bvh":
            assert ts.top_root_is_leaf and (got[0] == ts.sl_stride).all()


@pytest.mark.parametrize("mode", ["tri_checks", "aabb_checks", "bounces"])
@pytest.mark.parametrize("route", ["dense", "two_level"])
def test_debug_dispatch_matches_jax(routes, route, mode):
    """pathtrace_scene_debug, 16x12, on the routes where the JAX package's
    CPU counts take the same route as the port's (dense: all triangles;
    two-level: the wavefront), accumulated onto a previous frame."""

    tpu, ts, jd, td, _ = routes[route]
    baked = dict(max_bounces=3, samples_per_pixel=1)
    prev = np.random.default_rng(3).uniform(0, 1, (12, 16, 3)).astype(np.float32)
    for d in (jd, td):
        d.accum_params.counter = 2
        d.accum_params.accumulate = True
    hi = 40.0 if mode != "bounces" else 4.0
    img = trenderer.pathtrace_scene_debug(
        ts, torch.from_numpy(prev), td, tl.BakedPathtraceParams(**baked), mode,
        heatmap_min=0.0, heatmap_max=hi).numpy()
    jimg = np.asarray(jrenderer.pathtrace_scene_debug(
        tpu, jnp.asarray(prev), jd, jl.BakedPathtraceParams(**baked), mode=mode,
        heatmap_min=0.0, heatmap_max=hi))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    close = np.isclose(img, jimg, rtol=1e-5, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99


def test_debug_bounces_is_the_path_loop_heatmap():
    """The "bounces" heatmap is get_heatmap_color of the non-regenerating
    STANDARD loop's n_bounces on the dispatch's camera rays, exactly, and
    its pixels hold several colours (paths of 0 to 7 bounces)."""

    from lupinpathtracer_tpu_torch.render import integrators as tintg

    ts = tl.build_scene_torch(tbuiltin.build_scene_cornell_box()[0], device="cpu")
    desc = _desc(tl, PT.STANDARD)
    img = tl.pathtrace_scene_debug(
        ts, tl.new_accumulation_buffer(12, 12, device="cpu"), desc,
        tl.BakedPathtraceParams(max_bounces=6), mode="bounces",
        heatmap_min=0.0, heatmap_max=7.0)
    gx = torch.arange(12).repeat(12)
    gy = torch.arange(12).repeat_interleave(12)
    state, ro, rd = tintg._camera_ray_from(
        dict(cam=trenderer._camera_args(desc), is_ortho=False, gx=gx, gy=gy,
             resolution=(12, 12)), trng.init_state(gy * 12 + gx, 0, 0, 0))
    _, _, n_bounces, _ = tintg.pathtrace(ts, tintg.make_ctx(ts, EPS), ro, rd,
                                         state, int(PT.STANDARD), 6)
    want = trenderer.get_heatmap_color(n_bounces.float(), 0.0, 7.0)
    assert torch.equal(img[gy, gx], want)
    assert torch.unique(n_bounces).numel() > 3


@pytest.mark.parametrize("guides", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("iterations", [1, 2, 3, 4, 5])
def test_denoise_matches_jax(iterations, guides):
    rng = np.random.default_rng(iterations)
    color = rng.gamma(2.0, 0.4, (20, 28, 3)).astype(np.float32)
    kw = {}
    if guides:
        kw = dict(albedo=rng.uniform(0, 1, (20, 28, 3)).astype(np.float32),
                  normal=rng.normal(size=(20, 28, 3)).astype(np.float32))
    got = tl.denoise(torch.from_numpy(color),
                     **{k: torch.from_numpy(v) for k, v in kw.items()},
                     iterations=iterations, sigma_color=0.5)
    ref = jatrous.denoise(jnp.asarray(color),
                          **{k: jnp.asarray(v) for k, v in kw.items()},
                          iterations=iterations, sigma_color=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_denoise_reduces_noise():
    """tests/test_render.py::test_denoise_reduces_noise on the port, with
    the DenoiseDesc defaults."""

    rng = np.random.default_rng(0)
    clean = np.zeros((32, 32, 3), np.float32)
    clean[8:24, 8:24] = 1.0
    noisy = clean + rng.normal(0, 0.3, clean.shape).astype(np.float32)
    d = tl.DenoiseDesc(iterations=3)
    out = tl.denoise(torch.from_numpy(noisy), iterations=d.iterations,
                     sigma_color=d.sigma_color).numpy()
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean() * 0.6
