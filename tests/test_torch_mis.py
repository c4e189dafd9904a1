"""PyTorch port, the MIS integrator and sample streams on the CPU, against
the JAX package on the same scenes and seeds: integrators.pathtrace_spp
under MIS on the Cornell variants of tests/test_torch_render.py, MIS on a
small terrain and a two-level field, the pinned 32x32 MIS golden, the
power-2 heuristic, path regeneration against the sequential per-sample
loop (integrators.pathtrace), and LUPIN_SPP_STREAMS-style sample streams.

Tolerances: on the Cornell variants, n_traced equal exactly and acc at
rtol 2e-4 / atol 2e-5 (tests/test_torch_render.py); the see-through
variants by its 99% statistic; BVH renders by tests/test_torch_bvh_render.py's
(>= 99% of pixels within 2e-3, mean within 1%, n_traced equal on >= 99%
of lanes); the golden at atol 2e-3 (tests/test_golden_regression.py);
regeneration and streams as tests/test_render.py holds the JAX package:
the sum of n_traced equal exactly, acc at rtol 3e-6 / atol 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.io import builtin as jbuiltin
from lupinpathtracer_tpu.io import synthetic as jsyn
from lupinpathtracer_tpu.render import bsdf as jbsdf
from lupinpathtracer_tpu.render import integrators as jint
from lupinpathtracer_tpu.render import renderer as jrenderer
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core import rng as trng
from lupinpathtracer_tpu_torch.io import builtin as tbuiltin
from lupinpathtracer_tpu_torch.io import synthetic as tsyn
from lupinpathtracer_tpu_torch.render import bsdf as tbsdf
from lupinpathtracer_tpu_torch.render import integrators as tint
from lupinpathtracer_tpu_torch.render import renderer as trenderer

from test_torch_render import (
    _both_pathtrace_spp, _desc, _grid, cornell, cornell_alpha, cornell_env,
    cornell_refractive)
from test_torch_scene import cornell_glossy
from test_torch_two_level import _cam_desc, instanced_scene

PT = tl.PathtraceType
GOLDEN_MIS = os.path.join(os.path.dirname(__file__), "goldens",
                          "cornell_32_mis.npy")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Runs each test on one PyTorch thread: the suite runs in several
    worker processes at once, and PyTorch's intra-op thread pools in all of
    them oversubscribe the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("build", [cornell, cornell_glossy, cornell_env],
                         ids=lambda b: b.__name__)
def test_mis_pathtrace_spp_matches_jax(build):
    (jacc, jnt), (tacc, tnt) = _both_pathtrace_spp(
        build, PT.MIS, 16, 16, 2, 4, 3, 0, 10.0)
    np.testing.assert_array_equal(tnt.numpy(), np.asarray(jnt))
    for a, b in zip(tacc, jacc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    assert float(sum(a.sum() for a in tacc)) > 0


def _see_through_ok(tacc, tnt, jacc, jnt):
    same = tnt.numpy() == np.asarray(jnt)
    ok = same.copy()
    for a, b in zip(tacc, jacc):
        ok &= np.isclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    assert same.mean() >= 0.99 and ok.mean() >= 0.99
    tm = float(sum(a.mean() for a in tacc))
    jm = float(sum(np.asarray(b).mean() for b in jacc))
    assert tm > 0 and abs(tm - jm) <= 0.01 * jm


def test_mis_see_through_refractive_statistics():
    """The refractive box (the coplanar tie of
    test_torch_render.test_pathtrace_spp_see_through_statistics) under MIS:
    >= 99% of lanes equal, image mean within 1%."""

    (jacc, jnt), (tacc, tnt) = _both_pathtrace_spp(
        cornell_refractive, PT.MIS, 16, 16, 2, 4, 3, 0, 10.0)
    _see_through_ok(tacc, tnt, jacc, jnt)


def test_mis_see_through_alpha_statistics():
    """The half-transparent box under MIS, one sample at a time through
    the non-regenerating loop (integrators.pathtrace): >= 99% of lanes
    equal, image mean within 1%. Not through pathtrace_spp: the alpha
    skip's re-cast loop runs while any lane of the batch re-casts, and each
    round draws a number on every lane, so a lane that meets the
    floor/box tie differently changes the draws of every lane of its batch
    (in both packages alike); the regenerating wavefront keeps one batch
    for all samples."""

    from lupinpathtracer_tpu.core import rng as jrng

    W = H = 16
    tpu = build_scene_tpu(cornell_alpha(jl, jbuiltin))
    ts = tl.build_scene_torch(cornell_alpha(tl, tbuiltin), device="cpu")
    gx, gy, pix = _grid(W, H)
    jctx = jint.make_ctx(tpu, jnp.float32(1e-3))
    tctx = tint.make_ctx(ts, float(np.float32(1e-3)))
    jreg = dict(cam=jrenderer._camera_args(_desc(jl, PT.MIS)), is_ortho=False,
                gx=jnp.asarray(gx), gy=jnp.asarray(gy),
                resolution=(jnp.float32(W), jnp.float32(H)))
    treg = dict(cam=trenderer._camera_args(_desc(tl, PT.MIS)), is_ortho=False,
                gx=torch.from_numpy(gx), gy=torch.from_numpy(gy),
                resolution=(W, H))
    runs = []
    for s in range(2):
        state, ro, rd = jint._camera_ray_from(
            jreg, jrng.init_state(jnp.asarray(pix.astype(np.uint32)), 3, 0, s))
        jrad, _, _, jnt = jint.pathtrace(tpu, jctx, ro, rd, state, int(PT.MIS), 4)
        state, ro, rd = tint._camera_ray_from(
            treg, trng.init_state(torch.from_numpy(pix), 3, 0, s))
        trad, _, _, tnt = tint.pathtrace(ts, tctx, ro, rd, state, int(PT.MIS), 4)
        runs.append((trad, tnt, jrad, jnt))
    _see_through_ok(
        [torch.cat([r[0][k] for r in runs]) for k in range(3)],
        torch.cat([r[1] for r in runs]),
        [np.concatenate([np.asarray(r[2][k]) for r in runs]) for k in range(3)],
        np.concatenate([np.asarray(r[3]) for r in runs]))


def _terrain_desc(pkg, cams, ptype):
    desc = pkg.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.pathtrace_type = ptype
    desc.advanced.max_radiance = 10.0
    return desc


def _render_both(tpu, ts, jdesc, tdesc, W, H, spp, bounces):
    baked = dict(max_bounces=bounces, samples_per_pixel=spp)
    img = tl.render_progressive(ts, tdesc, tl.BakedPathtraceParams(**baked),
                                W, H, 1, device="cpu")
    jimg = np.asarray(jrenderer.render_progressive(
        tpu, jdesc, jl.BakedPathtraceParams(**baked), W, H, 1))
    assert img.shape == (H, W, 3) and np.isfinite(img).all() and img.mean() > 0
    assert (np.abs(img - jimg) <= 2e-3).mean() >= 0.99
    assert abs(img.mean() - jimg.mean()) <= 0.01 * jimg.mean()


def test_mis_bvh_terrain_matches_jax():
    """MIS on the 2048-triangle terrain (B4 on the camera prologue; B5, B6
    and B7 on the three-slot bounce batches), 32x18, 2 spp, 4 bounces:
    the image against the JAX render, and pathtrace_spp's n_traced lane by
    lane."""

    js, jc = jsyn.build_scene_terrain(n_tris=2048)
    tsc, tc = tsyn.build_scene_terrain(n_tris=2048)
    tpu = build_scene_tpu(js)
    ts = tl.build_scene_torch(tsc, device="cpu")
    assert ts.use_bvh and not ts.two_level
    _render_both(tpu, ts, _terrain_desc(jl, jc, PT.MIS),
                 _terrain_desc(tl, tc, PT.MIS), 32, 18, 2, 4)
    W, H = 32, 18
    gx, gy, pix = _grid(W, H)
    _, jnt = jint.pathtrace_spp(
        tpu, jint.make_ctx(tpu, jnp.float32(1e-3)),
        jnp.asarray(pix.astype(np.uint32)), jnp.asarray(gx), jnp.asarray(gy),
        (jnp.float32(W), jnp.float32(H)),
        jrenderer._camera_args(_terrain_desc(jl, jc, PT.MIS)), False,
        jnp.uint32(1), jnp.uint32(0), 2, int(PT.MIS), 4, jnp.float32(10.0))
    _, tnt = tint.pathtrace_spp(
        ts, tint.make_ctx(ts, float(np.float32(1e-3))), torch.from_numpy(pix),
        torch.from_numpy(gx), torch.from_numpy(gy), (W, H),
        trenderer._camera_args(_terrain_desc(tl, tc, PT.MIS)), False, 1, 0, 2,
        int(PT.MIS), 4, 10.0)
    assert (tnt.numpy() == np.asarray(jnt)).mean() >= 0.99


def test_mis_two_level_matches_jax(monkeypatch):
    """MIS on the five-instance field of tests/test_torch_two_level.py
    (B4 camera rays, B5/B6/B7 with the instance word) at the size of its
    STANDARD render there, 32x24, 2 spp, 3 bounces, against the JAX
    render."""

    monkeypatch.setenv("LUPIN_SKIP_PROBE", "1")
    tpu = build_scene_tpu(instanced_scene(jl), dense_max_tris=64, two_level=True)
    ts = tl.build_scene_torch(instanced_scene(tl), device="cpu",
                              dense_max_tris=64, two_level=True)
    jdesc, tdesc = _cam_desc(jl), _cam_desc(tl)
    jdesc.pathtrace_type = tdesc.pathtrace_type = PT.MIS
    _render_both(tpu, ts, jdesc, tdesc, 32, 24, 2, 3)


def test_mis_golden_and_jax_render():
    """The pinned 32x32 MIS golden (8 spp x 8 accumulations, 8 bounces,
    max_radiance 10) and the JAX render of the same."""

    golden = np.load(GOLDEN_MIS)
    baked = dict(max_bounces=8, samples_per_pixel=8)
    ts = tl.build_scene_torch(cornell(tl, tbuiltin), device="cpu")
    img = tl.render_progressive(ts, _desc(tl, PT.MIS),
                                tl.BakedPathtraceParams(**baked), 32, 32, 8,
                                device="cpu")
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, golden, atol=2e-3)
    jimg = jrenderer.render_progressive(
        build_scene_tpu(cornell(jl, jbuiltin)), _desc(jl, PT.MIS),
        jl.BakedPathtraceParams(**baked), 32, 32, 8)
    np.testing.assert_allclose(img, np.asarray(jimg), atol=2e-3)


def test_mis_heuristic_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 4, 4096).astype(np.float32)
    b = rng.uniform(0, 4, 4096).astype(np.float32)
    a[:8] = 0.0
    b[4:12] = 0.0
    got = tbsdf.mis_heuristic(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jbsdf.mis_heuristic(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def _cornell_batch(W, H, ptype):
    ts = tl.build_scene_torch(cornell(tl, tbuiltin), device="cpu")
    gx, gy, pix = (torch.from_numpy(x) for x in _grid(W, H))
    ctx = tint.make_ctx(ts, float(np.float32(1e-3)))
    return ts, ctx, gx, gy, pix, trenderer._camera_args(_desc(tl, ptype))


@pytest.mark.parametrize("ptype", [PT.STANDARD, PT.MIS], ids=lambda p: p.name)
def test_regen_matches_sequential_spp(ptype):
    """pathtrace_spp (regeneration) against spp calls of the
    non-regenerating loop (integrators.pathtrace), each sample from
    init_state(pixel, 0, 0, s): the same RNG streams drive the same
    decisions, so the traced segments are equal exactly."""

    W = H = 12
    SPP, BOUNCES, MAXRAD = 3, 4, 10.0
    ts, ctx, gx, gy, pix, cam = _cornell_batch(W, H, ptype)
    regen = dict(cam=cam, is_ortho=False, gx=gx, gy=gy, resolution=(W, H))
    acc_seq = [torch.zeros(W * H) for _ in range(3)]
    nt_seq = 0
    for s in range(SPP):
        state, ro, rd = tint._camera_ray_from(
            regen, trng.init_state(pix, 0, 0, s))
        radiance, _, n_bounces, nt = tint.pathtrace(
            ts, ctx, ro, rd, state, int(ptype), BOUNCES)
        assert int(n_bounces.max()) <= BOUNCES + 1
        clamped = tint.clamp_radiance(radiance, MAXRAD)
        acc_seq = [a + c for a, c in zip(acc_seq, clamped)]
        nt_seq += int(nt.sum())
    acc, n_traced = tint.pathtrace_spp(ts, ctx, pix, gx, gy, (W, H), cam, False,
                                       0, 0, SPP, int(ptype), BOUNCES, MAXRAD)
    assert int(n_traced.sum()) == nt_seq
    for a, b in zip(acc, acc_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-6, atol=1e-6)


@pytest.mark.parametrize("ptype", [PT.STANDARD, PT.MIS], ids=lambda p: p.name)
def test_spp_streams_match_one_stream_and_jax(ptype):
    """streams K = 2 and 4 (the lanes tiled K times, stream k from sample
    k*spp/K): the sum of n_traced equal to K = 1's exactly and acc within
    rtol 3e-6 / atol 1e-6 of it (only the float sums' order differs); and
    the same K through the JAX package, n_traced equal lane by lane and
    acc at rtol 2e-4 / atol 2e-5 on >= 99% of lanes: under MIS, one lane
    of the 144 (at K = 1 too) sends its light ray from a grazing hit and
    meets a triangle at a t just above the epsilon in the port and just
    below it in the JAX package (7e-5 of radiance)."""

    W = H = 12
    SPP, BOUNCES, MAXRAD = 4, 4, 10.0
    ts, ctx, gx, gy, pix, cam = _cornell_batch(W, H, ptype)
    tpu = build_scene_tpu(cornell(jl, jbuiltin))
    jctx = jint.make_ctx(tpu, jnp.float32(1e-3))
    jcam = jrenderer._camera_args(_desc(jl, ptype))

    def run(K):
        return tint.pathtrace_spp(ts, ctx, pix, gx, gy, (W, H), cam, False, 0,
                                  0, SPP, int(ptype), BOUNCES, MAXRAD, streams=K)

    acc1, nt1 = run(1)
    for K in (2, 4):
        accK, ntK = run(K)
        assert int(ntK.sum()) == int(nt1.sum())
        for a, b in zip(accK, acc1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-6, atol=1e-6)
        jacc, jnt = jint.pathtrace_spp(
            tpu, jctx, jnp.asarray(pix.numpy().astype(np.uint32)),
            jnp.asarray(gx.numpy()), jnp.asarray(gy.numpy()),
            (jnp.float32(W), jnp.float32(H)), jcam, False, jnp.uint32(0),
            jnp.uint32(0), SPP, int(ptype), BOUNCES, jnp.float32(MAXRAD),
            streams=K)
        np.testing.assert_array_equal(ntK.numpy(), np.asarray(jnt))
        ok = np.ones(W * H, bool)
        for a, b in zip(accK, jacc):
            ok &= np.isclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
        assert ok.mean() >= 0.99


def test_spp_streams_env_in_dispatch(monkeypatch):
    """pathtrace_scene reads LUPIN_SPP_STREAMS on the wavefront route (here
    MIS): 2 gives K = 1's image to rtol 3e-6 / atol 1e-6; 3, which does
    not divide spp, and 0 mean 1 (the same image exactly)."""

    ts = tl.build_scene_torch(cornell(tl, tbuiltin), device="cpu")
    baked = tl.BakedPathtraceParams(max_bounces=3, samples_per_pixel=4)

    def render():
        return trenderer.pathtrace_scene(
            ts, tl.new_accumulation_buffer(16, 16, device="cpu"),
            _desc(tl, PT.MIS), baked)

    monkeypatch.delenv("LUPIN_SPP_STREAMS", raising=False)
    base = render()
    for k in ("3", "0"):
        monkeypatch.setenv("LUPIN_SPP_STREAMS", k)
        assert torch.equal(render(), base)
    monkeypatch.setenv("LUPIN_SPP_STREAMS", "2")
    np.testing.assert_allclose(render().numpy(), base.numpy(), rtol=3e-6, atol=1e-6)
