"""PyTorch port, the slice end to end on the CPU: pathtrace_spp (the
wavefront loop that is also kernel B3's plain version) against the JAX
package's integrators.pathtrace_spp, and render_progressive against the
pinned 32x32 Cornell golden and the JAX render; plus the entry points'
device rule, and the paths that once raised (MIS, AOVs, heatmaps).

Tolerances: n_traced equal exactly; acc at rtol 2e-4 / atol 2e-5, the
tolerance tests/test_mega.py holds the Pallas megakernel to; the golden at
atol 2e-3, the tolerance of tests/test_golden_regression.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.io import builtin as jbuiltin
from lupinpathtracer_tpu.render import integrators as jint
from lupinpathtracer_tpu.render import renderer as jrenderer
from lupinpathtracer_tpu.render import tonemap as jtonemap
from lupinpathtracer_tpu.render.renderer import _camera_args as j_camera_args
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.io import builtin as tbuiltin
from lupinpathtracer_tpu_torch.kernels import mega
from lupinpathtracer_tpu_torch.render import integrators as tint
from lupinpathtracer_tpu_torch.render import renderer as trenderer

from test_torch_scene import cornell_glossy, grid_field

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cornell_32_standard.npy")
PT = tl.PathtraceType


def cornell(pkg, builtin):
    return builtin.build_scene_cornell_box()[0]


def cornell_refractive(pkg, builtin):
    """A smooth refractive tall box (delta lobes, the volume slot)."""

    scene, _ = builtin.build_scene_cornell_box()
    m = scene.add_material(pkg.Material(
        color=np.array([0.9, 0.8, 0.7, 1.0], np.float32),
        mat_type=pkg.MaterialType.REFRACTIVE, roughness=0.0, ior=1.5,
        tr_depth=0.5))
    scene.instances[6].mat_idx = m
    return scene


def _desc(pkg, ptype, max_radiance=10.0):
    cam = jbuiltin.build_scene_cornell_box()[1][0]
    desc = pkg.PathtraceDesc()
    desc.camera_transform = cam.transform
    desc.camera_params = cam.params
    desc.pathtrace_type = ptype
    desc.advanced.max_radiance = max_radiance
    return desc


def _grid(W, H):
    gx = np.tile(np.arange(W, dtype=np.int32), H)
    gy = np.repeat(np.arange(H, dtype=np.int32), W)
    return gx, gy, (gy * W + gx).astype(np.int32)


def cornell_env(pkg, builtin):
    """An environment light seen through the open front (outside the
    megakernel gate: the wavefront route)."""

    scene, _ = builtin.build_scene_cornell_box()
    scene.environments.append(pkg.Environment(
        emission=np.array([0.3, 0.4, 0.5], np.float32)))
    return scene


def cornell_alpha(pkg, builtin):
    """A half-transparent tall box: the stochastic alpha-skip loop."""

    scene, _ = builtin.build_scene_cornell_box()
    scene.instances[6].mat_idx = scene.add_material(pkg.Material(
        color=np.array([0.7, 0.7, 0.9, 0.5], np.float32)))
    return scene


CASES = [
    (cornell, PT.STANDARD), (cornell, PT.NAIVE), (cornell, PT.DIRECT),
    (cornell_glossy, PT.STANDARD), (cornell_env, PT.STANDARD),
]


def _both_pathtrace_spp(build, ptype, W, H, SPP, BOUNCES, ACCUM, SEED, MAXR):
    tpu = build_scene_tpu(build(jl, jbuiltin))
    ts = tl.build_scene_torch(build(tl, tbuiltin), device="cpu")
    gx, gy, pix = _grid(W, H)
    jcam = j_camera_args(_desc(jl, ptype))
    jctx = jint.make_ctx(tpu, jnp.float32(1e-3))
    jacc, jnt = jint.pathtrace_spp(
        tpu, jctx, jnp.asarray(pix.astype(np.uint32)), jnp.asarray(gx),
        jnp.asarray(gy), (jnp.float32(W), jnp.float32(H)), jcam, False,
        jnp.uint32(ACCUM), jnp.uint32(SEED), SPP, int(ptype), BOUNCES,
        jnp.float32(MAXR))
    tcam = trenderer._camera_args(_desc(tl, ptype))
    tctx = tint.make_ctx(ts, float(np.float32(1e-3)))
    tacc, tnt = tint.pathtrace_spp(
        ts, tctx, torch.from_numpy(pix), torch.from_numpy(gx),
        torch.from_numpy(gy), (W, H), tcam, False, ACCUM, SEED, SPP,
        int(ptype), BOUNCES, MAXR)
    return (jacc, jnt), (tacc, tnt)


@pytest.mark.parametrize("build", [cornell_refractive, cornell_alpha],
                         ids=lambda b: b.__name__)
def test_pathtrace_spp_see_through_statistics(build):
    """Rays that enter or pass through the tall box (refraction with delta
    lobes and the volume slot; the stochastic alpha skip) reach its bottom
    face, which is coplanar with the floor: the two tie at exactly equal t,
    and a last-ulp difference between XLA and PyTorch picks the other face
    (about one lane in 256). Held per lane on >= 99% of lanes, and on the
    image mean to 1%."""

    (jacc, jnt), (tacc, tnt) = _both_pathtrace_spp(
        build, PT.STANDARD, 16, 16, 2, 4, 3, 0, 10.0)
    same = tnt.numpy() == np.asarray(jnt)
    ok = same.copy()
    for a, b in zip(tacc, jacc):
        ok &= np.isclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    assert same.mean() >= 0.99 and ok.mean() >= 0.99
    tm = float(sum(a.mean() for a in tacc))
    jm = float(sum(np.asarray(b).mean() for b in jacc))
    assert tm > 0 and abs(tm - jm) <= 0.01 * jm


@pytest.mark.parametrize("build,ptype", CASES,
                         ids=lambda x: getattr(x, "__name__", None) or x.name)
def test_pathtrace_spp_matches_jax(build, ptype):
    W = H = 16
    SPP, BOUNCES, ACCUM, SEED, MAXR = 2, 4, 3, 0, 10.0
    (jacc, jnt), (tacc, tnt) = _both_pathtrace_spp(
        build, ptype, W, H, SPP, BOUNCES, ACCUM, SEED, MAXR)
    np.testing.assert_array_equal(tnt.numpy(), np.asarray(jnt))
    for a, b in zip(tacc, jacc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    assert float(sum(a.sum() for a in tacc)) > 0
    ts = tl.build_scene_torch(build(tl, tbuiltin), device="cpu")
    if mega.applicable(ts, ptype):
        # On the CPU, kernel B3's wrapper runs its plain version: this loop.
        gx, gy, pix = (torch.from_numpy(a) for a in _grid(W, H))
        macc, mnt = mega.mega_pathtrace_spp(
            ts, tint.make_ctx(ts, 1e-3)["W"], pix, gx, gy, (W, H),
            trenderer._camera_args(_desc(tl, ptype)), False, ACCUM, SEED, SPP,
            int(ptype), BOUNCES, MAXR, float(np.float32(1e-3)))
        assert torch.equal(mnt, tnt)
        assert all(torch.equal(a, b) for a, b in zip(macc, tacc))


def test_golden_and_jax_render():
    golden = np.load(GOLDEN)
    baked = dict(max_bounces=8, samples_per_pixel=8)
    scene_t = tl.build_scene_torch(cornell(tl, tbuiltin), device="cpu")
    img = tl.render_progressive(scene_t, _desc(tl, PT.STANDARD),
                                tl.BakedPathtraceParams(**baked), 32, 32, 8,
                                device="cpu")
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, golden, atol=2e-3)
    jimg = jrenderer.render_progressive(
        build_scene_tpu(cornell(jl, jbuiltin)), _desc(jl, PT.STANDARD),
        jl.BakedPathtraceParams(**baked), 32, 32, 8)
    np.testing.assert_allclose(img, jimg, atol=2e-3)


def test_tiled_render_equals_full_frame():
    """Per-pixel RNG streams key on the absolute pixel id, so tiles (here
    16x16 and ragged 24x24) reproduce the full-frame image exactly."""

    scene = tl.build_scene_torch(cornell(tl, tbuiltin), device="cpu")
    baked = tl.BakedPathtraceParams(max_bounces=3, samples_per_pixel=2)
    full = trenderer.pathtrace_scene(
        scene, tl.new_accumulation_buffer(40, 32, device="cpu"),
        _desc(tl, PT.STANDARD), baked)
    for ts in (16, 24):
        img = tl.new_accumulation_buffer(40, 32, device="cpu")
        nx, ny = tl.get_num_tiles(40, 32, ts)
        for k in range(nx * ny):
            desc = _desc(tl, PT.STANDARD)
            desc.tile_params = tl.TileParams(enabled=True, tile_idx=k, tile_size=ts)
            img = trenderer.pathtrace_scene(scene, img, desc, baked)
        assert torch.equal(img, full)


def test_tonemap_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 3, (12, 20, 3)).astype(np.float32)
    for exposure, filmic in ((0.0, False), (0.7, True)):
        j = jtonemap.tonemap(jnp.asarray(img), exposure, filmic, True)
        t = tl.tonemap(torch.from_numpy(img), exposure, filmic, True)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
        j = jtonemap.tonemap_and_fit_aspect(jnp.asarray(img), exposure, 16, 16,
                                            filmic, True)
        t = tl.tonemap_and_fit_aspect(torch.from_numpy(img), exposure, 16, 16,
                                      filmic, True)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_hdr_output_matches_jax_writer(tmp_path):
    """The port saves renders with its copy of io/hdr.py: byte-identical
    files to the JAX package's writer, and an RGBE round trip within the
    format's 8-bit mantissa (shared by a pixel's three channels)."""

    from lupinpathtracer_tpu.io import hdr as jhdr
    from lupinpathtracer_tpu_torch.io import hdr as thdr

    img = np.random.default_rng(4).uniform(0, 5, (9, 13, 3)).astype(np.float32)
    thdr.write_hdr(tmp_path / "t.hdr", img)
    jhdr.write_hdr(tmp_path / "j.hdr", img)
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    back = thdr.read_hdr(tmp_path / "t.hdr")
    step = img.max(axis=-1, keepdims=True) / 128.0
    assert (np.abs(back[..., :3] - img) <= step).all()


def test_entry_points_default_to_cuda(monkeypatch):
    """Called without device="cpu" on a host with no GPU, the entry points
    raise instead of moving to the CPU."""

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene_cpu = cornell(tl, tbuiltin)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tl.build_scene_torch(scene_cpu)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tl.new_accumulation_buffer(8, 8)
    scene = tl.build_scene_torch(scene_cpu, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tl.render_progressive(scene, _desc(tl, PT.STANDARD),
                              tl.BakedPathtraceParams(), 8, 8, 1)


def test_uncovered_paths_raise():
    """The paths that raised NotImplementedError until the whole render API
    was ported (the name is kept from then) render, finite, on a dense and
    a two-level scene: MIS, every falsecolor AOV and the three debug
    heatmaps (tests/test_torch_mis.py and tests/test_torch_aov.py hold them
    to the JAX package)."""

    scene = tl.build_scene_torch(cornell(tl, tbuiltin), device="cpu")
    big = tl.build_scene_torch(grid_field(tl, tbuiltin), device="cpu")
    assert big.use_bvh and big.two_level
    baked = tl.BakedPathtraceParams(max_bounces=2, samples_per_pixel=1)
    for sc in (scene, big):
        img = tl.new_accumulation_buffer(8, 8, device="cpu")
        out = tl.pathtrace_scene(sc, img, _desc(tl, PT.MIS), baked)
        assert torch.isfinite(out).all() and float(out.mean()) > 0
        for fc in tl.FalsecolorType:
            out = tl.pathtrace_scene_falsecolor(sc, img, _desc(tl, PT.STANDARD),
                                                baked, fc)
            assert torch.isfinite(out).all()
        for mode in trenderer.DEBUG_MODES:
            out = tl.pathtrace_scene_debug(sc, img, _desc(tl, PT.STANDARD),
                                           baked, mode)
            assert torch.isfinite(out).all()
            # The dense box tests no box: its aabb_checks heatmap is black.
            assert (float(out.max()) > 0) == (mode != "aabb_checks" or sc is big)
