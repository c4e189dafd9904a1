"""PyTorch port, multi-device rendering on the CPU: parallel/sharding.py on
meshes of CPU entries against the port's single-device render_progressive
and against the JAX package's render_progressive_sharded on its virtual
8-device CPU mesh (tests/conftest.py), and apps/scaling_study.py with
--cpu-mesh.

Tolerances: tiles mode equals the single-device render bit for bit (the
per-pixel RNG streams are keyed by the absolute pixel); against the JAX
package within 1e-5 absolute, the tolerance of tests/test_render.py's
sharded tests.
"""

import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.io import builtin as jbuiltin
from lupinpathtracer_tpu.parallel import sharding as jsharding
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.apps import scaling_study
from lupinpathtracer_tpu_torch.io import builtin as tbuiltin
from lupinpathtracer_tpu_torch.parallel import sharding as tsharding

from test_wavefront import _tri_sphere_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch thread a test: the suite runs in several workers."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cornell_desc(pkg, ptype):
    cam = jbuiltin.build_scene_cornell_box()[1][0]
    desc = pkg.PathtraceDesc()
    desc.camera_transform = cam.transform
    desc.camera_params = cam.params
    desc.pathtrace_type = ptype
    desc.advanced.max_radiance = 10.0
    return desc


BAKED = dict(max_bounces=2, samples_per_pixel=2)


def _both_cornell():
    tpu = build_scene_tpu(jbuiltin.build_scene_cornell_box()[0])
    ts = tl.build_scene_torch(tbuiltin.build_scene_cornell_box()[0], device="cpu")
    return tpu, ts


@pytest.mark.parametrize("n,accums", [(2, 2), (4, 1)])
def test_tiles_mode_matches_single_and_jax(n, accums):
    """Tiles mode on ["cpu"] * n: bit-equal to the port's single-device
    render_progressive (the megakernel's plain version on the CPU), and
    within 1e-5 of the JAX package's sharded render on n of its devices
    (two accumulations at n = 2: the progressive blend)."""

    tpu, ts = _both_cornell()
    PT = tl.PathtraceType.STANDARD
    single = tl.render_progressive(ts, _cornell_desc(tl, PT), tl.BakedPathtraceParams(
        **BAKED), 16, 16, accums, device="cpu")
    img = tsharding.render_progressive_sharded(
        ts, _cornell_desc(tl, PT), tl.BakedPathtraceParams(**BAKED), 16, 16, accums,
        mesh=["cpu"] * n)
    assert img.shape == (16, 16, 3) and img.mean() > 0
    assert np.array_equal(img, single)
    jimg = jsharding.render_progressive_sharded(
        tpu, _cornell_desc(jl, PT), jl.BakedPathtraceParams(**BAKED), 16, 16, accums,
        mesh=jsharding.make_tile_mesh(n))
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=1e-5)


def test_samples_mode_matches_jax():
    """Samples mode at n = 2: entry i renders the frame at sample offset
    i * spp, the entries averaged; within 1e-5 of the JAX package's pmean
    mode, and not the tiles image (other samples)."""

    tpu, ts = _both_cornell()
    PT = tl.PathtraceType.STANDARD
    img = tsharding.render_progressive_sharded(
        ts, _cornell_desc(tl, PT), tl.BakedPathtraceParams(**BAKED), 16, 16, 1,
        mesh=tsharding.make_tile_mesh(2, ["cpu"]), mode="samples")
    jimg = jsharding.render_progressive_sharded(
        tpu, _cornell_desc(jl, PT), jl.BakedPathtraceParams(**BAKED), 16, 16, 1,
        mesh=jsharding.make_tile_mesh(2), mode="samples")
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=1e-5)
    tiles = tsharding.render_progressive_sharded(
        ts, _cornell_desc(tl, PT), tl.BakedPathtraceParams(**BAKED), 16, 16, 1,
        mesh=["cpu"] * 2)
    assert not np.array_equal(img, tiles)


def test_bvh_scene_tiles_mode():
    """A BVH scene (the UV sphere and ground of tests/test_wavefront.py,
    dense_max_tris=64: several superleaves, lit here by a constant
    environment) in tiles mode at n = 4:
    bit-equal to the single-device render, within 1e-5 of the JAX
    package's sharded render."""

    desc_of = {}
    for pkg in (jl, tl):
        desc = pkg.PathtraceDesc()
        cam = np.zeros((3, 4), np.float32)
        cam[:, :3] = np.eye(3)
        cam[:, 3] = (0.0, 1.5, -6.0)
        desc.camera_transform = cam
        desc.pathtrace_type = pkg.PathtraceType.NAIVE
        desc.advanced.max_radiance = 10.0
        desc_of[pkg] = desc
    scene = _tri_sphere_scene()
    scene.environments.append(jl.Environment(emission=np.array([1.0, 0.9, 0.8],
                                                               np.float32)))
    tpu = build_scene_tpu(scene, dense_max_tris=64)
    ts = tl.build_scene_torch(scene, device="cpu", dense_max_tris=64)
    assert ts.use_bvh and ts.sl_count >= 2
    baked = dict(max_bounces=2, samples_per_pixel=1)
    single = tl.render_progressive(ts, desc_of[tl], tl.BakedPathtraceParams(**baked),
                                   16, 16, 1, device="cpu")
    img = tsharding.render_progressive_sharded(
        ts, desc_of[tl], tl.BakedPathtraceParams(**baked), 16, 16, 1, mesh=["cpu"] * 4)
    assert np.array_equal(img, single) and img.max() > 0
    jimg = jsharding.render_progressive_sharded(
        tpu, desc_of[jl], jl.BakedPathtraceParams(**baked), 16, 16, 1,
        mesh=jsharding.make_tile_mesh(4))
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=1e-5)


def test_make_tile_mesh_and_height_rule():
    """Entries repeat in turn over the given devices; the default (every
    visible GPU) raises without one; the height must divide over the
    mesh, as in the JAX package."""

    assert tsharding.make_tile_mesh(3, ["cpu"]) == [torch.device("cpu")] * 3
    assert tsharding.make_tile_mesh(None, ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsharding.make_tile_mesh(2)
    _, ts = _both_cornell()
    with pytest.raises(ValueError, match="must divide"):
        tsharding.render_progressive_sharded(
            ts, _cornell_desc(tl, tl.PathtraceType.STANDARD),
            tl.BakedPathtraceParams(**BAKED), 16, 18, 1, mesh=["cpu"] * 4)


def test_scaling_study_cpu_mesh(capsys):
    """scaling_study --cpu-mesh at 16x16: mesh sizes 1, 2, 4, 8 in both
    modes, the tiles images identical across sizes."""

    rows = scaling_study.main(["--cpu-mesh", "--width", "16", "--height", "16",
                               "--spp", "1", "--bounces", "2", "--accums", "1"])
    assert [(r["mode"], r["devices"]) for r in rows] == [
        (m, n) for m in ("tiles", "samples") for n in (1, 2, 4, 8)]
    assert "identical across mesh sizes" in capsys.readouterr().out
