"""PyTorch port, base layer: PCG32 bit parity with the JAX package, the V3
helpers, and the rule that the port imports nothing of JAX.

Inputs are made from a numpy seed and go through both packages.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lupinpathtracer_tpu.core import rng as jrng
from lupinpathtracer_tpu.core import vec3 as jv3
from lupinpathtracer_tpu_torch.core import rng as trng
from lupinpathtracer_tpu_torch.core import vec3 as tv3

REPO = pathlib.Path(__file__).resolve().parents[1]
N_LANES = 1 << 20  # >= 1M lanes


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np_u32(x):
    return np.asarray(x).astype(np.uint32)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(20261016)
    pix = _u32(rng, N_LANES)
    accum = rng.integers(0, 1 << 16, N_LANES).astype(np.uint32)
    seed = _u32(rng, N_LANES)
    sample = rng.integers(0, 1 << 12, N_LANES).astype(np.uint32)
    return pix, accum, seed, sample


def test_init_state_bit_exact(lanes):
    pix, accum, seed, sample = lanes
    js = jrng.init_state(jnp.asarray(pix), jnp.asarray(accum),
                         jnp.asarray(seed), jnp.asarray(sample))
    ts = trng.init_state(_t(pix), _t(accum), _t(seed), _t(sample))
    np.testing.assert_array_equal(_np_u32(ts.numpy()), _np_u32(js))


def test_next_u32_and_f32_bit_exact(lanes):
    pix, accum, seed, sample = lanes
    js = jrng.init_state(jnp.asarray(pix), jnp.asarray(accum),
                         jnp.asarray(seed), jnp.asarray(sample))
    ts = trng.init_state(_t(pix), _t(accum), _t(seed), _t(sample))
    for _ in range(3):
        js, jw = jrng.next_u32(js)
        ts, tw = trng.next_u32(ts)
        np.testing.assert_array_equal(_np_u32(tw.numpy()), _np_u32(jw))
        np.testing.assert_array_equal(_np_u32(ts.numpy()), _np_u32(js))
        js, jf = jrng.next_f32(js)
        ts, tf = trng.next_f32(ts)
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(
            tf.numpy().view(np.uint32), np.asarray(jf).view(np.uint32)
        )


def test_u32_to_f32_edge_words():
    words = np.array([0, 1, 2**24 + 1, 2**31 - 1, 2**31, 2**31 + 1,
                      2**32 - 129, 2**32 - 1], np.uint32)
    jf = np.asarray(jrng.u32_to_f32(jnp.asarray(words)))
    tf = trng.u32_to_f32(_t(words)).numpy()
    np.testing.assert_array_equal(tf.view(np.uint32), jf.view(np.uint32))


@pytest.mark.parametrize("n", [1, 3, 7, 64])
def test_next_u32_range_and_disk(n):
    rng = np.random.default_rng(n)
    st = _u32(rng, 4096)
    js, ji = jrng.next_u32_range(jnp.asarray(st), n)
    ts, ti = trng.next_u32_range(_t(st), n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji).astype(np.int32))
    assert int(ti.max()) < n and int(ti.min()) >= 0
    js, jx, jy = jrng.next_in_disk(js)
    ts, tx, ty = trng.next_in_disk(ts)
    np.testing.assert_array_equal(_np_u32(ts.numpy()), _np_u32(js))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)


def test_vec3_helpers_match():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 3, 256)).astype(np.float32)
    ja, jb = jv3.V3(*map(jnp.asarray, a)), jv3.V3(*map(jnp.asarray, b))
    ta, tb = tv3.V3(*map(torch.from_numpy, a)), tv3.V3(*map(torch.from_numpy, b))
    pairs = [
        (jv3.dot(ja, jb), tv3.dot(ta, tb)),
        (jv3.length(ja), tv3.length(ta)),
        (jv3.max_comp(ja), tv3.max_comp(ta)),
        (jv3.mean_comp(ja), tv3.mean_comp(ta)),
    ]
    for jvec, tvec in [(jv3.cross(ja, jb), tv3.cross(ta, tb)),
                       (jv3.normalize(ja), tv3.normalize(ta)),
                       (jv3.where(a[0] > 0, ja, jb), tv3.where(torch.from_numpy(a[0] > 0), ta, tb)),
                       (jv3.vmax(ja, jb), tv3.vmax(ta, tb)),
                       (jv3.vmin(ja, 0.25), tv3.vmin(ta, 0.25)),
                       (jv3.vabs(ja), tv3.vabs(ta)),
                       (jv3.vclip(ja, -0.5, 0.5), tv3.vclip(ta, -0.5, 0.5)),
                       (jv3.splat((1.0, 2.0, 3.0), ja), tv3.splat((1.0, 2.0, 3.0), ta)),
                       (jv3.from_rows(jv3.to_rows(ja)), tv3.from_rows(tv3.to_rows(ta)))]:
        pairs += list(zip(jvec, tvec))
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax") or top == "lupinpathtracer_tpu"


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_port_imports_no_jax(target):
    files = (sorted((REPO / "lupinpathtracer_tpu_torch").rglob("*.py"))
             if target == "package" else [REPO / "chip_smoke.py"])
    assert files
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert not bad, bad


def test_wrappers_serve_cpu_and_cuda_tensors_only():
    """A kernel wrapper runs its plain version only because its tensors lie
    on the CPU, and on any device but the CPU and CUDA it raises."""

    from lupinpathtracer_tpu_torch.core.device import on_cpu
    from lupinpathtracer_tpu_torch.kernels import bvh, dense_intersect

    assert on_cpu(torch.zeros(1))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        on_cpu(torch.zeros(1, device="meta"))
    R = torch.zeros((4, 10), device="meta")
    W = torch.zeros((4, 10, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dense_intersect.dense_closest_hit(W, R, 1e-3)
    z = torch.zeros(1, dtype=torch.int32, device="meta")
    f = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bvh.pair_intersect(z, z, z, z, tv3.V3(f, f, f), tv3.V3(f, f, f), W,
                           1e-3, SP=8, pair_block=4)


def test_failing_build_or_launch_raises(monkeypatch, tmp_path):
    """No way around a kernel that does not build or launch: a missing
    compiler, a compiler error and a nonzero launch code all raise."""

    from lupinpathtracer_tpu_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("pair_variants")
    monkeypatch.undo()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/bvh.cu"):
        cuda_build.load("bvh")
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        cuda_build.check(9, "pair_intersect")
    cuda_build.check(0, "pair_intersect")
    assert set(cuda_build.SOURCES) == {
        p.stem for p in (REPO / "lupinpathtracer_tpu_torch" / "csrc").glob("*.cu")}
