"""PyTorch port, the apps on the CPU: render_cli against the JAX package's
CLI on the same arguments and scene files, golden_test's comparator and
checkpoint guard against the JAX runner's, golden_test.main bootstrapping
and resuming a checkpoint, the viewer's orbit, and every module of the
port importing without JAX (check_kernels itself needs a GPU: its first
step builds the CUDA kernels).

Tolerances: the CLI's output files equal the JAX CLI's at the render
tolerance of tests/test_torch_render.py (rtol 2e-4 / atol 2e-5) plus one
step of the file's quantization (half floats: 2^-10 relative; the 8-bit
tonemap: one level); the comparator bit-equal.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lupinpathtracer_tpu.apps import golden_test as jgt
from lupinpathtracer_tpu.apps import render_cli as jcli
from lupinpathtracer_tpu.apps import viewer as jviewer

from lupinpathtracer_tpu_torch.apps import golden_test as tgt
from lupinpathtracer_tpu_torch.apps import render_cli as tcli
from lupinpathtracer_tpu_torch.apps import viewer as tviewer
from lupinpathtracer_tpu_torch.io import builtin as tbuiltin
from lupinpathtracer_tpu_torch.io import exr, hdr
from lupinpathtracer_tpu_torch.tools import scene_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch thread a test: the suite runs in several workers."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    return exr.read_exr(path)[..., :3] if path.endswith(".exr") else hdr.read_hdr(path)


@pytest.mark.parametrize("case", ["cornell_tiled_denoise", "textured_tonemap",
                                  "textured_albedo"])
def test_render_cli_matches_jax(tmp_path, case):
    """The port's CLI with --device cpu at 16x16, 1 spp, 2 accumulations,
    2 bounces against the JAX CLI on the same arguments: the Cornell box
    with --tile-size and --denoise (.hdr out), and an opaque textured
    scene with an environment from files (alpha would couple the lanes of
    a batch) with --tonemap (.exr out) and with --falsecolor albedo."""

    args = ["--width", "16", "--height", "16", "--spp", "1", "--accums", "2",
            "--bounces", "2"]
    ext = ".hdr"
    if case == "cornell_tiled_denoise":
        args += ["--tile-size", "8", "--denoise"]
    else:
        scene, cams = scene_files.textured_cornell(tex_size=16, env_wh=(32, 16),
                                                   opaque=True)
        args.insert(0, scene_files.write_scene_dir(str(tmp_path), "tex", scene, cams))
        ext = ".exr"
    if case == "textured_albedo":
        args += ["--falsecolor", "albedo"]
    outs = {}
    for tag, cli, extra in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}{ext}")
        tm = ["--tonemap", str(tmp_path / f"{tag}.png")] if "tonemap" in case else []
        cli.main(args + tm + extra + ["--out", out])
        outs[tag] = _read(out)
    j, t = outs["jax"], outs["port"]
    assert t.shape == (16, 16, 3) and np.isfinite(t).all() and t.mean() > 0
    quantum = 2.0 ** -10 if ext == ".exr" else 2.0 ** -7
    np.testing.assert_allclose(t, j, rtol=2e-4 + quantum, atol=2e-5)
    if "tonemap" in case:
        from PIL import Image

        pj, pt = (np.asarray(Image.open(tmp_path / f"{k}.png"), np.int32)
                  for k in ("jax", "port"))
        assert pt.shape == (16, 16, 3) and np.abs(pt - pj).max() <= 1


@pytest.mark.parametrize("fn", ["compare", "align_for_scale", "camera_resolution",
                                "_resize_box"])
def test_comparator_bit_equal_to_jax(fn, rng):
    a = rng.uniform(0, 4, (24, 20, 3)).astype(np.float32)
    b = rng.uniform(0, 4, (24, 20, 3)).astype(np.float32)
    calls = {
        "compare": lambda m: m.compare(a, b),
        "align_for_scale": lambda m: (m.align_for_scale(a, 1), m.align_for_scale(a, 4)),
        "camera_resolution": lambda m: [m.camera_resolution(x) for x in (1.0, 1.5, 2.39)],
        "_resize_box": lambda m: (m._resize_box(a, 6, 5), m._resize_box(a, 7, 9)),
    }[fn]
    _bit_equal(calls(jgt), calls(tgt))


def _bit_equal(x, y):
    if isinstance(x, (tuple, list)):
        assert type(x) is type(y) and len(x) == len(y)
        for a, b in zip(x, y):
            _bit_equal(a, b)
        return
    assert type(x) is type(y)
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


# -- the checkpoint guard (tests/test_ckpt_guard.py's cases, on the port) -------


def _ckpt(path, **extra):
    np.savez(path, image=np.zeros((4, 4, 4)), counter=3, spp_per_pass=10, **extra)
    return np.load(path, allow_pickle=False)


@pytest.mark.parametrize("case", ["stable", "stamped", "stale", "legacy"])
def test_ckpt_guard(tmp_path, case):
    s = tgt._code_sha()
    assert len(s) == 12 and tgt._code_sha() == s  # cached, deterministic
    p = tmp_path / "ckpt.npz"
    if case == "stamped":
        ck = _ckpt(p, code_sha=s)
        assert str(ck["code_sha"]) == s and int(ck["counter"]) == 3
    elif case == "stale":
        assert str(_ckpt(p, code_sha="deadbeef0000")["code_sha"]) != s
    elif case == "legacy":
        assert "code_sha" not in _ckpt(p)


def test_code_sha_skips_build_dir(tmp_path):
    """The hash reads .py, .cpp, .cu and .cuh files, and nothing under
    build/: nvcc fills build/ at first use, which must not discard a
    checkpoint."""

    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "a.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text("__global__ void k() {}\n")
    h0 = tgt.source_hash(str(pkg))
    (pkg / "build").mkdir()
    (pkg / "build" / "libk.so").write_bytes(b"\x7fELF")
    (pkg / "build" / "copy.cu").write_text("// a variant copy\n")
    (pkg / "notes.txt").write_text("docs\n")
    assert tgt.source_hash(str(pkg)) == h0
    for name in ("csrc/k.cuh", "csrc/k.cu"):
        (pkg / name).write_text("// changed\n")
        h1 = tgt.source_hash(str(pkg))
        assert h1 != h0
        h0 = h1


def test_golden_main_bootstraps_then_resumes(tmp_path, monkeypatch, capsys):
    """golden_test.main with --ckpt on a Cornell scene dir written by
    scene_files: with no golden it renders (tiled, checkpointed; the
    camera's resolution cut to 16x16) and bootstraps one into --out_dir;
    with that golden beside the scene it resumes the checkpoint at its
    last accumulation and passes the reference's gate."""

    scenes = tmp_path / "scenes"
    scene_files.write_scene_dir(str(scenes), "cornell",
                                *tbuiltin.build_scene_cornell_box())
    monkeypatch.setattr(tgt, "camera_resolution", lambda aspect: (16, 16))
    out_dir = tmp_path / "out"
    argv = ["--scenes", str(scenes), "--scene", "cornell", "--samples", "20",
            "--ckpt", "--out_dir", str(out_dir), "--device", "cpu"]
    first = tgt.main(argv)
    assert first == [("cornell", 0, True, 0.0, 0.0)]
    assert "ckpt @ accum 2/2" in capsys.readouterr().out
    shutil.copy(out_dir / "cornell_render_cam0.hdr",
                scenes / "cornell" / "render_cam0.hdr")
    second = tgt.main(argv)
    text = capsys.readouterr().out
    assert "resumed at accum 2/2" in text and "[OK]" in text
    (name, cam, ok, max_dist, _), = second
    assert ok is True and max_dist <= tgt.EPSILON


def test_viewer_orbit_transform_matches_jax():
    base = np.zeros((3, 4), np.float32)
    base[:, :3] = np.eye(3)
    base[:, 3] = (0.0, 1.0, -3.9)
    for ang in (0.0, 1.3, np.pi):
        np.testing.assert_array_equal(tviewer.orbit_transform(base, ang),
                                      jviewer.orbit_transform(base, ang))


def test_viewer_orbit_frames(tmp_path):
    """A 2-frame orbit at 16 px on the CPU: normals preview, accumulation,
    denoise, tonemap, PNG frames; the first frame lit."""

    from PIL import Image

    out = tmp_path / "frames"
    tviewer.main(["--out", str(out), "--orbit", "2", "--width", "16",
                  "--accums", "2", "--spp", "1", "--bounces", "2", "--denoise",
                  "--preview-normals", "--device", "cpu"])
    files = sorted(os.listdir(out))
    assert files == ["frame000.png", "frame000_preview.png",
                     "frame001.png", "frame001_preview.png"]
    for f in files:
        assert np.asarray(Image.open(out / f)).shape[:2] == (16, 16)
    assert np.asarray(Image.open(out / "frame000.png")).max() > 0


def test_port_modules_import_without_jax():
    """Every module of the port, check_kernels included, imports in a
    process where JAX and the JAX package cannot be imported."""

    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'lupinpathtracer_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import lupinpathtracer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'lupinpathtracer_tpu_torch.apps.check_kernels' in names\n"
        "assert not any(k.split('.')[0] in ('jax', 'lupinpathtracer_tpu') for k in sys.modules)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 40
