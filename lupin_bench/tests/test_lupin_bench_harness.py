"""CPU tests of the benchmark harness (lupin_bench/): window arithmetic,
trace reduction, the frozen generator, the reference against the port, the
import graphs, the metric readers, the control and the planted faults.

    python -m pytest lupin_bench/tests -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from lupin_bench import cells, check, control, port, records, scenes  # noqa: E402
from lupin_bench import run as run_mod  # noqa: E402
from lupin_bench.reference import (  # noqa: E402
    Reference, frame_segments, progressive_pixels)

CORNELL = dict(scene=dict(generator="cornell_box", args={}, two_level=False))


def _json(*path):
    with open(os.path.join(ROOT, *path)) as f:
        return json.load(f)


def tiny_cell(name: str = "cornell.example1") -> dict:
    """A cell at a size a CPU test holds, with the real cell's render
    settings and limits."""

    real = _json("lupin_bench", "traffic", name.split(".", 1)[1] + ".json")
    traffic = dict(real, width=32, height=18, spp=2, accumulations=3,
                   trace_from=1, trace_units=1, check=dict(pixels=128))
    return dict(name=name, chips=1, config=CORNELL, traffic=traffic,
                limits=_json("lupin_bench", "limits", name + ".json"),
                end_to_end=[], per_layer=[])


# ---------------------------------------------------------------- window


def test_window_stall_lowers_rate():
    mrays_per_s = cells.end_to_end("mrays_per_s")
    steady = dict(units=40, unit_s=[0.05] * 40, wall_s=2.0, rays=4_000_000)
    # A stall of 0.3 s inside three accumulations of the window.
    stalled = dict(steady, unit_s=[0.05] * 37 + [0.35] * 3, wall_s=2.9)
    assert mrays_per_s(stalled) < mrays_per_s(steady)
    assert mrays_per_s(steady) == pytest.approx(2.0)


# ----------------------------------------------------------------- trace


def _trace():
    ev = [("void mega_kernel<true>(Params, int const*)", 1_000, 3_000),
          ("void at::native::elementwise_kernel<128, 2>(...)", 2_000, 4_000),
          ("Memcpy DtoD (Device -> Device)", 10_000, 11_000),
          ("void pair_hit_kernel(PairArgs, PairSplit)", 20_000, 26_000),
          ("void mega_kernel<false>(Params, int const*)", 26_000, 27_000),
          ("void cub::DeviceRadixSortOnesweepKernel<...>", 30_000, 31_000)]
    return dict(events=ev, units=2, wall_s=41e-6, t0_ns=0, t1_ns=41_000,
                spans=[("pathtrace_scene", 0, 25_000),
                       ("synchronize", 25_000, 41_000)])


def test_trace_grouping_on_synthetic_records():
    tr = _trace()
    ev = tr["events"]
    assert records.busy_s(ev) == pytest.approx(12e-6)  # 1-4, 10-11, 20-27, 30-31 us
    assert records.kernel_of(ev[0][0]) == "B3"
    assert records.kernel_of(ev[3][0]) == "B6"
    assert records.kernel_of(ev[1][0]) is None
    assert records.device_ms(ev, lambda n: records.kernel_of(n) is None) == \
        pytest.approx(4e-3)
    assert records.idle_share(tr) == pytest.approx(100 * (1 - 12 / 41))
    gaps = records.idle_gaps(tr)
    assert gaps[0] == ["synchronize#1", pytest.approx(10e-6)]  # 31-41 us
    assert gaps[1] == ["pathtrace_scene#0", pytest.approx(9e-6)]  # 11-20 us
    assert sum(g for _, g in gaps) == pytest.approx(29e-6)  # 0-1, 4-10, 27-30 too
    assert records.top_ops(ev)[0][0].startswith("void pair_hit_kernel")
    assert records.clock_aligned(tr)
    rec = dict(loop="progressive", trace=tr, setup=dict(scene_build_s=1.5),
               window=dict(units=4, peak_above_bytes=2e9))
    got = {m["name"]: cells.reader(m["name"])(rec)
           for m in _json("BENCHMARK.json")["per_layer"]}
    assert got == {"scene.build_s": 1.5,
                   "kernels.b3_ms_per_accum": pytest.approx(1.5e-3),
                   "glue.device_ms_per_accum": pytest.approx(2e-3),
                   "device.idle_share": pytest.approx(100 * (1 - 12 / 41)),
                   "device.launches_per_accum": 3,
                   "dispatch.peak_gb": 2.0}
    # Untraced runs and traces without the kernel read nothing.
    assert cells.reader("kernels.b3_ms_per_accum")(dict(rec, trace=None)) is None
    no_b3 = dict(tr, events=[e for e in ev if "mega" not in e[0]])
    assert cells.reader("kernels.b3_ms_per_accum")(dict(rec, trace=no_b3)) is None


def test_benchmark_json_names_existing_files():
    bench = _json("BENCHMARK.json")
    for w in bench["workloads"]:
        c = cells.load(ROOT, w["name"])
        assert issubclass(cells.loop_class(c["traffic"]["loop"]), port.Loop)
        assert callable(scenes.generator(c["config"]["scene"]["generator"]))
        assert set(c["limits"]) == {"radiance_mismatch_share",
                                    "radiance_sum_gap", "segments_gap"}
        assert any(m["name"] == "setup_s" for m in c["end_to_end"])
        assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in bench["end_to_end"]:
        if m["name"] != "setup_s":
            assert callable(cells.end_to_end(m["name"]))
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))


# ------------------------------------------------------------- generators


def test_frozen_cornell_box_equals_the_ports():
    from lupinpathtracer_tpu_torch.io.builtin import build_scene_cornell_box

    a, cams = build_scene_cornell_box()
    d = scenes.generate(CORNELL, 5)
    b = port.port_scene(d)
    assert len(a.meshes) == len(b.meshes) and len(a.instances) == len(b.instances)
    for m1, m2 in zip(a.meshes, b.meshes):
        for f in ("positions", "indices", "normals"):
            x, y = getattr(m1, f), getattr(m2, f)
            assert (x is None and y is None) or np.array_equal(x, y), f
    for i1, i2 in zip(a.instances, b.instances):
        assert np.array_equal(i1.frame, i2.frame)
        assert (i1.mesh_idx, i1.mat_idx) == (i2.mesh_idx, i2.mat_idx)
    assert len(a.materials) == len(b.materials)
    for m1, m2 in zip(a.materials, b.materials):
        for f in ("color", "emission", "mat_type", "roughness", "metallic", "ior"):
            assert np.array_equal(np.asarray(getattr(m1, f)),
                                  np.asarray(getattr(m2, f))), f
    assert np.array_equal(cams[0].transform, d["camera"]["transform"])
    p = cams[0].params
    assert (p.lens, p.film, p.aspect, p.focus, p.aperture, p.is_orthographic) == \
        tuple(d["camera"][k] for k in ("lens", "film", "aspect", "focus",
                                       "aperture", "is_orthographic"))


# -------------------------------------------------------------- reference


def _desc_of(scene, cam) -> dict:
    """The port's host scene as the benchmark's description (for scenes
    that only the port's own generators make)."""

    mats = [scenes.material(m.color, m.emission, int(m.mat_type), m.roughness,
                            m.metallic, m.ior) for m in scene.materials]
    meshes = [dict(positions=m.positions, indices=m.indices, normals=m.normals)
              for m in scene.meshes]
    insts = [(i.frame, i.mesh_idx, i.mat_idx) for i in scene.instances]
    p = cam.params
    return scenes.scene(meshes, mats, insts, dict(
        transform=cam.transform, lens=p.lens, film=p.film, aspect=p.aspect,
        focus=p.focus, aperture=p.aperture, is_orthographic=p.is_orthographic))


def _fixture(which):
    from lupinpathtracer_tpu_torch.io import synthetic

    if which == "cornell":
        return scenes.generate(CORNELL, 5), False
    if which == "terrain":
        sc, cams = synthetic.build_scene_terrain(n_tris=3000, seed=5)
        return _desc_of(sc, cams[0]), False
    sc, cams = synthetic.build_scene_instanced_field(200, seed=5, tris_per_mesh=64)
    return _desc_of(sc, cams[0]), True


@pytest.mark.parametrize("which", ["cornell", "terrain", "field"])
def test_reference_equals_the_port_on_the_cpu(which):
    d, two = _fixture(which)
    ts, _ = port.build(d, two, "cpu")
    traffic = tiny_cell()["traffic"]
    loop = cells.loop_class("progressive")(ts, d, traffic, 12345, "cpu")
    loop.begin()
    for i in range(3):
        loop.step(i)
    img, accums = loop.checked(3)
    assert accums == 3
    ref = Reference(d, two, "cpu")
    gx = (torch.arange(32 * 18) % 32).int()
    gy = (torch.arange(32 * 18) // 32).int()
    args = (float(np.float32(0.001)), 8, float(np.float32(100.0)))
    rimg, seg = progressive_pixels(ref, d["camera"], gx, gy, 32, 18, 12345, 3, 2,
                                   *args)
    assert torch.equal(img.reshape(-1, 3), rimg)
    assert int(seg.sum()) == sum(loop.unit_rays)
    for c in range(3):
        assert frame_segments(ref, d["camera"], 32, 18, 12345, c, 2,
                              *args) == loop.unit_rays[c]


def test_images_restart_after_their_accumulations():
    d = scenes.generate(CORNELL, 5)
    ts, _ = port.build(d, False, "cpu")
    loop = cells.loop_class("progressive")(ts, d, tiny_cell()["traffic"], 7, "cpu")
    loop.begin()
    for i in range(3):
        loop.step(i)
    first = loop.checked(3)[0]
    for i in range(3, 5):
        loop.step(i)
    img, n = loop.checked(5)
    assert img is first and n == 3  # the image in progress is not checked
    loop.step(5)
    assert torch.equal(loop.checked(6)[0], first)  # counters 0-2 again
    assert loop.unit_rays[3:] == loop.unit_rays[:3]


# ---------------------------------------------------------------- imports


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sys.modules))"],
                         capture_output=True, text=True, cwd=ROOT, check=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    return {m.split(".")[0] for m in out.stdout.split()}


def test_import_graphs_hold_no_jax():
    harness = _modules(
        "import lupin_bench.run as r, lupin_bench.port, lupin_bench.check, "
        "lupin_bench.records, lupin_bench.control\n"
        "from lupin_bench import cells, scenes\n"
        "cells.loop_class('progressive'); scenes.generator('cornell_box')\n"
        "[cells.reader(m) for m in ('scene.build_s', 'kernels.b3_ms_per_accum')]")
    assert not harness & set(run_mod.FORBIDDEN), harness & set(run_mod.FORBIDDEN)
    assert "lupinpathtracer_tpu_torch" in harness
    ref = _modules("import lupin_bench.reference\nfrom lupin_bench import scenes\n"
                   "scenes.generator('cornell_box')")
    assert not ref & (set(run_mod.FORBIDDEN) | {"lupinpathtracer_tpu_torch"})


# ------------------------------------------------------ control and faults


def _run(cell, seed=4242, seconds=0.3):
    return run_mod.run_cell(cell, seed, seconds, False, "cpu", 0.0)


@pytest.mark.parametrize("name", ["cornell.example1", "cornell.golden_1080p"])
def test_control_in_bfloat16_fails_the_check(name):
    cell = tiny_cell(name)
    nums = control.control_numbers(cell, 9, 3, "cpu")
    correct, checks = check.verdict(nums, cell["limits"])
    assert not correct, checks
    assert nums["radiance_mismatch_share"] > cell["limits"]["radiance_mismatch_share"]


def _patch(monkeypatch, fault):
    from lupinpathtracer_tpu_torch.render import renderer

    orig = renderer.pathtrace_scene

    def pathtrace_scene(scene, image, desc, baked, stats=None):
        out = orig(scene, image, desc, baked, stats)
        if fault == "unchanged":
            return image
        if fault == "half":
            out[out.shape[0] // 2:] = image[out.shape[0] // 2:]
            stats["rays"] //= 2
        if fault == "altered":
            out = out * 1.01
        if fault == "miscount":
            stats["rays"] *= 2
        return out

    monkeypatch.setattr(renderer, "pathtrace_scene", pathtrace_scene)


@pytest.mark.parametrize("name", ["cornell.example1", "cornell.golden_1080p"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered",
                                   "miscount"])
def test_planted_faults_make_the_run_incorrect(monkeypatch, name, fault):
    if fault:
        _patch(monkeypatch, fault)
    out = _run(tiny_cell(name))
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] >= 1 and list(out)[-1] == "checks"
