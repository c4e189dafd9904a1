"""The benchmark's only contact with the program: the scene bridge and the
base of the window's loops.

The scene description from `scenes.py` goes to the port through its public
scene API (`SceneCPU`, `build_scene_torch`). A loop kind is
`loops/<kind>.py` with a `Loop` class built on `port.Loop`, found by the
name in a traffic file's "loop" (`cells.loop_class`), so that a new kind
adds a file and edits none. Every unit of a loop (an accumulation, a frame)
ends in a device synchronisation. Spans (host clock, ns) and
`record_function` ranges mark the harness's calls into the program.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from lupinpathtracer_tpu_torch.core.types import (
    BakedPathtraceParams,
    CameraParams,
    Material,
    MaterialType,
    PathtraceDesc,
    PathtraceType,
)
from lupinpathtracer_tpu_torch.render import renderer
from lupinpathtracer_tpu_torch.scene.flatten import build_scene_torch
from lupinpathtracer_tpu_torch.scene.scene import (
    InstanceCPU,
    MeshCPU,
    SceneCPU,
    validate_scene,
)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The harness's host spans: (name, start_ns, end_ns), time.time_ns()."""

    def __init__(self):
        self.spans: list = []

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        with torch.profiler.record_function(name):
            yield
        self.spans.append((name, t0, time.time_ns()))


def port_scene(desc: dict) -> SceneCPU:
    """The scene description as the port's host scene."""

    scene = SceneCPU()
    for m in desc["materials"]:
        scene.add_material(Material(
            color=m["color"], emission=m["emission"],
            mat_type=MaterialType(m["mat_type"]), roughness=m["roughness"],
            metallic=m["metallic"], ior=m["ior"]))
    for m in desc["meshes"]:
        scene.add_mesh(MeshCPU(positions=m["positions"], indices=m["indices"],
                               normals=m["normals"]))
    for f, mi, ki in zip(desc["frames"], desc["inst_mesh"], desc["inst_mat"]):
        scene.add_instance(InstanceCPU(frame=f.copy(), mesh_idx=int(mi),
                                       mat_idx=int(ki)))
    validate_scene(scene)
    return scene


def build(desc: dict, two_level: bool, device):
    """(scene on device, seconds of build_scene_torch)."""

    scene = port_scene(desc)
    t0 = time.perf_counter()
    ts = build_scene_torch(scene, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    if bool(ts.two_level) != bool(two_level):
        raise RuntimeError(f"the port built two_level={ts.two_level}, the "
                           f"configuration states {two_level}")
    return ts, build_s


def path_desc(cam: dict, render: dict, seed32: int) -> PathtraceDesc:
    desc = PathtraceDesc()
    desc.camera_transform = cam["transform"]
    desc.camera_params = CameraParams(
        is_orthographic=cam["is_orthographic"], lens=cam["lens"],
        aperture=cam["aperture"], focus=cam["focus"], film=cam["film"],
        aspect=cam["aspect"])
    desc.pathtrace_type = PathtraceType[render["integrator"]]
    desc.advanced.max_radiance = render["max_radiance"]
    desc.advanced.ray_epsilon = render["ray_epsilon"]
    desc.advanced.rng_seed = seed32
    return desc


class Loop:
    """One cell's drive of the port: set-up's warm-up, then the window.
    `profiler` (a callable giving a started profiler, or None) is started
    before unit `trace_from` and stopped after `trace_units` units."""

    unit = "unit"

    def __init__(self, ts, scene_desc, traffic, seed32, device):
        render = traffic["render"]
        self.ts, self.render, self.traffic = ts, render, traffic
        self.device, self.seed32 = device, seed32
        self.W, self.H = int(traffic["width"]), int(traffic["height"])
        self.cam = scene_desc["camera"]
        self.baked = BakedPathtraceParams(
            max_bounces=int(render["max_bounces"]),
            samples_per_pixel=int(traffic["spp"]))
        self.spans = Spans()

    def image(self):
        return renderer.new_accumulation_buffer(self.W, self.H, self.device)

    def window(self, seconds: float, profiler=None) -> dict:
        """Runs units until `seconds` have passed since the window opened
        (and the traced units, if any, are done). Returns the window's
        record: per unit its seconds, the wall from the window's start to
        the end of the last unit, the peak of allocated memory above the
        window's start."""

        dev = self.device
        cuda = torch.device(dev).type == "cuda"
        self.begin()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) if cuda else 0
        t_from = int(self.traffic.get("trace_from", 1))
        t_units = int(self.traffic.get("trace_units", 1))
        prof, traced = None, {}
        unit_s, i = [], 0
        t0 = time.perf_counter()
        while True:
            if profiler is not None and i == t_from:
                sync(dev)
                prof = profiler()
                traced["t0_ns"], traced["p0"] = time.time_ns(), time.perf_counter()
            u0 = time.perf_counter()
            self.step(i)
            with self.spans("synchronize"):
                sync(dev)
            t = time.perf_counter()
            unit_s.append(t - u0)
            i += 1
            if prof is not None and i == t_from + t_units:
                traced["wall_s"] = time.perf_counter() - traced["p0"]
                traced["t1_ns"] = time.time_ns()
                prof.stop()
                traced["prof"], prof = prof, None
                traced["units"] = t_units
            if t - t0 >= seconds and (profiler is None or "prof" in traced):
                break
        return dict(
            units=i, unit_s=unit_s, wall_s=t - t0,
            peak_above_bytes=(torch.cuda.max_memory_allocated(dev) - held
                              if cuda else 0),
            traced=traced, **self.end())
