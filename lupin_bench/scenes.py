"""The benchmark's scene descriptions (numpy only), made by the generator a
configuration names.

A generator is `generators/<name>.py` with `generate(seed, **args)`, found
by the name in the configuration's `scene.generator`, so that a new scene
adds a file and edits none. Generators are frozen copies of the scenes the
configurations' sources define: a later change to the program cannot change
the yardstick. They return a plain description of the scene:

    {"meshes": [{"positions": (V, 3) f32, "indices": (T, 3) u32,
                 "normals": (V, 3) f32 or None}, ...],
     "materials": [{"color": (4,) f32, "emission": (4,) f32, "mat_type": int,
                    "roughness": float, "metallic": float, "ior": float}, ...],
     "frames": (N, 3, 4) f32, "inst_mesh": (N,) i64, "inst_mat": (N,) i64,
     "camera": {"transform": (3, 4) f32, "lens", "film", "aspect", "focus",
                "aperture", "is_orthographic"}}

The harness hands it to the port through the port's public scene API and
the reference reads the same arrays. Sizes never depend on the seed.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MATTE, GLOSSY, REFLECTIVE = 0, 1, 2


def material(color=(0.0, 0.0, 0.0, 1.0), emission=(0.0, 0.0, 0.0, 0.0),
             mat_type=MATTE, roughness=0.0, metallic=0.0, ior=1.5) -> dict:
    """A material with the renderer's defaults (black, opaque, matte)."""

    return dict(color=np.asarray(color, np.float32),
                emission=np.asarray(emission, np.float32),
                mat_type=int(mat_type), roughness=float(roughness),
                metallic=float(metallic), ior=float(ior))


def frame_identity() -> np.ndarray:
    f = np.zeros((3, 4), np.float32)
    f[:, :3] = np.eye(3, dtype=np.float32)
    return f


def scene(meshes, materials, insts, camera) -> dict:
    """The description from meshes, materials, [(frame, mesh, material)]
    instances and a camera."""

    return dict(meshes=meshes, materials=materials,
                frames=np.stack([f for f, _, _ in insts]).astype(np.float32),
                inst_mesh=np.asarray([m for _, m, _ in insts], np.int64),
                inst_mat=np.asarray([k for _, _, k in insts], np.int64),
                camera=camera)


def generator(name: str):
    """The `generate(seed, **args)` function of generators/<name>.py."""

    path = os.path.join(HERE, "generators", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "lupin_bench_generator_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate


def generate(config: dict, seed: int) -> dict:
    """The scene a configuration file names, made from `seed`."""

    gen = config["scene"]
    return generator(gen["generator"])(seed=seed, **gen.get("args", {}))
