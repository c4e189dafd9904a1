"""Headless kernel check on the GPU.

The counterpart of lupinpathtracer_tpu/apps/check_kernels.py (a rebuild of
the reference's `check_shaders` tool, lupin/src/tools/check_shaders.rs:
14-19). It first builds every CUDA kernel library from csrc/ (nvcc,
kernels/cuda_build.build_all), then runs every render entry against tiny
scenes on the card, so one command finds a kernel that does not build or
launch:

- each PathtraceType, the ALBEDO falsecolor AOV, the tri_checks debug
  heatmap, tonemap and denoise on the Cornell box (B2, B3);
- the packet-BVH sphere (dense_max_tris=64: B4-B7);
- the sphere instanced five times as a two-level scene, with the port's
  one two-level mode of B4 (kernels/packet.py) launched directly. The JAX
  tool forces LUPIN_PACKET_STREAM here, its SMEM-ring variant for top
  tables that do not fit the TPU's scalar memory; that is a TPU mechanism
  with no counterpart in the port, and no environment variable stands in
  for it;
- the sharded step (parallel/sharding.py) on a mesh of two entries of the
  first GPU (tiles mode, B3).

Any failure counts; the tool exits non-zero when one fails, as the JAX
tool does.

Usage: python -m lupinpathtracer_tpu_torch.apps.check_kernels
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch


def _sphere_mesh():
    """The JAX tool's UV sphere (24 x 32 vertices, 1,472 triangles)."""

    from ..scene.scene import MeshCPU

    lat = np.linspace(0.1, np.pi - 0.1, 24)
    lon = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    pts = np.array(
        [[np.sin(a) * np.cos(b), np.cos(a) + 1.5, np.sin(a) * np.sin(b)]
         for a in lat for b in lon],
        np.float32,
    )
    idx = []
    for i in range(23):
        for j in range(32):
            a = i * 32 + j
            b = i * 32 + (j + 1) % 32
            c = (i + 1) * 32 + j
            d = (i + 1) * 32 + (j + 1) % 32
            idx += [[a, b, c], [b, d, c]]
    return MeshCPU(positions=pts, indices=np.asarray(idx, np.int32),
                   normals=None, texcoords=None, colors=None)


def checks(device) -> list:
    """[(name, fn)] of every check, fn() returning the check's outputs."""

    from ..core.types import (
        BakedPathtraceParams,
        FalsecolorType,
        Material,
        PathtraceDesc,
        PathtraceType,
    )
    from ..core.vec3 import V3
    from ..denoise.atrous import denoise
    from ..io import builtin
    from ..kernels import intersect, packet
    from ..parallel.sharding import make_tile_mesh, render_progressive_sharded
    from ..render import renderer, tonemap
    from ..scene.flatten import build_scene_torch
    from ..scene.scene import InstanceCPU, SceneCPU

    scene, cams = builtin.build_scene_cornell_box()
    ts = build_scene_torch(scene, device=device)
    desc = PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    baked = BakedPathtraceParams(max_bounces=2, samples_per_pixel=1)

    def buf():
        return renderer.new_accumulation_buffer(8, 8, device)

    def pt_check(pt):
        d = copy.deepcopy(desc)
        d.pathtrace_type = pt
        return lambda: renderer.pathtrace_scene(ts, buf(), d, baked)

    out = [(f"pathtrace[{pt.name}]", pt_check(pt)) for pt in PathtraceType]
    out += [
        ("falsecolor[ALBEDO]", lambda: renderer.pathtrace_scene_falsecolor(
            ts, buf(), desc, baked, FalsecolorType.ALBEDO)),
        ("debug[tri_checks]", lambda: renderer.pathtrace_scene_debug(
            ts, buf(), desc, baked)),
        ("tonemap", lambda: tonemap.tonemap_and_fit_aspect(
            torch.ones((8, 8, 3), device=device), 0.0, 10, 10, True, True)),
        ("denoise", lambda: denoise(torch.ones((16, 16, 3), device=device),
                                    iterations=2)),
    ]

    # BVH/packet path: a UV sphere forces several superleaves, so the
    # packet traversal with attributes (B4) and the wavefront (B5-B7) run.
    sphere = _sphere_mesh()
    sph = SceneCPU(
        meshes=[sphere],
        instances=[InstanceCPU(frame=np.eye(3, 4, dtype=np.float32),
                               mesh_idx=0, mat_idx=0)],
        materials=[Material()], environments=[], textures=[],
    )
    bvh_ts = build_scene_torch(sph, device=device, dense_max_tris=64)
    desc_b = copy.deepcopy(desc)
    desc_b.pathtrace_type = PathtraceType.STANDARD
    out.append(("pathtrace[STANDARD, packet BVH]", lambda: renderer.pathtrace_scene(
        bvh_ts, buf(), desc_b, baked)))

    # Two-level: the sphere instanced five times; B4's two-level mode on a
    # row of downward rays across the instances.
    sph5 = SceneCPU(
        meshes=[sphere],
        instances=[
            InstanceCPU(frame=np.array([[1, 0, 0, 2.5 * k], [0, 1, 0, 0],
                                        [0, 0, 1, 0]], np.float32),
                        mesh_idx=0, mat_idx=0)
            for k in range(5)
        ],
        materials=[Material()], environments=[], textures=[],
    )
    tl_ts = build_scene_torch(sph5, device=device, dense_max_tris=64,
                              two_level=True)

    def two_level():
        W4 = intersect._wavefront_tri_matrix(tl_ts)
        n = 256
        ro = V3(torch.linspace(-1.0, 11.0, n, device=device),
                torch.full((n,), 8.0, device=device), torch.zeros(n, device=device))
        rd = V3(torch.zeros(n, device=device), torch.full((n,), -1.0, device=device),
                torch.zeros(n, device=device))
        t = packet.packet_traverse(tl_ts, ro, rd, float(np.float32(1e-3)), W4)[0]
        if not bool((t < 1e30).any()):
            raise AssertionError("two-level B4 hit nothing")
        return t

    out.append(("packet BVH [two-level]", two_level))
    out.append(("sharded step [tiles, 2 entries]", lambda: render_progressive_sharded(
        ts, desc, baked, 8, 16, 1, mesh=make_tile_mesh(2, [device]))))
    return out


def main():
    from ..core.device import resolve_device
    from ..kernels import cuda_build

    device = resolve_device("cuda")
    t0 = time.time()
    cuda_build.build_all()
    print(f"  OK   build ({time.time() - t0:.1f}s)", flush=True)
    failed = 0
    for name, fn in checks(device):
        t0 = time.time()
        try:
            fn()
            torch.cuda.synchronize(device)
            print(f"  OK   {name} ({time.time() - t0:.1f}s)", flush=True)
        except Exception as e:  # noqa: BLE001 — report every failure
            failed += 1
            print(f"  FAIL {name}: {type(e).__name__}: {e}", flush=True)
    if failed:
        raise SystemExit(f"{failed} kernel checks failed")
    print("all kernel checks passed")


if __name__ == "__main__":
    main()
