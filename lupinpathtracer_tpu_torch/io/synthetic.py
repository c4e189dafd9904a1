"""Synthetic scene generators for scale-envelope testing.

A copy of lupinpathtracer_tpu/io/synthetic.py (the port imports nothing of
the JAX package); the same seeds give array-equal scenes.

The reference's showcase envelope is multi-million-triangle scenes
(Bistro Exterior / Classroom, the reference's README.md:20-37) and up to
1M TLAS instances (renderer.rs:317-319); no such asset ships in
test_scenes/, so these generators build deterministic equivalents:

- ``build_scene_terrain``: a displaced-grid terrain (one big mesh — deep
  single-level BVH, the packet backend's DMA-bound regime) plus a few
  UV-sphere instances with varied materials and an emissive sky quad.
  Scales from ~2k tris (multi-chip dryrun) to 5M+ (envelope bench).
- ``build_scene_instanced_field``: a two-level stress — N instances of a
  small set of sphere/box meshes scattered on a ground plane (the
  instances1-at-scale analog).

Everything is seeded NumPy; no file IO, so the scenes are checked-in "as
code" and reproducible in CI and in bench configs.
"""

from __future__ import annotations

import numpy as np

from ..core import math3d
from ..core.types import CameraParams, Material, MaterialType, SceneCamera
from ..scene.scene import InstanceCPU, MeshCPU, SceneCPU, validate_scene


def _uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0) -> MeshCPU:
    """UV sphere with shared poles; (n_lat-1)*n_lon*2 - 2*n_lon tris."""

    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    ll, tt = np.meshgrid(lon, lat, indexing="xy")  # (n_lat+1, n_lon)
    x = np.sin(tt) * np.cos(ll)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(ll)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32) * radius

    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                idx.append((a, b, c))
            if i < n_lat - 1:
                idx.append((b, d, c))
    indices = np.asarray(idx, np.uint32)
    normals = (pos / radius).astype(np.float32)
    return MeshCPU(positions=pos, indices=indices, normals=normals)


def _terrain_mesh(n_tris: int, extent: float, seed: int) -> MeshCPU:
    """Displaced grid: smooth multi-octave sine field + seeded jitter.
    Grid of (N-1)^2 quads = 2(N-1)^2 tris, one contiguous mesh."""

    n = max(2, int(round(np.sqrt(n_tris / 2.0))) + 1)
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent, extent, n, dtype=np.float64)
    zs = np.linspace(-extent, extent, n, dtype=np.float64)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    h = np.zeros_like(xx)
    # A few fixed octaves with seeded phases: hilly but smooth, so the BVH
    # gets realistic spatial structure rather than white noise.
    for freq, amp in ((0.35, 1.2), (0.9, 0.45), (2.1, 0.18), (5.3, 0.06)):
        px, pz = rng.uniform(0, 2 * np.pi, 2)
        h += amp * np.sin(freq * xx + px) * np.cos(freq * zz + pz)
    h += rng.normal(0.0, 0.02, h.shape)

    pos = np.stack([xx, h, zz], axis=-1).reshape(-1, 3).astype(np.float32)

    # Two tris per cell, consistent winding (up-facing with the left-handed
    # convention used by the Cornell floor, io/builtin.py).
    i = np.arange(n - 1)
    j = np.arange(n - 1)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    v00 = (ii * n + jj).ravel()
    v01 = (ii * n + jj + 1).ravel()
    v10 = ((ii + 1) * n + jj).ravel()
    v11 = ((ii + 1) * n + jj + 1).ravel()
    tris = np.concatenate(
        [
            np.stack([v00, v01, v11], axis=1),
            np.stack([v00, v11, v10], axis=1),
        ],
        axis=0,
    ).astype(np.uint32)

    # Smooth normals via central height differences (cheap, vectorized).
    dhdx = np.gradient(h, xs, axis=0)
    dhdz = np.gradient(h, zs, axis=1)
    nrm = np.stack([-dhdx, np.ones_like(h), -dhdz], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normals = nrm.reshape(-1, 3).astype(np.float32)

    return MeshCPU(positions=pos, indices=tris, normals=normals)


def _place(frame_rot: np.ndarray | None, scale: float, at) -> np.ndarray:
    f = math3d.frame_identity()
    f[:, :3] *= scale
    if frame_rot is not None:
        f[:, :3] = frame_rot @ f[:, :3]
    f[:, 3] = np.asarray(at, np.float32)
    return f


def build_scene_terrain(
    n_tris: int = 2_000_000, seed: int = 0, extent: float = 12.0
) -> tuple[SceneCPU, list[SceneCamera]]:
    """Multi-M-triangle envelope scene (README.md:20-37 analog).

    ~97% of triangles live in one displaced-terrain mesh; a handful of
    sphere instances (matte / glossy / reflective / emissive) sit on the
    surface so the render exercises secondary rays and MIS light
    sampling, and an overhead emissive quad provides the key light."""

    rng = np.random.default_rng(seed + 1)
    scene = SceneCPU()

    ground = scene.add_material(
        Material(color=np.array([0.55, 0.5, 0.42, 1.0], np.float32))
    )
    mats = [
        scene.add_material(
            Material(color=np.array([0.7, 0.2, 0.2, 1.0], np.float32))
        ),
        scene.add_material(
            Material(
                color=np.array([0.2, 0.4, 0.75, 1.0], np.float32),
                mat_type=MaterialType.GLOSSY,
                roughness=0.15,
            )
        ),
        scene.add_material(
            Material(
                color=np.array([0.9, 0.75, 0.4, 1.0], np.float32),
                mat_type=MaterialType.REFLECTIVE,
                roughness=0.05,
            )
        ),
        scene.add_material(
            Material(emission=np.array([6.0, 5.0, 4.0, 0.0], np.float32))
        ),
    ]
    key_light = scene.add_material(
        Material(emission=np.array([14.0, 12.0, 9.0, 0.0], np.float32))
    )

    terrain = _terrain_mesh(n_tris, extent, seed)
    t_mesh = scene.add_mesh(terrain)
    scene.add_instance(
        InstanceCPU(frame=math3d.frame_identity(), mesh_idx=t_mesh, mat_idx=ground)
    )

    # Spheres: tri budget ~2% of the terrain, at least a tiny one.
    # EMISSIVE spheres use a separate low-poly mesh: every emissive
    # triangle enters the light-pdf evaluation (lights.compute_instance_
    # lights_pdf is O(B x light_tris) like the reference's per-light march,
    # bvh_custom.wgsl:112-152), and r4's two 9216-tri emissive spheres put
    # ~18k triangles into that product — the pdf brute force, not
    # traversal, dominated the terrain bench (out_hw/terrain_render.log
    # OOM; BENCH_r04 0.23 Mrays/s). Bistro-class scenes have few area
    # lights; 2 x 144-tri emitters keep the MIS-over-mesh-lights exercise
    # without making lighting the workload.
    sph_lat = max(4, min(48, int(np.sqrt(max(16, n_tris) * 0.02 / 8))))
    sphere = scene.add_mesh(_uv_sphere(sph_lat, 2 * sph_lat))
    lo_sphere = scene.add_mesh(_uv_sphere(6, 12))
    heights = terrain.positions[:, 1]
    n_verts = terrain.positions.shape[0]
    for k in range(8):
        v = int(rng.integers(0, n_verts))
        base = terrain.positions[v]
        r = float(rng.uniform(0.25, 0.8)) * extent / 12.0
        at = [base[0], float(heights[v]) + r, base[2]]
        emissive = k % len(mats) == 3
        scene.add_instance(
            InstanceCPU(frame=_place(None, r, at),
                        mesh_idx=lo_sphere if emissive else sphere,
                        mat_idx=mats[k % len(mats)])
        )

    # Key light: a quad high above the terrain (down-facing).
    lq = scene.add_mesh(
        MeshCPU(
            positions=np.array(
                [
                    [-0.3 * extent, 4.5, -0.3 * extent],
                    [0.3 * extent, 4.5, -0.3 * extent],
                    [0.3 * extent, 4.5, 0.3 * extent],
                    [-0.3 * extent, 4.5, 0.3 * extent],
                ],
                np.float32,
            ),
            indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
        )
    )
    scene.add_instance(
        InstanceCPU(frame=math3d.frame_identity(), mesh_idx=lq, mat_idx=key_light)
    )

    validate_scene(scene)

    cam = SceneCamera(
        transform=_look_at(
            eye=np.array([0.0, 3.2, -0.85 * extent], np.float32),
            target=np.array([0.0, 0.0, 0.25 * extent], np.float32),
        ),
        params=CameraParams(
            is_orthographic=False,
            lens=0.035,
            aperture=0.0,
            focus=extent,
            film=0.036,
            aspect=16.0 / 9.0,
        ),
    )
    return scene, [cam]


def build_scene_instanced_field(
    n_instances: int = 100_000, seed: int = 0, tris_per_mesh: int = 180
) -> tuple[SceneCPU, list[SceneCamera]]:
    """Two-level stress: N instances of a few small meshes scattered over a
    plane (renderer.rs:317-319 allows 1M instances; instances1 at scale)."""

    rng = np.random.default_rng(seed)
    scene = SceneCPU()

    grey = scene.add_material(
        Material(color=np.array([0.6, 0.6, 0.6, 1.0], np.float32))
    )
    mats = [
        scene.add_material(
            Material(color=np.array(list(rng.uniform(0.2, 0.85, 3)) + [1.0],
                                    np.float32))
        )
        for _ in range(6)
    ]
    light = scene.add_material(
        Material(emission=np.array([10.0, 9.0, 8.0, 0.0], np.float32))
    )

    side = float(np.sqrt(n_instances)) * 0.9 + 4.0
    plane = scene.add_mesh(
        MeshCPU(
            positions=np.array(
                [[-side, 0, side], [side, 0, side],
                 [side, 0, -side], [-side, 0, -side]],
                np.float32,
            ),
            indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
        )
    )
    scene.add_instance(
        InstanceCPU(frame=math3d.frame_identity(), mesh_idx=plane, mat_idx=grey)
    )

    n_lat = max(4, int(np.sqrt(tris_per_mesh / 4)))
    proto = [scene.add_mesh(_uv_sphere(n_lat, 2 * n_lat)),
             scene.add_mesh(_uv_sphere(n_lat + 2, 2 * n_lat))]

    grid = int(np.ceil(np.sqrt(n_instances)))
    pitch = 2.0 * side / (grid + 1)
    ks = np.arange(n_instances)
    gx = (ks % grid).astype(np.float64)
    gz = (ks // grid).astype(np.float64)
    px = (gx - (grid - 1) / 2.0) * pitch + rng.uniform(-0.2, 0.2, n_instances) * pitch
    pz = (gz - (grid - 1) / 2.0) * pitch + rng.uniform(-0.2, 0.2, n_instances) * pitch
    scales = rng.uniform(0.22, 0.42, n_instances) * pitch
    for k in range(n_instances):
        f = _place(None, float(scales[k]), [px[k], scales[k], pz[k]])
        scene.add_instance(
            InstanceCPU(frame=f, mesh_idx=proto[k % 2], mat_idx=mats[k % len(mats)])
        )

    lq = scene.add_mesh(
        MeshCPU(
            positions=np.array(
                [[-side * 0.25, side * 0.6, -side * 0.25],
                 [side * 0.25, side * 0.6, -side * 0.25],
                 [side * 0.25, side * 0.6, side * 0.25],
                 [-side * 0.25, side * 0.6, side * 0.25]],
                np.float32,
            ),
            indices=np.array([[0, 1, 2], [2, 3, 0]], np.uint32),
        )
    )
    scene.add_instance(
        InstanceCPU(frame=math3d.frame_identity(), mesh_idx=lq, mat_idx=light)
    )

    validate_scene(scene)
    cam = SceneCamera(
        transform=_look_at(
            eye=np.array([0.0, side * 0.35, -side * 1.05], np.float32),
            target=np.array([0.0, 0.0, 0.0], np.float32),
        ),
        params=CameraParams(
            is_orthographic=False, lens=0.035, aperture=0.0,
            focus=float(side), film=0.036, aspect=16.0 / 9.0,
        ),
    )
    return scene, [cam]


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera frame: -z forward toward target, y-up (matches the Cornell
    camera convention in io/builtin.py — camera looks along +z in world
    because the scene is left-handed with the backwall at +z)."""

    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    frame = np.zeros((3, 4), np.float32)
    frame[:, 0] = right
    frame[:, 1] = up2
    frame[:, 2] = fwd
    frame[:, 3] = eye
    return frame
