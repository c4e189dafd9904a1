"""Eric Haines' Standard Procedural Databases (IEEE CG&A 7(11), 1987), scene
`balls` (balls.c, the "sphereflake"): a frozen copy of its procedure, with
every sphere an instance of one tessellated sphere.

A root sphere of radius 0.5 at the origin, whose axis is +z, carries 9
children; each child has a third of its parent's radius and touches it,
centred along one of balls.c's nine directions turned into the parent's
frame (the rotation taking +z to the parent's axis), and its own axis is
that direction. The recursion runs to depth `size_factor` (SF), so the scene
holds 1 + 9 + ... + 9 ** SF = (9 ** (SF + 1) - 1) / 8 spheres, written in
balls.c's order (each sphere before its children). The nine directions are
balls.c's `objset`: the trio (1, 1, 0), (1, 0, -1), (0, 1, -1) over sqrt 2,
turned about (1, -1, 0) by asin(2 / sqrt 6), then about +z by 0, 120 and
240 degrees: three above the equator and six on it. The procedure has no
random part, so the seed changes nothing in the scene.

What the port cannot render as SPD writes it is converted (the
configuration's `assumed` gives each reason):

- each sphere: one instance of a unit icosphere (`subdivisions` times
  split, 20 * 4 ** subdivisions triangles wound outward, vertex normals the
  unit positions) under a frame of uniform scale (the radius) and a
  translation (the centre);
- the floor: SPD's square at z = -0.5, 24 on a side, as one 2-triangle
  instance, matte (1.0, 0.75, 0.33);
- the view: SPD's from / at / up and 45-degree angle as the port's
  thin-lens camera (film 0.024, lens 0.012 / tan 22.5 degrees, aspect 1,
  focus |at - from|, aperture 0), forward the camera's +z, up its +y and
  x = y x z;
- the lights: SPD's three point lights as three emissive quads, 0.5 x 0.5
  (2 triangles each), centred at the lights and facing the origin;
- the spheres' surface: glossy (1.0, 0.9, 0.7), roughness ROUGHNESS, in
  place of SPD's Phong terms with a mirror part (a delta material would
  take the port off its fused shading);
- the background: black (no environment).
"""

from __future__ import annotations

import math

import numpy as np

from lupin_bench.scenes import GLOSSY, MATTE, frame_identity, material, scene

# SPD's view of balls (balls.c).
FROM = (2.1, 1.3, 1.7)
AT = (0.0, 0.0, 0.0)
UP = (0.0, 0.0, 1.0)
ANGLE_DEG = 45.0
FILM = 0.024

ROOT_RADIUS = 0.5
RADIUS_RATIO = 1.0 / 3.0
FLOOR_Z = -0.5
FLOOR_HALF = 12.0
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
LIGHT_SIZE = 0.5
LIGHT_EMISSION = 100.0
SPHERE_COLOR = (1.0, 0.9, 0.7)
ROUGHNESS = 0.2
FLOOR_COLOR = (1.0, 0.75, 0.33)


def _axis_rotation(axis, angle) -> np.ndarray:
    """(3, 3) right-handed rotation by `angle` about the unit `axis`
    (Rodrigues)."""

    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) * c + s * k + (1.0 - c) * np.outer(axis, axis)


def objset() -> np.ndarray:
    """(9, 3) balls.c's unit child directions in the frame of a sphere whose
    axis is +z."""

    d = 1.0 / math.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]])
    tilt = _axis_rotation(np.array([1.0, -1.0, 0.0]) / math.sqrt(2.0),
                          math.asin(2.0 / math.sqrt(6.0)))
    trio = trio @ tilt.T
    out = []
    for k in range(3):
        spin = _axis_rotation(np.array([0.0, 0.0, 1.0]), k * 2.0 * math.pi / 3.0)
        out.append(trio @ spin.T)
    return np.concatenate(out)


def _to_axis(dirs: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotations taking +z to each unit direction (balls.c: the
    identity at +z, a half turn about +y at -z, else the turn about
    z x d by acos(d . z))."""

    out = np.empty((len(dirs), 3, 3))
    for i, d in enumerate(dirs):
        if d[2] >= 1.0:
            out[i] = np.eye(3)
        elif d[2] <= -1.0:
            out[i] = _axis_rotation(np.array([0.0, 1.0, 0.0]), math.pi)
        else:
            axis = np.cross([0.0, 0.0, 1.0], d)
            out[i] = _axis_rotation(axis / np.linalg.norm(axis),
                                    math.acos(float(d[2])))
    return out


def spheres(size_factor: int):
    """(centres (N, 3), radii (N,)) float64 of the flake's spheres in
    balls.c's order (each sphere before its children), N = (9 ** (SF + 1)
    - 1) / 8."""

    sf = int(size_factor)
    sets = objset()
    centres = [np.zeros((1, 3))]
    radii = [np.full(1, ROOT_RADIUS)]
    axes = np.array([[0.0, 0.0, 1.0]])
    digits = [np.zeros((1, 0), np.int64)]
    for _ in range(sf):
        c, r = centres[-1], radii[-1]
        kids = np.einsum("nij,kj->nki", _to_axis(axes), sets)  # (n, 9, 3)
        centres.append((c[:, None, :] + kids * (r * (1.0 + RADIUS_RATIO))[:, None, None]
                        ).reshape(-1, 3))
        radii.append(np.repeat(r * RADIUS_RATIO, 9))
        axes = kids.reshape(-1, 3)
        prev = digits[-1]
        digits.append(np.concatenate(
            [np.repeat(prev, 9, axis=0), np.tile(np.arange(9), len(prev))[:, None]],
            axis=1))
    # Preorder rank of the node with child digits d_1 .. d_L: a node before
    # its subtree, subtrees of level k holding (9 ** (SF - k + 1) - 1) / 8.
    rank = []
    for level, dg in enumerate(digits):
        r = np.zeros(len(dg), np.int64)
        for k in range(level):
            r += 1 + dg[:, k] * ((9 ** (sf - k) - 1) // 8)
        rank.append(r)
    order = np.argsort(np.concatenate(rank))
    return np.concatenate(centres)[order], np.concatenate(radii)[order]


def icosphere(subdivisions: int) -> dict:
    """A unit icosphere: the icosahedron's 20 faces, each split into four
    `subdivisions` times with the new vertices pushed to the sphere; 20 * 4
    ** s triangles and 10 * 4 ** s + 2 vertices, wound outward, vertex
    normals the positions."""

    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    pos = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(int(subdivisions)):
        mid: dict = {}

        def middle(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = pos[a] + pos[b]
                pos.append(m / np.linalg.norm(m))
                mid[key] = len(pos) - 1
            return mid[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    p = np.asarray(pos)
    idx = np.asarray(faces, np.int64)
    v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    inward = np.einsum("ij,ij->i", np.cross(v1 - v0, v2 - v0), v0 + v1 + v2) < 0
    idx[inward] = idx[inward][:, [0, 2, 1]]
    return dict(positions=p.astype(np.float32), indices=idx.astype(np.uint32),
                normals=p.astype(np.float32))


def _quad(c, n, size) -> dict:
    """A square of side `size` centred at c, (v1 - v0) x (v2 - v0) along the
    unit n: 2 triangles."""

    c, n = np.asarray(c, np.float64), np.asarray(n, np.float64)
    ref = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    a = np.cross(n, ref)
    a /= np.linalg.norm(a)
    b = np.cross(n, a)
    h = size / 2.0
    quad = np.stack([c - h * a - h * b, c + h * a - h * b, c + h * a + h * b,
                     c - h * a + h * b])
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    p0, p1, p2 = quad[idx[0]]
    if np.dot(np.cross(p1 - p0, p2 - p0), n) < 0:
        idx = idx[:, [0, 2, 1]]
    return dict(positions=quad.astype(np.float32), indices=idx.astype(np.uint32),
                normals=None)


def floor_mesh() -> dict:
    """SPD's floor square at z = FLOOR_Z, facing +z."""

    return _quad((0.0, 0.0, FLOOR_Z), (0.0, 0.0, 1.0), 2.0 * FLOOR_HALF)


def light_mesh(k: int) -> dict:
    """Light k's emissive quad, centred at the light and facing the origin."""

    c = np.asarray(LIGHTS[k], np.float64)
    return _quad(c, -c / np.linalg.norm(c), LIGHT_SIZE)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def camera() -> dict:
    """SPD's view as the port's camera: +z forward (at - from), +y the up
    vector made orthogonal to it, x = y x z, origin `from`."""

    f, at = np.asarray(FROM, np.float64), np.asarray(AT, np.float64)
    z = _unit(at - f)
    y = _unit(np.asarray(UP, np.float64) - np.dot(UP, z) * z)
    x = np.cross(y, z)
    tr = np.zeros((3, 4), np.float64)
    tr[:, 0], tr[:, 1], tr[:, 2], tr[:, 3] = x, y, z, f
    lens = (FILM / 2.0) / math.tan(math.radians(ANGLE_DEG / 2.0))
    return dict(transform=tr.astype(np.float32), lens=lens, film=FILM,
                aspect=1.0, focus=float(np.linalg.norm(at - f)), aperture=0.0,
                is_orthographic=False)


def generate(seed: int = 0, size_factor: int = 5, subdivisions: int = 3) -> dict:
    materials = [
        material(color=SPHERE_COLOR + (1.0,), mat_type=GLOSSY, roughness=ROUGHNESS),
        material(color=FLOOR_COLOR + (1.0,), mat_type=MATTE),
        material(emission=(LIGHT_EMISSION,) * 3 + (0.0,)),
    ]
    meshes = [icosphere(subdivisions), floor_mesh()] + [
        light_mesh(k) for k in range(len(LIGHTS))]
    centres, radii = spheres(size_factor)
    frames = np.zeros((len(radii), 3, 4), np.float64)
    frames[:, [0, 1, 2], [0, 1, 2]] = radii[:, None]
    frames[:, :, 3] = centres
    insts = [(f.astype(np.float32), 0, 0) for f in frames]
    insts.append((frame_identity(), 1, 1))
    insts += [(frame_identity(), 2 + k, 2) for k in range(len(LIGHTS))]
    return scene(meshes, materials, insts, camera())
