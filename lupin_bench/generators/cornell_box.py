"""Lupin's built-in Cornell box (lupin_loader/src/loader.rs:14-207,
`build_scene_cornell_box`): the Yocto/GL box of 8 quad meshes (36
triangles), 4 materials (white, red, green, an emissive ceiling light) and
its one camera (lens 0.035, film 0.024, focus 3.9, aspect 1, at
(0, 1, -3.9)). A frozen copy of the port's `io/builtin.py`; the scene has
no random part, so the seed changes nothing in it.
"""

from __future__ import annotations

import numpy as np

from lupin_bench.scenes import frame_identity, material, scene

QUAD = [0, 1, 2, 2, 3, 0]
FLIPPED = [0, 2, 1, 2, 0, 3]
BOX = [0, 2, 1, 2, 0, 3, 4, 6, 5, 6, 4, 7,
       8, 10, 9, 10, 8, 11, 12, 14, 13, 14, 12, 15,
       16, 18, 17, 18, 16, 19, 20, 22, 21, 22, 20, 23]
WHITE, RED, GREEN, LIGHT = 0, 1, 2, 3

# (corners, indices, material) of each mesh, in the builder's order.
MESHES = [
    ([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]], QUAD, WHITE),  # floor
    ([[-1, 2, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1]], QUAD, WHITE),  # ceiling
    ([[-1, 0, 1], [1, 0, 1], [1, 2, 1], [-1, 2, 1]], FLIPPED, WHITE),  # back
    ([[1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]], QUAD, GREEN),  # right
    ([[-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]], QUAD, RED),  # left
    ([[0.53, 0.6, -0.75], [0.7, 0.6, -0.17], [0.13, 0.6, -0.0],
      [-0.05, 0.6, -0.57], [-0.05, 0.0, -0.57], [-0.05, 0.6, -0.57],
      [0.13, 0.6, -0.0], [0.13, 0.0, -0.0], [0.53, 0.0, -0.75],
      [0.53, 0.6, -0.75], [-0.05, 0.6, -0.57], [-0.05, 0.0, -0.57],
      [0.7, 0.0, -0.17], [0.7, 0.6, -0.17], [0.53, 0.6, -0.75],
      [0.53, 0.0, -0.75], [0.13, 0.0, -0.0], [0.13, 0.6, -0.0],
      [0.7, 0.6, -0.17], [0.7, 0.0, -0.17], [0.53, 0.0, -0.75],
      [0.7, 0.0, -0.17], [0.13, 0.0, -0.0], [-0.05, 0.0, -0.57]],
     BOX, WHITE),  # short box
    ([[-0.53, 1.2, -0.09], [0.04, 1.2, 0.09], [-0.14, 1.2, 0.67],
      [-0.71, 1.2, 0.49], [-0.53, 0.0, -0.09], [-0.53, 1.2, -0.09],
      [-0.71, 1.2, 0.49], [-0.71, 0.0, 0.49], [-0.71, 0.0, 0.49],
      [-0.71, 1.2, 0.49], [-0.14, 1.2, 0.67], [-0.14, 0.0, 0.67],
      [-0.14, 0.0, 0.67], [-0.14, 1.2, 0.67], [0.04, 1.2, 0.09],
      [0.04, 0.0, 0.09], [0.04, 0.0, 0.09], [0.04, 1.2, 0.09],
      [-0.53, 1.2, -0.09], [-0.53, 0.0, -0.09], [-0.53, 0.0, -0.09],
      [0.04, 0.0, 0.09], [-0.14, 0.0, 0.67], [-0.71, 0.0, 0.49]],
     BOX, WHITE),  # tall box
    ([[-0.25, 1.99, -0.25], [-0.25, 1.99, 0.25], [0.25, 1.99, 0.25],
      [0.25, 1.99, -0.25]], FLIPPED, LIGHT),  # light
]


def generate(seed: int = 0) -> dict:
    materials = [
        material(color=(0.725, 0.71, 0.68, 1.0)),
        material(color=(0.63, 0.065, 0.05, 1.0)),
        material(color=(0.14, 0.45, 0.091, 1.0)),
        material(emission=(17.0, 12.0, 4.0, 0.0)),
    ]
    meshes, insts = [], []
    for k, (corners, idx, mat) in enumerate(MESHES):
        meshes.append(dict(positions=np.asarray(corners, np.float32),
                           indices=np.asarray(idx, np.uint32).reshape(-1, 3),
                           normals=None))
        insts.append((frame_identity(), k, mat))
    cam = dict(transform=np.array([[1, 0, 0, 0], [0, 1, 0, 1.0], [0, 0, 1, -3.9]],
                                  np.float32),
               lens=0.035, film=0.024, aspect=1.0, focus=3.9, aperture=0.0,
               is_orthographic=False)
    return scene(meshes, materials, insts, cam)
