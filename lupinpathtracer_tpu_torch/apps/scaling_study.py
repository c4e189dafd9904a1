"""Multi-device scaling study over a device mesh.

The counterpart of lupinpathtracer_tpu/apps/scaling_study.py. Renders a
fixed frame with the sharded step (parallel/sharding.py) at mesh sizes
1/2/4/8 (up to the mesh's length) in both modes:

- tiles:   row blocks of the image over the mesh (the reference's
           TileParams axis, renderer.rs:651-670, one tile per entry);
- samples: every entry renders the full frame at its own sample offset
           and the mesh averages the frames.

The mesh is every visible GPU, or with --cpu-mesh eight entries of the
CPU. Entries of one device are issued in turn and time-share it, so on
one GPU or on the CPU the meaningful invariant is that the total wall
time stays about flat as the mesh grows while each entry's work falls to
1/n; on several GPUs the wall time is the scaling. It asserts that the
tiles-mode images are identical across mesh sizes (per-pixel RNG streams
are keyed by the absolute pixel; SCALING.md). One JSON line per
configuration.

Usage: python -m lupinpathtracer_tpu_torch.apps.scaling_study [--width 128] ...
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--accums", type=int, default=2)
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="a mesh of eight CPU entries instead of the GPUs")
    ap.add_argument("--scene", default="cornell",
                    choices=("cornell", "terrain"),
                    help="cornell = dense megakernel path; terrain = "
                         "multi-superleaf BVH traversal (io/synthetic.py)")
    ap.add_argument("--tris", type=int, default=8192,
                    help="terrain triangle budget")
    args = ap.parse_args(argv)

    from ..core.types import BakedPathtraceParams, PathtraceDesc, PathtraceType
    from ..io import builtin
    from ..parallel.sharding import make_tile_mesh, render_progressive_sharded
    from ..scene.flatten import build_scene_torch

    full = make_tile_mesh(8, ["cpu"]) if args.cpu_mesh else make_tile_mesh()
    if args.scene == "terrain":
        from ..io.synthetic import build_scene_terrain

        scene, cams = build_scene_terrain(n_tris=args.tris, seed=0)
        ts = build_scene_torch(scene, device=full[0])
        assert ts.use_bvh and ts.sl_count > 1, "terrain must take the BVH path"
    else:
        scene, cams = builtin.build_scene_cornell_box()
        ts = build_scene_torch(scene, device=full[0])
    desc = PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.pathtrace_type = PathtraceType.STANDARD
    baked = BakedPathtraceParams(
        max_bounces=args.bounces, samples_per_pixel=args.spp
    )

    sizes = [n for n in (1, 2, 4, 8) if n <= len(full)]
    # Relative rates: pixels x spp x accumulations is the common numerator.
    work = args.width * args.height * args.spp * args.accums

    rows = []
    tiles = {}
    for mode in ("tiles", "samples"):
        for n in sizes:
            mesh = full[:n]
            render_progressive_sharded(  # warm-up (kernel builds, allocator)
                ts, desc, baked, args.width, args.height, 1, mesh=mesh, mode=mode)
            t0 = time.time()
            img = render_progressive_sharded(
                ts, desc, baked, args.width, args.height, args.accums,
                mesh=mesh, mode=mode,
            )
            dt = time.time() - t0
            if not (np.isfinite(img).all() and img.max() > 0):
                raise AssertionError(f"{mode} image at {n} devices is empty or "
                                     "not finite")
            if mode == "tiles":
                tiles[n] = img
            rows.append(dict(mode=mode, devices=n, device=str(mesh[0]),
                             wall_s=dt, paths_per_s=work / dt / 1e6))
            print(json.dumps(rows[-1]), flush=True)

    # Cross-mesh result parity: tiles mode gives the same image whatever
    # the mesh size.
    for n in sizes[1:]:
        if not np.array_equal(tiles[n], tiles[sizes[0]]):
            raise AssertionError(f"tiles-mode image at {n} devices differs")
    print("# tiles-mode images identical across mesh sizes", flush=True)
    return rows


if __name__ == "__main__":
    main()
