"""The BVH main paths alone on the card, for comparing checkouts.

    python3 lupinpathtracer_tpu_torch/tools/main_path.py [--root DIR]
        [--accums N] [--scenes terrain2M,instanced100k]

Renders chip_smoke.py's BVH main paths (terrain2M and instanced100k,
512x288, STANDARD, 4 spp, 8 bounces, max_radiance 10): one warm-up
accumulation, then N timed ones, each timed alone; prints one JSON line
per scene with the seconds of each accumulation, the traced segments and
the card's name and power limit. `--root` imports the package from another
checkout (e.g. an earlier commit unpacked with `git archive` under
`archive_check/`), so that two checkouts can be timed in turns on one card,
each in its own process: the script uses only entry points every slice of
the port has. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--accums", type=int, default=5)
    ap.add_argument("--scenes", default="terrain2M,instanced100k")
    ns = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(ns.root))

    import numpy as np
    import torch

    import lupinpathtracer_tpu_torch as lt
    from lupinpathtracer_tpu_torch.io import synthetic

    if not torch.cuda.is_available():
        print("main_path: no CUDA GPU available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    makers = {
        "terrain2M": lambda: synthetic.build_scene_terrain(n_tris=2_000_000, seed=0),
        "instanced100k": lambda: synthetic.build_scene_instanced_field(
            n_instances=100_000, seed=0, tris_per_mesh=64),
    }
    dev = torch.device("cuda", 0)
    baked = lt.BakedPathtraceParams(max_bounces=8, samples_per_pixel=4)
    for name in ns.scenes.split(","):
        scene, cams = makers[name]()
        ts = lt.build_scene_torch(scene, device=dev)
        desc = lt.PathtraceDesc()
        desc.camera_transform = cams[0].transform
        desc.camera_params = cams[0].params
        desc.pathtrace_type = lt.PathtraceType.STANDARD
        desc.advanced.max_radiance = 10.0
        lt.render_progressive(ts, desc, baked, 512, 288, 1, device=dev)
        walls, rays = [], 0
        for _ in range(ns.accums):
            stats: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = lt.render_progressive(ts, desc, baked, 512, 288, 1, device=dev,
                                        stats=stats)
            walls.append(time.perf_counter() - t0)
            rays = stats["rays"]
        print(json.dumps({"scene": name, "root": os.path.abspath(ns.root),
                          "s_per_accumulation": walls, "rays": rays,
                          "median_s": float(np.median(walls)),
                          "image_mean": float(img.mean()), "card": card}), flush=True)
        del ts
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
