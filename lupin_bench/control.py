"""The control of a cell's correctness numbers, for setting their limits.

The control is the reference put in the program's place, computed in
bfloat16 (the renderer computes in float32): on each seed it works out the
float32 reference and the bfloat16 control at the cell's sampled pixels,
over `--accumulations` accumulations (the image a run checks: the traffic's
accumulations an image, or fewer where a window finishes none), and the
whole frame's traced segments of the accumulation a run would count. It
prints the numbers check.py compares, one JSON line a seed, and holds them
to the cell's limits (check.verdict): the control has to come out not
correct on every seed, and the program exits with 1 where it does not. The
benchmark's runs do not run it.

    python3 lupin_bench/control.py --workload <name> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)


def control_numbers(cell: dict, seed: int, accums: int, device) -> dict:
    import numpy as np
    import torch

    from lupin_bench import check, scenes
    from lupin_bench.reference import Reference, frame_segments, progressive_pixels

    cfg, traffic = cell["config"], cell["traffic"]
    r = traffic["render"]
    W, H = int(traffic["width"]), int(traffic["height"])
    seed32 = seed & 0xFFFFFFFF
    desc = scenes.generate(cfg, seed % 2**64)
    two = bool(cfg["scene"]["two_level"])
    gx, gy = check.sample_pixels(seed % 2**64, 1, W, H,
                                 int(traffic["check"]["pixels"]), device)
    eps = float(np.float32(r["ray_epsilon"]))
    args = (int(r["max_bounces"]), float(np.float32(r["max_radiance"])))
    spp = int(traffic["spp"])
    c = check.checked_accumulation(seed % 2**64, accums)
    img, rays = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        ref = Reference(desc, two, device, dt)
        img[dt] = progressive_pixels(ref, desc["camera"], gx, gy, W, H, seed32,
                                     accums, spp, eps, *args)[0]
        rays[dt] = frame_segments(ref, desc["camera"], W, H, seed32, c, spp,
                                  eps, *args)
    f32, b16 = torch.float32, torch.bfloat16
    return {"radiance_mismatch_share": check.mismatch_share(img[b16], img[f32]),
            "radiance_sum_gap": check.sum_gap(img[b16], img[f32]),
            "segments_gap": check.segments_gap(rays[b16], rays[f32])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--accumulations", type=int, default=0,
                   help="accumulations of the checked image (default: the "
                        "traffic's accumulations an image)")
    args = p.parse_args(argv)

    import torch

    from lupin_bench import cells, check

    cell = cells.load(ROOT, args.workload)
    accums = args.accumulations or int(cell["traffic"]["accumulations"])
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    passed = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, accums, device)
        correct, checks = check.verdict(nums, cell["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "accumulations": accums, "correct": correct,
                          "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if correct:
            passed.append(seed)
    if passed:
        print(f"the control passed the check on seeds {passed}", file=sys.stderr)
        return 1
    print("the control failed the check on every seed", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
