"""Variants of kernel B4 on the card: what its split and its occupancy
bound buy.

    python3 -m lupinpathtracer_tpu_torch.tools.prof_packet [--reps N]

csrc/packet.cu walks the top tree by packets of 32 lanes, splits a packet
into per-lane walks where sub-chunks are at most PK_SPLIT_CHUNK triangles
and a popped leaf has fewer than PK_SPLIT owner lanes, and holds the
packets without the split to 7 blocks of 128 threads per SM. This tool
compiles copies of that source, each with one choice changed, into the
build directory (prof_pair.build_copies) and times each on the first
sample's camera batch (512x288) of terrain2M, instanced100k and
instanced2k, in turns (VARIANTS, then reversed):

  shipped    the checkout's source
  no_split   no packet splits (PK_SPLIT_CHUNK 0)
  split_all  the split on every scene (PK_SPLIT_CHUNK unbounded)
  per_ray    every packet splits at its first leaf, on every scene: the
             per-ray walk but for the packet's walk down to a first leaf
  no_bound   no occupancy bound (__launch_bounds__ without a block count)

Every copy computes the same function: each output must equal the shipped
build's bit for bit. One JSON line per variant and scene: the device ms of
each turn (torch.profiler) and their mean, the registers and spill bytes
ptxas reports for the four instantiations, and the card's name and power
limit. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..kernels import intersect, packet
from .prof_pair import build_copies, camera_rays, kernel_ms, ptxas_usage

_CHUNK = "constexpr int PK_SPLIT_CHUNK = 128;"
VARIANTS = {
    "shipped": (),
    "no_split": ((_CHUNK, "constexpr int PK_SPLIT_CHUNK = 0;"),),
    "split_all": ((_CHUNK, "constexpr int PK_SPLIT_CHUNK = 1 << 30;"),),
    "per_ray": ((_CHUNK, "constexpr int PK_SPLIT_CHUNK = 1 << 30;"),
                ("constexpr int PK_SPLIT = 8;", "constexpr int PK_SPLIT = 33;")),
    "no_bound": (("__launch_bounds__(PK_THREADS, SPLIT ? 6 : 7)",
                  "__launch_bounds__(PK_THREADS)"),),
}


def sweep(reps: int = 5):
    """Yields one dict per (scene, variant): the variants' device ms on
    each scene's camera batch, in turns. Raises if a variant's output
    differs from the shipped build's."""

    from .. import build_scene_torch
    from ..core.types import PathtraceDesc
    from ..io import synthetic

    dev = torch.device("cuda", 0)
    builds = {k: (packet.bind(lib), log)
              for k, (lib, log) in build_copies("packet", VARIANTS).items()}
    eps = float(np.float32(PathtraceDesc().advanced.ray_epsilon))
    scenes = {
        "terrain2M": lambda: synthetic.build_scene_terrain(n_tris=2_000_000, seed=0),
        "instanced100k": lambda: synthetic.build_scene_instanced_field(
            100_000, seed=0, tris_per_mesh=64),
        "instanced2k": lambda: synthetic.build_scene_instanced_field(
            2_000, seed=0, tris_per_mesh=64),
    }
    for name, make in scenes.items():
        cpu_scene, cams = make()
        scene = build_scene_torch(cpu_scene, device=dev)
        W = intersect.scene_tri_matrix(scene)
        ro, rd = camera_rays(cams[0], 512, 288, dev)
        attrs = not scene.two_level  # as the main path calls it

        def run(key):
            return packet._launch(builds[key][0], scene, ro, rd, eps, W, None, attrs)

        ref = run("shipped")
        times = {k: [] for k in VARIANTS}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for key in order:
                ms, out, _ = kernel_ms(lambda: run(key), "packet_kernel", reps)
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    raise AssertionError(f"B4 variant {key} changed the output on {name}")
                times[key].append(ms)
        for key in VARIANTS:
            yield dict(scene=name, variant=key, ms=float(np.mean(times[key])),
                       runs_ms=times[key], sub_chunk=scene.sl_stride // scene.sl_sub.shape[1],
                       registers_spills=list(ptxas_usage(builds[key][1]).values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_packet: no CUDA GPU available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for row in sweep(ns.reps):
        print(json.dumps(dict(**row, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
