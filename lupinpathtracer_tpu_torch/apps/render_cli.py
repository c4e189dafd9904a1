"""Headless renderer CLI.

The counterpart of lupinpathtracer_tpu/apps/render_cli.py (a rebuild of
lupin_examples/example1, example1.rs:6-57): load or build a scene, run a
progressive accumulation loop, save the HDR result; with scene-file input,
camera/integrator/AOV selection, tiled rendering, multi-device sharding,
denoising and tonemapped output. The flags are the JAX CLI's, plus
`--device` (default cuda: the port's entry points run on the GPU unless
asked for the CPU). The image stays on the render device through the
denoiser and the tonemap; only the files are written from host copies.

Usage:
  python -m lupinpathtracer_tpu_torch.apps.render_cli [scene.json] \
      --out output.hdr --width 512 --height 512 --spp 5 --accums 200 \
      --bounces 8 --integrator standard --camera 0 [--falsecolor albedo]
      [--denoise] [--tonemap out.png] [--shard] [--tile-size 400]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core.device import resolve_device
from ..core.types import (
    BakedPathtraceParams,
    FalsecolorType,
    PathtraceDesc,
    PathtraceType,
    get_num_tiles,
)
from ..io import builtin, textures as tex_io, yocto_json
from ..render import renderer, tonemap
from ..scene.flatten import build_scene_torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene", nargs="?", default=None, help="Yocto JSON scene; Cornell box if omitted")
    p.add_argument("--out", default="output.hdr")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=0, help="0 = from camera aspect")
    p.add_argument("--spp", type=int, default=5)
    p.add_argument("--accums", type=int, default=200)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--camera", type=int, default=0)
    p.add_argument(
        "--integrator",
        choices=["standard", "mis", "naive", "direct"],
        default="standard",
    )
    p.add_argument("--falsecolor", default=None, help="AOV name (albedo, normals, ...)")
    p.add_argument("--max-radiance", type=float, default=100.0)
    p.add_argument("--ray-epsilon", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tile-size", type=int, default=0, help=">0 enables tiled dispatch")
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--tonemap", default=None, help="also save tonemapped PNG/JPG here")
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--filmic", action="store_true")
    p.add_argument("--shard", action="store_true",
                   help="shard row tiles over every visible GPU (over the "
                        "one CPU entry with --device cpu)")
    p.add_argument("--device", default="cuda", help="render device (cuda or cpu)")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns its seconds: scene load (JSON and PLY parse,
    textures), build_scene_torch, and the render loop."""

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    if args.scene:
        scene, cams = yocto_json.load_scene_yoctogl_v24(args.scene)
    else:
        scene, cams = builtin.build_scene_cornell_box()
    if not cams:
        raise SystemExit("scene has no cameras")
    cam = cams[min(args.camera, len(cams) - 1)]
    t1 = time.time()
    ts = build_scene_torch(scene, device=device)
    times = dict(load_s=t1 - t0, build_s=time.time() - t1)
    print(f"scene ready in {time.time() - t0:.1f}s "
          f"({ts.num_world_tris} world tris, bvh={ts.use_bvh})")

    W = args.width
    H = args.height or max(1, round(W / cam.params.aspect))

    desc = PathtraceDesc()
    desc.camera_transform = cam.transform
    desc.camera_params = cam.params
    desc.pathtrace_type = PathtraceType[args.integrator.upper()]
    desc.advanced.max_radiance = args.max_radiance
    desc.advanced.ray_epsilon = args.ray_epsilon
    desc.advanced.rng_seed = args.seed
    baked = BakedPathtraceParams(
        max_bounces=args.bounces, samples_per_pixel=args.spp
    )

    t0 = time.time()
    if args.falsecolor:
        fc = FalsecolorType[args.falsecolor.upper()]
        image = renderer.new_accumulation_buffer(W, H, device)
        for i in range(args.accums):
            desc.accum_params.accumulate = True
            desc.accum_params.counter = i
            image = renderer.pathtrace_scene_falsecolor(ts, image, desc, baked, fc)
    elif args.shard:
        from ..parallel.sharding import render_progressive_sharded

        image = torch.from_numpy(render_progressive_sharded(
            ts, desc, baked, W, H, args.accums,
            mesh=None if device.type == "cuda" else [device],
        )).to(device)
    elif args.tile_size > 0:
        desc.tile_params.enabled = True
        desc.tile_params.tile_size = args.tile_size
        nx, ny = get_num_tiles(W, H, args.tile_size)
        image = renderer.new_accumulation_buffer(W, H, device)
        for i in range(args.accums):
            desc.accum_params.accumulate = True
            desc.accum_params.counter = i
            for t in range(nx * ny):
                desc.tile_params.tile_idx = t
                image = renderer.pathtrace_scene(ts, image, desc, baked)
    else:
        image = torch.from_numpy(renderer.render_progressive(
            ts, desc, baked, W, H, args.accums, progress=True, device=device
        )).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = times["render_s"] = time.time() - t0
    spp_total = args.spp * args.accums
    print(f"rendered {W}x{H} @ {spp_total}spp in {dt:.1f}s "
          f"({W * H * spp_total / dt / 1e6:.1f} Mpaths/s)")

    if args.denoise:
        from ..denoise.atrous import denoise as atrous

        guide_baked = BakedPathtraceParams(max_bounces=1, samples_per_pixel=8)
        albedo, normal = (
            renderer.pathtrace_scene_falsecolor(
                ts, renderer.new_accumulation_buffer(W, H, device), desc,
                guide_baked, fc_type,
            )
            for fc_type in (FalsecolorType.ALBEDO, FalsecolorType.NORMALS)
        )
        image = atrous(image, albedo, normal)
        print("denoised")

    tex_io.save_texture(args.out, image.cpu().numpy(), srgb_encode=False)
    print(f"saved {args.out}")
    if args.tonemap:
        mapped = tonemap.tonemap(image, args.exposure, args.filmic, True)
        tex_io.save_texture(args.tonemap, mapped.cpu().numpy(), srgb_encode=False)
        print(f"saved {args.tonemap}")
    return times


if __name__ == "__main__":
    main()
