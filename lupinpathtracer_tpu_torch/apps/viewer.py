"""Headless viewer: camera paths, orbits, and AOV inspection.

The counterpart of lupinpathtracer_tpu/apps/viewer.py. The reference's
lupin_viewer (lupin_viewer/src/main.rs) is an interactive winit/egui app;
this app reproduces its capabilities headlessly: it renders an orbit frame
by frame, accumulating per frame (reset on movement, main.rs:494),
optionally renders the fast normals AOV for each "moving" frame
(main.rs:564-566) and denoises converged frames (main.rs:610). Frames stay
on the render device (`--device`, default cuda) through the denoiser and
the tonemap; PNG frames are written from host copies.

Usage:
  python -m lupinpathtracer_tpu_torch.apps.viewer scene.json --orbit 8 \
      --out frames/ --width 480 --accums 16 [--denoise] [--integrator mis]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import (
    BakedPathtraceParams,
    FalsecolorType,
    PathtraceDesc,
    PathtraceType,
)
from ..io import builtin, textures as tex_io, yocto_json
from ..render import renderer, tonemap
from ..scene.flatten import build_scene_torch


def orbit_transform(base: np.ndarray, angle: float) -> np.ndarray:
    """Rotate the camera frame around the world Y axis through the origin."""

    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = rot @ base[:, :3]
    out[:, 3] = rot @ base[:, 3]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--out", default="frames")
    p.add_argument("--orbit", type=int, default=8, help="frames in a full orbit")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--accums", type=int, default=16, help="accumulations per frame")
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--camera", type=int, default=0)
    p.add_argument(
        "--integrator",
        choices=["standard", "mis", "naive", "direct"],
        default="standard",
    )
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--preview-normals", action="store_true",
                   help="emit a 1-accum normals AOV per frame (the viewer's "
                        "falsecolor-while-moving preview)")
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--filmic", action="store_true")
    p.add_argument("--device", default="cuda", help="render device (cuda or cpu)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.scene:
        scene, cams = yocto_json.load_scene_yoctogl_v24(args.scene)
    else:
        scene, cams = builtin.build_scene_cornell_box()
    cam = cams[min(args.camera, len(cams) - 1)]
    ts = build_scene_torch(scene, device=device)

    W = args.width
    H = max(8, round(W / cam.params.aspect))
    os.makedirs(args.out, exist_ok=True)

    baked = BakedPathtraceParams(
        max_bounces=args.bounces, samples_per_pixel=args.spp
    )
    preview_baked = BakedPathtraceParams(max_bounces=1, samples_per_pixel=1)

    for f in range(args.orbit):
        angle = 2.0 * np.pi * f / args.orbit
        desc = PathtraceDesc()
        desc.camera_transform = orbit_transform(cam.transform, angle)
        desc.camera_params = cam.params
        desc.pathtrace_type = PathtraceType[args.integrator.upper()]
        t0 = time.time()

        if args.preview_normals:
            # Camera moved: fast normals falsecolor (main.rs:564-566).
            prev = renderer.pathtrace_scene_falsecolor(
                ts, renderer.new_accumulation_buffer(W, H, device), desc,
                preview_baked, FalsecolorType.NORMALS_UNSIGNED,
            )
            tex_io.save_texture(
                os.path.join(args.out, f"frame{f:03d}_preview.png"),
                prev.cpu().numpy(), srgb_encode=False,
            )

        # Accumulation restarts per frame (reset on movement, main.rs:494).
        img = torch.from_numpy(renderer.render_progressive(
            ts, desc, baked, W, H, args.accums, device=device)).to(device)

        if args.denoise:
            from ..denoise.atrous import denoise as atrous

            img = atrous(img)

        mapped = tonemap.tonemap(img, args.exposure, args.filmic, True)
        out_path = os.path.join(args.out, f"frame{f:03d}.png")
        tex_io.save_texture(out_path, mapped.cpu().numpy(), srgb_encode=False)
        print(f"frame {f + 1}/{args.orbit}: {time.time() - t0:.1f}s -> {out_path}",
              flush=True)


if __name__ == "__main__":
    main()
