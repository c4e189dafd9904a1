"""Golden-image regression runner.

The counterpart of lupinpathtracer_tpu/apps/golden_test.py (a rebuild of
the `lupin_tests` binary, lupin_tests/src/main.rs): discovers
`<dir>/<name>/<name>.json` scenes, renders every camera at the reference
workload (~1080p aspect-fit area, 1000 samples = 10 spp x 100
accumulations, 8 bounces, max_radiance 10; main.rs:29-33, :477-484) and
compares against checked-in `render_camN.hdr` goldens:

- headless (the reference opens a window);
- the comparator reports the reference's per-pixel RGB-distance criterion
  (epsilon = 5.0, compare_textures.wgsl:19-25), the gate, and relative
  RMSE, per pixel and box-averaged over 4x4 (an optional second gate);
- self-bootstrapping like the reference: missing goldens are rendered and
  saved (main.rs:176-186), `--overwrite_renders` regenerates them;
- large frames (and every `--ckpt` run) render tile by tile, with a
  checkpoint of the accumulation that a later run resumes; the
  checkpoint carries a hash of the package's source (`_code_sha`).

`--device` (default cuda) chooses the render device.

Usage:
  python -m lupinpathtracer_tpu_torch.apps.golden_test --scenes DIR
      [--scene NAME] [--first_camera_only] [--overwrite_renders]
      [--samples N] [--scale S] [--ckpt] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import math
import os
import sys
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import (
    BakedPathtraceParams,
    PathtraceDesc,
    PathtraceType,
    get_num_tiles,
)
from ..io import hdr as hdr_io
from ..io import yocto_json
from ..render import renderer
from ..scene.flatten import build_scene_torch

EPSILON = 5.0  # lupin_tests/src/main.rs:35
SAMPLES = 1000  # main.rs:29
SPP_PER_PASS = 10  # main.rs:31
BOUNCES = 8  # main.rs:32
MAX_RADIANCE = 10.0  # main.rs:33
RESOLUTION_TARGET = 1920 * 1080  # main.rs:477-484 (aspect-fit area)

# What the code hash reads: the sources of the compute path. build/ is
# skipped: nvcc and g++ fill it at first use, and hashing it would change
# the hash between a first and a second run.
_CODE_EXTS = (".py", ".cpp", ".cu", ".cuh")
_CODE_SHA_CACHE = None


def source_hash(pkg: str) -> str:
    """SHA-256 of the package's source files under `pkg` (their paths
    relative to it, and their bytes), build/ and this file left out."""

    h = hashlib.sha256()
    for root, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d not in ("build", "__pycache__"))
        for f in sorted(files):
            if f.endswith(_CODE_EXTS) and f != "golden_test.py":
                p = os.path.join(root, f)
                h.update(os.path.relpath(p, pkg).encode())
                with open(p, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


def _code_sha() -> str:
    """Content hash of the renderer package source, for checkpoint
    provenance. Docs/tools commits outside the package don't change it, so
    checkpoints survive unrelated commits; any change to the compute path
    invalidates them."""

    global _CODE_SHA_CACHE
    if _CODE_SHA_CACHE is None:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        _CODE_SHA_CACHE = source_hash(pkg)[:12]
    return _CODE_SHA_CACHE


def camera_resolution(aspect: float, target_area: int = RESOLUTION_TARGET):
    """Aspect-fit resolution (lupin_tests/src/main.rs:477-484)."""

    w = math.sqrt(target_area * aspect)
    return int(round(w)), int(round(w / aspect))


def align_for_scale(render: np.ndarray, scale_k: int) -> np.ndarray:
    """Sub-pixel alignment for reduced-scale comparisons.

    The reference's y flip (pixel.y = res.y - id.y + 0.5,
    pathtracer.wgsl:508) overshoots the film by half a pixel *of the render
    resolution*, so a render at 1/K scale sits (K-1)/K of a pixel below the
    box-downsampled golden. Full-resolution comparisons (K == 1) need no
    correction."""

    if scale_k <= 1:
        return render
    s = (scale_k - 1) / scale_k
    a0 = np.roll(render, -0, axis=0)
    a1 = np.roll(render, -1, axis=0)
    out = a0 * (1 - s) + a1 * s
    return out[:-1]  # drop the wrapped last row


def compare(render: np.ndarray, golden: np.ndarray):
    """Returns (max RGB distance, per-pixel relative RMSE, ds4 relative
    RMSE).

    Per-pixel RMSE at test spp is Monte-Carlo-noise dominated (~11-15% at
    160 vs 1000 spp even for a bit-correct renderer); the ds4 metric box-
    averages 4x4 pixels first so structure dominates noise."""

    diff = render[..., :3] - golden[..., :3]
    dist = np.sqrt((diff**2).sum(-1))
    rmse = float(np.sqrt((diff**2).mean()))
    denom = float(np.sqrt((golden[..., :3] ** 2).mean())) or 1.0

    h, w = render.shape[0] // 4 * 4, render.shape[1] // 4 * 4
    r4 = render[:h, :w, :3].reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
    g4 = golden[:h, :w, :3].reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
    rmse4 = float(np.sqrt(((r4 - g4) ** 2).mean()))
    denom4 = float(np.sqrt((g4**2).mean())) or 1.0
    return float(dist.max()), rmse / denom, rmse4 / denom4


def _render_tiled(ts, desc, baked, name, ci, w, h, accums, args, device):
    """The tiled, checkpointed accumulation loop (golden_test.py:187-270).
    Returns the image as numpy, or None when the camera's wall budget
    deferred it."""

    desc.tile_params.enabled = True
    desc.tile_params.tile_size = args.tile_size
    nx, ny = get_num_tiles(w, h, args.tile_size)
    image = renderer.new_accumulation_buffer(w, h, device)
    desc.accum_params.accumulate = True
    start_accum = 0
    ckpt_path = None
    if args.ckpt:
        # Resume support for long full-workload runs: the raw accumulation
        # average + counter fully define progress, so a killed run
        # restarts where it stopped.
        os.makedirs(args.out_dir, exist_ok=True)
        ckpt_path = os.path.join(args.out_dir, f"{name}_cam{ci}_{w}x{h}_ckpt.npz")
        if os.path.exists(ckpt_path):
            ck = np.load(ckpt_path, allow_pickle=False)
            ck_sha = str(ck["code_sha"]) if "code_sha" in ck else ""
            sha_ok = ck_sha == _code_sha() or os.environ.get("LUPIN_CKPT_ALLOW_STALE")
            if not sha_ok:
                # A checkpoint rendered by different code must not be
                # blended into a gate image: two renderer populations
                # blend into artifacts. Restart instead.
                print(f"    ckpt code_sha {ck_sha or '<none>'} != HEAD "
                      f"{_code_sha()}; discarding (LUPIN_CKPT_ALLOW_STALE=1 "
                      "overrides)", flush=True)
            elif ck["image"].shape[:2] == (h, w) and int(
                    ck["spp_per_pass"]) == SPP_PER_PASS:
                image = torch.from_numpy(ck["image"]).to(device)
                start_accum = int(ck["counter"])
                print(f"    resumed at accum {start_accum}/{accums}", flush=True)

    t_cam0 = t_last = time.time()
    for i in range(start_accum, accums):
        desc.accum_params.counter = i
        for t in range(nx * ny):
            desc.tile_params.tile_idx = t
            image = renderer.pathtrace_scene(ts, image, desc, baked)
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # bound the queue depth
        over_budget = (
            args.cam_budget_secs is not None
            and i + 1 < accums
            and time.time() - t_cam0 > args.cam_budget_secs
        )
        if ckpt_path and (i + 1 == accums or over_budget
                          or time.time() - t_last > args.ckpt_secs):
            np.savez(ckpt_path + ".tmp.npz", image=image.cpu().numpy(),
                     counter=i + 1, spp_per_pass=SPP_PER_PASS,
                     code_sha=_code_sha())
            os.replace(ckpt_path + ".tmp.npz", ckpt_path)
            t_last = time.time()
            print(f"    ckpt @ accum {i + 1}/{accums}", flush=True)
        if over_budget:
            # Per-camera wall budget: the checkpoint just written resumes
            # this camera on the next pass (exit code 2 signals "rerun me").
            print(f"    cam{ci}: budget {args.cam_budget_secs:.0f}s reached at "
                  f"accum {i + 1}/{accums}; deferred", flush=True)
            desc.tile_params.enabled = False
            return None
    desc.tile_params.enabled = False
    return image.cpu().numpy()


def run_scene(scene_dir, name, args):
    """Renders and compares every selected camera of one scene; returns
    [(name, camera, ok or "deferred", max_dist, ds4_rmse)]."""

    device = resolve_device(args.device)
    json_path = os.path.join(scene_dir, f"{name}.json")
    scene, cams = yocto_json.load_scene_yoctogl_v24(json_path)
    ts = build_scene_torch(scene, device=device)
    results = []
    cams = cams[:1] if args.first_camera_only else cams
    cam_filter = {int(c) for c in args.cameras.split(",")} if args.cameras else None
    for ci, cam in enumerate(cams):
        if cam_filter is not None and ci not in cam_filter:
            continue
        golden_path0 = os.path.join(scene_dir, f"render_cam{ci}.hdr")
        scale_k = max(1, int(round(1.0 / args.scale)))
        if os.path.exists(golden_path0):
            g0 = hdr_io.read_hdr(golden_path0)
            w, h = g0.shape[1] // scale_k, g0.shape[0] // scale_k
        elif args.scale != 1.0 and not args.overwrite_renders:
            # Nothing to compare against and not bootstrapping.
            print(f"  {name} cam{ci}: no golden; skipped")
            continue
        else:
            w, h = camera_resolution(cam.params.aspect)
            w = max(8, int(w * args.scale))
            h = max(8, int(h * args.scale))
        desc = PathtraceDesc()
        desc.camera_transform = cam.transform
        desc.camera_params = cam.params
        desc.pathtrace_type = PathtraceType.STANDARD
        desc.advanced.max_radiance = MAX_RADIANCE
        accums = max(1, args.samples // SPP_PER_PASS)
        baked = BakedPathtraceParams(max_bounces=BOUNCES, samples_per_pixel=SPP_PER_PASS)
        print(f"  {name} cam{ci}: {w}x{h} @ {accums * SPP_PER_PASS}spp", flush=True)
        if args.ckpt or w * h * SPP_PER_PASS > args.tile_threshold:
            img = _render_tiled(ts, desc, baked, name, ci, w, h, accums, args, device)
            if img is None:
                results.append((name, ci, "deferred", 0.0, 0.0))
                continue
        else:
            img = renderer.render_progressive(ts, desc, baked, w, h, accums,
                                              device=device)

        golden_path = golden_path0
        if not os.path.exists(golden_path) or args.overwrite_renders:
            if args.scale == 1.0:
                # Bootstrap like the reference (main.rs:176-186) but into
                # --out_dir: the scene tree may be read-only.
                os.makedirs(args.out_dir, exist_ok=True)
                golden_path = os.path.join(args.out_dir, f"{name}_render_cam{ci}.hdr")
                hdr_io.write_hdr(golden_path, img)
                print(f"    bootstrapped golden {golden_path}")
                results.append((name, ci, True, 0.0, 0.0))
                continue
            print(f"    no golden for cam{ci}; skipped")
            continue
        golden = hdr_io.read_hdr(golden_path)
        if golden.shape[:2] != img.shape[:2]:
            K = golden.shape[0] // img.shape[0]
            golden = (
                golden[: img.shape[0] * K, : img.shape[1] * K]
                .reshape(img.shape[0], K, img.shape[1], K, 3)
                .mean(axis=(1, 3))
            )
            img = align_for_scale(img, K)
            golden = golden[: img.shape[0]]
        max_dist, rel_rmse, rel_rmse4 = compare(img, golden)
        # The pass criterion is the reference's own gate: every pixel's RGB
        # distance <= epsilon (compare_textures.wgsl:19-25); the ds4-RMSE
        # gate is opt-in (--rmse_threshold).
        ok = max_dist <= EPSILON and (
            args.rmse_threshold is None or rel_rmse4 < args.rmse_threshold
        )
        results.append((name, ci, ok, max_dist, rel_rmse4))
        status = "OK" if ok else "FAIL"
        print(f"    cam{ci}: max_dist={max_dist:.3f} rel_rmse={rel_rmse:.4f} "
              f"ds4_rmse={rel_rmse4:.4f} [{status}]")
        if not ok:
            # Error renders go to --out_dir, never into the scene tree.
            os.makedirs(args.out_dir, exist_ok=True)
            err_path = os.path.join(args.out_dir, f"{name}_error_cam{ci}.hdr")
            hdr_io.write_hdr(err_path, img)
            print(f"    wrote {err_path}")
    return results


def _resize_box(img, h, w):
    """Box-filter downsample for reduced-scale comparisons."""

    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    fy = max(1, img.shape[0] // h)
    fx = max(1, img.shape[1] // w)
    out = np.zeros((h, w, img.shape[2]), np.float32)
    for dy in range(fy):
        for dx in range(fx):
            out += img[
                np.minimum(ys + dy, img.shape[0] - 1)[:, None],
                np.minimum(xs + dx, img.shape[1] - 1)[None, :],
            ]
    return out / (fy * fx)


def main(argv=None):
    """Runs the scenes; returns the results of run_scene. Exits 1 when a
    camera fails the gate and 2 when one was deferred."""

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenes", default="test_scenes",
                   help="directory of <name>/<name>.json scenes (the "
                        "reference corpus layout)")
    p.add_argument("--scene", default=None, help="run one scene by name")
    p.add_argument("--first_camera_only", action="store_true")  # main.rs:61-64
    p.add_argument("--overwrite_renders", action="store_true")  # main.rs:65-68
    p.add_argument("--samples", type=int, default=SAMPLES)
    p.add_argument("--scale", type=float, default=1.0,
                   help="resolution scale (goldens are box-downsampled)")
    p.add_argument("--rmse_threshold", type=float, default=None,
                   help="additionally gate on ds4 relative RMSE (e.g. 0.01); "
                        "default: the reference's epsilon gate only")
    p.add_argument("--tile_size", type=int, default=256,
                   help="dispatch tile for large frames")
    p.add_argument("--tile_threshold", type=int, default=4_000_000,
                   help="tile when W*H*spp_per_pass exceeds this")
    p.add_argument("--out_dir", default="out_golden",
                   help="where error renders and checkpoints are written")
    p.add_argument("--cameras", default=None,
                   help="comma-separated camera indices to run (default all)")
    p.add_argument("--ckpt", action="store_true",
                   help="checkpoint accumulation to out_dir and resume")
    p.add_argument("--ckpt_secs", type=float, default=120.0,
                   help="min seconds between checkpoints")
    p.add_argument("--cam_budget_secs", type=float, default=None,
                   help="per-camera wall budget: when an accumulation pass "
                        "exceeds it, checkpoint and defer to the next camera; "
                        "deferred cameras exit 2 so a retry loop resumes them")
    p.add_argument("--device", default="cuda", help="render device (cuda or cpu)")
    args = p.parse_args(argv)

    names = (
        [args.scene]
        if args.scene
        else sorted(
            d
            for d in os.listdir(args.scenes)
            if os.path.isfile(os.path.join(args.scenes, d, f"{d}.json"))
        )
    )
    all_results = []
    for name in names:
        print(f"scene {name}", flush=True)
        all_results += run_scene(os.path.join(args.scenes, name), name, args)

    deferred = [r for r in all_results if r[2] == "deferred"]
    failed = [r for r in all_results if not r[2]]
    print()
    if failed:
        print(f"Failure: {len(failed)}/{len(all_results)} camera renders differ")
        sys.exit(1)
    if deferred:
        print(f"Deferred: {len(deferred)}/{len(all_results)} cameras hit "
              "their wall budget; rerun to resume from checkpoints")
        sys.exit(2)
    print(f"Success: all {len(all_results)} camera renders match")
    return all_results


if __name__ == "__main__":
    main()
