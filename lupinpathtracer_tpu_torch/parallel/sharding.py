"""Multi-device rendering: image tiles or sample sets over a device mesh.

The counterpart of lupinpathtracer_tpu/parallel/sharding.py. The reference
is single-GPU; its scaling axis is the spatial tile loop (renderer.rs:
651-670, TileParams). The JAX package maps that axis onto a 1-D `tiles`
mesh with `shard_map`: one controller drives the devices of one process.
The port keeps that shape without a process group: a mesh is a list of
`torch.device`, the scene is copied once to each distinct device, and one
process issues each entry's block in turn (on several GPUs the launches of
one entry are asynchronous to the next entry's host work; overlapping them
further is future work, ROADMAP.md). Entries may repeat, so one GPU holds a
mesh of n entries, and the CPU tests use ["cpu"] * n.

- mode="tiles": row block i of the image goes to entry i; per-pixel RNG
  streams are keyed by the absolute pixel index, so the image does not
  depend on the mesh size.
- mode="samples": every entry renders the full frame at sample offset
  i * spp, and the entries' frames are averaged on the first entry's
  device (the JAX package's `pmean`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import vec3 as v3c
from ..core.device import resolve_device
from ..core.types import BakedPathtraceParams, PathtraceDesc
from ..kernels import mega
from ..render import integrators
from ..render.renderer import _camera_args


def make_tile_mesh(num_devices: int | None = None, devices=None) -> list:
    """A mesh of `num_devices` entries taken in turn from `devices` (every
    visible CUDA device by default); without num_devices, one entry per
    device. make_tile_mesh(4) on a host with one GPU is four entries of
    cuda:0."""

    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises: no GPU and no devices given
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("make_tile_mesh: no devices")
    n = len(devices) if num_devices is None else int(num_devices)
    return [devices[i % len(devices)] for i in range(n)]


def _trace_block(scene, cam, gx, gy, W, H, accum_counter, rng_seed, ray_epsilon,
                 max_radiance, spp, max_bounces, ptype, is_ortho,
                 sample_offset=0):
    """Render a flat pixel batch (sharding.py:43-70): the megakernel (B3)
    where the scene passes its gate, else the wavefront loop."""

    pixel_idx = gy * W + gx
    ctx = integrators.make_ctx(scene, ray_epsilon)
    resolution = (float(W), float(H))
    if mega.applicable(scene, ptype):
        acc, _ = mega.mega_pathtrace_spp(
            scene, ctx["W"], pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            ray_epsilon, sample_offset=sample_offset,
        )
    else:
        acc, _ = integrators.pathtrace_spp(
            scene, ctx, pixel_idx, gx, gy, resolution, cam, is_ortho,
            accum_counter, rng_seed, spp, ptype, max_bounces, max_radiance,
            sample_offset=sample_offset,
        )
    return v3c.to_rows(acc / float(spp))


def _rows(y0: int, rows: int, width: int, device):
    """(gx, gy) of image rows y0 .. y0 + rows - 1, row-major."""

    xs = torch.arange(width, dtype=torch.int32, device=device)
    ys = y0 + torch.arange(rows, dtype=torch.int32, device=device)
    return (xs[None, :].expand(rows, width).reshape(-1),
            ys[:, None].expand(rows, width).reshape(-1))


def _blend(image, color, counter: int):
    """The progressive blend of the sharded step (sharding.py:127-130)."""

    color = torch.clamp_min(color, 0.0)
    if counter == 0:
        return color
    wgt = np.float32(1.0) / np.float32(max(counter, 1))
    return torch.clamp_min(image * float(np.float32(1.0) - wgt) + color * float(wgt),
                           0.0)


def make_sharded_render_step(mesh: list, width: int, height: int, spp: int,
                             max_bounces: int, ptype: int, is_ortho: bool,
                             mode: str = "tiles"):
    """Build a multi-device render step (sharding.py:73-142).

    Returns step(scenes, image, cam, counter, seed, eps, max_rad) -> image,
    where `scenes` maps each device of the mesh to the scene on it. In
    tiles mode `image` is the list of row blocks, block i on mesh[i]; in
    samples mode it is one (H, W, 3) tensor on mesh[0]."""

    n = len(mesh)
    if mode not in ("tiles", "samples"):
        raise ValueError(f"mode must be 'tiles' or 'samples', got {mode!r}")
    if height % n:
        raise ValueError(f"image height {height} must divide over {n} devices")
    rows = height // n

    def step(scenes, image, cam, counter, seed, eps, max_rad):
        args = (width, height, counter, seed, eps, max_rad, spp, max_bounces,
                ptype, is_ortho)
        if mode == "tiles":
            out = []
            for i, dev in enumerate(mesh):
                gx, gy = _rows(i * rows, rows, width, dev)
                color = _trace_block(scenes[dev], cam, gx, gy, *args)
                out.append(_blend(image[i], color.reshape(rows, width, 3), counter))
            return out
        parts = []
        for i, dev in enumerate(mesh):
            gx, gy = _rows(0, height, width, dev)
            parts.append(_trace_block(scenes[dev], cam, gx, gy, *args,
                                      sample_offset=i * spp))
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(mesh[0])
        return _blend(image, (total / n).reshape(height, width, 3), counter)

    return step


def render_progressive_sharded(scene, desc: PathtraceDesc,
                               baked: BakedPathtraceParams, width: int,
                               height: int, accumulations: int,
                               mesh: list | None = None, mode: str = "tiles"):
    """Multi-device counterpart of render_progressive (example1.rs:39-53);
    returns a numpy image."""

    if mesh is None:
        mesh = make_tile_mesh()
    mesh = [resolve_device(d) for d in mesh]
    scenes = {}
    for dev in mesh:
        if dev not in scenes:
            scenes[dev] = scene if scene.device == dev else scene.to(dev)
    step = make_sharded_render_step(
        mesh, width, height, int(baked.samples_per_pixel), int(baked.max_bounces),
        int(desc.pathtrace_type), bool(desc.camera_params.is_orthographic), mode=mode,
    )
    cam = _camera_args(desc)
    rows = height // len(mesh)
    if mode == "tiles":
        image = [torch.zeros((rows, width, 3), dtype=torch.float32, device=d)
                 for d in mesh]
    else:
        image = torch.zeros((height, width, 3), dtype=torch.float32, device=mesh[0])
    for i in range(accumulations):
        image = step(scenes, image, cam, i, int(desc.advanced.rng_seed),
                     float(np.float32(desc.advanced.ray_epsilon)),
                     float(np.float32(desc.advanced.max_radiance)))
    if mode == "tiles":
        return np.concatenate([b.cpu().numpy() for b in image], axis=0)
    return image.cpu().numpy()
