"""Texture load/save.

A copy of lupinpathtracer_tpu/io/textures.py (the port imports nothing of
the JAX package), a rebuild of the reference's texture IO
(lupin_loader/src/loader.rs:209-293 load_texture/load_texture_cpu,
:1775-1879 save_texture). PIL is imported only for LDR files, so .hdr
and .exr load and save without it. LDR formats
decode via PIL to raw unorm values (sRGB-encoded bytes / 255 — linearization
happens at sample time for color maps, matching pathtracer.wgsl:1294); HDR
uses the in-repo Radiance codec. There is no GPU texture object: everything
becomes (H, W, 4) float32 destined for the flat device atlas.
"""

from __future__ import annotations

import os

import numpy as np

from . import hdr as hdr_io
from ..scene.scene import TextureCPU

_HDR_EXTS = {".hdr", ".exr"}


def is_hdr_path(path) -> bool:
    return os.path.splitext(str(path))[1].lower() in _HDR_EXTS


def load_texture(path) -> TextureCPU:
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".hdr":
        rgb = hdr_io.read_hdr(path)
        data = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
        return TextureCPU(data=data.astype(np.float32), is_hdr=True)
    if ext == ".exr":
        from . import exr as exr_io

        return TextureCPU(
            data=exr_io.read_exr(path).astype(np.float32), is_hdr=True
        )
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGBA")
        arr = np.asarray(im, np.uint8).astype(np.float32) / 255.0
    return TextureCPU(data=arr, is_hdr=False)


def save_texture(path, data: np.ndarray, srgb_encode: bool = True) -> None:
    """Save (H,W,3|4) float image. HDR extensions write linear Radiance HDR;
    LDR extensions optionally sRGB-encode then quantize (loader.rs:1775-1879
    drops alpha for LDR; we keep that behavior)."""

    data = np.asarray(data, np.float32)
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".hdr":
        hdr_io.write_hdr(path, data[..., :3])
        return
    if ext == ".exr":
        from . import exr as exr_io

        exr_io.write_exr(path, data)
        return
    from PIL import Image

    rgb = np.clip(data[..., :3], 0.0, 1.0)
    if srgb_encode:
        rgb = np.where(
            rgb <= 0.0031308, rgb * 12.92, 1.055 * np.power(rgb, 1 / 2.4) - 0.055
        )
    Image.fromarray((np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)).save(path)
