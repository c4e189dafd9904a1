"""Edge-avoiding à-trous wavelet denoiser.

The counterpart of lupinpathtracer_tpu/denoise/atrous.py, which stands in
for the reference's OIDN integration (denoising.rs:4-499): an edge-avoiding
à-trous wavelet filter (Dammertz et al. 2010) over a noisy accumulation
buffer, optionally guided by the ALBEDO and NORMALS falsecolor AOVs (the
G-buffers the reference feeds OIDN, renderer.rs:844-870). Plain tensor
math on the input's device: 25 shifted taps per iteration, no kernel of
its own (the JAX version is jnp outside any Pallas kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class DenoiseDesc:
    """The reference's DenoiseDesc quality knob (denoising.rs:210-219);
    iterations plays the role of OIDN's quality setting."""

    iterations: int = 5
    sigma_color: float = 0.35
    sigma_albedo: float = 0.25
    sigma_normal: float = 0.35


_KERNEL = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)  # B3 spline


def _pad_shift(img, dy: int, dx: int):
    """img shifted by (dy, dx) with clamped edges."""

    h, w = img.shape[:2]
    ys = (torch.arange(h, device=img.device) - dy).clamp(0, h - 1)
    xs = (torch.arange(w, device=img.device) - dx).clamp(0, w - 1)
    return img[ys[:, None], xs[None, :]]


def _sq32(sigma) -> float:
    """sigma * sigma, rounded in float32 as the JAX package computes it."""

    s = np.float32(sigma)
    return float(s * s)


def denoise(color, albedo=None, normal=None, iterations: int = 5,
            sigma_color: float = 0.35, sigma_albedo: float = 0.25,
            sigma_normal: float = 0.35):
    """Denoises an (H, W, 3) HDR image; albedo and normal are optional
    (H, W, 3) guides on the same device (the reference treats them as
    optional too, denoising.rs:270-297). Iteration i uses taps 2^i apart."""

    guides = [(g, _sq32(s)) for g, s in ((albedo, sigma_albedo),
                                            (normal, sigma_normal))
              if g is not None]
    c2 = _sq32(sigma_color)
    out = color
    for it in range(iterations):
        step = 1 << it
        accum = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype,
                           device=out.device)
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                c = _pad_shift(out, dy, dx)
                w = torch.full(out.shape[:2], _KERNEL[ky] * _KERNEL[kx],
                               dtype=out.dtype, device=out.device)
                w = w * torch.exp(-((c - out) ** 2).sum(-1) / c2)
                for g, g2 in guides:
                    w = w * torch.exp(-((_pad_shift(g, dy, dx) - g) ** 2).sum(-1) / g2)
                accum = accum + c * w[..., None]
                wsum = wsum + w[..., None]
        out = accum / torch.clamp_min(wsum, 1e-8)
    return out
