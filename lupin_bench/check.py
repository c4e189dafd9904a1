"""The comparison that decides `correct`: what the window produced against
the plain reference (reference.py), on a sample of pixels drawn from the
seed, once the window has closed and the program's state is freed.

Numbers compared, each against its limit in limits/<workload>.json:

- radiance_mismatch_share: the share of sampled pixels of the image the
  window leaves (its last image done, every accumulation and sample) whose
  value departs from the reference's progressive image by more than RTOL
  relative plus ATOL absolute in some channel, among the pixels that are
  not black on both sides (a miss agrees at any precision);
- radiance_sum_gap: |the sampled pixels' sum - the reference's| as a share
  of the reference's (a part of the frame left out);
- segments_gap: for one accumulation of that image drawn from the seed,
  |the program's traced segments (its dispatch's stats["rays"]) - the
  reference's over every pixel of the frame|, as a share of the
  reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as refmod

RTOL = 1e-3
ATOL = 1e-4


def sample_pixels(seed: int, salt: int, W: int, H: int, n: int, device):
    """n distinct pixels (gx, gy) drawn from the seed."""

    rng = np.random.default_rng([seed, salt])
    idx = rng.choice(W * H, size=min(n, W * H), replace=False)
    t = torch.as_tensor(idx, device=device)
    return (t % W).to(torch.int32), (t // W).to(torch.int32)


def mismatch_share(prog, ref) -> float:
    """Share of the (P, 3) pixels off the reference, among those not black
    on both sides."""

    bad = ((prog - ref).abs() > ATOL + RTOL * ref.abs()).any(dim=-1)
    lit = (prog != 0).any(dim=-1) | (ref != 0).any(dim=-1)
    return float(bad.sum()) / max(int(lit.sum()), 1)


def sum_gap(prog, ref) -> float:
    r = float(ref.double().sum())
    return abs(float(prog.double().sum()) - r) / max(abs(r), 1e-30)


def segments_gap(prog_rays: int, ref_rays: int) -> float:
    return abs(prog_rays - ref_rays) / max(ref_rays, 1)


def checked_accumulation(seed: int, accums: int) -> int:
    """The accumulation whose segments are counted, drawn from the seed."""

    return int(np.random.default_rng([seed, 2]).integers(accums))


def progressive_numbers(prog_pixels, accums, unit_rays, ref, traffic, cam,
                        seed32, seed, gx, gy):
    """The pixels of the program's image of `accums` accumulations
    (counters 0 .. accums - 1) and its per-accumulation segments (unit
    k of the window ran counter k for k < accums) against the reference."""

    r = traffic["render"]
    W, H, spp = int(traffic["width"]), int(traffic["height"]), int(traffic["spp"])
    eps = float(np.float32(r["ray_epsilon"]))
    args = (int(r["max_bounces"]), float(np.float32(r["max_radiance"])))
    img, _ = refmod.progressive_pixels(ref, cam, gx, gy, W, H, seed32,
                                       accums, spp, eps, *args)
    c = checked_accumulation(seed, accums)
    rays = refmod.frame_segments(ref, cam, W, H, seed32, c, spp, eps, *args)
    return {"radiance_mismatch_share": mismatch_share(prog_pixels, img),
            "radiance_sum_gap": sum_gap(prog_pixels, img),
            "segments_gap": segments_gap(unit_rays[c], rays)}


def verdict(numbers: dict, limits: dict):
    """(correct, checks): each number beside its limit; a number over its
    limit, or not finite, is not correct."""

    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks
