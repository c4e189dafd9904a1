"""The dense dispatch as one B3 launch (kernels/mega.py::mega_dispatch,
csrc/mega.cu's dispatch mode), which render/renderer.py takes on the card
for scenes inside the megakernel gate.

On the CPU: the launch's Params mirror the kernel's struct field by field;
the tile fields it passes give, through the kernel's lane -> pixel map,
_pixel_batch's pixels in _pixel_batch's order; pathtrace_scene on CPU
tensors keeps the plain route (integrators.pathtrace_spp and
_accumulate_and_store) and never launches the dispatch mode; the dispatch
mode refuses an image that is not float32 before any launch.

On the card (marked `gpu`; they skip without a CUDA GPU, and import no JAX):
the fused dispatch equals the acc-mode route it replaced (B3 in acc mode on
_pixel_batch's pixels, then _accumulate_and_store) bit for bit, over full
frames in swizzled and row-major order, an edge tile that runs past the
image, counters 0, 1 and 7, accumulate off, and with and without `stats`;
stats["rays"] equals the acc mode's n_traced sum; the count slot a
stream's next counted dispatch adds into is zero after each launch, and
a launch that fails leaves it in place; and the sharded steps, which keep
the acc mode, equal the fused dispatch.

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mega_dispatch.py
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core import vec3 as v3
from lupinpathtracer_tpu_torch.core.types import TileParams
from lupinpathtracer_tpu_torch.io import builtin
from lupinpathtracer_tpu_torch.kernels import cuda_build, intersect, mega
from lupinpathtracer_tpu_torch.parallel import sharding
from lupinpathtracer_tpu_torch.render import integrators, renderer
from lupinpathtracer_tpu_torch.tools import prof_mega

_CTYPES = {"float": ctypes.c_float, "uint32_t": ctypes.c_uint32, "int": ctypes.c_int}


def _kernel_params():
    """[(name, ctypes type, length)] of `struct Params` in csrc/mega.cu."""

    with open(f"{cuda_build.CSRC}/mega.cu") as f:
        src = f.read()
    body = re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        typ, names = decl.split(None, 1)
        for n in names.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", n.strip())
            out.append((m.group(1), _CTYPES[typ], int(m.group(2) or 1)))
    return out


def test_params_mirror_the_kernel_struct():
    got = []
    for name, ctype in mega._Params._fields_:
        if hasattr(ctype, "_length_"):
            got.append((name, ctype._type_, ctype._length_))
        else:
            got.append((name, ctype, 1))
    want = _kernel_params()
    assert got == want
    assert ctypes.sizeof(mega._Params) == 4 * sum(n for _, _, n in want)


def _desc(cams, tile=None, counter=0, accumulate=True, seed=12345):
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    if tile is not None:
        desc.tile_params = TileParams(enabled=True, tile_idx=tile[1], tile_size=tile[0])
    desc.accum_params.counter = counter
    desc.accum_params.accumulate = accumulate
    desc.advanced.rng_seed = seed
    return desc


def _kernel_lanes(f):
    """csrc/mega.cu lane_pixel over a dispatch's fields: (gx, gy) per lane."""

    lane = torch.arange(f["n_pix"], dtype=torch.int32)
    if f["swizzle"]:
        t, w, ntx = lane >> 8, lane & 255, f["tile_w"] >> 4
        return (f["tile_x"] + (t % ntx) * 16 + (w & 15),
                f["tile_y"] + torch.div(t, ntx, rounding_mode="floor") * 16 + (w >> 4))
    return (f["tile_x"] + lane % f["tile_w"],
            f["tile_y"] + torch.div(lane, f["tile_w"], rounding_mode="floor"))


# (image height, width, tile (size, index) or None, swizzled lane order)
GEOMETRY = {
    "full_512_swizzled": (512, 512, None, True),
    "full_500x300_row_major": (300, 500, None, False),
    "edge_tile_past_the_image": (300, 500, (128, 11), True),
    "inner_tile_row_major": (300, 500, (120, 5), False),
    "tile_larger_than_the_image": (40, 56, (64, 0), False),
}


@pytest.mark.parametrize("case", list(GEOMETRY))
def test_dispatch_fields_follow_pixel_batch(case):
    H, W, tile, swizzled = GEOMETRY[case]
    _, cams = builtin.build_scene_cornell_box()
    desc = _desc(cams, tile)
    (tw, th), (tx, ty) = renderer._tile_geometry((H, W, 3), desc)
    f = mega.dispatch_fields((H, W, 3), (tw, th), (tx, ty))
    assert mega.SWIZZLE == renderer._SWIZZLE_TILE
    assert bool(f["swizzle"]) == swizzled
    assert (f["img_w"], f["img_h"], f["n_pix"]) == (W, H, tw * th)
    gx, gy = renderer._pixel_batch(tw, th, tx, ty, "cpu")
    kx, ky = _kernel_lanes(f)
    assert torch.equal(kx, gx) and torch.equal(ky, gy)
    if case == "edge_tile_past_the_image":
        assert bool((gx >= W).any()) and bool((gy >= H).any())


def test_dispatch_fields_reject_pixels_past_int32():
    with pytest.raises(ValueError, match="int32"):
        mega.dispatch_fields((2**16, 2**15, 3), (2**15, 2**16), (0, 0))
    assert mega.dispatch_fields((2**16, 2**15 - 1, 3), (512, 512), (0, 0))["swizzle"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_dispatch_rejects_images_other_than_float32(dtype):
    """The dispatch mode stores float32 pixels; another image type is
    refused before any launch, not rendered some other way."""

    cornell, cams = builtin.build_scene_cornell_box()
    ts = tl.build_scene_torch(cornell, device="cpu")
    image = torch.zeros((16, 16, 3), dtype=dtype)
    cam = renderer._camera_args(_desc(cams))
    before = dict(mega.LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        mega.mega_dispatch(ts, image, cam, False, (0, 0), (16, 16), 0, 0, 2,
                           tl.PathtraceType.STANDARD, 4, 10.0, 1e-3, True, True)
    assert mega.LAUNCHES == before


def test_prof_mega_usage_reads_the_dispatch_mode():
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111mega_kernelILb{a}ELb{b}EEEv6Params' for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN12_GLOBAL__N_111mega_kernelILb{a}ELb{b}EEEv6Params\n"
        f"    16 bytes stack frame, {s} bytes spill stores, {s} bytes spill loads\n"
        f"ptxas info    : Used {r} registers, 528 bytes cmem[0]\n"
        for a, b, r, s in ((1, 0, 64, 36), (0, 0, 60, 0), (1, 1, 63, 32), (0, 1, 58, 4)))
    assert prof_mega.usage(log) == {"smem": (64, 36), "global": (60, 0),
                                    "smem.dispatch": (63, 32),
                                    "global.dispatch": (58, 4)}


def _plain(ts, image, desc, baked):
    """The plain route of a dense dispatch on CPU tensors, step by step."""

    _, (tw, th), (tx, ty) = renderer._dispatch_setup(ts, image, desc, baked)
    H, W = image.shape[:2]
    gx, gy = renderer._pixel_batch(tw, th, tx, ty, image.device)
    eps = float(np.float32(desc.advanced.ray_epsilon))
    ctx = integrators.make_ctx(ts, eps)
    spp = int(baked.samples_per_pixel)
    acc, nt = integrators.pathtrace_spp(
        ts, ctx, gy * W + gx, gx, gy, (float(W), float(H)), renderer._camera_args(desc),
        False, int(desc.accum_params.counter), int(desc.advanced.rng_seed), spp,
        int(desc.pathtrace_type), int(baked.max_bounces),
        float(np.float32(desc.advanced.max_radiance)))
    out = renderer._accumulate_and_store(
        image, v3.to_rows(acc / float(spp)), gx, gy, int(desc.accum_params.counter),
        bool(desc.accum_params.accumulate), full_frame=(tw, th) == (W, H))
    return out, int(nt.sum())


@pytest.mark.parametrize("case", ["full_swizzled", "full_row_major", "edge_tile"])
def test_cpu_dispatch_keeps_the_plain_route(case):
    H, W, tile = {"full_swizzled": (32, 32, None), "full_row_major": (12, 20, None),
                  "edge_tile": (20, 28, (16, 3))}[case]
    cornell, cams = builtin.build_scene_cornell_box()
    ts = tl.build_scene_torch(cornell, device="cpu")
    baked = tl.BakedPathtraceParams(max_bounces=4, samples_per_pixel=2)
    prev = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(3))
    desc = _desc(cams, tile, counter=3)
    before = dict(mega.LAUNCHES)
    stats = {}
    got = tl.pathtrace_scene(ts, prev, desc, baked, stats)
    assert mega.LAUNCHES == before and mega.LAUNCHES["mega_dispatch"] == 0
    want, rays = _plain(ts, prev, desc, baked)
    assert torch.equal(got, want) and stats["rays"] == rays


# ----------------------------------------------------------- on the card ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _prev_image(H, W, dev):
    """A previous image with the values the clamps treat apart: negatives,
    -0.0, NaN and infinities among uniform [0, 2) values."""

    g = torch.Generator().manual_seed(H * 1000 + W)
    img = 2.0 * torch.rand((H, W, 3), generator=g)
    flat = img.view(-1)
    special = torch.tensor([-1.5, -0.0, float("nan"), float("inf"), -float("inf"), 0.0])
    idx = torch.randperm(flat.numel(), generator=g)[:600]
    flat[idx] = special.repeat(100)
    return img.to(dev)


def _acc_route(ts, image, desc, baked):
    """The route the fused dispatch replaced: B3 in acc mode on
    _pixel_batch's pixels, then _accumulate_and_store. (image, rays)."""

    _, (tw, th), (tx, ty) = renderer._dispatch_setup(ts, image, desc, baked)
    H, W = image.shape[:2]
    gx, gy = renderer._pixel_batch(tw, th, tx, ty, image.device)
    spp = int(baked.samples_per_pixel)
    acc, nt = mega.mega_pathtrace_spp(
        ts, intersect.scene_tri_matrix(ts), gy * W + gx, gx, gy, (float(W), float(H)),
        renderer._camera_args(desc), False, int(desc.accum_params.counter),
        int(desc.advanced.rng_seed), spp, int(desc.pathtrace_type),
        int(baked.max_bounces), float(np.float32(desc.advanced.max_radiance)),
        float(np.float32(desc.advanced.ray_epsilon)))
    out = renderer._accumulate_and_store(
        image, v3.to_rows(acc / float(spp)), gx, gy, int(desc.accum_params.counter),
        bool(desc.accum_params.accumulate), full_frame=(tw, th) == (W, H))
    return out, int(nt.sum())


# (image height, width, tile (size, index) or None, counter, accumulate, stats)
CASES = {
    "full_512_swizzled_counter0": (512, 512, None, 0, True, True),
    "full_512_swizzled_counter1_no_stats": (512, 512, None, 1, True, False),
    "full_512_swizzled_counter7": (512, 512, None, 7, True, True),
    "full_512_swizzled_no_accumulate": (512, 512, None, 7, False, True),
    "full_500x300_row_major_counter0": (300, 500, None, 0, True, True),
    "full_500x300_row_major_counter7_no_stats": (300, 500, None, 7, True, False),
    "full_500x300_row_major_no_accumulate": (300, 500, None, 1, False, True),
    "edge_tile_counter0": (300, 500, (128, 11), 0, True, True),
    "edge_tile_counter7": (300, 500, (128, 11), 7, True, True),
    "edge_tile_counter1_no_accumulate_no_stats": (300, 500, (128, 11), 1, False, False),
    "inner_tile_row_major_counter7": (300, 500, (120, 5), 7, True, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_fused_dispatch_equals_the_acc_route_on_card(cuda_device, case):
    H, W, tile, counter, accumulate, with_stats = CASES[case]
    cornell, cams = builtin.build_scene_cornell_box()
    ts = tl.build_scene_torch(cornell, device=cuda_device)
    baked = tl.BakedPathtraceParams(max_bounces=8, samples_per_pixel=3)
    desc = _desc(cams, tile, counter, accumulate, seed=2**31 + 77)
    prev = _prev_image(H, W, cuda_device)
    kept = prev.clone()
    want, rays = _acc_route(ts, prev, desc, baked)
    for _ in range(3):  # both count slots, and the first again
        before = dict(mega.LAUNCHES)
        syncs = renderer.HOST_SYNCS["rays"]
        stats = {} if with_stats else None
        got = tl.pathtrace_scene(ts, prev, desc, baked, stats)
        torch.cuda.synchronize()
        assert mega.LAUNCHES["mega_dispatch"] == before["mega_dispatch"] + 1
        assert mega.LAUNCHES["mega_pathtrace_spp"] == before["mega_pathtrace_spp"] + 1
        assert renderer.HOST_SYNCS["rays"] == syncs + int(with_stats)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(prev), _bits(kept))
        if with_stats:
            assert stats["rays"] == rays
        assert all(int(slots[nxt]) == 0 for slots, nxt in mega._COUNTS.values())


@pytest.mark.gpu
def test_failed_launch_keeps_the_count_slot(cuda_device, monkeypatch):
    """A launch that fails raises and leaves the stream's next count slot
    where it was: that slot is still zero, and the next counted dispatch
    counts exactly its own segments."""

    cornell, cams = builtin.build_scene_cornell_box()
    ts = tl.build_scene_torch(cornell, device=cuda_device)
    baked = tl.BakedPathtraceParams(max_bounces=8, samples_per_pixel=2)
    desc = _desc(cams, counter=2)
    prev = _prev_image(64, 64, cuda_device)
    want, rays = _acc_route(ts, prev, desc, baked)
    tl.pathtrace_scene(ts, prev, desc, baked, {})  # the slots exist and hold a count
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    slots = mega._COUNTS[(cuda_device.index, stream)]
    nxt = slots[1]

    class FailingLib:
        @staticmethod
        def lupin_mega_dispatch(*args):
            return 700  # cudaErrorIllegalAddress

    real_load = cuda_build.load
    monkeypatch.setattr(cuda_build, "load", lambda name, bind=None: FailingLib)
    before = dict(mega.LAUNCHES)
    with pytest.raises(RuntimeError, match="mega_dispatch"):
        tl.pathtrace_scene(ts, prev, desc, baked, {})
    assert mega.LAUNCHES == before and slots[1] == nxt
    assert int(slots[0][nxt]) == 0
    monkeypatch.setattr(cuda_build, "load", real_load)
    stats = {}
    got = tl.pathtrace_scene(ts, prev, desc, baked, stats)
    assert stats["rays"] == rays and torch.equal(_bits(got), _bits(want))
    assert slots[1] == 1 - nxt and int(slots[0][slots[1]]) == 0


@pytest.mark.gpu
def test_sharded_steps_keep_the_acc_mode_and_equal_the_fused_dispatch(cuda_device):
    """The sharded steps launch B3 in acc mode only; one entry, in either
    mode, renders what render_progressive's fused dispatches render, bit
    for bit; two sample shards render the same image twice over."""

    cornell, cams = builtin.build_scene_cornell_box()
    ts = tl.build_scene_torch(cornell, device=cuda_device)
    baked = tl.BakedPathtraceParams(max_bounces=8, samples_per_pixel=2)
    desc = _desc(cams)
    fused = tl.render_progressive(ts, desc, baked, 64, 48, 3, device=cuda_device)
    n_fused = mega.LAUNCHES["mega_dispatch"]
    for mode in ("tiles", "samples"):
        one = sharding.render_progressive_sharded(
            ts, desc, baked, 64, 48, 3, mesh=[cuda_device], mode=mode)
        assert np.array_equal(one.view(np.int32), fused.view(np.int32))
    two = [sharding.render_progressive_sharded(
        ts, desc, baked, 64, 48, 3, mesh=[cuda_device] * 2, mode="samples")
        for _ in range(2)]
    assert np.array_equal(two[0], two[1]) and two[0].mean() > 0
    assert mega.LAUNCHES["mega_dispatch"] == n_fused
