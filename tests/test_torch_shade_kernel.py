"""The BVH route's shading step as one kernel launch a loop iteration
(kernels/shade.py, csrc/shade.cu), which render/integrators.py::_pathtrace_snd
takes where shade.applicable holds.

On the CPU: the gate's truth table over the scene's features, the
integrator and the tensors' device, and that it is B3's feature gate
(mega.in_gate) with BVH scenes in place of dense ones; the synthetic terrain
falls outside it and the two-level instanced field inside; the ctypes
mirrors of the kernel's structs; the material table is the attribute row's
material block; the loop counts its iterations by route (SHADE_STEPS) and a
CPU render launches nothing; the fused route, run on CPU tensors through the
step's plain version, equals the plain route bit for bit; the device reader
kernels.shade_ms_per_accum.

On the card (marked `gpu`; they skip without a CUDA GPU, and import no
JAX): the kernel against the PyTorch step on the same inputs at every loop
iteration of a render (the PCG state, the mask and the counters bit for
bit, the ray, weight, radiance and acc within rounding), the first
samples' states and rays against the PyTorch ones, whole renders
(n_traced and acc by chip_smoke's compare_paths rule) on SPD
tetra at size factor 5 and the two-level instanced field, STANDARD and
NAIVE, with one and two sample streams, and a tiled BVH dispatch; one
launch a loop iteration, and DIRECT and MIS keep the PyTorch step.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_shade_kernel.py
"""

import copy
import ctypes
import os
import re
import sys
import types

import pytest
import torch

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core.types import PathtraceType, TileParams
from lupinpathtracer_tpu_torch.io import builtin, synthetic
from lupinpathtracer_tpu_torch.kernels import cuda_build, mega, shade
from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
from lupinpathtracer_tpu_torch.render import integrators, renderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lupin_bench import cells, port, scenes  # noqa: E402

STANDARD, NAIVE = PathtraceType.STANDARD, PathtraceType.NAIVE
PTYPES = {"standard": STANDARD, "naive": NAIVE}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- gate ---


def _features(**kw):
    """A scene's gate-relevant flags: a single-level BVH scene with two
    light triangles inside every clause, changed by kw."""

    f = dict(use_bvh=True, instances_empty=False, has_alpha=False, envs_empty=True,
             any_volumetric=False, any_delta=False, any_normal_maps=False,
             any_vert_colors=False, num_textures=0, any_uv=False,
             lights_empty=False, lt_v0=torch.zeros(3, 2))
    f.update(kw)
    return types.SimpleNamespace(**f)


CUDA_LIKE = types.SimpleNamespace(is_cuda=True)
REGEN = dict(spp=1)
# name: (feature changes, the integrator, in the gate)
GATE = {
    "bvh_standard": ({}, STANDARD, True),
    "bvh_naive": ({}, NAIVE, True),
    "bvh_direct": ({}, PathtraceType.DIRECT, False),
    "bvh_mis": ({}, PathtraceType.MIS, False),
    "no_lights": (dict(lights_empty=True), STANDARD, True),
    "64_light_tris": (dict(lt_v0=torch.zeros(3, 64)), STANDARD, True),
    "65_light_tris": (dict(lt_v0=torch.zeros(3, 65)), STANDARD, False),
    "alpha": (dict(has_alpha=True), STANDARD, False),
    "environment": (dict(envs_empty=False), STANDARD, False),
    "volumes": (dict(any_volumetric=True), STANDARD, False),
    "delta_materials": (dict(any_delta=True), NAIVE, False),
    "normal_maps": (dict(any_normal_maps=True), STANDARD, False),
    "vertex_colours": (dict(any_vert_colors=True), STANDARD, False),
    "uv_textures": (dict(num_textures=2, any_uv=True), STANDARD, False),
    "textures_without_uvs": (dict(num_textures=2), STANDARD, True),
    "uvs_without_textures": (dict(any_uv=True), NAIVE, True),
    "no_instances": (dict(instances_empty=True), STANDARD, False),
}


@pytest.mark.parametrize("case", list(GATE))
def test_gate_truth_table(case):
    """shade.applicable on a CUDA tensor of a regenerating loop is
    mega.in_gate on a BVH scene; B3 (mega.applicable) takes the same
    features of a dense scene and no BVH scene."""

    change, ptype, want = GATE[case]
    scene = _features(**change)
    assert shade.applicable(scene, ptype, REGEN, CUDA_LIKE) is want
    assert mega.in_gate(scene, ptype) is want
    assert not mega.applicable(scene, ptype)
    dense = _features(**dict(change, use_bvh=False))
    assert mega.applicable(dense, ptype) is want
    assert not shade.applicable(dense, ptype, REGEN, CUDA_LIKE)


@pytest.mark.parametrize("why", ["cpu_tensors", "no_regen"])
def test_gate_needs_cuda_tensors_and_regeneration(why):
    x = torch.zeros(1) if why == "cpu_tensors" else CUDA_LIKE
    regen = None if why == "no_regen" else REGEN
    for ptype in (STANDARD, NAIVE):
        assert not shade.applicable(_features(), ptype, regen, x)


def test_synthetic_terrain_is_outside_and_the_instanced_field_inside():
    """The terrain has reflective spheres (delta materials) and 242 light
    triangles, so it keeps the PyTorch step; the two-level field (matte
    instances, a two-triangle light) takes the fused one."""

    terrain = tl.build_scene_torch(synthetic.build_scene_terrain(n_tris=20_000)[0],
                                   device="cpu")
    assert terrain.use_bvh and terrain.any_delta
    assert terrain.lt_v0.shape[1] > mega.MAX_LIGHT_TRIS
    field = tl.build_scene_torch(
        synthetic.build_scene_instanced_field(n_instances=50)[0], device="cpu")
    assert field.use_bvh and field.two_level
    for ptype in (STANDARD, NAIVE):
        assert not shade.applicable(terrain, ptype, REGEN, CUDA_LIKE)
        assert shade.applicable(field, ptype, REGEN, CUDA_LIKE)


# ------------------------------------------------------ struct mirrors ---

_CTYPES = {"float": ctypes.c_float, "uint32_t": ctypes.c_uint32, "int": ctypes.c_int}


def _struct(name):
    """[(name, C type, length)] of `struct <name>` in csrc/shade.cu."""

    with open(f"{cuda_build.CSRC}/shade.cu") as f:
        src = f.read()
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        if "*" in decl:  # one pointer a declaration
            out.append((re.search(r"\*\s*(\w+)$", decl).group(1), "ptr", 1))
            continue
        typ, names = decl.split(None, 1)
        for n in names.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", n.strip())
            out.append((m.group(1), typ, int(m.group(2) or 1)))
    return out


def test_params_mirror_the_kernel_struct():
    got = []
    for name, ctype in shade._Params._fields_:
        if hasattr(ctype, "_length_"):
            got.append((name, ctype._type_, ctype._length_))
        else:
            got.append((name, ctype, 1))
    want = [(n, _CTYPES[t], k) for n, t, k in _struct("Params")]
    assert got == want
    assert ctypes.sizeof(shade._Params) == 4 * sum(k for _, _, k in want)
    # Every field is one of B3's, under its name (Step copies them by name).
    b3 = {n for n, _ in mega._Params._fields_}
    assert {n for n, _, _ in want} - b3 == set()


def test_lanes_mirror_the_kernel_struct():
    want = _struct("Lanes")
    assert all(t == "ptr" and k == 1 for _, t, k in want)
    assert [n for n, _ in shade._Lanes._fields_] == [n for n, _, _ in want]
    assert all(t is ctypes.c_void_p for _, t in shade._Lanes._fields_)


def test_state_rows_match_the_kernel():
    with open(f"{cuda_build.CSRC}/shade.cu") as f:
        src = f.read()
    f_rows = re.search(r"constexpr int (F_RO = .*?);", src).group(1)
    c_rows = re.search(r"constexpr int (C_BOUNCE = .*?);", src).group(1)
    assert f_rows == ", ".join(f"F_{n.upper()} = {3 * k}"
                               for k, n in enumerate(shade.F_FIELDS[:-1])) + \
        f", F_ACC = {3 * (len(shade.F_FIELDS) - 1)}"
    assert c_rows == ("C_BOUNCE = 0, C_SAMPLE = 1, C_N_BOUNCES = 2, C_N_TRACED = 3")
    assert shade.C_FIELDS == ("bounce", "sample_idx", "n_bounces", "n_traced")
    assert f"MAT_COLS = {shade.MAT_COLS};" in src


def test_material_table_is_the_attribute_rows_material_block():
    """Row m of the table holds the attribute row's columns ATTR_MAT_COLOR
    .. ATTR_MAT_IOR of every triangle of material m (the kernel's
    material_at reads both with the same offsets)."""

    cornell, _ = builtin.build_scene_cornell_box()
    ts = tl.build_scene_torch(cornell, device="cpu")
    tab = shade.pack_mat_table(ts)
    assert tab.shape == (ts.mat_type.shape[0], shade.MAT_COLS) and tab.is_contiguous()
    lo, hi = dk.ATTR_MAT_COLOR.start, dk.ATTR_MAT_IOR + 1
    rows = ts.wt_attr[: ts.num_world_tris, lo:hi]
    assert torch.equal(tab[ts.wt_mat[: ts.num_world_tris].long(), : hi - lo], rows)
    assert torch.equal(tab[:, hi - lo:], torch.zeros_like(tab[:, hi - lo:]))


# ---------------------------------------------------- the loop, on CPU ---


def _spd(device, sf=5):
    cfg = dict(scene=dict(generator="spd_tetra", args=dict(size_factor=sf),
                          two_level=False))
    d = scenes.generate(cfg, 3)
    ts, _ = port.build(d, False, device)
    desc = port.path_desc(d["camera"], dict(integrator="STANDARD", max_radiance=100.0,
                                            ray_epsilon=0.001), 7)
    return ts, desc


def _field(device):
    s, cams = synthetic.build_scene_instanced_field(n_instances=50)
    ts = tl.build_scene_torch(s, device=device)
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    return ts, desc


SCENES = {"spd": _spd, "field": _field}


def _render(ts, desc, ptype, W, H, spp, streams=1, counter=3, offset=0):
    """integrators.pathtrace_spp over a W x H frame: (acc, n_traced, the
    SHADE_STEPS and LAUNCHES["shade"] it added)."""

    dev = ts.wt_attr.device
    gx, gy = renderer._pixel_batch(W, H, 0, 0, dev)
    ctx = integrators.make_ctx(ts, 0.001)
    steps, launches = dict(integrators.SHADE_STEPS), dict(shade.LAUNCHES)
    acc, nt = integrators.pathtrace_spp(
        ts, ctx, gy * W + gx, gx, gy, (float(W), float(H)), renderer._camera_args(desc),
        False, counter, 2**33 + 5, spp, ptype, 8, 100.0, sample_offset=offset,
        streams=streams)
    added = {k: integrators.SHADE_STEPS[k] - steps[k] for k in steps}
    firsts = shade.LAUNCHES["shade_first"] - launches["shade_first"]
    assert firsts == (1 if shade.LAUNCHES["shade"] > launches["shade"] else 0)
    return acc, nt, added, shade.LAUNCHES["shade"] - launches["shade"]


def _cpu_gate(scene, ptype, regen, x):
    """shade.applicable without its device clause: the fused route on CPU
    tensors, through the step's plain version."""

    return regen is not None and scene.use_bvh and mega.in_gate(scene, ptype)


@pytest.mark.parametrize("ptype", [STANDARD, NAIVE, PathtraceType.DIRECT,
                                   PathtraceType.MIS])
def test_cpu_render_counts_plain_steps_and_launches_nothing(ptype):
    """On CPU tensors every loop iteration takes the PyTorch step: one
    "plain" count per iteration (one bounce-loop sync fewer than the loop
    made), none "fused", no launch."""

    ts, desc = _spd("cpu")
    syncs = integrators.HOST_SYNCS["bounce_loop"]
    _, _, added, launched = _render(ts, desc, ptype, 16, 8, 2)
    iters = integrators.HOST_SYNCS["bounce_loop"] - syncs - 1
    assert added == {"fused": 0, "plain": iters} and iters > 0
    assert launched == 0


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("ptype", list(PTYPES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_fused_route_plain_version_equals_the_plain_route(monkeypatch, scene, ptype,
                                                          streams):
    """The fused route's loop (the step's buffers, slot A in place, the
    trace on them, the result's rows) with the step's plain version equals
    the plain route bit for bit, one "fused" count an iteration, no launch."""

    ts, desc = SCENES[scene]("cpu")
    acc0, nt0, plain, _ = _render(ts, desc, PTYPES[ptype], 24, 16, 2, streams)
    monkeypatch.setattr(shade, "applicable", _cpu_gate)
    acc1, nt1, fused, launched = _render(ts, desc, PTYPES[ptype], 24, 16, 2, streams)
    assert torch.equal(nt0, nt1)
    assert all(torch.equal(a, b) for a, b in zip(acc0, acc1))
    assert fused == {"fused": plain["plain"], "plain": 0} and plain["fused"] == 0
    assert launched == 0


# ---------------------------------------------------------- the reader ---


def _rec(events, units=2):
    tr = dict(events=events, units=units, wall_s=1e-3, t0_ns=0, t1_ns=10**6, spans=[])
    return dict(loop="progressive", setup=dict(scene_build_s=0.0),
                window=dict(peak_above_bytes=0), trace=tr)


def test_shade_reader():
    """Device ms of lupin_shade_kernel records per traced accumulation;
    None on a Cornell window (B3 and glue), on a BVH window of a program
    without the kernel, and untraced."""

    read = cells.reader("kernels.shade_ms_per_accum")
    k = "void (anonymous namespace)::lupin_shade_kernel(Params, Lanes, float const*, Lights)"
    bvh = [("void pair_hit_kernel(PairArgs, PairSplit)", 0, 3_000),
           ("void at::native::vectorized_elementwise_kernel<4>(...)", 3_000, 4_000)]
    assert read(_rec(bvh + [(k, 5_000, 6_000), (k, 7_000, 10_000)])) == pytest.approx(2e-3)
    cornell = [("void (anonymous namespace)::mega_kernel<true, true>(Params)", 0, 78_000),
               ("void at::native::reduce_kernel<512, 1>(...)", 80_000, 82_000)]
    assert read(_rec(cornell)) is None
    assert read(_rec(bvh)) is None
    assert read(dict(_rec(bvh), trace=None)) is None


# ----------------------------------------------------------- on the card ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def _compare_paths(acc_k, nt_k, acc_p, nt_p):
    """chip_smoke's compare_paths and compare_dispatch rules: n_traced equal
    on at least 99.9% of lanes and the segments within 1e-4 of the PyTorch
    step's; acc within rtol 2e-4 / atol 2e-5 on at least 99.9% of values
    and its mean within 0.5%. Not every lane: on the card PyTorch divides a
    tensor by a host scalar as a multiply by the scalar's f32 reciprocal
    (the CPU divides, as the kernel and B3 do), so where the frame's height
    is not a power of two its camera rays differ from the kernel's by an
    ulp, and now and then one grazes a triangle the other misses (one lane
    of 12,288 on the field at 128x96)."""

    assert float((nt_k == nt_p).float().mean()) >= 0.999
    seg_k, seg_p = int(nt_k.sum()), int(nt_p.sum())
    assert abs(seg_k - seg_p) <= 1e-4 * seg_p, (seg_k, seg_p)
    a, b = torch.stack(list(acc_k)), torch.stack(list(acc_p))
    within = ((a - b).abs() <= 2e-5 + 2e-4 * b.abs()).float().mean()
    assert float(within) >= 0.999, float(within)
    mk, mp_ = float(a.mean()), float(b.mean())
    assert abs(mk - mp_) <= 0.005 * max(abs(mp_), 1e-12), (mk, mp_)


def _plain_gate(*args):
    return False


@pytest.mark.gpu
@pytest.mark.parametrize("ptype", list(PTYPES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_kernel_equals_the_plain_step_at_every_iteration(cuda_device, scene, ptype):
    """At each loop iteration of a render the kernel and the PyTorch step
    shade the same hit record from the same state: the PCG state, the mask
    and the four counters equal bit for bit, the ray, weight, radiance and
    acc within rounding. The kernel's state goes on to the next trace."""

    ts, desc = SCENES[scene](cuda_device)
    W, H, spp, ptype = 64, 48, 4, PTYPES[ptype]
    gx, gy = renderer._pixel_batch(W, H, 0, 0, cuda_device)
    ctx = integrators.make_ctx(ts, 0.001)
    regen = dict(gx=gx, gy=gy, resolution=(float(W), float(H)),
                 cam=renderer._camera_args(desc), is_ortho=False,
                 pixel_idx=gy * W + gx, accum_counter=3, rng_seed=2**33 + 5, spp=spp,
                 max_radiance=100.0, sample_offset=0)
    state = integrators.rng_mod.init_state(regen["pixel_idx"], 3, 2**33 + 5, 0)
    state, ro, rd = integrators._camera_ray_from(regen, state)
    p = integrators._Path(ts, ctx, ro, rd, state, regen)
    step = shade.Step(ts, ctx, p, ptype, 8)
    iters = 0
    while p.running(8):
        q, twin = copy.copy(p), copy.copy(step)
        twin.f, twin.c = step.f.clone(), step.c.clone()
        twin.state, twin.alive = step.state.clone(), step.alive.clone()
        twin._bind(q)
        launches = shade.LAUNCHES["shade"]
        step(p)
        twin._plain(q)
        assert shade.LAUNCHES["shade"] == launches + 1
        assert torch.equal(step.state, twin.state), iters
        assert torch.equal(step.alive, twin.alive), iters
        assert torch.equal(step.c, twin.c), iters
        torch.testing.assert_close(step.f, twin.f, rtol=2e-5, atol=2e-6, equal_nan=True)
        p.hit, p.attrs, _ = integrators.ray_skip_alpha(
            ts, ctx, p.ro, p.rd, p.state, p.alive, active=p.alive, coherent=False)
        iters += 1
    assert iters > 8  # respawns ran: spp samples of up to 9 segments


@pytest.mark.gpu
@pytest.mark.parametrize("H", [64, 48])
def test_first_rays_on_card(cuda_device, H):
    """The kernel's first samples against integrators._first_rays: the PCG
    state bit for bit; the rays bit for bit at a power-of-two frame, within
    an ulp's rounding elsewhere (PyTorch on the card divides by the frame's
    size as a multiply by its f32 reciprocal)."""

    ts, desc = _spd(cuda_device)
    W = 64
    gx, gy = renderer._pixel_batch(W, H, 0, 0, cuda_device)
    offs = torch.arange(W * H, device=cuda_device) % 3
    for off in (0, 7, offs):
        regen = dict(gx=gx, gy=gy, resolution=(float(W), float(H)),
                     cam=renderer._camera_args(desc), is_ortho=False,
                     pixel_idx=gy * W + gx, accum_counter=5, rng_seed=2**32 + 9, spp=4,
                     max_radiance=100.0, sample_offset=off)
        ctx = integrators.make_ctx(ts, 0.001)
        n = shade.LAUNCHES["shade_first"]
        s_k, ro_k, rd_k = shade.first_rays(ts, ctx, regen, STANDARD, 8)
        assert shade.LAUNCHES["shade_first"] == n + 1
        s_p, ro_p, rd_p = integrators._first_rays(regen)
        assert torch.equal(s_k, s_p)
        for a, b in zip((*ro_k, *rd_k), (*ro_p, *rd_p)):
            if H == 64:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# (scene, integrator, streams, sample offset)
RENDERS = {
    "spd_standard": ("spd", "standard", 1, 0),
    "spd_naive": ("spd", "naive", 1, 0),
    "spd_standard_two_streams": ("spd", "standard", 2, 0),
    "spd_standard_offset": ("spd", "standard", 1, 5),
    "field_standard": ("field", "standard", 1, 0),
    "field_naive": ("field", "naive", 1, 0),
    "field_naive_two_streams": ("field", "naive", 2, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(RENDERS))
def test_fused_render_matches_the_plain_render(cuda_device, monkeypatch, case):
    scene, ptype, streams, offset = RENDERS[case]
    ts, desc = SCENES[scene](cuda_device)
    acc_k, nt_k, fused, launched = _render(ts, desc, PTYPES[ptype], 128, 96, 4,
                                           streams, offset=offset)
    assert fused["plain"] == 0 and launched == fused["fused"] > 0
    monkeypatch.setattr(shade, "applicable", _plain_gate)
    acc_p, nt_p, plain, launched = _render(ts, desc, PTYPES[ptype], 128, 96, 4,
                                           streams, offset=offset)
    assert plain["fused"] == 0 and launched == 0
    _compare_paths(acc_k, nt_k, acc_p, nt_p)


@pytest.mark.gpu
@pytest.mark.parametrize("ptype", list(PTYPES))
def test_tiled_bvh_dispatch(cuda_device, monkeypatch, ptype):
    """An edge tile of a BVH frame through pathtrace_scene: the stored
    image and the segment count against the PyTorch step's."""

    ts, desc = _spd(cuda_device)
    desc.pathtrace_type = PTYPES[ptype]
    desc.tile_params = TileParams(enabled=True, tile_idx=7, tile_size=64)  # x 192-255
    desc.accum_params.counter = 2
    baked = tl.BakedPathtraceParams(max_bounces=8, samples_per_pixel=3)
    prev = torch.rand((150, 200, 3), generator=torch.Generator().manual_seed(1)).to(
        cuda_device)

    def dispatch():
        stats = {}
        img = tl.pathtrace_scene(ts, prev, desc, baked, stats)
        return img, stats["rays"]

    launches = shade.LAUNCHES["shade"]
    img_k, rays_k = dispatch()
    assert shade.LAUNCHES["shade"] > launches
    monkeypatch.setattr(shade, "applicable", _plain_gate)
    img_p, rays_p = dispatch()
    assert abs(rays_k - rays_p) <= 1e-4 * rays_p, (rays_k, rays_p)
    within = ((img_k - img_p).abs() <= 2e-5 + 2e-4 * img_p.abs()).float().mean()
    assert float(within) >= 0.999
    assert abs(float(img_k.mean()) - float(img_p.mean())) <= 0.005 * float(img_p.mean())


@pytest.mark.gpu
@pytest.mark.parametrize("ptype", [PathtraceType.DIRECT, PathtraceType.MIS])
def test_direct_and_mis_keep_the_pytorch_step_on_card(cuda_device, ptype):
    ts, desc = _spd(cuda_device)
    _, _, added, launched = _render(ts, desc, ptype, 32, 24, 2)
    assert added["fused"] == 0 and added["plain"] > 0 and launched == 0
