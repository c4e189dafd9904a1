"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version. Marked `gpu`; without a CUDA GPU every test skips. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: B1/B2 equal their plain versions exactly (same f32 operations
in the same order, kernels built with -fmad=false); B3 holds n_traced equal
on >= 99.9% of lanes and acc at rtol 2e-4 / atol 2e-5 there (the plain
version divides by Python scalars, which PyTorch on the card turns into a
reciprocal multiply), with its triangle table in shared memory (the Cornell
box) and read through L1 (the box with a 520-triangle sphere). The BVH
kernels B4-B7 equal their plain versions exactly on a 300k-triangle terrain
(several superleaves, four sub-chunks each): the same tables walked in the
same order with the same f32 arithmetic (B4's packets of lanes on a shared
stack visit exactly each lane's own nodes; B5 over resumed rounds with
Q = 8 and 32, with and without its histogram, its stack compared below
each lane's sp, the entries a later round reads). B6 also equals the
earlier design (B6' V0) bit for bit, with the sign pre-test on (eps > 0)
and off (eps = 0) and on an all-empty grid. Both BVH routes are also held
to closest_hit_bvh, the walk of the binary BVH (tolerances in that test).
Two-level scenes: on a 2,000-instance field B4's one two-level mode, B6
and B7 with the instance word and without it (rays moved to mesh space,
rows rotated, in PyTorch), and the B6' variants equal their plain versions
exactly (V1/V3 select with rsqrt: the
winner may differ on <= 1e-4 of hit lanes), and both routes are held to
closest_hit_brute_two_level. B1/B2 are also held on random soups of 36, 37,
556 and 2,047 triangles at batches of 0, 1, 31, 33 and 4,097 rays (with
and without the sign pre-test) and on all-miss batches, and B7 on
synthetic batches of 2,048 and 147,456 sorted positions (long segments;
~2 winners per superleaf), one item and no winner, with and without the
instance word and the tangent rows. The rest of the render API on a dense
box, a 20,000-triangle terrain and a 300-instance field: the MIS,
falsecolor and debug dispatches on the card against the same dispatch on
CPU tensors (>= 99% of pixels within 2e-3 and the mean within 1% for MIS,
within 1e-4 for the AOVs and 1e-5 for the heatmaps), count_traversal equal
to its plain version exactly, and sample streams K = 2 against K = 1 (the
traced segments equal, acc within rtol 3e-6 / atol 1e-6)."""

import numpy as np
import pytest
import torch

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core.vec3 import V3
from lupinpathtracer_tpu_torch.core import rng as rng_mod
from lupinpathtracer_tpu_torch.io import builtin, synthetic
from lupinpathtracer_tpu_torch.kernels import bvh
from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
from lupinpathtracer_tpu_torch.kernels import intersect, mega, packet
from lupinpathtracer_tpu_torch.render import integrators
from lupinpathtracer_tpu_torch.render.renderer import _camera_args, _pixel_batch
from lupinpathtracer_tpu_torch.tools import prof_pair, prof_top

EPS = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_b1_b2_kernels_match_plain_on_card(cuda_device):
    ts = tl.build_scene_torch(builtin.build_scene_cornell_box()[0], device=cuda_device)
    W = intersect.scene_tri_matrix(ts)
    rng = np.random.default_rng(4)
    ro = rng.uniform([-0.6, 0.3, -0.6], [0.6, 1.2, 0.6], (4096, 3)).T
    rd = rng.normal(size=(3, 4096))
    rd /= np.linalg.norm(rd, axis=0)

    def v(a):
        return V3(*(torch.tensor(c, dtype=torch.float32, device=cuda_device) for c in a))

    R = intersect.ray_features(v(ro), v(rd))
    k = dk.dense_closest_hit_attrs(W, ts.wt_attr, R, EPS)
    p = dk.dense_closest_hit_attrs_plain(W, ts.wt_attr[: W.shape[2]], R, EPS)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    for a, b in zip(dk.dense_closest_hit(W, R, EPS), k[:5]):
        assert torch.equal(a, b)


def _sphere_mesh(n_lat=14, n_lon=20):
    """A UV sphere of radius 1: (n_lat - 1) * n_lon * 2 triangles."""

    lat = np.linspace(0.15, np.pi - 0.15, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    pts = np.asarray([[np.sin(a) * np.cos(b), np.cos(a), np.sin(a) * np.sin(b)]
                      for a in lat for b in lon], np.float32)
    idx = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            idx += [[a, b, c], [b, d, c]]
    return tl.MeshCPU(positions=pts, indices=np.asarray(idx, np.int32),
                      normals=pts.copy(), texcoords=None, colors=None)


@pytest.mark.gpu
@pytest.mark.parametrize("sphere", [False, True], ids=["shared_table", "l1_table"])
def test_megakernel_matches_plain_on_card(cuda_device, sphere):
    scene, cams = builtin.build_scene_cornell_box()
    scene.instances[6].mat_idx = scene.add_material(tl.Material(
        color=np.array([0.8, 0.7, 0.6, 1.0], np.float32),
        mat_type=tl.MaterialType.GLOSSY, roughness=0.3, ior=1.5))
    if sphere:  # past the shared-memory table (csrc/mega.cu TRI_SMEM_TRIS)
        frame = np.zeros((3, 4), np.float32)
        frame[:, :3] = 0.25 * np.eye(3, dtype=np.float32)
        frame[:, 3] = (0.3, 1.2, 0.2)
        scene.instances.append(tl.InstanceCPU(
            frame=frame, mesh_idx=scene.add_mesh(_sphere_mesh()), mat_idx=0))
    ts = tl.build_scene_torch(scene, device=cuda_device)
    assert not ts.use_bvh and (ts.num_world_tris > 128) == sphere
    xs = torch.arange(32, dtype=torch.int32, device=cuda_device)
    gx, gy = xs.repeat(32), xs.repeat_interleave(32)
    pix = gy * 32 + gx
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    cam = _camera_args(desc)
    for ptype in (tl.PathtraceType.STANDARD, tl.PathtraceType.NAIVE):
        ctx = integrators.make_ctx(ts, EPS)
        args = (pix, gx, gy, (32, 32), cam, False, 1, 0, 2, int(ptype), 8, 10.0)
        acc_k, nt_k = mega.mega_pathtrace_spp(ts, ctx["W"], *args, EPS)
        acc_p, nt_p = integrators.pathtrace_spp(ts, ctx, *args)
        eq = nt_k == nt_p
        assert float(eq.float().mean()) >= 0.999
        for a, b in zip(acc_k, acc_p):
            torch.testing.assert_close(a[eq], b[eq], rtol=2e-4, atol=2e-5)


def _camera_rays(cams, w, h, dev):
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    gx, gy = _pixel_batch(w, h, 0, 0, dev)
    _, ro, rd = integrators._camera_ray_from(
        dict(cam=_camera_args(desc), is_ortho=False, gx=gx, gy=gy,
             resolution=(float(w), float(h))),
        rng_mod.init_state(gy * w + gx, 0, 0))
    return ro, rd


def _bounce_batch(ro, rd, t, gn):
    """Rays from the camera hits (the camera origin on misses) into random
    directions on the side of the geometric normal facing the camera."""

    dev = t.device
    d = np.random.default_rng(5).normal(size=(3, t.shape[0]))
    d /= np.linalg.norm(d, axis=0)
    d = V3(*(torch.tensor(c, dtype=torch.float32, device=dev) for c in d))
    flip = (d.x * gn.x + d.y * gn.y + d.z * gn.z) * (
        rd.x * gn.x + rd.y * gn.y + rd.z * gn.z) > 0.0
    d = V3(*(torch.where(flip, -c, c) for c in d))
    th = torch.where(t < dk.F32_MAX, t, 0.0)
    return V3(*(a + b * th for a, b in zip(ro, rd))), d


@pytest.fixture(scope="module")
def terrain_rays():
    """A 300k-triangle terrain on the card, its 128x72 camera rays and a
    bounce batch from their hits."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    dev = torch.device("cuda", 0)
    scene, cams = synthetic.build_scene_terrain(n_tris=300_000, seed=0)
    ts = tl.build_scene_torch(scene, device=dev)
    assert ts.use_bvh and not ts.top_root_is_leaf and ts.sl_sub.shape[1] > 1
    ro, rd = _camera_rays(cams, 128, 72, dev)
    W = intersect.scene_tri_matrix(ts)
    t, *_, ia = packet.packet_traverse(ts, ro, rd, EPS, W, with_attrs=True)
    return ts, W, (ro, rd), _bounce_batch(ro, rd, t, V3(*ia[bvh.IA_GN]))


@pytest.mark.gpu
def test_b4_packet_kernel_matches_plain_on_card(terrain_rays):
    """B4 (a packet of 32 lanes per warp on one shared stack) against the
    per-ray plain version on the camera rays and the bounce batch, with and
    without attributes, with inactive lanes, and on batches whose size is
    not a multiple of the packet."""

    ts, W, (ro, rd), (o, d) = terrain_rays
    B = ro.x.shape[0]
    act = torch.tensor(np.random.default_rng(6).random(B) < 0.9,
                       device=ro.x.device)
    for (O, D), attrs in (((ro, rd), True), ((ro, rd), False), ((o, d), False)):
        packet.LAUNCHES["packet_traverse"] = 0
        k = packet.packet_traverse(ts, O, D, EPS, W, active=act, with_attrs=attrs)
        p = packet.packet_traverse_plain(ts, O, D, EPS, W, active=act,
                                         with_attrs=attrs)
        assert packet.LAUNCHES["packet_traverse"] == 1
        assert bool((k[0] < dk.F32_MAX).any()) and len(k) == (6 if attrs else 5)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
    for n in (B - 37, 1, 33):
        O, D = V3(*(c[:n] for c in ro)), V3(*(c[:n] for c in rd))
        k = packet.packet_traverse(ts, O, D, EPS, W, with_attrs=True)
        p = packet.packet_traverse_plain(ts, O, D, EPS, W, with_attrs=True)
        for a, b in zip(k, p):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_b5_b6_b7_kernels_match_plain_on_card(terrain_rays):
    """One wavefront round of the bounce batch: B5 over two resumed rounds,
    B6 on the first round's superleaf-sorted pairs, B7 on the batch's
    winners, each kernel against its plain version."""

    ts, W, _, (o, d) = terrain_rays
    dev = o.x.device
    B = o.x.shape[0]
    pad = (-B) % intersect.WF_RAY_BLOCK
    o = V3(*(intersect._pad(c, pad, 0.0) for c in o))
    d = V3(intersect._pad(d.x, pad, 0.0), intersect._pad(d.y, pad, 1.0),
           intersect._pad(d.z, pad, 0.0))
    Bp, n_sl, SP, PB = B + pad, ts.sl_count, ts.sl_stride, intersect.WF_PAIR_BLOCK
    S, Q = bvh.stack_depth(ts), 4
    stack = torch.zeros((S, Bp), dtype=torch.int32, device=dev)
    sp = (torch.arange(Bp, device=dev) < B).to(torch.int32)
    best_t = torch.full((Bp,), dk.F32_MAX, device=dev)
    tab = ts.top_tab
    for rnd in range(2):
        # Both update their stack in place: each gets its own copy.
        k = bvh.top_traverse(tab, o, d, best_t, stack.clone(), sp, S=S, Q=Q,
                             n_sl=n_sl)
        p = bvh.top_traverse_plain(tab, o, d, best_t, stack.clone(), sp, S=S,
                                   Q=Q, n_sl=n_sl)
        # Stacks compared below each lane's sp: the entries a later round
        # reads (the kernel does not write entries pushed and popped within
        # the round).
        assert prof_top.max_abs_diff(k, p, S) == 0.0
        if rnd == 0:
            first = k
        stack, sp = k[2], k[3]
        best_t = torch.full((Bp,), 30.0, device=dev)

    sl, _, _, _, cnt_sl, _ = first
    key = torch.where(sl.reshape(-1) >= 0, sl.reshape(-1), n_sl)
    skey, order = torch.sort(key, stable=True)
    ray = order % Bp
    so, sd = V3(*(c[ray] for c in o)), V3(*(c[ray] for c in d))
    items = intersect._wf_work_items(skey, n_sl, PB, cnt_sl)
    blk, sl_k, lo, hi, _, n_items = items
    k = bvh.pair_intersect(blk, sl_k, lo, hi, so, sd, W, EPS, SP=SP,
                           pair_block=PB, n_items=n_items)
    p = bvh.pair_intersect_plain(blk, sl_k, lo, hi, so, sd, W, EPS, SP=SP,
                                 pair_block=PB, n_items=n_items)
    assert bool((k[0] < dk.F32_MAX).any())
    for a, b in zip(k, p):
        assert torch.equal(a, b)

    h = intersect.closest_hit_wavefront(ts, V3(*(c[:B] for c in o)),
                                        V3(*(c[:B] for c in d)), EPS, W=W,
                                        coherent=False)
    assert bool(h.hit.any())
    args, kw, _, _ = intersect._attr_fetch_args(ts, h)
    assert torch.equal(bvh.attr_fetch(*args, **kw),
                       bvh.attr_fetch_plain(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [1, 4], ids=["eight_lanes_per_ray", "one_lane_per_ray"])
@pytest.mark.parametrize("hist", [True, False], ids=["histogram", "no_histogram"])
@pytest.mark.parametrize("Q", [8, 32])
def test_b5_resumed_rounds_match_plain_on_card(terrain_rays, Q, hist, copies):
    """B5 over resumed rounds of the bounce batch until every stack drains,
    each round against its plain version on the same inputs (stacks
    compared below sp), the best t falling between rounds as the
    wavefront's would: a first round of Q = 8, then rounds of Q, as the
    wavefront's full-batch rounds hand their stragglers to rounds of
    WF_Q_TAIL = 32; with the demand histogram (the terrain's superleaf
    count) and without it (a count above HIST_MAX_SL). One copy of the
    batch (10,240 lanes) takes the kernel's eight lanes per ray; four
    copies are more rays than the card holds threads at eight lanes each
    and take one lane per ray (csrc/bvh.cu)."""

    ts, W, _, (o, d) = terrain_rays
    o, d = V3(*(c.repeat(copies) for c in o)), V3(*(c.repeat(copies) for c in d))
    dev = o.x.device
    B = o.x.shape[0]
    pad = (-B) % intersect.WF_RAY_BLOCK
    t_hit = intersect.closest_hit(ts, o, d, EPS, W=W, coherent=False).dst
    o = V3(*(intersect._pad(c, pad, 0.0) for c in o))
    d = V3(intersect._pad(d.x, pad, 0.0), intersect._pad(d.y, pad, 1.0),
           intersect._pad(d.z, pad, 0.0))
    t_hit = intersect._pad(t_hit, pad, dk.F32_MAX)
    Bp, S = B + pad, bvh.stack_depth(ts)
    n_sl = ts.sl_count if hist else bvh.HIST_MAX_SL + 1
    assert (bvh.hist_bins(n_sl) > 0) == hist
    stack = torch.zeros((S, Bp), dtype=torch.int32, device=dev)
    sp = (torch.arange(Bp, device=dev) < B).to(torch.int32)
    best_t = torch.full((Bp,), dk.F32_MAX, device=dev)
    rounds = 0
    while bool((sp > 0).any()):
        q = 8 if rounds == 0 else Q
        k = bvh.top_traverse(ts.top_tab, o, d, best_t, stack.clone(), sp, S=S,
                             Q=q, n_sl=n_sl)
        p = bvh.top_traverse_plain(ts.top_tab, o, d, best_t, stack.clone(), sp,
                                   S=S, Q=q, n_sl=n_sl)
        # Stacks compared below each lane's sp: the entries a later round
        # reads (the kernel does not write entries pushed and popped within
        # the round).
        assert prof_top.max_abs_diff(k, p, S) == 0.0
        stack, sp = k[2], k[3]
        # A lane's best t after the round's pairs: its hit once it emitted.
        best_t = torch.where(k[1] > 0, torch.minimum(best_t, t_hit), best_t)
        rounds += 1
    assert rounds >= 2


@pytest.mark.gpu
def test_bvh_routes_agree_on_card(terrain_rays):
    """The bounce batch through the sort wavefront (B5/B6) and through B4:
    the same hits (B4 also culls by sub-chunk boxes, so a grazing hit may
    differ on <= 0.1% of hit lanes), and the same t and attributes (B7 vs
    B4's fused phase) where the winners agree."""

    ts, W, _, (o, d) = terrain_rays
    h1, a1 = intersect.closest_hit_attrs(ts, o, d, EPS, W=W, coherent=False)
    h2, a2 = intersect.closest_hit_attrs(ts, o, d, EPS, W=W, coherent=True)
    n_hit = float(h1.hit.sum())
    assert n_hit > 0 and float((h1.hit != h2.hit).sum()) <= 1e-3 * n_hit
    same = (h1.tri == h2.tri) & h1.hit & h2.hit
    assert float(same.sum()) >= 0.999 * n_hit
    assert torch.equal(h1.dst[same], h2.dst[same])
    for x, y in ((a1.n.x, a2.n.x), (a1.gn.y, a2.gn.y), (a1.mat_id, a2.mat_id)):
        assert torch.equal(x[same], y[same])


@pytest.mark.gpu
def test_bvh_routes_match_stack_walk_on_card(terrain_rays):
    """Both BVH routes (B4; B5/B6) against closest_hit_bvh, the masked-stack
    walk of the binary BVH (plain PyTorch on the card), on the camera rays
    and the bounce batch: hit flags differing on <= 0.1% of hits, winners
    equal on >= 95% of hits, and t within rtol 5e-4 where they agree. The
    walk computes t with cross products, the kernels with the factored
    feature dot products. Camera rays: atol 1e-5, as the CPU tests hold the
    routes to JAX. Bounce rays start on the terrain 7-22 units from the
    world origin, where cancellation moves a t near eps by up to ~7e-4
    between the two formulations on a 300k-triangle terrain: atol 2e-3."""

    ts, W, (ro, rd), (o, d) = terrain_rays
    for (O, D), atol in (((ro, rd), 1e-5), ((o, d), 2e-3)):
        ref = intersect.closest_hit_bvh(ts, O, D, EPS)
        n_ref = float(ref.hit.sum())
        assert n_ref > 0
        for coherent in (False, True):
            h = intersect.closest_hit(ts, O, D, EPS, W=W, coherent=coherent)
            assert float((h.hit != ref.hit).sum()) <= 1e-3 * n_ref
            same = (h.tri == ref.tri) & h.hit & ref.hit
            assert float(same.sum()) >= 0.95 * n_ref
            torch.testing.assert_close(h.dst[same], ref.dst[same], rtol=5e-4,
                                       atol=atol)


# ---------------------------------------------------------------------------
# Two-level (instanced) scenes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def field_rays():
    """A 2,000-instance field on the card (two-level; B4 resident by the
    routing, B6/B7 with the instance word), its 128x72 camera rays and a
    bounce batch from their hits."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    dev = torch.device("cuda", 0)
    scene, cams = synthetic.build_scene_instanced_field(2_000, seed=0,
                                                        tris_per_mesh=64)
    ts = tl.build_scene_torch(scene, device=dev)
    assert ts.two_level
    ro, rd = _camera_rays(cams, 128, 72, dev)
    W = intersect.scene_tri_matrix(ts)
    h, ia = intersect.closest_hit_attrs(ts, ro, rd, EPS, W=W)
    assert bool(h.hit.any())
    return ts, W, (ro, rd), _bounce_batch(ro, rd, h.dst, ia.gn)


@pytest.mark.gpu
def test_b4_two_level_modes_match_plain_on_card(field_rays):
    """B4's one two-level mode (each leaf's gsl_meta row, rays moved to mesh
    space per owner lane) against its plain version on the camera rays and
    the bounce batch, with inactive lanes and a batch that is not a
    multiple of the packet; attributes are refused."""

    ts, W, (ro, rd), (o, d) = field_rays
    act = torch.tensor(np.random.default_rng(7).random(ro.x.shape[0]) < 0.8,
                       device=ro.x.device)
    for O, D, a in ((ro, rd, None), (o, d, None), (ro, rd, act)):
        packet.LAUNCHES["packet_traverse"] = 0
        k = packet.packet_traverse(ts, O, D, EPS, W, active=a)
        assert packet.LAUNCHES["packet_traverse"] == 1
        plain = packet.packet_traverse_plain(ts, O, D, EPS, W, active=a)
        assert bool((k[0] < dk.F32_MAX).any())
        for x, y in zip(k, plain):
            assert torch.equal(x, y)
    n = ro.x.shape[0] - 5
    O, D = V3(*(c[:n] for c in ro)), V3(*(c[:n] for c in rd))
    for x, y in zip(packet.packet_traverse(ts, O, D, EPS, W),
                    packet.packet_traverse_plain(ts, O, D, EPS, W)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="wavefront_fetch_attrs"):
        packet.packet_traverse(ts, ro, rd, EPS, W, with_attrs=True)


@pytest.mark.gpu
def test_b6_b7_instance_modes_match_plain_on_card(field_rays):
    """B6 with the instance word against its plain version and against B6
    on the same rays moved to mesh space in PyTorch (bvh.mesh_space); B7
    with the instance word against its plain version and against B7 in
    mesh space followed by the PyTorch rotation (bvh.rotate_rows)."""

    ts, W, _, (o, d) = field_rays
    args, kw, info = prof_pair.round1_state(ts, o, d)
    assert kw["inst"] is not None
    bvh.LAUNCHES["pair_intersect"] = 0
    k = bvh.pair_intersect(*args, W, EPS, **kw)
    assert bvh.LAUNCHES["pair_intersect"] == 1
    p = bvh.pair_intersect_plain(*args, W, EPS, **kw)
    assert bool((k[0] < dk.F32_MAX).any())
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    skey = info["skey"]
    m12 = ts.inst_inv.reshape(-1, 12)[
        ts.gsl_inst[skey.clamp(max=ts.sl_count - 1).long()].long()]
    mo, md = bvh.mesh_space(m12, args[4], args[5])
    kw0 = dict(kw, inst=None, txf_tab=None)
    pre = bvh.pair_intersect(*args[:4], V3(*mo), V3(*md), W, EPS, **kw0)
    for a, b in zip(k, pre):
        assert torch.equal(a, b)

    h = intersect.closest_hit(ts, o, d, EPS, W=W, coherent=False)
    args7, kw7, order, hitm = intersect._attr_fetch_args(ts, h)
    assert kw7["inst"] is not None
    rows = bvh.attr_fetch(*args7, **kw7)
    assert torch.equal(rows, bvh.attr_fetch_plain(*args7, **kw7))
    mesh = bvh.attr_fetch(*args7, **dict(kw7, inst=None, nrm_tab=None, ovr_tab=None))
    item = bvh.pair_item_map(args7[0], args7[2], args7[3], kw7["n_items"],
                             intersect.WF_PAIR_BLOCK, rows.shape[1])
    cov = item >= 0
    i = kw7["inst"].long()[item[cov]]
    rot = bvh.rotate_rows(mesh[:, cov], kw7["nrm_tab"][i], kw7["ovr_tab"][i])
    assert bool(cov.any()) and torch.equal(rot, rows[:, cov])
    ia = intersect.wavefront_fetch_attrs(ts, h)
    gn2 = ia.gn.x ** 2 + ia.gn.y ** 2 + ia.gn.z ** 2
    torch.testing.assert_close(gn2[h.hit], torch.ones_like(gn2[h.hit]),
                               rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("scene_name", ["terrain", "field"])
@pytest.mark.parametrize("split_units", [1, bvh.PAIR_SPLIT_UNITS, 1 << 16],
                         ids=["no_split", "default", "most_split"])
def test_b6_matches_plain_and_earlier_design_on_card(scene_name, split_units,
                                                     request, monkeypatch):
    """The redesigned B6 (a thread per sorted position) against
    pair_intersect_plain and B6' V0 (the earlier block-per-item design),
    bit for bit, on the bounce batch's first-round items: with the sign
    pre-test (eps > 0), without it (eps = 0), and on an all-empty grid;
    with the tiles never split, split as by default, and split into as many
    chunks as the superleaves allow (PAIR_SPLIT_UNITS). On the field
    several items share a block of positions."""

    monkeypatch.setattr(bvh, "PAIR_SPLIT_UNITS", split_units)
    ts, W, _, (o, d) = request.getfixturevalue(scene_name + "_rays")
    args, kw, info = prof_pair.round1_state(ts, o, d)
    blk, n_items = args[0], int(kw["n_items"])
    if scene_name == "field":
        assert n_items > int(torch.unique(blk[:n_items]).numel())
    for eps in (EPS, 0.0):
        k = bvh.pair_intersect(*args, W, eps, **kw)
        p = bvh.pair_intersect_plain(*args, W, eps, **kw)
        v0 = bvh.pair_intersect_variant("V0", *args, W, eps, **kw)
        assert bool((k[0] < dk.F32_MAX).any())
        for a, b, c in zip(k, p, v0):
            assert torch.equal(a, b) and torch.equal(a, c)
    e = bvh.pair_intersect(*args[:3], args[2], *args[4:], W, EPS, **kw)
    assert bool((e[0] == dk.F32_MAX).all()) and not bool(e[4].any())


@pytest.mark.gpu
def test_two_level_routes_match_brute_force_on_card(field_rays):
    """closest_hit on both routes against closest_hit_brute_two_level: hit
    flags differing on <= 0.1% of hits, t within rtol 1e-5 / atol 1e-5 where
    both hit (the same coefficient algebra; the reference sums its products
    in another order, which can move a grazing hit across a validity test),
    winners equal on >= 95% of hits (ties across instances)."""

    ts, W, (ro, rd), (o, d) = field_rays
    for O, D in ((ro, rd), (o, d)):
        step = O.x.shape[0] // 2048  # lanes from all over the frame
        O, D = V3(*(c[::step] for c in O)), V3(*(c[::step] for c in D))
        ref = intersect.closest_hit_brute_two_level(ts, O, D, EPS, W, chunk=64)
        n_ref = float(ref.hit.sum())
        assert n_ref > 0
        for coherent in (True, False):
            h = intersect.closest_hit(ts, O, D, EPS, W=W, coherent=coherent)
            assert float((h.hit != ref.hit).sum()) <= 1e-3 * n_ref
            both = h.hit & ref.hit
            torch.testing.assert_close(h.dst[both], ref.dst[both],
                                       rtol=1e-5, atol=1e-5)
            assert float((h.tri == ref.tri)[ref.hit].sum()) >= 0.95 * n_ref


@pytest.mark.gpu
@pytest.mark.parametrize("scene_name", ["terrain", "field"])
def test_pair_variants_match_plain_on_card(scene_name, request):
    """B6': V0 and V4 equal B6 bit for bit; every variant equals its plain
    version on what it returns (V1/V3: the winner on >= 1 - 1e-4 of hit
    lanes, the values exactly where it agrees)."""

    ts, W, _, (o, d) = request.getfixturevalue(scene_name + "_rays")
    args, kw, _ = prof_pair.round1_state(ts, o, d)
    assert (kw["inst"] is not None) == ts.two_level
    b6 = bvh.pair_intersect(*args, W, EPS, **kw)
    assert bool((b6[0] < dk.F32_MAX).any())
    bvh.LAUNCHES["pair_intersect_variant"] = 0
    for variant in bvh.PAIR_VARIANTS:
        k = bvh.pair_intersect_variant(variant, *args, W, EPS, **kw)
        p = bvh.pair_intersect_plain(*args, W, EPS, variant=variant, **kw)
        if variant in ("V0", "V4"):
            for a, b in zip(k, b6):
                assert torch.equal(a, b), variant
        if variant in ("V1", "V3"):
            hit = (k[0] < dk.F32_MAX) | (p[0] < dk.F32_MAX)
            same = k[4] == p[4]
            assert float((~same & hit).sum()) <= 1e-4 * float(hit.sum()), variant
            for a, b in zip(k, p):
                assert torch.equal(a[same], b[same]), variant
        else:
            for a, b in zip(k, p):
                assert torch.equal(a, b), variant
        if variant == "V2":
            assert torch.equal(k[0], b6[0]) and torch.equal(k[4], b6[4])
            assert not bool(k[1].any() or k[2].any() or k[3].any())
    assert bvh.LAUNCHES["pair_intersect_variant"] == len(bvh.PAIR_VARIANTS)
    # An all-empty grid leaves the prefilled miss in place.
    e = prof_pair.run_variant("GRID", args, W, EPS, kw)
    assert bool((e[0] == dk.F32_MAX).all()) and not bool(e[4].any())


def _dense_soup(T, seed, dev):
    """T random triangles in [-1, 1]^3 and their (T + 3, 128) attribute rows
    (three slack rows past T, as flatten pads the soup)."""

    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1.0, 1.0, (3, T))
    e1, e2 = rng.normal(0.0, 0.4, (2, 3, T))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return (intersect.build_tri_matrix(t(v0), t(e1), t(e2)),
            t(rng.normal(size=(T + 3, dk.ATTR_WIDTH))))


def _dense_rays(B, seed, dev, miss=False):
    """B rays from [-1.5, 1.5]^3 in random directions; with `miss`, rays
    from z = 10 pointing away from every triangle."""

    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (3, B))
    d = rng.normal(size=(3, B))
    if miss:
        o[2] = 10.0
        d[2] = np.abs(d[2]) + 0.1
    d /= np.linalg.norm(d, axis=0)
    return intersect.ray_features(
        V3(*(torch.tensor(c, dtype=torch.float32, device=dev) for c in o)),
        V3(*(torch.tensor(c, dtype=torch.float32, device=dev) for c in d)))


def _b1_b2_equal(W, A, R, eps):
    """B2 and B1 against their plain versions, every output equal; returns
    the hit count."""

    k = dk.dense_closest_hit_attrs(W, A, R, eps)
    p = dk.dense_closest_hit_attrs_plain(W, A[: W.shape[2]], R, eps)
    assert len(k) == len(p) == 6 and k[5].shape == (dk.ATTR_WIDTH, R.shape[0])
    for a, b in zip(k, p):
        assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(dk.dense_closest_hit(W, R, eps), k[:5]):
        assert torch.equal(a, b)
    return int((k[0] < dk.F32_MAX).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [EPS, 0.0], ids=["pretest", "eps0"])
@pytest.mark.parametrize("B", [0, 1, 31, 33, 4097])
@pytest.mark.parametrize("T", [36, 37, 556, 2047])
def test_b1_b2_match_plain_at_every_size_on_card(cuda_device, T, B, eps):
    """B1/B2 on random soups from the Cornell box's size to the dense gate's
    top (T not a multiple of 4: padded groups; above STAGE_GROUPS groups:
    several stages), batches that leave a warp or a block ragged, and eps = 0
    (no sign pre-test)."""

    W, A = _dense_soup(T, T, cuda_device)
    hits = _b1_b2_equal(W, A, _dense_rays(B, B + 1, cuda_device), eps)
    assert B < 31 or hits > 0


@pytest.mark.gpu
@pytest.mark.parametrize("T", [36, 37, 556, 2047])
def test_b1_b2_all_miss_batch_on_card(cuda_device, T):
    W, A = _dense_soup(T, T, cuda_device)
    assert _b1_b2_equal(W, A, _dense_rays(4097, 2, cuda_device, miss=True), EPS) == 0


def _attr_case(P_real, n_sl, n_msl, SP, hits, two_level, tangents, dev,
               one_key=False, seed=0):
    """B7's arguments for P_real sorted positions (padded to the pair block)
    of which `hits` are winners, spread over n_sl superleaves (sorted,
    misses keyed n_sl), items from _wf_work_items; each item's mesh
    superleaf is its superleaf modulo n_msl, and with `two_level` its
    instance its superleaf modulo 97, with random normal matrices and
    material overrides (-1: none)."""

    rng = np.random.default_rng(seed)
    PB = intersect.WF_PAIR_BLOCK
    P = -(-P_real // PB) * PB
    key = np.full(P, n_sl, np.int32)
    key[:hits] = 3 if one_key else np.sort(rng.integers(0, n_sl, hits))
    blk, sl_k, lo, hi, _, n_items = intersect._wf_work_items(
        torch.tensor(key, device=dev), n_sl, PB)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    li = torch.tensor(np.where(key < n_sl, rng.integers(0, SP, P), 0),
                      dtype=torch.int32, device=dev)
    hu, hv = f32(rng.random((2, P)) * 0.5)
    A3 = f32(rng.normal(size=(n_msl, SP, dk.ATTR_WIDTH)))
    kw = dict(pair_block=PB, with_tangents=tangents, n_items=n_items, inst=None,
              nrm_tab=None, ovr_tab=None)
    if two_level:
        kw.update(inst=sl_k % 97, nrm_tab=f32(rng.normal(size=(97, 9))),
                  ovr_tab=torch.tensor(rng.integers(-1, 6, 97), dtype=torch.int32,
                                       device=dev))
    return (blk, sl_k % n_msl, lo, hi, li, hu, hv, A3), kw


@pytest.mark.gpu
@pytest.mark.parametrize("tangents", [False, True], ids=["ia_rows", "ia_rows_nm"])
@pytest.mark.parametrize("two_level", [False, True], ids=["mesh", "instance_word"])
@pytest.mark.parametrize("case", ["straggler", "full", "field", "one_item", "no_hit"])
def test_b7_matches_plain_on_card(cuda_device, case, two_level, tangents):
    """B7 on a straggler-sized batch (2,048 positions), a full one (147,456)
    with long segments and with ~2 winners per superleaf (many items per
    tile), a single item, and a batch with no winner (one empty item)."""

    P, n_sl, n_msl, SP, hits = {
        "straggler": (2048, 50, 50, 64, 600),
        "full": (147_456, 300, 300, 256, 120_000),
        "field": (147_456, 60_000, 4, 64, 120_000),
        "one_item": (2048, 10, 10, 64, 100),
        "no_hit": (2048, 10, 10, 64, 0)}[case]
    args, kw = _attr_case(P, n_sl, n_msl, SP, hits, two_level, tangents,
                          cuda_device, one_key=case == "one_item")
    if case in ("one_item", "no_hit"):
        assert int(kw["n_items"]) == 1
    k = bvh.attr_fetch(*args, **kw)
    p = bvh.attr_fetch_plain(*args, **kw)
    assert k.shape == p.shape == (bvh.IA_ROWS_NM if tangents else bvh.IA_ROWS,
                                  args[4].shape[0])
    assert torch.equal(k, p)
    assert bool((k != 0).any()) == (hits > 0)


# ---------------------------------------------------------------------------
# The rest of the render API: MIS, sample streams, AOVs, debug heatmaps
# ---------------------------------------------------------------------------


_SMALL_SCENES = {
    "cornell": lambda: builtin.build_scene_cornell_box(),
    "terrain": lambda: synthetic.build_scene_terrain(n_tris=20_000, seed=0),
    "field": lambda: synthetic.build_scene_instanced_field(300, seed=0,
                                                           tris_per_mesh=64),
}


@pytest.fixture(scope="module")
def small_scenes():
    """{name: (scene on the card, the same scene on the CPU, cameras)}: the
    Cornell box (dense: B2), a 20,000-triangle terrain (B4-B7) and a
    300-instance field (two-level)."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    out = {}
    for name, make in _SMALL_SCENES.items():
        scene, cams = make()
        out[name] = (tl.build_scene_torch(scene, device=torch.device("cuda", 0)),
                     tl.build_scene_torch(scene, device="cpu"), cams)
    assert out["terrain"][0].use_bvh and out["field"][0].two_level
    return out


def _desc_of(cams, ptype):
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.pathtrace_type = ptype
    desc.advanced.max_radiance = 10.0
    return desc


def _image_close(card, cpu, atol, share=0.99, mean_rel=None):
    card = card.cpu().numpy()
    cpu = cpu.numpy()
    assert np.isfinite(card).all()
    assert (np.abs(card - cpu) <= atol).all(axis=-1).mean() >= share
    if mean_rel is not None:
        assert abs(card.mean() - cpu.mean()) <= mean_rel * cpu.mean()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_SMALL_SCENES))
def test_mis_dispatch_matches_cpu_on_card(small_scenes, name):
    """pathtrace_scene under MIS, 32x24, 2 spp, 4 bounces (B2 on the box;
    B4, B5, B6 and B7 on the terrain and the field), on the card against
    the same dispatch on CPU tensors: >= 99% of pixels within 2e-3 and the
    mean within 1% (the plain versions' float math differs between the
    card and the CPU in the last bits, and a ray that meets a tie may take
    another path)."""

    card, cpu, cams = small_scenes[name]
    desc = _desc_of(cams, tl.PathtraceType.MIS)
    baked = tl.BakedPathtraceParams(max_bounces=4, samples_per_pixel=2)
    out = [tl.pathtrace_scene(s, tl.new_accumulation_buffer(32, 24, device=s.device),
                              desc, baked) for s in (card, cpu)]
    assert float(out[1].mean()) > 0
    _image_close(*out, 2e-3, mean_rel=0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_SMALL_SCENES))
def test_falsecolor_dispatch_matches_cpu_on_card(small_scenes, name):
    """Every FalsecolorType, 32x24, 1 spp (B2 on the box, B4 with
    attributes on the terrain, B4 and B7 on the field), on the card against
    the same dispatch on CPU tensors: >= 99% of pixels within 1e-4."""

    card, cpu, cams = small_scenes[name]
    desc = _desc_of(cams, tl.PathtraceType.STANDARD)
    baked = tl.BakedPathtraceParams(samples_per_pixel=1)
    for fc in tl.FalsecolorType:
        out = [tl.pathtrace_scene_falsecolor(
            s, tl.new_accumulation_buffer(32, 24, device=s.device), desc, baked, fc)
            for s in (card, cpu)]
        _image_close(*out, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_SMALL_SCENES))
def test_debug_dispatch_matches_cpu_on_card(small_scenes, name):
    """The three debug heatmaps, 32x24 (count_traversal through B5/B6 on
    the terrain and the field; the non-regenerating STANDARD loop), on the
    card against the same dispatch on CPU tensors: >= 99% of pixels within
    1e-5."""

    card, cpu, cams = small_scenes[name]
    desc = _desc_of(cams, tl.PathtraceType.STANDARD)
    baked = tl.BakedPathtraceParams(max_bounces=4)
    for mode in ("tri_checks", "aabb_checks", "bounces"):
        out = [tl.pathtrace_scene_debug(
            s, tl.new_accumulation_buffer(32, 24, device=s.device), desc, baked,
            mode, heatmap_max=600.0 if mode == "tri_checks" else 40.0)
            for s in (card, cpu)]
        _image_close(*out, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["terrain", "field"])
def test_count_traversal_matches_plain_on_card(small_scenes, name):
    """count_traversal of the same 128x72 camera rays (made on the CPU)
    through the kernels on the card and through their plain versions on
    the CPU: equal exactly (B5 and B6 equal their plain versions, so every
    round visits the same superleaves)."""

    card, cpu, cams = small_scenes[name]
    ro, rd = _camera_rays(cams, 128, 72, "cpu")
    dev = card.device
    got = intersect.count_traversal(card, V3(*(c.to(dev) for c in ro)),
                                    V3(*(c.to(dev) for c in rd)), EPS)
    ref = intersect.count_traversal(cpu, ro, rd, EPS)
    assert int(ref[0].sum()) > 0 and int(ref[1].sum()) > 0
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_spp_streams_match_one_stream_on_card(small_scenes):
    """pathtrace_spp on the field, 64x48, 4 spp, 4 bounces, STANDARD, with
    streams K = 2 against K = 1 on the card: the sum of n_traced equal
    exactly, acc within rtol 3e-6 / atol 1e-6 (each lane's walk does not
    depend on its batch: B4's owner masks, B5's per-lane stack, B6 per
    pair)."""

    card, _, cams = small_scenes["field"]
    desc = _desc_of(cams, tl.PathtraceType.STANDARD)
    gx, gy = _pixel_batch(64, 48, 0, 0, card.device)
    ctx = integrators.make_ctx(card, EPS)
    runs = [integrators.pathtrace_spp(
        card, ctx, gy * 64 + gx, gx, gy, (64.0, 48.0), _camera_args(desc), False,
        0, 0, 4, int(tl.PathtraceType.STANDARD), 4, 10.0, streams=K)
        for K in (1, 2)]
    (acc1, nt1), (acc2, nt2) = runs
    assert int(nt1.sum()) == int(nt2.sum()) > 64 * 48 * 4
    for a, b in zip(acc2, acc1):
        torch.testing.assert_close(a, b, rtol=3e-6, atol=1e-6)
