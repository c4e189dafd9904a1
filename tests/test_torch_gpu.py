"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version. Marked `gpu`; without a CUDA GPU every test skips. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: B1/B2 equal their plain versions exactly (same f32 operations
in the same order, kernels built with -fmad=false); B3 holds n_traced equal
on >= 99.9% of lanes and acc at rtol 2e-4 / atol 2e-5 there (the plain
version divides by Python scalars, which PyTorch on the card turns into a
reciprocal multiply). The BVH kernels B4-B7 equal their plain versions
exactly on a 300k-triangle terrain (several superleaves, four sub-chunks
each): the same tables walked in the same order with the same f32
arithmetic. Both BVH routes are also held to closest_hit_bvh, the walk of
the binary BVH (tolerances in that test)."""

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


@pytest.mark.gpu
def test_megakernel_matches_plain_on_card(cuda_device):
    scene, cams = builtin.build_scene_cornell_box()
    scene.instances[6].mat_idx = scene.add_material(tl.Material(
        color=np.array([0.8, 0.7, 0.6, 1.0], np.float32),
        mat_type=tl.MaterialType.GLOSSY, roughness=0.3, ior=1.5))
    ts = tl.build_scene_torch(scene, device=cuda_device)
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


@pytest.fixture(scope="module")
def terrain_rays():
    """A 300k-triangle terrain on the card, its 128x72 camera rays and a
    bounce batch: rays from the camera hits (the camera origin on misses)
    into random directions on the side of the geometric normal facing the
    camera."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    dev = torch.device("cuda", 0)
    scene, cams = synthetic.build_scene_terrain(n_tris=300_000, seed=0)
    ts = tl.build_scene_torch(scene, device=dev)
    assert ts.use_bvh and not ts.top_root_is_leaf and ts.sl_sub.shape[1] > 1
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    w, h = 128, 72
    gx, gy = _pixel_batch(w, h, 0, 0, dev)
    _, ro, rd = integrators._camera_ray_from(
        dict(cam=_camera_args(desc), is_ortho=False, gx=gx, gy=gy,
             resolution=(float(w), float(h))),
        rng_mod.init_state(gy * w + gx, 0, 0))
    W = intersect.scene_tri_matrix(ts)
    t, *_, ia = packet.packet_traverse(ts, ro, rd, EPS, W, with_attrs=True)
    hit = t < dk.F32_MAX
    gn = V3(*ia[bvh.IA_GN])
    rng = np.random.default_rng(5)
    d = rng.normal(size=(3, t.shape[0]))
    d /= np.linalg.norm(d, axis=0)
    d = V3(*(torch.tensor(c, dtype=torch.float32, device=dev) for c in d))
    flip = (d.x * gn.x + d.y * gn.y + d.z * gn.z) * (
        rd.x * gn.x + rd.y * gn.y + rd.z * gn.z) > 0.0
    d = V3(*(torch.where(flip, -c, c) for c in d))
    th = torch.where(hit, t, 0.0)
    o = V3(*(a + b * th for a, b in zip(ro, rd)))
    return ts, W, (ro, rd), (o, d)


@pytest.mark.gpu
def test_b4_packet_kernel_matches_plain_on_card(terrain_rays):
    ts, W, (ro, rd), _ = terrain_rays
    act = torch.tensor(np.random.default_rng(6).random(ro.x.shape[0]) < 0.9,
                       device=ro.x.device)
    packet.LAUNCHES["packet_traverse"] = 0
    k = packet.packet_traverse(ts, ro, rd, EPS, W, active=act, with_attrs=True)
    p = packet.packet_traverse_plain(ts, ro, rd, EPS, W, active=act,
                                     with_attrs=True)
    assert packet.LAUNCHES["packet_traverse"] == 1
    assert bool((k[0] < dk.F32_MAX).any())
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
    tab = ts.top_tab.float()
    for rnd in range(2):
        # Both update their stack in place: each gets its own copy.
        k = bvh.top_traverse(tab, o, d, best_t, stack.clone(), sp, S=S, Q=Q,
                             n_sl=n_sl)
        p = bvh.top_traverse_plain(tab, o, d, best_t, stack.clone(), sp, S=S,
                                   Q=Q, n_sl=n_sl)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
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
