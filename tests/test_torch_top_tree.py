"""PyTorch port, kernel B4's packet walk on the CPU: why the kernel that
walks one shared stack per packet of lanes (csrc/packet.cu) returns exactly
what the per-ray walk returns.

`union_walk` below emulates that kernel in plain PyTorch: the lanes are
grouped into blocks of consecutive lanes; each block walks one stack whose
entries carry an owner mask (the lanes for which the node lies on their
own walk); a popped internal row is slab-tested by its owners, each with
its own best t, and a child is pushed, in child-slot order, when any owner
hits it, owned by those that do; a popped leaf is tested by its owners
(sub-chunk boxes with the best t at the pop), and the block runs the union
of their admitted sub-chunks in ascending order, each lane only its own.
The per-lane arithmetic is the plain version's (kernels/packet.py), so the
result must equal `packet_traverse_plain` bit for bit, whatever the block
size (the kernel's warp of 32, and 128 and 256), the lane order (the
renderer's swizzled camera batch, and shuffled) and the inactive lanes.
The shared stack never holds more than 7 * top_depth + 1 entries, so the
kernel's stack of SM entries never overflows. Where the kernel splits a
packet into per-lane walks (a leaf of few owner lanes, on short
sub-chunks), each lane's own entries become its own stack: still exact.
A top tree too deep for the kernel's shared stack takes the wavefront.
Beside it, B5's plain version counts the rows its pops read (for B5's
bound), and B5's outputs are compared whole but the stack, which counts
below each lane's sp only (tools/prof_top.max_abs_diff).

Scenes: a 20,000-triangle terrain and the 2,000-instance field
(io/synthetic.py; two-level, each leaf's ray moved to mesh space). Inputs
are numpy-seeded; the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.accel.superleaf import TOP_FAN
from lupinpathtracer_tpu_torch.core.vec3 import V3
from lupinpathtracer_tpu_torch.io import synthetic
from lupinpathtracer_tpu_torch.kernels import bvh
from lupinpathtracer_tpu_torch.kernels import dense_intersect as dk
from lupinpathtracer_tpu_torch.kernels import intersect, packet
from lupinpathtracer_tpu_torch.tools import prof_pair

EPS = 1e-3
F32_MAX = dk.F32_MAX


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Runs each test on one PyTorch thread: the suite runs in several
    worker processes at once, and PyTorch's intra-op thread pools in all of
    them oversubscribe the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def union_walk(scene, ro, rd, eps, W4, active, block, split=0):
    """B4 by packets of `block` consecutive lanes sharing one stack (see the
    module note); a packet that pops a leaf of fewer than `split` owners
    turns into per-lane walks, each lane's own entries, bottom to top,
    becoming its own stack (csrc/packet.cu's split). Returns (t, u, v, det,
    tri) as packet_traverse_plain, the deepest shared stack, the union's
    distinct sub-chunks over all blocks and its pops."""

    B = ro.x.shape[0]
    SP = scene.sl_stride
    sub = scene.sl_sub.float()
    nsub = sub.shape[1]
    spb = SP // nsub
    geo, refs = bvh.top_rows(scene.top_tab)
    iv = (1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    R = bvh.ray_feature_rows(ro, rd)
    col = torch.arange(spb)
    bt = torch.full((B,), F32_MAX, dtype=torch.float32)
    bu, bv, bd = (torch.zeros(B, dtype=torch.float32) for _ in range(3))
    bi = torch.zeros(B, dtype=torch.int32)
    n = dict(deepest=0, chunks=0, pops=0)

    def walk(stack, ln, split):
        while stack:
            pref, own = stack.pop()
            ref = pref >> 1
            lanes = ln[own]
            if pref & 1 == 0:
                n["pops"] += 1
                g = geo[ref]  # (8, 8)
                near, far = bvh.slab(
                    ro.x[lanes, None], ro.y[lanes, None], ro.z[lanes, None],
                    iv[0][lanes, None], iv[1][lanes, None], iv[2][lanes, None],
                    [g[:, k] for k in range(3)], [g[:, 3 + k] for k in range(3)])
                hit8 = ((far >= near) & (far > 0.0) & (near < bt[lanes, None])
                        & (g[:, 6] > -0.5))
                for c in range(TOP_FAN):  # child-slot order
                    if bool(hit8[:, c].any()):
                        m = torch.zeros_like(own)
                        m[own] = hit8[:, c]
                        stack.append((int(refs[ref, c]), m))
                n["deepest"] = max(n["deepest"], len(stack))
                continue
            if int(own.sum()) < split:
                stack.append((pref, own))
                for j in range(ln.shape[0]):  # per-lane walks
                    mine = [(e, torch.ones(1, dtype=torch.bool)) for e, o in stack
                            if bool(o[j])]
                    walk(mine, ln[j:j + 1], 0)
                return
            n["pops"] += 1
            leaf(ref, lanes)

    def leaf(ref, lanes):
        if scene.two_level:
            meta = scene.gsl_meta[ref]
            wref = int(meta[0])
            m12 = meta[2:14].expand(lanes.shape[0], 12)
            ol, dl = bvh.mesh_space(m12, tuple(c[lanes] for c in ro),
                                    tuple(c[lanes] for c in rd))
            ivl = tuple(1.0 / c for c in dl)
            Rl = bvh.ray_feature_rows(ol, dl)
        else:
            wref = ref
            ol = tuple(c[lanes] for c in ro)
            ivl = tuple(c[lanes] for c in iv)
            Rl = R[lanes]
        sb = sub[wref]  # (nsub, 8)
        n_, f_ = bvh.slab(
            ol[0][:, None], ol[1][:, None], ol[2][:, None],
            ivl[0][:, None], ivl[1][:, None], ivl[2][:, None],
            [sb[:, k] for k in range(3)], [sb[:, 3 + k] for k in range(3)])
        bits = ((f_ >= n_) & (f_ > 0.0) & (n_ < bt[lanes, None])
                & (sb[:, 6] > -0.5))
        for s in range(nsub):  # each lane's chunks, ascending
            on = bits[:, s]
            if not bool(on.any()):
                continue
            n["chunks"] += 1
            sel = lanes[on]
            cols = (wref * SP + s * spb + col)[None, :].expand(sel.shape[0], spb)
            Rs = Rl[on]
            m = []
            for cc in range(4):
                acc = Rs[:, 0:1] * W4[cc, 0][cols]
                for k in range(1, 10):
                    acc = acc + Rs[:, k:k + 1] * W4[cc, k][cols]
                m.append(acc)
            tt, uu, vv = dk.dense_epilogue(m[0], m[1], m[2], m[3], eps)
            j = torch.argmin(tt, dim=1, keepdim=True)
            cmin = tt.gather(1, j)[:, 0]
            upd = cmin < bt[sel]
            us = sel[upd]
            bt[us] = cmin[upd]
            bu[us] = uu.gather(1, j)[:, 0][upd]
            bv[us] = vv.gather(1, j)[:, 0][upd]
            bd[us] = m[0].gather(1, j)[:, 0][upd]
            bi[us] = (ref * SP + s * spb + j[:, 0]).to(torch.int32)[upd]

    for b0 in range(0, B, block):
        ln = torch.arange(b0, min(b0 + block, B))
        act = active[ln]
        walk([(0, act)] if bool(act.any()) else [], ln, split)
    return (bt, bu, bv, bd, bi), n["deepest"], n["chunks"], n["pops"]


@pytest.fixture(scope="module")
def scenes():
    """{name: (scene, camera rays of a 32x16 frame in the renderer's lane
    order, W)} for the terrain and the 2,000-instance field."""

    out = {}
    for name, (cpu_scene, cams) in (
            ("terrain", synthetic.build_scene_terrain(n_tris=20_000, seed=0)),
            ("field2k", synthetic.build_scene_instanced_field(
                2_000, seed=0, tris_per_mesh=64))):
        ts = tl.build_scene_torch(cpu_scene, device="cpu")
        assert ts.use_bvh and not ts.top_root_is_leaf
        assert ts.two_level == (name == "field2k")
        ro, rd = prof_pair.camera_rays(cams[0], 32, 16, "cpu")
        out[name] = (ts, ro, rd, intersect.scene_tri_matrix(ts))
    return out


@pytest.mark.parametrize("order", ["swizzled", "shuffled"])
@pytest.mark.parametrize("block", [32, 128, 256])
@pytest.mark.parametrize("name", ["terrain", "field2k"])
def test_union_walk_equals_per_ray_walk(scenes, name, block, order):
    ts, ro, rd, W = scenes[name]
    B = ro.x.shape[0]
    rng = np.random.default_rng(block + (order == "shuffled"))
    if order == "shuffled":
        perm = torch.from_numpy(rng.permutation(B))
        ro, rd = V3(*(c[perm] for c in ro)), V3(*(c[perm] for c in rd))
    active = torch.from_numpy(rng.random(B) < 0.85)
    ref = packet.packet_traverse_plain(ts, ro, rd, EPS, W, active=active)
    got, deepest, _, _ = union_walk(ts, ro, rd, EPS, W, active, block)
    assert bool((ref[0] < F32_MAX).any()) and bool((ref[0][~active] == F32_MAX).all())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert deepest <= 7 * ts.top_depth + 1


@pytest.mark.parametrize("split", [packet.PACKET_SPLIT, packet.PACKET_LANES + 1],
                         ids=["split_below_8_owners", "split_at_first_leaf"])
@pytest.mark.parametrize("name", ["terrain", "field2k"])
def test_packet_split_equals_per_ray_walk(scenes, name, split):
    """The kernel's split: a packet that meets a leaf of few owner lanes
    continues as per-lane walks, each lane's own entries of the shared
    stack becoming its own stack; the result is still the per-ray walk's,
    bit for bit, whether the split comes at a sparse leaf or at the first
    leaf."""

    ts, ro, rd, W = scenes[name]
    B = ro.x.shape[0]
    active = torch.from_numpy(np.random.default_rng(split).random(B) < 0.9)
    ref = packet.packet_traverse_plain(ts, ro, rd, EPS, W, active=active)
    got, _, _, _ = union_walk(ts, ro, rd, EPS, W, active, packet.PACKET_LANES,
                              split=split)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["terrain", "field2k"])
def test_union_stack_depth_and_plain_counts(scenes, name):
    """The deepest shared stack of one packet of all the batch's lanes stays
    within 7 * top_depth + 1 (below the kernel's SM, and within its shared
    stack), and the plain version's packet counts (packets of
    PACKET_LANES lanes) are the union walk's."""

    ts, ro, rd, W = scenes[name]
    B = ro.x.shape[0]
    every = torch.ones(B, dtype=torch.bool)
    _, deepest, _, _ = union_walk(ts, ro, rd, EPS, W, every, B)
    assert TOP_FAN < deepest <= 7 * ts.top_depth + 1 < packet.stack_size(ts)
    assert packet.stack_size(ts) <= packet.PACKET_STACK_MAX
    counts: dict = {}
    packet.packet_traverse_plain(ts, ro, rd, EPS, W, counts=counts)
    _, _, u_chunks, u_pops = union_walk(ts, ro, rd, EPS, W, every,
                                        packet.PACKET_LANES)
    assert counts["union_chunks"] == u_chunks > 0
    assert counts["union_tri_tests"] == u_chunks * counts["chunk_tris"]
    assert counts["union_leaf_visits"] <= counts["leaf_visits"]
    assert u_pops == (counts["union_box_tests"] - ts.sl_sub.shape[1]
                      * counts["union_leaf_visits"]) // TOP_FAN + counts["union_leaf_visits"]
    assert 0.0 < counts["lane_share"] <= 1.0


def test_packet_route_needs_the_stack_room(scenes, monkeypatch):
    """A top tree too deep for the packet's shared stack (stack_size >
    PACKET_STACK_MAX) takes the sort wavefront instead of B4."""

    ts = scenes["terrain"][0]
    assert intersect.packet_eligible(ts)
    deepest = (packet.PACKET_STACK_MAX - TOP_FAN - TOP_FAN - 2) // (TOP_FAN - 1)
    monkeypatch.setitem(ts.statics, "top_depth", deepest)
    assert packet.stack_size(ts) <= packet.PACKET_STACK_MAX
    assert intersect.packet_eligible(ts)
    monkeypatch.setitem(ts.statics, "top_depth", deepest + 1)
    assert packet.stack_size(ts) > packet.PACKET_STACK_MAX
    assert not intersect.packet_eligible(ts)


def test_b5_plain_counts_and_output_difference(scenes):
    """B5's plain version counts the rows its internal pops read (for the
    bound), and prof_top.max_abs_diff compares the stack below each lane's
    sp only, and everything else whole."""

    from lupinpathtracer_tpu_torch.tools import prof_top

    ts, ro, rd, _ = scenes["terrain"]
    B = ro.x.shape[0]
    S = bvh.stack_depth(ts)
    stack = torch.zeros((S, B), dtype=torch.int32)
    sp = torch.ones(B, dtype=torch.int32)
    best_t = torch.full((B,), F32_MAX, dtype=torch.float32)
    counts: dict = {}
    k = bvh.top_traverse_plain(ts.top_tab, ro, rd, best_t, stack, sp, S=S, Q=2,
                               n_sl=ts.sl_count, counts=counts)
    assert 0 < counts["rows_read"] <= min(counts["internal_pops"],
                                          ts.top_tab.shape[0])
    assert counts["internal_pops"] <= counts["pops"]
    assert k[4] is not None and bool((k[3] > 0).any())
    p = [x.clone() if x is not None else None for x in k]
    assert prof_top.max_abs_diff(k, p, S) == 0.0
    lane = int(torch.nonzero(k[3] < S)[0])
    p[2][int(k[3][lane]):, lane] += 7  # above sp: not part of the contract
    assert prof_top.max_abs_diff(k, p, S) == 0.0
    lane = int(torch.nonzero(k[3] > 0)[0])
    p[2][0, lane] += 3
    assert prof_top.max_abs_diff(k, p, S) == 3.0
    p[2][0, lane] -= 3
    p[4][0] += 5
    assert prof_top.max_abs_diff(k, p, S) == 5.0
    p[4] = None
    assert prof_top.max_abs_diff(k, p, S) == float("inf")
