"""The BVH walk: closest hit of a single-level scene's bounce batch by one
thread per ray walking the binary BVH (csrc/walk.cu).

kernels/intersect.py::closest_hit_wavefront sends a batch here on the card
when it is a bounce batch (coherent=False) of a single-level scene and B4
does not take it; every other batch keeps its route. The walk replaces the
superleaf wavefront's rounds (B5, the superleaf sort, B6, the un-sort and
the per-ray min, and a host sync a round) by one launch. It returns what
the wavefront returns, (t, u, v, det, tri) per lane with tri an id of the
padded superleaf soup, so B7 (`intersect.wavefront_fetch_attrs`) follows
unchanged.

The walk reads the scene's node table `bvh_nodes` (scene/flatten.py::
pack_bvh_nodes, built with the scene: per node 32 bytes, (min.xyz, first)
and (max.xyz, count) with the ints' bits in the float lanes) and the
coefficient table B6 reads (bvh.pair_table). csrc/walk.cu's header says
what the walk computes and how it keeps every hit B6 would find.
`walk_plain` is its plain version, bit for bit: each lane walks the same
nodes in the same order with the same arithmetic, all lanes in lockstep.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.device import on_cpu
from ..core.vec3 import V3
from . import bvh as bk
from . import dense_intersect as dk

F32_MAX = dk.F32_MAX

# Launches of the kernel (counted only where it is launched).
LAUNCHES = {"walk": 0}

STACK = 27  # csrc/walk.cu STACK: accel/bvh.py BVH_MAX_DEPTH + 2
PAD = 2.0 ** -16  # csrc/walk.cu PAD: a box widens by PAD * (|o|max + M)
FAR_SCALE = 1.0 + 3.0 * 2.0 ** -23  # csrc/walk.cu FAR_SCALE, >= 1 + 2 gamma_3


def bind(lib):
    """Declares lupin_walk's signature on a loaded build of csrc/walk.cu,
    once (cuda_build.load). Returns `lib`."""

    lib.lupin_walk.restype = ctypes.c_int
    lib.lupin_walk.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_float]
                               + [ctypes.c_void_p] * 6)
    return lib


def _entry(lo, hi, op, om, iv):
    """Entry distance of each lane's box (lo, hi: (n, 3)), F32_MAX where
    the lane misses it: csrc/walk.cu box_entry."""

    a = [(lo[:, k] - op[k]) * iv[k] for k in range(3)]
    b = [(hi[:, k] - om[k]) * iv[k] for k in range(3)]
    mn, mx = torch.fmin, torch.fmax
    tn = mx(mx(mn(a[0], b[0]), mn(a[1], b[1])), mn(a[2], b[2]))
    tf = mn(mn(mx(a[0], b[0]), mx(a[1], b[1])), mx(a[2], b[2])) * FAR_SCALE
    return torch.where((tn <= tf) & (tf >= 0.0), tn, F32_MAX)


def walk_plain(nodes, W4, ro: V3, rd: V3, eps, active=None, counts=None):
    """Plain version of the walk kernel: every lane walks the node table
    (n_nodes, 8) as the kernel's thread does, all lanes one node a step in
    lockstep, and tests a leaf's triangles against the (4, 10, T)
    coefficient matrix W4 with B6's arithmetic. Returns (t, u, v, det, tri),
    a miss as (F32_MAX, 0, 0, 0, 0). `counts`, a dict, receives the
    internal steps (two box tests each), the leaf visits, the triangles
    tested, the groups of four triangles read and the distinct nodes and
    groups read, for a bound."""

    B = ro.x.shape[0]
    dev = ro.x.device
    i32 = torch.int32
    box_lo, box_hi = nodes[:, 0:3], nodes[:, 4:7]
    n_first = nodes[:, 3].contiguous().view(i32)
    n_count = nodes[:, 7].contiguous().view(i32)
    o, d = (ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z)
    R = bk.ray_feature_rows(o, d)
    iv = [1.0 / c for c in d]
    M = torch.cat([box_lo[0], box_hi[0]]).abs().max()
    m = torch.fmax(torch.fmax(o[0].abs(), o[1].abs()), o[2].abs())
    delta = (m + M) * PAD
    op = [c + delta for c in o]
    om = [c - delta for c in o]

    bt = torch.full((B,), F32_MAX, dtype=torch.float32, device=dev)
    bu, bv, bdet = (torch.zeros(B, dtype=torch.float32, device=dev) for _ in range(3))
    bidx = torch.zeros(B, dtype=i32, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    if active is not None:
        live = live & active
    first = n_first[0].expand(B).clone()
    count = n_count[0].expand(B).clone()
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    # One spare row: the row masked-out lanes write to.
    st_first = torch.zeros((STACK + 1, B), dtype=i32, device=dev)
    st_count = torch.zeros((STACK + 1, B), dtype=i32, device=dev)
    st_t = torch.zeros((STACK + 1, B), dtype=torch.float32, device=dev)
    lanes = torch.arange(B, device=dev)
    tally = dict(steps=0, leaves=0, tri_tests=0, groups=0)
    seen_nodes = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
    seen_groups = torch.zeros(-(-W4.shape[2] // 4), dtype=torch.bool, device=dev)
    if counts is not None:
        seen_nodes[0] = True

    while bool(live.any()):
        inner = live & (count == 0)
        leaf = live & (count > 0)
        pop = torch.zeros_like(live)

        # Internal nodes: both children's boxes.
        li = torch.nonzero(inner).flatten()
        if li.numel():
            c = first[li].long()
            tl = _entry(box_lo[c], box_hi[c], [x[li] for x in op],
                        [x[li] for x in om], [x[li] for x in iv])
            tr = _entry(box_lo[c + 1], box_hi[c + 1], [x[li] for x in op],
                        [x[li] for x in om], [x[li] for x in iv])
            b = bt[li]
            go_l, go_r = tl < b, tr < b
            both = go_l & go_r
            left_near = tl <= tr
            near = torch.where(left_near, c, c + 1)
            far = torch.where(left_near, c + 1, c)
            one = torch.where(go_l, c, c + 1)
            nxt = torch.where(both, near, one)
            row = torch.where(both, sp[li], STACK)
            st_first[row, li] = n_first[far]
            st_count[row, li] = n_count[far]
            st_t[row, li] = torch.where(left_near, tr, tl)
            sp[li] = sp[li] + both.long()
            go = go_l | go_r
            first[li] = torch.where(go, n_first[nxt], first[li])
            count[li] = torch.where(go, n_count[nxt], count[li])
            pop[li] = ~go
            if counts is not None:
                tally["steps"] += li.numel()
                seen_nodes[c] = True
                seen_nodes[c + 1] = True

        # Leaves: their triangles in index order, then a pop.
        lf = torch.nonzero(leaf).flatten()
        if lf.numel():
            f, n = first[lf], count[lf]
            Rl = R[lf]
            for k in range(int(n.max())):
                tk = k < n
                j = torch.where(tk, f + k, 0)
                w = W4[:, :, j.long()]  # (4, 10, n)
                num = []
                for cc in range(4):
                    acc = Rl[:, 0] * w[cc, 0]
                    for q in range(1, 10):
                        acc = acc + Rl[:, q] * w[cc, q]
                    num.append(acc)
                det, nu, nv, nt = num
                dd = 1.0 / det
                tq, uq, vq = nt * dd, nu * dd, nv * dd
                valid = tk & (uq >= 0.0) & (vq >= 0.0) & (uq + vq <= 1.0) & (tq >= eps)
                b, bi = bt[lf], bidx[lf]
                upd = valid & ((tq < b) | ((tq == b) & (j < bi)))
                bt[lf] = torch.where(upd, tq, b)
                bu[lf] = torch.where(upd, uq, bu[lf])
                bv[lf] = torch.where(upd, vq, bv[lf])
                bdet[lf] = torch.where(upd, det, bdet[lf])
                bidx[lf] = torch.where(upd, j, bi)
            pop[lf] = True
            if counts is not None:
                g0, g1 = f // 4, (f + n - 1) // 4
                tally["leaves"] += lf.numel()
                tally["tri_tests"] += int(n.sum())
                tally["groups"] += int((g1 - g0 + 1).sum())
                for k in range(int((g1 - g0).max()) + 1):
                    seen_groups[(g0 + k)[g0 + k <= g1].long()] = True

        # Pops: entries no longer below the best hit are dropped.
        if bool(pop.any()):
            while True:
                top = st_t[(sp - 1).clamp_min(0), lanes]
                drop = pop & (sp > 0) & ~(top < bt)
                if not bool(drop.any()):
                    break
                sp = sp - drop.long()
            empty = pop & (sp == 0)
            live = live & ~empty
            take = pop & (sp > 0)
            sp = sp - take.long()
            row = sp.clamp_min(0)
            first = torch.where(take, st_first[row, lanes], first)
            count = torch.where(take, st_count[row, lanes], count)

    if counts is not None:
        counts.update(tally, nodes_read=int(seen_nodes.sum()),
                      groups_read=int(seen_groups.sum()))
    return bt, bu, bv, bdet, bidx


def walk(scene, ro: V3, rd: V3, eps, W4, active=None):
    """The closest hit of a single-level scene's rays by the BVH walk:
    (t, u, v, det, tri) per lane, tri an id of the padded superleaf soup
    (as closest_hit_wavefront returns them); inactive lanes miss. W4 is the
    (4, 10, T) coefficient matrix at the soup's width (the kernel reads its
    bvh.pair_table). On CUDA tensors one launch of csrc/walk.cu; on CPU
    tensors walk_plain."""

    if scene.two_level:
        raise ValueError("the walk takes single-level scenes: a two-level "
                         "scene's bvh tables are placeholders")
    if scene.bvh_depth + 2 > STACK:
        raise ValueError(f"BVH of depth {scene.bvh_depth}: the walk's stack "
                         f"holds {STACK} entries")
    nodes = scene.bvh_nodes
    B = ro.x.shape[0]
    for x in (*ro, *rd, W4, nodes):
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
    if any(x.shape != (B,) for x in (*ro, *rd)):
        raise ValueError("ro and rd must hold one entry a lane")
    if active is not None and (active.dtype != torch.bool or active.shape != (B,)):
        raise ValueError("active must be a (B,) bool mask")
    if on_cpu(ro.x):
        return walk_plain(nodes, W4, ro, rd, eps, active=active)
    from . import cuda_build

    dev = ro.x.device
    table = bk.pair_table(W4)
    ins = [x.contiguous() for x in (*ro, *rd)]
    act = None if active is None else active.contiguous()
    t = torch.empty(B, dtype=torch.float32, device=dev)
    u, v, det = (torch.empty(B, dtype=torch.float32, device=dev) for _ in range(3))
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    lib = cuda_build.load("walk", bind)
    with torch.cuda.device(dev):
        rc = lib.lupin_walk(nodes.data_ptr(), table.data_ptr(),
                            *(x.data_ptr() for x in ins),
                            None if act is None else act.data_ptr(), B,
                            float(eps), t.data_ptr(), u.data_ptr(), v.data_ptr(),
                            det.data_ptr(), tri.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "walk")
    LAUNCHES["walk"] += 1
    return t, u, v, det, tri
