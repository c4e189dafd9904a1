"""Kernel B4: closest hit of each camera ray through the top tree and its
superleaves, optionally with the winner's interpolated attribute rows.

The counterpart of lupinpathtracer_tpu/kernels/pallas_packet.py
(`packet_traverse`, pallas_call at :1011; `_packet_kernel` :303 and
`_attr_phase` :730). The TPU kernel walks the top tree once per block of
PBK rays, DMAs each visited superleaf's coefficient block and intersects it
on the MXU. On the card (csrc/packet.cu) the 32 lanes of a warp walk one
shared stack whose entries carry an owner mask, the lanes for which the
node lies on their own walk; each lane tests only what it owns, with its
own best t, and the lanes of a sub-chunk read its coefficients together.
That visits exactly each lane's own nodes in the order of its own walk, so
the result is the per-ray walk's, bit for bit.

Per ray: a stack of S + TOP_FAN entries (S = 7*top_depth + 10) holding
(child_ref << 1) | is_leaf, root row 0 first. An internal pop slab-tests
all 8 children against the ray's best t and pushes the hits in child-slot
order (empty slots carry a box that passes the slab test and are masked on
their used marker). A leaf pop tests the superleaf's NSUB sub-chunk boxes
(with the best t at the pop) and intersects the SPB triangles of each chunk
that passes, chunk by chunk, keeping the best hit with a strict < (within a
chunk the lowest index wins a tie). With attributes, the winner's packed
row is read and interpolated as _attr_phase does; miss and inactive lanes
are zero. Both read the top tree as the packed rows of bvh.top_rows, built
once per scene.

Two-level (instanced) scenes (pallas_packet.py:405-467): a leaf id is a
global (instance x mesh superleaf) id. At a leaf pop the ray moves to the
instance's mesh space (12 inverse-transform scalars, direction not
normalised so t stays world-scaled), the sub-chunk boxes and triangles are
the mesh superleaf's, and the winner is gref * SP + lane, a global id. The
leaf's mesh superleaf and transform come from its 64-byte gsl_meta row
(the JAX package's TL_STREAM layout; its resident mode, which kept the
tables in the TPU's SMEM, computes the same). Attributes are never fused on
two-level scenes.

Where sub-chunks are short (the instanced fields), a packet that pops a
leaf of few owner lanes continues as per-lane walks, each lane's own
entries of the shared stack becoming its own stack: still exact.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it runs the plain version below: the per-ray walk in lockstep over lanes,
the same tables in the same order and the same f32 arithmetic, so kernel
and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..accel.superleaf import TOP_FAN
from ..core.device import on_cpu
from . import bvh
from . import dense_intersect as dk

F32_MAX = dk.F32_MAX

# Kernel launches (counted only where the kernel is launched).
LAUNCHES = {"packet_traverse": 0}

# Lanes of one packet of the kernel (csrc/packet.cu: a warp), the deepest
# stack it holds (PK_STACK), and its split: a packet that pops a leaf of
# fewer than PACKET_SPLIT owner lanes continues as per-lane walks, where
# the sub-chunks are at most PACKET_SPLIT_CHUNK triangles (PK_SPLIT,
# PK_SPLIT_CHUNK; tests/test_torch_kernel_layouts.py holds these copies to
# the source). intersect.packet_eligible sends deeper trees elsewhere.
PACKET_LANES = 32
PACKET_STACK_MAX = 128
PACKET_SPLIT = 8
PACKET_SPLIT_CHUNK = 128

# Ray-triangle pairs per chunk of the plain version's triangle evaluation:
# bounds its (lanes, SPB) temporaries (32 MB each).
_PLAIN_PAIRS = 1 << 23


def env_on(name: str) -> bool:
    """Boolean switch from the environment (pallas_packet.py:108-115): set
    and not "0" or "" (so VAR=0 means off)."""

    return os.environ.get(name, "") not in ("", "0")


def stack_size(scene) -> int:
    """S + TOP_FAN stack entries (pallas_packet.py:952-953)."""

    return bvh.stack_depth(scene) + TOP_FAN


def _check(scene, ro, rd, W4, with_attrs):
    if scene.top_root_is_leaf:
        raise ValueError("single-superleaf scenes take the pair kernel")
    if with_attrs and scene.two_level:
        raise ValueError("two-level scenes fetch attributes with "
                         "wavefront_fetch_attrs, not in the packet kernel")
    if W4.dim() != 3 or W4.shape[:2] != (4, 10):
        raise ValueError(f"W4 must be (4, 10, T), got {tuple(W4.shape)}")
    bvh._f32(*ro, *rd, W4)
    if W4.shape[2] < scene.msl_count * scene.sl_stride:
        raise ValueError("W4 does not cover the repacked soup")


def _awout(scene, with_attrs):
    if not with_attrs:
        return 0
    return bvh.IA_ROWS_NM if scene.any_normal_maps else bvh.IA_ROWS


def packet_traverse_plain(scene, ro, rd, eps, W4, *, active=None,
                          with_attrs=False, counts=None):
    """Plain version of B4: every lane pops one stack entry per step.
    `counts`, a dict, receives the work this batch needs, for a bound:
    box_tests (child and sub-chunk slab tests), tri_tests (triangles of the
    admitted chunks), chunks (distinct sub-chunks admitted), leaf_visits
    (leaf pops over all rays); and the work of the kernel's packets of
    PACKET_LANES consecutive lanes, each walking the union of its lanes'
    trees: union_box_tests (8 per distinct row, NSUB per distinct leaf of a
    packet), union_chunks and union_tri_tests (distinct sub-chunks of a
    packet, and their triangles), lane_share (tri_tests over
    PACKET_LANES * union_tri_tests: the share of a packet's lanes that test
    a triangle the packet reads), packet_split (whether the kernel splits
    sparse packets into per-lane walks here; the union counts are then an
    upper bound of the packets' work)."""

    _check(scene, ro, rd, W4, with_attrs)
    B = ro.x.shape[0]
    dev = ro.x.device
    SP = scene.sl_stride
    sub = scene.sl_sub.float()
    nsub = sub.shape[1]
    spb = SP // nsub
    geo, refs = bvh.top_rows(scene.top_tab)
    rows = geo.shape[0]
    SM = stack_size(scene)
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active.to(torch.bool))
    ivx, ivy, ivz = 1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z
    R = bvh.ray_feature_rows(ro, rd)

    stack = torch.zeros((SM, B), dtype=torch.int32, device=dev)
    sp = act.to(torch.int32)
    bt = torch.full((B,), F32_MAX, dtype=torch.float32, device=dev)
    bu, bv, bd = (torch.zeros(B, dtype=torch.float32, device=dev) for _ in range(3))
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    lane = torch.arange(B, device=dev)
    col = torch.arange(spb, device=dev)
    n_box = torch.zeros((), dtype=torch.int64, device=dev)
    n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    n_leaf = torch.zeros((), dtype=torch.int64, device=dev)
    touched = torch.zeros(sub.shape[0] * nsub, dtype=torch.bool, device=dev)
    # Packet-union keys: (packet, node) of every pop, (packet, leaf, chunk)
    # of every admitted chunk.
    packet = lane // PACKET_LANES
    pops, chunk_keys = [], []

    while True:
        live = sp > 0
        if not bool(live.any()):
            break
        sp = torch.where(live, sp - 1, sp)
        top = stack.gather(0, sp.clamp(max=SM - 1).long()[None, :])[0]
        pref = torch.where(live & (sp < SM), top, 0)
        ref = pref >> 1
        is_int = live & ((pref & 1) == 0)
        is_leaf = live & ((pref & 1) == 1)

        # Internal pops: slab-test the 8 children, push hits in slot order.
        row = torch.where(is_int, ref, 0).long()
        g = geo[row]  # (B, 8, 8)
        near, far = bvh.slab(
            ro.x[:, None], ro.y[:, None], ro.z[:, None],
            ivx[:, None], ivy[:, None], ivz[:, None],
            [g[:, :, k] for k in range(3)], [g[:, :, 3 + k] for k in range(3)])
        hit8 = ((far >= near) & (far > 0.0) & (near < bt[:, None])
                & (g[:, :, 6] > -0.5) & is_int[:, None])
        r8 = refs[row]
        if counts is not None:
            n_box += TOP_FAN * is_int.sum() + nsub * is_leaf.sum()
            n_leaf += is_leaf.sum()
            # Rows and leaves in one key space: leaf l after the rows.
            node = torch.where(is_int, ref.long(), rows + ref.long())
            pops.append((packet * (rows + scene.sl_count) + node)[live])
        for ci in range(TOP_FAN):
            stack = bvh._put_row(stack, sp, r8[:, ci], hit8[:, ci])
            sp = sp + hit8[:, ci].to(torch.int32)

        # Leaf pops: sub-chunk boxes (best t at the pop), then the chunks.
        leaf_lanes = lane[is_leaf]
        step = max(1, _PLAIN_PAIRS // spb)
        for s0 in range(0, leaf_lanes.shape[0], step):
            ln = leaf_lanes[s0:s0 + step]
            gref = ref[ln].long()
            if not scene.two_level:
                wref = gref
                ol = (ro.x[ln], ro.y[ln], ro.z[ln])
                ivl = (ivx[ln], ivy[ln], ivz[ln])
                Rl = R[ln]
            else:
                # The leaf's mesh space: its mesh superleaf, and the ray by
                # its instance's inverse transform (the gsl_meta row).
                meta = scene.gsl_meta[gref]
                wref, m12 = meta[:, 0].long(), meta[:, 2:14]
                ol, dl = bvh.mesh_space(m12, tuple(c[ln] for c in ro),
                                        tuple(c[ln] for c in rd))
                ivl = tuple(1.0 / c for c in dl)
                Rl = bvh.ray_feature_rows(ol, dl)
            sb = sub[wref]  # (L, nsub, 8)
            n_, f_ = bvh.slab(
                ol[0][:, None], ol[1][:, None], ol[2][:, None],
                ivl[0][:, None], ivl[1][:, None], ivl[2][:, None],
                [sb[:, :, k] for k in range(3)], [sb[:, :, 3 + k] for k in range(3)])
            bits = ((f_ >= n_) & (f_ > 0.0) & (n_ < bt[ln, None])
                    & (sb[:, :, 6] > -0.5))
            for s in range(nsub):
                on = bits[:, s]
                if not bool(on.any()):
                    continue
                sel = ln[on]
                if counts is not None:
                    n_tri += spb * on.sum()
                    touched[wref[on] * nsub + s] = True
                    chunk_keys.append(
                        (packet[sel] * scene.sl_count + gref[on]) * nsub + s)
                base = wref[on] * SP + s * spb
                cols = base[:, None] + col[None, :]  # (Ls, spb)
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
                bi[us] = (gref[on] * SP + s * spb + j[:, 0]).to(torch.int32)[upd]

    if counts is not None:
        keys = torch.unique(torch.cat(pops)) if pops else lane[:0]
        u_chunks = int(torch.unique(torch.cat(chunk_keys)).numel()) if chunk_keys else 0
        u_rows = int((keys % (rows + scene.sl_count) < rows).sum())
        u_leaves = int(keys.numel()) - u_rows
        counts.update(box_tests=int(n_box), tri_tests=int(n_tri),
                      chunks=int(touched.sum()), chunk_tris=spb,
                      leaf_visits=int(n_leaf), packet_lanes=PACKET_LANES,
                      union_box_tests=TOP_FAN * u_rows + nsub * u_leaves,
                      union_leaf_visits=u_leaves, union_chunks=u_chunks,
                      union_tri_tests=u_chunks * spb,
                      lane_share=int(n_tri) / max(PACKET_LANES * u_chunks * spb, 1),
                      packet_split=spb <= PACKET_SPLIT_CHUNK)
    if not with_attrs:
        return bt, bu, bv, bd, bi
    awout = _awout(scene, with_attrs)
    ia = torch.zeros((awout, B), dtype=torch.float32, device=dev)
    hit = bt < F32_MAX
    if bool(hit.any()):
        rows_a = scene.wt_attr[bi[hit].long()]
        ia[:, hit] = bvh.interp_rows(rows_a, bu[hit], bv[hit], awout)
    return bt, bu, bv, bd, bi, ia


def packet_traverse(scene, ro, rd, eps, W4, *, active=None, with_attrs=False):
    """B4: (t, u, v, det, tri) of the closest hit per ray, t = F32_MAX on a
    miss (u = v = det = 0, tri 0), tri a repacked-soup index (two-level
    scenes: global superleaf * stride + lane); with `with_attrs`
    (single-level scenes only), also the (IA_ROWS[_NM], B) interpolated
    winner rows (kernels/bvh.py IA_* layout, zeros on miss and inactive
    lanes)."""

    if on_cpu(ro.x):
        return packet_traverse_plain(scene, ro, rd, eps, W4, active=active,
                                     with_attrs=with_attrs)

    from . import cuda_build

    out = _launch(cuda_build.load("packet", bind), scene, ro, rd, eps, W4,
                  active, with_attrs)
    if ro.x.shape[0] > 0:
        LAUNCHES["packet_traverse"] += 1
    return out


def bind(lib):
    """Declares lupin_packet_traverse's signature on a loaded build of
    csrc/packet.cu, once: cuda_build.load calls it where it opens the
    library, tools/prof_packet.py on its copies. Returns `lib`."""

    lib.lupin_packet_traverse.restype = ctypes.c_int
    lib.lupin_packet_traverse.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8)
    return lib


def _launch(lib, scene, ro, rd, eps, W4, active, with_attrs):
    """B4's kernel from the loaded library `lib` (the checkout's build of
    csrc/packet.cu, or a copy of it: tools/prof_packet.py), bound by
    `bind`."""

    from . import cuda_build

    _check(scene, ro, rd, W4, with_attrs)
    SM = stack_size(scene)
    if SM > PACKET_STACK_MAX:
        raise ValueError(f"a top tree of depth {scene.top_depth} needs a stack "
                         f"of {SM} > {PACKET_STACK_MAX} entries")
    fn = lib.lupin_packet_traverse
    dev = ro.x.device
    B = ro.x.shape[0]
    geo, refs = bvh.top_rows(scene.top_tab)
    sub = scene.sl_sub.float().contiguous()
    gmeta = scene.gsl_meta.float().contiguous() if scene.two_level else None
    act = (torch.ones(B, dtype=torch.int32, device=dev) if active is None
           else active.to(torch.int32).contiguous())
    tiles = torch.zeros(1, dtype=torch.int32, device=dev)
    t, u, v, det = (torch.empty(B, dtype=torch.float32, device=dev) for _ in range(4))
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    awout = _awout(scene, with_attrs)
    ia = torch.empty((max(awout, 1), B), dtype=torch.float32, device=dev)
    A = scene.wt_attr.contiguous()
    Wp = bvh.pair_table(W4)
    rays = [x.contiguous() for x in (*ro, *rd)]
    if B > 0:
        with torch.cuda.device(dev):
            rc = fn(geo.data_ptr(), refs.data_ptr(), sub.data_ptr(),
                    *(x.data_ptr() for x in rays), act.data_ptr(),
                    Wp.data_ptr(), scene.sl_stride, sub.shape[1], SM, B,
                    float(eps), A.data_ptr(), A.shape[1], awout,
                    int(scene.two_level),
                    None if gmeta is None else gmeta.data_ptr(),
                    int(scene.gsl_meta.shape[1]), tiles.data_ptr(),
                    t.data_ptr(), u.data_ptr(), v.data_ptr(), det.data_ptr(),
                    tri.data_ptr(), ia.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(rc, "packet_traverse")
    if not with_attrs:
        return t, u, v, det, tri
    return t, u, v, det, tri, ia
