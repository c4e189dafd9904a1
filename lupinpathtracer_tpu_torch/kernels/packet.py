"""Kernel B4: per-ray closest hit through the top tree and its superleaves,
optionally with the winner's interpolated attribute rows.

The counterpart of lupinpathtracer_tpu/kernels/pallas_packet.py
(`packet_traverse`, pallas_call at :1011; `_packet_kernel` :303 and
`_attr_phase` :730). The TPU kernel walks the top tree once per block of
PBK rays, DMAs each visited superleaf's coefficient block and intersects it
on the MXU; on the card every thread owns one ray and walks the tree on its
own (csrc/packet.cu), which is what the TPU packet emulated.

Per ray: a stack of S + TOP_FAN entries (S = 7*top_depth + 10) holding
(child_ref << 1) | is_leaf, root row 0 first. An internal pop slab-tests
all 8 children against the ray's best t and pushes the hits in child-slot
order (empty slots carry a box that passes the slab test and are masked on
their used marker). A leaf pop tests the superleaf's NSUB sub-chunk boxes
(with the best t at the pop) and intersects the SPB triangles of each chunk
that passes, chunk by chunk, keeping the best hit with a strict < (within a
chunk the lowest index wins a tie). With attributes, the winner's packed
row is read and interpolated as _attr_phase does; miss and inactive lanes
are zero.

Two-level (instanced) scenes (pallas_packet.py:405-467): a leaf id is a
global (instance x mesh superleaf) id. At a leaf pop the ray moves to the
instance's mesh space (12 inverse-transform scalars, direction not
normalised so t stays world-scaled), the sub-chunk boxes and triangles are
the mesh superleaf's, and the winner is gref * SP + lane, a global id.
Where the leaf's mesh superleaf, instance and transform come from is the
mode: `resident` reads the gsl_msl, gsl_inst and inst_inv tables, `stream`
one 64-byte gsl_meta row per leaf visit. The JAX package streams when the
tables outgrow the TPU's SMEM (`tables_resident`); the port keeps that
routing so each mode can be held against its JAX counterpart, and the two
modes return equal results. Attributes are never fused on two-level scenes.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it runs the plain version below: the same walk in lockstep over lanes, the
same tables in the same order and the same f32 arithmetic, so kernel and
plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..accel.superleaf import (
    CH_H2,
    CH_HI,
    CH_HI8,
    CH_ISLEAF,
    CH_LO,
    CH_LO8,
    CH_STRIDE,
    TOP_FAN,
)
from ..core.device import on_cpu
from . import bvh
from . import dense_intersect as dk

F32_MAX = dk.F32_MAX

# Kernel launches (counted only where the kernel is launched), in all and
# by mode (see _mode).
LAUNCHES = {"packet_traverse": 0}
MODE_LAUNCHES = {"single": 0, "resident": 0, "stream": 0}

# Ray-triangle pairs per chunk of the plain version's triangle evaluation:
# bounds its (lanes, SPB) temporaries (32 MB each).
_PLAIN_PAIRS = 1 << 23


def _pack_top(tab):
    """Split the condensed row table into geo (rows, TOP_FAN, 8) f32
    [lo.xyz, hi.xyz, isleaf, 0] and refs (rows, TOP_FAN) i32
    (child_ref << 1) | isleaf, the refs decoded once here
    (pallas_packet.py:72-104)."""

    rows = tab.shape[0]
    t3 = tab.float().reshape(rows, TOP_FAN, CH_STRIDE)
    geo = torch.cat([
        t3[:, :, CH_LO], t3[:, :, CH_HI], t3[:, :, CH_ISLEAF:CH_ISLEAF + 1],
        torch.zeros((rows, TOP_FAN, 1), dtype=torch.float32, device=tab.device),
    ], dim=2).contiguous()
    ref = (t3[:, :, CH_H2].to(torch.int32) * 65536
           + t3[:, :, CH_HI8].to(torch.int32) * 256
           + t3[:, :, CH_LO8].to(torch.int32))
    is_leaf = (t3[:, :, CH_ISLEAF] > 0.5).to(torch.int32)
    return geo, ((ref << 1) | is_leaf).contiguous()


def stack_size(scene) -> int:
    """S + TOP_FAN stack entries (pallas_packet.py:952-953)."""

    return bvh.stack_depth(scene) + TOP_FAN


# The JAX package's bounds of the resident mode (pallas_packet.py:119-132):
# they describe the TPU's 1 MB SMEM, not a limit of the card, and are kept
# so that the same scenes take the same mode in both packages.
RESIDENT_MAX_GSL = 16384
RESIDENT_MAX_INSTANCES = 4096


def tables_resident(scene) -> bool:
    """Whether a two-level scene takes the resident mode (smem_tables_fit)."""

    return (scene.sl_count <= RESIDENT_MAX_GSL
            and scene.num_instances <= RESIDENT_MAX_INSTANCES)


def _mode(scene, stream) -> int:
    """0 single-level, 1 two-level resident, 2 two-level stream; `stream`
    (None or bool) overrides the routing of a two-level scene."""

    if not scene.two_level:
        return 0
    if stream is None:
        stream = not tables_resident(scene)
    return 2 if stream else 1


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
                          with_attrs=False, counts=None, stream=None):
    """Plain version of B4: every lane pops one stack entry per step.
    `counts`, a dict, receives the work this batch needs, for a bound:
    box_tests (child and sub-chunk slab tests), tri_tests (triangles of the
    admitted chunks), chunks (distinct sub-chunks admitted), leaf_visits
    (leaf pops over all rays)."""

    _check(scene, ro, rd, W4, with_attrs)
    mode = _mode(scene, stream)
    if mode == 1:
        gsl_msl, gsl_inst = scene.gsl_msl.long(), scene.gsl_inst.long()
        inv12 = scene.inst_inv.reshape(-1, 12)
    B = ro.x.shape[0]
    dev = ro.x.device
    SP = scene.sl_stride
    sub = scene.sl_sub.float()
    nsub = sub.shape[1]
    spb = SP // nsub
    geo, refs = _pack_top(scene.top_tab)
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
        for ci in range(TOP_FAN):
            stack = bvh._put_row(stack, sp, r8[:, ci], hit8[:, ci])
            sp = sp + hit8[:, ci].to(torch.int32)

        # Leaf pops: sub-chunk boxes (best t at the pop), then the chunks.
        leaf_lanes = lane[is_leaf]
        step = max(1, _PLAIN_PAIRS // spb)
        for s0 in range(0, leaf_lanes.shape[0], step):
            ln = leaf_lanes[s0:s0 + step]
            gref = ref[ln].long()
            if mode == 0:
                wref = gref
                ol = (ro.x[ln], ro.y[ln], ro.z[ln])
                ivl = (ivx[ln], ivy[ln], ivz[ln])
                Rl = R[ln]
            else:
                # The leaf's mesh space: its mesh superleaf, and the ray by
                # its instance's inverse transform.
                if mode == 2:
                    meta = scene.gsl_meta[gref]
                    wref, m12 = meta[:, 0].long(), meta[:, 2:14]
                else:
                    wref, m12 = gsl_msl[gref], inv12[gsl_inst[gref]]
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
        counts.update(box_tests=int(n_box), tri_tests=int(n_tri),
                      chunks=int(touched.sum()), chunk_tris=spb,
                      leaf_visits=int(n_leaf))
    if not with_attrs:
        return bt, bu, bv, bd, bi
    awout = _awout(scene, with_attrs)
    ia = torch.zeros((awout, B), dtype=torch.float32, device=dev)
    hit = bt < F32_MAX
    if bool(hit.any()):
        rows = scene.wt_attr[bi[hit].long()]
        ia[:, hit] = bvh.interp_rows(rows, bu[hit], bv[hit], awout)
    return bt, bu, bv, bd, bi, ia


def packet_traverse(scene, ro, rd, eps, W4, *, active=None, with_attrs=False,
                    stream=None):
    """B4: (t, u, v, det, tri) of the closest hit per ray, t = F32_MAX on a
    miss (u = v = det = 0, tri 0), tri a repacked-soup index (two-level
    scenes: global superleaf * stride + lane); with `with_attrs`
    (single-level scenes only), also the (IA_ROWS[_NM], B) interpolated
    winner rows (kernels/bvh.py IA_* layout, zeros on miss and inactive
    lanes). `stream` forces a two-level scene into the stream (True) or the
    resident (False) mode; None routes it as the JAX package does."""

    if on_cpu(ro.x):
        return packet_traverse_plain(scene, ro, rd, eps, W4, active=active,
                                     with_attrs=with_attrs, stream=stream)
    _check(scene, ro, rd, W4, with_attrs)

    from . import cuda_build

    fn = cuda_build.load("packet").lupin_packet_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 8)
    mode = _mode(scene, stream)
    tabs = [None] * 4  # gsl_msl, gsl_inst, inst_inv, gsl_meta
    if mode == 1:
        tabs[:3] = [scene.gsl_msl.to(torch.int32).contiguous(),
                    scene.gsl_inst.to(torch.int32).contiguous(),
                    scene.inst_inv.float().reshape(-1, 12).contiguous()]
    elif mode == 2:
        tabs[3] = scene.gsl_meta.float().contiguous()
    meta_cols = int(scene.gsl_meta.shape[1])
    dev = ro.x.device
    B = ro.x.shape[0]
    geo, refs = _pack_top(scene.top_tab)
    sub = scene.sl_sub.float().contiguous()
    SM = stack_size(scene)
    act = (torch.ones(B, dtype=torch.int32, device=dev) if active is None
           else active.to(torch.int32).contiguous())
    stack = torch.empty((SM, B), dtype=torch.int32, device=dev)
    t, u, v, det = (torch.empty(B, dtype=torch.float32, device=dev) for _ in range(4))
    tri = torch.empty(B, dtype=torch.int32, device=dev)
    awout = _awout(scene, with_attrs)
    ia = torch.empty((max(awout, 1), B), dtype=torch.float32, device=dev)
    A = scene.wt_attr.contiguous()
    W4 = W4.contiguous()
    rays = [x.contiguous() for x in (*ro, *rd)]
    if B > 0:
        with torch.cuda.device(dev):
            rc = fn(geo.data_ptr(), refs.data_ptr(), sub.data_ptr(),
                    *(x.data_ptr() for x in rays), act.data_ptr(),
                    W4.data_ptr(), W4.shape[2], scene.sl_stride, sub.shape[1],
                    SM, B, float(eps), A.data_ptr(),
                    A.shape[1], awout, mode,
                    *(None if x is None else x.data_ptr() for x in tabs),
                    meta_cols, stack.data_ptr(), t.data_ptr(),
                    u.data_ptr(), v.data_ptr(), det.data_ptr(), tri.data_ptr(),
                    ia.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(rc, "packet_traverse")
        LAUNCHES["packet_traverse"] += 1
        MODE_LAUNCHES[("single", "resident", "stream")[mode]] += 1
    if not with_attrs:
        return t, u, v, det, tri
    return t, u, v, det, tri, ia
