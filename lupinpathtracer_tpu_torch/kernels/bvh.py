"""Kernels B5/B6/B7: the BVH wavefront's top-tree traversal, pair
intersection and winner-attribute fetch.

The counterpart of lupinpathtracer_tpu/kernels/pallas_bvh.py:

- B5 `top_traverse` (`_top_kernel`, pallas_call at pallas_bvh.py:344): one
  resumable round of 8-wide top-tree traversal per ray, emitting up to Q
  superleaf ids near to far, plus the per-superleaf demand histogram and
  the per-ray AABB-test count.
- B6 `pair_intersect` (`_pair_kernel`, :665): closest hit of superleaf-sorted
  rays against their work item's superleaf, local triangle index out.
- B7 `attr_fetch` (`_attr_kernel`, :896): the winner's attribute row,
  interpolated at the hit barycentrics into the compact IA_* rows.

The orchestration (rounds, sorts, work items, per-ray min) lives in
kernels/intersect.py. On a CUDA tensor each wrapper launches its kernel from
csrc/bvh.cu or raises; on a CPU tensor it runs the plain PyTorch version
below, which performs the same f32 arithmetic in the same order (B5 and B7
exactly; B6 with the dense kernel's plain version per superleaf segment).

Work items (blk, sl, lo, hi) are as in the JAX package: item k covers the
sorted positions [lo, hi) that fall inside ray block blk (PB lanes), all
against superleaf sl; items with lo == hi are skipped, and only the first
`n_items` (a one-element device tensor, so no host sync) are valid.
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
    TOP_COLS,
    TOP_FAN,
)
from . import dense_intersect as dk

F32_MAX = dk.F32_MAX

# Output row layout of B7 (and of B4's attribute phase): per-winner shading
# quantities interpolated at the hit (pallas_bvh.py:692-704).
IA_N = slice(0, 3)  # n0*w + n1*u + n2*v (unnormalized)
IA_GN = slice(3, 6)  # geometric normal
IA_TU = 6  # interpolated texcoord u
IA_TV = 7  # interpolated texcoord v
IA_HAS_UV = 8
IA_VC = slice(9, 12)  # interpolated vertex color rgb
IA_VCA = 12  # interpolated vertex alpha
IA_DET_SIGN = 13
IA_MAT_ID = 14
IA_ROWS = 16  # row 15 unused
IA_TAN = slice(16, 19)  # only with normal maps
IA_BIT = slice(19, 22)
IA_ROWS_NM = 24

# In-kernel demand histogram only up to this many superleaves
# (pallas_bvh.py:317); above it the caller takes the searchsorted branch.
HIST_MAX_SL = 4096

# The 19-comparator network that orders a node's 8 (t, ref) pairs, swapping
# only on a strict > (pallas_bvh.py:205-218); csrc/bvh.cu has the same one.
SORT_NET = (
    (0, 1), (2, 3), (0, 2), (1, 3), (1, 2),
    (4, 5), (6, 7), (4, 6), (5, 7), (5, 6),
    (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
    (1, 2), (3, 4), (5, 6),
)

TWO_LEVEL_TODO = (
    "two-level (instanced) BVH scenes are not ported yet: ROADMAP.md "
    "Queue A item 9"
)

# Kernel launches per wrapper (counted only where a kernel is launched).
LAUNCHES = {"top_traverse": 0, "pair_intersect": 0, "attr_fetch": 0}


def stack_depth(scene) -> int:
    """Entries S of a ray's top-tree stack (intersect.py:660,
    pallas_packet.py:952)."""

    return (TOP_FAN - 1) * scene.top_depth + TOP_FAN + 2


def hist_bins(n_sl: int) -> int:
    """Length of B5's histogram output (0: not produced)."""

    if n_sl > HIST_MAX_SL:
        return 0
    return max(-(-n_sl // 128) * 128, 128)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def slab(rox, roy, roz, ivx, ivy, ivz, lo, hi):
    """(t_near, t_far) of the slab test (pathtracer.wgsl:2906-2918); lo/hi
    are 3-tuples broadcasting against the rays. min/max propagate NaN, as
    jnp.minimum/maximum do and as csrc/bvh.cu's nmin/nmax do."""

    tx1 = (lo[0] - rox) * ivx
    tx2 = (hi[0] - rox) * ivx
    ty1 = (lo[1] - roy) * ivy
    ty2 = (hi[1] - roy) * ivy
    tz1 = (lo[2] - roz) * ivz
    tz2 = (hi[2] - roz) * ivz
    mn, mx = torch.minimum, torch.maximum
    t_far = mn(mn(mx(tx1, tx2), mx(ty1, ty2)), mx(tz1, tz2))
    t_near = mx(mx(mn(tx1, tx2), mn(ty1, ty2)), mn(tz1, tz2))
    return t_near, t_far


def _put_row(buf, row, val, mask):
    """buf[row[l], l] = val[l] where mask[l] and 0 <= row[l] < len(buf)."""

    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    return torch.where((rows == row[None, :]) & mask[None, :], val[None, :], buf)


def top_traverse_plain(tab, ro, rd, best_t, stack, sp, *, S, Q, n_sl,
                       counts=None):
    """Plain version of B5: every lane pops in lockstep, with the Pallas
    kernel's per-lane semantics (pallas_bvh.py:160-240). `stack` is updated
    in place, as the kernel updates it. `counts`, a dict, receives the stack
    entries popped and pushed, for a bound."""

    Bp = ro.x.shape[0]
    dev = ro.x.device
    tab = tab.float().reshape(-1, TOP_FAN, CH_STRIDE)
    ivx, ivy, ivz = 1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z
    stack_io = stack
    sp = sp.clone()
    pops = pushes = 0
    cnt = torch.zeros(Bp, dtype=torch.int32, device=dev)
    out = torch.full((Q, Bp), -1, dtype=torch.int32, device=dev)
    aabb = torch.zeros(Bp, dtype=torch.int32, device=dev)
    while True:
        active = (sp > 0) & (cnt < Q)
        if not bool(active.any()):
            break
        pops += int(active.sum())
        spm1 = torch.where(active, sp - 1, 0)
        top = stack.gather(0, spm1.clamp(max=S - 1).long()[None, :])[0]
        node = torch.where(active & (spm1 < S), top, 0)
        sp = torch.where(active, spm1, sp)

        em = active & (node < 0)
        out = _put_row(out, cnt, -node - 1, em)
        cnt = cnt + em.to(torch.int32)

        is_int = active & (node >= 0)
        g = tab[torch.where(is_int, node, 0).long()]  # (Bp, 8, 10)
        ts, refs = [], []
        for ci in range(TOP_FAN):
            c = g[:, ci]
            near, far = slab(
                ro.x, ro.y, ro.z, ivx, ivy, ivz,
                [c[:, CH_LO.start + k] for k in range(3)],
                [c[:, CH_HI.start + k] for k in range(3)],
            )
            t_c = torch.where((far >= near) & (far > 0.0), near, F32_MAX)
            ts.append(torch.where(c[:, CH_ISLEAF] > -0.5, t_c, F32_MAX))
            rid = (c[:, CH_H2] * 65536.0 + c[:, CH_HI8] * 256.0
                   + c[:, CH_LO8]).to(torch.int32)
            refs.append(torch.where(c[:, CH_ISLEAF] > 0.5, -rid - 1, rid))
        for a, b in SORT_NET:
            swap = ts[a] > ts[b]
            ts[a], ts[b] = (torch.where(swap, ts[b], ts[a]),
                            torch.where(swap, ts[a], ts[b]))
            refs[a], refs[b] = (torch.where(swap, refs[b], refs[a]),
                                torch.where(swap, refs[a], refs[b]))
        rem = []
        for ci in range(TOP_FAN):  # near -> far: emit leaves
            hit_c = is_int & (ts[ci] < best_t)
            em_c = hit_c & (refs[ci] < 0) & (cnt < Q)
            out = _put_row(out, cnt, -refs[ci] - 1, em_c)
            cnt = cnt + em_c.to(torch.int32)
            rem.append(hit_c & ~em_c)
        for ci in range(TOP_FAN - 1, -1, -1):  # far -> near: push the rest
            stack = _put_row(stack, sp, refs[ci], rem[ci])
            sp = sp + rem[ci].to(torch.int32)
            pushes += int(rem[ci].sum())
        aabb = aabb + torch.where(is_int, TOP_FAN, 0).to(torch.int32)

    nb = hist_bins(n_sl)
    cnt_sl = None
    if nb:
        keys = torch.where(out >= 0, out, nb).reshape(-1).long()
        cnt_sl = torch.bincount(keys, minlength=nb + 1)[:nb].to(torch.int32)
    stack_io.copy_(stack)
    if counts is not None:
        counts.update(pops=pops, pushes=pushes)
    return out, cnt, stack_io, sp, cnt_sl, aabb


def _item_ranges(blk, lo, hi, n_items, PB):
    """Host list of (item, first, end) position ranges of the valid items."""

    n = int(n_items) if n_items is not None else int(blk.shape[0])
    rows = torch.stack([blk[:n], lo[:n], hi[:n]]).cpu().tolist()
    out = []
    for k, (b, l_, h) in enumerate(zip(*rows)):
        a, e = max(l_, b * PB), min(h, b * PB + PB)
        if e > a:
            out.append((k, a, e))
    return out


def pair_intersect_plain(blk, sl, lo, hi, ro, rd, W4, eps, *, SP,
                         pair_block=256, n_items=None):
    """Plain version of B6: each run of positions that share a superleaf
    goes through the dense closest hit's plain version against that
    superleaf's (4, 10, SP) slice. Miss lanes: t = F32_MAX, u = v = det = 0,
    local index 0; uncovered positions keep those values."""

    P = ro.x.shape[0]
    dev = ro.x.device
    t = torch.full((P,), F32_MAX, dtype=torch.float32, device=dev)
    u, v, det = (torch.zeros(P, dtype=torch.float32, device=dev) for _ in range(3))
    li = torch.zeros(P, dtype=torch.int32, device=dev)
    c = (ro.y * rd.z - ro.z * rd.y, ro.z * rd.x - ro.x * rd.z,
         ro.x * rd.y - ro.y * rd.x)
    R = torch.stack([rd.x, rd.y, rd.z, *c, ro.x, ro.y, ro.z,
                     torch.ones_like(ro.x)], dim=-1)
    sl_h = sl.cpu().tolist()
    runs = []  # merge consecutive ranges of one superleaf
    for k, a, e in _item_ranges(blk, lo, hi, n_items, pair_block):
        s = sl_h[k]
        if runs and runs[-1][0] == s and runs[-1][2] == a:
            runs[-1][2] = e
        else:
            runs.append([s, a, e])
    for s, a, e in runs:
        out = dk.dense_closest_hit_plain(W4[:, :, s * SP:(s + 1) * SP], R[a:e], eps)
        t[a:e], u[a:e], v[a:e], det[a:e], li[a:e] = out
    return t, u, v, det, li


def interp_rows(a, hu, hv, awout):
    """IA_* rows (awout, n) from attribute rows a (n, AW) at barycentrics
    (hu, hv), as _attr_kernel computes them (pallas_bvh.py:750-786)."""

    hw = 1.0 - hu - hv

    def interp(s0, s1, s2, c):
        return a[:, s0.start + c] * hw + a[:, s1.start + c] * hu + a[:, s2.start + c] * hv

    rows = [torch.zeros_like(hu)] * awout
    for c in range(3):
        rows[IA_N.start + c] = interp(dk.ATTR_N0, dk.ATTR_N1, dk.ATTR_N2, c)
        rows[IA_GN.start + c] = a[:, dk.ATTR_GN.start + c]
        rows[IA_VC.start + c] = interp(dk.ATTR_C0, dk.ATTR_C1, dk.ATTR_C2, c)
    rows[IA_TU] = interp(dk.ATTR_UV0, dk.ATTR_UV1, dk.ATTR_UV2, 0)
    rows[IA_TV] = interp(dk.ATTR_UV0, dk.ATTR_UV1, dk.ATTR_UV2, 1)
    rows[IA_HAS_UV] = a[:, dk.ATTR_HAS_UV]
    rows[IA_VCA] = interp(dk.ATTR_C0, dk.ATTR_C1, dk.ATTR_C2, 3)
    rows[IA_DET_SIGN] = a[:, dk.ATTR_DET_SIGN]
    rows[IA_MAT_ID] = a[:, dk.ATTR_MAT_ID]
    if awout >= IA_ROWS_NM:
        for c in range(3):
            rows[IA_TAN.start + c] = a[:, dk.ATTR_TAN.start + c]
            rows[IA_BIT.start + c] = a[:, dk.ATTR_BIT.start + c]
    return torch.stack(rows, dim=0)


def attr_fetch_plain(blk, sl, lo, hi, li, hu, hv, A3, *, pair_block=256,
                     with_tangents=False, n_items=None):
    """Plain version of B7: rows of covered positions, zeros elsewhere.
    Single-level items only (rows unrotated, mat_id kept)."""

    P = li.shape[0]
    awout = IA_ROWS_NM if with_tangents else IA_ROWS
    out = torch.zeros((awout, P), dtype=torch.float32, device=li.device)
    ranges = _item_ranges(blk, lo, hi, n_items, pair_block)
    if not ranges:
        return out
    sl_h = sl.cpu().tolist()
    pos = torch.cat([torch.arange(a, e) for _, a, e in ranges]).to(li.device)
    msl = torch.cat([torch.full((e - a,), sl_h[k], dtype=torch.long)
                     for k, a, e in ranges]).to(li.device)
    rows = A3[msl, li[pos].long()]
    out[:, pos] = interp_rows(rows, hu[pos], hv[pos], awout)
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _f32(*xs):
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")


def _i32(*xs):
    for x in xs:
        if x.dtype != torch.int32:
            raise TypeError(f"expected int32, got {x.dtype}")


def _items_check(blk, sl, lo, hi, n_items):
    _i32(blk, sl, lo, hi)
    n = blk.shape[0]
    if not (sl.shape[0] == lo.shape[0] == hi.shape[0] == n):
        raise ValueError("work-item arrays differ in length")
    if n_items is None:
        n_items = torch.tensor([n], dtype=torch.int32, device=blk.device)
    n_items = n_items.reshape(1).to(torch.int32)
    return n_items


def top_traverse(tab, ro, rd, best_t, stack, sp, *, S, Q, n_sl):
    """B5: one round of top-tree traversal. tab: (rows, TOP_COLS) top table
    (bf16 or its f32 values); ro/rd: V3 over Bp lanes; best_t (Bp,);
    stack (S, Bp) i32, contiguous, updated in place; sp (Bp,) i32. Returns
    (sl (Q, Bp) i32 with -1 empties, cnt (Bp,), stack (the argument), sp',
    cnt_sl (hist_bins(n_sl),) i32 or None, aabb (Bp,) i32 slab tests this
    round)."""

    tab = tab.float().contiguous()
    if tab.dim() != 2 or tab.shape[1] != TOP_COLS:
        raise ValueError(f"tab must be (rows, {TOP_COLS}), got {tuple(tab.shape)}")
    Bp = ro.x.shape[0]
    if stack.shape != (S, Bp):
        raise ValueError(f"stack must be ({S}, {Bp}), got {tuple(stack.shape)}")
    _i32(stack, sp)
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous: it is updated in place")
    _f32(best_t, *ro, *rd)
    if ro.x.device.type != "cuda":
        return top_traverse_plain(tab, ro, rd, best_t, stack, sp, S=S, Q=Q, n_sl=n_sl)

    from . import cuda_build

    fn = cuda_build.load("bvh").lupin_top_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 7)
    dev = ro.x.device
    nb = hist_bins(n_sl)
    sl = torch.empty((Q, Bp), dtype=torch.int32, device=dev)
    cnt, sp_o, aabb = (torch.empty(Bp, dtype=torch.int32, device=dev) for _ in range(3))
    hist = torch.zeros(max(nb, 1), dtype=torch.int32, device=dev)
    ins = [x.contiguous() for x in (tab, *ro, *rd, best_t, sp)]
    with torch.cuda.device(dev):
        rc = fn(*(x.data_ptr() for x in ins), S, Q, Bp, nb, stack.data_ptr(),
                sl.data_ptr(), cnt.data_ptr(), sp_o.data_ptr(),
                hist.data_ptr(), aabb.data_ptr(), _stream(dev))
    cuda_build.check(rc, "top_traverse")
    LAUNCHES["top_traverse"] += 1
    return sl, cnt, stack, sp_o, (hist if nb else None), aabb


def pair_intersect(blk, sl, lo, hi, ro, rd, W4, eps, *, SP, pair_block=256,
                   n_items=None):
    """B6: work-item pair intersection over superleaf-sorted rays. ro/rd:
    V3 of sorted pair rays (P,); W4 (4, 10, n_msl*SP); sl holds each item's
    (mesh) superleaf. Returns per sorted position (t, u, v, det, LOCAL tri
    index in [0, SP)); uncovered positions hold a miss."""

    n_items = _items_check(blk, sl, lo, hi, n_items)
    _f32(W4, *ro, *rd)
    if W4.dim() != 3 or W4.shape[:2] != (4, 10) or W4.shape[2] % SP:
        raise ValueError(f"W4 must be (4, 10, n*{SP}), got {tuple(W4.shape)}")
    if ro.x.device.type != "cuda":
        return pair_intersect_plain(blk, sl, lo, hi, ro, rd, W4, eps, SP=SP,
                                    pair_block=pair_block, n_items=n_items)

    from . import cuda_build

    fn = cuda_build.load("bvh").lupin_pair_intersect
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 6)
    dev = ro.x.device
    P = ro.x.shape[0]
    t = torch.full((P,), F32_MAX, dtype=torch.float32, device=dev)
    u, v, det = (torch.zeros(P, dtype=torch.float32, device=dev) for _ in range(3))
    li = torch.zeros(P, dtype=torch.int32, device=dev)
    ins = [x.contiguous() for x in (blk, sl, lo, hi, n_items, *ro, *rd, W4)]
    with torch.cuda.device(dev):
        rc = fn(*(x.data_ptr() for x in ins), W4.shape[2], blk.shape[0], SP,
                pair_block, P, float(eps), t.data_ptr(), u.data_ptr(),
                v.data_ptr(), det.data_ptr(), li.data_ptr(), _stream(dev))
    cuda_build.check(rc, "pair_intersect")
    LAUNCHES["pair_intersect"] += 1
    return t, u, v, det, li


def attr_fetch(blk, sl, lo, hi, li, hu, hv, A3, *, pair_block=256,
               with_tangents=False, n_items=None):
    """B7: li (P,) local winner index per sorted ray, hu/hv (P,) its
    barycentrics, A3 (n_msl, SP, AW) attribute slices. Returns
    (IA_ROWS[_NM], P) rows in sorted order, zeros on uncovered positions."""

    n_items = _items_check(blk, sl, lo, hi, n_items)
    _i32(li)
    _f32(hu, hv, A3)
    if A3.dim() != 3:
        raise ValueError(f"A3 must be (n_msl, SP, AW), got {tuple(A3.shape)}")
    if li.device.type != "cuda":
        return attr_fetch_plain(blk, sl, lo, hi, li, hu, hv, A3,
                                pair_block=pair_block,
                                with_tangents=with_tangents, n_items=n_items)

    from . import cuda_build

    fn = cuda_build.load("bvh").lupin_attr_fetch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    dev = li.device
    P = li.shape[0]
    awout = IA_ROWS_NM if with_tangents else IA_ROWS
    out = torch.zeros((awout, P), dtype=torch.float32, device=dev)
    A3 = A3.contiguous()
    ins = [x.contiguous() for x in (blk, sl, lo, hi, n_items, li, hu, hv)]
    with torch.cuda.device(dev):
        rc = fn(*(x.data_ptr() for x in ins), A3.data_ptr(), blk.shape[0],
                A3.shape[1], A3.shape[2], pair_block, P, awout,
                out.data_ptr(), _stream(dev))
    cuda_build.check(rc, "attr_fetch")
    LAUNCHES["attr_fetch"] += 1
    return out
