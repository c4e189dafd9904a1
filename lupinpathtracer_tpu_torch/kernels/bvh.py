"""Kernels B5/B6/B7: the BVH wavefront's top-tree traversal, pair
intersection and winner-attribute fetch.

The counterpart of lupinpathtracer_tpu/kernels/pallas_bvh.py:

- B5 `top_traverse` (`_top_kernel`, pallas_call at pallas_bvh.py:344): one
  resumable round of 8-wide top-tree traversal per ray, emitting up to Q
  superleaf ids near to far, plus the per-superleaf demand histogram and
  the per-ray AABB-test count. The kernel (csrc/bvh.cu) reads the top
  table's packed rows (`top_rows`, kept on the table) and runs a launch of
  few rays at eight lanes per ray, a larger one at one thread per ray.
- B6 `pair_intersect` (`_pair_kernel`, :665): closest hit of superleaf-sorted
  rays against their work item's superleaf, local triangle index out; with
  an instance word per item (two-level scenes) the item's rays first move
  to mesh space. The kernel (csrc/pair_intersect.cuh) runs one thread per
  sorted position, finds the item covering it (`pair_item_map` is that
  lookup in PyTorch) and reads the coefficients packed once per matrix
  (`pair_table`).
- B6' `pair_intersect_variant`: the ablation variants of B6
  (tools/prof_pair.py:276 of the JAX repo, `run_variant`), for
  tools/prof_pair.py of this package; V0 is B6's earlier design (a block per
  work item), equal to B6 bit for bit.
- B7 `attr_fetch` (`_attr_kernel`, :896): the winner's attribute row,
  interpolated at the hit barycentrics into the compact IA_* rows; with an
  instance word per item, rotated by the instance's normal matrix and given
  its material override. The kernel (csrc/bvh.cu) runs one thread per
  sorted position in tiles of ATTR_TILE, finds the covering item with B6's
  lookup and reads the row's touched sectors as 16-byte loads.

The orchestration (rounds, sorts, work items, per-ray min) lives in
kernels/intersect.py. On a CUDA tensor each wrapper launches its kernel from
csrc/bvh.cu (csrc/pair_variants.cu for B6') or raises; on a CPU tensor it
runs the plain PyTorch version below, which performs the same f32
arithmetic in the same order.

Work items (blk, sl, lo, hi) are as in the JAX package: item k covers the
sorted positions [lo, hi) that fall inside ray block blk (PB lanes), all
against superleaf sl; items with lo == hi are skipped, and only the first
`n_items` (a one-element device tensor, so no host sync) are valid. B6's
kernel also needs them ordered by the positions they cover, each position
in at most one item, as `intersect._wf_work_items` makes them.
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
from ..core.device import on_cpu
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

# B6' variants (csrc/pair_kernel.cuh). V4 differs from V0 only in the
# kernel's shared-memory tile, so its plain version is V0's.
PAIR_VARIANTS = ("V0", "V1", "V2", "V3", "V4", "V5")

# Kernel launches per wrapper (counted only where a kernel is launched).
LAUNCHES = {"top_traverse": 0, "pair_intersect": 0, "attr_fetch": 0,
            "pair_intersect_variant": 0}

# Sorted positions per block of B6's kernel (csrc/pair_intersect.cuh
# PI_THREADS), and the (tile, triangle chunk) units its split scratch holds:
# a launch of fewer tiles splits each tile's triangles to fill the card.
PAIR_TILE = 256
PAIR_SPLIT_UNITS = 4096
# Sorted positions per block of B7's kernel (csrc/bvh.cu AT_TILE).
ATTR_TILE = 256
PAIR_SPLIT_MIN = 64

# Ray-triangle pairs per chunk of B6's plain version: bounds its (lanes, SP)
# temporaries (16 MB each).
_PLAIN_PAIRS = 1 << 22


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
    entries popped and pushed, the internal pops (those that read a row)
    and the distinct rows they read, for a bound."""

    Bp = ro.x.shape[0]
    dev = ro.x.device
    tab = tab.float().reshape(-1, TOP_FAN, CH_STRIDE)
    ivx, ivy, ivz = 1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z
    stack_io = stack
    sp = sp.clone()
    pops = pushes = internal = 0
    read = torch.zeros(tab.shape[0], dtype=torch.bool, device=dev)
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
        if counts is not None:
            internal += int(is_int.sum())
            read[node[is_int].long()] = True
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
        counts.update(pops=pops, pushes=pushes, internal_pops=internal,
                      rows_read=int(read.sum()))
    return out, cnt, stack_io, sp, cnt_sl, aabb


def _item_lanes(blk, lo, hi, n_items, PB, P):
    """(pos, item) of every covered sorted position, as the kernels cover
    them: item k owns the lanes of ray block blk[k] that fall in
    [lo[k], hi[k]) and below P. Only the first n_items items count (one
    host sync to read it)."""

    n = int(n_items) if n_items is not None else int(blk.shape[0])
    dev = blk.device
    b, l_, h = (x[:n].long()[:, None] for x in (blk, lo, hi))
    pos = b * PB + torch.arange(PB, device=dev)[None, :]
    live = (pos >= l_) & (pos < h) & (pos < P)
    item = torch.arange(n, device=dev)[:, None].expand_as(pos)
    return pos[live], item[live]


def pair_item_map(blk, lo, hi, n_items, PB, P):
    """(P,) int64: per sorted position the item that covers it, -1 where
    none, found as B6's kernel finds it (csrc/pair_intersect.cuh): the last
    item whose first covered position max(lo, blk * PB) is at or before the
    position (among items with equal starts, the last non-empty one), if the
    position lies below that item's end min(hi, blk * PB + PB, P). Items
    must be ordered by the positions they cover (bvh.py's module note); then
    this equals the coverage of `_item_lanes`."""

    n = int(n_items) if n_items is not None else int(blk.shape[0])
    dev = blk.device
    b, l_, h = (x[:n].long() for x in (blk, lo, hi))
    c = torch.maximum(l_, b * PB)
    e = torch.minimum(torch.minimum(h, b * PB + PB), torch.full_like(h, P))
    pos = torch.arange(P, device=dev)
    out = torch.full((P,), -1, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    i = torch.searchsorted(c.contiguous(), pos, right=True) - 1
    k = torch.arange(n, device=dev)
    last_ne = torch.cummax(torch.where(e > c, k, -1), 0).values
    ic = i.clamp_min(0)
    ne = last_ne[ic]
    pick = torch.where((ne >= 0) & (c[ne.clamp_min(0)] == c[ic]), ne, ic)
    covered = (i >= 0) & (pos < e[pick])
    return torch.where(covered, pick, out)


def pair_split(SP: int, n_tiles: int, cap: int = PAIR_SPLIT_UNITS):
    """(KS, KC): how B6's kernel splits each of a launch's n_tiles tiles
    (csrc/pair_intersect.cuh): fewer tiles than `cap` units split each
    tile's SP triangles into KS chunks of KC (a multiple of 4, at least
    PAIR_SPLIT_MIN unless SP is smaller), KS * n_tiles <= cap; chunk c is
    [c * KC, min(SP, c * KC + KC))."""

    ks = 1
    if 0 < n_tiles < cap:
        ks = min(max(SP // PAIR_SPLIT_MIN, 1), cap // n_tiles)
    kc = (-(-SP // ks) + 3) & ~3
    return -(-SP // kc), kc


def pair_table(W4):
    """The coefficient table of B6 and B3: the (4, 10, T) matrix packed as
    (ceil(T / 4), 40, 4) f32, element [g, c * 10 + q, k] = W4[c, q, 4g + k],
    so that a group of four triangles is 640 contiguous bytes
    (csrc/pair_intersect.cuh, csrc/mega.cu); the padding triangles past T
    are all zero (det = 0: never valid). Built once per matrix and kept on
    it (scenes cache their matrix: intersect.scene_tri_matrix); rebuilt if
    the matrix was written since."""

    cached = W4.__dict__.get("_pair_table")
    if cached is not None and cached[0] == W4._version:
        return cached[1]
    T = W4.shape[2]
    Tg = -(-T // 4)
    flat = W4.new_zeros((40, Tg * 4))
    flat[:, :T] = W4.reshape(40, T)
    table = flat.reshape(40, Tg, 4).permute(1, 0, 2).contiguous()
    W4.__dict__["_pair_table"] = (W4._version, table)
    return table


def top_rows(tab):
    """The top table packed for B4 and B5: geo (rows, TOP_FAN, 8) f32
    [lo.xyz, hi.xyz, isleaf, 0], so that a child's box is two 16-byte loads
    and a row 256 contiguous bytes, and refs (rows, TOP_FAN) i32
    (child_ref << 1) | is_leaf, each reference decoded once from its three
    float fields (pallas_packet.py:72-104). isleaf keeps the table's
    marker: 1 leaf, 0 internal, -1 an empty slot. Built once per table and
    kept on it (a scene's top_tab: every caller gets the same tensors,
    which must not be modified); rebuilt if the table was written since."""

    cached = tab.__dict__.get("_top_rows")
    if cached is not None and cached[0] == tab._version:
        return cached[1]
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
    out = (geo, ((ref << 1) | is_leaf).contiguous())
    tab.__dict__["_top_rows"] = (tab._version, out)
    return out


def mesh_space(m12, ro, rd):
    """Rays moved to mesh space by (n, 12) inverse-transform rows, one per
    ray (pallas_bvh.py:430-439): m0*x + m1*y + m2*z + m3 summed left to
    right; the direction is not normalised, so t stays world-scaled."""

    m = [m12[:, j] for j in range(12)]
    o = (m[0] * ro[0] + m[1] * ro[1] + m[2] * ro[2] + m[3],
         m[4] * ro[0] + m[5] * ro[1] + m[6] * ro[2] + m[7],
         m[8] * ro[0] + m[9] * ro[1] + m[10] * ro[2] + m[11])
    d = (m[0] * rd[0] + m[1] * rd[1] + m[2] * rd[2],
         m[4] * rd[0] + m[5] * rd[1] + m[6] * rd[2],
         m[8] * rd[0] + m[9] * rd[1] + m[10] * rd[2])
    return o, d


def ray_feature_rows(o, d):
    """R = [d, o x d, o, 1], (n, 10), from component tuples."""

    c = (o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
         o[0] * d[1] - o[1] * d[0])
    return torch.stack([*d, *c, *o, torch.ones_like(o[0])], dim=-1)


def _pair_select(det, nu, nv, nt, eps, variant):
    """Per-lane winner over the SP triangles of (n, SP) numerators, as the
    kernel variant selects it: (t, u, v, det, index), the first index on a
    tie, a miss as (F32_MAX, 0, 0, 0, 0)."""

    if variant == "V5":
        t = torch.clamp_max(nt.min(dim=1).values, F32_MAX)
        z = torch.zeros_like(t)
        return t, z, z, z, torch.zeros_like(t, dtype=torch.int32)
    if variant in ("V1", "V3"):
        ad = torch.rsqrt(det * det)
        t = nt * ad
        t = torch.where(det < 0.0, -t, t)
        valid = ((nu * det >= 0.0) & (nv * det >= 0.0)
                 & ((det - nu - nv) * det >= 0.0) & (t >= eps))
        tt = torch.where(valid, t, F32_MAX)
        u = v = None
    else:
        tt, u, v = dk.dense_epilogue(det, nu, nv, nt, eps)
    best = torch.argmin(tt, dim=1, keepdim=True)
    bt = tt.gather(1, best)[:, 0]
    hit = bt < F32_MAX

    def pick(x):
        return x.gather(1, best)[:, 0]

    idx = torch.where(hit, best[:, 0], 0).to(torch.int32)
    z = torch.zeros_like(bt)
    if variant in ("V2", "V3"):
        return torch.where(hit, bt, F32_MAX), z, z, z, idx
    if variant == "V1":
        # Exact t, u, v, det of the selected triangle.
        wdet = pick(det)
        d = 1.0 / wdet
        return (torch.where(hit, pick(nt) * d, F32_MAX),
                torch.where(hit, pick(nu) * d, z),
                torch.where(hit, pick(nv) * d, z), torch.where(hit, wdet, z), idx)
    return (torch.where(hit, bt, F32_MAX), torch.where(hit, pick(u), z),
            torch.where(hit, pick(v), z), torch.where(hit, pick(det), z), idx)


def pair_intersect_plain(blk, sl, lo, hi, ro, rd, W4, eps, *, SP,
                         pair_block=256, n_items=None, inst=None,
                         txf_tab=None, variant="V0"):
    """Plain version of B6 and of its variants: every covered position
    against its item's (4, 10, SP) coefficient slice, the four numerators
    summed in the kernel's order (the dense kernel's plain numerators). Miss lanes: t = F32_MAX, u = v = det = 0,
    local index 0; uncovered positions keep those values. With inst and
    txf_tab, an item's rays first move to mesh space by row inst[k] of the
    (n_inst, 12) inverse transforms."""

    if variant not in PAIR_VARIANTS:
        raise ValueError(f"unknown pair variant {variant!r}")
    if (inst is None) != (txf_tab is None):
        raise ValueError("inst and txf_tab come together")
    P = ro.x.shape[0]
    dev = ro.x.device
    t = torch.full((P,), F32_MAX, dtype=torch.float32, device=dev)
    u, v, det = (torch.zeros(P, dtype=torch.float32, device=dev) for _ in range(3))
    li = torch.zeros(P, dtype=torch.int32, device=dev)
    pos, item = _item_lanes(blk, lo, hi, n_items, pair_block, P)
    if pos.numel() == 0:
        return t, u, v, det, li
    o, d = tuple(c[pos] for c in ro), tuple(c[pos] for c in rd)
    if inst is not None:
        o, d = mesh_space(txf_tab[inst.long()[item]], o, d)
    R = ray_feature_rows(o, d)
    # Positions grouped by mesh superleaf: each group against one slice.
    msl = sl.long()[item]
    order = torch.argsort(msl, stable=True)
    ids, counts = torch.unique_consecutive(msl[order], return_counts=True)
    step = max(1, _PLAIN_PAIRS // SP)
    first = 0
    for m, n in zip(ids.tolist(), counts.tolist()):
        Ws = W4[:, :, m * SP:(m + 1) * SP]
        for s0 in range(first, first + n, step):
            sel = order[s0:min(s0 + step, first + n)]
            out = _pair_select(*dk.dense_numerators(R[sel], Ws), eps, variant)
            p = pos[sel]
            t[p], u[p], v[p], det[p], li[p] = out
        first += n
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


def rotate3(nm, x, y, z, renorm=None):
    """(x, y, z) rotated by the row-major 3x3 rows nm (n, 9), each component
    summed left to right; where `renorm` (bool, (n,)) the result is scaled to
    unit length by 1 / sqrt(max(len^2, 1e-30)) (pallas_bvh.py:799-814; the
    IEEE expression, which the CUDA kernel computes too)."""

    rx = nm[:, 0] * x + nm[:, 1] * y + nm[:, 2] * z
    ry = nm[:, 3] * x + nm[:, 4] * y + nm[:, 5] * z
    rz = nm[:, 6] * x + nm[:, 7] * y + nm[:, 8] * z
    if renorm is not None:
        inv = 1.0 / torch.sqrt(torch.clamp_min(rx * rx + ry * ry + rz * rz, 1e-30))
        inv = torch.where(renorm, inv, 1.0)
        rx, ry, rz = rx * inv, ry * inv, rz * inv
    return rx, ry, rz


def rotate_rows(rows, nm, ovr):
    """Two-level tail of the attribute rows (pallas_bvh.py:788-825): IA_N,
    IA_GN and, when present, IA_TAN / IA_BIT of rows (awout, n) rotated by
    each lane's instance normal matrix nm (n, 9); IA_GN renormalised and
    IA_MAT_ID replaced by the override ovr (n,) i32, both only where
    ovr >= 0."""

    rows = list(rows)
    on = ovr >= 0
    spans = [(IA_N, None), (IA_GN, on)]
    if len(rows) >= IA_ROWS_NM:
        spans += [(IA_TAN, None), (IA_BIT, None)]
    for sl3, renorm in spans:
        rows[sl3.start:sl3.stop] = rotate3(nm, *rows[sl3.start:sl3.stop], renorm)
    rows[IA_MAT_ID] = torch.where(on, ovr.to(torch.float32), rows[IA_MAT_ID])
    return torch.stack(rows, dim=0)


def attr_fetch_plain(blk, sl, lo, hi, li, hu, hv, A3, *, pair_block=256,
                     with_tangents=False, n_items=None, inst=None,
                     nrm_tab=None, ovr_tab=None):
    """Plain version of B7: rows of covered positions, zeros elsewhere. With
    inst, nrm_tab (n_inst, 9) and ovr_tab (n_inst,), an item's rows are
    rotated and overridden by row inst[k] of the tables (rotate_rows)."""

    P = li.shape[0]
    awout = IA_ROWS_NM if with_tangents else IA_ROWS
    out = torch.zeros((awout, P), dtype=torch.float32, device=li.device)
    pos, item = _item_lanes(blk, lo, hi, n_items, pair_block, P)
    if pos.numel() == 0:
        return out
    rows = interp_rows(A3[sl.long()[item], li[pos].long()], hu[pos], hv[pos], awout)
    if inst is not None:
        i = inst.long()[item]
        rows = rotate_rows(rows, nrm_tab[i], ovr_tab[i])
    out[:, pos] = rows
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
    (bf16 or its f32 values; the kernel reads its packed rows, top_rows,
    kept on the tensor: pass the scene's top_tab); ro/rd: V3 over Bp lanes;
    best_t (Bp,); stack (S, Bp) i32, contiguous, updated in place; sp (Bp,)
    i32. Returns (sl (Q, Bp) i32 with -1 empties, cnt (Bp,), stack (the
    argument), sp', cnt_sl (hist_bins(n_sl),) i32 or None, aabb (Bp,) i32
    slab tests this round). Of the stack only the entries below a lane's
    sp' are defined: the only ones a later round reads (entries pushed and
    popped within the round may not be written)."""

    if tab.dim() != 2 or tab.shape[1] != TOP_COLS:
        raise ValueError(f"tab must be (rows, {TOP_COLS}), got {tuple(tab.shape)}")
    Bp = ro.x.shape[0]
    if stack.shape != (S, Bp):
        raise ValueError(f"stack must be ({S}, {Bp}), got {tuple(stack.shape)}")
    _i32(stack, sp)
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous: it is updated in place")
    _f32(best_t, *ro, *rd)
    if on_cpu(ro.x):
        return top_traverse_plain(tab, ro, rd, best_t, stack, sp, S=S, Q=Q, n_sl=n_sl)

    from . import cuda_build

    out = _top_launch(cuda_build.load("bvh", bind), tab, ro, rd, best_t,
                      stack, sp, S=S, Q=Q, n_sl=n_sl)
    LAUNCHES["top_traverse"] += 1
    return out


def _pair_argtypes(n_head: int, split: bool) -> list:
    """A pair kernel entry point's arguments: `n_head` leading ints (the
    variant's index), then B6's (with its split scratch when `split`)."""

    return ([ctypes.c_int] * n_head + [ctypes.c_void_p] * 14
            + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_float] + [ctypes.c_void_p] * 5
            + ([ctypes.c_void_p] * 2 + [ctypes.c_int] if split else [])
            + [ctypes.c_void_p])


def bind(lib):
    """Declares the entry points' signatures on a loaded build of
    csrc/bvh.cu (B5, B6, B7), once: cuda_build.load calls it where it opens
    the library, the variant tools on their copies. Returns `lib`."""

    lib.lupin_top_traverse.restype = ctypes.c_int
    lib.lupin_top_traverse.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7)
    lib.lupin_pair_intersect.restype = ctypes.c_int
    lib.lupin_pair_intersect.argtypes = _pair_argtypes(0, split=True)
    lib.lupin_attr_fetch.restype = ctypes.c_int
    lib.lupin_attr_fetch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    return lib


def bind_variants(lib):
    """bind's counterpart for csrc/pair_variants.cu (B6')."""

    lib.lupin_pair_variant.restype = ctypes.c_int
    lib.lupin_pair_variant.argtypes = _pair_argtypes(1, split=False)
    return lib


def _top_launch(lib, tab, ro, rd, best_t, stack, sp, *, S, Q, n_sl):
    """B5's kernel from the loaded library `lib` (the checkout's build of
    csrc/bvh.cu, or a copy of it: tools/prof_top.py), bound by `bind`."""

    from . import cuda_build

    fn = lib.lupin_top_traverse
    dev = ro.x.device
    Bp = ro.x.shape[0]
    nb = hist_bins(n_sl)
    geo, refs = top_rows(tab)
    sl = torch.empty((Q, Bp), dtype=torch.int32, device=dev)
    cnt, sp_o, aabb = (torch.empty(Bp, dtype=torch.int32, device=dev) for _ in range(3))
    hist = torch.zeros(max(nb, 1), dtype=torch.int32, device=dev)
    ins = [x.contiguous() for x in (*ro, *rd, best_t, sp)]
    with torch.cuda.device(dev):
        rc = fn(geo.data_ptr(), refs.data_ptr(), *(x.data_ptr() for x in ins),
                S, Q, Bp, nb, stack.data_ptr(), sl.data_ptr(), cnt.data_ptr(),
                sp_o.data_ptr(), hist.data_ptr(), aabb.data_ptr(), _stream(dev))
    cuda_build.check(rc, "top_traverse")
    return sl, cnt, stack, sp_o, (hist if nb else None), aabb


def _inst_check(inst, n, tabs, what):
    """Validates the per-item instance word and its per-instance tables
    (all given or all None); returns whether they are given."""

    given = [x is not None for x in (inst, *tabs)]
    if any(given) != all(given):
        raise ValueError(f"inst and {what} come together")
    if not given[0]:
        return False
    _i32(inst)
    if inst.shape[0] != n:
        raise ValueError("inst must have one entry per work item")
    return True


def _pair_launch(fn, head, blk, sl, lo, hi, n_items, inst, txf_tab,
                 ro, rd, W4, eps, SP, pair_block, split=False):
    """Launches the pair kernel entry point `fn` of a bound library
    (`head`: its leading int arguments) and returns (t, u, v, det, li).
    `split` is B6's launch: the kernel reads pair_table(W4) instead of W4
    and gets its split scratch, PAIR_SPLIT_UNITS units of PAIR_TILE partial
    minima and their counters."""

    from . import cuda_build

    dev = ro.x.device
    P = ro.x.shape[0]
    t = torch.full((P,), F32_MAX, dtype=torch.float32, device=dev)
    u, v, det = (torch.zeros(P, dtype=torch.float32, device=dev) for _ in range(3))
    li = torch.zeros(P, dtype=torch.int32, device=dev)
    ins = [x.contiguous() for x in (blk, sl, lo, hi, n_items)]
    tabs = [None, None] if inst is None else [inst.contiguous(),
                                              txf_tab.contiguous()]
    rays = [x.contiguous() for x in (*ro, *rd, pair_table(W4) if split else W4)]
    scratch = []
    if split:
        cap = PAIR_SPLIT_UNITS
        part = torch.empty(5 * cap * PAIR_TILE, dtype=torch.float32, device=dev)
        cnt = torch.zeros(cap, dtype=torch.int32, device=dev)
        scratch = [part.data_ptr(), cnt.data_ptr(), cap]
    with torch.cuda.device(dev):
        rc = fn(*head, *(x.data_ptr() for x in ins),
                *(None if x is None else x.data_ptr() for x in tabs),
                *(x.data_ptr() for x in rays), W4.shape[2], blk.shape[0], SP,
                pair_block, P, float(eps), t.data_ptr(), u.data_ptr(),
                v.data_ptr(), det.data_ptr(), li.data_ptr(), *scratch,
                _stream(dev))
    cuda_build.check(rc, fn.__name__)
    return t, u, v, det, li


def _pair_check(blk, sl, lo, hi, n_items, ro, rd, W4, SP, inst, txf_tab):
    n_items = _items_check(blk, sl, lo, hi, n_items)
    _f32(W4, *ro, *rd)
    if W4.dim() != 3 or W4.shape[:2] != (4, 10) or W4.shape[2] % SP:
        raise ValueError(f"W4 must be (4, 10, n*{SP}), got {tuple(W4.shape)}")
    if not on_cpu(W4) and SP % 4:
        raise ValueError(f"B6's kernel copies 4 triangles at a time: SP={SP} "
                         "must be a multiple of 4")
    if _inst_check(inst, blk.shape[0], (txf_tab,), "txf_tab"):
        _f32(txf_tab)
        if txf_tab.dim() != 2 or txf_tab.shape[1] != 12:
            raise ValueError("txf_tab must be (n_inst, 12)")
    return n_items


def pair_intersect(blk, sl, lo, hi, ro, rd, W4, eps, *, SP, pair_block=256,
                   n_items=None, inst=None, txf_tab=None):
    """B6: work-item pair intersection over superleaf-sorted rays. ro/rd:
    V3 of sorted pair rays (P,); W4 (4, 10, n_msl*SP); sl holds each item's
    (mesh) superleaf; items ordered by the positions they cover (module
    note). Two-level scenes add inst (n,) i32, each item's instance, and
    txf_tab (n_inst, 12), the inverse transforms: the item's rays move to
    mesh space in the kernel. Returns per sorted position (t, u, v, det,
    LOCAL tri index in [0, SP)); uncovered positions hold a miss."""

    n_items = _pair_check(blk, sl, lo, hi, n_items, ro, rd, W4, SP, inst, txf_tab)
    if on_cpu(ro.x):
        return pair_intersect_plain(blk, sl, lo, hi, ro, rd, W4, eps, SP=SP,
                                    pair_block=pair_block, n_items=n_items,
                                    inst=inst, txf_tab=txf_tab)
    from . import cuda_build

    out = _pair_launch(cuda_build.load("bvh", bind).lupin_pair_intersect, (),
                       blk, sl, lo, hi, n_items, inst, txf_tab, ro, rd, W4, eps,
                       SP, pair_block, split=True)
    LAUNCHES["pair_intersect"] += 1
    return out


def pair_intersect_variant(variant, blk, sl, lo, hi, ro, rd, W4, eps, *, SP,
                           pair_block=256, n_items=None, inst=None,
                           txf_tab=None):
    """B6': B6's arguments through ablation variant `variant` of its kernel
    (PAIR_VARIANTS; csrc/pair_kernel.cuh says what each leaves out). V0 and
    V4 return what B6 returns; V2, V3 and V5 return (t, index) with
    u = v = det = 0 (V5: t = min(nt), index 0)."""

    if variant not in PAIR_VARIANTS:
        raise ValueError(f"unknown pair variant {variant!r}")
    n_items = _pair_check(blk, sl, lo, hi, n_items, ro, rd, W4, SP, inst, txf_tab)
    if on_cpu(ro.x):
        return pair_intersect_plain(blk, sl, lo, hi, ro, rd, W4, eps, SP=SP,
                                    pair_block=pair_block, n_items=n_items,
                                    inst=inst, txf_tab=txf_tab, variant=variant)
    from . import cuda_build

    lib = cuda_build.load("pair_variants", bind_variants)
    out = _pair_launch(lib.lupin_pair_variant, (PAIR_VARIANTS.index(variant),),
                       blk, sl, lo, hi, n_items, inst, txf_tab, ro, rd, W4, eps,
                       SP, pair_block)
    LAUNCHES["pair_intersect_variant"] += 1
    return out


def attr_fetch(blk, sl, lo, hi, li, hu, hv, A3, *, pair_block=256,
               with_tangents=False, n_items=None, inst=None, nrm_tab=None,
               ovr_tab=None):
    """B7: li (P,) local winner index per sorted ray, hu/hv (P,) its
    barycentrics, A3 (n_msl, SP, AW) attribute slices. Two-level scenes add
    inst (n,) i32, each item's instance, nrm_tab (n_inst, 9) normal matrices
    and ovr_tab (n_inst,) i32 material overrides. Returns (IA_ROWS[_NM], P)
    rows in sorted order, zeros on uncovered positions."""

    n_items = _items_check(blk, sl, lo, hi, n_items)
    _i32(li)
    _f32(hu, hv, A3)
    if A3.dim() != 3:
        raise ValueError(f"A3 must be (n_msl, SP, AW), got {tuple(A3.shape)}")
    has_inst = _inst_check(inst, blk.shape[0], (nrm_tab, ovr_tab),
                           "nrm_tab/ovr_tab")
    if has_inst:
        _f32(nrm_tab)
        _i32(ovr_tab)
        if nrm_tab.dim() != 2 or nrm_tab.shape[1] != 9 or (
                ovr_tab.shape != nrm_tab.shape[:1]):
            raise ValueError("nrm_tab must be (n_inst, 9), ovr_tab (n_inst,)")
    if on_cpu(li):
        return attr_fetch_plain(blk, sl, lo, hi, li, hu, hv, A3,
                                pair_block=pair_block,
                                with_tangents=with_tangents, n_items=n_items,
                                inst=inst, nrm_tab=nrm_tab, ovr_tab=ovr_tab)

    from . import cuda_build

    out = _attr_launch(cuda_build.load("bvh", bind), blk, sl, lo, hi, li, hu,
                       hv, A3, pair_block=pair_block, with_tangents=with_tangents,
                       n_items=n_items, inst=inst, nrm_tab=nrm_tab,
                       ovr_tab=ovr_tab)
    LAUNCHES["attr_fetch"] += 1
    return out


def _attr_launch(lib, blk, sl, lo, hi, li, hu, hv, A3, *, pair_block,
                 with_tangents, n_items, inst, nrm_tab, ovr_tab):
    """B7's kernel from the loaded library `lib` (the checkout's build of
    csrc/bvh.cu, or a build of an earlier design: tools/replay.py), bound
    by `bind`, on checked arguments; n_items a one-element device
    tensor."""

    from . import cuda_build

    A3 = A3.contiguous()
    if A3.data_ptr() % 16 or A3.shape[2] % 4 or A3.shape[2] <= dk.ATTR_MAT_ID:
        raise ValueError("B7 reads attribute rows as 16-byte loads up to "
                         "ATTR_MAT_ID: A3 must be 16-byte aligned with a row "
                         f"width divisible by 4, got {tuple(A3.shape)}")
    fn = lib.lupin_attr_fetch
    dev = li.device
    P = li.shape[0]
    awout = IA_ROWS_NM if with_tangents else IA_ROWS
    out = torch.zeros((awout, P), dtype=torch.float32, device=dev)
    ins = [x.contiguous() for x in (blk, sl, lo, hi, n_items, li, hu, hv)]
    tabs = ([x.contiguous() for x in (inst, nrm_tab, ovr_tab)] if inst is not None
            else [None] * 3)
    with torch.cuda.device(dev):
        rc = fn(*(x.data_ptr() for x in ins), A3.data_ptr(),
                *(None if x is None else x.data_ptr() for x in tabs),
                blk.shape[0], A3.shape[1], A3.shape[2], pair_block, P, awout,
                out.data_ptr(), _stream(dev))
    cuda_build.check(rc, "attr_fetch")
    return out
