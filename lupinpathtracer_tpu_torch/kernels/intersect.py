"""Ray-scene intersection: the dense intersector and the BVH wavefront.

The counterpart of lupinpathtracer_tpu/kernels/intersect.py. Cramer's-rule
ray/triangle intersection factors into dot products: each ray becomes the
10-feature row R = [d, o x d, o, 1] and each triangle four 10-vectors whose
dot products with R are the determinant and the t/u/v numerators of
ray_tri_dst (pathtracer.wgsl:2922-2943).

- Dense scenes (<= the dense gate): the closest hit over all triangles is
  kernel B1/B2 (kernels/dense_intersect.py).
- Single-level BVH scenes: coherent batches (camera rays) take kernel B4
  (kernels/packet.py), which also returns the winner's interpolated
  attributes. Divergent bounce batches on the card take the BVH walk
  (kernels/walk.py: one thread per ray down the binary BVH, one launch a
  batch); elsewhere (CPU tensors, the debug counts) they take the sort
  wavefront (`closest_hit_wavefront`): rounds of B5 top traversal, a
  superleaf-keyed sort, B6 pair intersection, an un-sort and a per-ray
  min. Either is followed by `wavefront_fetch_attrs` (a sort, B7, an
  un-sort). The sorts are torch.sort(stable=True) on the int32 key, as
  XLA's stable sort in the JAX package; an un-sort is a scatter by the
  original slot. The round loops' conditions are host syncs, counted in
  HOST_SYNCS; the rounds are counted in ROUNDS, B5's pairs in PAIRS, the
  batches by route in ROUTES. A BVH scene's `closest_hit` or
  `closest_hit_attrs` call is core/trace.py's `intersect` span, each round
  a `wavefront.round` span, B7's fetch inside it a `fetch` span.
- Two-level (instanced) scenes keep one mesh-space soup per unique mesh and
  a top tree over every (instance x mesh superleaf) pair. They take the same
  wavefront: B4 on coherent batches (one mode: each leaf's gsl_meta row,
  whatever the size of the instance tables; the JAX package's resident and
  stream modes are a limit of the TPU's scalar memory), and on bounce
  batches B6/B7 with a per-item instance word, whatever the number of
  instances (the JAX package's large-instance route, which moves the rays
  and rotates the rows outside the kernels, is a limit of the TPU's scalar
  memory and has no counterpart here). Triangle ids are global
  (superleaf * stride + lane), the
  backside flag needs no det-sign fixup, and attributes always come from
  `wavefront_fetch_attrs`. `closest_hit_brute_two_level` is their
  reference for the tests: every (ray, global superleaf) pair, no tree.

The JAX package's route switches, read from the environment at each call
as there: LUPIN_NO_PACKET (no B4 at all) and LUPIN_FORCE_PACKET (B4 on
bounce batches too). The wavefront's round sizes (WF_Q, WF_Q_TAIL,
WF_TAIL_C) and B4's superleaf envelope (PACKET_MAX_GSL) are constants. The
JAX package's LUPIN_PACKET_GEO_VMEM_MAX and LUPIN_PACKET_REFS_SMEM_MAX have
no counterpart: they are the TPU's VMEM and SMEM budgets for a staged top
tree, and B4 here reads the top tree from global memory (packet_eligible
lists the card's own limits).

`closest_hit_bvh`, the JAX package's masked-stack walk over the binary BVH,
walks the binary BVH rather than the superleaf tables the kernels walk, so
it serves as an independent reference: the CPU tests hold it to the JAX
walk, and the card tests hold the B4 and B5-B7 routes to it.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, fields

import torch

from ..core import trace
from ..core import vec3 as v3
from ..core.vec3 import V3
from . import bvh as bk
from . import dense_intersect as dk
from . import packet
from . import walk

F32_MAX = dk.F32_MAX

# Host syncs of the wavefront's round loops (each loop condition reads a
# device value, through core/trace.py's `sync`). A measurement counter: set
# to 0 before a run, read after.
HOST_SYNCS = {"wavefront": 0}

# Rounds of the wavefront's loops (full-batch and straggler rounds; each is
# core/trace.py's `wavefront.round` span while it records). Counted whether
# or not spans record, like HOST_SYNCS.
ROUNDS = {"wavefront": 0}

# BVH batches by route (`_route`): B4 ("packet"), the BVH walk ("walk"),
# the sort wavefront ("wavefront"). Counted whether or not spans record.
ROUTES = {"walk": 0, "wavefront": 0, "packet": 0}

# (ray, superleaf) pairs B5 emitted in the wavefront's rounds, summed on the
# rounds' device with no host sync: a one-element int64 tensor once a round
# has run (int(PAIRS["wavefront"]) reads it). Counted whether or not spans
# record; while they record, each round's count also goes to core/trace.py's
# count ring as `intersect.pairs`.
PAIRS = {"wavefront": 0}


@dataclass
class HitInfo:
    """Batched hit record (pathtracer.wgsl:2953-2961). ``tri`` indexes the
    world-triangle soup (superleaf order)."""

    hit: torch.Tensor  # (B,) bool
    dst: torch.Tensor  # (B,) f32
    u: torch.Tensor  # (B,) f32
    v: torch.Tensor  # (B,) f32
    tri: torch.Tensor  # (B,) i32
    backside: torch.Tensor  # (B,) bool

    def map(self, fn, *others: "HitInfo") -> "HitInfo":
        return HitInfo(*(
            fn(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in fields(self)
        ))


def miss(B: int, device) -> HitInfo:
    z = torch.zeros(B, dtype=torch.float32, device=device)
    return HitInfo(
        hit=torch.zeros(B, dtype=torch.bool, device=device),
        dst=torch.full((B,), F32_MAX, dtype=torch.float32, device=device),
        u=z,
        v=z,
        tri=torch.zeros(B, dtype=torch.int32, device=device),
        backside=torch.zeros(B, dtype=torch.bool, device=device),
    )


def build_tri_matrix(v0T, e1T, e2T):
    """Per-triangle coefficient matrix W (4, 10, T) from component-major
    (3, T) tables (intersect.py:173-201):

      det = R . [n, 0, 0, 0]                    n = e1 x e2
      nu  = R . [e2 x v0, -e2, 0, 0]
      nv  = R . [-(e1 x v0), e1, 0, 0]
      nt  = R . [0, 0, -n, n.v0]
    """

    v0 = v3.from_t3(v0T)
    e1 = v3.from_t3(e1T)
    e2 = v3.from_t3(e2T)
    n = v3.cross(e1, e2)
    c_e2v0 = v3.cross(e2, v0)
    c_e1v0 = v3.cross(e1, v0)
    ndotv0 = v3.dot(n, v0)
    z = torch.zeros_like(v0.x)
    rows = [
        [n.x, n.y, n.z, z, z, z, z, z, z, z],
        [c_e2v0.x, c_e2v0.y, c_e2v0.z, -e2.x, -e2.y, -e2.z, z, z, z, z],
        [-c_e1v0.x, -c_e1v0.y, -c_e1v0.z, e1.x, e1.y, e1.z, z, z, z, z],
        [z, z, z, z, z, z, -n.x, -n.y, -n.z, ndotv0],
    ]
    return torch.stack([torch.stack(r, dim=0) for r in rows], dim=0)


def scene_tri_matrix(scene):
    """Dense coefficient matrix over the world triangle soup: the real
    triangles of a dense scene; for superleaf scenes the full fixed-stride
    repacked soup (padding rows are degenerate: det = 0, never valid).
    Built once per scene and cached on it: every caller gets the same
    tensor, which must not be modified."""

    cached = scene.__dict__.get("_tri_matrix")
    if cached is not None:
        return cached
    if scene.use_bvh and scene.sl_count > 0:
        n = scene.msl_count * scene.sl_stride
    else:
        n = scene.num_world_tris
    W = build_tri_matrix(
        scene.wt_v0[:, :n], scene.wt_e1[:, :n], scene.wt_e2[:, :n]
    )
    scene.__dict__["_tri_matrix"] = W
    return W


def ray_features(ro: V3, rd: V3):
    """R = [d, o x d, o, 1] with shape (B, 10)."""

    c = v3.cross(ro, rd)
    return torch.stack(
        [rd.x, rd.y, rd.z, c.x, c.y, c.z, ro.x, ro.y, ro.z,
         torch.ones_like(ro.x)], dim=-1,
    )


def dense_tuv(R, W4, eps):
    """All-pairs t/u/v/det (B, T); invalid pairs at t = F32_MAX."""

    det, nu, nv, nt = dk.dense_numerators(R, W4)
    return (*dk.dense_epilogue(det, nu, nv, nt, eps), det)


def _ray_tri(ro: V3, rd: V3, tv0: V3, te1: V3, te2: V3, eps):
    """Per-lane ray_tri_dst (pathtracer.wgsl:2922-2943)."""

    n = v3.cross(te1, te2)
    rov0 = ro - tv0
    q = v3.cross(rov0, rd)
    det = v3.dot(rd, n)
    d = 1.0 / det
    u = d * -v3.dot(q, te2)
    v = d * v3.dot(q, te1)
    t = d * -v3.dot(n, rov0)
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= eps)
    return torch.where(valid, t, F32_MAX), u, v, det


def _apply_active(h: HitInfo, active) -> HitInfo:
    """Inactive lanes report a clean miss (intersect.py:1131-1137), with
    backside False even where the det-sign fixup flipped the tri-0
    placeholder."""

    if active is None:
        return h
    m = miss(h.dst.shape[0], h.dst.device)
    return h.map(lambda a, b: torch.where(active, a, b), m)


def _fixup_backside(scene, h: HitInfo) -> HitInfo:
    """World-soup scenes: flip backside by the hit instance's det sign
    (intersect.py:1113-1116)."""

    flip = scene.inst_det_sign[scene.wt_inst[h.tri.long()].long()] < 0.0
    h.backside = torch.where(flip, ~h.backside, h.backside)
    return h


# ---------------------------------------------------------------------------
# Masked-stack walk over the binary BVH (the tests' independent reference)
# ---------------------------------------------------------------------------


def _ray_aabb_dst(ro: V3, inv_d: V3, lo: V3, hi: V3):
    """Slab test (pathtracer.wgsl:2906-2918); F32_MAX on a miss."""

    mn, mx = torch.minimum, torch.maximum
    tx1 = (lo.x - ro.x) * inv_d.x
    tx2 = (hi.x - ro.x) * inv_d.x
    ty1 = (lo.y - ro.y) * inv_d.y
    ty2 = (hi.y - ro.y) * inv_d.y
    tz1 = (lo.z - ro.z) * inv_d.z
    tz2 = (hi.z - ro.z) * inv_d.z
    dst_far = mn(mn(mx(tx1, tx2), mx(ty1, ty2)), mx(tz1, tz2))
    dst_near = mx(mx(mn(tx1, tx2), mn(ty1, ty2)), mn(tz1, tz2))
    did_hit = (dst_far >= dst_near) & (dst_far > 0.0)
    return torch.where(did_hit, dst_near, F32_MAX)


def closest_hit_bvh(scene, ro: V3, rd: V3, eps, with_counts: bool = False):
    """The JAX package's masked wavefront walk of the binary world BVH
    (intersect.py:323-441; bvh_custom.wgsl:246-284): every live lane
    advances one node per step, leaves test a fixed block of bvh_leaf_size
    triangles, internal nodes push near child last with best-t pruning.
    Backside is det > 0 without the det-sign fixup, as in the JAX walk.
    `with_counts` also returns each ray's (n_tri, n_aabb): the triangles
    its leaves tested and two slab tests per internal node
    (RAY_DEBUG_INFO, pathtracer.wgsl:2945-2951)."""

    B = ro.x.shape[0]
    dev = ro.x.device
    S = scene.bvh_depth + 2
    K = scene.bvh_leaf_size
    inv_d = V3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    n_soup = scene.wt_v0.shape[1]
    n_nodes = scene.bvh_count.shape[0]
    stack = torch.zeros((S, B), dtype=torch.int32, device=dev)
    sp = torch.ones(B, dtype=torch.int32, device=dev)
    best_t = torch.full((B,), F32_MAX, dtype=torch.float32, device=dev)
    best_u, best_v, best_det = (torch.zeros(B, dtype=torch.float32, device=dev)
                                for _ in range(3))
    best_tri = torch.zeros(B, dtype=torch.int32, device=dev)
    n_tri = torch.zeros(B, dtype=torch.int32, device=dev)
    n_aabb = torch.zeros(B, dtype=torch.int32, device=dev)
    while bool((sp > 0).any()):
        active = sp > 0
        sp = torch.where(active, sp - 1, 0)
        node = stack.gather(0, sp.clamp(max=S - 1).long()[None, :])[0].long()
        count = scene.bvh_count[node]
        first = scene.bvh_first[node]
        is_leaf = active & (count > 0)
        is_int = active & (count == 0)
        for k in range(K):
            ti = torch.where(is_leaf, first + k, 0).clamp(max=n_soup - 1).long()
            t, u, v, det = _ray_tri(ro, rd, v3.gather(scene.wt_v0, ti),
                                    v3.gather(scene.wt_e1, ti),
                                    v3.gather(scene.wt_e2, ti), eps)
            upd = is_leaf & (k < count) & (t < best_t)
            best_u = torch.where(upd, u, best_u)
            best_v = torch.where(upd, v, best_v)
            best_det = torch.where(upd, det, best_det)
            best_tri = torch.where(upd, ti.to(torch.int32), best_tri)
            best_t = torch.where(upd, t, best_t)
        lc = torch.where(is_int, first, 0).clamp(max=n_nodes - 2).long()
        rc = lc + 1
        tl = _ray_aabb_dst(ro, inv_d, v3.gather(scene.bvh_min, lc),
                           v3.gather(scene.bvh_max, lc))
        tr = _ray_aabb_dst(ro, inv_d, v3.gather(scene.bvh_min, rc),
                           v3.gather(scene.bvh_max, rc))
        push_l = is_int & (tl < best_t)
        push_r = is_int & (tr < best_t)
        left_near = tl <= tr
        far = torch.where(left_near, rc, lc).to(torch.int32)
        near = torch.where(left_near, lc, rc).to(torch.int32)
        push_far = torch.where(left_near, push_r, push_l)
        push_near = torch.where(left_near, push_l, push_r)
        stack = bk._put_row(stack, sp, far, push_far)
        sp = sp + push_far.to(torch.int32)
        stack = bk._put_row(stack, sp, near, push_near)
        sp = sp + push_near.to(torch.int32)
        n_tri = n_tri + torch.where(is_leaf, count.clamp(max=K), 0).to(torch.int32)
        n_aabb = n_aabb + torch.where(is_int, 2, 0).to(torch.int32)
    h = HitInfo(hit=best_t < F32_MAX, dst=best_t, u=best_u, v=best_v,
                tri=best_tri, backside=best_det > 0.0)
    return (h, (n_tri, n_aabb)) if with_counts else h


def count_traversal(scene, ro: V3, rd: V3, eps):
    """Per-ray (tri, AABB) test counts of one closest-hit query, the debug
    heatmaps' data (intersect.py:519-542). BVH scenes with superleaves
    (every scene the port builds) count the wavefront's tests, B5's slab
    tests and B6's triangles, as the JAX package does on its device; the
    stack walk's counts (closest_hit_bvh) serve a BVH scene without
    superleaves. Dense scenes test every triangle; a scene without
    instances tests nothing."""

    B, dev = ro.x.shape[0], ro.x.device
    if scene.instances_empty:
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        return z, z
    if scene.use_bvh:
        if scene.two_level or scene.sl_count > 0:
            _, counts = closest_hit_wavefront(scene, ro, rd, eps,
                                              with_counts=True)
        else:
            _, counts = closest_hit_bvh(scene, ro, rd, eps, with_counts=True)
        return counts
    return (torch.full((B,), scene.num_world_tris, dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev))


def closest_hit_brute_two_level(scene, ro: V3, rd: V3, eps, W,
                                chunk: int = 16) -> HitInfo:
    """Brute-force closest hit of a two-level scene (intersect.py:443-516):
    every (ray, global superleaf) pair through dense products over chunks
    of superleaves, no tree and no kernel; O(B * n_gsl * SP), a reference
    for small batches. The instance transform as bvh_custom.wgsl:30-35
    (direction not normalised, so t stays world-scaled). The lowest global
    triangle id wins a tie. Only hit, dst and tri are filled."""

    B = ro.x.shape[0]
    dev = ro.x.device
    SP = scene.sl_stride
    n_gsl = scene.sl_count
    Wr = W.reshape(4, 10, scene.msl_count, SP)
    msl = scene.gsl_msl.long()
    inv = scene.inst_inv.reshape(-1, 12)[scene.gsl_inst.long()]
    best_t = torch.full((B,), F32_MAX, dtype=torch.float32, device=dev)
    best_tri = torch.zeros(B, dtype=torch.int64, device=dev)
    for g0 in range(0, n_gsl, chunk):
        m = [inv[g0:g0 + chunk, j:j + 1] for j in range(12)]  # (C, 1) each
        ox = m[0] * ro.x + m[1] * ro.y + m[2] * ro.z + m[3]
        oy = m[4] * ro.x + m[5] * ro.y + m[6] * ro.z + m[7]
        oz = m[8] * ro.x + m[9] * ro.y + m[10] * ro.z + m[11]
        dx = m[0] * rd.x + m[1] * rd.y + m[2] * rd.z
        dy = m[4] * rd.x + m[5] * rd.y + m[6] * rd.z
        dz = m[8] * rd.x + m[9] * rd.y + m[10] * rd.z
        RT = torch.stack([dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                          ox * dy - oy * dx, ox, oy, oz, torch.ones_like(ox)],
                         dim=1)  # (C, 10, B)
        Wc = Wr[:, :, msl[g0:g0 + chunk]]  # (4, 10, C, SP)
        det, nu, nv, nt = torch.einsum("frcs,crb->fcbs", Wc, RT)
        tt, _, _ = dk.dense_epilogue(det, nu, nv, nt, eps)  # (C, B, SP)
        C = tt.shape[0]
        flat = tt.permute(1, 0, 2).reshape(B, C * SP)
        k = flat.argmin(dim=1)  # first minimum: lowest (superleaf, lane)
        t = flat.gather(1, k[:, None])[:, 0]
        upd = t < best_t  # earlier chunks keep ties
        best_tri = torch.where(upd, g0 * SP + k, best_tri)
        best_t = torch.where(upd, t, best_t)
    hit = best_t < F32_MAX
    z = torch.zeros_like(best_t)
    return HitInfo(hit=hit, dst=best_t, u=z, v=z,
                   tri=torch.where(hit, best_tri, 0).to(torch.int32),
                   backside=torch.zeros_like(hit))


# ---------------------------------------------------------------------------
# BVH wavefront (kernels B4-B7)
# ---------------------------------------------------------------------------

WF_Q = 8  # superleaf emits per ray per full-batch round
WF_Q_TAIL = 32  # compacted straggler rounds
WF_RAY_BLOCK = 2048  # lane padding of a batch
WF_PAIR_BLOCK = 256  # sorted positions per work-item block
WF_TAIL_C = 2048  # straggler-compaction capacity

# B4's envelope on global superleaves (intersect.py:79-99): the JAX
# package's default.
PACKET_MAX_GSL = 131072
_GATE_LOGGED: set = set()


def packet_eligible(scene) -> bool:
    """Whether kernel B4 can take this scene. The limits of csrc/packet.cu,
    each a width of the kernel's own words:
    - triangle ids: a winner's id, ref * SP + s * spb, is an int32, so the
      global superleaves are at most (2**31 - 1) // SP; and at most
      PACKET_MAX_GSL (the JAX package's envelope, intersect.py:96-99);
    - the stack: a warp's shared stack holds PK_STACK entries
      (packet.PACKET_STACK_MAX), and a ray needs packet.stack_size;
    - node references: a stack entry and a refs word hold
      (child_ref << 1) | is_leaf in an int32, so the top rows and the
      superleaves must stay below 2**30, which the id guard implies (a
      stride is a multiple of 128);
    - sub-chunks: a leaf's sub-chunk hits are the bits of one 32-bit word
      and lupin_packet_traverse rejects a stride that is not a multiple of
      4 * nsub, which the superleaf builder rules out (nsub <= 8, the
      stride a multiple of 128 * nsub).
    The kernel reads the top rows, the sub-chunk boxes and the coefficients
    from global memory and runs a persistent grid of at most one wave of
    blocks, so neither the tables' size nor the batch's meets another
    limit. A scene it cannot take goes to the sort wavefront, logged once
    per reason."""

    if scene.top_root_is_leaf:
        return False
    max_gsl = min(PACKET_MAX_GSL, (2**31 - 1) // max(int(scene.sl_stride), 1))
    reason = None
    if scene.sl_count > max_gsl:
        reason = (f"{scene.sl_count} superleaves > {max_gsl} "
                  "(PACKET_MAX_GSL, int32 triangle ids)")
    elif packet.stack_size(scene) > packet.PACKET_STACK_MAX:
        reason = f"top tree of depth {scene.top_depth}"
    if reason is None:
        return True
    if reason not in _GATE_LOGGED:
        _GATE_LOGGED.add(reason)
        print(f"# packet kernel ineligible: {reason}; using the sort "
              "wavefront", file=sys.stderr)
    return False


def _use_packet(scene, coherent: bool = True) -> bool:
    """Whether B4 takes this batch (intersect.py:141-166, without the
    packet probe): never under LUPIN_NO_PACKET; coherent batches (camera
    rays) when the scene is eligible; divergent bounce batches
    (coherent=False) only under LUPIN_FORCE_PACKET, a measurement switch
    (the JAX package measured B4 ~7x slower than the sort wavefront there
    on the TPU)."""

    if packet.env_on("LUPIN_NO_PACKET"):
        return False
    if not coherent and not packet.env_on("LUPIN_FORCE_PACKET"):
        return False
    return packet_eligible(scene)


def _route(scene, x, coherent: bool, with_counts: bool = False) -> str:
    """The route of a BVH batch whose rays lie where tensor `x` lies, from
    the input alone: "packet" where B4 takes it (_use_packet; never with
    the debug counts), "walk" for a bounce batch (coherent=False) of a
    single-level scene on the card, "wavefront" otherwise (two-level
    scenes, the debug counts, CPU tensors)."""

    if not with_counts and _use_packet(scene, coherent):
        return "packet"
    if not (coherent or with_counts or scene.two_level) and x.is_cuda:
        return "walk"
    return "wavefront"


def _wavefront_tri_matrix(scene, W=None):
    """Coefficient matrix at the repacked-soup width the superleaf kernels
    slice by superleaf id."""

    need = scene.msl_count * scene.sl_stride
    if W is None or W.shape[2] != need:
        W = build_tri_matrix(scene.wt_v0[:, :need], scene.wt_e1[:, :need],
                             scene.wt_e2[:, :need])
    return W


def _pad(x, n, fill):
    if n == 0:
        return x
    return torch.cat([x, torch.full((n,), fill, dtype=x.dtype, device=x.device)])


def closest_hit_wavefront(scene, ro: V3, rd: V3, eps, W=None, active=None,
                          coherent: bool = True, with_counts: bool = False):
    """Closest hit of a BVH scene, single- or two-level
    (intersect.py:581-747), by `_route`: kernel B4 for coherent batches;
    the BVH walk (kernels/walk.py) for a single-level scene's bounce batch
    on the card; otherwise rounds of B5 top traversal -> superleaf sort ->
    B6 pair intersection -> un-sort -> per-ray min until every stack
    drains, full-batch rounds while more than C = WF_TAIL_C lanes are
    pending (WF_Q superleaf emits a ray a round), then rounds over the
    compacted stragglers (WF_Q_TAIL emits). Inactive lanes skip traversal
    (a miss). No det-sign backside fixup here.

    `with_counts` (the debug heatmaps) skips B4 and also returns each ray's
    (n_tri, n_aabb): the triangles the pair kernel tested (its superleaf
    visits times the stride) and B5's top-tree slab tests."""

    B = ro.x.shape[0]
    dev = ro.x.device
    SP = scene.sl_stride
    W = _wavefront_tri_matrix(scene, W)
    route = _route(scene, ro.x, coherent, with_counts)
    ROUTES[route] += 1
    if route == "packet":
        t, u, v, det, tri = packet.packet_traverse(scene, ro, rd, eps, W,
                                                   active=active)
        return HitInfo(hit=t < F32_MAX, dst=t, u=u, v=v,
                       tri=tri.clamp_min(0), backside=det > 0.0)
    if route == "walk":
        t, u, v, det, tri = walk.walk(scene, ro, rd, eps, W, active=active)
        return HitInfo(hit=t < F32_MAX, dst=t, u=u, v=v, tri=tri,
                       backside=det > 0.0)

    pad = (-B) % WF_RAY_BLOCK
    Bp = B + pad
    rop = V3(*(_pad(c, pad, 0.0) for c in ro))
    rdp = V3(_pad(rd.x, pad, 0.0), _pad(rd.y, pad, 1.0), _pad(rd.z, pad, 0.0))
    PB = WF_PAIR_BLOCK

    if scene.top_root_is_leaf:
        # One superleaf: every ray tests superleaf 0; one item per block. A
        # two-level scene's soup is in mesh space, so the instance transform
        # rides along here too.
        blk = torch.arange(Bp // PB, dtype=torch.int32, device=dev)
        msl_k, inst_k, txf_tab, _, _ = _item_instancing(
            scene, torch.zeros_like(blk))
        t, u, v, det, li = bk.pair_intersect(
            blk, msl_k, blk * PB, blk * PB + PB, rop, rdp, W, eps, SP=SP,
            pair_block=PB, inst=inst_k, txf_tab=txf_tab)
        h = HitInfo(hit=t[:B] < F32_MAX, dst=t[:B], u=u[:B], v=v[:B],
                    tri=li[:B], backside=det[:B] > 0.0)
        if with_counts:
            return h, (torch.full((B,), SP, dtype=torch.int32, device=dev),
                       torch.zeros(B, dtype=torch.int32, device=dev))
        return h

    S = bk.stack_depth(scene)
    real = torch.arange(Bp, device=dev) < B
    if active is not None:
        real = real & _pad(active, pad, False)
    tab = scene.top_tab
    c = dict(
        stack=torch.zeros((S, Bp), dtype=torch.int32, device=dev),
        sp=real.to(torch.int32),
        best_t=torch.full((Bp,), F32_MAX, dtype=torch.float32, device=dev),
        best_u=torch.zeros(Bp, dtype=torch.float32, device=dev),
        best_v=torch.zeros(Bp, dtype=torch.float32, device=dev),
        best_det=torch.zeros(Bp, dtype=torch.float32, device=dev),
        best_tri=torch.zeros(Bp, dtype=torch.int32, device=dev),
    )
    if with_counts:
        c["n_tri"] = torch.zeros(Bp, dtype=torch.int32, device=dev)
        c["n_aabb"] = torch.zeros(Bp, dtype=torch.int32, device=dev)

    def round_(cc, o, d, Q):
        return _wf_round(scene, W, tab, eps, o, d, cc, S=S, PB=PB, Q=Q)

    C = min(Bp, WF_TAIL_C)
    if Bp > C:
        while trace.sync(HOST_SYNCS, "wavefront", (c["sp"] > 0).sum() > C):
            ROUNDS["wavefront"] += 1
            with trace.span("wavefront.round"):
                c = round_(c, rop, rdp, WF_Q)

    arange_b = torch.arange(Bp, device=dev)
    arange_c = torch.arange(C, device=dev)
    keys_1d = [k for k in c if k != "stack"]
    while trace.sync(HOST_SYNCS, "wavefront", (c["sp"] > 0).any()):
        ROUNDS["wavefront"] += 1
        with trace.span("wavefront.round"):
            pending = c["sp"] > 0
            n_pend = torch.cumsum(pending.to(torch.int64), 0)
            slot = torch.where(pending, n_pend - 1, C)
            idx = torch.zeros(C + 1, dtype=torch.int64, device=dev)
            idx = idx.scatter(0, slot, arange_b)[:C]  # slot C is dropped
            valid = arange_c < n_pend[-1]
            cc = {k: c[k][idx] for k in keys_1d}
            cc["sp"] = torch.where(valid, cc["sp"], 0)
            cc["stack"] = c["stack"][:, idx]
            cc = round_(cc, V3(*(x[idx] for x in rop)),
                        V3(*(x[idx] for x in rdp)), WF_Q_TAIL)
            # invalid slots land on Bp, dropped
            back = torch.where(valid, idx, Bp)
            out = {}
            for k in keys_1d:
                ext = torch.cat([c[k], c[k][:1]])
                ext[back] = cc[k]
                out[k] = ext[:Bp]
            ext = torch.cat([c["stack"], c["stack"][:, :1]], dim=1)
            ext[:, back] = cc["stack"]
            out["stack"] = ext[:, :Bp]
            c = out

    t = c["best_t"][:B]
    h = HitInfo(hit=t < F32_MAX, dst=t, u=c["best_u"][:B],
                v=c["best_v"][:B], tri=c["best_tri"][:B].clamp_min(0),
                backside=c["best_det"][:B] > 0.0)
    if with_counts:
        return h, (c["n_tri"][:B], c["n_aabb"][:B])
    return h


def _wf_work_items(skey, n_sl, PB, cnt_sl=None):
    """Work items from superleaf-sorted keys (empties keyed n_sl), as
    intersect.py:750-815: superleaf s covers sorted positions
    [seg_start[s], seg_start[s+1]), one item per (segment, PB-block) it
    touches; items are block-monotone, sized to the static cap
    n_blocks + n_sl, and the tail repeats the last valid block/superleaf
    with lo == hi. Returns (blk, sl, lo, hi, n_real, n_items), all int32
    device tensors (n_real and n_items of one element)."""

    P = skey.shape[0]
    dev = skey.device
    n_pb = P // PB
    if cnt_sl is not None:
        seg_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                               torch.cumsum(cnt_sl[:n_sl].to(torch.int64), 0)])
    else:
        qs = torch.arange(n_sl + 1, dtype=skey.dtype, device=dev)
        seg_start = torch.searchsorted(skey, qs, right=False)
    cnt = seg_start[1:] - seg_start[:-1]
    n_real = seg_start[n_sl:n_sl + 1]
    first_blk = seg_start[:n_sl] // PB
    last_blk = torch.maximum(seg_start[1:] - 1, seg_start[:n_sl]) // PB
    n_items_s = torch.where(cnt > 0, last_blk - first_blk + 1, 0)
    ioff = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(n_items_s, 0)])
    total = ioff[n_sl:n_sl + 1]
    W_CAP = n_pb + min(n_sl, P)
    karr = torch.arange(W_CAP, dtype=torch.int64, device=dev)
    s_k = torch.searchsorted(ioff[1:].contiguous(), karr, right=True)
    s_k = s_k.clamp(max=n_sl - 1)
    valid = karr < total
    blk_k = first_blk[s_k] + (karr - ioff[s_k])
    blk_k = torch.cummax(torch.where(valid, blk_k, -1), 0).values.clamp_min(0)
    sl_k = torch.cummax(torch.where(valid, s_k, -1), 0).values.clamp_min(0)
    lo_k = torch.where(valid, seg_start[s_k], 0)
    hi_k = torch.where(valid, seg_start[s_k + 1], 0)
    n_items = total.clamp_min(1)
    i32 = torch.int32
    return (blk_k.to(i32), sl_k.to(i32), lo_k.to(i32), hi_k.to(i32),
            n_real.to(i32), n_items.to(i32))


def _wf_pairs(scene, tab, rop: V3, rdp: V3, c: dict, *, S, PB, Q):
    """The first half of a wavefront round: B5 top traversal, then the
    (Q, Bp) emits grouped by superleaf (stable sort) and cut into work
    items. Returns B6's arguments ahead of (W, eps) and its keywords, the
    sorted keys, the sort order, n_real and B5's (stack, sp, cnt, aabb).
    Two-level scenes pass B6 each item's mesh superleaf and instance."""

    Bp = rop.x.shape[0]
    n_sl = scene.sl_count
    sl, cnt, stack, sp, cnt_sl, aabb = bk.top_traverse(
        tab, rop, rdp, c["best_t"], c["stack"], c["sp"], S=S, Q=Q, n_sl=n_sl)
    pair_sl = sl.reshape(-1)  # slot q*Bp + r holds ray r
    key = torch.where(pair_sl >= 0, pair_sl, n_sl)
    skey, order = torch.sort(key, stable=True)
    ray = order % Bp
    s_ro = V3(*(x[ray] for x in rop))
    s_rd = V3(*(x[ray] for x in rdp))
    blk, sl_k, lo, hi, n_real, n_items = _wf_work_items(skey, n_sl, PB, cnt_sl)
    msl_k, inst_k, txf_tab, _, _ = _item_instancing(scene, sl_k)
    args = (blk, msl_k, lo, hi, s_ro, s_rd)
    kw = dict(SP=scene.sl_stride, pair_block=PB, n_items=n_items, inst=inst_k,
              txf_tab=txf_tab)
    return args, kw, skey, order, n_real, stack, sp, cnt, aabb


def _count_pairs(n_real):
    """Adds a round's pairs (n_real, a one-element device tensor) to PAIRS
    on their device; where the sum lies on another device it moves once."""

    p = PAIRS["wavefront"]
    if not (torch.is_tensor(p) and p.device == n_real.device):
        p = torch.tensor([int(p)], dtype=torch.int64, device=n_real.device)
    PAIRS["wavefront"] = p + n_real
    trace.count("intersect.pairs", n_real)


def _wf_round(scene, W, tab, eps, rop: V3, rdp: V3, c: dict, *, S, PB, Q):
    """One wavefront round over Bp lanes (intersect.py:994-1103): B5 top
    traversal -> group the (Q, Bp) emits by superleaf (stable sort) -> B6 ->
    un-sort -> per-ray min with a strict < (the incumbent keeps ties).
    With the count keys in `c`, adds the round's tests to them
    (intersect.py:1098-1102): every emitted superleaf visit tests the full
    stride of triangles."""

    Bp = rop.x.shape[0]
    SP = scene.sl_stride
    n_sl = scene.sl_count
    QB = Q * Bp
    args, kw, skey, order, n_real, stack, sp, cnt, aabb = _wf_pairs(
        scene, tab, rop, rdp, c, S=S, PB=PB, Q=Q)
    _count_pairs(n_real)
    t, u, v, det, ltri = bk.pair_intersect(*args, W, eps, **kw)
    t = torch.where(torch.arange(QB, device=t.device) < n_real, t, F32_MAX)
    gtri = ltri + skey.clamp(max=n_sl - 1) * SP

    def unsort(x):
        y = torch.empty_like(x)
        y[order] = x
        return y.reshape(Q, Bp)

    # argmin returns the first minimum, so the lowest q wins among equal new
    # hits and the strict < keeps the incumbent on a tie, as a loop over q
    # with a strict < would.
    t_q = unsort(t)
    j = t_q.argmin(0, keepdim=True)
    t_m, u_m, v_m, det_m, tri_m = (x_q.gather(0, j)[0] for x_q in (
        t_q, *(unsort(x) for x in (u, v, det, gtri))))
    wn = t_m < c["best_t"]
    out = dict(stack=stack, sp=sp)
    for k, x in (("best_t", t_m), ("best_u", u_m), ("best_v", v_m),
                 ("best_det", det_m), ("best_tri", tri_m)):
        out[k] = torch.where(wn, x, c[k])
    if "n_tri" in c:
        out["n_tri"] = c["n_tri"] + cnt * SP
        out["n_aabb"] = c["n_aabb"] + aabb
    return out


@dataclass
class InterpAttrs:
    """Per-ray shading attributes interpolated at the hit by kernel B4 or
    B7 (kernels/bvh.py IA_* layout; intersect.py:818-837): the BVH route's
    counterpart of the dense kernel's (ATTR_WIDTH, B) rows. Material fields
    come from mat_id (render/materials.py)."""

    n: V3  # unnormalized interpolated shading normal
    gn: V3  # geometric normal
    tu: torch.Tensor
    tv: torch.Tensor
    has_uv: torch.Tensor  # bool
    vc: V3  # interpolated vertex color
    vca: torch.Tensor
    det_sign: torch.Tensor
    mat_id: torch.Tensor  # i32
    tan: V3 | None = None  # only with normal maps
    bit: V3 | None = None

    def map(self, fn, *others: "InterpAttrs") -> "InterpAttrs":
        """Applies fn leaf by leaf (V3 components included)."""

        def one(a, *bs):
            if a is None:
                return None
            if isinstance(a, V3):
                return V3(*(fn(getattr(a, k), *(getattr(b, k) for b in bs))
                            for k in "xyz"))
            return fn(a, *bs)

        return InterpAttrs(*(
            one(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in fields(self)
        ))


def _item_instancing(scene, sl_k):
    """(msl_k, inst_k, txf_tab, nrm_tab, ovr_tab): per work item its mesh
    superleaf and instance, and the per-instance inverse transforms
    (n, 12), normal matrices (n, 9) and material overrides (n,)
    (intersect.py:840-854). Single-level scenes are their own mesh space:
    the items' superleaves and Nones."""

    if not scene.two_level:
        return sl_k, None, None, None, None
    g = sl_k.long()
    return (scene.gsl_msl[g].to(torch.int32), scene.gsl_inst[g].to(torch.int32),
            scene.inst_inv.reshape(-1, 12), scene.inst_normal_mat.reshape(-1, 9),
            scene.inst_mat.to(torch.int32))


def _ia_from_rows(r, with_tan: bool) -> InterpAttrs:
    def v(sl):
        return V3(r[sl.start], r[sl.start + 1], r[sl.start + 2])

    return InterpAttrs(
        n=v(bk.IA_N), gn=v(bk.IA_GN), tu=r[bk.IA_TU], tv=r[bk.IA_TV],
        has_uv=r[bk.IA_HAS_UV] > 0.0, vc=v(bk.IA_VC), vca=r[bk.IA_VCA],
        det_sign=r[bk.IA_DET_SIGN], mat_id=r[bk.IA_MAT_ID].to(torch.int32),
        tan=v(bk.IA_TAN) if with_tan else None,
        bit=v(bk.IA_BIT) if with_tan else None,
    )


def _attr_fetch_args(scene, hit: HitInfo):
    """The sort ahead of B7 (intersect.py:857-920): hit lanes sorted by
    winning superleaf (misses keyed n_sl, last) and their work items.
    Returns (args, kwargs) of bvh.attr_fetch, the sort order and the padded
    hit mask."""

    B = hit.tri.shape[0]
    SP = scene.sl_stride
    n_sl = scene.sl_count
    PB = WF_PAIR_BLOCK
    pad = (-B) % PB
    hitm = _pad(hit.hit, pad, False)
    tri = torch.where(hitm, _pad(hit.tri, pad, 0), 0)
    key = torch.where(hitm, tri // SP, n_sl).to(torch.int32)
    li = torch.where(hitm, tri % SP, 0).to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    blk, sl_k, lo, hi, _, n_items = _wf_work_items(skey, n_sl, PB)
    msl_k, inst_k, _, nrm_tab, ovr_tab = _item_instancing(scene, sl_k)
    A3 = scene.wt_attr[: scene.msl_count * SP].reshape(
        scene.msl_count, SP, dk.ATTR_WIDTH)
    args = (blk, msl_k, lo, hi, li[order], _pad(hit.u, pad, 0.0)[order],
            _pad(hit.v, pad, 0.0)[order], A3)
    kw = dict(pair_block=PB, with_tangents=bool(scene.any_normal_maps),
              n_items=n_items, inst=inst_k, nrm_tab=nrm_tab, ovr_tab=ovr_tab)
    return args, kw, order, hitm


def wavefront_fetch_attrs(scene, hit: HitInfo) -> InterpAttrs:
    """InterpAttrs of BVH hits (intersect.py:857-950): rays sorted by
    winning superleaf (misses last), kernel B7 per work item, rows scattered
    back to ray order; miss lanes are zero."""

    args, kw, order, hitm = _attr_fetch_args(scene, hit)
    a = bk.attr_fetch(*args, **kw)
    base = torch.empty_like(a)
    base[:, order] = a
    r = torch.where(hitm[None, :], base, 0.0)[:, :hit.tri.shape[0]]
    return _ia_from_rows(r, kw["with_tangents"])


def _packet_hit_attrs(scene, ro: V3, rd: V3, eps, W=None, active=None):
    """One B4 launch returning (HitInfo, InterpAttrs): traversal and winner
    attribute interpolation fused (intersect.py:1182-1226)."""

    W = _wavefront_tri_matrix(scene, W)
    t, u, v, det, tri, r = packet.packet_traverse(
        scene, ro, rd, eps, W, active=active, with_attrs=True)
    h = _fixup_backside(scene, HitInfo(
        hit=t < F32_MAX, dst=t, u=u, v=v, tri=tri.clamp_min(0),
        backside=det > 0.0))
    return _apply_active(h, active), _ia_from_rows(r, bool(scene.any_normal_maps))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _closest_hit_bvh(scene, ro: V3, rd: V3, eps, W, active,
                     coherent: bool) -> HitInfo:
    """closest_hit of a BVH scene (its `intersect` span left to the caller)."""

    h = closest_hit_wavefront(scene, ro, rd, eps, W=W, active=active,
                              coherent=coherent)
    if not scene.two_level:
        h = _fixup_backside(scene, h)
    return _apply_active(h, active)


def closest_hit(scene, ro: V3, rd: V3, eps, W=None, active=None,
                coherent: bool = True) -> HitInfo:
    """ray_scene_intersection (bvh_custom.wgsl:7-110): dense scenes through
    kernel B1, BVH scenes through the wavefront (intersect.py:1118-1167).
    World-soup scenes flip the backside flag by the hit instance's det sign;
    two-level scenes intersect in object space, where det already has the
    reference's sign (and their global triangle ids do not index wt_inst).
    `active` masks lanes (inactive lanes report a miss); `coherent=False`
    marks a divergent bounce batch (no B4)."""

    B = ro.x.shape[0]
    if scene.instances_empty:
        return miss(B, ro.x.device)
    if scene.use_bvh:
        with trace.span("intersect"):
            return _closest_hit_bvh(scene, ro, rd, eps, W, active, coherent)
    if W is None:
        W = scene_tri_matrix(scene)
    t, u, v, det, idx = dk.dense_closest_hit(W, ray_features(ro, rd), eps)
    h = HitInfo(hit=t < F32_MAX, dst=t, u=u, v=v, tri=idx, backside=det > 0.0)
    return _apply_active(_fixup_backside(scene, h), active)


def closest_hit_attrs(scene, ro: V3, rd: V3, eps, W=None, active=None,
                      coherent: bool = True):
    """Closest hit with the winner's attributes (intersect.py:1229-1286):
    dense scenes return the packed (ATTR_WIDTH, B) rows of kernel B2; BVH
    scenes an InterpAttrs, from B4 on coherent batches of single-level
    scenes and from wavefront_fetch_attrs (B7) otherwise (two-level scenes
    always: B4 fuses no attributes there). A scene without instances
    returns (miss, None)."""

    if scene.instances_empty:
        return closest_hit(scene, ro, rd, eps, W=W), None
    if scene.use_bvh:
        with trace.span("intersect"):
            if not scene.two_level and _route(scene, ro.x, coherent) == "packet":
                ROUTES["packet"] += 1
                return _packet_hit_attrs(scene, ro, rd, eps, W=W, active=active)
            h = _closest_hit_bvh(scene, ro, rd, eps, W, active, coherent)
            with trace.span("fetch"):
                return h, wavefront_fetch_attrs(scene, h)
    if W is None:
        W = scene_tri_matrix(scene)
    t, u, v, det, idx, attr = dk.dense_closest_hit_attrs(
        W, scene.wt_attr, ray_features(ro, rd), eps
    )
    if active is not None:
        # Inactive lanes: a miss with zeroed attrs.
        t = torch.where(active, t, F32_MAX)
        u = torch.where(active, u, 0.0)
        v = torch.where(active, v, 0.0)
        det = torch.where(active, det, 0.0)
        idx = torch.where(active, idx, 0)
        attr = torch.where(active[None, :], attr, 0.0)
    backside = det > 0.0
    flip = attr[dk.ATTR_DET_SIGN] < 0.0
    h = HitInfo(
        hit=t < F32_MAX, dst=t, u=u, v=v, tri=idx,
        backside=torch.where(flip, ~backside, backside),
    )
    return h, attr
