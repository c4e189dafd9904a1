"""The benchmark's plain reference renderer (PyTorch and numpy only).

It imports nothing of the program. From the scene description that
`scenes.py` makes (the same arrays the harness hands to the program) it works
out, for a sample of pixels:

- the progressive image of the STANDARD integrator: per (pixel, accumulation,
  sample) one path with the renderer's PCG streams and draw order, the
  one-sample BSDF/light mix, Russian roulette after bounce 3, the radiance
  clamp, the per-accumulation mean and the progressive blend; and the traced
  segments of every path.

Closest hits come from a brute-force ray/triangle test (the renderer's
ten-term coefficient form, so that rounding follows the renderer's) behind a
plain culling tree of its own: primitives in Morton order, boxes of 16
children per level, no ordering and no early exit. Two-level scenes test
each candidate instance's mesh in mesh space, as the renderer does.

The reference supports what the benchmark's configurations use: matte,
glossy and reflective materials, emissive instances as area lights, no
textures, alpha, volumes, environments or delta lobes; it raises on others.
`dtype` selects the precision of every float computation; the benchmark's
control computes it in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MATTE, GLOSSY, REFLECTIVE = 0, 1, 2
MIN_ROUGHNESS = 0.03 * 0.03
PI = 3.14159265358979323846264338327950288
SMALL_LIGHT_TRIS = 32
FANOUT = 16
LEAF_TRIS = 16
RAY_CHUNK = 16384
PAIR_CHUNK = 1 << 21
LANE_CHUNK = 1 << 20

# --------------------------------------------------------------------------
# Vectors as (x, y, z) tensors, every expression in the renderer's order
# --------------------------------------------------------------------------


class V:
    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def __add__(self, o):
        return V(self.x + o.x, self.y + o.y, self.z + o.z) if isinstance(o, V) \
            else V(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        return V(self.x - o.x, self.y - o.y, self.z - o.z) if isinstance(o, V) \
            else V(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        return V(self.x * o.x, self.y * o.y, self.z * o.z) if isinstance(o, V) \
            else V(self.x * o, self.y * o, self.z * o)

    def __truediv__(self, o):
        return V(self.x / o.x, self.y / o.y, self.z / o.z) if isinstance(o, V) \
            else V(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V(-self.x, -self.y, -self.z)

    def __getitem__(self, idx):
        return V(self.x[idx], self.y[idx], self.z[idx])

    def rows(self):
        return torch.stack([self.x, self.y, self.z], dim=-1)


def _rsub(s, a: V) -> V:
    return V(s - a.x, s - a.y, s - a.z)


def dot(a: V, b: V):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V, b: V) -> V:
    return V(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def normalize(a: V) -> V:
    n = torch.clamp_min(torch.sqrt(dot(a, a)), 1e-20)
    return V(a.x / n, a.y / n, a.z / n)


def where(m, a, b) -> V:
    a = a if isinstance(a, V) else V(a, a, a)
    b = b if isinstance(b, V) else V(b, b, b)
    return V(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
             torch.where(m, a.z, b.z))


def all_zero(a: V):
    return (a.x == 0.0) & (a.y == 0.0) & (a.z == 0.0)


def max_comp(a: V):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def is_finite(a: V):
    return torch.isfinite(a.x) & torch.isfinite(a.y) & torch.isfinite(a.z)


def nan_to_zero(a: V) -> V:
    def f(c):
        return torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)

    return V(f(a.x), f(a.y), f(a.z))


def vrows(t) -> V:
    return V(t[..., 0], t[..., 1], t[..., 2])


# --------------------------------------------------------------------------
# PCG32 streams (u32 values held in int64 tensors)
# --------------------------------------------------------------------------

_MASK = 0xFFFFFFFF


def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK


def _u32(x, device):
    if not torch.is_tensor(x):
        x = torch.tensor(int(x), dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def hash_u32(x):
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    return x ^ (x >> 14)


def init_state(pixel, accum, seed, sample):
    dev = pixel.device
    return hash_u32(_mul32(_u32(pixel, dev), 19349663)
                    ^ _mul32(_u32(accum, dev), 83492791)
                    ^ _mul32(_u32(seed, dev), 73856093)
                    ^ _mul32(_u32(sample, dev), 2654435769))


class Rng:
    """Per-lane PCG32 streams; uniforms come out in `dtype`."""

    def __init__(self, state, dtype):
        self.state, self.dtype = state, dtype

    def u32(self):
        s = (_mul32(self.state, 747796405) + 2891336453) & _MASK
        self.state = s
        w = _mul32((s >> ((s >> 28) + 4)) ^ s, 277803737)
        return (w >> 22) ^ w

    def f(self):
        w = self.u32()
        wi = torch.where(w >= 2**31, w - 2**32, w)
        f = wi.to(torch.float32)
        f = torch.where(wi < 0, f + 4294967296.0, f) / 4294967295.0
        return f.to(self.dtype)

    def range(self, n: int):
        r = self.f()
        return torch.clamp_max((r * float(n)).to(torch.int32), n - 1)


# --------------------------------------------------------------------------
# Scene preparation
# --------------------------------------------------------------------------


def _nrm_np(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)


def _transform_points(frame, pts):
    return pts @ frame[:, :3].T + frame[:, 3]


def _normal_matrix(frame):
    return np.linalg.inv(frame[:, :3].astype(np.float64)).T.astype(np.float32)


def _mesh_soup(mesh, frame):
    """World (or mesh) space v0, e1, e2 and vertex normals n0, n1, n2 of one
    mesh under `frame`, as the renderer's scene flattening bakes them."""

    wp = _transform_points(frame, mesh["positions"])
    tri = mesh["indices"].astype(np.int64)
    v0, v1, v2 = wp[tri[:, 0]], wp[tri[:, 1]], wp[tri[:, 2]]
    nm = _normal_matrix(frame)
    if mesh["normals"] is not None:
        nw = mesh["normals"][:, :3] @ nm.T
        ns = (nw[tri[:, 0]], nw[tri[:, 1]], nw[tri[:, 2]])
    else:
        p = mesh["positions"]
        p0, p1, p2 = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
        gn = _nrm_np(_nrm_np(np.cross(p2 - p0, p1 - p0)) @ nm.T)
        ns = (gn, gn, gn)
    return (v0, v1 - v0, v2 - v0) + ns


def build_alias_table(weights):
    """PBRT-4's alias table (the renderer's light sampling table): per bin a
    threshold and an alias, from LIFO work lists of under- and over-full
    bins."""

    weights = np.asarray(weights, np.float64).ravel()
    n = weights.size
    prob = (weights / weights.sum()).astype(np.float32)
    threshold = np.zeros(n, np.float32)
    alias = np.zeros(n, np.int64)
    est = (prob.astype(np.float64) * n).astype(np.float32)
    under = [(float(est[i]), i) for i in range(n) if est[i] < 1.0]
    over = [(float(est[i]), i) for i in range(n) if not est[i] < 1.0]
    while under and over:
        ue, ui = under.pop()
        oe, oi = over.pop()
        threshold[ui] = np.float32(ue)
        alias[ui] = oi
        excess = np.float32(np.float32(ue) + np.float32(oe) - np.float32(1.0))
        (under if excess < 1.0 else over).append((float(excess), oi))
    for _, i in under + over:
        threshold[i] = 1.0
        alias[i] = 0
    return threshold, alias


def _tri_matrix(v0: V, e1: V, e2: V):
    """(T, 4, 10) rows: det, u, v and t numerators against [d, o x d, o, 1]."""

    n = cross(e1, e2)
    a = cross(e2, v0)
    b = cross(e1, v0)
    nv0 = dot(n, v0)
    z = torch.zeros_like(v0.x)
    rows = [[n.x, n.y, n.z, z, z, z, z, z, z, z],
            [a.x, a.y, a.z, -e2.x, -e2.y, -e2.z, z, z, z, z],
            [-b.x, -b.y, -b.z, e1.x, e1.y, e1.z, z, z, z, z],
            [z, z, z, z, z, z, -n.x, -n.y, -n.z, nv0]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _features(o: V, d: V):
    c = V(o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z, o.x * d.y - o.y * d.x)
    return torch.stack([d.x, d.y, d.z, c.x, c.y, c.z, o.x, o.y, o.z,
                        torch.ones_like(o.x)], dim=-1)


def _tuv(R, W, eps, big):
    """t (big where invalid), u, v of rays R (..., 10) against rows W
    (..., 4, 10): each numerator a ten-term sum in order."""

    num = []
    for c in range(4):
        acc = R[..., 0] * W[..., c, 0]
        for k in range(1, 10):
            acc = acc + R[..., k] * W[..., c, k]
        num.append(acc)
    det, nu, nv, nt = num
    d = 1.0 / det
    t, u, v = nt * d, nu * d, nv * d
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= eps)
    return torch.where(ok, t, big), u, v


class _CullTree:
    """Boxes over primitives in Morton order: level 0 holds leaves of
    `leaf` primitives, each further level FANOUT boxes of the one below."""

    def __init__(self, lo, hi, leaf, device):
        c = (lo + hi) * 0.5
        span = np.maximum(c.max(0) - c.min(0), 1e-30)
        q = np.clip(((c - c.min(0)) / span * 1023.0), 0, 1023).astype(np.int64)
        code = np.zeros(len(c), np.int64)
        for bit in range(10):
            for ax in range(3):
                code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
        self.order = torch.from_numpy(np.argsort(code, kind="stable")).to(device)
        lo_s = torch.from_numpy(lo).to(device)[self.order]
        hi_s = torch.from_numpy(hi).to(device)[self.order]
        pad = 1e-5 * (1.0 + torch.maximum(lo_s.abs(), hi_s.abs()))
        self.n, self.leaf = len(c), leaf
        self.levels = []
        box_lo, box_hi, width = lo_s - pad, hi_s + pad, leaf
        while True:
            m = -(-box_lo.shape[0] // width)
            fill = m * width - box_lo.shape[0]
            blo = torch.cat([box_lo, box_lo.new_full((fill, 3), math.inf)])
            bhi = torch.cat([box_hi, box_hi.new_full((fill, 3), -math.inf)])
            box_lo = blo.reshape(m, width, 3).amin(1)
            box_hi = bhi.reshape(m, width, 3).amax(1)
            self.levels.append((box_lo, box_hi))
            if m <= FANOUT:
                break
            width = FANOUT
        self.levels.reverse()

    def candidates(self, o, inv_d):
        """(ray, primitive) pairs whose boxes the rays (ray-major tensors
        o, inv_d of shape (B, 3), float32) pass, primitives in input ids."""

        dev = o.device
        B = o.shape[0]
        n0 = self.levels[0][0].shape[0]
        ray = torch.arange(B, device=dev).repeat_interleave(n0)
        node = torch.arange(n0, device=dev).repeat(B)
        for li, (lo, hi) in enumerate(self.levels):
            oo, ii = o[ray], inv_d[ray]
            t1 = (lo[node] - oo) * ii
            t2 = (hi[node] - oo) * ii
            tmin = torch.fmin(t1, t2).nan_to_num(nan=-math.inf).amax(1)
            tmax = torch.fmax(t1, t2).nan_to_num(nan=math.inf).amin(1)
            keep = (tmin <= tmax) & (tmax >= 0.0)
            ray, node = ray[keep], node[keep]
            width = FANOUT if li + 1 < len(self.levels) else self.leaf
            limit = (self.levels[li + 1][0].shape[0] if li + 1 < len(self.levels)
                     else self.n)
            ray = ray.repeat_interleave(width)
            node = (node[:, None] * width
                    + torch.arange(width, device=dev)[None, :]).reshape(-1)
            keep = node < limit
            ray, node = ray[keep], node[keep]
        return ray, self.order[node]


class Reference:
    """The scene's tables for the reference, on `device`, in `dtype`."""

    def __init__(self, scene: dict, two_level: bool, device, dtype=torch.float32):
        self.device, self.dtype, self.two_level = device, dtype, two_level
        self.big = float(torch.finfo(dtype).max)
        mats = scene["materials"]
        for m in mats:
            if m["mat_type"] not in (MATTE, GLOSSY, REFLECTIVE):
                raise ValueError(f"material type {m['mat_type']} is not supported")
        dt, dev = dtype, device

        def T(a, d=dt):
            return torch.as_tensor(np.asarray(a), device=dev).to(d)

        self.m_color = T([m["color"][:3] for m in mats], torch.float32)
        self.m_emission = T([m["emission"][:3] for m in mats], torch.float32)
        self.m_type = T([m["mat_type"] for m in mats], torch.int32)
        self.m_rough = T([m["roughness"] for m in mats], torch.float32)
        self.m_ior = T([m["ior"] for m in mats], torch.float32)
        meshes = scene["meshes"]
        frames = scene["frames"]
        inst_mesh, inst_mat = scene["inst_mesh"], scene["inst_mat"]
        if two_level:
            self._prep_two_level(meshes, frames, inst_mesh, inst_mat)
        else:
            self._prep_single_level(meshes, frames, inst_mesh, inst_mat)
        self._prep_lights(meshes, mats, frames, inst_mesh, inst_mat)

    def _t(self, a, d=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device).to(
            d or self.dtype)

    def _prep_single_level(self, meshes, frames, inst_mesh, inst_mat):
        cols = [[] for _ in range(6)]
        mat = []
        for f, mi, ki in zip(frames, inst_mesh, inst_mat):
            for c, a in zip(cols, _mesh_soup(meshes[mi], f)):
                c.append(a)
            mat.append(np.full(meshes[mi]["indices"].shape[0], ki, np.int64))
        v0, e1, e2, n0, n1, n2 = (np.concatenate(c).astype(np.float32) for c in cols)
        self.tri_mat = self._t(np.concatenate(mat), torch.int64)
        self.tri_n = [vrows(self._t(a)) for a in (n0, n1, n2)]
        self.W = _tri_matrix(*(vrows(self._t(a)) for a in (v0, e1, e2)))
        lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
        hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
        self.tree = _CullTree(lo, hi, LEAF_TRIS, self.device)

    def _prep_two_level(self, meshes, frames, inst_mesh, inst_mat):
        ident = np.eye(3, 4, dtype=np.float32)
        used = sorted(set(int(m) for m in inst_mesh))
        tmax = max(meshes[m]["indices"].shape[0] for m in used)
        nm = len(meshes)
        W = torch.zeros((nm, tmax, 4, 10), dtype=self.dtype, device=self.device)
        N = torch.zeros((3, nm, tmax, 3), dtype=self.dtype, device=self.device)
        self.mesh_tris = [0] * nm
        mlo = np.zeros((nm, 3), np.float32)
        mhi = np.zeros((nm, 3), np.float32)
        for m in used:
            v0, e1, e2, n0, n1, n2 = _mesh_soup(meshes[m], ident)
            k = v0.shape[0]
            self.mesh_tris[m] = k
            W[m, :k] = _tri_matrix(*(vrows(self._t(a)) for a in (v0, e1, e2)))
            for j, a in enumerate((n0, n1, n2)):
                N[j, m, :k] = self._t(a)
            mlo[m] = meshes[m]["positions"].min(0)
            mhi[m] = meshes[m]["positions"].max(0)
        self.mW, self.mN = W, N
        a64 = frames[:, :, :3].astype(np.float64)
        inv64 = np.linalg.inv(a64)
        rinv = inv64.astype(np.float32)
        inv = np.zeros(frames.shape, np.float32)
        inv[:, :, :3] = rinv
        inv[:, :, 3] = -np.einsum("iab,ib->ia", rinv, frames[:, :, 3])
        self.inst_inv = self._t(inv.reshape(-1, 12))
        self.inst_nrm = self._t(np.transpose(inv64, (0, 2, 1)).astype(np.float32)
                                .reshape(-1, 9))
        self.inst_mesh = self._t(inst_mesh, torch.int64)
        self.inst_mat = self._t(inst_mat, torch.int64)
        corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                           -1).reshape(8, 3)
        lo_m, hi_m = mlo[inst_mesh], mhi[inst_mesh]
        pts = lo_m[:, None, :] + corners[None] * (hi_m - lo_m)[:, None, :]
        wpts = np.einsum("iab,icb->ica", frames[:, :, :3], pts) + frames[:, None, :, 3]
        self.tree = _CullTree(wpts.min(1), wpts.max(1), 1, self.device)

    def _prep_lights(self, meshes, mats, frames, inst_mesh, inst_mat):
        areas_l, thr, ali, v0s, e1s, e2s, light_of = [], [], [], [], [], [], []
        offs = []
        for f, mi, ki in zip(frames, inst_mesh, inst_mat):
            mesh = meshes[mi]
            if not np.any(np.asarray(mats[ki]["emission"])[:3] != 0.0):
                continue
            if mesh["indices"].shape[0] == 0:
                continue
            tri = mesh["indices"].astype(np.int64)
            p0, p1, p2 = (mesh["positions"][tri[:, k]] for k in range(3))
            areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
            total = float(areas.sum())
            if total <= 0.0:
                continue
            t_, a_ = build_alias_table(areas)
            offs.append(sum(len(x) for x in thr))
            light_of.append(np.full(len(tri), len(areas_l), np.int64))
            areas_l.append(total)
            thr.append(t_)
            ali.append(a_)
            w0, w1, w2 = (_transform_points(f, p).astype(np.float32)
                          for p in (p0, p1, p2))
            v0s.append(w0)
            e1s.append((w1 - w0).astype(np.float32))
            e2s.append((w2 - w0).astype(np.float32))
        self.n_lights = len(areas_l)
        if not self.n_lights:
            return
        self.l_off = self._t(offs, torch.int64)
        self.l_size = self._t([len(x) for x in thr], torch.int32)
        self.l_thr = self._t(np.concatenate(thr))
        self.l_alias = self._t(np.concatenate(ali), torch.int64)
        self.lt = [vrows(self._t(np.concatenate(a))) for a in (v0s, e1s, e2s)]
        self.lt_area = self._t(np.asarray(areas_l, np.float32))[
            self._t(np.concatenate(light_of), torch.int64)]
        self.n_lt = self.lt_area.shape[0]
        if self.n_lt > SMALL_LIGHT_TRIS:
            self.lW = _tri_matrix(*self.lt)
        self.l_nhat = normalize(cross(self.lt[1], self.lt[2]))

    # ---------------------------------------------------------------- hits

    def closest_hit(self, o: V, d: V, eps, active):
        """Per lane (hit, t, u, v, primitive, local triangle) of the closest
        hit at t >= eps; inactive lanes miss. A primitive is a triangle of
        a single-level scene or an instance of a two-level one."""

        B = o.x.shape[0]
        dev, dt, big = self.device, self.dtype, self.big
        best = torch.full((B,), big, dtype=dt, device=dev)
        bu = torch.zeros(B, dtype=dt, device=dev)
        bv = torch.zeros(B, dtype=dt, device=dev)
        bp = torch.zeros(B, dtype=torch.int64, device=dev)
        bl = torch.zeros(B, dtype=torch.int64, device=dev)
        lanes = torch.nonzero(active).flatten()
        pairs = PAIR_CHUNK // (64 if self.two_level else 1)
        # A ray has at most one pair a primitive: where the scene is small,
        # rays go in chunks whose pairs still fit one pair chunk.
        chunk = max(RAY_CHUNK, pairs // self.tree.n)
        for s in range(0, lanes.numel(), chunk):
            ln = lanes[s:s + chunk]
            C = ln.numel()
            oc, dc = o[ln], d[ln]
            ray, prim = self.tree.candidates(oc.rows().float(),
                                             1.0 / dc.rows().float())
            cb = torch.full((C,), big, dtype=dt, device=dev)
            cu, cv = torch.zeros_like(cb), torch.zeros_like(cb)
            cp = torch.zeros(C, dtype=torch.int64, device=dev)
            cl = torch.zeros_like(cp)
            for p0 in range(0, ray.numel(), pairs):
                r, pr = ray[p0:p0 + pairs], prim[p0:p0 + pairs]
                t, u, v, loc = self._test(oc[r], dc[r], pr, eps)
                m = torch.full((C,), big, dtype=dt, device=dev)
                m.scatter_reduce_(0, r, t, "amin")
                win = (t == m[r]) & (t < big)
                first = torch.full((C,), torch.iinfo(torch.int64).max,
                                   dtype=torch.int64, device=dev)
                first.scatter_reduce_(0, r[win], pr[win], "amin")
                sel = win & (pr == first[r])
                rs = r[sel]
                upd = m[rs] < cb[rs]  # an earlier pair keeps a tie
                rs = rs[upd]
                cb[rs] = t[sel][upd]
                cu[rs] = u[sel][upd]
                cv[rs] = v[sel][upd]
                cp[rs] = pr[sel][upd]
                cl[rs] = loc[sel][upd]
            best[ln], bu[ln], bv[ln], bp[ln], bl[ln] = cb, cu, cv, cp, cl
        return best < big, best, bu, bv, bp, bl

    def _test(self, o: V, d: V, prim, eps):
        """(t, u, v, local triangle) of each (ray, primitive) pair."""

        if not self.two_level:
            t, u, v = _tuv(_features(o, d), self.W[prim], eps, self.big)
            return t, u, v, torch.zeros_like(prim)
        m = self.inst_inv[prim]
        mo = V(m[:, 0] * o.x + m[:, 1] * o.y + m[:, 2] * o.z + m[:, 3],
               m[:, 4] * o.x + m[:, 5] * o.y + m[:, 6] * o.z + m[:, 7],
               m[:, 8] * o.x + m[:, 9] * o.y + m[:, 10] * o.z + m[:, 11])
        md = V(m[:, 0] * d.x + m[:, 1] * d.y + m[:, 2] * d.z,
               m[:, 4] * d.x + m[:, 5] * d.y + m[:, 6] * d.z,
               m[:, 8] * d.x + m[:, 9] * d.y + m[:, 10] * d.z)
        R = _features(mo, md)
        t, u, v = _tuv(R[:, None, :], self.mW[self.inst_mesh[prim]], eps,
                       self.big)
        t, loc = torch.min(t, dim=1)  # the first index on a tie
        u = u.gather(1, loc[:, None])[:, 0]
        v = v.gather(1, loc[:, None])[:, 0]
        return t, u, v, loc

    def hit_attrs(self, hit, u, v, prim, loc):
        """Unnormalised shading normal and material id at each hit."""

        w = 1.0 - u - v
        if not self.two_level:
            n0, n1, n2 = (x[prim] for x in self.tri_n)
            n = n0 * w + n1 * u + n2 * v
            mat = self.tri_mat[prim]
        else:
            mesh = self.inst_mesh[prim]
            n0, n1, n2 = (vrows(self.mN[j][mesh, loc]) for j in range(3))
            n = n0 * w + n1 * u + n2 * v
            nm = self.inst_nrm[prim]
            n = V(nm[:, 0] * n.x + nm[:, 1] * n.y + nm[:, 2] * n.z,
                  nm[:, 3] * n.x + nm[:, 4] * n.y + nm[:, 5] * n.z,
                  nm[:, 6] * n.x + nm[:, 7] * n.y + nm[:, 8] * n.z)
            mat = self.inst_mat[prim]
        mat = torch.where(hit, mat, 0)
        return n, mat

    # -------------------------------------------------------------- lights

    def sample_lights(self, pos: V, rng: Rng):
        B = pos.x.shape[0]
        nl = self.n_lights
        if nl == 0:
            z = torch.zeros(B, dtype=self.dtype, device=self.device)
            return V(z, z, z)
        pick = rng.range(nl)
        r_bin, r_thr, ra, rb = rng.f(), rng.f(), rng.f(), rng.f()
        li = torch.clamp(pick, 0, nl - 1).long()
        size = self.l_size[li]
        idx = torch.minimum((r_bin * size.to(self.dtype)).to(torch.int32), size - 1)
        gi = self.l_off[li] + idx.long()
        tri = torch.where(r_thr >= self.l_thr[gi], self.l_alias[gi], idx.long())
        s = torch.sqrt(ra)
        tu = 1.0 - s
        tv = rb * s
        gt = self.l_off[li] + tri
        v0, e1, e2 = (x[gt] for x in self.lt)
        p = v0 + e1 * tu + e2 * tv
        return where(pick < nl, normalize(p - pos), 0.0)

    def lights_pdf(self, pos: V, inc: V, eps):
        nl = self.n_lights
        if nl == 0:
            return torch.zeros_like(pos.x)
        v0, e1, e2 = self.lt
        if self.n_lt <= SMALL_LIGHT_TRIS:
            pdf = torch.zeros_like(pos.x)
            for i in range(self.n_lt):
                tv0, te1, te2 = v0[i], e1[i], e2[i]
                n = cross(te1, te2)
                rov0 = pos - tv0
                q = cross(rov0, inc)
                dd = 1.0 / dot(inc, n)
                uu = dd * -dot(q, te2)
                vv = dd * dot(q, te1)
                t = dd * -dot(n, rov0)
                ok = (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (t >= eps)
                t = torch.where(ok, t, self.big)
                nh = normalize(cross(te1, te2))
                cos = torch.abs(dot(inc, nh))
                pdf = pdf + torch.where(
                    t < self.big,
                    (t * t) / torch.clamp_min(cos * self.lt_area[i], 1e-20), 0.0)
            return pdf / float(nl)
        nh = self.l_nhat
        B = pos.x.shape[0]
        chunk = max(1, (1 << 22) // self.n_lt)
        outs = []
        for s in range(0, B, chunk):
            pc, ic = pos[s:s + chunk], inc[s:s + chunk]
            t, _, _ = _tuv(_features(pc, ic)[:, None, :], self.lW[None], eps,
                           self.big)
            cos = torch.abs(ic.x[:, None] * nh.x[None, :]
                            + ic.y[:, None] * nh.y[None, :]
                            + ic.z[:, None] * nh.z[None, :])
            c = torch.where(t < self.big,
                            (t * t) / torch.clamp_min(cos * self.lt_area[None, :],
                                                      1e-20), 0.0)
            outs.append(c.sum(dim=-1))
        return torch.cat(outs) / float(nl)

    # ------------------------------------------------------------ materials

    def material(self, mat):
        T = self.dtype
        color = vrows(self.m_color[mat].to(T))
        emission = vrows(self.m_emission[mat].to(T))
        mtype = self.m_type[mat]
        r = self.m_rough[mat].to(T)
        r = r * r
        clamped = (mtype == MATTE) | (mtype == GLOSSY)
        r = torch.where(clamped, torch.clamp(r, MIN_ROUGHNESS, 1.0),
                        torch.where(r < MIN_ROUGHNESS, 0.0, r))
        return dict(type=mtype, color=color, emission=emission, rough=r,
                    ior=self.m_ior[mat].to(T))


# --------------------------------------------------------------------------
# BSDFs (matte, glossy, reflective), each expression in the renderer's order
# --------------------------------------------------------------------------


def _flip_up(n: V, o: V) -> V:
    return where(dot(n, o) <= 0.0, -n, n)


def _reflect(w: V, n: V) -> V:
    return -w + n * (2.0 * dot(n, w))


def _basis(v: V):
    z = normalize(v)
    sign = torch.where(z.z < 0.0, -1.0, 1.0).to(z.z.dtype)
    a = -1.0 / (sign + z.z)
    b = z.x * z.y * a
    x = V(1.0 + sign * z.x * z.x * a, sign * b, -sign * z.x)
    y = V(b, sign + z.y * z.y * a, -z.y)
    return x, y, z


def _from_basis(b, lx, ly, lz) -> V:
    x, y, z = b
    return x * lx + y * ly + z * lz


def _hemisphere_cos(n: V, rx, ry) -> V:
    z = torch.sqrt(ry)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * rx
    return normalize(_from_basis(_basis(n), r * torch.cos(phi), r * torch.sin(phi), z))


def _hemisphere_cos_pdf(n: V, d: V):
    c = dot(n, d)
    return torch.where(c <= 0.0, 0.0, c / PI)


def _fresnel_dielectric(eta, n: V, o: V):
    cosw = torch.abs(dot(n, o))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - sin2 / eta2
    t0 = torch.sqrt(torch.clamp_min(cos2t, 0.0))
    t1 = eta * t0
    t2 = eta * cosw
    rs = (cosw - t1) / (cosw + t1)
    rp = (t0 - t2) / (t0 + t2)
    f = (rs * rs + rp * rp) / 2.0
    return torch.where(cos2t < 0.0, 1.0, f)


def _fresnel_conductor(eta: V, n: V, o: V) -> V:
    cr = dot(n, o)
    cosw = torch.clamp(cr, -1.0, 1.0)
    cos2 = cosw * cosw
    sin2 = torch.clamp(1.0 - cos2, 0.0, 1.0)

    def chan(e):
        e2 = e * e
        t0 = e2 - sin2
        a2b2 = torch.abs(t0)
        t1 = a2b2 + cos2
        a = torch.sqrt(torch.clamp_min((a2b2 + t0) / 2.0, 0.0))
        t2 = 2.0 * a * cosw
        rs = (t1 - t2) / (t1 + t2)
        t3 = cos2 * a2b2 + sin2 * sin2
        t4 = t2 * sin2
        rp = rs * (t3 - t4) / (t3 + t4)
        return (rp + rs) / 2.0

    return where(cr <= 0.0, 0.0, V(chan(eta.x), chan(eta.y), chan(eta.z)))


def _ggx(r, n: V, h: V):
    c = dot(n, h)
    r2 = r * r
    c2 = c * c
    den = c2 * r2 + 1.0 - c2
    return torch.where(c <= 0.0, 0.0, r2 / (PI * den * den))


def _shadow1(r, n: V, h: V, w: V):
    c = dot(n, w)
    ch = dot(h, w)
    r2 = r * r
    c2 = c * c
    g = 2.0 * torch.abs(c) / (torch.abs(c) + torch.sqrt(torch.clamp_min(c2 - r2 * c2 + r2, 0.0)))
    return torch.where(c * ch <= 0.0, 0.0, g)


def _shadow(r, n, h, o, i):
    return _shadow1(r, n, h, o) * _shadow1(r, n, h, i)


def _sample_microfacet(r, n: V, rx, ry) -> V:
    phi = 2.0 * PI * rx
    theta = torch.atan(r * torch.sqrt(ry / torch.clamp_min(1.0 - ry, 1e-12)))
    st = torch.sin(theta)
    return normalize(_from_basis(_basis(n), torch.cos(phi) * st,
                                 torch.sin(phi) * st, torch.cos(theta)))


def _microfacet_pdf(r, n: V, h: V):
    c = dot(n, h)
    return torch.where(c < 0.0, 0.0, _ggx(r, n, h) * c)


def _same_hemi(n, o, i):
    return dot(n, o) * dot(n, i) >= 0.0


def _sample(mp, n, o, rnl, rx, ry):
    up = _flip_up(n, o)
    zero = torch.zeros_like(rnl)
    diff = _hemisphere_cos(up, rx, ry)
    h = _sample_microfacet(mp["rough"], up, rx, ry)
    refl = _reflect(o, h)
    refl = where(_same_hemi(up, o, refl), refl, zero)
    f = _fresnel_dielectric(mp["ior"], up, o)
    glossy = where(rnl < f, refl, diff)
    t = mp["type"]
    out = where(t == GLOSSY, glossy, where(t == REFLECTIVE, refl, diff))
    return where(mp["rough"] == 0.0, zero, out)


def _eval(mp, n, o, i):
    mask = dot(n, i) * dot(n, o) <= 0.0
    up = _flip_up(n, o)
    r = mp["rough"]
    absin = torch.abs(dot(up, i))
    matte = mp["color"] * (torch.abs(dot(n, i)) / PI)
    h = normalize(i + o)
    d = _ggx(r, up, h)
    g = _shadow(r, up, h, o, i)
    f1 = _fresnel_dielectric(mp["ior"], up, o)
    f = _fresnel_dielectric(mp["ior"], h, i)
    spec = f * d * g / (4.0 * dot(up, o) * dot(up, i)) * absin
    glossy = mp["color"] * ((1.0 - f1) / PI * absin) + spec
    c = mp["color"]
    s = torch.sqrt
    rr = V(torch.clamp(c.x, 0.0, 0.99), torch.clamp(c.y, 0.0, 0.99),
           torch.clamp(c.z, 0.0, 0.99))
    sq = V(s(rr.x), s(rr.y), s(rr.z))
    eta = V(1.0 + sq.x, 1.0 + sq.y, 1.0 + sq.z) / _rsub(1.0, sq)
    fc = _fresnel_conductor(eta, h, i)
    refl = fc * (d * g / (4.0 * dot(up, o) * dot(up, i)) * torch.abs(dot(up, i)))
    t = mp["type"]
    out = where(t == GLOSSY, glossy, where(t == REFLECTIVE, refl, matte))
    out = where(mask, 0.0, out)
    out = where(mp["rough"] == 0.0, 0.0, out)
    return nan_to_zero(out)


def _pdf(mp, n, o, i):
    mask = dot(n, i) * dot(n, o) <= 0.0
    up = _flip_up(n, o)
    h = normalize(o + i)
    matte = _hemisphere_cos_pdf(up, i)
    refl = _microfacet_pdf(mp["rough"], up, h) / (4.0 * torch.abs(dot(o, h)))
    f = _fresnel_dielectric(mp["ior"], up, o)
    glossy = f * _microfacet_pdf(mp["rough"], up, h) / (
        4.0 * torch.abs(dot(o, h))) + (1.0 - f) * _hemisphere_cos_pdf(up, i)
    t = mp["type"]
    out = torch.where(t == GLOSSY, glossy, torch.where(t == REFLECTIVE, refl, matte))
    out = torch.where(mask, 0.0, out)
    out = torch.where(mp["rough"] == 0.0, 0.0, out)
    return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


# --------------------------------------------------------------------------
# Camera, paths and AOVs
# --------------------------------------------------------------------------


def _f32(x) -> float:
    return float(np.float32(x))


def camera_rays(cam: dict, gx, gy, width, height, rng: Rng):
    """One jittered thin-lens camera ray per lane (the renderer's camera
    model and draw order: two jitter uniforms, then a disk sample)."""

    dt = rng.dtype
    ox, oy = rng.f(), rng.f()
    f32 = np.float32
    film, aspect, lens = f32(cam["film"]), f32(cam["aspect"]), f32(cam["lens"])
    film_w = float(film if aspect >= 1.0 else film * aspect)
    film_h = float(film / aspect if aspect >= 1.0 else film)
    res_x, res_y = _f32(width), _f32(height)
    px = gx.to(dt) + 0.5
    py = res_y - gy.to(dt) + 0.5
    u = (px + (ox - 0.5)) / res_x
    v = (py + (oy - 0.5)) / res_y
    rx, ry = rng.f(), rng.f()
    r = torch.sqrt(ry)
    phi = 2.0 * PI * rx
    dx, dy = torch.cos(phi) * r, torch.sin(phi) * r
    if cam["is_orthographic"]:
        raise ValueError("orthographic cameras are not supported")
    aperture, focus = _f32(cam["aperture"]), _f32(cam["focus"])
    qx = film_w * (0.5 - u)
    qy = film_h * (0.5 - v)
    qz = torch.full_like(qx, float(lens))
    ql = torch.sqrt(qx * qx + qy * qy + qz * qz)
    look = V(-qx / ql, -qy / ql, -qz / ql)
    lp = V(dx * aperture / 2.0, dy * aperture / 2.0, torch.zeros_like(dx))
    fs = torch.full_like(qx, focus) / torch.abs(look.z)
    d = normalize(look * fs - lp)
    ro, rd = lp, V(d.x, d.y, -d.z)
    m = [[_f32(cam["transform"][i][j]) for j in range(4)] for i in range(3)]
    o = V(m[0][0] * ro.x + m[0][1] * ro.y + m[0][2] * ro.z + m[0][3],
          m[1][0] * ro.x + m[1][1] * ro.y + m[1][2] * ro.z + m[1][3],
          m[2][0] * ro.x + m[2][1] * ro.y + m[2][2] * ro.z + m[2][3])
    dd = normalize(V(m[0][0] * rd.x + m[0][1] * rd.y + m[0][2] * rd.z,
                     m[1][0] * rd.x + m[1][1] * rd.y + m[1][2] * rd.z,
                     m[2][0] * rd.x + m[2][1] * rd.y + m[2][2] * rd.z))
    return o, dd


def trace_paths(ref: Reference, cam, gx, gy, width, height, accum, seed,
                sample, eps, max_bounces, max_radiance):
    """STANDARD paths, one per lane (pixel gx, gy; accumulation counter
    `accum`; sample index `sample`: tensors). Returns the clamped radiance
    (B, 3) and the traced segments of each path (B,)."""

    dt, dev = ref.dtype, ref.device
    B = gx.shape[0]
    pixel = gy.long() * width + gx.long()
    rng = Rng(init_state(pixel, accum, seed, sample), dt)
    ro, rd = camera_rays(cam, gx, gy, width, height, rng)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    hit, dst, u, v, prim, loc = ref.closest_hit(ro, rd, eps, alive)
    weight = V(*(torch.ones(B, dtype=dt, device=dev) for _ in range(3)))
    rad = V(*(torch.zeros(B, dtype=dt, device=dev) for _ in range(3)))
    segs = torch.ones(B, dtype=torch.int64, device=dev)
    bounce = 0
    while bool(alive.any()):
        entering = alive
        alive = alive & hit
        rng.f(), rng.f()  # the transmittance pair (no volumes)
        outgoing = -rd
        n_raw, mat = ref.hit_attrs(hit, u, v, prim, loc)
        normal = normalize(n_raw)
        mp = ref.material(mat)
        pos = ro + rd * dst
        rad = rad + where(alive, weight * mp["emission"], 0.0)
        r_choice, rnl, rx, ry = rng.f(), rng.f(), rng.f(), rng.f()
        bdir = _sample(mp, normal, outgoing, rnl, rx, ry)
        ldir = ref.sample_lights(pos, rng)
        inc = where(r_choice < 0.5, bdir, ldir)
        pdf = 0.5 * _pdf(mp, normal, outgoing, inc) + 0.5 * ref.lights_pdf(pos, inc, eps)
        dead = all_zero(inc)
        f = _eval(mp, normal, outgoing, inc)
        factor = f / torch.clamp_min(pdf, 0.0)
        alive = alive & ~dead
        weight = where(alive, weight * factor, weight)
        rng.f()  # the delta lobe's draw (no delta lobes)
        alive = alive & ~all_zero(weight) & is_finite(weight)
        rr = rng.f()
        rr_on = alive & (bounce > 3)
        survive = torch.clamp_max(max_comp(weight), 0.99)
        alive = alive & ~(rr_on & (rr >= survive))
        weight = where(rr_on & (rr < survive),
                       weight / torch.clamp_min(survive, 1e-12), weight)
        done = entering & (~alive | (bounce + 1 > max_bounces))
        cont = entering & ~done
        ro = where(cont, pos, ro)
        rd = where(cont, inc, rd)
        segs = segs + cont.long()
        nh, nd, nu, nv, np_, nl = ref.closest_hit(ro, rd, eps, cont)
        hit = torch.where(cont, nh, hit)
        dst, u, v = (torch.where(cont, a, b) for a, b in ((nd, dst), (nu, u), (nv, v)))
        prim = torch.where(cont, np_, prim)
        loc = torch.where(cont, nl, loc)
        alive = cont
        bounce += 1
    return clamp_radiance(rad, max_radiance).rows(), segs


def clamp_radiance(r: V, max_radiance) -> V:
    fin = is_finite(r)
    r = where(fin, r, 0.0)
    peak = max_comp(r)
    scale = torch.where(peak > max_radiance,
                        torch.full_like(peak, max_radiance) / torch.clamp_min(peak, 1e-20),
                        1.0)
    return r * scale


def progressive_pixels(ref: Reference, cam, gx, gy, width, height, seed,
                       accumulations, spp, eps, max_bounces, max_radiance):
    """The progressive image at pixels (gx, gy) after `accumulations`
    accumulations of `spp` samples, and the traced segments of each pixel
    over all of them: ((P, 3) float32, (P,) int64)."""

    dev, dt = ref.device, ref.dtype
    P = gx.shape[0]
    N = accumulations
    rep = N * spp
    lane_gx, lane_gy = gx.repeat_interleave(rep), gy.repeat_interleave(rep)
    k = torch.arange(rep, device=dev).repeat(P)
    accum, sample = k // spp, k % spp
    rad = torch.empty((P * rep, 3), dtype=dt, device=dev)
    segs = torch.empty(P * rep, dtype=torch.int64, device=dev)
    step = LANE_CHUNK
    for s in range(0, P * rep, step):
        sl = slice(s, s + step)
        rad[sl], segs[sl] = trace_paths(
            ref, cam, lane_gx[sl], lane_gy[sl], width, height, accum[sl], seed,
            sample[sl], eps, max_bounces, max_radiance)
    rad = rad.reshape(P, N, spp, 3)
    image = torch.zeros((P, 3), dtype=dt, device=dev)
    for c in range(N):
        acc = torch.zeros((P, 3), dtype=dt, device=dev)
        for s in range(spp):
            acc = acc + rad[:, c, s]
        col = torch.clamp_min(acc / float(spp), 0.0)
        if c == 0:
            image = col
        else:
            w = np.float32(1.0) / np.float32(c)
            keep = float(np.float32(1.0) - w)
            image = torch.clamp_min(image * keep + col * float(w), 0.0)
    return image.float(), segs.reshape(P, rep).sum(1)


def frame_segments(ref: Reference, cam, width, height, seed, accum, spp, eps,
                   max_bounces, max_radiance) -> int:
    """The traced segments of one whole accumulation: every pixel's `spp`
    paths at accumulation counter `accum`."""

    dev = ref.device
    n = width * height * spp
    total = 0
    step = LANE_CHUNK
    for s in range(0, n, step):
        k = torch.arange(s, min(s + step, n), device=dev)
        pix, sample = k // spp, k % spp
        _, segs = trace_paths(
            ref, cam, (pix % width).to(torch.int32), (pix // width).to(torch.int32),
            width, height, torch.full_like(k, accum), seed, sample, eps,
            max_bounces, max_radiance)
        total += int(segs.sum())
    return total
