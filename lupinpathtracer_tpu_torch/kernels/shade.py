"""The BVH route's shading step as one CUDA launch a loop iteration.

render/integrators.py::_pathtrace_snd shades a whole wavefront of lanes
between two traces. Its PyTorch step (materials, BSDF sampling, the 50/50
light mix with its pdf, Russian roulette, the end of the path, the respawn
of the pixel's next sample and the accumulation) is some 700 small kernels
an iteration. On the card, for scenes whose features B3's per-lane code
implements (kernels/mega.py::in_gate), `Step` runs it as one launch of
csrc/shade.cu instead: each lane reads the wavefront's hit record and its
loop state and writes slot A's next ray, state and mask in place, for the
loop's unchanged trace. The same PCG draws in the same order as the PyTorch
step, so every (pixel, sample) stream is its stream.

`Step` takes over the loop state of a `_Path` (render/integrators.py) into
two buffers it owns, (15, B) f32 and (4, B) int32 (the rows F_FIELDS and
C_FIELDS name), and points the path's fields at their rows. For tensors on the CPU it runs the PyTorch
step on them (integrators.shade_step_plain), its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.device import on_cpu
from ..core.vec3 import V3
from . import mega

# Launches, counted only where the kernel is launched: "shade" the fused
# steps, "shade_first" the first samples' (first_rays).
LAUNCHES = {"shade": 0, "shade_first": 0}

MAT_COLS = 16  # csrc/shade.cu: a material's block of the attribute row, padded
# Rows of the state buffers (csrc/shade.cu F_*, C_*): the ray, the weight,
# the radiance and acc as x, y, z rows; the counters.
F_FIELDS = ("ro", "rd", "weight", "radiance", "acc")
C_FIELDS = ("bounce", "sample_idx", "n_bounces", "n_traced")


def applicable(scene, ptype: int, regen, x) -> bool:
    """The fused step's gate, from the input alone: `x`, a tensor of the
    loop's, is on a CUDA device; the loop regenerates paths
    (integrators.pathtrace_spp); the scene is a BVH scene, whose hits carry
    the wavefront's interpolated attributes (dense scenes inside the gate
    run whole in B3); and it passes B3's feature gate, mega.in_gate."""

    return (x.is_cuda and regen is not None and scene.use_bvh
            and mega.in_gate(scene, ptype))


class _Params(ctypes.Structure):
    """Mirror of `Params` in csrc/shade.cu."""

    _fields_ = (
        [("cam", ctypes.c_float * 12)]
        + [(n, ctypes.c_float) for n in (
            "lens", "film_w", "film_h", "focus", "aperture", "res_x", "res_y",
            "eps", "max_radiance", "ortho_scale")]
        + [("accum", ctypes.c_uint32), ("seed", ctypes.c_uint32)]
        + [(n, ctypes.c_int) for n in (
            "sample_offset", "spp", "max_bounces", "use_nee", "is_ortho",
            "num_lights", "n_light_tris", "type_mask", "n_pix")]
    )


class _Lanes(ctypes.Structure):
    """Mirror of `Lanes` in csrc/shade.cu: one device pointer a field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "hit", "dst", "nx", "ny", "nz", "mat_id", "pix", "gx", "gy", "offs",
        "f", "c", "state", "alive")]


def bind(lib):
    """Declares lupin_shade_step's signature on a loaded build of
    csrc/shade.cu, once (cuda_build.load). Returns `lib`."""

    lib.lupin_shade_step.restype = ctypes.c_int
    lib.lupin_shade_step.argtypes = (
        [ctypes.POINTER(_Params), ctypes.POINTER(_Lanes)] + [ctypes.c_void_p] * 8)
    lib.lupin_shade_first.restype = ctypes.c_int
    lib.lupin_shade_first.argtypes = [
        ctypes.POINTER(_Params), ctypes.POINTER(_Lanes), ctypes.c_void_p]
    return lib


def pack_mat_table(scene):
    """(M, MAT_COLS) f32: per material the attribute row's material block
    (kernels/dense_intersect.py ATTR_MAT_COLOR .. ATTR_MAT_IOR: color rgba,
    emission, scattering, type, roughness, metallic, ior), zero-padded."""

    cols = [*scene.mat_color, *scene.mat_emission, *scene.mat_scattering,
            scene.mat_type, scene.mat_roughness, scene.mat_metallic, scene.mat_ior]
    z = torch.zeros_like(scene.mat_roughness)
    cols += [z] * (MAT_COLS - len(cols))
    return torch.stack([c.to(torch.float32) for c in cols], dim=1).contiguous()


def _mat_table(scene):
    """pack_mat_table(scene), built once per scene and kept on it."""

    table = scene.__dict__.get("_shade_mat_table")
    if table is None:
        table = scene.__dict__["_shade_mat_table"] = pack_mat_table(scene)
    return table


def _setup(scene, ctx, regen, ptype: int, max_bounces: int):
    """(Params, Lanes with the regeneration's pointers, the tensors they
    point at) of a regenerating loop's lanes on the card."""

    B = regen["pixel_idx"].shape[0]
    off = regen["sample_offset"]
    per_lane = torch.is_tensor(off) and off.dim() > 0
    keep = [regen[k].to(torch.int32).contiguous() for k in ("pixel_idx", "gx", "gy")]
    keep.append(off.to(torch.int64).contiguous() if per_lane else None)
    if any(t.shape != (B,) for t in keep if t is not None):
        raise ValueError("the regeneration's pixel arrays and sample offsets "
                         "must hold one entry a lane")
    base = mega._base_params(
        scene, regen["resolution"], regen["cam"], regen["is_ortho"], regen["spp"],
        ptype, max_bounces, regen["max_radiance"], ctx["eps"], B,
        0 if per_lane else int(off))
    p = _Params(**{n: getattr(base, n) for n, _ in _Params._fields_})
    p.accum = int(regen["accum_counter"]) & 0xFFFFFFFF
    p.seed = int(regen["rng_seed"]) & 0xFFFFFFFF
    lanes = _Lanes(**{n: None if t is None else t.data_ptr()
                      for n, t in zip(("pix", "gx", "gy", "offs"), keep)})
    return p, lanes, keep


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def first_rays(scene, ctx, regen, ptype: int, max_bounces: int):
    """(state, ro, rd) of every lane's first sample, what
    integrators._first_rays computes, where the fused step runs: on the card
    from the kernel's camera code, which computes every later sample's ray
    too (PyTorch on the card divides by a host scalar as a multiply by its
    f32 reciprocal, so its rays can differ from the kernel's by an ulp); on
    the CPU integrators._first_rays."""

    from ..render import integrators

    pix = regen["pixel_idx"]
    if on_cpu(pix):
        return integrators._first_rays(regen)
    from . import cuda_build

    p, lanes, keep = _setup(scene, ctx, regen, ptype, max_bounces)
    rays = torch.empty((6, pix.shape[0]), dtype=torch.float32, device=pix.device)
    state = torch.empty(pix.shape[0], dtype=torch.int64, device=pix.device)
    lanes.f, lanes.state = rays.data_ptr(), state.data_ptr()
    lib = cuda_build.load("shade", bind)
    with torch.cuda.device(pix.device):
        rc = lib.lupin_shade_first(ctypes.byref(p), ctypes.byref(lanes), _stream(pix.device))
    cuda_build.check(rc, "shade_first")
    LAUNCHES["shade_first"] += 1
    return state, V3(*rays[:3]), V3(*rays[3:])


class Step:
    """The shading step of one regenerating path loop (`p`, an
    integrators._Path with `regen`), on the card one launch a call.

    The constructor moves p's loop state into the step's buffers and points
    p's fields at their rows; each call shades p's hit record and leaves in
    p (the same buffers) slot A's ray, state and mask for the next trace,
    acc, the counters and the reset weights and radiances."""

    def __init__(self, scene, ctx, p, ptype: int, max_bounces: int):
        regen = p.regen
        self.scene, self.ctx, self.ptype, self.max_bounces = scene, ctx, ptype, max_bounces
        self.f = torch.stack([c for n in F_FIELDS for c in getattr(p, n)])
        self.c = torch.stack([getattr(p, n).to(torch.int32) for n in C_FIELDS])
        self.state = p.state.to(torch.int64).clone()
        self.alive = p.alive.clone()
        self._bind(p)
        if on_cpu(self.f):
            return
        self._p, self._lanes, self._keep = _setup(scene, ctx, regen, ptype, max_bounces)
        ln = self._lanes
        ln.f, ln.c = self.f.data_ptr(), self.c.data_ptr()
        ln.state, ln.alive = self.state.data_ptr(), self.alive.data_ptr()
        self._tabs = [_mat_table(scene).data_ptr(), *mega.light_tables(scene)[1]]

    def _bind(self, p):
        """Points p's loop state at the buffers' rows."""

        for k, n in enumerate(F_FIELDS):
            setattr(p, n, V3(*self.f[3 * k:3 * k + 3]))
        for k, n in enumerate(C_FIELDS):
            setattr(p, n, self.c[k])
        p.state, p.alive = self.state, self.alive

    def __call__(self, p):
        if on_cpu(self.f):
            self._plain(p)
        else:
            self._launch(p)

    def _plain(self, p):
        """The plain version: the PyTorch step on p, copied back into the
        buffers (which p's fields then name again)."""

        from ..render import integrators

        integrators.shade_step_plain(self.scene, self.ctx, p, self.ptype,
                                     self.max_bounces)
        for k, n in enumerate(F_FIELDS):
            for j, comp in enumerate(getattr(p, n)):
                self.f[3 * k + j].copy_(comp)
        for k, n in enumerate(C_FIELDS):
            self.c[k].copy_(getattr(p, n))
        self.state.copy_(p.state)
        self.alive.copy_(p.alive)
        self._bind(p)

    def _launch(self, p):
        from . import cuda_build

        hit, a = p.hit, p.attrs
        # The hit record's tensors, held until the launch call returns.
        rec = [hit.hit.contiguous(), hit.dst.contiguous(), a.n.x.contiguous(),
               a.n.y.contiguous(), a.n.z.contiguous(),
               a.mat_id.to(torch.int32).contiguous()]
        want = [torch.bool] + [torch.float32] * 4 + [torch.int32]
        B = self.alive.shape[0]
        if any(t.shape != (B,) or t.dtype != d or t.device != self.f.device
               for t, d in zip(rec, want)):
            raise ValueError("the hit record must hold one entry a lane on the "
                             "step's device: bool hit, f32 dst and normal, "
                             "int32 material id")
        ln = self._lanes
        ln.hit, ln.dst, ln.nx, ln.ny, ln.nz, ln.mat_id = (t.data_ptr() for t in rec)
        lib = cuda_build.load("shade", bind)
        dev = self.f.device
        with torch.cuda.device(dev):
            rc = lib.lupin_shade_step(ctypes.byref(self._p), ctypes.byref(ln),
                                      *self._tabs, _stream(dev))
        cuda_build.check(rc, "shade")
        LAUNCHES["shade"] += 1
