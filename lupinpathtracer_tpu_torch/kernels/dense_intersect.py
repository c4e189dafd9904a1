"""Kernels B1/B2: dense closest hit of every ray against every triangle.

The counterpart of lupinpathtracer_tpu/kernels/pallas_intersect.py
(`dense_closest_hit_pallas`, `dense_closest_hit_attrs_pallas`). Inputs are
the ray feature rows R (B, 10) = [d, o x d, o, 1] and the coefficient matrix
W4 (4, 10, T) of kernels/intersect.build_tri_matrix; the output per ray is
(t, u, v, det, idx) with t = F32_MAX on a miss (u, v, det, idx = 0), and for
B2 the winner's packed attribute row, transposed to (ATTR_WIDTH, B) as in
the JAX package (zeros on a miss).

On a CUDA tensor each wrapper launches its kernel from csrc/dense_intersect.cu
or raises. The kernel runs one thread per ray over the packed coefficient
groups of `bvh.pair_table` (four triangles per 16-byte load, staged in
shared memory STAGE_GROUPS groups at a time, strict-< running argmin in
index order, the sign pre-test before the divide where eps > 0); B2's
warps then transpose their 32 winners' rows through shared-memory tiles of
TILE_W columns into coalesced stores. On a CPU tensor it runs the plain
PyTorch version below, which performs the same arithmetic in the same
order.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.device import on_cpu

F32_MAX = 3.4028234663852886e38  # float32 max (the JAX literal 3.4028235e38 rounds to it)

# Packed per-triangle shading attribute layout (rows of the scene's
# wt_attr matrix; pallas_intersect.py:44-74). flatten (producer) and
# render/materials (consumer) both read it from here.
ATTR_N0 = slice(0, 3)
ATTR_N1 = slice(3, 6)
ATTR_N2 = slice(6, 9)
ATTR_GN = slice(9, 12)
ATTR_UV0 = slice(12, 14)
ATTR_UV1 = slice(14, 16)
ATTR_UV2 = slice(16, 18)
ATTR_HAS_UV = 18
ATTR_C0 = slice(19, 23)
ATTR_C1 = slice(23, 27)
ATTR_C2 = slice(27, 31)
ATTR_TAN = slice(31, 34)
ATTR_BIT = slice(34, 37)
ATTR_MAT_COLOR = slice(37, 41)
ATTR_MAT_EMISSION = slice(41, 44)
ATTR_MAT_SCATTERING = slice(44, 47)
ATTR_MAT_TYPE = 47
ATTR_MAT_ROUGHNESS = 48
ATTR_MAT_METALLIC = 49
ATTR_MAT_IOR = 50
ATTR_MAT_ANISO = 51
ATTR_MAT_TRDEPTH = 52
ATTR_MAT_TEX = slice(53, 58)
ATTR_DET_SIGN = 58
ATTR_MAT_ID = 59
ATTR_INST_ID = 60
ATTR_TRI_ID = 61
ATTR_WIDTH = 128  # padded to a lane multiple in the JAX layout

# Kernel launches per wrapper (counted only where a kernel is launched).
LAUNCHES = {"dense_closest_hit": 0, "dense_closest_hit_attrs": 0}

# The kernel's launch shape (csrc/dense_intersect.cu, whose constants these
# copy): threads per block, blocks per SM it is built for, groups of four
# triangles per shared-memory stage, attribute columns per tile chunk.
THREADS = 128
MIN_BLOCKS = 8
STAGE_GROUPS = 26
TILE_W = 32

# Rays per chunk of the plain version: bounds its (chunk, T) temporaries.
_PLAIN_PAIRS = 1 << 22


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def dense_numerators(R, W4):
    """det, nu, nv, nt (B, T): each a 10-term dot product summed in order
    k = 0..9 with separate multiply and add, exactly as the kernel does."""

    out = []
    for c in range(4):
        acc = R[:, 0:1] * W4[c, 0][None, :]
        for k in range(1, 10):
            acc = acc + R[:, k : k + 1] * W4[c, k][None, :]
        out.append(acc)
    return out


def dense_epilogue(det, nu, nv, nt, eps):
    """t/u/v and validity (pallas_intersect.py:102-107); a NaN fails
    `valid`. Returns (t with F32_MAX where invalid, u, v)."""

    d = 1.0 / det
    t = nt * d
    u = nu * d
    v = nv * d
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= eps)
    return torch.where(valid, t, F32_MAX), u, v


def dense_closest_hit_plain(W4, R, eps):
    """Plain version of B1: argmin over all triangles, first index on a
    tie (the Pallas kernel's per-block min index + strict cross-block <)."""

    B, T = R.shape[0], W4.shape[2]
    chunk = max(1, _PLAIN_PAIRS // max(T, 1))
    outs = []
    for s in range(0, max(B, 1), chunk):  # an empty batch: one empty chunk
        Rc = R[s : s + chunk]
        det, nu, nv, nt = dense_numerators(Rc, W4)
        tt, u, v = dense_epilogue(det, nu, nv, nt, eps)
        best = torch.argmin(tt, dim=1, keepdim=True)
        bt = tt.gather(1, best)[:, 0]
        hit = bt < F32_MAX

        def pick(x):
            return torch.where(hit, x.gather(1, best)[:, 0], 0.0)

        idx = torch.where(hit, best[:, 0], 0).to(torch.int32)
        outs.append((torch.where(hit, bt, F32_MAX), pick(u), pick(v),
                     pick(det), idx))
    return tuple(torch.cat(c) for c in zip(*outs))


def dense_closest_hit_attrs_plain(W4, A, R, eps):
    """Plain version of B2: B1 plus the winner's attribute row, (AW, B)."""

    t, u, v, det, idx = dense_closest_hit_plain(W4, R, eps)
    attr = torch.where((t < F32_MAX)[:, None], A[idx.long()], 0.0).T
    return t, u, v, det, idx, attr.contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(W4, R, A=None):
    if R.dim() != 2 or R.shape[1] != 10:
        raise ValueError(f"R must be (B, 10), got {tuple(R.shape)}")
    if W4.dim() != 3 or W4.shape[:2] != (4, 10):
        raise ValueError(f"W4 must be (4, 10, T), got {tuple(W4.shape)}")
    ts = (W4, R) if A is None else (W4, R, A)
    for x in ts:
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
        if x.device != R.device:
            raise ValueError("all inputs must be on one device")
    if A is not None and (A.dim() != 2 or A.shape[0] < W4.shape[2]):
        raise ValueError(f"A must be (>=T, AW), got {tuple(A.shape)}")


def smem_bytes(T: int, attrs: bool) -> int:
    """Dynamic shared memory of one block (csrc/dense_intersect.cu
    smem_bytes): a stage of min(ceil(T / 4), STAGE_GROUPS) groups of 640
    bytes, which B2's four warps reuse as their 32 x (TILE_W + 1) tiles."""

    stage = 640 * min(-(-T // 4), STAGE_GROUPS)
    tiles = 4 * (THREADS // 32) * 32 * (TILE_W + 1) if attrs else 0
    return max(stage, tiles)


def bind(lib):
    """Declares lupin_dense_closest_hit's signature on a loaded build of
    csrc/dense_intersect.cu, once: cuda_build.load calls it where it opens
    the library, the variant tools on their copies. Returns `lib`."""

    lib.lupin_dense_closest_hit.restype = ctypes.c_int
    lib.lupin_dense_closest_hit.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_void_p] * 7)
    return lib


def _launch(lib, table, R, eps, T, A=None):
    """One launch of `lupin_dense_closest_hit` from the loaded library `lib`
    (bound by `bind`) on the coefficient table `table` (pair_table(W4) for
    this checkout's kernel; a build of an earlier design takes what it
    reads, as tools/replay.py passes it). Returns (t, u, v, det, idx, attr
    or None)."""

    from . import cuda_build

    fn = lib.lupin_dense_closest_hit
    R = R.contiguous()
    B = R.shape[0]
    dev = R.device
    t, u, v, det = (torch.empty(B, dtype=torch.float32, device=dev)
                    for _ in range(4))
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    if A is not None:
        A = A.contiguous()
        aw = A.shape[1]
        if aw % 4 or A.data_ptr() % 16:
            raise ValueError("B2 reads attribute rows as 16-byte loads: A must "
                             f"be 16-byte aligned with a width divisible by 4, got {aw}")
        attr = torch.empty((aw, B), dtype=torch.float32, device=dev)
        a_ptr, attr_ptr = A.data_ptr(), attr.data_ptr()
    else:
        aw, attr, a_ptr, attr_ptr = 0, None, None, None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(R.data_ptr(), table.data_ptr(), a_ptr, B, T, aw, aw, float(eps),
                t.data_ptr(), u.data_ptr(), v.data_ptr(), det.data_ptr(),
                idx.data_ptr(), attr_ptr, stream)
    cuda_build.check(rc, "dense_closest_hit")
    return t, u, v, det, idx, attr


def _kernel(W4, R, eps, A=None):
    from . import cuda_build
    from .bvh import pair_table

    return _launch(cuda_build.load("dense_intersect", bind), pair_table(W4), R,
                   eps, W4.shape[2], A)


def dense_closest_hit(W4, R, eps):
    """B1: (t, u, v, det, idx) of the closest hit per ray."""

    _check(W4, R)
    if on_cpu(R):
        return dense_closest_hit_plain(W4, R, eps)
    out = _kernel(W4, R, eps)
    LAUNCHES["dense_closest_hit"] += 1
    return out[:5]


def dense_closest_hit_attrs(W4, A, R, eps):
    """B2: B1 plus the winner's packed attribute row, (ATTR_WIDTH, B). A may
    carry slack rows beyond W4's T triangles (flatten pads the soup)."""

    _check(W4, R, A)
    A = A[: W4.shape[2]]
    if on_cpu(R):
        return dense_closest_hit_attrs_plain(W4, A, R, eps)
    out = _kernel(W4, R, eps, A)
    LAUNCHES["dense_closest_hit_attrs"] += 1
    return out
