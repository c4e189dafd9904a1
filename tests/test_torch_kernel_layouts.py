"""PyTorch port: the host-side pieces of the redesigned kernels B6 and B3,
on the CPU.

- B6's position -> item lookup (kernels/bvh.py::pair_item_map, the search
  csrc/pair_intersect.cuh runs) against `_item_lanes`, the coverage the
  plain version and the earlier kernel use, on work items made by both
  packages' `_wf_work_items` from the same numpy-seeded keys: terrain-like
  (few superleaves, long segments), instanced-like (many superleaves of a
  few pairs, empty superleaves between them), the single-superleaf
  shortcut's items and an all-empty grid, with the lo == hi tail past
  n_items.
- B6's split of a launch with few tiles into (tile, triangle chunk) units
  (kernels/bvh.py::pair_split, the kernel's arithmetic): the chunks tile
  each superleaf, and the partial minima merged in chunk order with a
  strict < equal the whole scan on a terrain's first-round pairs.
- The pre-test both kernels run before the divide (csrc/tri_test.cuh), in
  numpy float32: on adversarial numerators (signed zeros, subnormals,
  infinities, NaNs, quotients that underflow, u + v within ulps of 1) it
  drops only triangles the reference epilogue rejects.
- B6's packed coefficient table (kernels/bvh.py::pair_table) and B3's
  packed tables (kernels/mega.py), unpacked back to the coefficient matrix
  and the light arrays, array-equal, and built once per scene.

Everything here is exact: no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lupinpathtracer_tpu.kernels import intersect as jint

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.io import builtin, synthetic
from lupinpathtracer_tpu_torch.kernels import bvh as tbvh
from lupinpathtracer_tpu_torch.kernels import intersect as tint
from lupinpathtracer_tpu_torch.kernels import mega
from lupinpathtracer_tpu_torch.tools import prof_pair

PB = 256


def _keys(kind, seed=0):
    """Superleaf-sorted keys of Q * Bp pair slots (empties keyed n_sl,
    last) and n_sl: `terrain` ~600 pairs in each of 40 superleaves;
    `instanced` ~6 pairs in each of 3,000, a third of them empty."""

    rng = np.random.default_rng(seed)
    if kind == "terrain":
        n_sl, counts = 40, rng.integers(1, 1200, 40)
    else:
        n_sl = 3000
        counts = rng.integers(1, 12, n_sl) * (rng.random(n_sl) > 0.33)
    P = -(-int(counts.sum() + 3000) // PB) * PB
    key = np.full(P, n_sl, np.int32)
    key[: counts.sum()] = np.repeat(np.arange(n_sl, dtype=np.int32), counts)
    return key, n_sl


def _items(kind):
    """(blk, lo, hi, n_items, P) of the case, the port's _wf_work_items
    checked array-equal against the JAX package's where they make them."""

    if kind in ("terrain", "instanced"):
        key, n_sl = _keys(kind)
        got = tint._wf_work_items(torch.from_numpy(key), n_sl, PB)
        ref = jint._wf_work_items(jnp.asarray(key), n_sl, PB)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        blk, _, lo, hi, n_real, n_items = got
        assert int(n_items) < blk.shape[0]  # a lo == hi tail past n_items
        assert bool((lo[int(n_items):] == hi[int(n_items):]).all())
        return blk, lo, hi, n_items, key.shape[0]
    P = 16 * PB
    blk = torch.arange(P // PB, dtype=torch.int32)
    lo = blk * PB
    hi = lo + PB if kind == "shortcut" else lo  # "empty": every item lo == hi
    return blk, lo, hi, None, P


@pytest.mark.parametrize("kind", ["terrain", "instanced", "shortcut", "empty"])
def test_pair_item_map_matches_item_lanes(kind):
    """Every covered position maps to the item `_item_lanes` gives it, and
    no other position maps to an item."""

    blk, lo, hi, n_items, P = _items(kind)
    item = tbvh.pair_item_map(blk, lo, hi, n_items, PB, P)
    pos, ref = tbvh._item_lanes(blk, lo, hi, n_items, PB, P)
    want = torch.full((P,), -1, dtype=torch.int64)
    want[pos] = ref
    assert torch.equal(item, want)
    if kind == "empty":
        assert not bool((item >= 0).any())
    else:
        assert int((item >= 0).sum()) == pos.numel() > 0


def test_pair_item_map_prefers_the_nonempty_item_among_equal_starts():
    """An empty item that starts where a non-empty one does (not made by
    _wf_work_items, but inside the kernel's contract) hides nothing."""

    blk = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    lo = torch.tensor([0, 100, 100, 300], dtype=torch.int32)
    hi = torch.tensor([100, 250, 100, 400], dtype=torch.int32)
    item = tbvh.pair_item_map(blk, lo, hi, None, PB, 2 * PB)
    pos, ref = tbvh._item_lanes(blk, lo, hi, None, PB, 2 * PB)
    want = torch.full((2 * PB,), -1, dtype=torch.int64)
    want[pos] = ref
    assert torch.equal(item, want) and int(item[120]) == 1


@pytest.mark.parametrize("SP", [4, 36, 64, 256, 4096])
def test_pair_split_tiles_each_superleaf(SP):
    """Chunks of at least 64 triangles (or the whole superleaf), multiples
    of 4, covering [0, SP) once, and never more units than the scratch."""

    cap = tbvh.PAIR_SPLIT_UNITS
    for n_tiles in (0, 1, 3, 35, 300, cap - 1, cap, 5000):
        ks, kc = tbvh.pair_split(SP, n_tiles)
        assert kc % 4 == 0 and kc >= min(tbvh.PAIR_SPLIT_MIN, SP)
        assert (ks - 1) * kc < SP <= ks * kc
        assert ks == 1 or ks * n_tiles <= cap
        if n_tiles >= cap or n_tiles == 0:
            assert ks == 1
    assert tbvh.pair_split(4096, 1) == (64, 64)
    assert tbvh.pair_split(4096, 100) == (40, 104)


def test_split_merge_equals_whole_scan():
    """The kernel's merge of a split tile, in PyTorch: the plain version on
    each chunk of every superleaf, merged in chunk order with a strict <,
    equals it on the whole superleaves, bit for bit."""

    scene, cams = synthetic.build_scene_terrain(n_tris=20_000, seed=0)
    ts = tl.build_scene_torch(scene, device="cpu")
    ro, rd = prof_pair.camera_rays(cams[0], 32, 18, "cpu")
    args, kw, _ = prof_pair.round1_state(ts, ro, rd)
    W = tint.scene_tri_matrix(ts)
    SP, eps = kw["SP"], 1e-3
    whole = tbvh.pair_intersect_plain(*args, W, eps, **kw)
    assert bool((whole[0] < tbvh.F32_MAX).any())
    ks, kc = tbvh.pair_split(SP, 1)
    assert ks > 1 and SP % kc == 0
    n_msl = W.shape[2] // SP
    best = None
    for c in range(ks):
        Wc = W.reshape(4, 10, n_msl, SP)[..., c * kc:(c + 1) * kc].reshape(4, 10, -1)
        t, u, v, det, li = tbvh.pair_intersect_plain(*args, Wc.contiguous(), eps,
                                                     **dict(kw, SP=kc))
        part = (t, u, v, det, li + c * kc)
        if best is None:
            best = list(part)
            continue
        win = t < best[0]
        best = [torch.where(win, p, b) for p, b in zip(part, best)]
    for a, b in zip(best, whole):
        assert torch.equal(a, b)


def _surely_invalid(det, nu, nv, nt):
    """numpy float32 mirror of surely_invalid (csrc/tri_test.cuh)."""

    u32 = np.uint32
    sd = det.view(u32) & u32(0x80000000)

    def flip(x):
        return (x.view(u32) ^ sd).view(np.float32)

    dn = np.abs(det)
    un, vn, tn = flip(nu), flip(nv), flip(nt)
    thr = dn * np.float32(2.0 ** -24)
    return (~(tn > 0) | (un < -thr) | (vn < -thr)
            | (un + vn > dn * np.float32(1.0 + 2.0 ** -16)))


def _near_edge(rng, n):
    """Numerators whose u + v lies within a few ulps of 1 (and u, v of 0),
    det from subnormal to huge, either sign."""

    f = np.float32
    det = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-44, 38, n)).astype(f)
    a = rng.random(n).astype(f)
    nu = (det * a).astype(f)
    nv = (det * (f(1) - a)).astype(f)
    for x in (nu, nv):
        k = rng.integers(-8, 9, n)
        x[:] = np.nextafter(x, np.where(k > 0, np.inf, -np.inf).astype(f))
        for _ in range(3):  # a few ulps more on some lanes
            m = rng.random(n) < 0.5
            x[m] = np.nextafter(x[m], np.where(k[m] > 0, np.inf, -np.inf).astype(f))
    nt = (det * rng.uniform(-0.1, 10.0, n)).astype(f)
    return np.stack([det, nu, nv, nt])


def test_sign_pretest_drops_only_invalid_triangles():
    """Every combination of adversarial numerators, and numerators on the
    edges of the valid region (u + v within ulps of 1): where the pre-test
    drops a triangle, the reference epilogue (d = 1/det; t, u, v = n * d;
    u >= 0, v >= 0, u + v <= 1, t >= eps) rejects it too; and it does drop
    most of a random sample's invalid triangles."""

    f = np.float32
    tiny = np.finfo(f).tiny
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, tiny, -tiny, 1e-30, -1e-30,
                     1e-20, -1e-20, 0.3, -0.3, 0.5, -0.5, 0.7, 1.0, -1.0, 3.0,
                     -3.0, 1e30, -1e30, 3.4e38, -3.4e38, np.inf, -np.inf,
                     np.nan], f)
    g = np.stack(np.meshgrid(vals, vals, vals, vals, indexing="ij"), 0).reshape(4, -1)
    rng = np.random.default_rng(3)
    wide = rng.normal(size=(4, 200_000)) * 10.0 ** rng.uniform(-40, 37, (4, 200_000))
    plain = rng.normal(size=(4, 200_000))  # numerators of a realistic scale
    with np.errstate(all="ignore"):
        edge = _near_edge(rng, 400_000)
    det, nu, nv, nt = np.concatenate(
        [g, edge, wide.astype(f), plain.astype(f)], axis=1)
    for eps in (f(1e-3), f(1e-4), f(tiny)):
        with np.errstate(all="ignore"):
            d = f(1.0) / det
            t, u, v = nt * d, nu * d, nv * d
            valid = (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= eps)
            rej = _surely_invalid(det, nu, nv, nt)
        assert not (rej & valid).any(), np.nonzero(rej & valid)[0][:5]
        tail = slice(-200_000, None)
        assert rej[tail].sum() > 0.95 * (~valid[tail]).sum()


@pytest.fixture(scope="module")
def cornell():
    scene = tl.build_scene_torch(builtin.build_scene_cornell_box()[0], device="cpu")
    assert not scene.use_bvh and scene.num_world_tris % 4 == 0
    return scene


@pytest.mark.parametrize("T", [36, 33])
def test_mega_tri_table_unpacks_to_w4(cornell, T):
    """B3's triangle table (bvh.pair_table of a (4, 10, T) matrix, T not
    always a multiple of 4): (ceil(T/4), 40, 4) groups back to (4, 10, T)
    equal; the padding triangles zero."""

    W4 = tint.scene_tri_matrix(cornell)[:, :, :T].contiguous()
    Wp = tbvh.pair_table(W4)
    assert Wp.shape == (-(-T // 4), 40, 4) and Wp.is_contiguous()
    flat = Wp.permute(1, 0, 2).reshape(40, -1)
    assert torch.equal(flat[:, :T].reshape(4, 10, T), W4)
    assert not bool(flat[:, T:].any())


def test_pair_table_unpacks_to_w4_and_is_kept():
    """(T/4, 40, 4) back to (4, 10, T): equal; the same tensor on the next
    call for the same matrix; rebuilt once the matrix is written."""

    scene, _ = synthetic.build_scene_instanced_field(20, seed=0, tris_per_mesh=64)
    W4 = tint.scene_tri_matrix(tl.build_scene_torch(scene, device="cpu")).clone()
    T = W4.shape[2]
    Wp = tbvh.pair_table(W4)
    assert Wp.shape == (T // 4, 40, 4) and Wp.is_contiguous()
    assert torch.equal(Wp.permute(1, 0, 2).reshape(4, 10, T), W4)
    assert tbvh.pair_table(W4) is Wp
    W4[0, 0, 5] += 1.0
    again = tbvh.pair_table(W4)
    assert again is not Wp and float(again[1, 0, 1]) == float(W4[0, 0, 5])


def test_mega_light_table_unpacks_to_light_arrays(cornell):
    lt = mega.pack_light_table(cornell)
    assert lt.shape == (cornell.lt_v0.shape[1], mega.LIGHT_COLS) and lt.is_contiguous()
    assert torch.equal(lt[:, 0:3].T, cornell.lt_v0)
    assert torch.equal(lt[:, 4:7].T, cornell.lt_e1)
    assert torch.equal(lt[:, 8:11].T, cornell.lt_e2)
    assert torch.equal(lt[:, 3], cornell.light_area[cornell.lt_light.long()])
    assert not bool(lt[:, [7, 11]].any())


def test_tables_built_once_per_scene(cornell):
    """The coefficient matrix and B3's packed tables are made once per
    scene (the triangle table once per matrix): later calls return the same
    tensors; another scene object (even of the same geometry) gets its
    own."""

    W = tint.scene_tri_matrix(cornell)
    assert tint.scene_tri_matrix(cornell) is W
    assert torch.equal(W, tint.build_tri_matrix(cornell.wt_v0[:, :cornell.num_world_tris],
                                                cornell.wt_e1[:, :cornell.num_world_tris],
                                                cornell.wt_e2[:, :cornell.num_world_tris]))
    a = (tbvh.pair_table(W), mega._light_table(cornell))
    b = (tbvh.pair_table(tint.scene_tri_matrix(cornell)), mega._light_table(cornell))
    assert a[0] is b[0] and a[1] is b[1]
    other = tl.build_scene_torch(builtin.build_scene_cornell_box()[0], device="cpu")
    assert tint.scene_tri_matrix(other) is not W
