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
- The packed top rows of B4 and B5 (kernels/bvh.py::top_rows) decoded back
  to the top table's boxes, slot markers and child references on a
  terrain, an instanced field and the Cornell box above the dense gate,
  and kept on the table.
- B5's comparator network as the kernel runs it (csrc/bvh.cu: six layers
  of disjoint compare-exchanges between the lanes of a ray) against the
  19 comparators in their order (kernels/bvh.py::SORT_NET), on ties,
  misses and random keys.
- The edits the profiling tools make to copies of csrc/packet.cu,
  csrc/bvh.cu and csrc/mega.cu (tools/prof_packet.py, tools/prof_top.py,
  tools/prof_mega.py) each find their text in the sources once, and their
  reading of ptxas's register and spill report.
- The packet kernel's constants copied in kernels/packet.py equal
  csrc/packet.cu's; B1/B2's (kernels/dense_intersect.py) and B7's tile
  (kernels/bvh.py ATTR_TILE) equal csrc/dense_intersect.cu's and
  csrc/bvh.cu's, and B2's shared memory leaves the registers to set its
  occupancy.
- B7's lookup (the same search as B6's) on the work items
  intersect._attr_fetch_args makes for a terrain's, an instanced field's
  and an all-miss batch's winners (misses keyed n_sl, the lo == hi tail)
  against `_item_lanes`.
- B2's attribute phase as the kernel tiles it (warps of 32 rays, chunks of
  TILE_W columns read as quarter rows, four rays per warp load, a padded
  tile), emulated in PyTorch, equals A[idx].T with zeros on misses, and
  its tile accesses are free of bank conflicts.
- The launch recorder of the replay tools (tools/replay.record_launches)
  on a small render on the CPU: every call recorded, tensor arguments
  copied, the scene's tables shared.

Everything here is exact: no tolerance."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lupinpathtracer_tpu.kernels import intersect as jint

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.io import builtin, synthetic
from lupinpathtracer_tpu_torch.kernels import bvh as tbvh
from lupinpathtracer_tpu_torch.kernels import intersect as tint
from lupinpathtracer_tpu_torch.kernels import cuda_build, mega
from lupinpathtracer_tpu_torch.kernels import packet as tpacket
from lupinpathtracer_tpu_torch.kernels import dense_intersect as tdk
from lupinpathtracer_tpu_torch.tools import (
    prof_dense, prof_mega, prof_packet, prof_pair, prof_top, replay)

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


def _top_scenes():
    terrain, _ = synthetic.build_scene_terrain(n_tris=20_000, seed=0)
    field, _ = synthetic.build_scene_instanced_field(300, seed=0, tris_per_mesh=64)
    box, _ = builtin.build_scene_cornell_box()
    return {"terrain": tl.build_scene_torch(terrain, device="cpu"),
            "field": tl.build_scene_torch(field, device="cpu"),
            "cornell_above_gate": tl.build_scene_torch(box, device="cpu",
                                                       dense_max_tris=16)}


@pytest.fixture(scope="module")
def top_scenes():
    return _top_scenes()


@pytest.mark.parametrize("name", ["terrain", "field", "cornell_above_gate"])
def test_top_rows_decode_to_top_tab(top_scenes, name):
    """geo (rows, 8, 8) holds each slot's lo, hi and marker as the table
    stores them, then a zero; refs (rows, 8) the reference the three fields
    H2, HI8, LO8 spell (decoded here in float64) shifted left by one, with
    the leaf bit where the marker is 1."""

    scene = top_scenes[name]
    assert scene.use_bvh
    tab = scene.top_tab.double().numpy().reshape(-1, 8, 10)
    geo, refs = tbvh.top_rows(scene.top_tab)
    assert geo.shape == (tab.shape[0], 8, 8) and geo.dtype == torch.float32
    assert refs.shape == (tab.shape[0], 8) and refs.dtype == torch.int32
    assert geo.is_contiguous() and refs.is_contiguous()
    g = geo.double().numpy()
    np.testing.assert_array_equal(g[:, :, 0:3], tab[:, :, 0:3])
    np.testing.assert_array_equal(g[:, :, 3:6], tab[:, :, 3:6])
    np.testing.assert_array_equal(g[:, :, 6], tab[:, :, 6])
    assert not g[:, :, 7].any()
    r = refs.numpy().astype(np.int64)
    spelled = tab[:, :, 7] * 65536 + tab[:, :, 8] * 256 + tab[:, :, 9]
    np.testing.assert_array_equal(r >> 1, spelled.astype(np.int64))
    np.testing.assert_array_equal(r & 1, (tab[:, :, 6] == 1.0).astype(np.int64))
    assert set(np.unique(tab[:, :, 6])) <= {-1.0, 0.0, 1.0}
    if not scene.top_root_is_leaf:
        leaf = tab[:, :, 6] == 1.0
        assert leaf.any() and (r[leaf] >> 1).max() < scene.sl_count
        assert (r[tab[:, :, 6] == 0.0] >> 1).max() < tab.shape[0]


def test_top_rows_are_kept_on_the_table(top_scenes):
    """The same tensors on every call for the scene's table (the wavefront
    passes scene.top_tab to B5 each round, B4 reads them each launch); a
    table written since gets new ones."""

    scene = top_scenes["terrain"]
    geo, refs = tbvh.top_rows(scene.top_tab)
    again = tbvh.top_rows(scene.top_tab)
    assert again[0] is geo and again[1] is refs
    assert again[0].data_ptr() == geo.data_ptr()
    tab = scene.top_tab.clone()
    first = tbvh.top_rows(tab)
    assert first[0] is not geo and torch.equal(first[0], geo)
    tab[0, 0] = tab[0, 0] - 1.0
    rebuilt = tbvh.top_rows(tab)
    assert rebuilt[0] is not first[0]
    assert float(rebuilt[0][0, 0, 0]) == float(tab[0, 0])


def _network_layers(t, r):
    """csrc/bvh.cu's six layers on (n, 8) keys and refs: lane c trades with
    its partner p, the lower slot keeping the smaller key, swapping only on
    a strict >."""

    c = np.arange(8)
    partners = [c ^ 1, c ^ 2, np.where(np.isin(c, [1, 2, 5, 6]), c ^ 3, c), c ^ 4,
                np.where((c >= 2) & (c <= 5), c ^ 6, c),
                np.where((c >= 1) & (c <= 6), ((c - 1) ^ 1) + 1, c)]
    t, r = t.copy(), r.copy()
    for p in partners:
        tp, rp = t[:, p], r[:, p]
        swap = np.where(c < p, t > tp, (c > p) & (tp > t))
        t, r = np.where(swap, tp, t), np.where(swap, rp, r)
    return t, r


def test_b5_network_layers_equal_the_comparators():
    rng = np.random.default_rng(5)
    n = 20_000
    t = rng.choice(np.float32([0.5, 1.0, 2.0, 3e38]), (n, 8))  # many ties
    t[: n // 2] = rng.random((n // 2, 8)).astype(np.float32)
    t[n // 4: n // 2, 2:6] = np.float32(3.4028235e38)  # misses
    r = rng.integers(-700, 700, (n, 8))
    lt, lr = _network_layers(t, r)
    st, sr = t.copy(), r.copy()
    for a, b in tbvh.SORT_NET:
        swap = st[:, a] > st[:, b]
        st[:, [a, b]] = np.where(swap[:, None], st[:, [b, a]], st[:, [a, b]])
        sr[:, [a, b]] = np.where(swap[:, None], sr[:, [b, a]], sr[:, [a, b]])
    np.testing.assert_array_equal(lt, st)
    np.testing.assert_array_equal(lr, sr)
    assert (np.diff(st, axis=1) >= 0).all()


@pytest.mark.parametrize("name,variants", [("packet", prof_packet.VARIANTS),
                                           ("bvh", prof_top.SHAPES),
                                           ("mega", prof_mega.VARIANTS),
                                           ("dense_intersect", prof_dense.VARIANTS)])
def test_profiling_copies_find_their_edits(name, variants):
    with open(f"{cuda_build.CSRC}/{name}.cu") as f:
        src = f.read()
    for edits in variants.values():
        for old, new in edits:
            assert src.count(old) == 1 and old != new


def test_packet_constants_are_the_kernel_source():
    """The packet kernel's constants that the wrapper, the plain version's
    union counts and the route's gate copy (kernels/packet.py) are those of
    csrc/packet.cu; a packet is a warp (full-mask ballots of 32 lanes)."""

    with open(f"{cuda_build.CSRC}/packet.cu") as f:
        src = f.read()
    const = {k: int(v, 0) for k, v in re.findall(
        r"constexpr (?:int|unsigned) (\w+) = (\w+?)u?;", src)}
    assert const["PK_STACK"] == tpacket.PACKET_STACK_MAX
    assert const["PK_SPLIT"] == tpacket.PACKET_SPLIT
    assert const["PK_SPLIT_CHUNK"] == tpacket.PACKET_SPLIT_CHUNK
    assert bin(const["FULL"]).count("1") == tpacket.PACKET_LANES


def test_ptxas_usage_reads_each_entry_function():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4lupin1kILb1EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN4lupin1kILb1EEEvv
    16 bytes stack frame, 36 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 64 registers, 528 bytes cmem[0]
ptxas info    : Function properties for _ZN4lupin6helperEv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN4lupin1kILb0EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN4lupin1kILb0EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 528 bytes cmem[0]
"""
    assert prof_pair.ptxas_usage(log) == {"_ZN4lupin1kILb1EEEvv": (64, 36),
                                          "_ZN4lupin1kILb0EEEvv": (40, 0)}
    mega_log = log.replace("1kILb", "11mega_kernelILb")
    assert prof_mega.usage(mega_log) == {"smem": (64, 36), "global": (40, 0)}


def _kernel_constants(name):
    with open(f"{cuda_build.CSRC}/{name}.cu") as f:
        src = f.read()
    return {k: int(v, 0) for k, v in re.findall(
        r"constexpr (?:int|unsigned) (\w+) = (\w+?)u?;", src)}


def test_dense_constants_are_the_kernel_source():
    """B1/B2's launch shape copied in kernels/dense_intersect.py is
    csrc/dense_intersect.cu's; smem_bytes is its shared memory (a stage of
    min(Tg, STAGE_GROUPS) 640-byte groups, B2's four warp tiles of
    32 x (TILE_W + 1) floats reusing it), and at any T the dense gate
    admits MIN_BLOCKS blocks of it (plus the 1 KB the card reserves per
    block) fit an SM's 228 KB: the registers, not shared memory, set the
    kernel's occupancy (MIN_BLOCKS x 4 warps)."""

    const = _kernel_constants("dense_intersect")
    assert const["THREADS"] == tdk.THREADS
    assert const["MIN_BLOCKS"] == tdk.MIN_BLOCKS
    assert const["STAGE_GROUPS"] == tdk.STAGE_GROUPS
    assert const["TILE_W"] == tdk.TILE_W
    assert 65536 // (tdk.MIN_BLOCKS * tdk.THREADS) >= 64  # registers a thread
    tile = 4 * 32 * (tdk.TILE_W + 1) * (tdk.THREADS // 32)
    for T in (1, 36, 37, 103, 104, 105, 556, 2048):
        stage = 640 * min(-(-T // 4), tdk.STAGE_GROUPS)
        assert tdk.smem_bytes(T, False) == stage
        assert tdk.smem_bytes(T, True) == max(stage, tile)
        assert tdk.MIN_BLOCKS * (tdk.smem_bytes(T, True) + 1024) <= 228 * 1024
    assert tdk.smem_bytes(36, False) == 5760 and tdk.smem_bytes(36, True) == 16896


def test_attr_tile_is_the_kernel_source():
    assert _kernel_constants("bvh")["AT_TILE"] == tbvh.ATTR_TILE


@pytest.mark.parametrize("name", ["terrain", "field", "all_miss"])
def test_attr_item_map_matches_item_lanes(top_scenes, name):
    """The items _attr_fetch_args builds for B7 (winners sorted by
    superleaf, misses keyed n_sl and sorted last, the lo == hi tail past
    n_items): every covered position maps to the item `_item_lanes` gives
    it, exactly the winners are covered, and nothing else maps."""

    scene = top_scenes["terrain" if name == "all_miss" else name]
    rng = np.random.default_rng(7)
    B = 3000  # not a multiple of the pair block: padded positions
    n_tris = scene.sl_count * scene.sl_stride
    hit = torch.tensor(rng.random(B) < (0.0 if name == "all_miss" else 0.7))
    tri = torch.tensor(rng.integers(0, n_tris, B), dtype=torch.int32)
    z = torch.zeros(B)
    h = tint.HitInfo(hit=hit, dst=torch.where(hit, 1.0, tint.F32_MAX), u=z, v=z,
                     tri=tri, backside=hit & False)
    args, kw, order, hitm = tint._attr_fetch_args(scene, h)
    blk, _, lo, hi, li = args[:5]
    n_items, PB, P = kw["n_items"], kw["pair_block"], li.shape[0]
    assert P % PB == 0 and P >= B
    assert int(n_items) < blk.shape[0]
    assert bool((lo[int(n_items):] == hi[int(n_items):]).all())
    item = tbvh.pair_item_map(blk, lo, hi, n_items, PB, P)
    pos, ref = tbvh._item_lanes(blk, lo, hi, n_items, PB, P)
    want = torch.full((P,), -1, dtype=torch.int64)
    want[pos] = ref
    assert torch.equal(item, want)
    assert torch.equal(item >= 0, hitm[order])
    assert int((item >= 0).sum()) == int(hit.sum())


def _emulate_b2_tiles(A, idx, hit, B, tile_w=tdk.TILE_W):
    """csrc/dense_intersect.cu's attribute phase in PyTorch: per warp of 32
    rays and chunk of tile_w columns, lane l reads the four columns
    4 (l % 8) of ray j + l // 8 of its warp (j = 0, 4, ..., 28) into a
    32 x (tile_w + 1) tile, zeros for a miss or a lane past B; then lane l
    writes column c of ray l. Returns (attr (aw, B), the tile's bank of each
    write and read, per warp instruction)."""

    aw = A.shape[1]
    out = torch.full((aw, B), float("nan"))
    row = torch.where(hit, idx.long(), -1)
    lane = torch.arange(32)
    sub, col = lane // 8, 4 * (lane % 8)
    banks = []
    for ray0 in range(0, B, 32):
        rows = torch.full((32,), -1, dtype=torch.int64)
        n = min(32, B - ray0)
        rows[:n] = row[ray0:ray0 + n]
        for c0 in range(0, aw, tile_w):
            tile = torch.full((32 * (tile_w + 1),), float("nan"))
            for j in range(0, 32, 4):
                rw = rows[j + sub]  # the shuffle from lane j + sub
                for e in range(4):
                    ok = (rw >= 0) & (c0 + col + e < aw)
                    x = torch.where(ok, A[rw.clamp_min(0), (c0 + col + e).clamp_max(aw - 1)], 0.0)
                    at = (j + sub) * (tile_w + 1) + col + e
                    tile[at] = x
                    banks.append(at % 32)
            for c in range(min(tile_w, aw - c0)):
                at = lane * (tile_w + 1) + c
                banks.append(at % 32)
                out[c0 + c, ray0:ray0 + n] = tile[at][:n]
    return out, banks


@pytest.mark.parametrize("aw", [128, 36])
@pytest.mark.parametrize("B", [1, 31, 33, 100])
def test_b2_attribute_tiles_equal_the_gather(B, aw):
    rng = np.random.default_rng(B)
    T = 37
    A = torch.tensor(rng.normal(size=(T, aw)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, T, B), dtype=torch.int32)
    hit = torch.tensor(rng.random(B) < 0.8)
    out, banks = _emulate_b2_tiles(A, idx, hit, B)
    want = torch.where(hit[:, None], A[idx.long()], 0.0).T
    assert torch.equal(out, want)
    # Each warp instruction's 32 lanes hit 32 distinct banks.
    assert all(len(set(b.tolist())) == 32 for b in banks)


def test_record_launches_copies_arguments_and_shares_tables():
    """record_launches on B2 over one accumulation of a small DIRECT render
    of the Cornell box on the CPU: every call recorded, each replayed call
    equal to what the render got, R cloned, W4 and the attribute table
    shared; the wrapper restored after the run."""

    from lupinpathtracer_tpu_torch.core.types import PathtraceDesc, PathtraceType

    box, cams = builtin.build_scene_cornell_box()
    scene = tl.build_scene_torch(box, device="cpu")
    desc = PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.pathtrace_type = PathtraceType.DIRECT
    seen = []
    real = tdk.dense_closest_hit_attrs

    def spy(*a):
        out = real(*a)
        seen.append((a[2], out))
        return out

    tdk.dense_closest_hit_attrs = spy
    try:
        rec = replay.record_launches(
            tdk, "dense_closest_hit_attrs",
            replay.one_accumulation(scene, desc, 16, 12, 2, 3), share=(0, 1))
    finally:
        tdk.dense_closest_hit_attrs = real
    assert tdk.dense_closest_hit_attrs is real
    assert len(rec) == len(seen) > 0
    for (a, kw), (R, out) in zip(rec, seen):
        assert kw == {}
        assert a[0] is tint.scene_tri_matrix(scene) and a[1] is scene.wt_attr
        assert a[2] is not R and torch.equal(a[2], R)
        for x, y in zip(tdk.dense_closest_hit_attrs(*a), out):
            assert torch.equal(x, y)
