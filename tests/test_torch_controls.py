"""PyTorch port, the traversal controls: the JAX package's route switches,
the constants that replaced its other switches, B4's per-lane exactness
and the port's dispatch self-bound.

- _use_packet agrees with JAX's over LUPIN_NO_PACKET x LUPIN_FORCE_PACKET
  x coherent; a render under LUPIN_FORCE_PACKET (B4 on bounce batches)
  matches JAX's;
- the eight retired switches change nothing: a render with one of them set
  is bit-identical to one without and stays one dispatch;
- B4's plain version is exact per lane: a permutation of the rays permutes
  its results bit for bit;
- the wavefront's round sizes (WF_Q, WF_Q_TAIL, WF_TAIL_C) change its
  rounds, not its result, and one setting matches the JAX wavefront under
  the same sizes (its environment variables);
- packet_eligible has no TPU memory budget, and keeps the int32 id guard
  and PACKET_MAX_GSL as JAX's does;
- the self-bound: a frame the working-set rule splits tiles as the JAX
  package's rule does; by default a CPU frame is one dispatch.

Scenes and rays are tests/test_torch_bvh.py's (the ~1.5k-triangle sphere
scene and the 2048-triangle terrain). Tolerances are that file's: hit flags
equal, t within rtol 5e-4 / atol 1e-5 and the winning triangle equal on
>= 95% of hits where two implementations meet (tests/test_wavefront.py:
124-134); within the port, results equal bit for bit, the winning triangle
except at exact-t ties; renders as tests/test_render.py holds two routes:
< 2% of pixels more than 1e-3 apart."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lupinpathtracer_tpu as jl
from lupinpathtracer_tpu.core import vec3 as jv3
from lupinpathtracer_tpu.io import synthetic as jsyn
from lupinpathtracer_tpu.kernels import intersect as jint
from lupinpathtracer_tpu.render import renderer as jrenderer
from lupinpathtracer_tpu.scene.flatten import build_scene_tpu

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core import vec3 as tv3
from lupinpathtracer_tpu_torch.io import synthetic as tsyn
from lupinpathtracer_tpu_torch.kernels import bvh as tbvh
from lupinpathtracer_tpu_torch.kernels import intersect as tint
from lupinpathtracer_tpu_torch.kernels import packet as tpk
from lupinpathtracer_tpu_torch.render import renderer as trenderer

from test_torch_bvh import EPS, T, both, rays

# The port's route switches, then the retired ones (read by the JAX
# package, which some tests here set for its side).
SWITCHES = ("LUPIN_NO_PACKET", "LUPIN_FORCE_PACKET", "LUPIN_SPP_STREAMS")
RETIRED = ("LUPIN_PACKET_RAYSORT", "LUPIN_PACKET_MAX_GSL", "LUPIN_WF_Q",
           "LUPIN_WF_Q_DIV", "LUPIN_WF_Q_TAIL", "LUPIN_WF_TAIL_C",
           "LUPIN_DISPATCH_RAY_STRIDE_BUDGET", "LUPIN_DISPATCH_TILE_FLOOR")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Each test starts with no switch set, on one PyTorch thread (the
    suite runs in several worker processes at once)."""

    for name in SWITCHES + RETIRED:
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    return {name: both(name) for name in ("spheres", "terrain")}


def _active(B, seed):
    return np.random.default_rng(seed).random(B) < 0.7


@pytest.mark.parametrize("no_packet,force_packet",
                         list(itertools.product([None, "0", "1"], repeat=2)))
def test_use_packet_matches_jax(scenes, no_packet, force_packet, monkeypatch):
    """_use_packet against JAX _use_packet over LUPIN_NO_PACKET x
    LUPIN_FORCE_PACKET in {unset, "0", "1"} x coherent, on both scenes."""

    for name, val in (("LUPIN_NO_PACKET", no_packet),
                      ("LUPIN_FORCE_PACKET", force_packet)):
        if val is not None:
            monkeypatch.setenv(name, val)
    for tpu, ts, _ in scenes.values():
        for coherent in (True, False):
            want = jint._use_packet(tpu, coherent)
            assert tint._use_packet(ts, coherent) == want
            assert want == (no_packet != "1" and (coherent or force_packet == "1"))


def _terrain_desc(pkg, cams):
    desc = pkg.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.pathtrace_type = pkg.PathtraceType.NAIVE
    desc.advanced.max_radiance = 10.0
    return desc


def test_force_packet_render_matches_jax(monkeypatch):
    """A 16x16 NAIVE render of the small terrain under LUPIN_FORCE_PACKET=1:
    the port sends its bounce batches to B4 (with the winners' attributes
    fused) and matches the JAX render under the same variable, and its own
    default route. JAX reads the variable at trace time, so its jit caches
    are cleared around it (its CPU route for a single-level scene is the
    stack walk, which the variable leaves as it is)."""

    js, jc = jsyn.build_scene_terrain(n_tris=2048)
    tsc, tc = tsyn.build_scene_terrain(n_tris=2048)
    tpu = build_scene_tpu(js)
    ts = tl.build_scene_torch(tsc, device="cpu")
    baked = dict(max_bounces=2, samples_per_pixel=1)
    calls = []
    real = tpk.packet_traverse
    monkeypatch.setattr(tpk, "packet_traverse",
                        lambda *a, **k: calls.append(a[1].x.shape[0]) or real(*a, **k))

    def port():
        calls.clear()
        return tl.render_progressive(ts, _terrain_desc(tl, tc),
                                     tl.BakedPathtraceParams(**baked), 16, 16, 1,
                                     device="cpu")

    default = port()
    n_default = len(calls)
    monkeypatch.setenv("LUPIN_FORCE_PACKET", "1")
    forced = port()
    assert n_default == 1 and len(calls) > n_default  # the bounces took B4
    jax.clear_caches()
    try:
        jimg = np.asarray(jrenderer.render_progressive(
            tpu, _terrain_desc(jl, jc), jl.BakedPathtraceParams(**baked), 16, 16, 1))
    finally:
        jax.clear_caches()
    assert np.isfinite(forced).all() and forced.mean() > 0
    assert (np.abs(forced - jimg) > 1e-3).mean() < 0.02
    assert (np.abs(forced - default) > 1e-3).mean() < 0.02


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


# Each retired switch with what once let it act on a 16x16 frame, set on
# both sides: B4 on every batch for its coherence sort and its superleaf
# envelope, the sort wavefront on every batch for its round sizes, and each
# of the two dispatch variables for the other. The values are those that
# once changed the route, the tiles or the rounds, or raised.
FORCE, NO_PACKET = {"LUPIN_FORCE_PACKET": "1"}, {"LUPIN_NO_PACKET": "1"}
RETIRED_CASES = [
    ("LUPIN_PACKET_RAYSORT", "1", FORCE),
    ("LUPIN_PACKET_MAX_GSL", "0", FORCE),
    ("LUPIN_WF_Q", "eight", NO_PACKET),
    ("LUPIN_WF_Q_DIV", "0", NO_PACKET),
    ("LUPIN_WF_Q_TAIL", "-1", NO_PACKET),
    ("LUPIN_WF_TAIL_C", "1.5", NO_PACKET),
    ("LUPIN_DISPATCH_RAY_STRIDE_BUDGET", "1", {"LUPIN_DISPATCH_TILE_FLOOR": "8"}),
    ("LUPIN_DISPATCH_TILE_FLOOR", "8", {"LUPIN_DISPATCH_RAY_STRIDE_BUDGET": "1"}),
]


@pytest.fixture(scope="module")
def terrain_render():
    """The small terrain (a top tree over 12 superleaves, which B4 and the
    wavefront's rounds walk) and a 16x16, 1-spp, 2-bounce NAIVE render of
    it on CPU tensors."""

    tsc, tc = tsyn.build_scene_terrain(n_tris=2048)
    ts = tl.build_scene_torch(tsc, device="cpu")
    assert not ts.top_root_is_leaf and tint.packet_eligible(ts)
    desc = _terrain_desc(tl, tc)
    baked = tl.BakedPathtraceParams(max_bounces=2, samples_per_pixel=1)
    return lambda: tl.render_progressive(ts, desc, baked, 16, 16, 1, device="cpu")


@pytest.mark.parametrize("name,value,context", RETIRED_CASES,
                         ids=[c[0] for c in RETIRED_CASES])
def test_retired_switch_changes_nothing(terrain_render, name, value, context,
                                        monkeypatch):
    """A render with a retired switch set is bit-identical to one without
    it, with what once let it act set on both sides, and is one dispatch:
    the port reads the variable nowhere."""

    for k, v in context.items():
        monkeypatch.setenv(k, v)
    dispatches = _count(monkeypatch, trenderer, "_render_pathtrace")
    packets = _count(monkeypatch, tpk, "packet_traverse")
    want = terrain_render()
    n_packets = len(packets)
    monkeypatch.setenv(name, value)
    got = terrain_render()
    assert dispatches == [1, 1]
    assert len(packets) == 2 * n_packets
    assert (n_packets > 1) == (context is FORCE)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("with_attrs", [False, True])
@pytest.mark.parametrize("name", ["spheres", "terrain"])
def test_packet_traverse_is_lane_independent(scenes, name, with_attrs):
    """B4's plain version on a seeded permutation of 2,048 rays and their
    active mask returns the permuted results of the unpermuted call, bit
    for bit, attribute rows included: each lane's result is its own walk's,
    whatever the other lanes of its packet."""

    _, ts, span = scenes[name]
    _, (tro, trd) = rays(2048, span, seed=9)
    W = tint.scene_tri_matrix(ts)
    act = T(_active(2048, 2))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(2048))
    ref = tpk.packet_traverse_plain(ts, tro, trd, EPS, W, active=act,
                                    with_attrs=with_attrs)
    got = tpk.packet_traverse_plain(
        ts, tv3.V3(*(c[perm] for c in tro)), tv3.V3(*(c[perm] for c in trd)),
        EPS, W, active=act[perm], with_attrs=with_attrs)
    assert len(ref) == len(got) == (6 if with_attrs else 5)
    for x, y in zip(ref, got):
        assert torch.equal(x[..., perm], y)
    hit = ref[0] < 1e30
    assert hit.any() and (~hit).any() and not hit[~act].any()


WF_SETTINGS = list(itertools.product([1, 8], [1, 32], [16, 2048]))


@pytest.fixture(scope="module")
def wf_case(scenes):
    """2100 terrain rays (two 2048-lane blocks: full rounds, then the
    compacted tail) with an active mask, and the default wavefront's hits."""

    tpu, ts, span = scenes["terrain"]
    j, t = rays(2100, span, seed=13)
    act = _active(2100, 14)
    ref = tint.closest_hit_wavefront(ts, *t, EPS, active=T(act), coherent=False)
    return tpu, ts, j, t, act, ref


@pytest.mark.parametrize("q,q_tail,tail_c", WF_SETTINGS)
def test_wavefront_switches_keep_the_result(wf_case, q, q_tail, tail_c,
                                            monkeypatch):
    """The wavefront with WF_Q in {1, 8}, WF_Q_TAIL in {1, 32} and WF_TAIL_C
    in {16, 2048}, on coherent batches (LUPIN_NO_PACKET keeping them off
    B4) and bounce batches: t equal to the default's on every lane, the
    triangle except at exact-t ties, the same rounds (host syncs) for
    both, and more of them where WF_Q and WF_Q_TAIL are 1."""

    tpu, ts, _, (tro, trd), act, ref = wf_case
    defaults = dict(WF_Q=tint.WF_Q, WF_Q_TAIL=tint.WF_Q_TAIL)
    monkeypatch.setattr(tint, "WF_Q", q)
    monkeypatch.setattr(tint, "WF_Q_TAIL", q_tail)
    monkeypatch.setattr(tint, "WF_TAIL_C", tail_c)
    monkeypatch.setenv("LUPIN_NO_PACKET", "1")
    syncs = []
    for coherent in (True, False):
        tint.HOST_SYNCS["wavefront"] = 0
        h = tint.closest_hit_wavefront(ts, tro, trd, EPS, active=T(act),
                                       coherent=coherent)
        syncs.append(tint.HOST_SYNCS["wavefront"])
        assert torch.equal(h.dst, ref.dst) and torch.equal(h.hit, ref.hit)
        tie = h.tri != ref.tri
        assert (h.dst[tie] == ref.dst[tie]).all() and tie.float().mean() <= 0.01
    assert syncs[0] == syncs[1]
    if (q, q_tail) == (1, 1):
        tint.HOST_SYNCS["wavefront"] = 0
        for k, v in defaults.items():
            monkeypatch.setattr(tint, k, v)
        tint.closest_hit_wavefront(ts, tro, trd, EPS, active=T(act), coherent=False)
        assert tint.HOST_SYNCS["wavefront"] < syncs[1]


def test_wavefront_switches_match_jax(wf_case, monkeypatch):
    """One setting (Q 2, Q_TAIL 4, C 256; the JAX kernels' blocks need a
    capacity of whole 128-lane rows) in both packages, the port's constants
    and the JAX package's variables: the port against the JAX sort
    wavefront (its Pallas kernels in interpret mode) on 300 of the rays."""

    tpu, ts, (jro, jrd), (tro, trd), act, _ = wf_case
    n = 300
    for name, val in (("LUPIN_WF_Q_DIV", "2"), ("LUPIN_WF_Q_TAIL", "4"),
                      ("LUPIN_WF_TAIL_C", "256")):
        monkeypatch.setenv(name, val)
    monkeypatch.setattr(tint, "WF_Q", 2)
    monkeypatch.setattr(tint, "WF_Q_TAIL", 4)
    monkeypatch.setattr(tint, "WF_TAIL_C", 256)

    def cut(v, V):
        return V(*(c[:n] for c in (v.x, v.y, v.z)))

    jw = jint.closest_hit_wavefront(tpu, cut(jro, jv3.V3), cut(jrd, jv3.V3), EPS,
                                    active=jnp.asarray(act[:n]), coherent=False)
    h = tint.closest_hit_wavefront(ts, cut(tro, tv3.V3), cut(trd, tv3.V3), EPS,
                                   active=T(act[:n]), coherent=False)
    hit = np.asarray(jw.hit)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(h.hit.numpy(), hit)
    np.testing.assert_allclose(h.dst.numpy()[hit], np.asarray(jw.dst)[hit],
                               rtol=5e-4, atol=1e-5)
    assert (h.tri.numpy() == np.asarray(jw.tri))[hit].mean() >= 0.95


def test_packet_gate_has_no_tpu_budget(scenes, monkeypatch):
    """A top table of more than 23,437 rows (the JAX package's VMEM budget
    for the lane-padded table) keeps B4 in the port and loses it in JAX;
    the int32 id guard and the superleaf envelope (the port's
    PACKET_MAX_GSL, the JAX package's variable) gate both packages alike,
    with 0 turning B4 off."""

    tpu, ts, _ = scenes["terrain"]
    assert tint.packet_eligible(ts) and jint.packet_eligible(tpu)
    rows = 23_438
    monkeypatch.setattr(ts, "top_tab", torch.zeros((rows, ts.top_tab.shape[1])))
    jbig = tpu.replace(top_tab=jnp.zeros((rows, tpu.top_tab.shape[1]), jnp.float32))
    assert tint.packet_eligible(ts) and not jint.packet_eligible(jbig)
    n = ts.sl_count
    default = tint.PACKET_MAX_GSL
    for val, want in ((n, True), (n - 1, False), (0, False)):
        monkeypatch.setenv("LUPIN_PACKET_MAX_GSL", str(val))
        monkeypatch.setattr(tint, "PACKET_MAX_GSL", val)
        assert tint.packet_eligible(ts) == jint.packet_eligible(tpu) == want
    monkeypatch.delenv("LUPIN_PACKET_MAX_GSL")
    monkeypatch.setattr(tint, "PACKET_MAX_GSL", default)
    # The smallest stride (a multiple of 512, as the builder's) at which
    # the last superleaf's triangle ids pass 2**31 - 1.
    stride = -(-((2**31 - 1) // n + 1) // 512) * 512
    monkeypatch.setitem(ts.statics, "sl_stride", stride)
    assert not tint.packet_eligible(ts)
    assert not jint.packet_eligible(tpu.replace(sl_stride=stride))
    monkeypatch.setitem(ts.statics, "sl_stride", stride - 512)
    assert tint.packet_eligible(ts)


def _cornell_bvh():
    from lupinpathtracer_tpu.io import builtin as jbuiltin
    from lupinpathtracer_tpu_torch.io import builtin as tbuiltin

    scene, cams = tbuiltin.build_scene_cornell_box()
    ts = tl.build_scene_torch(scene, device="cpu", dense_max_tris=8)
    assert ts.use_bvh and ts.sl_count > 0
    desc = tl.PathtraceDesc()
    desc.camera_transform = cams[0].transform
    desc.camera_params = cams[0].params
    desc.advanced.max_radiance = 10.0
    desc.pathtrace_type = tl.PathtraceType.NAIVE
    jscene, jcams = jbuiltin.build_scene_cornell_box()
    return ts, desc, build_scene_tpu(jscene, dense_max_tris=8), jcams


def test_self_bound_tiles_as_jax(monkeypatch):
    """A working-set budget below one 8x8 tile's, with a floor of 8, splits
    the 16x16 frame into as many dispatches as the JAX package makes under
    its rays x stride budget of 1 and floor of 8 (tests/test_render.py::
    test_auto_tile_self_bounding), and the tiled image equals the whole
    one; by default the frame is one dispatch."""

    ts, desc, tpu, jcams = _cornell_bvh()
    baked = tl.BakedPathtraceParams(max_bounces=2, samples_per_pixel=1)
    port = _count(monkeypatch, trenderer, "_render_pathtrace")
    full = tl.render_progressive(ts, desc, baked, 16, 16, 1, device="cpu")
    assert len(port) == 1
    monkeypatch.setattr(trenderer, "DISPATCH_MEMORY_SHARE", 0.0)
    monkeypatch.setattr(trenderer, "DISPATCH_TILE_FLOOR", 8)
    port.clear()
    tiled = tl.render_progressive(ts, desc, baked, 16, 16, 1, device="cpu")
    jdesc = jl.PathtraceDesc()
    jdesc.camera_transform = jcams[0].transform
    jdesc.camera_params = jcams[0].params
    jdesc.pathtrace_type = jl.PathtraceType.NAIVE
    monkeypatch.setenv("LUPIN_DISPATCH_RAY_STRIDE_BUDGET", "1")
    monkeypatch.setenv("LUPIN_DISPATCH_TILE_FLOOR", "8")
    # JAX's dispatches counted, not run (the image passes through).
    jcalls = []
    monkeypatch.setattr(jrenderer, "_dispatch_packet_safe",
                        lambda scene, fn, image, *a, **k: jcalls.append(1) or image)
    jrenderer.pathtrace_scene(tpu, jrenderer.new_accumulation_buffer(16, 16),
                              jdesc, jl.BakedPathtraceParams(max_bounces=2,
                                                             samples_per_pixel=1))
    assert len(port) == len(jcalls) == 4
    np.testing.assert_allclose(tiled, full, atol=1e-5)


def test_default_self_bound_is_the_working_set(monkeypatch):
    """A frame splits only where lanes x dispatch_bytes_per_lane passes half
    of the device's memory (here the host's): a 1920x1080 terrain frame is
    one dispatch on the CPU; the bytes per lane grow with the top tree's
    depth (the stack) and with WF_Q, and MIS costs more than NAIVE."""

    tsc, _ = tsyn.build_scene_terrain(n_tris=2048)
    ts = tl.build_scene_torch(tsc, device="cpu")
    baked = tl.BakedPathtraceParams(max_bounces=8, samples_per_pixel=1)
    naive = int(tl.PathtraceType.NAIVE)
    mem = trenderer.device_memory_bytes("cpu")
    base = trenderer.dispatch_bytes_per_lane(ts, baked, naive)
    assert 1000 < base < 10_000 and mem > 1 << 30
    assert trenderer.dispatch_tiles(ts, (1080, 1920), baked, naive, "cpu") is None
    monkeypatch.setattr(trenderer, "DISPATCH_MEMORY_SHARE",
                        1920 * 1080 * base / mem / 10)
    ts_split = trenderer.dispatch_tiles(ts, (1080, 1920), baked, naive, "cpu")
    assert ts_split is not None and ts_split * ts_split * base <= 1920 * 1080 * base / 10
    monkeypatch.setattr(trenderer, "DISPATCH_MEMORY_SHARE", 0.5)
    monkeypatch.setitem(ts.statics, "top_depth", ts.top_depth + 4)
    deeper = trenderer.dispatch_bytes_per_lane(ts, baked, naive)
    assert deeper == base + 2 * 4 * 7 * 4  # two int32 stack copies, 7 rows a level
    monkeypatch.setattr(tint, "WF_Q", 16)
    assert trenderer.dispatch_bytes_per_lane(ts, baked, naive) > deeper
    assert trenderer.dispatch_bytes_per_lane(
        ts, baked, int(tl.PathtraceType.MIS)) > base
    assert tbvh.stack_depth(ts) > 0
