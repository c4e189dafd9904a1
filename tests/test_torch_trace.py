"""PyTorch port, its own spans (core/trace.py) and the metrics that read
them (lupin_bench/metrics/): nothing recorded without a profiler while
HOST_SYNCS still counts; under a profiler one `dispatch` span a
pathtrace_scene call with its syncs nested under it; images and traced
segments bit-equal with and without spans; the ring's bound; the dispatch
readers on synthetic spans and records, with the clock check; the BVH
route's `bounce`, `shade`, `intersect` and `wavefront.round` spans on the
SPD tetra scene at size factor 5, intersect.ROUNDS, scene/flatten.py's
BUILD_S, and the BVH route's readers on a recorded window and on a Cornell
one; B7's `fetch` span inside `intersect`, intersect.PAIRS and the count
ring on a small two-level batch, and their readers on the SPD balls scene's
window.
The `gpu` test (skips without a card) checks that the spans share the
device records' clock under profile(activities=[CUDA]), as the benchmark's
traced runs profile. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import contextlib
import os
import sys
import time
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lupinpathtracer_tpu_torch as tl
from lupinpathtracer_tpu_torch.core import trace
from lupinpathtracer_tpu_torch.core.trace import Span
from lupinpathtracer_tpu_torch.io import builtin, synthetic
from lupinpathtracer_tpu_torch.kernels import intersect
from lupinpathtracer_tpu_torch.render import integrators, renderer
from lupinpathtracer_tpu_torch.scene import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lupin_bench import cells, port, records, scenes  # noqa: E402

READERS = ("dispatch.host_ms_per_accum", "dispatch.sync_wait_ms_per_accum",
           "dispatch.device_idle_ms_per_accum")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _desc(cam, max_radiance=10.0):
    desc = tl.PathtraceDesc()
    desc.camera_transform = cam.transform
    desc.camera_params = cam.params
    desc.pathtrace_type = tl.PathtraceType.STANDARD
    desc.advanced.max_radiance = max_radiance
    return desc


def _scene(name, device="cpu"):
    """(scene on `device`, its first camera): the dense Cornell box (the
    megakernel's route; on the CPU its plain version) or a small terrain
    (the BVH route: B4 camera rays, the wavefront on bounces)."""

    if name == "cornell":
        scene, cams = builtin.build_scene_cornell_box()
    else:
        scene, cams = synthetic.build_scene_terrain(n_tris=2048)
    return tl.build_scene_torch(scene, device=device), cams[0]


def _dispatches(ts, cam, n=2, W=16, H=12, spp=2, bounces=3):
    """n accumulations by pathtrace_scene, each with a stats dict; returns
    (image, the stats' ray counts)."""

    baked = tl.BakedPathtraceParams(max_bounces=bounces, samples_per_pixel=spp)
    desc = _desc(cam)
    img = renderer.new_accumulation_buffer(W, H, ts.device)
    rays = []
    for i in range(n):
        desc.accum_params.accumulate = True
        desc.accum_params.counter = i
        stats = {}
        img = renderer.pathtrace_scene(ts, img, desc, baked, stats)
        rays.append(stats["rays"])
    return img, rays


def test_no_profiler_records_nothing_while_host_syncs_count(monkeypatch):
    """Without a profiler a span site is the shared no-op context and reads
    no clock; the dense dispatch still counts its syncs, the new `rays` one
    among them."""

    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("dispatch") is trace._OFF
    ts, cam = _scene("cornell")
    renderer.HOST_SYNCS["rays"] = 0
    integrators.HOST_SYNCS["bounce_loop"] = 0

    class NoClock:
        def time_ns(self):
            raise AssertionError("a span read the clock with tracing off")

    def no_range(name):
        raise AssertionError("a span opened a range with tracing off")

    t0 = time.time_ns()
    with monkeypatch.context() as m:
        m.setattr(trace, "time", NoClock())
        m.setattr(torch.profiler, "record_function", no_range)
        _dispatches(ts, cam, n=2)
    assert trace.spans(t0, time.time_ns()) == []
    assert renderer.HOST_SYNCS["rays"] == 2
    assert integrators.HOST_SYNCS["bounce_loop"] > 2
    assert trace.sync(renderer.HOST_SYNCS, "rays", torch.tensor(7), int) == 7
    assert renderer.HOST_SYNCS["rays"] == 3


def test_profiler_spans_nest_under_their_dispatch():
    """Under profile(activities=[CPU]): one `dispatch` span a call, its
    sync.rays and sync.bounce_loop spans inside it, carrying its dispatch
    id; every span id unique. (On the CPU B3's wrapper runs its plain
    version, so b3.launch appears only on the card, and the plain path
    loop's `bounce` and `shade` spans only off it.)"""

    ts, cam = _scene("cornell")
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch._C._autograd._profiler_enabled()
        _dispatches(ts, cam, n=2)
    got = trace.spans(t0, time.time_ns())
    disp = [s for s in got if s.name == "dispatch"]
    assert len(disp) == 2
    assert len({s.span_id for s in got}) == len(got)
    assert {s.name for s in got} == {"dispatch", "sync.rays", "sync.bounce_loop",
                                     "bounce", "shade"}
    by_id = {s.span_id: s for s in got}
    for d in disp:
        assert d.parent_id is None and d.dispatch_id == d.span_id
        inner = [s for s in got if s.dispatch_id == d.span_id and s is not d]
        assert [s.name for s in inner].count("sync.rays") == 1
        assert sum(s.name == "sync.bounce_loop" for s in inner) > 1
        for s in inner:
            assert s.parent_id in by_id
            assert d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
    assert disp[0].end_ns <= disp[1].start_ns
    # The profiler's own timeline shows the port's ranges.
    names = {e.name for e in prof.events()}
    assert {"dispatch", "sync.rays", "sync.bounce_loop"} <= names


@pytest.mark.parametrize("name", ["cornell", "terrain"])
def test_spans_change_no_result(name):
    """The image and stats["rays"] are bit-equal with spans off, under a
    profiler and under trace.recording() (the dense route, and the BVH route
    through the wavefront, whose round syncs then record too)."""

    ts, cam = _scene(name)
    off = _dispatches(ts, cam)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        on = _dispatches(ts, cam)
    with trace.recording():
        rec = _dispatches(ts, cam)
    for img, rays in (on, rec):
        assert torch.equal(img, off[0]) and rays == off[1]
    names = {s.name for s in trace.spans(t0, time.time_ns())}
    assert {"dispatch", "sync.rays", "sync.bounce_loop"} <= names
    if name == "terrain":
        assert "sync.wavefront" in names


def test_ring_stays_within_its_bound(monkeypatch):
    monkeypatch.setattr(trace, "_ring", deque(maxlen=trace.RING))
    counts = {"probe": 0}
    t0 = time.time_ns()
    with trace.recording():
        for k in range(trace.RING + 100):
            with trace.span("dispatch"):
                assert trace.sync(counts, "probe", k, int) == k
    assert counts["probe"] == trace.RING + 100
    assert len(trace._ring) == trace.RING
    kept = trace.spans(t0, time.time_ns())
    assert len(kept) == trace.RING
    assert kept[-1].name == "dispatch" and kept[-2].name == "sync.probe"
    assert kept[-2].dispatch_id == kept[-1].span_id
    assert not trace._recording and not trace._open


B3 = "void (anonymous namespace)::mega_kernel<true>(Params, int)"


def _synthetic(monkeypatch, n=2, plant=(0, 0), drift=0.0, offset=0, drop=False):
    """n traced accumulations 200 us apart: each a 100 us dispatch with a
    15 us b3.launch and a 60 us sync.rays, a 78 us B3 record (starting 2 us
    after its launch span, ending 5 us before the sync's end) and two glue
    records (2 and 7 us) inside it, and a glue record between dispatches; a
    dispatch after the window. plant = (k, ns) moves the k-th B3 record's
    start; `drift` slows the records' clock by that share about the first
    B3 record and `offset` moves it by that many ns; `drop` loses the last
    B3 record."""

    spans, events = [], []
    for k in range(n):
        base, d = 1_000 + 200_000 * k, 3 * k + 1
        spans += [Span("b3.launch", base + 4_000, base + 19_000, d + 1, d, d),
                  Span("sync.rays", base + 29_000, base + 89_000, d + 2, d, d),
                  Span("dispatch", base, base + 100_000, d, None, d)]
        if not (drop and k == n - 1):
            shift = plant[1] if k == plant[0] else 0
            events.append((B3, base + 6_000 + shift, base + 84_000))
        events += [("reduce_kernel", base + 85_000, base + 87_000),
                   ("elementwise_kernel", base + 91_000, base + 98_000),
                   ("elementwise_kernel", base + 149_000, base + 159_000)]
    a0 = 7_000 + plant[1] * (plant[0] == 0)
    events = [(m, round(a0 + offset + (a - a0) * (1 - drift)),
               round(a0 + offset + (b - a0) * (1 - drift))) for m, a, b in events]
    t1 = 200_000 * n + 105_000
    d = 3 * n + 1
    spans.append(Span("dispatch", t1 + 95_000, t1 + 105_000, d, None, d))
    monkeypatch.setattr(trace, "_ring", deque(spans, maxlen=trace.RING))
    tr = dict(events=events, units=n, wall_s=t1 * 1e-9, t0_ns=0, t1_ns=t1,
              spans=[])
    return dict(loop="progressive", setup=dict(scene_build_s=0.0),
                window=dict(peak_above_bytes=0), trace=tr)


def test_dispatch_readers_on_synthetic_spans(monkeypatch):
    """host: (100 - 60) us a dispatch; sync wait: 60 us; device idle inside
    a dispatch: 100 - (78 + 2 + 7) = 13 us."""

    rec = _synthetic(monkeypatch)
    got = {n: cells.reader(n)(rec) for n in READERS}
    assert got["dispatch.host_ms_per_accum"] == pytest.approx(0.040)
    assert got["dispatch.sync_wait_ms_per_accum"] == pytest.approx(0.060)
    assert got["dispatch.device_idle_ms_per_accum"] == pytest.approx(0.013)
    assert records.idle_share(rec["trace"]) > 0


def test_dispatch_readers_none_outside_a_traced_progressive_run(monkeypatch):
    rec = _synthetic(monkeypatch)
    for n in READERS:
        read = cells.reader(n)
        assert read(dict(rec, trace=None)) is None
        assert read(dict(rec, loop="fly")) is None
    monkeypatch.setattr(trace, "_ring", deque(maxlen=trace.RING))
    for n in READERS:
        assert cells.reader(n)(rec) is None


@pytest.mark.parametrize("case,kw,want", [
    ("first_record_within_slack", dict(plant=(0, -3_999)), 0.011),
    ("first_record_far_before_its_launch", dict(n=60, plant=(0, -20_000)), None),
    ("record_before_its_launch", dict(n=60, plant=(30, -40_000)), None),
    ("records_lost", dict(n=60, drop=True), None),
    ("records_clock_slow", dict(n=60, drift=0.004), 0.013),
    ("records_clock_early", dict(n=60, offset=-300_000), 0.013),
    ("records_clock_early_and_fast",
     dict(n=60, offset=-1_000_000, drift=-0.005), 0.013),
])
def test_clock_check(monkeypatch, capsys, case, kw, want):
    """The records' clock put on the spans' by one linear map: records on a
    clock 0.4% slow (47 us early by the window's end), 300 us early, or 1 ms
    early and 0.5% fast come back to the spans' clock; the first record
    planted 4 us early (within the check's slack) covers 4 us more of its
    dispatch. The idle metric is left out, with one line on standard error,
    where no one map places every B3 record after its b3.launch span's start
    and before its sync.rays span's end (a record planted 20 or 40 us early
    among on-time ones) or records are lost. The span-only readers keep
    their values."""

    rec = _synthetic(monkeypatch, **kw)
    idle = cells.reader("dispatch.device_idle_ms_per_accum")(rec)
    err = capsys.readouterr().err
    if want is not None:
        assert idle == pytest.approx(want, abs=1e-4) and err == ""
    else:
        assert idle is None and len(err.strip().splitlines()) == 1
    assert cells.reader("dispatch.host_ms_per_accum")(rec) == pytest.approx(0.040)
    if case == "records_clock_slow":
        last = max(a for m, a, _ in rec["trace"]["events"] if m == B3)
        assert last < 1_000 + 200_000 * 59 + 4_000 - 40_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_spans_share_the_device_records_clock_on_card(cuda_device):
    """Under profile(activities=[CUDA]), as the benchmark's traced runs: a
    dense dispatch records `dispatch`, `b3.launch` and `sync.rays`, and its
    B3 device record starts no earlier than 2 us before b3.launch starts."""

    ts, cam = _scene("cornell", cuda_device)
    _dispatches(ts, cam, n=1, W=64, H=64)  # builds B3
    torch.cuda.synchronize()
    t0 = time.time_ns()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    assert torch._C._autograd._profiler_enabled()
    _dispatches(ts, cam, n=1, W=64, H=64)
    torch.cuda.synchronize()
    t1 = time.time_ns()
    prof.stop()
    got = trace.spans(t0, t1)
    assert {"dispatch", "b3.launch", "sync.rays"} <= {s.name for s in got}
    launch = [s for s in got if s.name == "b3.launch"]
    b3 = [e for e in records.events_of(prof) if records.PORT_KERNELS["B3"] in e[0]]
    assert len(launch) == len(b3) == 1
    assert b3[0][1] >= launch[0].start_ns - 2_000
    assert b3[0][1] <= t1


# ------------------------------------------------------------ BVH route

BVH_READERS = ("scene.bvh_build_s", "wavefront.rounds_per_accum",
               "wavefront.host_ms_per_accum", "wavefront.sync_wait_ms_per_accum",
               "shading.host_ms_per_accum", "kernels.b4_ms_per_accum",
               "kernels.b6_ms_per_accum", "kernels.b5_b7_ms_per_accum")
# Device records of the BVH kernels, as the profiler names them, with their
# us: B4 0.5, B6 3 + 1, B5 0.25, B7 0.25.
BVH_EVENTS = (("void packet_kernel<false>(PacketArgs)", 500),
              ("void pair_hit_kernel(PairArgs, PairSplit)", 3_000),
              ("void pair_hit_kernel(PairArgs, PairSplit)", 1_000),
              ("void top_kernel_x8(float4 const*, int const*)", 250),
              ("void attr_kernel(int const*, int const*)", 250))


def _spd_window(n=2, record=True):
    """n accumulations of the SPD tetra scene at size factor 5 (4,098
    triangles, single-level BVH) at 24x16 and 2 spp, recorded unless
    `record` is False: (the progressive loop's record of a traced window,
    its spans, the rounds intersect.ROUNDS counted). The device records are
    BVH_EVENTS (the CPU has none)."""

    cfg = dict(scene=dict(generator="spd_tetra", args=dict(size_factor=5),
                          two_level=False))
    d = scenes.generate(cfg, 3)
    ts, build_s = port.build(d, False, "cpu")
    traffic = dict(width=24, height=16, spp=2, accumulations=200,
                   render=dict(integrator="STANDARD", max_bounces=8,
                               max_radiance=100.0, ray_epsilon=0.001))
    loop = cells.loop_class("progressive")(ts, d, traffic, 77, "cpu")
    loop.begin()
    r0 = intersect.ROUNDS["wavefront"]
    t0 = time.time_ns()
    with trace.recording() if record else contextlib.nullcontext():
        for i in range(n):
            loop.step(i)
    t1 = time.time_ns()
    events = [(m, t0 + 1_000 * k, t0 + 1_000 * k + us * 1_000)
              for k, (m, us) in enumerate(BVH_EVENTS)]
    tr = dict(events=events, units=n, wall_s=(t1 - t0) * 1e-9, t0_ns=t0,
              t1_ns=t1, spans=[])
    rec = dict(loop="progressive", setup=dict(scene_build_s=build_s),
               window=dict(peak_above_bytes=0), trace=tr)
    return rec, trace.spans(t0, t1), intersect.ROUNDS["wavefront"] - r0


def test_bvh_route_spans_nest_under_their_dispatch():
    """A BVH render records `bounce`, `shade` inside it, `intersect` (the
    camera batch's and each bounce's) and `wavefront.round` inside an
    `intersect`, each carrying its dispatch's id and inside its time;
    intersect.ROUNDS counts the rounds whether or not spans record."""

    rec, got, rounds = _spd_window()
    names = [s.name for s in got]
    for n in ("bounce", "shade", "intersect", "wavefront.round"):
        assert n in names, n
    assert rounds == names.count("wavefront.round") > 0
    by_id = {s.span_id: s for s in got}
    disp = {s.span_id: s for s in got if s.name == "dispatch"}
    assert len(disp) == 2
    for s in got:
        if s.name == "dispatch":
            continue
        d = disp[s.dispatch_id]
        assert d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
        parent = by_id[s.parent_id]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        want = {"shade": "bounce", "bounce": "dispatch",
                "wavefront.round": "intersect"}.get(s.name)
        if want:
            assert parent.name == want, (s.name, parent.name)
        if s.name == "intersect":
            assert parent.name in ("dispatch", "bounce")
    # One intersect a bounce, plus the camera batch's of each dispatch.
    assert names.count("intersect") == names.count("bounce") + 2
    # Off, the same rounds are still counted.
    _, off, off_rounds = _spd_window(record=False)
    assert off == [] and off_rounds == rounds


def test_the_dense_route_records_no_intersect_span():
    """A Cornell render (the dense route; on the CPU B3's plain version,
    the path loop) records no `intersect` or `wavefront.round` span and
    counts no round."""

    ts, cam = _scene("cornell")
    r0 = intersect.ROUNDS["wavefront"]
    t0 = time.time_ns()
    with trace.recording():
        _dispatches(ts, cam, n=2)
    names = {s.name for s in trace.spans(t0, time.time_ns())}
    assert "dispatch" in names and "bounce" in names
    assert not names & {"intersect", "wavefront.round"}
    assert intersect.ROUNDS["wavefront"] == r0


@pytest.mark.parametrize("name", BVH_READERS)
def test_bvh_readers_give_a_number_on_a_bvh_window(name):
    rec, _, _ = _spd_window()
    v = cells.reader(name)(rec)
    assert isinstance(v, float) and v > 0, v


@pytest.mark.parametrize("name", BVH_READERS[1:])
def test_bvh_readers_give_none_on_a_cornell_window(monkeypatch, name):
    """A Cornell window as the card records it (`dispatch`, `b3.launch`,
    `sync.rays` spans; B3 and glue records) has nothing these readers
    read. (scene.bvh_build_s reads the set-up's build, not the window.)"""

    assert cells.reader(name)(_synthetic(monkeypatch)) is None


def test_bvh_readers_arithmetic():
    """On the recorded window: the span readers from the spans themselves,
    the device readers from BVH_EVENTS."""

    rec, got, rounds = _spd_window()
    by_id = {s.span_id: s for s in got}

    def under(s, outer):
        p = by_id.get(s.parent_id)
        while p is not None and p.name != outer:
            p = by_id.get(p.parent_id)
        return p is not None

    def ms(pick):
        return sum(s.end_ns - s.start_ns for s in got if pick(s)) / 1e6 / 2

    read = {n: cells.reader(n)(rec) for n in BVH_READERS}
    assert read["wavefront.rounds_per_accum"] == rounds / 2
    sync_in = ms(lambda s: s.name == "sync.wavefront" and under(s, "intersect"))
    assert sync_in > 0
    assert read["wavefront.sync_wait_ms_per_accum"] == pytest.approx(sync_in)
    assert read["wavefront.host_ms_per_accum"] == pytest.approx(
        ms(lambda s: s.name == "intersect") - ms(
            lambda s: s.name.startswith("sync.") and under(s, "intersect")))
    assert read["shading.host_ms_per_accum"] == pytest.approx(
        ms(lambda s: s.name == "shade") - ms(
            lambda s: s.name.startswith("sync.") and under(s, "shade")))
    assert read["kernels.b4_ms_per_accum"] == pytest.approx(0.25)
    assert read["kernels.b6_ms_per_accum"] == pytest.approx(2.0)
    assert read["kernels.b5_b7_ms_per_accum"] == pytest.approx(0.25)
    assert read["scene.bvh_build_s"] == pytest.approx(
        flatten.BUILD_S["bvh"] + flatten.BUILD_S["superleaf"])


def test_build_phases_are_recorded(monkeypatch):
    """build_scene_torch's BUILD_S: the BVH and superleaf phases of the
    last build, the rest of the flattening and the copy to the device,
    inside the call's own time; scene.bvh_build_s reads None from a port
    without the record."""

    cfg = dict(scene=dict(generator="spd_tetra", args=dict(size_factor=4),
                          two_level=False))
    d = scenes.generate(cfg, 3)
    t0 = time.perf_counter()
    port.build(d, False, "cpu")
    wall = time.perf_counter() - t0
    b = dict(flatten.BUILD_S)
    assert set(b) == {"bvh", "superleaf", "flatten", "device"}
    assert all(v > 0 for v in b.values())
    assert sum(b.values()) <= wall
    monkeypatch.delattr(flatten, "BUILD_S")
    assert cells.reader("scene.bvh_build_s")(None) is None


def test_build_phases_restart_with_each_build():
    """A dense scene's build after a BVH scene's sets every phase anew: no
    phase carries the larger scene's seconds over."""

    cfg = dict(scene=dict(generator="spd_tetra", args=dict(size_factor=4),
                          two_level=False))
    port.build(scenes.generate(cfg, 3), False, "cpu")
    big = dict(flatten.BUILD_S)
    t0 = time.perf_counter()
    _scene("cornell")
    wall = time.perf_counter() - t0
    small = dict(flatten.BUILD_S)
    assert set(small) == set(big)
    assert all(v >= 0 for v in small.values())
    assert sum(small.values()) <= wall
    assert small["bvh"] + small["superleaf"] < big["bvh"] + big["superleaf"]


# ------------------------------------------- B7's fetch span, B5's pairs

FETCH_READERS = ("fetch.host_ms_per_accum", "wavefront.pairs_per_segment")


def _balls_scene(sf=2, subdivisions=1):
    cfg = dict(scene=dict(generator="spd_balls", two_level=True,
                          args=dict(size_factor=sf, subdivisions=subdivisions)))
    d = scenes.generate(cfg, 3)
    return d, port.build(d, True, "cpu")[0]


def _balls_window(n=2, record=True):
    """n accumulations of the SPD balls scene at size factor 2 (91
    instanced spheres of 80 triangles, two-level) at 24x16 and 2 spp,
    recorded unless `record` is False: (the progressive loop's record of a
    traced window, its spans, the pairs intersect.PAIRS counted)."""

    d, ts = _balls_scene()
    traffic = dict(width=24, height=16, spp=2, accumulations=100,
                   render=dict(integrator="STANDARD", max_bounces=8,
                               max_radiance=10.0, ray_epsilon=0.001))
    loop = cells.loop_class("progressive")(ts, d, traffic, 77, "cpu")
    loop.begin()
    p0 = int(intersect.PAIRS["wavefront"])
    t0 = time.time_ns()
    with trace.recording() if record else contextlib.nullcontext():
        for i in range(n):
            loop.step(i)
    t1 = time.time_ns()
    tr = dict(events=[], units=n, wall_s=(t1 - t0) * 1e-9, t0_ns=t0, t1_ns=t1,
              spans=[])
    rec = dict(loop="progressive", setup=dict(scene_build_s=0.0),
               window=dict(peak_above_bytes=0, unit_rays=list(loop.unit_rays)),
               trace=tr)
    return rec, trace.spans(t0, t1), int(intersect.PAIRS["wavefront"]) - p0


@pytest.mark.parametrize("scene", ["spd_balls", "spd_tetra"])
def test_fetch_spans_nest_inside_intersect(scene):
    """B7's fetch is one `fetch` span inside its `intersect` span, carrying
    its dispatch's id: every intersect of the two-level scene (camera and
    bounce batches alike), every bounce batch's of the single-level one
    (its camera batches take B4, which fetches in the kernel)."""

    got = (_balls_window() if scene == "spd_balls" else _spd_window())[1]
    by_id = {s.span_id: s for s in got}
    fetch = [s for s in got if s.name == "fetch"]
    inter = [s for s in got if s.name == "intersect"]
    assert fetch
    for s in fetch:
        parent = by_id[s.parent_id]
        assert parent.name == "intersect"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.dispatch_id == parent.dispatch_id is not None
    if scene == "spd_balls":
        assert len(fetch) == len(inter)
    else:
        bounces = sum(s.name == "bounce" for s in got)
        assert len(fetch) == len(inter) - 2 == bounces


def test_pairs_count_a_two_level_batchs_pairs(monkeypatch):
    """intersect.PAIRS adds, round by round, the (ray, superleaf) pairs B5
    emitted (the non-empty slots of its output) on a small two-level bounce
    batch cut into several rounds, recording or not; the count ring keeps them only while
    recording."""

    _, ts = _balls_scene()
    g = torch.Generator().manual_seed(4)
    B = 3000
    ro = intersect.V3(*(torch.rand(B, generator=g) * 2.4 - 1.2 for _ in range(2)),
                      torch.full((B,), 1.5))
    d = torch.randn(B, 3, generator=g)
    d[:, 2] = -d[:, 2].abs() - 0.3
    d = d / d.norm(dim=1, keepdim=True)
    rd = intersect.V3(d[:, 0], d[:, 1], d[:, 2])
    emitted = []
    orig = intersect.bk.top_traverse

    def top_traverse(*a, **kw):
        out = orig(*a, **kw)
        emitted.append(int((out[0] >= 0).sum()))
        return out

    monkeypatch.setattr(intersect.bk, "top_traverse", top_traverse)
    monkeypatch.setattr(intersect, "WF_Q", 1)  # several rounds
    monkeypatch.setattr(intersect, "WF_Q_TAIL", 2)
    monkeypatch.setitem(intersect.PAIRS, "wavefront", 0)
    t0 = time.time_ns()
    h = intersect.closest_hit(ts, ro, rd, 1e-3, coherent=False)
    t1 = time.time_ns()
    assert bool(h.hit.any()) and len(emitted) > 1
    assert int(intersect.PAIRS["wavefront"]) == sum(emitted) > B
    assert intersect.PAIRS["wavefront"].dtype == torch.int64
    assert trace.counted("intersect.pairs", t0, t1) is None
    emitted.clear()
    t0 = time.time_ns()
    with trace.recording():
        h2 = intersect.closest_hit(ts, ro, rd, 1e-3, coherent=False)
    t1 = time.time_ns()
    assert torch.equal(h2.dst, h.dst)
    assert trace.counted("intersect.pairs", t0, t1) == sum(emitted)
    assert int(intersect.PAIRS["wavefront"]) == 2 * sum(emitted)


def test_fetch_readers_arithmetic():
    """On the balls window: fetch.host_ms_per_accum from the `fetch` spans
    less the syncs inside them; wavefront.pairs_per_segment the window's
    pairs over its accumulations' segments, the same count whether or not
    spans record."""

    rec, got, pairs = _balls_window()
    read = {n: cells.reader(n)(rec) for n in FETCH_READERS}
    by_id = {s.span_id: s for s in got}

    def under_fetch(s):
        p = by_id.get(s.parent_id)
        while p is not None and p.name != "fetch":
            p = by_id.get(p.parent_id)
        return p is not None

    own = sum(s.end_ns - s.start_ns for s in got if s.name == "fetch")
    wait = sum(s.end_ns - s.start_ns for s in got
               if s.name.startswith("sync.") and under_fetch(s))
    assert read["fetch.host_ms_per_accum"] == pytest.approx((own - wait) / 1e6 / 2)
    rays = rec["window"]["unit_rays"]
    assert pairs > sum(rays) > 0
    assert read["wavefront.pairs_per_segment"] == pytest.approx(pairs / sum(rays))
    _, off, off_pairs = _balls_window(record=False)
    assert off == [] and off_pairs == pairs


@pytest.mark.parametrize("name", FETCH_READERS)
def test_fetch_readers_none_where_nothing_is_read(monkeypatch, name):
    """None on a Cornell window (no `fetch` span, no wavefront round), on
    an untraced run, on another loop, on a window the port recorded nothing
    in, and from a port without the count ring."""

    read = cells.reader(name)
    rec, _, _ = _balls_window(n=1)
    assert isinstance(read(rec), float) and read(rec) > 0
    assert read(dict(rec, trace=None)) is None
    assert read(dict(rec, loop="fly")) is None
    late = dict(rec["trace"], t0_ns=rec["trace"]["t1_ns"] + 1,
                t1_ns=rec["trace"]["t1_ns"] + 10**9)
    assert read(dict(rec, trace=late)) is None
    syn = _synthetic(monkeypatch)
    syn["window"]["unit_rays"] = [1000, 1000]
    assert read(syn) is None
    monkeypatch.delattr(trace, "counted")
    if name == "wavefront.pairs_per_segment":
        assert read(rec) is None
