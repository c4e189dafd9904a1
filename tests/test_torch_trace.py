"""PyTorch port, its own spans (core/trace.py) and the three dispatch
metrics that read them (lupin_bench/metrics/dispatch.*): nothing recorded
without a profiler while HOST_SYNCS still counts; under a profiler one
`dispatch` span a pathtrace_scene call with its syncs nested under it;
images and traced segments bit-equal with and without spans; the ring's
bound; the readers on synthetic spans and records, with the clock check.
The `gpu` test (skips without a card) checks that the spans share the
device records' clock under profile(activities=[CUDA]), as the benchmark's
traced runs profile. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

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
from lupinpathtracer_tpu_torch.render import integrators, renderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lupin_bench import cells, records  # noqa: E402

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
    version, so b3.launch appears only on the card.)"""

    ts, cam = _scene("cornell")
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch._C._autograd._profiler_enabled()
        _dispatches(ts, cam, n=2)
    got = trace.spans(t0, time.time_ns())
    disp = [s for s in got if s.name == "dispatch"]
    assert len(disp) == 2
    assert len({s.span_id for s in got}) == len(got)
    assert {s.name for s in got} == {"dispatch", "sync.rays", "sync.bounce_loop"}
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
