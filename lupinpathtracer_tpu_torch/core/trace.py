"""The port's spans: named host intervals inside a render dispatch, kept in
memory on the clock of the profiler's device records.

A span is (name, start_ns, end_ns, span id, parent id, dispatch id), both
ends from time.time_ns(): the Unix-ns clock on which torch.profiler (Kineto)
reports device records. Every span inside one
`render/renderer.py::pathtrace_scene` call carries the span id of that
call's `dispatch` span as its dispatch id. Spans go to a ring of RING
entries, so a profiler left on cannot grow it without limit;
`spans(t0_ns, t1_ns)` returns those inside a window. Each span also opens
torch.profiler.record_function(name), so a profiler's own timeline (with CPU
activity) shows the port's ranges. Nothing is written to a file.

Spans record only while a torch.profiler is active
(torch._C._autograd._profiler_enabled(), which reads true under
profile(activities=[CUDA]) as under CPU activity), or inside `recording()`,
which tests and tools use to record without a profiler. Otherwise a span
site costs that check and returns a shared no-op context: no clock read,
no allocation, no record_function.

The spans, each for what reads it (lupin_bench/metrics/):

- `dispatch`: one whole pathtrace_scene call, every route
  (dispatch.host_ms_per_accum, dispatch.device_idle_ms_per_accum);
- `b3.launch`: kernels/mega.py::_launch from its first line to the return of
  the kernel's launch call, for the check that device records share the
  spans' clock (dispatch.device_idle_ms_per_accum);
- `sync.<site>`: a per-dispatch host sync, through `sync`, which also counts
  it in its module's HOST_SYNCS (dispatch.sync_wait_ms_per_accum, and
  subtracted in dispatch.host_ms_per_accum): `sync.rays`
  (render/renderer.py, the read of stats["rays"]; its end also bounds B3's
  end in the clock check), `sync.wavefront`
  (kernels/intersect.py, the round loops; wavefront.sync_wait_ms_per_accum
  reads those inside `intersect`) and `sync.bounce_loop`
  (render/integrators.py, the path loop);
- `bounce`: one iteration of render/integrators.py::_pathtrace_snd's path
  loop (STANDARD, NAIVE, DIRECT), on either route that runs the loop (the
  BVH route; the dense route off the card, where B3's single launch takes
  no span site); and `shade`, inside it, the iteration's work after the
  closest hit: materials, BSDF, lights and the end of bounce
  (shading.host_ms_per_accum, less the syncs inside it);
- `intersect`: one closest_hit or closest_hit_attrs call on a BVH scene
  (kernels/intersect.py): B4's camera batches, the wavefront's bounce
  batches and B7's fetch (wavefront.host_ms_per_accum, less the syncs
  inside it);
- `wavefront.round`: one round of closest_hit_wavefront's full-batch or
  straggler loop, also counted in intersect.ROUNDS whether or not spans
  record (wavefront.rounds_per_accum);
- `fetch`: B7's fetch (intersect.wavefront_fetch_attrs: its sort, work
  items, kernel, gathers and scatter) inside an `intersect` span, on the
  walk and the wavefront routes (fetch.host_ms_per_accum, less the syncs
  inside it).

Counts go to a second ring while spans record: `count(name, value)` keeps
the value with its time, where the value may be a device tensor that is
read only when `counted(name, t0_ns, t1_ns)` sums a window, so a count
adds no host sync to the path. `intersect.pairs`: the (ray, superleaf)
pairs each wavefront round's B5 emitted (wavefront.pairs_per_segment).

The scene build records no span: scene/flatten.py's BUILD_S holds the last
build's seconds by phase (scene.bvh_build_s).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple

import torch

RING = 65_536
DISPATCH = "dispatch"


class Span(NamedTuple):
    """One recorded span; ends in time.time_ns(), ids from one counter."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int | None
    dispatch_id: int | None


class _Off:
    """The no-op context a span site returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_ring: deque = deque(maxlen=RING)
_counts: deque = deque(maxlen=RING)  # (name, time_ns, value)
_ids = itertools.count(1)
_open: list = []  # (span id, dispatch id) of the open spans, innermost last
_recording = 0
_profiling = torch._C._autograd._profiler_enabled
_OFF = _Off()


@contextmanager
def _record(name: str):
    sid = next(_ids)
    parent, did = _open[-1] if _open else (None, None)
    if name == DISPATCH:
        did = sid
    _open.append((sid, did))
    t0 = time.time_ns()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        t1 = time.time_ns()
        _open.pop()
        _ring.append(Span(name, t0, t1, sid, parent, did))


def span(name: str):
    """A context recording `name` as a span while recording, else the
    shared no-op context."""

    if not (_recording or _profiling()):
        return _OFF
    return _record(name)


def sync(counts: dict, site: str, value, cast=bool):
    """The port's per-dispatch host sync: counts it in counts[site] (its
    module's HOST_SYNCS) and returns cast(value), the blocking read of a
    device value, inside a `sync.<site>` span while recording."""

    counts[site] += 1
    if not (_recording or _profiling()):
        return cast(value)
    with _record("sync." + site):
        return cast(value)


@contextmanager
def recording():
    """Records spans without a profiler (tests and tools; the render path
    never calls it)."""

    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans(t0_ns: int, t1_ns: int) -> list:
    """The ring's spans that start and end inside [t0_ns, t1_ns], in the
    order they ended."""

    return [s for s in list(_ring) if s.start_ns >= t0_ns and s.end_ns <= t1_ns]


def count(name: str, value):
    """Keeps `value` (an int or a one-element tensor, on any device; not
    read here) under `name` with the time while recording; else nothing."""

    if _recording or _profiling():
        _counts.append((name, time.time_ns(), value))


def counted(name: str, t0_ns: int, t1_ns: int):
    """The sum of the `name` counts kept inside [t0_ns, t1_ns] (reading a
    device value syncs), or None where none was kept."""

    vals = [v for n, t, v in list(_counts) if n == name and t0_ns <= t <= t1_ns]
    return sum(int(v) for v in vals) if vals else None
