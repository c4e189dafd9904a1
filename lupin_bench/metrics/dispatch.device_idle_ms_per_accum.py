"""Device-idle ms per traced accumulation inside the port's `dispatch`
spans (render/renderer.py::pathtrace_scene,
lupinpathtracer_tpu_torch/core/trace.py): the gaps between the device
records' busy intervals that fall inside a dispatch, the idle time the
port's dispatch causes; the rest of device.idle_share lies outside it.

The clock check: the k-th B3 record must start no earlier than
CLOCK_SLACK_NS before the k-th `b3.launch` span starts, and end no later
than CLOCK_SLACK_NS after the k-th `sync.rays` span ends (the host's read
that waits for B3). The device records come on the profiler's clock, which
on H100 hosts under gVisor, in about one traced window in nine, runs off the
host's by up to 0.7% and is right only at one end of the window, so that the
records drift by up to a few milliseconds against the spans. So they are put
on the spans' clock by one linear map: the profiler's own where every B3
record passes the check on it, else the one that keeps every record farthest
inside its bounds. Where no map passes (or the counts differ), the value is
None and one line goes to standard error. None also where the port records
no spans."""

import bisect
import sys

from lupin_bench.records import PORT_KERNELS, busy_intervals

CLOCK_SLACK_NS = 2000
MAX_RATE = 0.05  # a clock off by more than 5% is no clock to correct


def host_clock(b3, launch, syncs):
    """The map t -> t + c + r * (t - a0) of the records' clock onto the
    spans', a0 the first B3 record's start: the profiler's own (c = r = 0)
    where every B3 record passes the clock check there, else the map that
    keeps every record farthest inside its bounds; None where no map passes.
    `b3` holds the records' (start, end), `launch` the spans' starts, `syncs`
    their ends."""

    a0 = b3[0][0]
    # The check as bounds on c at a rate r: c >= least - r * x, c <= most - r * x.
    starts = [(s - CLOCK_SLACK_NS - a, a - a0) for (a, _), s in zip(b3, launch)]
    ends = [(y + CLOCK_SLACK_NS - b, b - a0) for (_, b), y in zip(b3, syncs)]

    def offsets(r):
        return (max(n - r * x for n, x in starts), min(n - r * x for n, x in ends))

    def excess(r):  # convex in r; <= 0 where some c passes at r
        lo, hi = offsets(r)
        return lo - hi

    lo, hi = offsets(0.0)
    if lo <= 0 <= hi:
        return lambda t: t
    r_lo, r_hi = -MAX_RATE, MAX_RATE
    for _ in range(100):  # ternary search for the rate of least excess
        m1, m2 = r_lo + (r_hi - r_lo) / 3, r_hi - (r_hi - r_lo) / 3
        r_lo, r_hi = (r_lo, m2) if excess(m1) < excess(m2) else (m1, r_hi)
    lo, hi = offsets(r_lo)
    if lo > hi:
        return None
    c = (lo + hi) / 2
    return lambda t: t + round(c + r_lo * (t - a0))


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr or not tr["events"]:
        return None
    try:
        from lupinpathtracer_tpu_torch.core import trace
    except ImportError:
        return None
    spans = trace.spans(tr["t0_ns"], tr["t1_ns"])
    disp = [s for s in spans if s.name == "dispatch"]
    if not disp:
        return None
    b3 = sorted((a, b) for n, a, b in tr["events"] if PORT_KERNELS["B3"] in n)
    launch = sorted(s.start_ns for s in spans if s.name == "b3.launch")
    syncs = sorted(s.end_ns for s in spans if s.name == "sync.rays")
    to_host = None
    if b3 and len(b3) == len(launch) == len(syncs):
        to_host = host_clock(b3, launch, syncs)
    if to_host is None:
        print(f"trace: {len(b3)} B3 records, {len(launch)} b3.launch and "
              f"{len(syncs)} sync.rays spans are not paired on one clock; "
              "dispatch.device_idle_ms_per_accum left out", file=sys.stderr)
        return None
    busy = busy_intervals([(n, to_host(a), to_host(b)) for n, a, b in tr["events"]])
    starts = [a for a, _ in busy]
    idle = 0
    for d in disp:
        covered = 0
        k = max(bisect.bisect_right(starts, d.start_ns) - 1, 0)
        while k < len(busy) and busy[k][0] < d.end_ns:
            covered += max(0, min(busy[k][1], d.end_ns) - max(busy[k][0], d.start_ns))
            k += 1
        idle += d.end_ns - d.start_ns - covered
    return idle / 1e6 / tr["units"]
