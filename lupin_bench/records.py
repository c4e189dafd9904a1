"""Reductions of a traced window's device records (torch.profiler, CUDA
activity only, read from the profiler's raw records: its Python event tree
costs about 0.1 ms a record).

A trace is a dict: `events` [(name, start_ns, end_ns)] of every device
record (kernels, copies, fills), `units` (accumulations or frames traced),
`wall_s` and `t0_ns`/`t1_ns` (the traced window on the host clock,
time.time_ns()), and `spans` [(name, start_ns, end_ns)], the harness's host
spans.
"""

from __future__ import annotations

# The port's hand-written CUDA kernels, by the names of their entry points
# (csrc/*.cu); every other device record is PyTorch's.
BVH_KERNELS = {"B4": "packet_kernel", "B5": "top_kernel", "B6": "pair_hit_kernel",
               "B7": "attr_kernel"}
PORT_KERNELS = dict(BVH_KERNELS, B1_B2="dense_hit_kernel", B3="mega_kernel",
                    B6v="pair_kernel")


def events_of(prof) -> list:
    """(name, start_ns, end_ns) of every device record of a stopped
    profiler."""

    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), int(e.start_ns()), int(e.end_ns())))
    return out


def kernel_of(name: str):
    """The port kernel a device record belongs to, or None."""

    return next((k for k, sub in PORT_KERNELS.items() if sub in name), None)


def device_ms(events, pick) -> float:
    """Summed device ms of the records whose name `pick` accepts."""

    return sum(b - a for n, a, b in events if pick(n)) / 1e6


def busy_intervals(events) -> list:
    """The union of the records' spans as sorted disjoint (start, end)."""

    out = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def busy_s(events) -> float:
    return sum(b - a for a, b in busy_intervals(events)) / 1e9


def idle_share(trace) -> float | None:
    """Per cent of the traced window in which no record ran on the device."""

    if not trace.get("events") or not trace.get("wall_s"):
        return None
    return 100.0 * (1.0 - busy_s(trace["events"]) / trace["wall_s"])


def top_ops(events, n=10) -> list:
    """[name, seconds] of the device operations that took most time."""

    tot: dict = {}
    for name, a, b in events:
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace, n=10) -> list:
    """[label, seconds] of the longest device idle gaps inside the traced
    window, each labelled by the harness span the host was in at the gap's
    middle (with the span's ordinal), "host" where no span covers it."""

    iv = busy_intervals(trace["events"])
    edges = [(trace["t0_ns"], trace["t0_ns"])] + iv + [(trace["t1_ns"],
                                                        trace["t1_ns"])]
    gaps = [(edges[k][1], edges[k + 1][0]) for k in range(len(edges) - 1)
            if edges[k + 1][0] > edges[k][1]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = trace.get("spans", [])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) // 2
        label = "host"
        for k, (name, s0, s1) in enumerate(spans):
            if s0 <= mid <= s1:
                label = f"{name}#{k}"
        out.append([label, (b - a) / 1e9])
    return out


def clock_aligned(trace) -> bool:
    """Whether the device records lie on the host clock of the spans: every
    record inside the traced window, with a second of slack."""

    ev = trace.get("events")
    if not ev:
        return False
    lo = min(a for _, a, _ in ev)
    hi = max(b for _, _, b in ev)
    return lo >= trace["t0_ns"] - 10**9 and hi <= trace["t1_ns"] + 10**9
