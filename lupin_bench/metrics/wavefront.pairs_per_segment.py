"""(ray, superleaf) pairs that B5 emitted in the wavefront's rounds of the
traced window (the port's `intersect.pairs` counts, core/trace.py's count
ring, each round's pairs kept as a device value and read after the window)
per traced segment: the traced accumulations times the window's mean
segments an accumulation (every accumulation of a cell renders the same
frame). The pairs B6 tests a segment. None where the port keeps no such
count (no wavefront round in the window, or a port without the count
ring)."""


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr:
        return None
    try:
        from lupinpathtracer_tpu_torch.core import trace
    except ImportError:
        return None
    counted = getattr(trace, "counted", None)
    rays = rec["window"].get("unit_rays")
    if counted is None or not rays:
        return None
    pairs = counted("intersect.pairs", tr["t0_ns"], tr["t1_ns"])
    if not pairs:
        return None
    return pairs / (tr["units"] * sum(rays) / len(rays))
