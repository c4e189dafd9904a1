"""Host ms per traced accumulation blocked in the port's host syncs: the
summed length of its `sync.*` spans (lupinpathtracer_tpu_torch/core/trace.py:
the read of stats["rays"], the wavefront's and the path loop's conditions).
None where the port records no spans."""


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr:
        return None
    try:
        from lupinpathtracer_tpu_torch.core import trace
    except ImportError:
        return None
    spans = trace.spans(tr["t0_ns"], tr["t1_ns"])
    if not any(s.name == "dispatch" for s in spans):
        return None
    wait = sum(s.end_ns - s.start_ns for s in spans if s.name.startswith("sync."))
    return wait / 1e6 / tr["units"]
