"""Host ms per traced accumulation of the port's own work in its dispatch:
the summed length of the port's `dispatch` spans
(render/renderer.py::pathtrace_scene, lupinpathtracer_tpu_torch/core/trace.py)
less that of the `sync.*` spans inside them, where the host waits on device
values. None where the port records no spans."""


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr:
        return None
    try:
        from lupinpathtracer_tpu_torch.core import trace
    except ImportError:
        return None
    spans = trace.spans(tr["t0_ns"], tr["t1_ns"])
    disp = {s.span_id: s.end_ns - s.start_ns for s in spans if s.name == "dispatch"}
    if not disp:
        return None
    wait = sum(s.end_ns - s.start_ns for s in spans
               if s.name.startswith("sync.") and s.dispatch_id in disp)
    return (sum(disp.values()) - wait) / 1e6 / tr["units"]
