"""Host ms per traced accumulation in B7's fetch on the BVH route (the
port's `fetch` spans, kernels/intersect.py: the fetch's sort, work items,
kernel launch, gathers and scatter after each closest hit, on the walk and
the wavefront routes) less any sync inside them. None where the port
records none (a dense scene, or a port without the span)."""

from lupin_bench.port_spans import host_ms_per_accum


def read(rec):
    return host_ms_per_accum(rec, "fetch")
