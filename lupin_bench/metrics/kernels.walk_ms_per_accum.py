"""Device ms per traced accumulation of the port's BVH walk (kernels/walk.py
-> csrc/walk.cu: `lupin_walk_kernel`, the closest hit of a single-level
scene's bounce batch by one thread per ray, one launch a batch). None where
the trace holds none (the dense route, two-level scenes, or a program
without it)."""

from lupin_bench.records import device_ms

KERNEL = "lupin_walk_kernel"


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr or not tr["events"]:
        return None
    ms = device_ms(tr["events"], lambda n: KERNEL in n)
    return ms / tr["units"] if ms > 0 else None
