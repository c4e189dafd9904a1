"""Device ms per traced accumulation of the port's fused shading step
(kernels/shade.py -> csrc/shade.cu: `lupin_shade_kernel`, the BVH route's
path-loop shading, one launch a loop iteration, and `lupin_shade_kernel_first`,
the first samples' rays, one launch a dispatch). None where the trace holds
neither (the dense route, or a program without them)."""

from lupin_bench.records import device_ms

KERNEL = "lupin_shade_kernel"


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr or not tr["events"]:
        return None
    ms = device_ms(tr["events"], lambda n: KERNEL in n)
    return ms / tr["units"] if ms > 0 else None
