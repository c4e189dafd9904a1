"""Device ms per traced accumulation of every record that is not one of the
port's CUDA kernels: the PyTorch glue of the path loop and the wavefront
(sorts, gathers, scatters, copies, fills, elementwise kernels)."""

from lupin_bench.records import device_ms, kernel_of


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr or not tr["events"]:
        return None
    return device_ms(tr["events"], lambda n: kernel_of(n) is None) / tr["units"]
