"""Device ms per traced accumulation of the port's megakernel B3
(`kernels/mega.py` -> `csrc/mega.cu`, `mega_kernel`), the whole path loop of
a scene inside its gate in one launch."""

from lupin_bench.records import PORT_KERNELS, device_ms


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr or not tr["events"]:
        return None
    ms = device_ms(tr["events"], lambda n: PORT_KERNELS["B3"] in n)
    return ms / tr["units"] if ms > 0 else None
