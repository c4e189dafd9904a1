"""Per cent of the traced accumulations' wall in which nothing ran on the
device (1 - the union of the device records' spans over the wall)."""

from lupin_bench.records import idle_share


def read(rec):
    if rec["loop"] != "progressive" or not rec["trace"]:
        return None
    return idle_share(rec["trace"])
