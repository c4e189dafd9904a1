"""Device records (kernels, copies, fills) per traced accumulation."""


def read(rec):
    tr = rec["trace"]
    if rec["loop"] != "progressive" or not tr or not tr["events"]:
        return None
    return len(tr["events"]) / tr["units"]
