"""GB of device memory allocated at the window's peak above what was held
when the window opened (torch.cuda.max_memory_allocated)."""


def read(rec):
    if rec["loop"] != "progressive" or not rec["window"]["peak_above_bytes"]:
        return None
    return rec["window"]["peak_above_bytes"] / 1e9
