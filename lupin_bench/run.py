"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 lupin_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as setup_s from the process's start): CUDA, the cell's scene
from the seed (scenes.py, generators/), the port's scene build, one warm-up
unit at the cell's own shape. Then the window: the loop's units
(loops/<kind>.py) for --seconds. With --trace 1 a steady part of the window runs under
torch.profiler (CUDA activity only) and the cell's per-layer metrics are
printed instead of its end-to-end ones. Then the check: the program's state
is freed and the plain reference (reference.py) is compared with what the
window produced (check.py). The last line of standard output is one JSON
object; the compared numbers, each beside its limit, are the last lines of
standard error.
"""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lupinpathtracer_tpu")


def process_start() -> float:
    """The process's start on the clock of time.time() (Linux /proc), or
    the import of this module where /proc does not say."""

    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""

    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of `cell` (cells.load's dict) on `device`; the result line's
    object. The reference runs on the same device after the window."""

    import torch

    from lupin_bench import cells, check, port, records, scenes
    from lupin_bench.reference import Reference

    cuda = torch.device(device).type == "cuda"
    cfg, traffic = cell["config"], cell["traffic"]
    seed32 = seed & 0xFFFFFFFF
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
    desc = scenes.generate(cfg, seed % 2**64)
    two_level = bool(cfg["scene"]["two_level"])
    ts, build_s = port.build(desc, two_level, device)
    loop = cells.loop_class(traffic["loop"])(ts, desc, traffic, seed32, device)
    loop.warmup()
    setup_s = time.time() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    w = loop.window(seconds, start_profiler if trace else None)
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated(device)
                      if cuda else 0)
    rec = dict(loop=traffic["loop"], setup=dict(scene_build_s=build_s),
               window=w, trace=None)
    result = {}
    if trace:
        tr = w.pop("traced")
        prof = tr.pop("prof")
        tr["events"] = records.events_of(prof)
        del prof
        tr["spans"] = [s for s in loop.spans.spans
                       if s[2] >= tr["t0_ns"] and s[1] <= tr["t1_ns"]]
        rec["trace"] = tr
        if not records.clock_aligned(tr):
            print("trace: device records are not on the host clock; idle gaps "
                  "are labelled 'host'", file=sys.stderr)
            tr["spans"] = []
        metrics = {}
        for m in cell["per_layer"]:
            v = cells.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": records.top_ops(tr["events"]),
                               "idle_gaps": records.idle_gaps(tr)}
        busy = records.busy_s(tr["events"])
        window_s = tr["wall_s"]
    else:
        metrics = {m["name"]: {"value": cells.end_to_end(m["name"])(w),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # The check: the window's output, then the program's state freed.
    W, H = int(traffic["width"]), int(traffic["height"])
    gx, gy = check.sample_pixels(seed % 2**64, 1, W, H,
                                 int(traffic["check"]["pixels"]), device)
    img, accums = loop.checked(w["units"])
    prog_px = img[gy.long(), gx.long()].float()
    attempted, loop_unit = w["units"], loop.unit
    loop.free()
    del loop, ts, img
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Reference(desc, two_level, device)
    numbers = check.progressive_numbers(
        prog_px, accums, w["unit_rays"], ref, traffic, desc["camera"], seed32,
        seed % 2**64, gx, gy)
    correct, checks = check.verdict(numbers, cell["limits"])
    us = sorted(w["unit_s"])
    print(f"window: {attempted} {loop_unit}s in {w['wall_s']:.3f} s (each "
          f"{us[0]:.4f} / {us[len(us) // 2]:.4f} / {us[-1]:.4f} s min / median / "
          f"max; rays {w['rays']}); checked image of {accums}; reference: "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev["busy_s"] = busy
        dev["window_s"] = window_s
    out = {"correct": correct, "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    out.update(result)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()

    from lupin_bench import cells

    cell = cells.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check correct = {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
