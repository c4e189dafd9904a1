"""A cell of BENCHMARK.json with the files it names, found by name:

- the configuration: the `file` that BENCHMARK.json gives it (the scene's
  generator, `generators/<name>.py`, and its arguments);
- the traffic mix: `traffic/<traffic>.json` (the loop kind,
  `loops/<kind>.py`, its sizes and the render settings);
- the limits of its correctness numbers: `limits/<workload>.json`;
- each metric listed for the cell: its end-to-end arithmetic,
  `end_to_end/<metric>.py` (`value(window)`, host clock, over all the work
  and all the time of the window), or its per-layer reader,
  `metrics/<metric>.py` (`read(rec)`).
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(path):
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: str, workload: str) -> dict:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return dict(
        name=workload, chips=int(w["chips"]),
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, workload)],
    )


def _module(folder: str, name: str):
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"lupin_bench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The `read(rec)` function of metrics/<name>.py."""

    return _module("metrics", name).read


def end_to_end(name: str):
    """The `value(window)` function of end_to_end/<name>.py."""

    return _module("end_to_end", name).value


def loop_class(kind: str):
    """The `Loop` class of loops/<kind>.py."""

    return _module("loops", kind).Loop
