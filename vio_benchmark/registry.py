"""Where the benchmark finds a cell's parts, by the names in BENCHMARK.json.

- a configuration: ``configs/<name>.json`` (the port's ``Config`` as
  ``Config.to_json`` writes it under ``"config"``, with its source and the
  sizes assumed);
- a traffic mix: ``traffic/<name>.json`` (the parameters ``gen/traffic.py``
  reads);
- a per-layer metric: ``metrics/<name>.py``, whose ``read(trace)`` returns
  the number or None when it finds nothing to read;
- a cell's limits of the output check: ``limits/<workload>.json``.

A later change adds a cell, configuration, mix or metric by adding such a
file and its entry.  ``search`` lists further directories, looked in first,
each with the same sub-directories.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _find(kind: str, name: str, suffix: str, search=()) -> Path:
    for base in [*map(Path, search), ROOT]:
        path = base / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} named {name!r} ({kind}/{name}{suffix})")


def load_benchmark(path="BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str):
    """(the workload's entry, its configuration's entry)."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            conf = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, conf
    raise KeyError(f"no workload named {workload!r} in the benchmark")


def load_config(name: str, search=()) -> dict:
    return json.loads(_find("configs", name, ".json", search).read_text())


def load_traffic(name: str, search=()) -> dict:
    return json.loads(_find("traffic", name, ".json", search).read_text())


def load_limits(workload: str, search=()) -> dict:
    """{number: limit} of the cell's output check ({} when it has none)."""
    try:
        return json.loads(_find("limits", workload, ".json", search).read_text())["limits"]
    except FileNotFoundError:
        return {}


def load_reader(name: str, search=()):
    """The per-layer metric's ``read(trace)``."""
    path = _find("metrics", name, ".py", search)
    spec = importlib.util.spec_from_file_location(f"vio_benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, workload: str, kind: str):
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): those
    without a ``workloads`` list and those that list the cell."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]
