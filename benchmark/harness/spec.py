"""The benchmark's specification, found by name: ``BENCHMARK.json`` at the
root of the checkout names the cells, configurations and metrics; each has
files of its own under ``benchmark/``:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, parameters of the one generator;
* a cell: ``workloads/<cell>.json``, the limits of its comparison;
* a per-layer metric: ``metrics/<metric name>.py``, whose ``read(ctx)``
  returns the number, or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_benchmark(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files read;
    raises KeyError for a name it does not hold."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(HERE, "workloads", f"{name}.json"))["limits"]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
