"""A cell of the benchmark, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration, traffic mix and limits are data files under ``portbench/``
and each per-layer metric a reader of its own, all found by name:

* ``portbench/configs/<config>.json``: the problem, ansatz and seeding;
* ``portbench/traffic/<traffic>.json``: the window a run drives
  (``"window"``) and its parameters;
* ``portbench/windows/<window>.py``: that window: ``run`` (set-up and the
  measured window), ``check`` (the compared numbers against the plain
  reference) and ``controls`` (the readings a limit is set from);
* ``portbench/limits/<workload>.json``: each compared number's limit;
* ``portbench/metrics/<metric>.py``: ``read(ctx)`` of one per-layer
  metric, None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)


def path(rel: str) -> str:
    """A path named relative to the checkout's root."""
    return os.path.join(ROOT, rel)


def _json(p: str) -> dict:
    with open(p) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _module(p: str, mod_name: str):
    """The module of the file ``p``, loaded once under ``mod_name``."""
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, p)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def load_reader(metric: str, metrics_dir: str) -> Callable:
    """``read`` of ``<metrics_dir>/<metric>.py`` (the name may hold dots)."""
    p = os.path.join(metrics_dir, metric + ".py")
    return _module(p, "portbench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def load_window(window: str):
    """The window module ``portbench/windows/<window>.py``."""
    p = os.path.join(HERE, "windows", window + ".py")
    return _module(p, "portbench_window_" + window.replace(".", "_").replace("-", "_"))


def _reports(metric: dict, workload: str, cell_e2e: List[str]) -> bool:
    # a metric without ``workloads`` is reported wherever the end-to-end
    # metric that it moves is
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in cell_e2e


def load_cell(workload: str, bench: dict = None, base: str = None) -> Cell:
    """The cell ``workload`` of ``bench`` (default: the root's
    ``BENCHMARK.json``), its configuration, traffic and limits read from
    ``base`` (default: ``portbench/``; the tests' tiny cells have their
    own), its metric readers from ``portbench/metrics/``."""
    bench = bench if bench is not None else _json(path("BENCHMARK.json"))
    base = base or HERE
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    config = _json(os.path.join(base, "configs", w["config"] + ".json"))
    traffic = _json(os.path.join(base, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(base, "limits", workload + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if m["name"] == "setup_s" or workload in m.get("workloads", [workload])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    metrics_dir = os.path.join(HERE, "metrics")
    readers = {m["name"]: load_reader(m["name"], metrics_dir) for m in per_layer}
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer, readers)
