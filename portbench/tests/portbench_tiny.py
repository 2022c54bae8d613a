"""The tests' tiny cells: a 2x2 lattice on the CPU in complex128, under
the real BENCHMARK.json's metrics, with limits of their own."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))
CELLS = {"tiny.adapt_train": "adapt_train", "tiny.polish_f64": "polish_f64"}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = copy.deepcopy(json.load(fh))
    for name, traffic in CELLS.items():
        b["workloads"].append(dict(name=name, config="tiny2x2", traffic=traffic, chips=1,
                                   why="test"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.polish_f64" if "polish" in m["name"]
                                  else "tiny.adapt_train")
    return b


def cell(name: str):
    from pb.spec import load_cell

    return load_cell(name, bench(), DATA)
