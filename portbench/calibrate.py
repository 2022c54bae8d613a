#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 2] [--out readings.json]

For each seed: one run of the cell as ``run.py`` makes it (set-up, a
``--seconds`` window, the check against the reference), its compared
numbers (the lower readings); for each control seed besides: the cell's
window's ``controls``, the reference put in the program's place in the
next precision down (``bfloat16`` storage for complex64, ``complex64``
for complex128), and the faults planted in the reference put in the
program's place: a step that returns its state unchanged, and an answer
altered where it is produced (the cotangent without its factor 2, so the
gradient halved).  The benchmark's own runs make none of these.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path[:0] = [HERE, ROOT]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from pb.runner import run_cell  # noqa: E402
from pb.spec import load_cell, load_window  # noqa: E402

# the control's precision: the next one down from the configuration's
CONTROL_STORE = {"complex64": "bfloat16", "complex128": "complex64"}


def controls(cell, seed: int, device, record: dict) -> dict:
    """The control's and the planted faults' numbers at one seed, from the
    record of the cell's run at that seed (``run_cell(..., keep=)``)."""
    return load_window(cell.traffic["window"]).controls(cell, seed, device, record["run"],
                                                        CONTROL_STORE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = dict(workload=args.workload, device=torch.cuda.get_device_name(0) if device == "cuda"
               else "cpu", seeds={})
    for seed in seeds + sorted(control_seeds - set(seeds)):
        t0 = time.time()
        record = {}
        result, _ = run_cell(cell, seed, args.seconds, False, device, keep=record)
        row = dict(program={key: c["value"] for key, c in result["checks"].items()},
                   correct=result["correct"],
                   metrics={key: m["value"] for key, m in result["metrics"].items()})
        if seed in control_seeds:
            row.update(controls(cell, seed, device, record))
        row["seconds"] = time.time() - t0
        out["seeds"][seed] = row
        print(json.dumps({seed: row}), flush=True)
    for kind in ("program", "control", "fault_state_unchanged", "fault_cotangent_half"):
        rows = [r[kind] for r in out["seeds"].values() if kind in r]
        if rows:
            agg = max if kind == "program" else min
            out[kind + ("_max" if kind == "program" else "_min")] = {
                key: agg(r[key] for r in rows) for key in rows[0]}
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
