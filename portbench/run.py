#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process is given.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; its configuration, traffic mix, limits and per-layer
metric readers are files under ``portbench/`` (``README.md`` there).  The
run builds the port's objects from the seed, warms the cell's shapes,
measures for ``--seconds``, checks the window's output against the plain
reference in ``portbench/reference/``, and prints the result as the last
line of standard output (the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``), each compared number beside its limit
as the last lines of standard error.  Without a CUDA device, or with
fewer than the cell asks for, it exits with 3 and prints no result; with
the JAX package or JAX loaded after the window, with 4.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one process with few threads: the host work of a run is serial
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".cache", "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, ".cache", "nv"))
sys.path[:0] = [HERE, ROOT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pb.spec import load_cell

    cell = load_cell(args.workload)
    import qsfh_torch  # noqa: F401  (the program under test: a checkout without it fails here)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    from pb.runner import forbidden_modules, run_cell

    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package are loaded: {loaded}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
