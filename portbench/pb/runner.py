"""One run of one cell: set-up, the window, the check, the result line."""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time

from .spec import load_window

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "qsfh_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
             keep=None):
    """(result dict, compared lines) of one run.  The program's own output
    goes to a log file under the run's temporary directory; ``keep``, a
    dict, receives the run's record as ``"run"``."""
    import torch

    t_enter = time.time()
    t_start = t_enter if t_start is None else t_start
    window = load_window(cell.traffic["window"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        log_path = os.path.join(workdir, "program.log")
        with open(log_path, "a") as fh, contextlib.redirect_stdout(fh):
            run = window.run(cell, seed, seconds, trace, device, workdir)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t_check = time.time()
        nums = window.check(cell, run, device)
        check_s = time.time() - t_check
    if keep is not None:
        keep["run"] = run
    # a number the cell's limits do not name is not compared (PERF.md says why)
    checks = {key: dict(value=v, limit=float(cell.limits[key])) for key, v in nums.items()
              if key in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](run["ctx"])
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=units[m["name"]])
    else:
        metrics = {"setup_s": dict(value=run["window_start"] - t_start, unit="s")}
        for name, v in run["e2e"].items():
            metrics[name] = dict(value=float(v), unit=units[name])
    dev = torch.device(device)
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        count=cell.chips, memory_peak_bytes=int(run.get("memory_peak_bytes", 0)))
    if trace and "device" in run:
        device_info.update(run["device"])
    result = dict(correct=correct, attempted=int(run["attempted"]), failed=int(run["failed"]),
                  metrics=metrics, device=device_info)
    if trace and "breakdown" in run:
        result["breakdown"] = run["breakdown"]
    result["checks"] = checks
    lines = [f"set-up phases (s): process start to the cell {t_enter - t_start:.2f}, " + ", ".join(
        f"{name} {sec:.2f}" for name, sec in run["setup_phases"].items())]
    lines.append(f"reference check {check_s:.2f} s; correct={correct}")
    lines += [f"check {key}: {c['value']!r} (limit {c['limit']!r})" for key, c in checks.items()]
    return result, lines

