"""The ``lbfgs_polish`` window: the flagship's float64 polish.

Set-up builds the port's ADAPT driver in complex128 at the configured
ansatz, lowers it with ``Rot64Program.from_adapt`` and evaluates twice at
the seeded point.  The window runs scipy's L-BFGS-B on
``value_and_grad`` from that point, as ``polish_fast.py``'s phase A does,
every evaluation appended to a JSONL record (the script's saves of each
improvement are left out: file writes that add noise and no program
work), a fresh start from the last point where the optimizer stops
early.  It
closes at the first evaluation that would start after ``seconds``.  Every
evaluation's angles and answer are kept; a sample drawn from the seed is
checked against the reference after the window.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np

from pb import bounds
from pb.common import Phases, StopWindow, ansatz, build_adapt, reference_for, rel, rng_for

KERNELS = ("rot64_resident", "rot64_groups", "happly64_tiles", "happly64", "adjoint64_resident",
           "adjoint64_groups")


def run(cell, seed: int, seconds: float, trace: bool, device, workdir: str) -> dict:
    phases = Phases()
    import torch
    from scipy.optimize import minimize

    from qsfh_torch.algos.adapt_fused import initial_state
    from qsfh_torch.native.statevec import Rot64Program

    phases.mark("imports")
    cfg, tr = cell.config, cell.traffic
    indices, x0, base = ansatz(cfg, seed)
    vqe = build_adapt(cfg, device, getattr(torch, cfg["polish_dtype"]), workdir, False)
    vqe.selected_indices = list(indices)
    vqe.params_t = torch.as_tensor(base if base is not None else x0, dtype=vqe._rdt,
                                   device=vqe.device)
    phases.mark("driver")
    prog = Rot64Program.from_adapt(vqe)
    psi0 = initial_state(vqe)
    cuda = vqe.device.type == "cuda"
    phases.mark("lowering")
    for _ in range(2):
        prog.value_and_grad(x0, psi0)
    phases.mark("two evaluations")
    timer = None
    if trace and cuda:
        from pb.trace import EventTimer

        timer = prog.impl = EventTimer(prog.impl, KERNELS)
    log_path = os.path.join(workdir, "polish.jsonl")
    st = dict(n=0, xs=[], es=[], gs=[], t0=None, t1=None)
    log = open(log_path, "a")

    def f(x):
        now = time.perf_counter()
        if now - st["t0"] >= seconds:
            st["t1"] = now
            raise StopWindow
        e, g = prog.value_and_grad(x, psi0)
        st["n"] += 1
        st["xs"].append(np.array(x, np.float64))
        st["es"].append(float(e))
        st["gs"].append(np.array(g, np.float64))
        log.write(json.dumps({"eval": st["n"], "E": e, "gnorm": float(np.linalg.norm(g)),
                              "phase": "lbfgs",
                              "elapsed_s": round(now - st["t0"], 3)}) + "\n")
        return e, g

    options = dict(maxiter=1 << 30, maxcor=int(tr["maxcor"]), ftol=float(tr["ftol"]),
                   gtol=float(tr["gtol"]), maxls=int(tr["maxls"]))
    if cuda:
        torch.cuda.synchronize()
    window_start = time.time()
    st["t0"] = time.perf_counter()
    x = x0
    try:
        while True:
            x = minimize(f, x, jac=True, method="L-BFGS-B", options=options).x
    except StopWindow:
        pass
    finally:
        log.close()
    window_s = st["t1"] - st["t0"]
    n = st["n"]
    out = dict(attempted=n, window_start=window_start, window_s=window_s,
               setup_phases=phases.seconds,
               failed=sum(1 for e in st["es"] if not math.isfinite(e)),
               e2e={"polish_evals_per_s": n / window_s})
    ctx = dict(kind="polish", evals=n, window_s=window_s,
               eval_least_s=bounds.polish_eval_least(cfg, len(indices)))
    if cuda:
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if timer is not None:
        from pb.trace import reduce

        dev = timer.intervals()
        ended = {b: name for name, _, b in dev}
        red = reduce(dev, lambda a, b: (
            "between evaluations: L-BFGS-B, the record, the angles' upload and readback"
            if ended.get(a, "").startswith("adjoint")
            else "between kernels of one evaluation (wrapper host work)"))
        ctx.update(red)
        ctx["event_device_s"] = red["busy_s"]
        out["device"] = dict(busy_s=red["busy_s"], window_s=window_s)
        out["breakdown"] = dict(device_ops=red["device_ops"], idle_gaps=red["idle_gaps"])
        prog.impl = timer._impl
    count = min(int(tr["sample_evals"]), n)
    pick = sorted(set(rng_for(seed, 1).choice(n, size=count, replace=False).tolist()) | {0})
    out["program"] = dict(picked=pick, xs=[st["xs"][j] for j in pick],
                          es=[st["es"][j] for j in pick], gs=[st["gs"][j] for j in pick])
    out["ctx"] = ctx
    out["inputs"] = dict(indices=indices)
    del prog, vqe, st, f
    return out


def reference(cfg: dict, inputs: dict, xs, device, store: str = "complex128") -> dict:
    """The reference's answers at the sampled evaluations' angles."""
    ref = reference_for(cfg, device, store)
    es, gs = [], []
    for x in xs:
        e, _, g = ref.value_and_grad(x, inputs["indices"])
        es.append(e)
        gs.append(g)
    return dict(es=es, gs=gs)


def numbers(prog: dict, ref: dict) -> dict:
    """The worst sampled evaluation's relative gap of E, and of the
    gradient (its largest entry's gap over the reference's largest
    entry)."""
    e_gap = max(rel(a, b) for a, b in zip(prog["es"], ref["es"]))
    g_gap = max(float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())
                for a, b in zip(prog["gs"], ref["gs"]))
    out = dict(e_gap=e_gap, g_gap=g_gap)
    return {key: (v if math.isfinite(v) else float("inf")) for key, v in out.items()}


def check(cell, run: dict, device) -> dict:
    """The run's compared numbers against the plain reference."""
    ref = reference(cell.config, run["inputs"], run["program"]["xs"], device)
    return numbers(run["program"], ref)


def controls(cell, seed: int, device, record: dict, stores: dict) -> dict:
    """The control's and the planted faults' numbers at the sampled
    evaluations of one run: the reference one precision down (``stores``
    maps the configuration's dtype to it) in the program's place, the
    first answer returned for every evaluation (a state left unchanged),
    and the gradient halved (the cotangent without its factor 2)."""
    cfg, prog = cell.config, record["program"]
    xs = prog["xs"]
    sound = reference(cfg, record["inputs"], xs, device)
    low = reference(cfg, record["inputs"], xs, device, stores[cfg["polish_dtype"]])
    stale = dict(es=[prog["es"][0]] * len(xs), gs=[prog["gs"][0]] * len(xs))
    half = dict(es=sound["es"], gs=[0.5 * np.asarray(g) for g in sound["gs"]])
    return dict(control=numbers(low, sound), fault_state_unchanged=numbers(stale, sound),
                fault_cotangent_half=numbers(half, sound))
