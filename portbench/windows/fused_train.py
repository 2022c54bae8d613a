"""The ``fused_train`` window: the port's chunked ADAPT inner loop.

Set-up builds the port's ADAPT driver and ``FusedAdaptRunner`` for the
configured ansatz at the seeded angles and starts the runner's own inner
loop (``FusedAdaptRunner._run_inner``: a fresh capturable Adam, the K-step
chunk captured as one CUDA graph, then chunk after chunk, each followed by
the loop's host work: the results read back and appended, the metrics log,
the in-flight checkpoint).  The first ``CHECKED_CHUNKS`` chunks are the
set-up's last steps: their results and the angles after each are what the
reference checks, the second one from the Adam state and angles that the
first replay left on the card.  The window opens as the next chunk starts
and closes at the first chunk that would start after ``seconds``.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

from pb import bounds
from pb.common import Phases, StopWindow, ansatz, build_adapt, reference_for, rel

SPANS = ("replay_readback", "inflight_save")
# the chunks that set-up runs through the window's own call and the check follows
CHECKED_CHUNKS = 2
# the runner as the flagship's convergence run drives it
DISPATCH = "fused"
DF_ENERGY = True


def drive(runner, lr: float, wrap_chunk, wrap_save):
    """Run the runner's inner loop (``_run_inner``) with its chunk callable
    and its in-flight save wrapped: ``wrap_chunk(make, th)`` (``make()``
    builds the chunk) and ``wrap_save(save)`` return what stands in for
    them.  The runner has no public per-chunk seam, so this is the one
    place that reaches into its private methods (``build_chunk`` is
    public; ``_save_inflight`` and ``_run_inner`` are not)."""
    build, save = runner.build_chunk, runner._save_inflight
    runner.build_chunk = lambda th, optimizer, k: wrap_chunk(lambda: build(th, optimizer, k), th)
    runner._save_inflight = wrap_save(save)
    try:
        runner._run_inner(lr, 0)
    except StopWindow:
        pass


def run(cell, seed: int, seconds: float, trace: bool, device, workdir: str) -> dict:
    phases = Phases()
    import torch

    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner
    from qsfh_torch.engine.dfloat import combine_rayleigh

    phases.mark("imports")
    cfg, k = cell.config, int(cell.traffic["chunk_iters"])
    indices, theta0, _ = ansatz(cfg, seed)
    vqe = build_adapt(cfg, device, getattr(torch, cfg["train_dtype"]), workdir, True)
    phases.mark("driver")
    vqe.selected_indices = list(indices)
    vqe.params_t = torch.as_tensor(theta0, dtype=vqe._rdt, device=vqe.device)
    runner = FusedAdaptRunner(vqe, chunk_iters=k, metrics_every_iter=False,
                              max_inner_iterations=1 << 62, verbose=True, dispatch=DISPATCH,
                              df_energy=DF_ENERGY)
    st = dict(calls=0, steps=0, t0=None, t1=None, checked=[], prof=None, window_start=None)
    cuda = vqe.device.type == "cuda"
    phases.mark("runner")

    def span(name):
        return torch.profiler.record_function(name) if trace else contextlib.nullcontext()

    def wrap_chunk(make, th):
        phases.mark("Adam")
        chunk = make()
        phases.mark("capture")

        def timed():
            if st["calls"] < CHECKED_CHUNKS:  # set-up's chunks: the checked steps
                res = chunk()
                # copies: on the CPU the arrays share the chunk's output buffer
                rec = {key: None if v is None else np.array(v) for key, v in res.items()}
                rec["theta"] = th.detach().cpu().numpy().astype(np.float64)
                st["checked"].append(rec)
                st["calls"] += 1
                phases.mark(f"checked chunk {st['calls']}")
                return res
            now = time.perf_counter()
            if st["t0"] is None:
                if cuda:
                    torch.cuda.synchronize()
                st["window_start"] = time.time()
                phases.mark("last checked chunk's host work")
                if trace:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if cuda:
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    st["prof"] = torch.profiler.profile(activities=acts)
                    st["prof"].start()
                st["t0"] = now = time.perf_counter()
            elif now - st["t0"] >= seconds:
                st["t1"] = now
                raise StopWindow
            with span("replay_readback"):
                res = chunk()
            st["steps"] += len(res["energy"])
            st["calls"] += 1
            return res

        return timed

    def wrap_save(save):
        def save_inflight(*args, **kwargs):
            with span("inflight_save"):
                return save(*args, **kwargs)

        return save_inflight

    drive(runner, float(cfg["lr"]), wrap_chunk, wrap_save)
    window_s = st["t1"] - st["t0"]
    out = dict(attempted=st["steps"], window_start=st["window_start"], window_s=window_s,
               setup_phases=phases.seconds)
    losses = vqe.results["iteration loss"]
    out["failed"] = sum(1 for e in losses[CHECKED_CHUNKS * k:] if not math.isfinite(e))
    out["e2e"] = {"train_steps_per_s": st["steps"] / window_s}
    chunks = st["steps"] // k
    least = bounds.train_least(cfg, len(indices), k)
    ctx = dict(kind="train", steps=st["steps"], chunks=chunks, k=k, window_s=window_s,
               chunk_least_s=least["chunk_s"], sweep_least_s=(k + 1) * least["fwd_s"]
               + k * least["adj_s"])
    if cuda:
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if trace:
        from pb.trace import profiler_intervals, reduce, span_label

        st["prof"].stop()
        dev, host = profiler_intervals(st["prof"], SPANS)
        red = reduce(dev, span_label(host, "results append, metrics log (_run_inner)"))
        ctx.update(red)
        out["device"] = dict(busy_s=red["busy_s"], window_s=window_s)
        out["breakdown"] = dict(device_ops=red["device_ops"], idle_gaps=red["idle_gaps"])
        st["prof"] = None
    recs = st["checked"]
    out["program"] = dict(
        energy=[float(e) for r in recs for e in r["energy"]],
        gnorm=[float(g) for r in recs for g in r["gnorm"]],
        Sz=[float(r["Sz"][-1]) for r in recs], S2=[float(r["S2"][-1]) for r in recs],
        fidelity=[float(r["fidelity"][-1]) for r in recs],
        e_df=[float(combine_rayleigh(r["df"])) for r in recs], theta=[r["theta"] for r in recs])
    out["ctx"] = ctx
    out["inputs"] = dict(indices=indices, theta0=theta0, lr=float(cfg["lr"]), k=k)
    del runner, vqe, st
    return out


def reference(cfg: dict, inputs: dict, device, store: str = "complex128", ref=None) -> dict:
    """The reference's checked chunks from the same angles and a fresh
    Adam (``ref``: a reference to use in place of the configuration's)."""
    ref = ref or reference_for(cfg, device, store)
    return ref.train(inputs["theta0"], inputs["indices"], inputs["lr"], inputs["k"],
                     CHECKED_CHUNKS)


def moved(g1) -> np.ndarray:
    """The angles whose change is compared: those whose first gradient in
    the reference is at least a thousandth of the median angle's, the
    median taken over the angles above the float64 rounding floor (1e-12
    of the largest).  Adam moves an angle whose gradient is nought to
    rounding (a symmetry's) by round-off alone, and where most angles are
    such the plain median is itself rounding."""
    g1 = np.abs(g1)
    live = g1[g1 > 1e-12 * g1.max()]
    return g1 >= 1e-3 * np.median(live)


def numbers(prog: dict, ref: dict, theta0, fidelity: bool) -> dict:
    """The compared numbers of the checked chunks, each the worst over
    them: the worst step's relative gap of E and ||g||, the gaps of Sz,
    S^2 (and the fidelity) at each chunk's end, the relative gap of each
    chunk's float64 readout, and of the angles' change from theta0 after
    each chunk (over the ``moved`` angles): the gap of its norm and the
    norm of the angles' difference, both over the reference's change."""
    keep = moved(ref["g1"])
    theta0 = np.asarray(theta0, np.float64)[keep]
    norm_gaps, diff_gaps = [], []
    for th_p, th_r in zip(prog["theta"], ref["theta"]):
        d_ref = th_r[keep] - theta0
        d_prog = np.asarray(th_p, np.float64)[keep] - theta0
        n_ref = float(np.linalg.norm(d_ref))
        norm_gaps.append(rel(float(np.linalg.norm(d_prog)), n_ref))
        diff_gaps.append(float(np.linalg.norm(d_prog - d_ref)) / n_ref)
    pairs = dict(loss_gap=("energy", rel), gnorm_gap=("gnorm", rel),
                 sz_gap=("Sz", _abs), s2_gap=("S2", _abs), e_df_gap=("e_df", rel))
    if fidelity:
        pairs["fidelity_gap"] = ("fidelity", _abs)
    out = {key: max(f(a, b) for a, b in zip(prog[name], ref[name]))
           for key, (name, f) in pairs.items()}
    out.update(dtheta_norm_gap=max(norm_gaps), theta_gap=max(diff_gaps))
    return {key: (v if math.isfinite(v) else float("inf")) for key, v in out.items()}


def _abs(a: float, b: float) -> float:
    return abs(a - b) if math.isfinite(a) else float("inf")


def check(cell, run: dict, device) -> dict:
    """The run's compared numbers against the plain reference."""
    cfg = cell.config
    ref = reference(cfg, run["inputs"], device)
    return numbers(run["program"], ref, run["inputs"]["theta0"],
                   fidelity=bool(cfg.get("ground_states")))


def controls(cell, seed: int, device, record: dict, stores: dict) -> dict:
    """The control's and the planted faults' numbers at one seed: the
    reference in the program's place one precision down (``stores`` maps
    the configuration's dtype to it), with its state left unchanged (lr
    0), and with its gradient halved (the cotangent without its factor 2);
    and how many angles ``moved`` leaves out, with their largest first
    gradient against the median's."""
    from pb.common import half_gradient

    cfg = cell.config
    inputs = record["inputs"]
    fid = bool(cfg.get("ground_states"))
    ref = reference_for(cfg, device)
    sound = reference(cfg, inputs, device, ref=ref)
    theta0 = inputs["theta0"]
    low = reference(cfg, inputs, device, stores[cfg["train_dtype"]])
    unchanged = reference(cfg, dict(inputs, lr=0.0), device, ref=ref)
    half = reference(cfg, inputs, device, ref=half_gradient(ref))
    g1 = np.abs(sound["g1"])
    out_idx = ~moved(g1)
    return dict(control=numbers(low, sound, theta0, fid),
                fault_state_unchanged=numbers(unchanged, sound, theta0, fid),
                fault_cotangent_half=numbers(half, sound, theta0, fid),
                left_out=dict(count=int(out_idx.sum()), of=int(g1.size),
                              largest_g=float(g1[out_idx].max()) if out_idx.any() else 0.0,
                              median_g=float(np.median(g1))))
