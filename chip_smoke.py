#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``qsfh_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out results.json] [--profile]

Phases (any failed check raises and the script exits nonzero):

1. Card and build: torch version, device name, ``nvidia-smi`` name and
   power limit; build the CUDA kernels from ``qsfh_torch/csrc/``.
2. Kernels at n = 18 on the real 3x3 term arrays: each kernel against its
   plain PyTorch version on the same inputs (||kernel - plain|| /
   ||plain|| <= 1e-5, float32 rounding), timed with CUDA events after
   warm-up, with its bound: max(bytes / 3.35 TB/s, float32 flops /
   67 TFLOP/s), H100 SXM published peaks.
3. Main path: ``qsfh_torch.algos.adapt.ADAPT`` on the 3x3 Hubbard lattice
   (t=1, U=6, 5 up / 4 down, complex64 on cuda) with the exact 4-state
   ground manifold read from the committed cache: one operator selection
   from the empty ansatz, 5 train steps of the 12-operator ansatz
   (theta = 0.05, Adam lr 1e-2) and one short ``run()``, with every launch
   counter set to 0 just before and read just after.  The same selection
   and steps then run through the plain versions on the card: energy,
   gnorm, Sz, S^2 and fidelity agree at every step (``STEP_TOLERANCES``)
   and the selected operators match as a set.
4. A ``kernels`` JSON line, then the device JSON line, last.

It imports nothing of JAX or of the JAX package ``qsfh_tpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
GROUND_STATE = os.path.join(
    HERE, "benchmarks", "demo_3x3", "ground_state_results",
    "Hubbard-3x3 (t=1, U=6, n_electrons=9) deg4.npz",
)
E_EXACT = -5.562308836311793  # the cached 4-state manifold's energy

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
STATE_RTOL = 1e-5
# kernel path vs plain path, per train step: (metric, rtol, atol); float32
# over 934 rotations a step, at least 10x the differences an H100 shows
STEP_TOLERANCES = (
    ("energy", 1e-4, 0.0),
    ("gnorm", 1e-4, 0.0),
    ("S2", 1e-4, 0.0),
    ("Sz", 0.0, 1e-4),
    ("fidelity", 0.0, 1e-4),
)

TPU_KERNELS = "qsfh_tpu/engine/pallas_kernels.py"
REPLACES = {
    "pauli_rotation": f"{TPU_KERNELS}:482",
    "pauli_apply": f"{TPU_KERNELS}:715",
    "pauli_inner": f"{TPU_KERNELS}:645,927",
    "adjoint_rotation": f"{TPU_KERNELS}:826",
}
# The least float32 arithmetic each function needs per (term, amplitude).
# Rule: a complex multiply is 6 flops and a complex add 2; a factor of
# +-1 or +-i (the parity sign, the phase (-i)^k) is a sign or a swap and
# costs nothing.  Rotation: cos * psi[b] (2) + (+-sin or +-i sin) *
# psi[b^x] (2) + the add (2) = 6.  Inner and apply: one complex product
# (6) and its accumulation (2) = 8.  Adjoint: the inner product (8) and two
# rotations (6 + 6) = 20.
FLOPS_PER_TERM_AMP = {
    "pauli_rotation": 6,
    "pauli_apply": 8,
    "pauli_inner": 8,
    "adjoint_rotation": 20,
}

CONFIG = dict(
    threshold1=1e-2, threshold2=1e-2, x_dimension=3, y_dimension=3, n_electrons=9,
    n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6, degenerate_subspace=4,
    ground_state_path=GROUND_STATE, plot=False, log_metrics=False,
)
N_ANSATZ = 12
N_STEPS = 5


def log(msg):
    print(msg, flush=True)


def rel_err(got, ref):
    import torch

    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def max_abs(got, ref):
    return float((got - ref).abs().max())


def time_cuda(fn, reps, warmup=2):
    """ms per call from CUDA events around ``reps`` calls after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 ------------------------------------------------------------------------


def phase_card():
    import torch

    from qsfh_torch.engine import kernels as K

    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.time()
    so = K.build()
    K._load()
    log(f"built {os.path.relpath(so, HERE)} in {time.time() - t0:.2f} s "
        f"(nvcc {K.build_info.get('seconds', 0.0):.2f} s)")
    for line in K.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return smi


# -- phase 2 ------------------------------------------------------------------------


def phase_kernels(adapt, dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.compiled import CompiledCircuit

    n = adapt.n_qubits
    dim = 1 << n
    p = adapt.problem
    cc = CompiledCircuit(adapt._ansatz_ops(range(N_ANSATZ)) + adapt._net_ops, n,
                         global_phase=adapt._net_phase)
    seg = cc.segments[0]
    thetas = torch.full((N_ANSATZ,), 0.05, dtype=torch.float32, device=dev)
    d = seg.tensors(dev, torch.float32, N_ANSATZ)
    angles = torch.cat([thetas, thetas.new_ones(1)])[d["pidx"]] * d["scale"]
    rot = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
    rot_inv = tuple(a.flip(0) for a in (d["xb"], d["zb"], -angles, d["phre"], d["phim"]))
    T_rot = len(seg)

    gen = torch.Generator(device=dev).manual_seed(0)

    def random_state():
        v = torch.randn(dim, dtype=torch.complex64, device=dev, generator=gen)
        return v / torch.linalg.vector_norm(v)

    psi, w = random_state(), random_state()
    h_xs, h_zs, h_c = p.observables["H"]._tensors(psi)
    s2_xs, s2_zs, _ = p.observables["S^2"]._tensors(psi)
    pool = adapt.packed_pool
    pool_xs, pool_zs, _, _ = pool._tensors(psi)
    log(f"main-path shapes: n={n}, rot segment {T_rot} terms, H {len(h_xs)}, "
        f"S^2 {len(s2_xs)}, pool {pool.size} generators / {len(pool_xs)} terms")

    results = {}

    def record(name, call, T, bytes_moved, errs, ms, plain_ms, library_ms=None):
        flops = FLOPS_PER_TERM_AMP[name] * T * dim
        b_ms, b_by = bound(bytes_moved, flops)
        entry = dict(call=call, terms=T, n=n, rel_err=max(e[0] for e in errs),
                     max_abs_err=max(e[1] for e in errs), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                     bytes=bytes_moved, flops=flops)
        results.setdefault(name, []).append(entry)
        log(f"  {name:16s} {call:28s} T={T:5d} rel_err={entry['rel_err']:.2e} "
            f"(tol {STATE_RTOL:g}) max_abs={entry['max_abs_err']:.2e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by})"
            + ("" if library_ms is None else f" library_ms={library_ms:.4f}"))
        if entry["rel_err"] > STATE_RTOL:
            raise AssertionError(f"{name} ({call}) disagrees with its plain version")

    term_bytes_rot = T_rot * (4 + 4 + 4 + 4 + 4)

    # pauli_rotation: the forward segment and its inverse
    for call, arrs in (("forward ansatz+network", rot), ("inverse (reversed)", rot_inv)):
        got = K.pauli_rotation(psi.clone(), *arrs)
        ref = K.pauli_rotation_plain(psi.clone(), *arrs)
        torch.cuda.synchronize()
        errs = [(rel_err(got, ref), max_abs(got, ref))]
        if call.startswith("inverse"):
            # 934 float32 rotations: expect ~sqrt(934) x 3e-7 ~ 1e-5 drift
            back = K.pauli_rotation(K.pauli_rotation(psi.clone(), *rot), *rot_inv)
            drift = rel_err(back, psi)
            log(f"  pauli_rotation   forward then inverse: ||back - psi|| = {drift:.2e} (tol 1e-4)")
            if drift > 1e-4:
                raise AssertionError("the inverse rotation does not undo the forward one")
        buf = psi.clone()
        ms = time_cuda(lambda: K.pauli_rotation(buf, *arrs), reps=10)
        plain_ms = time_cuda(lambda: K.pauli_rotation_plain(buf, *arrs), reps=2, warmup=1)
        record("pauli_rotation", call, T_rot, 2 * 8 * dim + term_bytes_rot, errs, ms, plain_ms)

    # pauli_apply on H, with a CSR sparse product as the library yardstick
    hargs = (h_xs, h_zs, h_c.real, h_c.imag)
    got = K.pauli_apply(psi, *hargs)
    ref = K.pauli_apply_plain(psi, *hargs)
    torch.cuda.synchronize()
    errs = [(rel_err(got, ref), max_abs(got, ref))]
    ms = time_cuda(lambda: K.pauli_apply(psi, *hargs), reps=20)
    plain_ms = time_cuda(lambda: K.pauli_apply_plain(psi, *hargs), reps=3, warmup=1)
    library_ms = library_sparse_apply(psi, h_xs, h_zs, h_c, ref)
    record("pauli_apply", "lambda = H psi", len(h_xs), 2 * 8 * dim + 16 * len(h_xs), errs,
           ms, plain_ms, library_ms)

    # pauli_inner: expectations (a = psi) and pool screening (a = w)
    for call, a, xs, zs in (
        ("<psi|H|psi> terms", psi, h_xs, h_zs),
        ("<psi|S^2|psi> terms", psi, s2_xs, s2_zs),
        ("pool screening <w|P|psi>", w, pool_xs, pool_zs),
    ):
        got = K.pauli_inner(a, psi, xs, zs)
        ref = K.pauli_inner_plain(a, psi, xs, zs)
        torch.cuda.synchronize()
        errs = [(rel_err(got, ref), max_abs(got, ref))]
        ms = time_cuda(lambda: K.pauli_inner(a, psi, xs, zs), reps=10)
        plain_ms = time_cuda(lambda: K.pauli_inner_plain(a, psi, xs, zs), reps=2, warmup=1)
        n_inputs = 1 if a is psi else 2
        T = len(xs)
        record("pauli_inner", call, T, n_inputs * 8 * dim + T * (8 + 8), errs, ms, plain_ms)

    # adjoint_rotation over the reversed segment, from psi and lambda = 2 H psi
    lam = 2.0 * K.pauli_apply(psi, *hargs)
    adj = tuple(a.flip(0) for a in (d["xb"], d["zb"], angles, d["phre"], d["phim"]))
    p1, l1, p2, l2 = psi.clone(), lam.clone(), psi.clone(), lam.clone()
    got = K.adjoint_rotation(p1, l1, *adj)
    ref = K.adjoint_rotation_plain(p2, l2, *adj)
    torch.cuda.synchronize()
    errs = [(rel_err(got, ref), max_abs(got, ref)), (rel_err(p1, p2), max_abs(p1, p2)),
            (rel_err(l1, l2), max_abs(l1, l2))]
    ms = time_cuda(lambda: K.adjoint_rotation(p1, l1, *adj), reps=10)
    plain_ms = time_cuda(lambda: K.adjoint_rotation_plain(p2, l2, *adj), reps=2, warmup=1)
    record("adjoint_rotation", "gradient sweep", T_rot,
           4 * 8 * dim + term_bytes_rot + 8 * T_rot, errs, ms, plain_ms)
    return results


def library_sparse_apply(psi, xs, zs, c, ref):
    """ms of one ``torch`` CSR sparse matrix-vector product computing H psi
    (a yardstick only; the port never calls it), or None where this
    torch build cannot multiply a complex CSR matrix on the card."""
    import torch

    from qsfh_torch.engine.state import index_bits, parity_signs

    dim = psi.shape[0]
    idx = index_bits(dim.bit_length() - 1, psi.device)
    rows, cols, vals = [], [], []
    for t in range(len(xs)):
        rows.append(idx)
        cols.append(idx ^ xs[t])
        vals.append(c[t] * parity_signs(idx, zs[t], torch.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse support is in beta"
        coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                      torch.cat(vals), (dim, dim)).coalesce()
        csr = coo.to_sparse_csr()
    del coo, rows, cols, vals
    try:
        out = torch.mv(csr, psi)
    except RuntimeError as exc:  # a missing sparse kernel in this torch build
        log(f"  library yardstick unavailable: {str(exc).splitlines()[0]}")
        return None
    if rel_err(out, ref) > STATE_RTOL:
        raise AssertionError("the sparse yardstick disagrees with H psi")
    log(f"  library yardstick: CSR H with {csr.values().numel()} nonzeros")
    return time_cuda(lambda: torch.mv(csr, psi), reps=20)


# -- phase 3 ------------------------------------------------------------------------


def bench_steps(adapt, dev):
    """N_STEPS train steps of the 12-operator ansatz; per-step metrics."""
    import torch

    indices = tuple(range(N_ANSATZ))
    adapt.selected_indices = list(indices)
    adapt.params_t = torch.full((N_ANSATZ,), 0.05, dtype=adapt._rdt, device=dev)
    optimizer = torch.optim.Adam([adapt.params_t], lr=1e-2)
    step = adapt._build_step(indices)
    rows = []
    for i in range(N_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, e, sz, s2, fid, gnorm = step(adapt.params_t, optimizer)
        e, sz, s2, fid, gnorm = map(float, (e, sz, s2, fid, gnorm))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        rows.append(dict(step=i + 1, energy=e, Sz=sz, S2=s2, fidelity=fid, gnorm=gnorm, ms=ms))
    return rows


def check_steps(rows, n_up, n_down, label):
    sz_exact = 0.5 * (n_up - n_down)
    for r in rows:
        log(f"  [{label}] step {r['step']}: E={r['energy']:.7f} Sz={r['Sz']:.3e} "
            f"S^2={r['S2']:.5f} fidelity={r['fidelity']:.6f} gnorm={r['gnorm']:.5f} "
            f"{r['ms']:.2f} ms")
        vals = (r["energy"], r["Sz"], r["S2"], r["fidelity"], r["gnorm"])
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{label}: non-finite step metrics {r}")
        if abs(r["Sz"] - sz_exact) > 1e-4:
            raise AssertionError(f"{label}: Sz drifted from {sz_exact}: {r['Sz']}")
        if not -1e-5 <= r["fidelity"] <= 1 + 1e-5:
            raise AssertionError(f"{label}: fidelity out of [0, 1]: {r['fidelity']}")
        if r["energy"] < E_EXACT - 1e-3:
            raise AssertionError(f"{label}: energy below the exact ground energy")
        if r["gnorm"] <= 0:
            raise AssertionError(f"{label}: zero gradient")


def build_adapt(dev, tmp, name, **extra):
    from qsfh_torch.algos.adapt import ADAPT

    t0 = time.time()
    adapt = ADAPT(n_epoch=1, results_root=os.path.join(tmp, name), device=dev,
                  **CONFIG, **extra)
    log(f"ADAPT 3x3 ({name}) built in {time.time() - t0:.2f} s: {adapt.n_qubits} qubits, "
        f"{len(adapt.fermion_pool)} pool operators, E_exact={adapt.ground_state_energy}")
    return adapt


def timed_select(adapt, label):
    """select_operator() twice from the empty ansatz: the first call pays
    one-time set-up (host-to-device term arrays, lazy CUDA module loads);
    returns the selection and the second call's host-clock ms."""
    import torch

    times, picks = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        picks.append(adapt.select_operator())
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    (selected, grads), again = picks
    if again[0] != selected:
        raise AssertionError(f"{label}: two selections from the same state differ")
    log(f"  [{label}] select_operator: {len(selected)} operators, max |g|={max(grads):.6f}, "
        f"{times[0]:.1f} ms first call, {times[1]:.1f} ms second")
    return selected, grads, times[1]


def phase_main_path(adapt, dev, tmp):
    import torch

    from qsfh_torch.engine import kernels as K

    if adapt.dtype != torch.complex64:
        raise AssertionError(f"expected complex64 on cuda, got {adapt.dtype}")
    results = {}
    K.reset_launch_counts()
    selected, grads, results["select_ms"] = timed_select(adapt, "kernels")
    results["steps"] = bench_steps(adapt, dev)
    check_steps(results["steps"], CONFIG["n_spin_up"], CONFIG["n_spin_down"], "kernels")

    run_adapt = build_adapt(dev, tmp, "run", max_inner_iterations=3)
    t0 = time.perf_counter()
    res = run_adapt.run()
    torch.cuda.synchronize()
    results["run_s"] = time.perf_counter() - t0
    losses = res["iteration loss"]
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"run(): expected 3 finite losses, got {losses}")
    if sorted(run_adapt.selected_indices) != sorted(selected):
        raise AssertionError("run() selected other operators than select_operator()")
    if not os.path.exists(run_adapt.model_filepath):
        raise AssertionError("run() wrote no checkpoint")
    counts = K.launch_counts()
    results["launches"] = counts
    log(f"  run(): {len(run_adapt.selected_indices)} operators, losses {losses}, "
        f"{results['run_s']:.2f} s")
    log(f"  launches on the main path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # the same selection and steps through the plain versions on the card
    plain = build_adapt(dev, tmp, "plain")
    plain.impl = K.PLAIN
    K.reset_launch_counts()
    plain_selected, _, results["plain_select_ms"] = timed_select(plain, "plain")
    results["plain_steps"] = bench_steps(plain, dev)
    check_steps(results["plain_steps"], CONFIG["n_spin_up"], CONFIG["n_spin_down"], "plain")
    if any(K.launch_counts().values()):
        raise AssertionError("the plain path launched a CUDA kernel")
    if set(plain_selected) != set(selected):
        raise AssertionError(f"selection differs: {sorted(selected)} vs {sorted(plain_selected)}")
    for a, b in zip(results["steps"], results["plain_steps"]):
        for key, rtol, atol in STEP_TOLERANCES:
            if abs(a[key] - b[key]) > rtol * abs(b[key]) + atol:
                raise AssertionError(f"step {a['step']}: {key} {a[key]} vs plain {b[key]}")
    log("  plain path: same operators; per step " + ", ".join(
        f"{key} within {rtol:g} relative + {atol:g}" for key, rtol, atol in STEP_TOLERANCES))
    return results


def _device_kernels(prof):
    """(name, count, device us) of every device kernel in a profile."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or "#" in ev.key:
            continue  # a range such as "Optimizer.step#Adam.step", not a kernel
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        rows.append((ev.key, ev.count, us))
    return sorted(rows, key=lambda r: -r[2])


def profile_phase(adapt, step_ms, select_ms, out):
    """Device kernel time by name over 2 train steps and 1 selection
    (torch.profiler); the idle share compares the device kernel time with
    the unprofiled host-clock time of the same work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step = adapt._build_step(tuple(range(N_ANSATZ)))
    optimizer = torch.optim.Adam([adapt.params_t], lr=1e-2)
    step(adapt.params_t, optimizer)
    torch.cuda.synchronize()
    out["profile"] = {}
    for label, reps, fn, ref_ms in (
        ("train step", 2, lambda: step(adapt.params_t, optimizer), step_ms),
        ("selection", 1, lambda: adapt._screen_for(())(adapt.params_t[:0]), select_ms),
    ):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        busy_ms = sum(r[2] for r in rows) / 1e3 / reps
        log(f"profile, {label}: device kernel time {busy_ms:.3f} ms per call against "
            f"{ref_ms:.3f} ms unprofiled: idle share {1 - busy_ms / ref_ms:.3f}")
        for key, count, us in rows[:8]:
            log(f"  {us / 1e3 / reps:9.4f} ms  {count // reps:6d}x  {key[:80]}")
        out["profile"][label] = dict(
            kernel_ms=busy_ms, unprofiled_ms=ref_ms, idle_share=1 - busy_ms / ref_ms,
            rows=[dict(name=k, launches=c // reps, device_ms=u / 1e3 / reps) for k, c, u in rows],
        )


# -- main ---------------------------------------------------------------------------------


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write every measurement to this JSON file")
    parser.add_argument("--profile", action="store_true", help="profile 2 train steps")
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(HERE, "qsfh_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the smoke test runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    smi = phase_card()
    tmp = tempfile.mkdtemp(prefix="qsfh_torch_smoke_")
    adapt = build_adapt(dev, tmp, "kernels")
    log("kernels at the main path's shapes (CUDA events, ms per call):")
    kern = phase_kernels(adapt, dev)
    log("main path:")
    main = phase_main_path(adapt, dev, tmp)
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, kernels=kern,
               main_path=main, torch=torch.__version__)
    step_ms = sorted(r["ms"] for r in main["steps"][1:])
    plain_ms = sorted(r["ms"] for r in main["plain_steps"][1:])
    out["step_ms_median"] = step_ms[len(step_ms) // 2]
    out["plain_step_ms_median"] = plain_ms[len(plain_ms) // 2]
    log(f"main-path train step: {out['step_ms_median']:.2f} ms (median of steps 2-{N_STEPS}), "
        f"plain versions {out['plain_step_ms_median']:.2f} ms; "
        f"selection {main['select_ms']:.1f} ms vs plain {main['plain_select_ms']:.1f} ms")
    if args.profile:
        profile_phase(adapt, out["step_ms_median"], main["select_ms"], out)
    log(f"smoke test took {time.time() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)

    line = []
    for name in ("pauli_rotation", "pauli_apply", "pauli_inner", "adjoint_rotation"):
        entries = kern[name]
        head = max(entries, key=lambda e: e["terms"])  # the heaviest main-path call
        line.append(dict(
            name=name, route="cuda", source="qsfh_torch/csrc/statevec_kernels.cu",
            replaces=REPLACES[name], launches=main["launches"][name],
            max_abs_err=max(e["max_abs_err"] for e in entries), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], call=head["call"],
        ))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
