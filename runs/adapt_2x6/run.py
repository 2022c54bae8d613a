#!/usr/bin/env python3
"""ADAPT-VQE on the 2x6 Hubbard ladder (24 qubits) with the port, on one card.

The settings of the reference study's general ADAPT driver
(``models/adapt_vqe.py``, its ``__main__`` at :470-485: periodic, t = 1,
U = 2, half filling with equal spins, the simplified pool, thresholds
1e-2 / 1e-2, 100 epochs, the per-epoch lr ||g_sel|| / sqrt(N_g) x 0.05)
with ``y_dimension`` 6 in place of 4.  The port's ADAPT driver selects
the operators by their pool gradient, and ``FusedAdaptRunner.run`` trains
each epoch in CUDA-graph chunks of K = 8 Adam steps in complex64, as the
3x3 flagship's convergence run did.

    python3 runs/adapt_2x6/run.py --out DIR [--budget-s 2700]

from the root of a checkout.  First the sector ED (the port's Lanczos in
complex128 on the card): the lowest Ritz values of the (6, 6) sector and
the degenerate ground space at 1e-6, which sets the driver's
``degenerate_subspace``.  Then selection and training epochs until an empty
selection, 100 epochs, or the first epoch to end past ``--budget-s``
seconds.  DIR receives the ED file (``hubbard2x6_gs.npz``: ``energy`` and
the ``wavefunctions`` rows, global phase fixed so the rows are real), the
final model (``adapt2x6_checkpoint.npz``), the driver's results and
per-step metrics (``results/``) and ``summary.json``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


class OutOfTime(Exception):
    """Raised after an epoch's checkpoint once the budget is spent."""


def real_phase(wfs):
    """Each row times the conjugate phase of its largest amplitude."""
    out = []
    for w in wfs:
        w = np.asarray(w, np.complex128)
        j = int(np.argmax(np.abs(w)))
        w = w * (np.conj(w[j]) / abs(w[j]))
        out.append(w)
    return np.stack(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--budget-s", type=float, default=2700.0)
    ap.add_argument("--x-dimension", type=int, default=2)
    ap.add_argument("--y-dimension", type=int, default=6)
    ap.add_argument("--coulomb", type=float, default=2.0)
    ap.add_argument("--n-epoch", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t_start = time.time()

    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.io import checkpoint as ckpt
    from qsfh_torch.linalg.lanczos import (_start_vector, degenerate_ground_space,
                                           device_matrix, lanczos_eigsh, sector_hamiltonian)
    from qsfh_torch.linalg.sectors import sector_dimension
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    dev = torch.device(args.device)
    nx, ny = args.x_dimension, args.y_dimension
    n_sites = nx * ny
    n_up = n_down = n_sites // 2
    settings = dict(x_dimension=nx, y_dimension=ny, tunneling=1.0, coulomb=args.coulomb,
                    n_electrons=n_up + n_down, n_spin_up=n_up, n_spin_down=n_down,
                    periodic=True)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(f"card: {card.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
              flush=True)

    # -- the sector ED: the lowest levels and the degenerate ground space --------------
    t0 = time.time()
    p = HubbardProblem(**{k: settings[k] for k in (
        "x_dimension", "y_dimension", "tunneling", "coulomb", "n_electrons", "n_spin_up",
        "n_spin_down", "periodic")})
    n = p.n_qubits
    mat, _ = sector_hamiltonian(p.qubit_hamiltonian, n, n_up + n_down, n_up, n_down)
    csr = device_matrix(mat, dev)
    dim = sector_dimension(n_up + n_down, n_up, n)
    v0 = _start_vector(dim, 11, torch.complex128, dev)
    ritz, _ = lanczos_eigsh(lambda v: csr @ v, v0, k=min(300, dim), n_eigen=6)
    del csr
    e0, states = degenerate_ground_space(p.qubit_hamiltonian, n, n_up + n_down, n_up, n_down,
                                         n_states=4, degeneracy_tol=1e-6, device=dev)
    wfs = real_phase([s.cpu().numpy() for s in states])
    del states
    deg = len(wfs)
    ed = dict(sector_dimension=dim, ritz_lowest=[float(x) for x in ritz], energy=float(e0),
              degenerate_states=deg, seconds=time.time() - t0)
    print("ED: " + json.dumps(ed), flush=True)
    gs_file = os.path.join(out, "hubbard2x6_gs.npz")
    ckpt.save_ground_state(gs_file, e0, wfs)
    del wfs

    # -- ADAPT: selection by pool gradient, epochs in fused chunks ---------------------
    vqe = ADAPT(n_epoch=args.n_epoch, threshold1=1e-2, threshold2=1e-2,
                pool=hubbard_interaction_pool_simplified(nx, ny), plot=False,
                device=dev, results_root=os.path.join(out, "results"),
                ground_state_path=gs_file, degenerate_subspace=deg if deg > 1 else 0,
                **settings)
    print(f"pool: {len(vqe.fermion_pool)} generators; ED energy {vqe.ground_state_energy}",
          flush=True)
    epoch_log = []
    t_run = time.time()

    def on_epoch_end(i_epoch):
        r = vqe.results
        epoch_log.append(dict(epoch=i_epoch + 1, operators=len(vqe.selected_indices),
                              steps=len(r["iteration loss"]), energy=r["epoch loss"][-1],
                              energy_df=r.get("epoch loss df", [None])[-1],
                              fidelity=r["fidelity"][-1], seconds=time.time() - t_run))
        print("epoch end: " + json.dumps(epoch_log[-1]), flush=True)
        if time.time() - t_start > args.budget_s:
            raise OutOfTime

    runner = FusedAdaptRunner(vqe, chunk_iters=8, max_inner_iterations=10000,
                              on_epoch_end=on_epoch_end)
    stop = "empty selection or n_epoch"
    try:
        runner.run()
        if len(vqe.results["epoch loss"]) >= args.n_epoch:
            stop = f"{args.n_epoch} epochs"
        else:
            stop = "empty selection (the reference's own stop)"
    except OutOfTime:
        stop = f"the budget of {args.budget_s:.0f} s, at the last completed epoch"

    # -- the records -------------------------------------------------------------------
    r = vqe.results
    shutil.copyfile(ckpt.resolve(vqe.model_filepath), os.path.join(out, "adapt2x6_checkpoint.npz"))
    e = r["epoch loss"][-1]
    summary = {
        "config": f"{nx}x{ny} t=1 U={args.coulomb:g} periodic, {n_up} up / {n_down} down, "
                  "simplified pool, thresholds 1e-2 / 1e-2 (reference adapt_vqe.py:470-485, "
                  f"y_dimension {ny})",
        "driver": "qsfh_torch FusedAdaptRunner.run (K = 8 CUDA-graph chunks), complex64",
        "card": card.strip() if card else str(dev),
        "stop": stop,
        "epochs": len(r["epoch loss"]),
        "n_operators": len(vqe.selected_indices),
        "pool_size": len(vqe.fermion_pool),
        "steps": len(r["iteration loss"]),
        "final_energy": e,
        "final_energy_df": r.get("epoch loss df", [None])[-1],
        "ed_energy": vqe.ground_state_energy,
        "error_mHa": 1e3 * (e - vqe.ground_state_energy),
        "fidelity": r["fidelity"][-1],
        "degenerate_subspace": deg,
        "ed": ed,
        "epochs_log": epoch_log,
        "run_seconds": time.time() - t_run,
    }
    if summary["final_energy_df"] is not None:
        summary["error_df_mHa"] = 1e3 * (summary["final_energy_df"] - vqe.ground_state_energy)
    with open(os.path.join(out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "epochs_log"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
