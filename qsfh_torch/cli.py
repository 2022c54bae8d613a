"""Command-line entry points for every driver of the port.

Counterpart of ``qsfh_tpu/cli.py``: the same subcommands, arguments,
defaults, printed lines and JSON files (``dynamics.json``, ``ite.json``,
``spectral.json`` in the working directory), calling the port's drivers:

    python -m qsfh_torch.cli hva   --x-dimension 2 --y-dimension 2 --n-epoch 200
    python -m qsfh_torch.cli adapt --x-dimension 3 --y-dimension 3 --degenerate-subspace 4
    python -m qsfh_torch.cli iqcc  --molecule LiH --r 1.6
    python -m qsfh_torch.cli hea   --molecule H2 --r 0.8 --reps 5
    python -m qsfh_torch.cli ed    --x-dimension 2 --y-dimension 2 --device cpu --x64

(or ``qsfh-torch <subcommand> ...`` once the package is installed).

Deviations from the JAX CLI:

* ``--device {cuda,cpu}`` (default ``cuda``, the card) replaces
  ``--platform {tpu,cpu,default}``; with no card the default raises, as
  ``resolve_device`` does: a run never carries on on the CPU unasked.
* ``--x64`` keeps its JAX meaning: on the card the states stay complex64
  (the kernels' dtype, as the JAX package keeps complex64 on its
  accelerator) and a line says so; on the CPU the states are complex128
  with ``--x64`` and complex64 without it.
* ``hva`` and ``adapt`` with ``--mesh-devices D > 1`` start D ranks of a
  ``torch.distributed`` group (``qsfh_torch.parallel.spawn_ranks``), each
  running the subcommand on its shard of the state; ``--dist-backend``
  names the group's backend: ``nccl`` (the default; one card a rank) or
  ``gloo`` (every rank on ``--device``, the exchanges staged through the
  host).  Rank 0 alone prints and writes the results.  ``multistart
  --mesh-devices D > 1`` spawns D ranks the same way over its start axis
  (any D that divides ``--n-starts``): each rank trains its rows of the
  batch, and rank 0 prints the gathered result.

No global state is set: the dtype and device go to each driver
explicitly, so ``main`` may run several times in one process.
"""

from __future__ import annotations

import argparse
import sys

MOLECULES = ("H2", "HeH_Ion", "LiH", "BeH2", "H2O", "H4", "H6")
SHARD_HELP = ("D > 1 starts D ranks, each holding 1/D of the state (a power of two; "
              "--dist-backend names the process group's backend)")


def _add_lattice_args(p: argparse.ArgumentParser):
    p.add_argument("--x-dimension", type=int, default=2)
    p.add_argument("--y-dimension", type=int, default=2)
    p.add_argument("--tunneling", type=float, default=1.0)
    p.add_argument("--coulomb", type=float, default=6.0)
    p.add_argument("--n-electrons", type=int, default=None, help="default: half filling")
    p.add_argument("--n-spin-up", type=int, default=None)
    p.add_argument("--n-spin-down", type=int, default=None)
    p.add_argument("--open-boundary", action="store_true", help="non-periodic lattice")


def _add_run_args(p: argparse.ArgumentParser):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the run goes (replaces the JAX CLI's --platform): the card, "
                        "or the CPU on request; with no card the default raises")
    p.add_argument("--x64", action="store_true",
                   help="complex128 states on the CPU; on the card the states stay complex64, "
                        "the kernels' dtype (as JAX keeps complex64 on its accelerator)")
    p.add_argument("--results-root", default="./results")
    p.add_argument("--load-model", action="store_true")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--degenerate-subspace", type=int, default=0)


def _add_shard_args(p: argparse.ArgumentParser):
    p.add_argument("--mesh-devices", type=int, default=1,
                   help=f"amplitude-shard the statevector over this many devices; {SHARD_HELP}")
    _add_backend_arg(p)


def _add_backend_arg(p: argparse.ArgumentParser):
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default="nccl",
                   help="the process group's backend with --mesh-devices > 1: nccl (one card a "
                        "rank) or gloo (every rank on --device, exchanges through the host)")


def build_parser():
    """(the parser, the multistart subparser whose defaults the
    ``--molecule`` warning reads)."""
    parser = argparse.ArgumentParser(prog="qsfh_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("hva", help="Hamiltonian-variational-ansatz VQE")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--n-epoch", type=int, default=1000)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--threshold", type=float, default=1e-2)
    p.add_argument("--early-stop", action="store_true")
    _add_shard_args(p)

    p = sub.add_parser("adapt", help="ADAPT-VQE with pool screening")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--n-epoch", type=int, default=100)
    _add_shard_args(p)
    p.add_argument("--threshold1", type=float, default=1e-2)
    p.add_argument("--threshold2", type=float, default=1e-2)
    p.add_argument(
        "--pool", default="simplified", choices=("simplified", "extended", "same-spin"),
        help="operator pool: the reference's opposite-spin ZS scattering (simplified, "
             "default), plus-same-spin (extended; simplified prefix keeps old checkpoints "
             "resumable), or same-spin only",
    )
    p.add_argument(
        "--max-inner-iterations", type=int, default=10000,
        help="cap on inner optimization steps per epoch (growth proceeds even when the "
             "gradient-norm threshold is not reached)",
    )

    p = sub.add_parser("iqcc", help="iterative QCC with Hamiltonian dressing")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--molecule", default=None, help="use a molecule instead of the lattice")
    p.add_argument("--r", type=float, default=1.0, help="bond length (Angstrom)")
    p.add_argument("--n-epoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--threshold", type=float, default=5e-3)
    p.add_argument("--max-terms", type=int, default=None)
    p.add_argument(
        "--compaction-eps", type=float, default=None,
        help="per-epoch operator-norm budget for dropping small dressed terms (rigorous "
             "cumulative eigenvalue-shift bound)",
    )
    p.add_argument(
        "--dense-dressing", action="store_true",
        help="EXACT dense-matrix dressing (<=14 qubits): term growth becomes a non-issue; "
             "see ops/dense_dressing.py",
    )
    p.add_argument(
        "--inner-optimizer", choices=("adam", "lbfgs"), default="adam",
        help="epoch-subproblem optimizer: adam (reference parity) or lbfgs with linesearch",
    )
    p.add_argument(
        "--ilc", action="store_true",
        help="iQCC-ILC boost folds after each epoch (requires --dense-dressing): "
             "anticommuting-subset subspace diagonalization (ops/ilc.py)",
    )
    p.add_argument("--ilc-cap", type=int, default=32,
                   help="max anticommuting generators per ILC fold")
    p.add_argument("--ilc-rounds", type=int, default=2, help="ILC folds per epoch")

    p = sub.add_parser("hea", help="hardware-efficient-ansatz molecular VQE")
    _add_run_args(p)
    p.add_argument("--molecule", default="H2")
    p.add_argument("--r", type=float, default=0.8)
    p.add_argument("--n-epoch", type=int, default=100)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--threshold", type=float, default=2e-3)

    p = sub.add_parser("vqd", help="variational quantum deflation (excited states)")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--molecule", default=None, help="molecular mode (HEA ansatz)")
    p.add_argument("--r", type=float, default=0.8)
    p.add_argument("--n-levels", type=int, default=2)
    p.add_argument("--n-epoch", type=int, default=300)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--beta", type=float, default=5.0)
    p.add_argument("--threshold", type=float, default=1e-4)

    p = sub.add_parser("dynamics", help="real-time Trotter quench dynamics")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--dt", type=float, default=0.02)
    p.add_argument("--t-final", type=float, default=2.0)
    p.add_argument("--order", type=int, default=2, choices=[1, 2])
    p.add_argument("--initial", choices=["neel", "slater"], default="slater",
                   help="quench start: Neel product state or the non-interacting Slater "
                        "determinant")
    p.add_argument("--u-final", type=float, default=None,
                   help="linearly ramp U from the static --coulomb to this value over "
                        "[0, t-final] (midpoint-sampled ScheduledEvolution instead of a "
                        "fixed-H quench)")

    p = sub.add_parser("ite", help="imaginary-time evolution ground-state solver")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--dbeta", type=float, default=None,
                   help="imaginary-time step (default: stable choice from the Pauli 1-norm "
                        "spectral bound)")
    p.add_argument("--order", type=int, default=4, help="Taylor order")
    p.add_argument("--n-steps", type=int, default=2000)
    p.add_argument("--block", type=int, default=50)
    p.add_argument("--variance-tol", type=float, default=1e-8,
                   help="stop when the energy variance <H^2>-<H>^2 drops below this "
                        "(ED-free convergence certificate)")
    p.add_argument("--initial", choices=["neel", "slater"], default="slater")

    p = sub.add_parser("ed", help="exact diagonalization (sector Lanczos)")
    _add_lattice_args(p)
    _add_run_args(p)

    p = sub.add_parser(
        "symmetry", help="point-group irrep + momentum analysis of the exact ground state")
    _add_lattice_args(p)
    _add_run_args(p)

    p = sub.add_parser(
        "spectral",
        help="Lanczos-resolvent spectroscopy: A(k,omega) / S(q,omega) / N(q,omega)")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--kind", choices=["particle", "hole", "spin", "charge"],
                   default="particle",
                   help="particle/hole: single-particle A(k, omega) from the momentum ladder "
                        "c(dag)_k,up; spin/charge: dynamical structure factor from S^z_q / n_q")
    p.add_argument("--kx", type=int, default=0)
    p.add_argument("--ky", type=int, default=0)
    p.add_argument("--m", type=int, default=80, help="Krylov depth")
    p.add_argument("--eta", type=float, default=0.1,
                   help="Lorentzian broadening of the returned A(omega) grid")
    p.add_argument("--omega-min", type=float, default=-10.0)
    p.add_argument("--omega-max", type=float, default=10.0)
    p.add_argument("--omega-points", type=int, default=201)

    p = sub.add_parser(
        "multistart",
        help="batched multistart HVA: B random inits trained together as the rows of one "
             "tensor")
    _add_lattice_args(p)
    _add_run_args(p)
    p.add_argument("--n-starts", type=int, default=8)
    p.add_argument("--n-epoch", type=int, default=300)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument(
        "--init-scale", type=float, default=0.1,
        help="HVA-only init stddev; ignored with --molecule (HEA always draws "
             "uniform(-pi,pi) like the reference)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard the start axis over this many devices (data parallelism): "
                        "D > 1 starts D ranks, each training n-starts / D of the starts")
    _add_backend_arg(p)
    p.add_argument("--molecule", default=None,
                   help="run a B-start HEA on this molecule instead of the lattice HVA")
    p.add_argument("--r", type=float, default=0.8, help="bond length [angstrom]")
    return parser, p


def _lattice_kwargs(args) -> dict:
    n_sites = args.x_dimension * args.y_dimension
    n_e = args.n_electrons if args.n_electrons is not None else n_sites
    n_up = args.n_spin_up if args.n_spin_up is not None else (n_e + 1) // 2
    n_dn = args.n_spin_down if args.n_spin_down is not None else n_e - n_up
    return dict(
        x_dimension=args.x_dimension,
        y_dimension=args.y_dimension,
        tunneling=args.tunneling,
        coulomb=args.coulomb,
        n_electrons=n_e,
        n_spin_up=n_up,
        n_spin_down=n_dn,
        periodic=not args.open_boundary,
    )


def _make_molecule(name: str, r: float):
    import qsfh_torch.molecules as mols

    factory = getattr(mols, name, None)
    if factory is None:
        raise SystemExit(f"unknown molecule {name!r}; available: {' '.join(MOLECULES)}")
    return factory(r)


def _backend(args):
    """(device, state dtype) of a run; raises where the card is asked for
    and missing."""
    import torch

    from .engine.state import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        if args.x64:
            print("--x64: the states stay complex64 on the card (the kernels' dtype), as the "
                  "JAX package keeps complex64 on its accelerator")
        return dev, torch.complex64
    return dev, torch.complex128 if args.x64 else torch.complex64


def _initial_state(problem, initial: str, lat: dict, dtype, dev):
    """The quench / ITE start: the non-interacting Slater determinant or
    the Neel basis state."""
    if initial == "slater":
        from .engine.circuits import slater_prep_state

        return slater_prep_state(
            problem.n_qubits,
            tuple(problem.spin_up_indices + problem.spin_down_indices),
            problem.diagonal,
            problem.decomposition,
            dtype=dtype,
            device=dev,
        )
    from .algos.dynamics import neel_occupied
    from .engine.state import basis_state

    occ = neel_occupied(lat["x_dimension"], lat["y_dimension"])
    return basis_state(problem.n_qubits, occ, dtype=dtype, device=dev)


def _ground_state(problem, args, dev):
    """(energy, the first state of the exact ground manifold, host array)."""
    import numpy as np

    if args.degenerate_subspace:
        energy, states = problem.ground_state(
            degenerate=True, n_states=args.degenerate_subspace, device=dev)
        return energy, np.asarray(states[0])
    energy, psi0 = problem.ground_state(device=dev)
    return energy, np.asarray(psi0)


def _rank_main(mesh, argv):
    """One rank of a sharded ``hva`` / ``adapt`` / ``multistart`` run."""
    return main(argv)


def main(argv=None):
    """Runs one subcommand; ``multistart`` returns its result dict (on
    several ranks rank 0's, which every rank shares)."""
    parser, multistart_parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if args.command in ("hva", "adapt", "multistart") and args.mesh_devices > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            from .parallel import spawn_ranks

            if args.command == "multistart":
                if args.n_starts % args.mesh_devices:
                    raise SystemExit(f"--mesh-devices {args.mesh_devices} must divide "
                                     f"--n-starts {args.n_starts}")
            elif args.mesh_devices & (args.mesh_devices - 1):
                raise SystemExit(f"--mesh-devices {args.mesh_devices}: a power of two")
            return spawn_ranks(_rank_main, args.mesh_devices, backend=args.dist_backend,
                               device=args.device, args=(argv,))[0]
    dev, dtype = _backend(args)

    if args.command == "hva":
        from .algos.hva import HVA

        vqe = HVA(
            n_epoch=args.n_epoch,
            reps=args.reps,
            lr=args.lr,
            threshold=args.threshold,
            early_stop=args.early_stop,
            load_model=args.load_model,
            degenerate_subspace=args.degenerate_subspace,
            results_root=args.results_root,
            plot=not args.no_plot,
            dtype=dtype,
            device=dev,
            mesh_devices=args.mesh_devices,
            **_lattice_kwargs(args),
        )
        vqe.run()
    elif args.command == "adapt":
        from .algos.adapt import ADAPT
        from .ops import pool as pool_mod

        pool = None
        if args.pool != "simplified":
            builder = {
                "extended": pool_mod.hubbard_interaction_pool_extended,
                "same-spin": pool_mod.hubbard_interaction_pool_same_spin,
            }[args.pool]
            pool = builder(args.x_dimension, args.y_dimension)
        vqe = ADAPT(
            n_epoch=args.n_epoch,
            threshold1=args.threshold1,
            threshold2=args.threshold2,
            pool=pool,
            max_inner_iterations=args.max_inner_iterations,
            load_model=args.load_model,
            degenerate_subspace=args.degenerate_subspace,
            results_root=args.results_root,
            plot=not args.no_plot,
            dtype=dtype,
            device=dev,
            mesh_devices=args.mesh_devices,
            **_lattice_kwargs(args),
        )
        vqe.run()
    elif args.command == "multistart":
        import numpy as np

        from .algos.multistart import MultistartHEA, MultistartHVA

        if args.molecule:
            # Lattice geometry flags and --init-scale shape the HVA path only;
            # MultistartHEA draws uniform(-pi, pi) inits over the molecular
            # HEA ansatz, so flag values other than the parser's defaults
            # would be silently dead: warn instead
            import warnings

            _hva_only = (
                "x_dimension", "y_dimension", "tunneling", "coulomb",
                "n_electrons", "n_spin_up", "n_spin_down", "open_boundary",
                "init_scale", "results_root", "degenerate_subspace",
            )
            _ignored = [
                k for k in _hva_only
                if getattr(args, k) != multistart_parser.get_default(k)
            ]
            if _ignored:
                warnings.warn(
                    "multistart --molecule uses the HEA ansatz with uniform(-pi, pi) "
                    f"starts; these HVA-only flags are ignored: {', '.join(sorted(_ignored))}",
                    stacklevel=1,
                )
            ms = MultistartHEA(
                _make_molecule(args.molecule, args.r),
                n_starts=args.n_starts,
                n_epoch=args.n_epoch,
                reps=args.reps,
                lr=args.lr,
                seed=args.seed,
                dtype=dtype,
                mesh_devices=args.mesh_devices,
                device=dev,
            )
            ref_key, ref_label = "fci_energy", "FCI"
        else:
            ms = MultistartHVA(
                n_starts=args.n_starts,
                n_epoch=args.n_epoch,
                reps=args.reps,
                lr=args.lr,
                init_scale=args.init_scale,
                seed=args.seed,
                results_root=args.results_root,
                dtype=dtype,
                mesh_devices=args.mesh_devices,
                device=dev,
                **_lattice_kwargs(args),
            )
            ref_key, ref_label = "ground_state_energy", "ED"
        out = ms.run()
        from .parallel.comm import rank

        if rank() != 0:  # rank 0 alone prints the gathered result
            return out
        print(
            f"multistart: {args.n_starts} starts x {args.n_epoch} epochs | "
            f"best start {out['best_index']} energy {out['best_energy']:.8f}"
            + (
                f" (gap {out['best_gap']:.3e} vs {ref_label} {out[ref_key]:.8f})"
                if "best_gap" in out
                else ""
            )
        )
        spread = out["final_energies"]
        print(
            f"final energies: min {spread.min():.8f} median "
            f"{float(np.median(spread)):.8f} max {spread.max():.8f}"
        )
        return out
    elif args.command == "iqcc":
        from .algos.iqcc import IQCC

        if args.molecule:
            problem = _make_molecule(args.molecule, args.r)
            tag = f"iqcc-{args.molecule}"
        else:
            from .ops.lattice import fermi_hubbard

            lat = _lattice_kwargs(args)
            problem = fermi_hubbard(
                lat["x_dimension"],
                lat["y_dimension"],
                lat["tunneling"],
                lat["coulomb"],
                periodic=lat["periodic"],
            )
            tag = f"iqcc-hubbard-{lat['x_dimension']}x{lat['y_dimension']}"
        vqe = IQCC(
            problem,
            n_epoch=args.n_epoch,
            lr=args.lr,
            threshold=args.threshold,
            max_terms=args.max_terms,
            compaction_eps=args.compaction_eps,
            dense_dressing=args.dense_dressing,
            ilc=args.ilc,
            ilc_cap=args.ilc_cap,
            ilc_rounds=args.ilc_rounds,
            inner_optimizer=args.inner_optimizer,
            results_root=args.results_root,
            tag=tag,
            plot=not args.no_plot,
            load_model=args.load_model,
            dtype=dtype,
            device=dev,
        )
        vqe.run()
    elif args.command == "hea":
        from .algos.hea import VQE

        vqe = VQE(
            _make_molecule(args.molecule, args.r),
            n_epoch=args.n_epoch,
            reps=args.reps,
            lr=args.lr,
            threshold=args.threshold,
            results_root=args.results_root,
            plot=not args.no_plot,
            dtype=dtype,
            device=dev,
        )
        vqe.run()
    elif args.command == "vqd":
        from .algos.vqd import VQD

        if args.molecule:
            vqd = VQD(
                _make_molecule(args.molecule, args.r),
                n_levels=args.n_levels,
                n_epoch=args.n_epoch,
                reps=args.reps,
                lr=args.lr,
                beta=args.beta,
                threshold=args.threshold,
                results_root=args.results_root,
                tag=f"VQD-{args.molecule}",
                dtype=dtype,
                device=dev,
            )
        else:
            # lattice mode: deflation over the momentum-conserving HVA ansatz
            # walks the excited states of the symmetric sector; each level
            # starts from normal(0, 0.05) angles drawn from its generator
            import torch

            from .algos.hva import HVA

            lat = _lattice_kwargs(args)
            hva = HVA(
                n_epoch=0, reps=args.reps, lr=args.lr, results_root=args.results_root,
                plot=False, log_metrics=False, ground_truth=False, dtype=dtype, device=dev,
                **lat,
            )

            def init(generator, _p=hva.params):
                return {
                    k: 0.05 * torch.randn(v.shape, generator=generator, dtype=torch.float64)
                    for k, v in _p.items()
                }

            vqd = VQD(
                hva.problem.fermion_hamiltonian,
                n_qubits=hva.n_qubits,
                n_levels=args.n_levels,
                n_epoch=args.n_epoch,
                reps=args.reps,  # identifies the run's artifacts
                lr=args.lr,
                beta=args.beta,
                threshold=args.threshold,
                results_root=args.results_root,
                tag=f"VQD-HVA-{lat['x_dimension']}x{lat['y_dimension']}",
                circuit=hva.circuit,
                init_params=init,
                dtype=dtype,
                device=dev,
            )
        energies = vqd.run()
        print("VQD energies:", energies)
    elif args.command == "dynamics":
        import json

        from .algos.base import HubbardProblem
        from .algos.dynamics import TrotterEvolution
        from .engine.expectation import Observable
        from .ops.jw import jordan_wigner

        lat = _lattice_kwargs(args)
        problem = HubbardProblem(results_root=args.results_root, **lat)
        n = problem.n_qubits
        if args.initial == "neel":
            from .algos.dynamics import neel_occupied

            occ = neel_occupied(lat["x_dimension"], lat["y_dimension"])
            n_up = sum(1 for q in occ if q % 2 == 0)
            if (lat["n_electrons"], lat["n_spin_up"]) != (len(occ), n_up):
                raise SystemExit(
                    "--initial neel fixes the sector to half filling with "
                    f"{n_up} up / {len(occ) - n_up} down on this lattice; "
                    "pass matching --n-electrons/--n-spin-up/--n-spin-down "
                    "or use --initial slater"
                )
        psi0 = _initial_state(problem, args.initial, lat, dtype, dev)
        n_steps = int(round(args.t_final / args.dt))
        obs = {
            "H": problem.observables["H"],
            "double_occupancy_U": Observable(jordan_wigner(problem.interacting_term), n),
            "Sz": problem.observables["Sz"],
        }
        if args.u_final is not None:
            from .algos.dynamics import ScheduledEvolution

            u0, u1, tf = float(problem.coulomb), args.u_final, args.t_final
            ev = ScheduledEvolution(problem, dt=args.dt, order=args.order, dtype=dtype,
                                    device=dev)
            _, rec = ev.evolve(
                psi0, n_steps, obs, coulomb=lambda tau: u0 + (u1 - u0) * tau / tf
            )
            rec.pop("shift_phase")  # no overlap records to unfold
        else:
            ev = TrotterEvolution(problem, dt=args.dt, order=args.order, dtype=dtype,
                                  device=dev)
            _, rec = ev.evolve(psi0, n_steps, obs)
        out = {
            "dt": args.dt,
            "order": args.order,
            "initial": args.initial,
            "u_final": args.u_final,
            "times": [round((i + 1) * args.dt, 10) for i in range(n_steps)],
            **{k: [float(v) for v in series] for k, series in rec.items()},
        }
        os_path = "dynamics.json"
        with open(os_path, "w") as fh:
            json.dump(out, fh)
        print(json.dumps({k: (v[-1] if isinstance(v, list) else v)
                          for k, v in out.items() if k != "times"}))
        print(f"wrote {os_path} ({n_steps} steps)")
    elif args.command == "ite":
        import json

        from .algos.base import HubbardProblem
        from .algos.ite import ImaginaryTimeEvolution

        lat = _lattice_kwargs(args)
        problem = HubbardProblem(results_root=args.results_root, **lat)
        psi0 = _initial_state(problem, args.initial, lat, dtype, dev)
        ite = ImaginaryTimeEvolution(
            problem, dbeta=args.dbeta, order=args.order, dtype=dtype, device=dev
        )
        _, rec = ite.run(
            psi0,
            n_steps=args.n_steps,
            block=args.block,
            variance_tol=args.variance_tol,
            verbose=True,
        )
        out = {
            "dbeta": ite.dbeta,
            "order": args.order,
            "initial": args.initial,
            "steps": int(len(rec["energies"])),
            "energy": float(rec["energies"][-1]),
            "variance": float(rec["variances"][-1]),
        }
        with open("ite.json", "w") as fh:
            json.dump(out, fh)
        print(json.dumps(out))
    elif args.command == "ed":
        from .algos.base import HubbardProblem

        lat = _lattice_kwargs(args)
        problem = HubbardProblem(results_root=args.results_root, **lat)
        if args.degenerate_subspace:
            energy, states = problem.ground_state(
                degenerate=True, n_states=args.degenerate_subspace, device=dev
            )
            print(f"ground energy: {energy}  (degenerate subspace of {len(states)})")
        else:
            energy, _ = problem.ground_state(device=dev)
            print(f"ground energy: {energy}")
    elif args.command == "symmetry":
        import json

        from .algos.base import HubbardProblem
        from .linalg.symmetry import momentum_weights, symmetry_adapted_states

        lat = _lattice_kwargs(args)
        problem = HubbardProblem(results_root=args.results_root, **lat)
        energy, psi0 = _ground_state(problem, args, dev)
        nx, ny = lat["x_dimension"], lat["y_dimension"]
        out = {"energy": energy}
        if args.open_boundary:
            # the site maps wrap periodically; on an open lattice neither
            # the wrapped rotation nor the translations commute with H
            out["note"] = "symmetry analysis requires a periodic lattice"
        else:
            if nx == ny:
                _, norms = symmetry_adapted_states(psi0, nx, ny, device=dev)
                out["c4_irrep_norms"] = {k: round(v, 8) for k, v in norms.items()}
            out["momentum_weights"] = {
                f"({kx},{ky})": round(w, 8)
                for (kx, ky), w in momentum_weights(psi0, nx, ny, device=dev).items()
                if w > 1e-10
            }
        print(json.dumps(out, indent=1))
    elif args.command == "spectral":
        import json

        import numpy as np

        from .algos.base import HubbardProblem
        from .linalg.spectral import dynamical_structure_factor, spectral_function_lanczos

        lat = _lattice_kwargs(args)
        problem = HubbardProblem(results_root=args.results_root, **lat)
        energy, gs = _ground_state(problem, args, dev)
        omegas = np.linspace(args.omega_min, args.omega_max, args.omega_points)
        if args.kind in ("spin", "charge"):
            res = dynamical_structure_factor(
                problem, gs, float(energy), q=(args.kx, args.ky),
                kind=args.kind, m=args.m, omegas=omegas, eta=args.eta,
                dtype=dtype, device=dev,
            )
        else:
            from .ops.correlations import _momentum_sum
            from .ops.fermion import FermionOperator

            nx, ny = lat["x_dimension"], lat["y_dimension"]
            dagger = args.kind == "particle"

            def ladder(site):
                return FermionOperator(((2 * site, 1 if dagger else 0),))

            op = _momentum_sum(nx, ny, -args.kx if not dagger else args.kx,
                               -args.ky if not dagger else args.ky, ladder)
            res = spectral_function_lanczos(
                problem, gs, float(energy), op, m=args.m,
                omegas=omegas, eta=args.eta, dtype=dtype, device=dev,
            )
        live = res["weights"] > 1e-8
        out = {
            "kind": args.kind,
            "k": [args.kx, args.ky],
            "ground_energy": float(energy),
            "norm2": float(res["norm2"]),
            "poles": [round(float(x), 8) for x in res["poles"][live]],
            "weights": [round(float(x), 8) for x in res["weights"][live]],
        }
        with open("spectral.json", "w") as fh:
            json.dump({**out, "omegas": omegas.tolist(),
                       "A": res["A"].tolist()}, fh)
        print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
