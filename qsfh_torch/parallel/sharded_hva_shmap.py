"""The amplitude-sharded HVA train step: rotation runs, adjoint gradients.

Counterpart of ``qsfh_tpu/parallel/sharded_hva_shmap.py``: the Givens
network prepares the Slater state first (once, on the shards), then reps x
(U, vertical..., horizontal...) layers and a final U layer run as ONE rot
program (``algos.hva.hva_program_rot``: the Coulomb layer as shared-angle
Z / ZZ rotations, no 2^n diagonal vector at any qubit count), the gradient
from the reverse adjoint sweep.  The parameters are the port's flat vector
[theta_U (reps+1) | theta_v (reps*Nv) | theta_h (reps*Nh)].
"""

from __future__ import annotations

import torch

from ..algos.base import HubbardProblem, adam_step, default_dtype
from ..engine.state import real_dtype
from ..ops.jw import jordan_wigner
from .shmap_engine import ShardedPauliEngine
from .sharded_compiled import (ShardedGivensNetwork, ShardedObservable, ShardedRotations,
                               adjoint_energy_grads, sharded_metrics_fn)


def hva_sizes(problem: HubbardProblem, reps: int):
    """(reps + 1, reps * Nv, reps * Nh): the parameter blocks."""
    h_gen, v_gen = problem.hva_generators()
    return reps + 1, reps * len(v_gen), reps * len(h_gen)


def sharded_hva_program(problem: HubbardProblem, reps: int, mesh, dtype, impl=None):
    """(engine, program, psi0 shard): the HVA rotations on the shards and the
    Slater state they start from."""
    from ..algos.hva import hva_program_rot

    p = problem
    engine = ShardedPauliEngine(p.n_qubits, mesh, impl)
    h_gen, v_gen = p.hva_generators()
    u_rot = jordan_wigner(p.interacting_term).rotation_terms()
    program = ShardedRotations(engine, hva_program_rot(
        reps, [g.rotation_terms() for g in v_gen], [g.rotation_terms() for g in h_gen], u_rot))
    basis = engine.basis_state(tuple(p.spin_up_indices + p.spin_down_indices), dtype)
    psi0 = ShardedGivensNetwork(engine, p.diagonal, p.decomposition).apply(basis)
    return engine, program, psi0


def build_sharded_hva_train_step(problem: HubbardProblem, reps: int, mesh, dtype=None,
                                 lr: float = 1e-2, gs=(), metrics: bool = True, impl=None):
    """The driver-grade sharded HVA step: (step, thetas0, optimizer0) with
    ``step(thetas, optimizer) -> (thetas, optimizer, E, Sz, S^2, fid,
    gnorm)``, the single-card ``HVA._build_step`` contract.  ``gs``: the
    exact ground states (full states) for the fidelity."""
    dtype = dtype or default_dtype(mesh.device)
    engine, program, psi0 = sharded_hva_program(problem, reps, mesh, dtype, impl)
    ham = ShardedObservable.of(engine, problem.qubit_hamiltonian)
    obs = problem.observables
    extras = sharded_metrics_fn(engine, obs["Sz"].op, obs["S^2"].op, gs, metrics)

    def step(thetas, optimizer):
        energy, grads, (sz, s2, fid) = adjoint_energy_grads(engine, program, thetas, psi0, ham,
                                                            extras)
        thetas, optimizer, gnorm = adam_step(thetas, grads, optimizer)
        return thetas, optimizer, energy, sz, s2, fid, gnorm

    step.program, step.psi0 = program, psi0
    thetas0 = torch.zeros(sum(hva_sizes(problem, reps)), dtype=real_dtype(dtype),
                          device=mesh.device)
    return step, thetas0, torch.optim.Adam([thetas0], lr=lr)


def build_sharded_hva_step_shmap(problem: HubbardProblem, reps: int, mesh, dtype=None,
                                 lr: float = 1e-2, impl=None):
    """(step, thetas0, optimizer0) with ``step(thetas, optimizer) -> (thetas,
    optimizer, E, gnorm)`` on the flat parameter vector."""
    train, thetas0, opt0 = build_sharded_hva_train_step(problem, reps, mesh, dtype, lr,
                                                        metrics=False, impl=impl)

    def step(thetas, optimizer):
        thetas, optimizer, energy, _, _, _, gnorm = train(thetas, optimizer)
        return thetas, optimizer, energy, gnorm

    return step, thetas0, opt0
