"""The amplitude-sharded ADAPT-VQE train step and pool screen.

Counterpart of ``qsfh_tpu/parallel/sharded_adapt.py``: the k-space basis
state, the ansatz and the Givens network as one rot program
(:class:`.sharded_compiled.ShardedRotations`), the Hamiltonian's energy and
cotangent, the adjoint gradient, Sz / S^2 / fidelity and the Adam update,
on each rank's shard.  Rotations cross shards through the stacked pair,
observables through the partner form; the step's shares meet in one
rank-order sum, so every rank holds the same energy, gradient and thetas.

The JAX module's ``gradient="backprop"`` and ``lowering="unrolled"`` are
XLA cross-checks of its scan lowering; the port has one lowering (the
kernels) and one gradient (the adjoint sweep), and the other values raise.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..algos.base import HubbardProblem, adam_step, default_dtype
from ..engine.compiled import givens_network_static_ops
from ..engine.state import real_dtype
from .shmap_engine import ShardedPauliEngine
from .sharded_compiled import (ShardedObservable, ShardedPool, ShardedRotations,
                               adjoint_energy_grads, sharded_metrics_fn)


def _ansatz_ops(pool_rot, selected):
    return [("rot", tuple(pool_rot[i]), slot) for slot, i in enumerate(selected)]


def _engine(problem: HubbardProblem, mesh, impl):
    return ShardedPauliEngine(problem.n_qubits, mesh, impl)


def build_sharded_adapt_train_step(problem: HubbardProblem, pool_rot: Sequence,
                                   selected: Sequence[int], mesh, dtype=None, lr: float = 1e-2,
                                   gs=(), metrics: bool = True, impl=None):
    """The driver-grade sharded ADAPT step: (step, thetas0, optimizer0) with
    ``step(thetas, optimizer) -> (thetas, optimizer, E, Sz, S^2, fid,
    gnorm)``, the single-card ``ADAPT._build_step`` contract (thetas
    updated in place through a ``torch.optim.Adam`` over ``[thetas]``).
    ``gs``: the exact ground states (full states) for the fidelity."""
    p = problem
    engine = _engine(p, mesh, impl)
    dtype = dtype or default_dtype(mesh.device)
    net_ops, phase = givens_network_static_ops(p.n_qubits, p.diagonal, p.decomposition)
    program = ShardedRotations(engine, _ansatz_ops(pool_rot, selected) + net_ops, phase)
    ham = ShardedObservable.of(engine, p.qubit_hamiltonian)
    obs = p.observables
    extras = sharded_metrics_fn(engine, obs["Sz"].op, obs["S^2"].op, gs, metrics)
    psi0 = engine.basis_state(tuple(p.spin_up_indices + p.spin_down_indices), dtype)

    def step(thetas, optimizer):
        energy, grads, (sz, s2, fid) = adjoint_energy_grads(engine, program, thetas, psi0, ham,
                                                            extras)
        thetas, optimizer, gnorm = adam_step(thetas, grads, optimizer)
        return thetas, optimizer, energy, sz, s2, fid, gnorm

    step.program, step.observable, step.extras = program, ham, extras
    thetas0 = torch.zeros(len(selected), dtype=real_dtype(dtype), device=mesh.device)
    return step, thetas0, torch.optim.Adam([thetas0], lr=lr)


def build_sharded_adapt_step(problem: HubbardProblem, pool_rot: Sequence,
                             selected: Sequence[int], mesh, dtype=None, lr: float = 1e-2,
                             gradient: str = "adjoint", lowering: str = "scan", impl=None):
    """(step, thetas0, optimizer0) with ``step(thetas, optimizer) -> (thetas,
    optimizer, E, gnorm)``: the train step without the metrics."""
    if gradient != "adjoint":
        raise ValueError(f"unknown gradient mode: {gradient!r} (the port's gradient is the "
                         "adjoint sweep)")
    if lowering != "scan":
        raise ValueError(f"unknown lowering: {lowering!r} (the port lowers to the rotation runs)")
    train, thetas0, opt0 = build_sharded_adapt_train_step(problem, pool_rot, selected, mesh,
                                                          dtype, lr, metrics=False, impl=impl)

    def step(thetas, optimizer):
        thetas, optimizer, energy, _, _, _, gnorm = train(thetas, optimizer)
        return thetas, optimizer, energy, gnorm

    return step, thetas0, opt0


def build_sharded_screen_fn(problem: HubbardProblem, pool_rot: Sequence, selected: Sequence[int],
                            packed_pool, mesh, dtype=None, impl=None):
    """fn(thetas) -> |pool| gradients dE/de_k = 2 Im <w | G_k psi_k>, w =
    U_net^dag H U_net psi_k, on the sharded state (the same bits on every
    rank, so every rank selects the same operators)."""
    p = problem
    engine = _engine(p, mesh, impl)
    dtype = dtype or default_dtype(mesh.device)
    ansatz = ShardedRotations(engine, _ansatz_ops(pool_rot, selected))
    net_ops, phase = givens_network_static_ops(p.n_qubits, p.diagonal, p.decomposition)
    net = ShardedRotations(engine, net_ops, phase)
    ham = ShardedObservable.of(engine, p.qubit_hamiltonian)
    pool = ShardedPool(engine, packed_pool)
    psi0 = engine.basis_state(tuple(p.spin_up_indices + p.spin_down_indices), dtype)
    empty = torch.zeros(0, dtype=real_dtype(dtype), device=mesh.device)

    def fn(thetas):
        psi_k = ansatz.apply(psi0, thetas)
        w = net.apply(ham.apply(net.apply(psi_k, empty)), empty, direction=-1)
        return pool.screen(psi_k, w)

    return fn
