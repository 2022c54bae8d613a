"""The HVA train step in the JAX package's GSPMD form, served by the
explicit engine.

``qsfh_tpu/parallel/sharded_hva.py`` annotates the state as sharded and lets
the XLA SPMD partitioner place the collectives: the Slater state built once
and placed by sharding, the parameters a dict {theta_U, theta_v, theta_h}
under one optimizer.  torch has no SPMD partitioner, so this form keeps the
JAX module's surface (the dict, the Slater state cut into shards from the
full state) and runs its step on :mod:`.sharded_hva_shmap`'s rotation runs
and adjoint gradient.
"""

from __future__ import annotations

import torch

from ..algos.base import HubbardProblem, default_dtype
from ..engine.circuits import slater_prep_state
from ..engine.state import real_dtype
from .mesh import shard_statevector
from .sharded_compiled import ShardedObservable, adjoint_energy_grads
from .sharded_hva_shmap import hva_sizes, sharded_hva_program

KEYS = ("theta_U", "theta_v", "theta_h")


def build_sharded_hva_step(problem: HubbardProblem, reps: int, mesh, dtype=None,
                           lr: float = 1e-2, impl=None):
    """(step, params0, optimizer0): ``step(params, optimizer) -> (params,
    optimizer, E, gnorm)`` with ``params`` the dict of the three parameter
    blocks, updated in place by a ``torch.optim.Adam`` over them."""
    p = problem
    dtype = dtype or default_dtype(mesh.device)
    engine, program, _ = sharded_hva_program(p, reps, mesh, dtype, impl)
    psi0 = shard_statevector(slater_prep_state(
        p.n_qubits, p.spin_up_indices + p.spin_down_indices, p.diagonal, p.decomposition,
        dtype=dtype, device=mesh.device), mesh)
    ham = ShardedObservable.of(engine, p.qubit_hamiltonian)
    sizes = hva_sizes(p, reps)

    def step(params, optimizer):
        flat = torch.cat([params[k].detach() for k in KEYS])
        energy, grads, _ = adjoint_energy_grads(engine, program, flat, psi0, ham)
        for key, g in zip(KEYS, torch.split(grads, sizes)):
            params[key].grad = g.clone()
        optimizer.step()
        return params, optimizer, energy, torch.linalg.vector_norm(grads)

    rdt = real_dtype(dtype)
    params0 = {k: torch.zeros(s, dtype=rdt, device=mesh.device) for k, s in zip(KEYS, sizes)}
    return step, params0, torch.optim.Adam(list(params0.values()), lr=lr)
