"""Host-side (scipy) sector-restricted exact diagonalization.

Counterpart of ``qsfh_tpu/linalg/exact.py``: the sparse matrix of a
Pauli sum, its restriction to an (N, Sz) sector and ARPACK's lowest
eigenpairs, in complex128.  It is the golden reference for the Lanczos
solver of :mod:`qsfh_torch.linalg.lanczos`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from ..ops.fermion import FermionOperator
from ..ops.jw import jordan_wigner
from ..ops.pauli import PauliSum
from ..utils.dense import paulisum_to_sparse
from .sectors import jw_number_spin_indices


def get_sparse_operator(op, n_qubits: int = None) -> scipy.sparse.csr_matrix:
    """Sparse matrix of a FermionOperator or PauliSum (OpenFermion-compatible)."""
    if isinstance(op, FermionOperator):
        if n_qubits is None:
            n_qubits = op.n_modes()
        op = jordan_wigner(op)
    if not isinstance(op, PauliSum):
        raise TypeError(type(op))
    if n_qubits is None:
        n_qubits = op.n_qubits()
    return paulisum_to_sparse(op, n_qubits)


def jw_number_spin_restrict_operator(
    operator: scipy.sparse.spmatrix,
    n_electrons: int,
    spin_up: int,
    spin_down: int,
    n_qubits: int = None,
):
    if n_qubits is None:
        n_qubits = int(np.log2(operator.shape[0]))
    select = jw_number_spin_indices(n_electrons, spin_up, spin_down, n_qubits)
    return operator[np.ix_(select, select)]


def jw_get_ground_state(
    sparse_operator, particle_number: int, spin_up: int, spin_down: int
) -> Tuple[float, np.ndarray]:
    """Sector-restricted ground state (energy, full-space state)."""
    n_qubits = int(np.log2(sparse_operator.shape[0]))
    restricted = jw_number_spin_restrict_operator(
        sparse_operator, particle_number, spin_up, spin_down, n_qubits
    )
    if restricted.shape[0] - 1 <= 1:
        evals, evecs = np.linalg.eigh(restricted.toarray())
    else:
        evals, evecs = scipy.sparse.linalg.eigsh(restricted, k=1, which="SA")
    expanded = np.zeros(1 << n_qubits, dtype=complex)
    expanded[jw_number_spin_indices(particle_number, spin_up, spin_down, n_qubits)] = evecs[:, 0]
    return float(evals[0]), expanded


def jw_get_ground_space(
    sparse_operator,
    particle_number: int,
    spin_up: int,
    spin_down: int,
    n_states: int = 4,
    n_probe: int = 10,
) -> Tuple[float, List[np.ndarray]]:
    """The ``n_states`` lowest sector states, Gram-Schmidt orthonormalized."""
    n_qubits = int(np.log2(sparse_operator.shape[0]))
    restricted = jw_number_spin_restrict_operator(
        sparse_operator, particle_number, spin_up, spin_down, n_qubits
    )
    if restricted.shape[0] <= n_probe + 1:
        evals, evecs = np.linalg.eigh(restricted.toarray())
    else:
        evals, evecs = scipy.sparse.linalg.eigsh(restricted, k=n_probe, which="SA")
    order = np.argsort(evals)
    evals, evecs = evals[order], evecs[:, order]
    idx = jw_number_spin_indices(particle_number, spin_up, spin_down, n_qubits)
    ortho: List[np.ndarray] = []
    for m in range(n_states):
        v = np.zeros(1 << n_qubits, dtype=complex)
        v[idx] = evecs[:, m]
        for u in ortho:
            v = v - (u.conj() @ v) * u
        ortho.append(v / np.linalg.norm(v))
    return float(evals[0]), ortho
