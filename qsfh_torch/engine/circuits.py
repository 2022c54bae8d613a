"""Circuit building blocks shared by the algorithm drivers.

Counterpart of ``qsfh_tpu/engine/circuits.py``: the momentum-mode
selection and the Slater-prep helpers on :mod:`.gates` (the Givens
network as an RZ layer of static phases and one 4x4 per plan rotation).
The JAX module's ``slater_prep_reim`` (a real (2, 2^n) array for the
TPU's complex-free program boundary) has no counterpart.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.fermion import FermionOperator
from ..ops.jw import jordan_wigner
from . import gates
from .state import basis_state

# above this many qubits the 2^n host phase vector of the RZ layer is too
# large; the layer runs as one rz per qubit
STATIC_RZ_LAYER_MAX_QUBITS = 22


def get_non_interacting_ground_state_indices(
    k_quadratic_term: FermionOperator, n_qubits: int, n_spin_up: int, n_spin_down: int
) -> Tuple[List[int], List[int]]:
    """Pick the lowest-energy momentum modes per spin sector.

    Reads the diagonal k-space hopping energies and returns the n_up /
    n_down lowest mode indices (reference ``models/hva.py:97-115``).
    """
    spin_up_energies = {x: 0.0 for x in range(0, n_qubits, 2)}
    spin_down_energies = {x: 0.0 for x in range(1, n_qubits, 2)}
    for term, coeff in k_quadratic_term.terms.items():
        index = term[0][0]
        if index % 2 == 0:
            spin_up_energies[index] = coeff.real
        else:
            spin_down_energies[index] = coeff.real
    spin_up_indices = sorted(spin_up_energies, key=spin_up_energies.get)[:n_spin_up]
    spin_down_indices = sorted(spin_down_energies, key=spin_down_energies.get)[:n_spin_down]
    return spin_up_indices, spin_down_indices


def _rz_layer(psi: torch.Tensor, n_qubits: int, angles) -> torch.Tensor:
    if n_qubits <= STATIC_RZ_LAYER_MAX_QUBITS:
        phases = gates.static_rz_layer_phases(angles, n_qubits)
        return psi * torch.as_tensor(phases).to(device=psi.device, dtype=psi.dtype)
    for i in range(n_qubits):
        psi = gates.rz(psi, n_qubits, angles[i], i)
    return psi


def apply_givens_network(psi: torch.Tensor, n_qubits: int, diagonal, decomposition):
    """RZ(angle(diagonal)) layer + reversed Givens-plan rotations: the
    Fourier transform from momentum to real space that ADAPT's ansatz and
    HVA's Slater determinant go through (reference ``adapt_vqe.py:343-354``)."""
    psi = _rz_layer(psi, n_qubits, [float(np.angle(diagonal[i])) for i in range(n_qubits)])
    for parallel_ops in reversed(decomposition):
        for op in parallel_ops:
            if op == "pht":
                psi = gates.pauli_x(psi, n_qubits, n_qubits - 1)
            else:
                i, j, theta, phi = op
                M = gates.givens_plan_matrix(float(theta), float(phi))
                psi = gates.apply_two_qubit(psi, n_qubits, M, i, j)
    return psi


def apply_givens_network_adjoint(psi: torch.Tensor, n_qubits: int, diagonal, decomposition):
    """Inverse of :func:`apply_givens_network` (U_FT^dag).  Gates within one
    parallel layer act on disjoint wires, so only the layer order reverses."""
    for parallel_ops in decomposition:
        for op in reversed(parallel_ops):
            if op == "pht":
                psi = gates.pauli_x(psi, n_qubits, n_qubits - 1)
            else:
                i, j, theta, phi = op
                M = gates.givens_plan_matrix(float(theta), float(phi))
                psi = gates.apply_two_qubit(psi, n_qubits, M.conj().T, i, j)
    return _rz_layer(psi, n_qubits, [-float(np.angle(diagonal[i])) for i in range(n_qubits)])


def slater_prep_state(n_qubits: int, occupied_modes: Sequence[int], diagonal, decomposition,
                      dtype=torch.complex128, device="cpu") -> torch.Tensor:
    """The Slater determinant: the occupied momentum modes' basis state
    through :func:`apply_givens_network` (reference ``hva.py:276-289``).
    A constant: drivers build it once."""
    psi = basis_state(n_qubits, occupied_modes, dtype=dtype, device=device)
    return apply_givens_network(psi, n_qubits, diagonal, decomposition)


class GeneratorGate:
    """A Trotterized exp(-i theta G) gate with its rotation terms lowered
    once: a serializable descriptor (the FermionOperator source) in place
    of the reference's pickled gate closures."""

    def __init__(self, generator, n_qubits: int, label: str = ""):
        fermionic = isinstance(generator, FermionOperator)
        self.fermion_generator = generator if fermionic else None
        self.generator = jordan_wigner(generator) if fermionic else generator
        self.n_qubits = n_qubits
        self.label = label
        self.rot_terms = self.generator.rotation_terms()

    def __call__(self, psi: torch.Tensor, theta) -> torch.Tensor:
        return gates.generator_rotation(psi, self.n_qubits, self.rot_terms, theta)
