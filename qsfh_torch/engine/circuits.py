"""Circuit building blocks shared by the algorithm drivers.

Counterpart of ``qsfh_tpu/engine/circuits.py``; this slice carries only the
momentum-mode selection the ADAPT driver needs.
"""

from __future__ import annotations

from typing import List, Tuple

from ..ops.fermion import FermionOperator


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
