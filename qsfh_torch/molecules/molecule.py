"""MolecularData equivalent: geometry -> integrals -> RHF -> FCI -> Hamiltonian.

Counterpart of ``qsfh_tpu/molecules/molecule.py``: the in-repo integral
engine (:mod:`.integrals`), RHF (:mod:`.scf`) and the sector-restricted
Lanczos FCI of :mod:`qsfh_torch.linalg.lanczos` on the CPU in complex128.

Spin-orbital / Hamiltonian conventions match OpenFermion so driver behavior
is identical: spin-orbital ``2p`` is alpha of spatial orbital p, ``2p+1``
beta; the molecular Hamiltonian is

    H = E_nuc + sum_pq h[p,q] a+_ps a_qs
             + 1/2 sum_pqrs (ps|qr)_chem a+_ps a+_qt a_rt a_ss

(the OpenFermion ``two_body_integrals[p,q,r,s] = (ps|qr)`` layout).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops.fermion import FermionOperator
from .basis import build_basis
from .integrals import ANGSTROM_TO_BOHR, build_integrals, nuclear_repulsion
from .scf import restricted_hartree_fock

EQ_TOL = 1e-10


class Molecule:
    """Quantum-chemistry problem container (MolecularData parity surface:
    n_qubits / n_electrons / n_orbitals / hf_energy / fci_energy /
    get_molecular_hamiltonian)."""

    def __init__(
        self,
        geometry: List[Tuple[str, Tuple[float, float, float]]],
        basis: str = "sto-3g",
        multiplicity: int = 1,
        charge: int = 0,
        run_fci: bool = True,
    ):
        if basis.lower() != "sto-3g":
            raise ValueError("only STO-3G is shipped (reference uses sto-3g only)")
        if multiplicity != 1:
            raise ValueError("closed-shell RHF path: multiplicity must be 1")
        self.geometry = geometry
        self.basis = basis
        self.multiplicity = multiplicity
        self.charge = charge

        atoms_bohr = [
            (sym, np.asarray(xyz, dtype=float) * ANGSTROM_TO_BOHR)
            for sym, xyz in geometry
        ]
        funcs, charges = build_basis(atoms_bohr)
        self.n_orbitals = len(funcs)
        self.n_qubits = 2 * self.n_orbitals
        self.n_electrons = sum(z for z, _ in charges) - charge
        self.nuclear_repulsion = nuclear_repulsion(charges)

        # display name: element counts by decreasing atomic number
        # (electropositive-first heuristic -- reproduces the factory names
        # H2, HeH+, LiH, BeH2, H4, H6) plus an ion charge marker; a
        # heuristic, not a full Hill/IUPAC formatter -- assign .name to
        # override for exotic species.  Feeds driver artifact tags
        # (algos/hea.py).
        zmap = {sym: z for (sym, _), (z, _) in zip(geometry, charges)}
        counts: dict = {}
        for sym, _ in geometry:
            counts[sym] = counts.get(sym, 0) + 1
        ion = "" if charge == 0 else (
            ("+" if charge > 0 else "-") if abs(charge) == 1
            else f"{abs(charge)}{'+' if charge > 0 else '-'}"
        )
        self.name = "".join(
            f"{el}{counts[el] if counts[el] > 1 else ''}"
            for el in sorted(counts, key=lambda s: -zmap[s])
        ) + ion

        S, T, V, eri = build_integrals(funcs, charges)
        self.hf_energy, C, self.orbital_energies = restricted_hartree_fock(
            S, T, V, eri, self.n_electrons, self.nuclear_repulsion
        )
        self.canonical_orbitals = C

        # AO -> MO transforms
        hcore_mo = C.T @ (T + V) @ C
        eri_mo = np.einsum("pi,qj,rk,sl,pqrs->ijkl", C, C, C, C, eri, optimize=True)
        self.one_body_integrals = hcore_mo
        # OpenFermion layout: two_body_integrals[p,q,r,s] = (ps|qr)_chem
        self.two_body_integrals = np.transpose(eri_mo, (0, 2, 3, 1))

        self._fci_energy: Optional[float] = None
        if run_fci:
            self._fci_energy = self._run_fci()

    # -- Hamiltonian -----------------------------------------------------------

    def get_molecular_hamiltonian(self) -> FermionOperator:
        """Spin-orbital second-quantized Hamiltonian (OpenFermion ordering)."""
        n = self.n_orbitals
        h1 = self.one_body_integrals
        h2 = self.two_body_integrals
        H = FermionOperator("", self.nuclear_repulsion)
        for p in range(n):
            for q in range(n):
                c = h1[p, q]
                if abs(c) > EQ_TOL:
                    for s in (0, 1):
                        H += FermionOperator(((2 * p + s, 1), (2 * q + s, 0)), c)
        for p in range(n):
            for q in range(n):
                for r in range(n):
                    for s in range(n):
                        c = h2[p, q, r, s] / 2.0
                        if abs(c) <= EQ_TOL:
                            continue
                        for sig in (0, 1):
                            for tau in (0, 1):
                                i, j = 2 * p + sig, 2 * q + tau
                                k, l = 2 * r + tau, 2 * s + sig
                                if i == j or k == l:
                                    continue  # a+a+ or aa on same mode is 0
                                H += FermionOperator(
                                    ((i, 1), (j, 1), (k, 0), (l, 0)), c
                                )
        return H.compress()

    # -- FCI -------------------------------------------------------------------

    def _run_fci(self) -> float:
        import torch

        from ..linalg.lanczos import ground_state
        from ..ops.jw import jordan_wigner

        qubit_h = jordan_wigner(self.get_molecular_hamiltonian())
        n_up = self.n_electrons // 2
        energy, _ = ground_state(
            qubit_h,
            self.n_qubits,
            self.n_electrons,
            n_up,
            self.n_electrons - n_up,
            dtype=torch.complex128,
            device="cpu",  # a host object: the integrals and their FCI live with it
        )
        return float(energy)

    @property
    def fci_energy(self) -> Optional[float]:
        return self._fci_energy
