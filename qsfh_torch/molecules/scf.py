"""Restricted Hartree-Fock with DIIS (host-side, numpy).

A copy of ``qsfh_tpu/molecules/scf.py``.

Replaces the PySCF SCF the reference runs through ``run_pyscf``
(``reference molecules/__init__.py:8``).  Closed-shell RHF is all the
reference molecules need (every factory uses multiplicity 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def restricted_hartree_fock(
    S: np.ndarray,
    T: np.ndarray,
    V: np.ndarray,
    eri: np.ndarray,
    n_electrons: int,
    e_nuc: float,
    max_iter: int = 200,
    tol: float = 1e-10,
    diis_size: int = 8,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Returns (hf_energy, mo_coefficients, mo_energies).

    ``eri`` is the chemist-notation (ij|kl) tensor.
    """
    if n_electrons % 2:
        raise ValueError("RHF needs an even electron count (closed shell)")
    n_occ = n_electrons // 2
    Hcore = T + V

    # symmetric orthogonalization
    s_vals, s_vecs = np.linalg.eigh(S)
    X = s_vecs @ np.diag(s_vals**-0.5) @ s_vecs.T

    def solve_fock(F):
        Fp = X.T @ F @ X
        eps, Cp = np.linalg.eigh(Fp)
        C = X @ Cp
        return eps, C

    eps, C = solve_fock(Hcore)
    D = 2.0 * C[:, :n_occ] @ C[:, :n_occ].T

    fock_list, err_list = [], []
    energy = 0.0
    for _ in range(max_iter):
        J = np.einsum("ijkl,kl->ij", eri, D)
        K = np.einsum("ikjl,kl->ij", eri, D)
        F = Hcore + J - 0.5 * K

        # DIIS extrapolation on the orthogonalized gradient FDS - SDF
        err = X.T @ (F @ D @ S - S @ D @ F) @ X
        fock_list.append(F)
        err_list.append(err)
        if len(fock_list) > diis_size:
            fock_list.pop(0)
            err_list.pop(0)
        if len(fock_list) > 1:
            m = len(fock_list)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            for i in range(m):
                for j in range(m):
                    B[i, j] = np.sum(err_list[i] * err_list[j])
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(B, rhs)[:m]
                F = sum(wi * Fi for wi, Fi in zip(w, fock_list))
            except np.linalg.LinAlgError:
                pass

        eps, C = solve_fock(F)
        D_new = 2.0 * C[:, :n_occ] @ C[:, :n_occ].T
        e_new = _rhf_energy(Hcore, eri, D_new, e_nuc)
        if abs(e_new - energy) < tol and np.max(np.abs(D_new - D)) < 1e-8:
            return e_new, C, eps
        energy, D = e_new, D_new
    return energy, C, eps


def _rhf_energy(Hcore, eri, D, e_nuc):
    """Clean energy from the density's own Fock matrix (not DIIS-mixed)."""
    J = np.einsum("ijkl,kl->ij", eri, D)
    K = np.einsum("ikjl,kl->ij", eri, D)
    F = Hcore + J - 0.5 * K
    return 0.5 * np.sum(D * (Hcore + F)) + e_nuc
