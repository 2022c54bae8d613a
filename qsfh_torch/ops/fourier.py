"""Lattice Fourier transform of fermionic operators.

Parity with ``reference/operators/fourier.py``: the spin-block DFT
matrix over row-major 2D momenta, and conjugate operator rewrites
``c^dag_n -> sum_m e^{-+2 pi i k.r} c^dag_m`` used to express the hopping
Hamiltonian diagonally in momentum space (consumed at
``reference/models/hva.py:185-193``).

Index conventions (identical to the reference):
  * spin-orbital ``index = 2*(ix + Nx*iy) + spin``
  * momentum tuple of a site index: ``(n % Nx, n // Nx)``
"""

from __future__ import annotations

import numpy as np

from .fermion import FermionOperator, normal_ordered


def round_operator(op: FermionOperator, decimals: int = 6) -> FermionOperator:
    out = FermionOperator.zero()
    for term, coeff in op.terms.items():
        c = complex(np.round(coeff.real, decimals), np.round(coeff.imag, decimals))
        if c != 0:
            out.terms[term] = out.terms.get(term, 0.0) + c
    return out


def fourier_transform_matrix(x_dimension: int, y_dimension: int) -> np.ndarray:
    """(2N x 2N) spin-block DFT matrix, 1/sqrt(N) normalized."""
    Nx, Ny = x_dimension, y_dimension
    n_sites = Nx * Ny
    n_spin_orbitals = 2 * n_sites
    F = np.zeros((n_spin_orbitals, n_spin_orbitals), dtype=complex)

    def index2tuple(index):
        return ((index // 2) % Nx, (index // 2) // Nx, index % 2)

    for row in range(n_spin_orbitals):
        nx, ny, spin1 = index2tuple(row)
        for column in range(n_spin_orbitals):
            mx, my, spin2 = index2tuple(column)
            if spin1 != spin2:
                continue
            F[row, column] = np.exp(-2j * np.pi * (mx * nx / Nx + my * ny / Ny))
    return F / np.sqrt(n_sites)


def _transform(hamiltonian: FermionOperator, Nx: int, Ny: int, sign: int) -> FermionOperator:
    """Shared body of the forward (sign=-1) / inverse (sign=+1) transforms."""
    n_sites = Nx * Ny

    def index2tuple(index):
        return ((index // 2) % Nx, (index // 2) // Nx, index % 2)

    def tuple2index(ix, iy, spin):
        return 2 * (ix + Nx * iy) + spin

    out = FermionOperator.zero()
    for term, coeff in hamiltonian.terms.items():
        ft_term = FermionOperator.identity()
        for n, ladder in term:
            nx, ny, spin = index2tuple(n)
            basis = FermionOperator.zero()
            for m in range(n_sites):
                mx, my = m % Nx, m // Nx
                m_sigma = tuple2index(mx, my, spin)
                # creation ops pick up sign*i phases; annihilation the conjugate
                s = sign if ladder else -sign
                phase = np.exp(s * 1j * 2 * np.pi * (mx * nx / Nx + my * ny / Ny))
                basis += FermionOperator(((m_sigma, ladder),), phase / np.sqrt(n_sites))
            ft_term = ft_term * basis
        out += ft_term * coeff
        out = normal_ordered(out)
    out.compress()
    return round_operator(out)


def fourier_transform(hamiltonian: FermionOperator, Nx: int, Ny: int) -> FermionOperator:
    """Real space -> momentum space (c^dag picks up e^{-i k.r})."""
    return _transform(hamiltonian, Nx, Ny, sign=-1)


def inverse_fourier_transform(hamiltonian: FermionOperator, Nx: int, Ny: int) -> FermionOperator:
    """Momentum space -> real space."""
    return _transform(hamiltonian, Nx, Ny, sign=+1)
