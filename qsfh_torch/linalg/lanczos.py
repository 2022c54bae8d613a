"""Lanczos ground-state solver over an (N, Sz) sector, on the CPU in complex128.

Counterpart of ``qsfh_tpu/linalg/lanczos.py`` (``lanczos_eigsh``,
``ground_state``, ``degenerate_ground_space``) with the same algorithm:
the Krylov basis in sector coordinates with full reorthogonalization (two
passes), breakdown at beta < 1e-12, k = min(max(2 dim, 8), 160) steps
(220 for the degenerate manifold), each further degenerate state from a
deflated restart (found states shifted up by |e| 10 + 10), and a
Gram-Schmidt pass over each state found.

Placement: the JAX package runs its solver on the CPU under x64
(``qsfh_tpu/algos/base.py:176``); so does this one, in complex128.  The
matvec differs: the JAX package scatters to the full space, applies the
packed Hamiltonian and gathers back; here the Hamiltonian restricted to
the sector is built once as a CSR matrix in sector coordinates from the
port's own term arrays (for each sector index b and term t, the entry
b ^ x_t with its phase and sign, duplicates summed), so each matvec is one
sparse product (3x3: 15,876 rows).

Start vectors come from a seeded ``torch.Generator``, so they differ from
the JAX package's ``jax.random`` draws: energies and subspaces agree,
vectors only up to phase (and within a degenerate manifold, a rotation).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import scipy.sparse
import torch

from ..engine.expectation import Observable
from ..ops.pauli import PauliSum
from .sectors import jw_number_spin_indices, sector_dimension

BREAKDOWN = 1e-12


def sector_hamiltonian(
    hamiltonian: PauliSum, n_qubits: int, n_electrons: int, spin_up: int, spin_down: int
) -> Tuple[scipy.sparse.csr_matrix, np.ndarray]:
    """(H restricted to the sector as CSR in sector coordinates, the
    sector's flat indices).  Row r, column pos(idx[r] ^ x_t) gains
    c_t (-1)^popcount(idx[r] & z_t) (the reorder sign folded into c_t, as
    ``Observable`` does); entries whose column leaves the sector cancel in
    H, which conserves (N, Sz), and are dropped."""
    idx = np.asarray(
        jw_number_spin_indices(n_electrons, spin_up, spin_down, n_qubits), dtype=np.int64)
    dim = idx.size
    pos = np.full(1 << n_qubits, -1, dtype=np.int64)
    pos[idx] = np.arange(dim)
    xs, zs, cre, cim = Observable(hamiltonian, n_qubits)._scan_terms()
    rows, cols, data = [], [], []
    r = np.arange(dim, dtype=np.int64)
    for x, z, c in zip(xs.astype(np.int64), zs.astype(np.int64), cre + 1j * cim):
        col = pos[idx ^ x]
        keep = col >= 0
        signs = 1.0 - 2.0 * (np.bitwise_count(idx[keep] & z) % 2).astype(np.float64)
        rows.append(r[keep])
        cols.append(col[keep])
        data.append(c * signs)
    mat = scipy.sparse.coo_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))), shape=(dim, dim)
    ).tocsr()
    mat.sum_duplicates()
    return mat, idx


def _sector_matvec(hamiltonian, n_qubits, n_electrons, spin_up, spin_down):
    """(matvec over sector coordinates on complex128 CPU tensors, sector
    index array)."""
    mat, idx = sector_hamiltonian(hamiltonian, n_qubits, n_electrons, spin_up, spin_down)

    def mv(v: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(mat @ v.numpy())

    return mv, idx


def _lanczos_basis(matvec: Callable, v0: torch.Tensor, k: int):
    """Up to k Lanczos steps with full reorthogonalization (two passes).

    Returns (alphas, betas, V): V holds the m <= k basis vectors as rows,
    m the steps taken before breakdown (beta < ``BREAKDOWN``).
    """
    dim = v0.shape[0]
    V = torch.zeros((k, dim), dtype=v0.dtype)
    v = v0 / torch.linalg.vector_norm(v0)
    V[0] = v
    alphas, betas = [], []
    beta_prev, v_prev = 0.0, torch.zeros_like(v)
    for j in range(k):
        w = matvec(v)
        alpha = float(torch.vdot(v, w).real)
        w = w - alpha * v - beta_prev * v_prev
        basis = V[: j + 1]
        for _ in range(2):  # overlaps conj(V) w as conj(V conj(w)): no conjugated copy of V
            w = w - torch.mv(basis.T, torch.mv(basis, w.conj()).conj())
        beta = float(torch.linalg.vector_norm(w))
        alphas.append(alpha)
        betas.append(beta)
        if beta < BREAKDOWN or j + 1 == k:
            break
        v_prev, v = v, w / beta
        V[j + 1] = v
        beta_prev = beta
    return np.asarray(alphas), np.asarray(betas), V[: len(alphas)]


def lanczos_eigsh(
    matvec: Callable, v0: torch.Tensor, k: int = 80, n_eigen: int = 1
) -> Tuple[np.ndarray, torch.Tensor]:
    """Lowest ``n_eigen`` eigenpairs of the Hermitian operator ``matvec``.

    Returns (eigenvalues [numpy, ascending], eigenvectors [n_eigen, dim]).
    """
    alphas, betas, V = _lanczos_basis(matvec, v0, k)
    m = alphas.size
    T = np.diag(alphas)
    if m > 1:
        off = betas[: m - 1]
        T += np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(T)
    n_eigen = min(n_eigen, m)
    Y = torch.from_numpy(evecs[:, :n_eigen]).to(V.dtype)
    vecs = (V.T @ Y).T
    vecs = vecs / torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    return evals[:n_eigen], vecs


def _start_vector(dim: int, seed: int, dtype) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    re = torch.randn(dim, generator=gen, dtype=rdt)
    im = torch.randn(dim, generator=gen, dtype=rdt)
    return torch.complex(re, im)


def _embed(v: torch.Tensor, idx: np.ndarray, n_qubits: int) -> torch.Tensor:
    full = torch.zeros(1 << n_qubits, dtype=v.dtype)
    full[torch.from_numpy(idx)] = v
    return full


def ground_state(
    hamiltonian: PauliSum,
    n_qubits: int,
    n_electrons: int,
    spin_up: int,
    spin_down: int,
    k: int = None,
    dtype=torch.complex128,
    seed: int = 7,
) -> Tuple[float, torch.Tensor]:
    """Sector-restricted ground state (energy, full-space state)."""
    dim_sector = sector_dimension(n_electrons, spin_up, n_qubits)
    if k is None:
        k = int(min(max(2 * dim_sector, 8), 160))
    k = min(k, max(dim_sector, 2))
    mv, idx = _sector_matvec(hamiltonian, n_qubits, n_electrons, spin_up, spin_down)
    v0 = _start_vector(dim_sector, seed, dtype)
    evals, vecs = lanczos_eigsh(mv, v0 / torch.linalg.vector_norm(v0), k=k, n_eigen=1)
    return float(evals[0]), _embed(vecs[0], idx, n_qubits)


def degenerate_ground_space(
    hamiltonian: PauliSum,
    n_qubits: int,
    n_electrons: int,
    spin_up: int,
    spin_down: int,
    n_states: int = 4,
    degeneracy_tol: float = 1e-6,
    k: int = 220,
    dtype=torch.complex128,
    seed: int = 7,
) -> Tuple[float, List[torch.Tensor]]:
    """Lowest (possibly degenerate) ground subspace, orthonormalized.

    One Krylov sequence finds one vector per degenerate eigenvalue, so each
    further state comes from a deflated restart: the states found so far
    are shifted up inside the matvec.  Stops at ``n_states`` or at the
    first energy above the ground energy by more than ``degeneracy_tol``.
    """
    dim_sector = sector_dimension(n_electrons, spin_up, n_qubits)
    k = min(k, dim_sector)
    mv, idx = _sector_matvec(hamiltonian, n_qubits, n_electrons, spin_up, spin_down)
    found: List[torch.Tensor] = []  # sector-coordinate eigenvectors
    energies: List[float] = []
    shift = None
    for s in range(n_states):
        v0 = _start_vector(dim_sector, seed + s, dtype)
        for u in found:
            v0 = v0 - torch.vdot(u, v0) * u
        v0 = v0 / torch.linalg.vector_norm(v0)
        if found:
            U = torch.stack(found)

            def matvec(v, _U=U, _s=shift):
                return mv(v) + _s * (_U.T @ (_U.conj() @ v))

        else:
            matvec = mv
        evals, vecs = lanczos_eigsh(matvec, v0, k=k, n_eigen=1)
        e, vec = float(evals[0]), vecs[0]
        if shift is None:
            shift = abs(e) * 10 + 10.0
        if energies and e > energies[0] + degeneracy_tol:
            break  # left the degenerate ground manifold
        for u in found:  # Gram-Schmidt against the states found
            vec = vec - torch.vdot(u, vec) * u
        found.append(vec / torch.linalg.vector_norm(vec))
        energies.append(e)
    return energies[0], [_embed(v, idx, n_qubits) for v in found]
