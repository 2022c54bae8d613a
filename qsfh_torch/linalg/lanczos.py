"""Lanczos ground-state solver over an (N, Sz) sector, on the card in complex128.

Counterpart of ``qsfh_tpu/linalg/lanczos.py`` (``lanczos_eigsh``,
``ground_state``, ``degenerate_ground_space``) with the same algorithm:
the Krylov basis in sector coordinates with full reorthogonalization (two
passes), breakdown at beta < 1e-12, k = min(max(2 dim, 8), 160) steps
(220 for the degenerate manifold), each further degenerate state from a
deflated restart (found states shifted up by |e| 10 + 10), and a
Gram-Schmidt pass over each state found.

Placement: the solver runs on ``resolve_device(device)``, the card unless
the caller asks for the CPU, in complex128.  The sector matrix, the start
vector, the Krylov basis and its reorthogonalization and the Ritz vectors
live there; only the tridiagonal problem goes to the host (numpy), as in
the JAX package, and the loop reads one number a step (beta, for the
breakdown test).

The matvec differs from the JAX package's, which scatters to the full
space, applies the packed Hamiltonian and gathers back: here the
Hamiltonian restricted to the sector is built once on the host as a CSR
matrix in sector coordinates from the port's own term arrays, one distinct
flip mask at a time (all x = 0 terms one diagonal; each other mask at most
one entry a row, the sum over its terms of c_t (-1)^popcount(b & z_t)),
and each matvec is one sparse product of torch's on the device (3x3:
15,876 rows; 2x6: 853,776).

Start vectors come from a seeded CPU ``torch.Generator`` (the same numbers
on every device), so they differ from the JAX package's ``jax.random``
draws: energies and subspaces agree, vectors only up to phase (and within
a degenerate manifold, a rotation).
"""

from __future__ import annotations

import warnings
from collections import defaultdict
from typing import Callable, List, Tuple

import numpy as np
import scipy.sparse
import torch

from ..engine.expectation import Observable
from ..engine.state import resolve_device
from ..ops.pauli import PauliSum
from .sectors import jw_number_spin_indices, sector_dimension

BREAKDOWN = 1e-12


def _parity_signs(v: np.ndarray, z: int) -> np.ndarray:
    return 1.0 - 2.0 * (np.bitwise_count(v & z) & 1).astype(np.float64)


def sector_hamiltonian(
    hamiltonian: PauliSum, n_qubits: int, n_electrons: int, spin_up: int, spin_down: int
) -> Tuple[scipy.sparse.csr_matrix, np.ndarray]:
    """(H restricted to the sector as a host CSR matrix in sector
    coordinates, the sector's flat indices).

    Built one distinct flip mask x at a time: row r, column
    pos(idx[r] ^ x) gains sum_{t: x_t = x} c_t (-1)^popcount(idx[r] & z_t)
    (the reorder sign folded into c_t, as ``Observable`` does), the x = 0
    terms forming the diagonal; entries whose column leaves the sector
    cancel in H, which conserves (N, Sz), and are dropped.  A mask gives a
    row at most one entry, so no entry list per term is built."""
    idx = np.asarray(
        jw_number_spin_indices(n_electrons, spin_up, spin_down, n_qubits), dtype=np.int64)
    dim = idx.size
    pos = np.full(1 << n_qubits, -1, dtype=np.int32 if dim < 2**31 else np.int64)
    pos[idx] = np.arange(dim)
    xs, zs, cre, cim = Observable(hamiltonian, n_qubits)._scan_terms()
    by_mask = defaultdict(list)
    for x, z, c in zip(xs.tolist(), zs.tolist(), (cre + 1j * cim).tolist()):
        by_mask[x].append((z, c))
    r = np.arange(dim, dtype=np.int64)
    rows, cols, data = [], [], []
    for x, terms in by_mask.items():
        col = pos[idx ^ x]
        keep = col >= 0
        src = idx[keep]
        val = np.zeros(src.size, dtype=np.complex128)
        for z, c in terms:
            val += c * _parity_signs(src, z)
        rows.append(r[keep])
        cols.append(col[keep].astype(np.int64))
        data.append(val)
    mat = scipy.sparse.csr_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))), shape=(dim, dim))
    mat.eliminate_zeros()
    return mat, idx


def device_matrix(mat: scipy.sparse.csr_matrix, device) -> torch.Tensor:
    """A host CSR matrix as a complex128 torch CSR tensor on ``device``,
    with int64 row offsets and column indices."""
    with warnings.catch_warnings():  # torch flags its CSR layout as beta
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
        warnings.filterwarnings("ignore", message="Sparse invariant checks")
        return torch.sparse_csr_tensor(
            torch.from_numpy(mat.indptr.astype(np.int64)).to(device),
            torch.from_numpy(mat.indices.astype(np.int64)).to(device),
            torch.from_numpy(mat.data.astype(np.complex128)).to(device),
            size=mat.shape,
            check_invariants=False,
        )


def _sector_matvec(hamiltonian, n_qubits, n_electrons, spin_up, spin_down, device):
    """(matvec over sector coordinates on complex128 tensors on
    ``device``, sector index array)."""
    mat, idx = sector_hamiltonian(hamiltonian, n_qubits, n_electrons, spin_up, spin_down)
    csr = device_matrix(mat, device)
    return (lambda v: csr @ v), idx


def _lanczos_basis(matvec: Callable, v0: torch.Tensor, k: int):
    """Up to k Lanczos steps with full reorthogonalization (two passes),
    on v0's device.

    Returns (alphas, betas, V): alphas and betas as host arrays, V the
    m <= k basis vectors as rows, m the steps taken before breakdown
    (beta < ``BREAKDOWN``: the one host read of a step).
    """
    dim = v0.shape[0]
    V = torch.zeros((k, dim), dtype=v0.dtype, device=v0.device)
    v = v0 / torch.linalg.vector_norm(v0)
    V[0] = v
    alphas, betas = [], []
    beta_prev, v_prev = 0.0, torch.zeros_like(v)
    for j in range(k):
        w = matvec(v)
        alpha = torch.vdot(v, w).real
        w = w - alpha * v - beta_prev * v_prev
        basis = V[: j + 1]
        for _ in range(2):  # overlaps conj(V) w as conj(V conj(w)): no conjugated copy of V
            w = w - torch.mv(basis.T, torch.mv(basis, w.conj()).conj())
        beta = torch.linalg.vector_norm(w)
        alphas.append(alpha)
        betas.append(beta)
        if j + 1 == k or float(beta) < BREAKDOWN:
            break
        v_prev, v = v, w / beta
        V[j + 1] = v
        beta_prev = beta
    m = len(alphas)
    return (torch.stack(alphas).cpu().numpy(), torch.stack(betas).cpu().numpy(), V[:m])


def lanczos_eigsh(
    matvec: Callable, v0: torch.Tensor, k: int = 80, n_eigen: int = 1
) -> Tuple[np.ndarray, torch.Tensor]:
    """Lowest ``n_eigen`` eigenpairs of the Hermitian operator ``matvec``.

    Returns (eigenvalues [numpy, ascending], eigenvectors [n_eigen, dim]
    on v0's device).
    """
    alphas, betas, V = _lanczos_basis(matvec, v0, k)
    m = alphas.size
    T = np.diag(alphas)
    if m > 1:
        off = betas[: m - 1]
        T += np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(T)
    n_eigen = min(n_eigen, m)
    Y = torch.from_numpy(evecs[:, :n_eigen]).to(device=V.device, dtype=V.dtype)
    vecs = (V.T @ Y).T
    vecs = vecs / torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    return evals[:n_eigen], vecs


def _start_vector(dim: int, seed: int, dtype, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    re = torch.randn(dim, generator=gen, dtype=rdt)
    im = torch.randn(dim, generator=gen, dtype=rdt)
    return torch.complex(re, im).to(device)


def _embed(v: torch.Tensor, idx: np.ndarray, n_qubits: int) -> torch.Tensor:
    full = torch.zeros(1 << n_qubits, dtype=v.dtype, device=v.device)
    full[torch.from_numpy(idx).to(v.device)] = v
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
    device=None,
) -> Tuple[float, torch.Tensor]:
    """Sector-restricted ground state (energy, full-space state on
    ``resolve_device(device)``)."""
    dev = resolve_device(device)
    dim_sector = sector_dimension(n_electrons, spin_up, n_qubits)
    if k is None:
        k = int(min(max(2 * dim_sector, 8), 160))
    k = min(k, max(dim_sector, 2))
    mv, idx = _sector_matvec(hamiltonian, n_qubits, n_electrons, spin_up, spin_down, dev)
    v0 = _start_vector(dim_sector, seed, dtype, dev)
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
    device=None,
) -> Tuple[float, List[torch.Tensor]]:
    """Lowest (possibly degenerate) ground subspace, orthonormalized, as
    full-space states on ``resolve_device(device)``.

    One Krylov sequence finds one vector per degenerate eigenvalue, so each
    further state comes from a deflated restart: the states found so far
    are shifted up inside the matvec.  Stops at ``n_states`` or at the
    first energy above the ground energy by more than ``degeneracy_tol``.
    """
    dev = resolve_device(device)
    dim_sector = sector_dimension(n_electrons, spin_up, n_qubits)
    k = min(k, dim_sector)
    mv, idx = _sector_matvec(hamiltonian, n_qubits, n_electrons, spin_up, spin_down, dev)
    found: List[torch.Tensor] = []  # sector-coordinate eigenvectors
    energies: List[float] = []
    shift = None
    for s in range(n_states):
        v0 = _start_vector(dim_sector, seed + s, dtype, dev)
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
