"""Exact dense-matrix iQCC dressing for small qubit counts.

Counterpart of ``qsfh_tpu/ops/dense_dressing.py``.  The dressed
Hamiltonian is kept as the 2^n x 2^n complex128 matrix (268 MB at 12
qubits) on the device it was made on: the similarity transform U^dag H U
is U's rotation passes and then two ZGEMMs per epoch, exact (no
truncation), and the Pauli decomposition that DIS selection needs comes
back from a fast Walsh-Hadamard transform over the XOR-diagonals in
O(4^n n).  The JAX package computes all of this in host numpy; here each
function is torch on the matrix's device, and the generator lists and
term counts come back to the host.

Conventions match :mod:`qsfh_torch.utils.dense`: qubit 0 is the most
significant bit, and a packed term c X^x Z^z contributes
M[b ^ xb, b] = c (-1)^popcount(zb & b), xb and zb the flat (bit-reversed)
masks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..engine.state import index_bits, parity_signs, qmask_to_bmask
from .dressing import _generator
from .pauli import PauliSum

__all__ = [
    "fwht",
    "dense_to_paulisum",
    "paulisum_to_dense_fast",
    "dense_dis_generators",
    "dressing_unitary",
    "similarity",
    "dress_dense",
    "DenseObservable",
]


def fwht(a: torch.Tensor) -> torch.Tensor:
    """Walsh-Hadamard transform along the LAST axis (unnormalized):
    out[..., t] = sum_b (-1)^popcount(t & b) a[..., b].  A new tensor."""
    dim = a.shape[-1]
    lead = a.shape[:-1]
    h = 1
    while h < dim:
        v = a.reshape(*lead, dim // (2 * h), 2, h)
        x, y = v[..., 0, :], v[..., 1, :]
        a = torch.stack((x + y, x - y), dim=-2).reshape(*lead, dim)
        h *= 2
    return a


def _xor_rows(dim: int, device) -> torch.Tensor:
    """R[xf, b] = b ^ xf, the row of M that XOR-diagonal xf reads at column b."""
    idx = index_bits(dim.bit_length() - 1, device)
    return idx[None, :] ^ idx[:, None]


def _xor_diagonals(M: torch.Tensor) -> torch.Tensor:
    """V[xf, b] = M[b ^ xf, b]."""
    dim = M.shape[0]
    return M.gather(0, _xor_rows(dim, M.device))


def _flat_to_qubit(n_qubits: int) -> np.ndarray:
    """The n-bit reversal (an involution) between flat and qubit masks."""
    idx = np.arange(1 << n_qubits, dtype=np.int64)
    rev = np.zeros(1 << n_qubits, dtype=np.int64)
    for q in range(n_qubits):
        rev |= ((idx >> (n_qubits - 1 - q)) & 1) << q
    return rev


def _check_square(M: torch.Tensor, n_qubits: int) -> int:
    dim = 1 << n_qubits
    if tuple(M.shape) != (dim, dim):
        raise ValueError(f"expected ({dim}, {dim}) matrix")
    return dim


def dense_to_paulisum(M: torch.Tensor, n_qubits: int, tol: float = 1e-10) -> PauliSum:
    """Exact Pauli decomposition of a 2^n x 2^n matrix:
    c(x, z) = 2^-n sum_b M[b ^ xb, b] (-1)^popcount(zb & b), one FWHT over
    the XOR-diagonals; terms with |c| <= ``tol`` are dropped.  Terms come in
    flat (xf, zf) row-major order, masks qubit-indexed."""
    dim = _check_square(M, n_qubits)
    C = fwht(_xor_diagonals(M)) / dim
    xf, zf = torch.nonzero(C.abs() > tol, as_tuple=True)
    c = C[xf, zf].cpu().numpy()
    rev = _flat_to_qubit(n_qubits)
    xf, zf = xf.cpu().numpy(), zf.cpu().numpy()
    return PauliSum(rev[xf].astype(np.uint64), rev[zf].astype(np.uint64), c)


def paulisum_to_dense_fast(P: PauliSum, n_qubits: int, device="cpu") -> torch.Tensor:
    """The complex128 matrix of a Pauli sum on ``device`` in O(4^n n)
    whatever the term count: the coefficients scattered into C[xf, zf], one
    FWHT, the XOR-diagonals scattered back (the inverse of
    :func:`dense_to_paulisum`)."""
    dim = 1 << n_qubits
    rev = _flat_to_qubit(n_qubits)
    xf = torch.as_tensor(rev[P.x.astype(np.int64)])
    zf = torch.as_tensor(rev[P.z.astype(np.int64)])
    # the scatter (duplicates summed) on the host, the transform on device
    C = torch.zeros((dim, dim), dtype=torch.complex128)
    C.index_put_((xf, zf), torch.as_tensor(P.c), accumulate=True)
    V = fwht(C.to(device))  # V[xf, b] = sum_z c(xf, z) (-1)^popcount(zf & b)
    M = torch.empty_like(V)
    return M.scatter_(0, _xor_rows(dim, device), V)


def dense_dis_generators(
    M: torch.Tensor, n_qubits: int, tol: float = 1e-10
) -> Tuple[List[Tuple[Tuple[int, ...], PauliSum]], int]:
    """DIS generators straight from the dense matrix: one per distinct
    nonzero qubit flip mask with any |c| > ``tol`` (each XOR-diagonal's
    FWHT row holds its z-resolved coefficients), in ASCENDING qubit x-mask
    order -- the order the symbolic route yields on a lexsorted sum, which
    breaks gradient ties by list position.  Returns (generators, the count
    of terms with |c| > ``tol``)."""
    dim = _check_square(M, n_qubits)
    C = fwht(_xor_diagonals(M)).abs() / dim
    nnz = int((C > tol).sum())
    weight = C.max(dim=1).values.cpu().numpy()
    rev = _flat_to_qubit(n_qubits)
    return [_generator(int(x)) for x in np.sort(rev[weight > tol]) if x], nnz


def _string_row_data(P: PauliSum, n_qubits: int, device):
    """(xb, data) of a single Hermitian string: M[b ^ xb, b] = data[b]."""
    if len(P.c) != 1:
        raise ValueError("generators must be single Pauli strings")
    xb = qmask_to_bmask(int(P.x[0]), n_qubits)
    zb = qmask_to_bmask(int(P.z[0]), n_qubits)
    signs = parity_signs(index_bits(n_qubits, device), zb, torch.float64)
    return xb, complex(P.c[0]) * signs


def dressing_unitary(
    generators: Sequence[PauliSum], taus: Sequence[float], n_qubits: int, device="cpu"
) -> torch.Tensor:
    """U_c = R_{K-1} ... R_0, R_k = exp(-i tau_k P_k / 2) = cos I - i sin P_k,
    as K row passes over the complex128 identity."""
    dim = 1 << n_qubits
    idx = index_bits(n_qubits, device)
    U = torch.eye(dim, dtype=torch.complex128, device=device)
    for P, tau in zip(generators, taus):
        xb, data = _string_row_data(P, n_qubits, device)
        c, s = np.cos(float(tau) / 2.0), np.sin(float(tau) / 2.0)
        # (P U)[b ^ xb] = data[b] U[b]  <=>  (P U) = (data U)[idx ^ xb]
        pu = (U * data[:, None]).index_select(0, idx ^ xb)
        pu *= -1j * s
        U *= c
        U += pu
    return U


def similarity(U: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """U^dag H U: the ZGEMM pair."""
    return U.conj().T @ H @ U


def dress_dense(
    H: torch.Tensor, generators: Sequence[PauliSum], taus: Sequence[float], n_qubits: int
) -> torch.Tensor:
    """U_c^dag H U_c on H's device, the dense-exact equivalent of
    ``ops.dressing.dress_hamiltonian`` (the same reversed-application
    semantics)."""
    return similarity(dressing_unitary(generators, taus, n_qubits, H.device), H)


class DenseObservable:
    """The two Observable entry points the iQCC loop calls, backed by a copy
    of the dense matrix in the state's dtype (complex64 on the card, as
    ``jnp.asarray`` gives on the TPU); the complex128 master stays the
    dressing's authority.  Differentiable by autograd."""

    def __init__(self, H: torch.Tensor, n_qubits: int, dtype=torch.complex128):
        self.n = n_qubits
        self._H = H.to(dtype)

    def apply_auto(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        return self._H @ psi

    def expectation_auto(self, psi: torch.Tensor, impl=None) -> torch.Tensor:
        return torch.real(torch.vdot(psi, self._H @ psi))
