"""Dense and sparse matrices of packed Pauli sums (host, tests and ground truth).

Counterpart of ``qsfh_tpu/utils/dense.py``.  Qubit 0 is the most
significant bit of the statevector index: basis index ``b`` has qubit
``q`` set iff bit ``n - 1 - q`` of ``b`` is set, and a packed term
c X^x Z^z sends |b> to c (-1)^popcount(b & zb) |b ^ xb>, with xb, zb the
flat (bit-reversed) masks.  The sparse matrix is built here only;
``linalg.exact`` calls it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from ..engine.state import qmask_to_bmask
from ..ops.pauli import PauliSum

# the JAX module's name for the qubit-indexed -> flat mask reversal
_qubit_masks_to_bit_masks = qmask_to_bmask


def _term_signs(idx: np.ndarray, zb: int) -> np.ndarray:
    """(-1)^popcount(idx & zb) as float64."""
    return 1.0 - 2.0 * (np.bitwise_count(idx & zb) % 2).astype(np.float64)


def paulisum_to_sparse(op: PauliSum, n_qubits: int) -> scipy.sparse.csr_matrix:
    """2^n x 2^n CSR matrix of a Pauli sum (duplicate entries summed)."""
    dim = 1 << n_qubits
    idx = np.arange(dim, dtype=np.int64)
    rows, data = [], []
    for x, z, c in zip(op.x, op.z, op.c):
        rows.append(idx ^ qmask_to_bmask(int(x), n_qubits))
        data.append(complex(c) * _term_signs(idx, qmask_to_bmask(int(z), n_qubits)))
    if not rows:
        return scipy.sparse.csr_matrix((dim, dim), dtype=np.complex128)
    return scipy.sparse.coo_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.tile(idx, len(rows)))),
        shape=(dim, dim),
    ).tocsr()


def paulisum_to_dense(op: PauliSum, n_qubits: int) -> np.ndarray:
    return paulisum_to_sparse(op, n_qubits).toarray()


def apply_paulisum_dense(op: PauliSum, psi: np.ndarray, n_qubits: int) -> np.ndarray:
    """op |psi> term by term in numpy (golden tests)."""
    idx = np.arange(1 << n_qubits, dtype=np.int64)
    out = np.zeros(1 << n_qubits, dtype=np.complex128)
    for x, z, c in zip(op.x, op.z, op.c):
        signs = _term_signs(idx, qmask_to_bmask(int(z), n_qubits))
        out[idx ^ qmask_to_bmask(int(x), n_qubits)] += c * signs * psi
    return out
