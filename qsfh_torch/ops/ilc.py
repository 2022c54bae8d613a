"""iQCC-ILC: involutory-linear-combination folds for the dense backend.

Counterpart of ``qsfh_tpu/ops/ilc.py``.  For mutually anticommuting
Hermitian Pauli strings P_k and a real unit vector a, G = sum_k a_{k+1} P_k
squares to |b|^2 I, and U = a_0 I - i G is unitary; the states it reaches
from |psi> are a_0 |psi> - i sum_k a_{k+1} P_k |psi>, whose energy is
a^T A a with A_ij = Re <v_i|H|v_j>, v_0 = psi, v_k = -i P_k psi, and a
unit norm (the cross terms of the Gram matrix vanish).  The best fold is
the lowest eigenvector of A; its eigenvalue is the folded energy.

The matrix work (V, W = H V, the subspace matrices, the fold's row and
column passes) runs in complex128 on the dense Hamiltonian's device.  The
subset choice stays on the host: the scores come back, the Gumbel draws
are ``np.random.default_rng(seed)``'s (the same seed gives the JAX
package's sets), and the (M+1)-dimensional eigenproblems are numpy's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..engine.state import index_bits
from .dense_dressing import _string_row_data
from .pauli import PauliSum

__all__ = [
    "pauli_anticommute",
    "string_column",
    "ilc_scores",
    "greedy_anticommuting_set",
    "candidate_anticommuting_sets",
    "fold_ilc_dense",
    "ilc_step_dense",
]


def pauli_anticommute(x1: int, z1: int, x2: int, z2: int) -> bool:
    """True iff the Hermitian strings (x1, z1), (x2, z2) anticommute
    (popcount(x1 & z2) + popcount(x2 & z1) odd)."""
    return (int(x1 & z2).bit_count() + int(x2 & z1).bit_count()) % 2 == 1


def string_column(P: PauliSum, psi: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """P |psi> for a single Hermitian Pauli string."""
    xb, data = _string_row_data(P, n_qubits, psi.device)
    perm = index_bits(n_qubits, psi.device) ^ xb
    return (data * psi).index_select(0, perm)


def _columns(gens: Sequence[PauliSum], psi: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """V[:, k] = -i P_k |psi>, (2^n, K) complex128."""
    V = torch.empty((psi.shape[0], len(gens)), dtype=torch.complex128, device=psi.device)
    for k, P in enumerate(gens):
        V[:, k] = -1j * string_column(P, psi, n_qubits)
    return V


def ilc_scores(
    H: torch.Tensor, psi: torch.Tensor, gens: Sequence[PauliSum], n_qubits: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Per-generator 2x2 subspace gains: V[:, k] = -i P_k psi, one ZGEMM
    W = H V, then per k the lowest eigenvalue of [[E0, A0k], [A0k, Bkk]].
    Returns host (scores, A0, Bdiag, E0) with score_k = E0 - lambda_k."""
    psi = psi.to(torch.complex128)
    E0 = float(torch.real(torch.vdot(psi, H @ psi)))
    V = _columns(gens, psi, n_qubits)
    W = H @ V
    A0 = torch.real(psi.conj() @ W).cpu().numpy()
    Bd = torch.real((V.conj() * W).sum(dim=0)).cpu().numpy()
    half = 0.5 * (E0 + Bd)
    rad = np.sqrt(0.25 * (E0 - Bd) ** 2 + A0**2)
    return E0 - (half - rad), A0, Bd, E0


def _anticommute_matrix(gens: Sequence[PauliSum]) -> np.ndarray:
    """anti[i, j]: generators i and j anticommute."""
    x = np.array([int(P.x[0]) for P in gens], dtype=np.uint64)
    z = np.array([int(P.z[0]) for P in gens], dtype=np.uint64)
    odd = np.bitwise_count(x[:, None] & z[None, :]) + np.bitwise_count(x[None, :] & z[:, None])
    return odd % 2 == 1


def greedy_anticommuting_set(
    gens: Sequence[PauliSum], scores: np.ndarray, cap: int, anti=None
) -> List[int]:
    """Indices of a mutually anticommuting subset, greedily by descending
    score (ties broken by list order)."""
    return _greedy_from_order(gens, np.argsort(-scores, kind="stable"), cap, anti)


def _greedy_from_order(gens: Sequence[PauliSum], order, cap: int, anti=None) -> List[int]:
    """Walk ``order`` and keep each generator that anticommutes with every
    one kept so far, up to ``cap``: the JAX package's loop, with the
    compatible set kept as one mask over the generators."""
    if anti is None:
        anti = _anticommute_matrix(gens)
    order = np.asarray(order, dtype=np.int64)
    ok = np.ones(len(gens), dtype=bool)
    chosen: List[int] = []
    pos = 0
    while len(chosen) < cap and pos < order.size:
        fits = ok[order[pos:]]
        hit = int(np.argmax(fits))
        if not fits[hit]:
            break
        i = int(order[pos + hit])
        chosen.append(i)
        ok &= anti[i]
        pos += hit + 1
    return chosen


def candidate_anticommuting_sets(
    gens: Sequence[PauliSum],
    scores: np.ndarray,
    cap: int,
    restarts: int = 16,
    seed: int = 0,
) -> List[List[int]]:
    """Anticommuting subsets to rank by realized subspace gain: the
    score-greedy set, ``restarts`` score-biased random orders (Gumbel
    perturbations of the log-scores), and ``restarts`` sets seeded by each
    top scorer and filled by descending score; deduplicated."""
    rng = np.random.default_rng(seed)
    anti = _anticommute_matrix(gens)
    base = np.log(np.maximum(scores, 1e-300))
    cands: List[List[int]] = [greedy_anticommuting_set(gens, scores, cap, anti)]
    for _ in range(restarts):
        noisy = base + rng.gumbel(size=len(base))
        cands.append(_greedy_from_order(gens, np.argsort(-noisy), cap, anti))
    rest = np.argsort(-scores, kind="stable")
    for t in rest[: max(1, restarts)]:
        order = np.concatenate(([t], rest[rest != t]))
        cands.append(_greedy_from_order(gens, order, cap, anti))
    seen, out = set(), []
    for c in cands:
        key = tuple(sorted(c))
        if c and key not in seen:
            seen.add(key)
            out.append(c)
    return out


def fold_ilc_dense(
    H: torch.Tensor, sub: Sequence[PauliSum], a, n_qubits: int
) -> torch.Tensor:
    """U^dag H U for U = a_0 I - i sum_k a_{k+1} P_k without forming U:
    a_0^2 H + i a_0 (G H - H G) + G H G with G = sum_k a_{k+1} P_k, each
    P_k M a row pass and M P_k a column pass over the matrix (O(M 4^n)
    instead of the ZGEMM pair's O(8^n))."""
    idx = index_bits(n_qubits, H.device)
    a0 = float(a[0])
    b = np.asarray(a[1:], dtype=np.float64)
    rc = [_string_row_data(P, n_qubits, H.device) for P in sub]
    GH = torch.zeros_like(H)
    for (xb, data), bk in zip(rc, b):
        perm = idx ^ xb  # (P_k H)[i ^ xb, :] = d[i] H[i, :]
        GH += float(bk) * (data[:, None] * H).index_select(0, perm)
    HG = torch.zeros_like(H)
    GHG = torch.zeros_like(H)
    for (xb, data), bk in zip(rc, b):
        perm = idx ^ xb
        HG += float(bk) * (H.index_select(1, perm) * data[None, :])
        GHG += float(bk) * (GH.index_select(1, perm) * data[None, :])
    return a0 * a0 * H + 1j * a0 * (GH - HG) + GHG


def ilc_step_dense(
    H: torch.Tensor,
    psi: torch.Tensor,
    gens: Sequence[PauliSum],
    n_qubits: int,
    cap: int = 32,
    restarts: int = 16,
) -> Tuple[torch.Tensor, float, dict]:
    """One ILC fold: rank the candidate anticommuting subsets of ``gens`` by
    their subspace eigenvalue, fold the best one's unitary into ``H``.
    Returns ``(H_folded, E_pred, info)``; ``E_pred`` is the folded
    Hamiltonian's energy at ``psi``."""
    psi = psi.to(torch.complex128)
    scores, _, _, E0 = ilc_scores(H, psi, gens, n_qubits)

    def subspace(sel):
        sub = [gens[i] for i in sel]
        V = torch.cat([psi[:, None], _columns(sub, psi, n_qubits)], dim=1)
        A = torch.real(V.conj().T @ (H @ V)).cpu().numpy()
        A = 0.5 * (A + A.T)
        evals, evecs = np.linalg.eigh(A)
        a = evecs[:, 0]
        if a[0] < 0:
            a = -a
        return sub, a, float(evals[0])

    best = None
    for sel in candidate_anticommuting_sets(gens, scores, cap, restarts=restarts):
        sub, a, e_sub = subspace(sel)
        if best is None or e_sub < best[2]:
            best = (sub, a, e_sub)
    if best is None:
        return H, E0, {"selected": 0, "E0": E0}
    sub, a, e_sub = best
    info = {
        "selected": len(sub),
        "E0": E0,
        "E_pred": e_sub,
        "gain": float(E0 - e_sub),
        "best_single_gain": float(scores.max()),
        "a0": float(a[0]),
        "labels": [P.to_terms()[0][0] for P in sub],
    }
    return fold_ilc_dense(H, sub, a, n_qubits), e_sub, info
