"""iQCC Hamiltonian dressing on packed Pauli sums (host numpy).

Counterpart of ``qsfh_tpu/ops/dressing.py``: every product is a
vectorized XOR + popcount pass over the packed (x, z, c) arrays and
duplicate monomials merge in one lexsort (``PauliSum.simplify``).  The
JAX package hands sums of 2048 terms and more to its C++ ``dress_emit``
and ``merge_terms``; both merges lexsort by (x, z), so the terms and their
order agree here and only the summation rounding of merged coefficients
can differ.  An optional ``compaction_eps`` budget and ``max_terms`` cap
drop the smallest-|c| terms and report the dropped weight.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .pauli import PauliSum


def _generator(x: int) -> Tuple[Tuple[int, ...], PauliSum]:
    """(flips, P = Y_{i0} X_{i1} ... X_{ik}) of a nonzero qubit flip mask."""
    flips = tuple(q for q in range(x.bit_length()) if (x >> q) & 1)
    label = " ".join(("Y" if i == 0 else "X") + str(q) for i, q in enumerate(flips))
    return flips, PauliSum.from_string(label)


def dis_generators(hamiltonian: PauliSum) -> List[Tuple[Tuple[int, ...], PauliSum]]:
    """Direct-interaction-set generators from the flip-index partition: one
    generator Y X..X (Y on the smallest flip index) per distinct nonzero x
    mask, in order of first appearance in the term list."""
    seen = set()
    out = []
    for x in hamiltonian.x:
        x = int(x)
        if x and x not in seen:
            seen.add(x)
            out.append(_generator(x))
    return out


def dress_once(hamiltonian: PauliSum, P: PauliSum, tau: float) -> PauliSum:
    """H <- exp(+i tau P / 2) H exp(-i tau P / 2) for a Hermitian P.

    For one Hermitian string (P^2 = I, all the DIS produces) the commuting
    terms pass through and each anticommuting c T becomes cos(tau) c T -
    i sin(tau) c (T P): one pass and one merge.  Otherwise the generic
    H + sin(tau)(-i/2)[H, P] + (1 - cos(tau))/2 (P H P - H).
    """
    if len(P) == 1:
        px, pz, pc = P.x[0], P.z[0], complex(P.c[0])
        p2 = pc * pc * (1.0 - 2.0 * (int(np.bitwise_count(px & pz)) % 2))
        if abs(p2 - 1.0) < 1e-12:
            H = hamiltonian
            anti = (np.bitwise_count(H.z & px) + np.bitwise_count(H.x & pz)).astype(
                np.int64) % 2 == 1
            xa, za, ca = H.x[anti], H.z[anti], H.c[anti]
            # (c X^x Z^z)(pc X^px Z^pz) = c pc (-1)^{|z & px|} X^{x^px} Z^{z^pz}
            sign = 1.0 - 2.0 * (np.bitwise_count(za & px).astype(np.int64) % 2)
            c_new = (-1j * np.sin(tau) * pc) * ca * sign
            c_keep = H.c.copy()
            c_keep[anti] = ca * np.cos(tau)
            return PauliSum(
                np.concatenate([H.x, xa ^ px]),
                np.concatenate([H.z, za ^ pz]),
                np.concatenate([c_keep, c_new]),
            ).simplify()
    HP = hamiltonian * P
    PH = P * hamiltonian
    PHP = P * HP
    dressed = (
        hamiltonian
        + (np.sin(tau) * -0.5j) * (HP - PH)
        + (0.5 * (1.0 - np.cos(tau))) * (PHP - hamiltonian)
    )
    return dressed.simplify()


def compact(hamiltonian: PauliSum, epsilon: float) -> Tuple[PauliSum, int, float]:
    """Drop the smallest-|c| tail whose total weight fits in ``epsilon``.

    Each Pauli string has unit operator norm, so the dropped weight bounds
    the shift of every eigenvalue (Weyl).  Returns ``(compacted, n_dropped,
    dropped_weight)``.
    """
    if epsilon <= 0.0 or len(hamiltonian) == 0:
        return hamiltonian, 0, 0.0
    a = np.abs(hamiltonian.c)
    order = np.argsort(a)
    csum = np.cumsum(a[order])
    k = int(np.searchsorted(csum, epsilon, side="right"))
    if k == 0:
        return hamiltonian, 0, 0.0
    keep = np.sort(order[k:])
    H = PauliSum(hamiltonian.x[keep], hamiltonian.z[keep], hamiltonian.c[keep])
    return H, k, float(csum[k - 1])


def dress_hamiltonian(
    hamiltonian: PauliSum,
    generators: Sequence[PauliSum],
    taus: Sequence[float],
    max_terms: Optional[int] = None,
    compaction_eps: Optional[float] = None,
) -> Tuple[PauliSum, int, float]:
    """Dress by each (P_k, tau_k) in REVERSED order, then drop terms: first
    within the ``compaction_eps`` budget (:func:`compact`), then down to
    ``max_terms`` by magnitude.  Returns ``(dressed, n_dropped,
    dropped_weight)``, the weight bounding this epoch's eigenvalue shift."""
    H = hamiltonian
    for P, tau in zip(reversed(list(generators)), reversed(list(taus))):
        H = dress_once(H, P, float(tau))
    dropped = 0
    weight = 0.0
    if compaction_eps is not None:
        H, dropped, weight = compact(H, float(compaction_eps))
    if max_terms is not None and len(H) > max_terms:
        order = np.argsort(np.abs(H.c))[::-1]
        keep = np.sort(order[:max_terms])
        dropped += len(H) - max_terms
        weight += float(np.abs(H.c[order[max_terms:]]).sum())
        H = PauliSum(H.x[keep], H.z[keep], H.c[keep])
    return H, dropped, weight
