"""Entanglement diagnostics: reduced density matrices and entropies.

Counterpart of ``qsfh_tpu/ops/entanglement.py``, in torch on the state's
device: the exact partial trace is a permute of the ``(2,)*n`` factor
tensor so the kept qubits lead and a reshape to ``(2^k, 2^{n-k})``, then
either the singular values (entropy only, never the density matrix) or
``M M^dag`` (the reduced density matrix itself).  Qubit q is flat-index
bit n-1-q, so it occupies axis q of the row-major factor tensor.

A state given as a tensor is read on its device; a numpy state goes to
``resolve_device(device)`` (the card unless ``device="cpu"``).  Entropies
come back as Python floats, the density matrix as a tensor.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..algos.base import state_on_device

__all__ = [
    "reduced_density_matrix",
    "entanglement_entropy",
    "renyi_entropy",
    "mutual_information",
    "site_qubits",
]


def site_qubits(sites: Sequence[int]) -> tuple:
    """Spin-orbital qubits of the given lattice sites (up on even JW modes,
    ops/lattice.py)."""
    out = []
    for s in sites:
        out.extend((2 * s, 2 * s + 1))
    return tuple(out)


def _lead_matrix(psi, n: int, keep: Sequence[int], device=None) -> torch.Tensor:
    """Reshape so the kept qubits index rows: ``M[a, b] = <a_keep, b_rest|psi>``."""
    keep = list(keep)
    if len(set(keep)) != len(keep):
        raise ValueError("duplicate qubits in subsystem")
    if not all(0 <= q < n for q in keep):
        raise ValueError("subsystem qubit out of range")
    rest = [q for q in range(n) if q not in keep]
    t = state_on_device(psi, device).reshape((2,) * n).permute(keep + rest)
    return t.reshape(1 << len(keep), 1 << len(rest))


def reduced_density_matrix(psi, n: int, keep: Sequence[int], device=None) -> torch.Tensor:
    """``rho_A = Tr_B |psi><psi|`` over the kept qubits, ``(2^k, 2^k)``
    with rows indexed by the kept qubits in the order given."""
    m = _lead_matrix(psi, n, keep, device)
    return m @ m.conj().T


def _schmidt_squared(psi, n: int, keep: Sequence[int], device=None) -> torch.Tensor:
    m = _lead_matrix(psi, n, keep, device)
    # the singular values of the smaller orientation
    if m.shape[0] > m.shape[1]:
        m = m.T
    p = torch.linalg.svdvals(m) ** 2
    return p / p.sum()  # guard tiny normalization drift


def entanglement_entropy(psi, n: int, keep: Sequence[int], base: float = math.e,
                         device=None) -> float:
    """Von Neumann entropy ``S(rho_A) = -Tr rho_A log rho_A`` of the kept
    qubits (``base=2`` for bits; default nats)."""
    p = _schmidt_squared(psi, n, keep, device)
    p = p[p > 1e-16]
    return float(-(p * torch.log(p)).sum() / math.log(base))


def renyi_entropy(psi, n: int, keep: Sequence[int], alpha: float = 2.0, base: float = math.e,
                  device=None) -> float:
    """Renyi-``alpha`` entropy ``(1-alpha)^-1 log Tr rho_A^alpha``
    (``alpha -> 1`` recovers von Neumann; ``alpha=2`` is the purity form
    measurable via swap tests)."""
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    if abs(alpha - 1.0) < 1e-9:
        return entanglement_entropy(psi, n, keep, base, device)
    p = _schmidt_squared(psi, n, keep, device)
    return float(torch.log((p ** alpha).sum()) / (1.0 - alpha) / math.log(base))


def mutual_information(psi, n: int, a: Sequence[int], b: Sequence[int], base: float = math.e,
                       device=None) -> float:
    """``I(A:B) = S_A + S_B - S_AB`` (>= 0; bounds every connected
    correlator between the regions)."""
    if set(a) & set(b):
        raise ValueError("regions must be disjoint")
    sa = entanglement_entropy(psi, n, a, base, device)
    sb = entanglement_entropy(psi, n, b, base, device)
    sab = entanglement_entropy(psi, n, list(a) + list(b), base, device)
    return sa + sb - sab
