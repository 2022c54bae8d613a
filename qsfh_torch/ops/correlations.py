"""Static correlation functions and structure factors.

Counterpart of ``qsfh_tpu/ops/correlations.py``: equal-time two-point
correlators of lattice states (the spin and density correlation matrices,
the one-body density matrix, the on-site pair correlator), the momentum-
space fluctuation operators that seed the Lanczos resolvent, and the
host-side Fourier sums (structure factor, momentum distribution).

Conventions: row-major sites ``s = x + y*nx``; spin-up on even JW modes;
per site ``S_z(s) = (n_up - n_dn)/2``, ``S_+(s) = c^dag_up c_dn``, so
``<S_i . S_j>`` sums the three Cartesian components.

Evaluation.  Each matrix is a list of entries, each entry the Hermitian
Jordan-Wigner sum of one site pair (two per off-diagonal entry of rho and
P: ``A = O + O^dag`` and ``B = -i (O - O^dag)``, so ``O = (<A> + i <B>)/2``).
``route="layout"`` evaluates the whole list at once: the entries' terms
concatenated into ONE flat term list with an entry index per term (no
merging of equal strings across entries: single-site Z strings recur in
many pairs), one inner-product layout (``streaming.GroupTiles``, built once
per matrix and cached), one ``pauli_inner_grouped`` call returning
<psi|P_t|psi> per term (``pauli_inner`` below ``INNER_TILE_MIN_BITS``
qubits), then Re(c_t v_t) folded in torch and summed by entry with
``engine.state.IndexFold`` (the same bits on every call).  ``route="loop"`` is the JAX module's form: one
``Observable`` per entry, its plain ``expectation``.  ``route="auto"``
takes the layout on the card and the loop on the CPU.  A numpy state goes
to ``resolve_device(device)``; a tensor is read on its device.  Matrices
come back as host numpy arrays, as the JAX module returns them.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..algos.base import state_on_device
from ..engine.expectation import Observable, _device_terms, _groups
from ..engine.kernels import INNER_TILE_MIN_BITS, pauli_inner, pauli_inner_grouped
from ..engine.state import IndexFold
from .fermion import FermionOperator
from .jw import jordan_wigner
from .pauli import PauliSum

__all__ = [
    "site_number_operator",
    "site_spin_z",
    "spin_spin_operator",
    "correlation_matrix",
    "structure_factor",
    "one_body_density_matrix",
    "momentum_distribution",
    "pair_correlation_matrix",
    "spin_q_operator",
    "charge_q_operator",
    "EntryTerms",
]

ROUTES = ("auto", "layout", "loop")


def site_number_operator(site: int) -> FermionOperator:
    up, dn = 2 * site, 2 * site + 1
    return FermionOperator(((up, 1), (up, 0))) + FermionOperator(((dn, 1), (dn, 0)))


def site_spin_z(site: int) -> FermionOperator:
    up, dn = 2 * site, 2 * site + 1
    return 0.5 * (
        FermionOperator(((up, 1), (up, 0))) - FermionOperator(((dn, 1), (dn, 0)))
    )


def _site_spin_pm(site: int, plus: bool) -> FermionOperator:
    up, dn = 2 * site, 2 * site + 1
    return FermionOperator(((up, 1), (dn, 0))) if plus else FermionOperator(((dn, 1), (up, 0)))


def spin_spin_operator(i: int, j: int) -> FermionOperator:
    """``S_i . S_j = Sz_i Sz_j + (S+_i S-_j + S-_i S+_j)/2``."""
    op = site_spin_z(i) * site_spin_z(j)
    op += 0.5 * (_site_spin_pm(i, True) * _site_spin_pm(j, False))
    op += 0.5 * (_site_spin_pm(i, False) * _site_spin_pm(j, True))
    return op


# -- the one-layout evaluation ---------------------------------------------------------


class EntryTerms:
    """Hermitian Pauli sums (the entries of a matrix) as ONE flat term list.

    Per term: flat masks (xb, zb) and the coefficient with the reorder
    sign, exactly as ``Observable`` lowers one sum, and ``entry``, the
    index of the sum it came from.  Equal strings of different entries
    stay separate terms.  The inner-product layout of the whole list and
    the device tensors are built once, at first use.
    """

    def __init__(self, ops: Sequence[PauliSum], n_qubits: int):
        self.n = n_qubits
        self.ops = list(ops)
        self.n_entries = len(ops)
        parts = [Observable(op, n_qubits)._scan_terms() for op in ops]
        self.arrays = tuple(np.concatenate([p[i] for p in parts]) for i in range(4))
        self.entry = np.repeat(np.arange(self.n_entries), [len(p[0]) for p in parts])
        self._cache = {}

    def __len__(self):
        return len(self.entry)

    def inner_groups(self):
        """The flat list's inner-product layout (built once)."""
        return _groups(self._cache, self.arrays, self.n, inner=True)

    def _entry_fold(self, psi):
        key = (str(psi.device), "entry")
        if key not in self._cache:
            self._cache[key] = IndexFold(self.entry, self.n_entries, psi.device)
        return self._cache[key]

    def term_values(self, psi: torch.Tensor) -> torch.Tensor:
        """v_t = <psi|P_t|psi> for every term, in list order: one
        ``pauli_inner_grouped`` call over the layout (``pauli_inner`` below
        ``INNER_TILE_MIN_BITS`` qubits); their plain versions on the CPU."""
        xs, zs, _ = _device_terms(self._cache, self.arrays, psi)
        if self.n < INNER_TILE_MIN_BITS:
            return pauli_inner(psi, psi, xs, zs)
        return pauli_inner_grouped(psi, psi, xs, zs, self.inner_groups())

    def values(self, psi: torch.Tensor, entry=None) -> torch.Tensor:
        """Re <psi|op_e|psi> for every entry e (a real tensor on psi's
        device): the term values folded with their coefficients and summed
        by entry (``entry``: another per-term entry index, for checks)."""
        _, _, c = _device_terms(self._cache, self.arrays, psi)
        v = self.term_values(psi).to(psi.dtype)
        contribs = (c * v).real
        if entry is None:
            return self._entry_fold(psi)(contribs)
        return IndexFold(torch.as_tensor(entry).cpu().numpy(), self.n_entries, psi.device)(contribs)


def _evaluate(psi, entries_of, n_sites: int, route: str, device=None) -> np.ndarray:
    """The entries of ``entries_of(n_sites)`` on psi, by ``route``, as float64."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    psi = state_on_device(psi, device)
    if route == "auto":
        route = "layout" if psi.is_cuda else "loop"
    ops = entries_of(n_sites)
    if route == "loop":
        n = 2 * n_sites
        return np.array([float(Observable(op, n).expectation(psi)) for op in ops.ops])
    return ops.values(psi).double().cpu().numpy()


@functools.lru_cache(maxsize=16)
def spin_entries(n_sites: int) -> EntryTerms:
    """``S_i . S_j`` for i <= j, row by row."""
    ops = [jordan_wigner(spin_spin_operator(i, j))
           for i in range(n_sites) for j in range(i, n_sites)]
    return EntryTerms(ops, 2 * n_sites)


@functools.lru_cache(maxsize=16)
def density_entries(n_sites: int) -> EntryTerms:
    """``n_i n_j`` for i <= j, row by row, then ``n_i`` per site."""
    ops = [jordan_wigner(site_number_operator(i) * site_number_operator(j))
           for i in range(n_sites) for j in range(i, n_sites)]
    ops += [jordan_wigner(site_number_operator(i)) for i in range(n_sites)]
    return EntryTerms(ops, 2 * n_sites)


@functools.lru_cache(maxsize=16)
def _one_body_entries(n_sites: int, off: int) -> EntryTerms:
    """Per row i: ``n_p``, then per j > i the pair ``A``, ``B`` of
    ``c^dag_p c_q`` (p = 2i + off, q = 2j + off)."""
    ops = []
    for i in range(n_sites):
        p = 2 * i + off
        ops.append(jordan_wigner(FermionOperator(((p, 1), (p, 0)))))
        for j in range(i + 1, n_sites):
            q = 2 * j + off
            hop = FermionOperator(((p, 1), (q, 0)))
            hop_dag = FermionOperator(((q, 1), (p, 0)))
            ops.append(jordan_wigner(hop + hop_dag))
            ops.append(jordan_wigner(-1j * hop + 1j * hop_dag))
    return EntryTerms(ops, 2 * n_sites)


def one_body_entries(n_sites: int, spin: str = "up") -> EntryTerms:
    if spin not in ("up", "down"):
        raise ValueError("spin must be 'up' or 'down'")
    return _one_body_entries(n_sites, 0 if spin == "up" else 1)


@functools.lru_cache(maxsize=16)
def pair_entries(n_sites: int) -> EntryTerms:
    """Per row i: ``Delta^dag_i Delta_i``, then per j > i the pair ``A``,
    ``B`` of ``Delta^dag_i Delta_j``."""
    ops = []
    for i in range(n_sites):
        for j in range(i, n_sites):
            up_i, dn_i = 2 * i, 2 * i + 1
            up_j, dn_j = 2 * j, 2 * j + 1
            # Delta^dag_i Delta_j = c^dag_{i,up} c^dag_{i,dn} c_{j,dn} c_{j,up}
            op = FermionOperator(((up_i, 1), (dn_i, 1), (dn_j, 0), (up_j, 0)))
            if i == j:
                ops.append(jordan_wigner(op))
                continue
            op_dag = FermionOperator(((up_j, 1), (dn_j, 1), (dn_i, 0), (up_i, 0)))
            ops.append(jordan_wigner(op + op_dag))
            ops.append(jordan_wigner(-1j * op + 1j * op_dag))
    return EntryTerms(ops, 2 * n_sites)


def _hermitian_from_pairs(vals: np.ndarray, n_sites: int) -> np.ndarray:
    """The Hermitian matrix of entries laid out per row as [diagonal, then
    (A, B) per j > i]."""
    out = np.zeros((n_sites, n_sites), dtype=np.complex128)
    k = 0
    for i in range(n_sites):
        out[i, i] = vals[k]
        k += 1
        for j in range(i + 1, n_sites):
            out[i, j] = 0.5 * (vals[k] + 1j * vals[k + 1])
            out[j, i] = np.conj(out[i, j])
            k += 2
    return out


def correlation_matrix(
    psi, n_sites: int, kind: str = "spin", connected: bool = False, route: str = "auto",
    device=None,
) -> np.ndarray:
    """``C[i, j] = <O_i O_j>`` over all site pairs.

    ``kind='spin'``: ``O_i O_j = S_i . S_j`` (full Heisenberg correlator);
    ``kind='density'``: ``O = n`` (total site density).  ``connected=True``
    subtracts ``<O_i><O_j>`` (density only; ``<S_i> = 0`` in the Sz-pinned
    sectors the drivers use).
    """
    if kind == "spin":
        entries_of = spin_entries
    elif kind == "density":
        entries_of = density_entries
    else:
        raise ValueError("kind must be 'spin' or 'density'")
    vals = _evaluate(psi, entries_of, n_sites, route, device)
    c = np.zeros((n_sites, n_sites))
    k = 0
    for i in range(n_sites):
        for j in range(i, n_sites):
            c[i, j] = c[j, i] = vals[k]
            k += 1
    if connected and kind == "density":
        means = vals[k:k + n_sites]
        c = c - np.outer(means, means)
    return c


def one_body_density_matrix(psi, n_sites: int, spin: str = "up", route: str = "auto",
                            device=None) -> np.ndarray:
    """``rho[i, j] = <c^dag_{i,spin} c_{j,spin}>`` (Hermitian, complex).

    Each off-diagonal entry comes from two Hermitian observables,
    ``A = c^dag_i c_j + h.c.`` and ``B = -i (c^dag_i c_j - h.c.)``:
    ``rho_ij = (<A> + i <B>) / 2``.  Diagonals are the mode occupations;
    ``trace(rho)`` is the particle number of that spin species.
    """
    entries_of = functools.partial(one_body_entries, spin=spin)
    vals = _evaluate(psi, entries_of, n_sites, route, device)
    return _hermitian_from_pairs(vals, n_sites)


def pair_correlation_matrix(psi, n_sites: int, route: str = "auto",
                            device=None) -> np.ndarray:
    """On-site (s-wave) pair correlator ``P[i, j] = <Delta^dag_i Delta_j>``
    with ``Delta_i = c_{i,dn} c_{i,up}``.

    Hermitian complex; diagonals are the double occupancies
    ``<n_{i,up} n_{i,dn}>``; evaluated from Hermitian A/B observable pairs
    like :func:`one_body_density_matrix`.
    """
    vals = _evaluate(psi, pair_entries, n_sites, route, device)
    return _hermitian_from_pairs(vals, n_sites)


def _momentum_sum(nx: int, ny: int, qx: int, qy: int, site_op) -> FermionOperator:
    n = nx * ny
    out = FermionOperator.zero()
    for s in range(n):
        x, y = s % nx, s // nx
        phase = np.exp(2j * np.pi * (qx * x / nx + qy * y / ny))
        out += complex(phase / np.sqrt(n)) * site_op(s)
    return out.compress()


def spin_q_operator(nx: int, ny: int, qx: int, qy: int) -> FermionOperator:
    """Momentum-space spin-fluctuation operator
    ``S^z_q = N^{-1/2} sum_s e^{i q.r_s} S^z_s`` (row-major sites, the
    phase convention of :func:`structure_factor`).  Non-Hermitian for
    ``q != 0``; seeded on the ground state it gives the dynamical spin
    structure factor (linalg/spectral.py), whose integrated weight is the
    static ``<gs|S^z_{-q} S^z_q|gs>``."""
    return _momentum_sum(nx, ny, qx, qy, site_spin_z)


def charge_q_operator(
    nx: int, ny: int, qx: int, qy: int, filling: float | None = None
) -> FermionOperator:
    """Momentum-space density-fluctuation operator
    ``n_q = N^{-1/2} sum_s e^{i q.r_s} n_s``; at ``q = 0`` with
    ``filling = N_e / N`` the mean is subtracted (``n_q - sqrt(N) *
    filling``), the exactly-connected operator."""
    op = _momentum_sum(nx, ny, qx, qy, site_number_operator)
    if filling is not None and qx % nx == 0 and qy % ny == 0:
        op += FermionOperator.identity() * (-np.sqrt(nx * ny) * float(filling))
    return op


def _fourier(mat: np.ndarray, nx: int, ny: int) -> Dict[Tuple[int, int], float]:
    n = nx * ny
    xs = np.arange(n) % nx
    ys = np.arange(n) // nx
    out = {}
    for kx in range(nx):
        for ky in range(ny):
            phase = np.exp(
                2j * np.pi * (kx * (xs[:, None] - xs[None, :]) / nx
                              + ky * (ys[:, None] - ys[None, :]) / ny)
            )
            out[(kx, ky)] = float(np.real(np.sum(phase * mat)) / n)
    return out


def momentum_distribution(
    rho: np.ndarray, nx: int, ny: int
) -> Dict[Tuple[int, int], float]:
    """``n(k) = (1/N) sum_{ij} e^{i k.(r_i - r_j)} rho[i, j]`` on the
    discrete momentum grid (``c_k = N^{-1/2} sum_j e^{-i k.r_j} c_j``);
    ``sum_k n(k) = trace(rho)``."""
    return _fourier(rho, nx, ny)


def structure_factor(corr: np.ndarray, nx: int, ny: int) -> Dict[Tuple[int, int], float]:
    """``S(q) = (1/N) sum_{ij} e^{i q.(r_i - r_j)} C[i, j]`` on the
    discrete momentum grid."""
    return _fourier(corr, nx, ny)
