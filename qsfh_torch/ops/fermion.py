"""Fermionic ladder-operator algebra (host-side, build-time only).

This is the symbolic layer that the reference obtains from OpenFermion's
``FermionOperator`` (used throughout ``reference/operators/pool.py``,
``reference/models/hva.py:147-176``).  It is deliberately a plain-Python
dict algebra: every use in the framework is *build-time* operator
construction whose output is lowered to packed Pauli arrays (see
:mod:`qsfh_torch.ops.pauli`) before anything touches the device.

Conventions (matching OpenFermion so that energies agree bit-for-bit):

* A term is a tuple of ``(mode, action)`` pairs where ``action`` is 1 for a
  creation operator ``a^dagger_mode`` and 0 for an annihilation operator.
* ``normal_ordered`` puts creation operators first, each group in strictly
  descending mode order, with fermionic anticommutation signs.
* String syntax: ``"3^ 1"`` means ``a^dagger_3 a_1``.
"""

from __future__ import annotations

import numbers
from typing import Dict, Tuple

Term = Tuple[Tuple[int, int], ...]

EQ_TOLERANCE = 1e-12


def _parse_term(term) -> Term:
    if term is None:
        return None
    if isinstance(term, str):
        parsed = []
        for token in term.split():
            if token.endswith("^"):
                parsed.append((int(token[:-1]), 1))
            else:
                parsed.append((int(token), 0))
        return tuple(parsed)
    if isinstance(term, tuple):
        if len(term) == 2 and isinstance(term[0], int) and isinstance(term[1], int):
            # single ladder operator, e.g. (3, 1)
            return (term,)
        return tuple((int(m), int(a)) for m, a in term)
    if isinstance(term, list):
        return tuple((int(m), int(a)) for m, a in term)
    raise TypeError(f"cannot parse fermion term: {term!r}")


class FermionOperator:
    """Sum of products of fermionic ladder operators with complex coefficients."""

    __slots__ = ("terms",)

    def __init__(self, term=None, coefficient=1.0):
        self.terms: Dict[Term, complex] = {}
        if term is None:
            return
        parsed = _parse_term(term)
        if coefficient != 0:
            self.terms[parsed] = complex(coefficient)

    # -- constructors -------------------------------------------------------

    @classmethod
    def zero(cls) -> "FermionOperator":
        return cls()

    @classmethod
    def identity(cls) -> "FermionOperator":
        return cls((), 1.0)

    @classmethod
    def from_terms(cls, terms: Dict[Term, complex]) -> "FermionOperator":
        op = cls()
        op.terms = {t: complex(c) for t, c in terms.items() if c != 0}
        return op

    # -- helpers ------------------------------------------------------------

    def copy(self) -> "FermionOperator":
        return FermionOperator.from_terms(self.terms)

    def many_body_order(self) -> int:
        """Largest number of ladder operators in any term (OpenFermion parity)."""
        if not self.terms:
            return 0
        return max(len(t) for t in self.terms)

    def n_modes(self) -> int:
        m = -1
        for term in self.terms:
            for mode, _ in term:
                m = max(m, mode)
        return m + 1

    def compress(self, abs_tol: float = EQ_TOLERANCE) -> "FermionOperator":
        """Drop negligible coefficients and real/imag parts in place."""
        new_terms = {}
        for term, coeff in self.terms.items():
            if abs(coeff.imag) <= abs_tol:
                coeff = complex(coeff.real, 0.0)
            if abs(coeff.real) <= abs_tol:
                coeff = complex(0.0, coeff.imag)
            if abs(coeff) > abs_tol:
                new_terms[term] = coeff
        self.terms = new_terms
        return self

    def constant(self) -> complex:
        return self.terms.get((), 0.0)

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, numbers.Number):
            other = FermionOperator((), other)
        if not isinstance(other, FermionOperator):
            return NotImplemented
        out = self.copy()
        for term, coeff in other.terms.items():
            newc = out.terms.get(term, 0.0) + coeff
            if newc == 0:
                out.terms.pop(term, None)
            else:
                out.terms[term] = newc
        return out

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-1.0) * other

    def __rsub__(self, other):
        return (-1.0) * self + other

    def __neg__(self):
        return (-1.0) * self

    def __mul__(self, other):
        if isinstance(other, numbers.Number):
            return FermionOperator.from_terms(
                {t: c * other for t, c in self.terms.items()}
            )
        if not isinstance(other, FermionOperator):
            return NotImplemented
        out = FermionOperator.zero()
        for t1, c1 in self.terms.items():
            for t2, c2 in other.terms.items():
                term = t1 + t2
                coeff = c1 * c2
                newc = out.terms.get(term, 0.0) + coeff
                if newc == 0:
                    out.terms.pop(term, None)
                else:
                    out.terms[term] = newc
        return out

    def __rmul__(self, other):
        if isinstance(other, numbers.Number):
            return self * other
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, numbers.Number):
            return self * (1.0 / other)
        return NotImplemented

    def __eq__(self, other):
        """Approximate equality (coefficient tolerance), OpenFermion-style.

        Pool builders rely on ``op not in pool`` / ``-op not in pool`` dedup
        (``reference/operators/pool.py:252``).
        """
        if not isinstance(other, FermionOperator):
            return NotImplemented
        keys = set(self.terms) | set(other.terms)
        for k in keys:
            if abs(self.terms.get(k, 0.0) - other.terms.get(k, 0.0)) > 1e-10:
                return False
        return True

    def __hash__(self):
        # Hash on the sorted term structure only; equality handles coefficients.
        return hash(frozenset(self.terms.keys()))

    def __repr__(self):
        if not self.terms:
            return "0"
        parts = []
        for term, coeff in sorted(self.terms.items()):
            ops = " ".join(f"{m}^" if a else f"{m}" for m, a in term)
            parts.append(f"{coeff} [{ops}]")
        return " +\n".join(parts)

    def isclose(self, other, tol=1e-10):
        keys = set(self.terms) | set(other.terms)
        return all(
            abs(self.terms.get(k, 0.0) - other.terms.get(k, 0.0)) <= tol for k in keys
        )


def hermitian_conjugated(op: FermionOperator) -> FermionOperator:
    out = FermionOperator.zero()
    for term, coeff in op.terms.items():
        new_term = tuple((m, 1 - a) for m, a in reversed(term))
        out.terms[new_term] = out.terms.get(new_term, 0.0) + coeff.conjugate()
    return out


def _normal_ordered_term(term: Term, coeff: complex) -> FermionOperator:
    """Normal order a single product of ladder operators.

    Recursive rewriting with the canonical anticommutation relations:
      a_p a^_q = delta_pq - a^_q a_p
      a^_p a^_q = -a^_q a^_p   (p != q), zero if p == q
      a_p a_q   = -a_q a_p     (p != q), zero if p == q
    Target order: creations first in descending mode index, then
    annihilations in descending mode index.
    """
    term = list(term)
    out = FermionOperator.zero()
    # Find first adjacent violation.
    for i in range(len(term) - 1):
        (p, dp), (q, dq) = term[i], term[i + 1]
        if dp == 0 and dq == 1:
            # annihilation-before-creation: swap
            swapped = term[:i] + [(q, dq), (p, dp)] + term[i + 2 :]
            out += _normal_ordered_term(tuple(swapped), -coeff)
            if p == q:
                delta = term[:i] + term[i + 2 :]
                out += _normal_ordered_term(tuple(delta), coeff)
            return out
        if dp == dq:
            if p == q:
                return out  # nilpotent: a a or a^ a^ with equal modes -> 0
            if p < q:
                swapped = term[:i] + [(q, dq), (p, dp)] + term[i + 2 :]
                out += _normal_ordered_term(tuple(swapped), -coeff)
                return out
    out.terms[tuple(term)] = coeff
    return out


def normal_ordered(op: FermionOperator) -> FermionOperator:
    out = FermionOperator.zero()
    for term, coeff in op.terms.items():
        out += _normal_ordered_term(term, coeff)
    out.compress()
    return out


def number_operator(n_modes: int, mode: int = None, coefficient: float = 1.0) -> FermionOperator:
    """n_mode = a^_mode a_mode, or total number operator if mode is None."""
    if mode is not None:
        return FermionOperator(((mode, 1), (mode, 0)), coefficient)
    out = FermionOperator.zero()
    for m in range(n_modes):
        out += FermionOperator(((m, 1), (m, 0)), coefficient)
    return out


def up_index(site: int) -> int:
    """Spin-up spin-orbital index (even wires), OpenFermion convention."""
    return 2 * site


def down_index(site: int) -> int:
    """Spin-down spin-orbital index (odd wires), OpenFermion convention."""
    return 2 * site + 1
