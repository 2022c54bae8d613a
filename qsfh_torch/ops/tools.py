"""Operator term splitters (parity with reference/operators/tools.py)."""

from __future__ import annotations

from .fermion import FermionOperator


def get_quadratic_term(op: FermionOperator) -> FermionOperator:
    """Terms with exactly two ladder operators (hopping part)."""
    out = FermionOperator.zero()
    for term, coeff in op.terms.items():
        if len(term) == 2:
            out.terms[term] = coeff
    return out


def get_interacting_term(op: FermionOperator) -> FermionOperator:
    """Terms with more than two ladder operators (Coulomb part)."""
    out = FermionOperator.zero()
    for term, coeff in op.terms.items():
        if len(term) > 2:
            out.terms[term] = coeff
    return out
