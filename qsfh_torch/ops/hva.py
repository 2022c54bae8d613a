"""HVA commuting hopping-bond coloring.

Parity with ``compile_hva_hopping_indices`` / ``get_hva_commuting_hopping_terms``
(``reference/models/utils.py:145-333``): lattice bonds are split into
1-3 horizontal and 1-3 vertical color classes of mutually commuting hopping
terms (disjoint site pairs), one HVA parameter per class per Trotter layer.

Cases (per direction of length L):
  * L == 2: a single class (one bond per row/column -- no double bond)
  * L > 2 odd, periodic: three classes (even bonds, odd bonds, wrap bonds)
  * L > 2 even, periodic: two classes (even bonds; odd bonds + wrap)
  * non-periodic: two classes (even bonds, odd bonds)
"""

from __future__ import annotations

from typing import List, Tuple

from .fermion import FermionOperator


def _direction_classes(L: int, periodic: bool) -> List[List[Tuple[int, int]]]:
    """Color classes of bond coordinates (a, a+1 mod L) along one axis."""
    if L == 2:
        return [[(0, 1)]]
    if periodic and L % 2 == 1:
        even = [(a, a + 1) for a in range(0, L - 1, 2) if a + 1 != L]
        odd = [(a, a + 1) for a in range(1, L - 1, 2)]
        wrap = [(0, L - 1)]
        return [even, odd, wrap]
    if periodic:
        even = [(a, a + 1) for a in range(0, L, 2)]
        odd = [(a, a + 1) for a in range(1, L - 1, 2)] + [(0, L - 1)]
        return [even, odd]
    even = [(a, a + 1) for a in range(0, L - 1, 2)]
    odd = [(a, a + 1) for a in range(1, L - 1, 2)]
    return [even, odd]


def compile_hva_hopping_indices(x_dimension: int, y_dimension: int, periodic: bool):
    """(horizontal_set, vertical_set): lists of spin-orbital index pairs."""

    def tuple2index(x, y, spin):
        return 2 * (x + y * x_dimension) + spin

    horizontal_set = []
    if x_dimension > 1:
        for cls in _direction_classes(x_dimension, periodic):
            terms = []
            for y in range(y_dimension):
                for (xa, xb) in cls:
                    for spin in (0, 1):
                        terms.append(
                            (tuple2index(xa, y, spin), tuple2index(xb, y, spin))
                        )
            horizontal_set.append(terms)

    vertical_set = []
    if y_dimension > 1:
        for cls in _direction_classes(y_dimension, periodic):
            terms = []
            for x in range(x_dimension):
                for (ya, yb) in cls:
                    for spin in (0, 1):
                        terms.append(
                            (tuple2index(x, ya, spin), tuple2index(x, yb, spin))
                        )
            vertical_set.append(terms)

    return horizontal_set, vertical_set


def get_hva_commuting_hopping_terms(x_dimension: int, y_dimension: int, periodic: bool):
    """Hermitian hopping generators per color class (utils.py:304-333)."""
    horizontal_set, vertical_set = compile_hva_hopping_indices(
        x_dimension, y_dimension, periodic
    )

    def build(commuting_indices):
        generator = FermionOperator.zero()
        for i, j in commuting_indices:
            generator += FermionOperator(((i, 1), (j, 0)))
            generator += FermionOperator(((j, 1), (i, 0)))
        return generator

    return [build(c) for c in horizontal_set], [build(c) for c in vertical_set]
