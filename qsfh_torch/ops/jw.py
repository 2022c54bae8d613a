"""Jordan-Wigner transform: fermionic ladder algebra -> packed Pauli sums.

Replaces OpenFermion's ``jordan_wigner`` (used at
``reference/models/hva.py:154`` and in every Trotterized generator,
``reference/models/hva.py:84-95``).  Convention:

    a^dagger_p = 1/2 (X_p - i Y_p) Z_0 ... Z_{p-1}
    a_p        = 1/2 (X_p + i Y_p) Z_0 ... Z_{p-1}

which in the packed X^x Z^z encoding (Y = i X Z) is

    a^dagger_p = 1/2 X_p Z_{<p}  +  1/2 X_p Z_p Z_{<p}     (packed coeffs 1/2, 1/2)
    a_p        = 1/2 X_p Z_{<p}  -  1/2 X_p Z_p Z_{<p}

(The -iY_p term: -i * Y = -i * (i X Z) = X Z, hence packed coefficient +1/2;
the +iY_p term gives -1/2 ... sign worked out in code and verified against
hand-derived 2-mode tables in tests.)
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .fermion import FermionOperator
from .pauli import PauliSum


@lru_cache(maxsize=4096)
def _ladder_paulisum(mode: int, dagger: int) -> PauliSum:
    zmask_below = np.uint64((1 << mode) - 1)
    bit = np.uint64(1 << mode)
    x = np.array([bit, bit], dtype=np.uint64)
    z = np.array([zmask_below, zmask_below | bit], dtype=np.uint64)
    # a^dag = (X - iY)/2 Z<  ;  a = (X + iY)/2 Z<
    # X-part packed coeff: 1/2.
    # -iY = -i(iXZ) = XZ -> +1/2 ;  +iY = i(iXZ) = -XZ -> -1/2.
    if dagger:
        c = np.array([0.5, 0.5], dtype=np.complex128)
    else:
        c = np.array([0.5, -0.5], dtype=np.complex128)
    return PauliSum(x, z, c)


def jordan_wigner(op) -> PauliSum:
    """Map a FermionOperator (or pass through a PauliSum) to a PauliSum."""
    if isinstance(op, PauliSum):
        return op
    if not isinstance(op, FermionOperator):
        raise TypeError(f"expected FermionOperator, got {type(op)}")
    total = PauliSum.zero()
    xs, zs, cs = [], [], []
    for term, coeff in op.terms.items():
        acc = PauliSum.identity(coeff)
        for mode, dagger in term:
            acc = acc * _ladder_paulisum(mode, dagger)
        xs.append(acc.x)
        zs.append(acc.z)
        cs.append(acc.c)
    if not xs:
        return total
    total.x = np.concatenate(xs)
    total.z = np.concatenate(zs)
    total.c = np.concatenate(cs)
    return total.simplify()
