"""STO-3G basis set data for the elements the reference molecules need.

A copy of ``qsfh_tpu/molecules/basis.py``.

Standard published STO-3G exponents/contractions (EMSL Basis Set Exchange)
for H, He, Li, Be.  SP shells share exponents between the 2s and 2p
contractions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .integrals import BasisFunction

# element -> list of shells; each shell is (type, exps, coefs or (cs, cp))
STO3G: Dict[str, List] = {
    "H": [
        ("S", [3.42525091, 0.62391373, 0.16885540], [0.15432897, 0.53532814, 0.44463454]),
    ],
    "He": [
        ("S", [6.36242139, 1.15892300, 0.31364979], [0.15432897, 0.53532814, 0.44463454]),
    ],
    "Li": [
        ("S", [16.1195750, 2.9362007, 0.7946505], [0.15432897, 0.53532814, 0.44463454]),
        (
            "SP",
            [0.6362897, 0.1478601, 0.0480887],
            [-0.09996723, 0.39951283, 0.70011547],
            [0.15591627, 0.60768372, 0.39195739],
        ),
    ],
    "Be": [
        ("S", [30.1678710, 5.4951153, 1.4871927], [0.15432897, 0.53532814, 0.44463454]),
        (
            "SP",
            [1.3148331, 0.3055389, 0.0993707],
            [-0.09996723, 0.39951283, 0.70011547],
            [0.15591627, 0.60768372, 0.39195739],
        ),
    ],
    "O": [
        ("S", [130.7093200, 23.8088610, 6.4436083], [0.15432897, 0.53532814, 0.44463454]),
        (
            "SP",
            [5.0331513, 1.1695961, 0.3803890],
            [-0.09996723, 0.39951283, 0.70011547],
            [0.15591627, 0.60768372, 0.39195739],
        ),
    ],
}

ATOMIC_NUMBER = {"H": 1, "He": 2, "Li": 3, "Be": 4, "O": 8}

P_SHELLS = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]


def build_basis(atoms_bohr: List[Tuple[str, np.ndarray]]):
    """Expand STO-3G shells into contracted Cartesian basis functions.

    Orbital order: per atom in input order, shells in data order, p shells
    as (px, py, pz).
    """
    basis: List[BasisFunction] = []
    charges: List[Tuple[int, np.ndarray]] = []
    for symbol, xyz in atoms_bohr:
        if symbol not in STO3G:
            raise ValueError(f"no STO-3G data for element {symbol}")
        charges.append((ATOMIC_NUMBER[symbol], np.asarray(xyz, dtype=float)))
        for shell in STO3G[symbol]:
            if shell[0] == "S":
                _, exps, coefs = shell
                basis.append(BasisFunction(xyz, (0, 0, 0), exps, coefs))
            elif shell[0] == "SP":
                _, exps, cs, cp = shell
                basis.append(BasisFunction(xyz, (0, 0, 0), exps, cs))
                for lmn in P_SHELLS:
                    basis.append(BasisFunction(xyz, lmn, exps, cp))
            else:  # pragma: no cover
                raise ValueError(f"unsupported shell type {shell[0]}")
    return basis, charges
