"""Packed Pauli-string algebra.

The reference represents qubit operators as OpenFermion ``QubitOperator``
dicts of ``((index, 'X'|'Y'|'Z'), ...) -> coeff`` (consumed all over
``reference/models/*.py``).  Here every Pauli string on up to 64
qubits is packed into two uint64 bitmasks so that products, commutators and
the iQCC Hamiltonian dressing (``reference/models/iqcc.py:175-180``)
become vectorized XOR + popcount passes over flat numpy arrays instead of
Python dict merges.

Encoding
--------
A term is the monomial  ``c * X^x Z^z``  where ``x`` and ``z`` are bitmasks
(bit q == qubit q) and the per-qubit operator order is X-then-Z.  The usual
"string with Y's" form relates by ``Y = i X Z``:

    P_str(x, z)  =  i^{|x & z|} * X^x Z^z        (Hermitian string)
    c_str        =  c_packed * (-i)^{|x & z|}

Products obey  ``(X^a Z^b)(X^c Z^d) = (-1)^{|b & c|} X^{a^c} Z^{b^d}``.

All arrays are plain numpy on the host; the engine consumes the
``(x, z, coeff)`` triplets as static data or as device arrays.
"""

from __future__ import annotations

import numbers
from typing import Iterable, List, Tuple

import numpy as np

_I_POW = np.array([1.0, 1.0j, -1.0, -1.0j], dtype=np.complex128)


def _popcount(a: np.ndarray) -> np.ndarray:
    return np.bitwise_count(a.astype(np.uint64)).astype(np.int64)


class PauliSum:
    """A sum of packed Pauli monomials ``sum_k c_k X^{x_k} Z^{z_k}``."""

    __slots__ = ("x", "z", "c")

    def __init__(self, x=None, z=None, c=None):
        self.x = np.asarray(x if x is not None else [], dtype=np.uint64).ravel()
        self.z = np.asarray(z if z is not None else [], dtype=np.uint64).ravel()
        self.c = np.asarray(c if c is not None else [], dtype=np.complex128).ravel()

    # -- constructors -------------------------------------------------------

    @classmethod
    def zero(cls) -> "PauliSum":
        return cls()

    @classmethod
    def identity(cls, coeff: complex = 1.0) -> "PauliSum":
        return cls([0], [0], [coeff])

    @classmethod
    def from_string(cls, s: str, coeff: complex = 1.0) -> "PauliSum":
        """Parse e.g. ``"X0 Y3 Z5"`` (empty string = identity)."""
        x = np.uint64(0)
        z = np.uint64(0)
        phase = 0  # power of (-i) accumulated converting Y -> XZ
        for token in s.split():
            p, q = token[0].upper(), int(token[1:])
            bit = np.uint64(1) << np.uint64(q)
            if p == "X":
                x |= bit
            elif p == "Z":
                z |= bit
            elif p == "Y":
                x |= bit
                z |= bit
                phase += 1  # Y = i * XZ  ->  c_packed = c * (-i)^... inverse below
            else:
                raise ValueError(f"bad Pauli: {token}")
        # Y = i X Z per qubit, so the string equals i^{#Y} X^x Z^z and the
        # packed coefficient is coeff * i^{#Y}.
        c = coeff * _I_POW[phase % 4]
        return cls([x], [z], [c])

    @classmethod
    def from_terms(cls, terms: Iterable[Tuple[str, complex]]) -> "PauliSum":
        out = cls.zero()
        xs, zs, cs = [], [], []
        for s, coeff in terms:
            t = cls.from_string(s, coeff)
            xs.append(t.x[0])
            zs.append(t.z[0])
            cs.append(t.c[0])
        out.x = np.array(xs, dtype=np.uint64)
        out.z = np.array(zs, dtype=np.uint64)
        out.c = np.array(cs, dtype=np.complex128)
        return out.simplify()

    # -- inspection ----------------------------------------------------------

    def __len__(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_terms(self) -> int:
        return len(self)

    def n_qubits(self) -> int:
        if len(self) == 0:
            return 0
        m = int(np.bitwise_or.reduce(self.x) | np.bitwise_or.reduce(self.z))
        return m.bit_length()

    def string_coeffs(self) -> np.ndarray:
        """Coefficients in the Y-string convention (Hermitian strings -> real).

        The Hermitian string is P_str = i^{|x&z|} X^x Z^z, so
        c_str = c_packed * (-i)^{|x&z|}.
        """
        return self.c * _I_POW[(-_popcount(self.x & self.z)) % 4]

    def to_terms(self) -> List[Tuple[str, complex]]:
        """Back to human-readable ('X0 Y1', coeff) pairs (Y-string convention)."""
        out = []
        cs = self.string_coeffs()
        for x, z, c in zip(self.x, self.z, cs):
            x, z = int(x), int(z)
            parts = []
            q = 0
            m = x | z
            while m >> q:
                bx, bz = (x >> q) & 1, (z >> q) & 1
                if bx and bz:
                    parts.append(f"Y{q}")
                elif bx:
                    parts.append(f"X{q}")
                elif bz:
                    parts.append(f"Z{q}")
                q += 1
            out.append((" ".join(parts), complex(c)))
        return out

    def constant(self) -> complex:
        mask = (self.x == 0) & (self.z == 0)
        return complex(self.c[mask].sum()) if mask.any() else 0.0

    def is_hermitian(self, tol: float = 1e-10) -> bool:
        return bool(np.all(np.abs(self.string_coeffs().imag) <= tol))

    # -- canonicalization ----------------------------------------------------

    def simplify(self, tol: float = 1e-12) -> "PauliSum":
        """Merge duplicate (x, z) monomials and drop negligible ones."""
        if len(self) == 0:
            return self
        order = np.lexsort((self.z, self.x))
        x, z, c = self.x[order], self.z[order], self.c[order]
        new_group = np.empty(len(x), dtype=bool)
        new_group[0] = True
        new_group[1:] = (x[1:] != x[:-1]) | (z[1:] != z[:-1])
        group_ids = np.cumsum(new_group) - 1
        n_groups = group_ids[-1] + 1
        cc = np.zeros(n_groups, dtype=np.complex128)
        np.add.at(cc, group_ids, c)
        gx = x[new_group]
        gz = z[new_group]
        keep = np.abs(cc) > tol
        self.x, self.z, self.c = gx[keep], gz[keep], cc[keep]
        return self

    def copy(self) -> "PauliSum":
        return PauliSum(self.x.copy(), self.z.copy(), self.c.copy())

    # -- algebra --------------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, numbers.Number):
            other = PauliSum.identity(other)
        if not isinstance(other, PauliSum):
            return NotImplemented
        return PauliSum(
            np.concatenate([self.x, other.x]),
            np.concatenate([self.z, other.z]),
            np.concatenate([self.c, other.c]),
        ).simplify()

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-1.0) * other

    def __neg__(self):
        return (-1.0) * self

    def __mul__(self, other):
        if isinstance(other, numbers.Number):
            return PauliSum(self.x, self.z, self.c * other)
        if not isinstance(other, PauliSum):
            return NotImplemented
        # Outer product, fully vectorized: (K1, K2) broadcast.
        x1 = self.x[:, None]
        z1 = self.z[:, None]
        x2 = other.x[None, :]
        z2 = other.z[None, :]
        sign = 1.0 - 2.0 * (_popcount(z1 & x2) % 2)
        x = (x1 ^ x2).ravel()
        z = (z1 ^ z2).ravel()
        c = (self.c[:, None] * other.c[None, :] * sign).ravel()
        return PauliSum(x, z, c).simplify()

    def __rmul__(self, other):
        if isinstance(other, numbers.Number):
            return self * other
        return NotImplemented

    def dagger(self) -> "PauliSum":
        # (X^x Z^z)^dag = Z^z X^x = (-1)^{|x&z|} X^x Z^z
        sign = 1.0 - 2.0 * (_popcount(self.x & self.z) % 2)
        return PauliSum(self.x, self.z, np.conj(self.c) * sign)

    def commutator(self, other: "PauliSum") -> "PauliSum":
        return self * other - other * self

    def __repr__(self):
        if len(self) == 0:
            return "0"
        return " + ".join(
            f"({c:.6g}) {s or 'I'}" for s, c in self.to_terms()
        )

    # -- engine lowering -------------------------------------------------------

    def rotation_terms(self, tol: float = 1e-12):
        """Lower to a list of (x, z, theta_scale) for Trotterized exp(-i theta G).

        Mirrors ``Trotterize_generator`` (reference/models/hva.py:84-95):
        identity terms are skipped and only the *real* part of the string
        coefficient drives the rotation angle.
        """
        cs = self.string_coeffs()
        out = []
        for x, z, c in zip(self.x, self.z, cs):
            if x == 0 and z == 0:
                continue
            if abs(c.real) <= tol:
                continue
            out.append((int(x), int(z), float(c.real)))
        return out


def qubit_operator(s: str = "", coeff: complex = 1.0) -> PauliSum:
    """Convenience: QubitOperator('Y0 X1 X2', c) analog."""
    return PauliSum.from_string(s, coeff)
