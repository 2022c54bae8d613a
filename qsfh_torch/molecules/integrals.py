"""Gaussian-basis molecular integrals (McMurchie-Davidson scheme).

A copy of ``qsfh_tpu/molecules/integrals.py`` (numpy and ``scipy.special``).

The reference delegates all quantum chemistry to PySCF via
``openfermionpyscf.run_pyscf`` (``reference molecules/__init__.py:8``).
PySCF is not available in this image, so the framework ships its own
minimal integral engine: overlap / kinetic / nuclear-attraction / electron-
repulsion integrals over contracted Cartesian Gaussians, sufficient for the
STO-3G s- and p-type shells the reference molecules use (H2, HeH+, LiH,
BeH2, H4, H6).  Host-side, build-time, numpy + scipy only.

Conventions: all distances in Bohr internally (callers pass Angstrom and we
convert), chemist ERI notation (ij|kl).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np
from scipy.special import gammainc, gamma as gamma_fn

ANGSTROM_TO_BOHR = 1.0 / 0.52917721092


def boys(n: int, x: float) -> float:
    """Boys function F_n(x) = int_0^1 t^{2n} exp(-x t^2) dt."""
    if x < 1e-12:
        return 1.0 / (2 * n + 1)
    a = n + 0.5
    return gammainc(a, x) * gamma_fn(a) / (2.0 * x**a)


def hermite_e(i: int, j: int, t: int, Qx: float, a: float, b: float) -> float:
    """Hermite expansion coefficient E_t^{ij} (McMurchie-Davidson recursion)."""
    p = a + b
    q = a * b / p
    if t < 0 or t > i + j:
        return 0.0
    if i == j == t == 0:
        return math.exp(-q * Qx * Qx)
    if j == 0:
        return (
            hermite_e(i - 1, j, t - 1, Qx, a, b) / (2 * p)
            - q * Qx / a * hermite_e(i - 1, j, t, Qx, a, b)
            + (t + 1) * hermite_e(i - 1, j, t + 1, Qx, a, b)
        )
    return (
        hermite_e(i, j - 1, t - 1, Qx, a, b) / (2 * p)
        + q * Qx / b * hermite_e(i, j - 1, t, Qx, a, b)
        + (t + 1) * hermite_e(i, j - 1, t + 1, Qx, a, b)
    )


def hermite_r(t: int, u: int, v: int, n: int, p: float, PC: np.ndarray, R2: float):
    """Auxiliary Hermite Coulomb integral R^n_{tuv} recursion."""
    if t < 0 or u < 0 or v < 0:
        return 0.0
    if t == u == v == 0:
        return (-2.0 * p) ** n * boys(n, p * R2)
    if t > 0:
        return (t - 1) * hermite_r(t - 2, u, v, n + 1, p, PC, R2) + PC[0] * hermite_r(
            t - 1, u, v, n + 1, p, PC, R2
        )
    if u > 0:
        return (u - 1) * hermite_r(t, u - 2, v, n + 1, p, PC, R2) + PC[1] * hermite_r(
            t, u - 1, v, n + 1, p, PC, R2
        )
    return (v - 1) * hermite_r(t, u, v - 2, n + 1, p, PC, R2) + PC[2] * hermite_r(
        t, u, v - 1, n + 1, p, PC, R2
    )


def gaussian_norm(a: float, lmn: Tuple[int, int, int]) -> float:
    """Normalization of a primitive Cartesian Gaussian x^l y^m z^n e^{-a r^2}."""
    l, m, n = lmn
    num = (2 * a / math.pi) ** 0.75 * (4 * a) ** ((l + m + n) / 2)
    den = math.sqrt(
        _df(2 * l - 1) * _df(2 * m - 1) * _df(2 * n - 1)
    )
    return num / den


def _df(n: int) -> float:
    """Double factorial with (-1)!! = 1."""
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


@dataclass
class BasisFunction:
    """One contracted Cartesian Gaussian."""

    center: np.ndarray  # (3,) Bohr
    lmn: Tuple[int, int, int]
    exps: np.ndarray
    coefs: np.ndarray  # contraction coefficients (for normalized primitives)
    norms: np.ndarray = field(init=False)

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=float)
        self.exps = np.asarray(self.exps, dtype=float)
        self.coefs = np.asarray(self.coefs, dtype=float)
        self.norms = np.array([gaussian_norm(a, self.lmn) for a in self.exps])
        # normalize the contracted function
        s = 0.0
        l, m, n = self.lmn
        L = l + m + n
        pref = math.pi**1.5 * _df(2 * l - 1) * _df(2 * m - 1) * _df(2 * n - 1) / 2.0**L
        for ca, aa, na in zip(self.coefs, self.exps, self.norms):
            for cb, ab, nb in zip(self.coefs, self.exps, self.norms):
                s += ca * cb * na * nb * pref / (aa + ab) ** (L + 1.5)
        self.coefs = self.coefs / math.sqrt(s)


def _overlap_prim(a, lmn1, A, b, lmn2, B):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    p = a + b
    S = (math.pi / p) ** 1.5
    S *= hermite_e(l1, l2, 0, A[0] - B[0], a, b)
    S *= hermite_e(m1, m2, 0, A[1] - B[1], a, b)
    S *= hermite_e(n1, n2, 0, A[2] - B[2], a, b)
    return S


def overlap(f1: BasisFunction, f2: BasisFunction) -> float:
    s = 0.0
    for ca, aa, na in zip(f1.coefs, f1.exps, f1.norms):
        for cb, ab, nb in zip(f2.coefs, f2.exps, f2.norms):
            s += ca * cb * na * nb * _overlap_prim(aa, f1.lmn, f1.center, ab, f2.lmn, f2.center)
    return s


def _kinetic_prim(a, lmn1, A, b, lmn2, B):
    l2, m2, n2 = lmn2
    term0 = b * (2 * (l2 + m2 + n2) + 3) * _overlap_prim(a, lmn1, A, b, lmn2, B)
    term1 = -2 * b**2 * (
        _overlap_prim(a, lmn1, A, b, (l2 + 2, m2, n2), B)
        + _overlap_prim(a, lmn1, A, b, (l2, m2 + 2, n2), B)
        + _overlap_prim(a, lmn1, A, b, (l2, m2, n2 + 2), B)
    )
    term2 = -0.5 * (
        l2 * (l2 - 1) * _overlap_prim(a, lmn1, A, b, (l2 - 2, m2, n2), B)
        + m2 * (m2 - 1) * _overlap_prim(a, lmn1, A, b, (l2, m2 - 2, n2), B)
        + n2 * (n2 - 1) * _overlap_prim(a, lmn1, A, b, (l2, m2, n2 - 2), B)
    )
    return term0 + term1 + term2


def kinetic(f1: BasisFunction, f2: BasisFunction) -> float:
    s = 0.0
    for ca, aa, na in zip(f1.coefs, f1.exps, f1.norms):
        for cb, ab, nb in zip(f2.coefs, f2.exps, f2.norms):
            s += ca * cb * na * nb * _kinetic_prim(aa, f1.lmn, f1.center, ab, f2.lmn, f2.center)
    return s


def _nuclear_prim(a, lmn1, A, b, lmn2, B, C):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    p = a + b
    P = (a * A + b * B) / p
    PC = P - C
    R2 = float(PC @ PC)
    val = 0.0
    for t in range(l1 + l2 + 1):
        Et = hermite_e(l1, l2, t, A[0] - B[0], a, b)
        if Et == 0.0:
            continue
        for u in range(m1 + m2 + 1):
            Eu = hermite_e(m1, m2, u, A[1] - B[1], a, b)
            if Eu == 0.0:
                continue
            for v in range(n1 + n2 + 1):
                Ev = hermite_e(n1, n2, v, A[2] - B[2], a, b)
                if Ev == 0.0:
                    continue
                val += Et * Eu * Ev * hermite_r(t, u, v, 0, p, PC, R2)
    return 2.0 * math.pi / p * val


def nuclear_attraction(f1: BasisFunction, f2: BasisFunction, C: np.ndarray) -> float:
    s = 0.0
    for ca, aa, na in zip(f1.coefs, f1.exps, f1.norms):
        for cb, ab, nb in zip(f2.coefs, f2.exps, f2.norms):
            s += ca * cb * na * nb * _nuclear_prim(
                aa, f1.lmn, f1.center, ab, f2.lmn, f2.center, np.asarray(C, dtype=float)
            )
    return s


def _eri_prim(a, lmn1, A, b, lmn2, B, c, lmn3, C, d, lmn4, D):
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    l3, m3, n3 = lmn3
    l4, m4, n4 = lmn4
    p = a + b
    q = c + d
    alpha = p * q / (p + q)
    P = (a * A + b * B) / p
    Q = (c * C + d * D) / q
    PQ = P - Q
    R2 = float(PQ @ PQ)

    val = 0.0
    for t in range(l1 + l2 + 1):
        E1t = hermite_e(l1, l2, t, A[0] - B[0], a, b)
        if E1t == 0.0:
            continue
        for u in range(m1 + m2 + 1):
            E1u = hermite_e(m1, m2, u, A[1] - B[1], a, b)
            if E1u == 0.0:
                continue
            for v in range(n1 + n2 + 1):
                E1v = hermite_e(n1, n2, v, A[2] - B[2], a, b)
                if E1v == 0.0:
                    continue
                for tau in range(l3 + l4 + 1):
                    E2t = hermite_e(l3, l4, tau, C[0] - D[0], c, d)
                    if E2t == 0.0:
                        continue
                    for nu in range(m3 + m4 + 1):
                        E2u = hermite_e(m3, m4, nu, C[1] - D[1], c, d)
                        if E2u == 0.0:
                            continue
                        for phi in range(n3 + n4 + 1):
                            E2v = hermite_e(n3, n4, phi, C[2] - D[2], c, d)
                            if E2v == 0.0:
                                continue
                            val += (
                                E1t
                                * E1u
                                * E1v
                                * E2t
                                * E2u
                                * E2v
                                * (-1.0) ** (tau + nu + phi)
                                * hermite_r(t + tau, u + nu, v + phi, 0, alpha, PQ, R2)
                            )
    return val * 2.0 * math.pi**2.5 / (p * q * math.sqrt(p + q))


def electron_repulsion(f1, f2, f3, f4) -> float:
    """Chemist-notation (f1 f2 | f3 f4)."""
    s = 0.0
    for c1, a1, n1 in zip(f1.coefs, f1.exps, f1.norms):
        for c2, a2, n2 in zip(f2.coefs, f2.exps, f2.norms):
            for c3, a3, n3 in zip(f3.coefs, f3.exps, f3.norms):
                for c4, a4, n4 in zip(f4.coefs, f4.exps, f4.norms):
                    s += (
                        c1
                        * c2
                        * c3
                        * c4
                        * n1
                        * n2
                        * n3
                        * n4
                        * _eri_prim(
                            a1, f1.lmn, f1.center,
                            a2, f2.lmn, f2.center,
                            a3, f3.lmn, f3.center,
                            a4, f4.lmn, f4.center,
                        )
                    )
    return s


def build_integrals(basis: Sequence[BasisFunction], atoms: Sequence[Tuple[int, np.ndarray]]):
    """(S, T, V, ERI) over a basis; atoms = [(Z, xyz_bohr)].

    ERI is the full chemist-notation tensor (ij|kl) with 8-fold symmetry
    exploited during construction.
    """
    n = len(basis)
    S = np.zeros((n, n))
    T = np.zeros((n, n))
    V = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1):
            S[i, j] = S[j, i] = overlap(basis[i], basis[j])
            T[i, j] = T[j, i] = kinetic(basis[i], basis[j])
            v = 0.0
            for Z, xyz in atoms:
                v -= Z * nuclear_attraction(basis[i], basis[j], xyz)
            V[i, j] = V[j, i] = v

    eri = np.zeros((n, n, n, n))
    done = np.zeros((n, n, n, n), dtype=bool)
    for i in range(n):
        for j in range(i + 1):
            for k in range(n):
                for l in range(k + 1):
                    if done[i, j, k, l]:
                        continue
                    val = electron_repulsion(basis[i], basis[j], basis[k], basis[l])
                    for (a, b, c, d) in (
                        (i, j, k, l), (j, i, k, l), (i, j, l, k), (j, i, l, k),
                        (k, l, i, j), (l, k, i, j), (k, l, j, i), (l, k, j, i),
                    ):
                        eri[a, b, c, d] = val
                        done[a, b, c, d] = True
    return S, T, V, eri


def nuclear_repulsion(atoms: Sequence[Tuple[int, np.ndarray]]) -> float:
    e = 0.0
    for i in range(len(atoms)):
        for j in range(i):
            Zi, Ri = atoms[i]
            Zj, Rj = atoms[j]
            e += Zi * Zj / np.linalg.norm(np.asarray(Ri) - np.asarray(Rj))
    return e
