"""Molecule factories with the reference's geometries.

Counterpart of ``qsfh_tpu/molecules/__init__.py`` (the reference's
``molecules/__init__.py:5-45``: the same names, geometries in Angstrom and
default basis, multiplicity and charge), backed by the port's copy of the
integral, RHF and FCI pipeline (numpy and ``scipy.special``; the FCI on the
port's Lanczos).
"""

from .molecule import Molecule


def H2(r, basis="sto-3g", multiplicity=1, charge=0) -> Molecule:
    geometry = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, r))]
    return Molecule(geometry, basis, multiplicity, charge)


def HeH_Ion(r, basis="sto-3g", multiplicity=1, charge=1) -> Molecule:
    geometry = [("He", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, r))]
    return Molecule(geometry, basis, multiplicity, charge)


def LiH(r, basis="sto-3g", multiplicity=1, charge=0) -> Molecule:
    geometry = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, r))]
    return Molecule(geometry, basis, multiplicity, charge)


def BeH2(r, basis="sto-3g", multiplicity=1, charge=0) -> Molecule:
    geometry = [("H", (0.0, 0.0, -r)), ("Be", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, r))]
    return Molecule(geometry, basis, multiplicity, charge)


def H2O(r, angle_deg=104.5, basis="sto-3g", multiplicity=1, charge=0) -> Molecule:
    """Water: O at the origin, both O-H bonds of length ``r`` (Angstrom)
    opened to ``angle_deg`` in the yz plane.  Beyond the reference's set
    (the first second-row p-block molecule the native integral engine
    handles); golden-tested against the canonical STO-3G RHF value."""
    import numpy as np

    half = np.deg2rad(angle_deg) / 2.0
    geometry = [
        ("O", (0.0, 0.0, 0.0)),
        ("H", (0.0, r * np.sin(half), r * np.cos(half))),
        ("H", (0.0, -r * np.sin(half), r * np.cos(half))),
    ]
    return Molecule(geometry, basis, multiplicity, charge)


def H4(r, basis="sto-3g", multiplicity=1, charge=0) -> Molecule:
    geometry = [("H", (0.0, 0.0, i * r)) for i in range(4)]
    return Molecule(geometry, basis, multiplicity, charge)


def H6(r, basis="sto-3g", multiplicity=1, charge=0) -> Molecule:
    geometry = [("H", (0.0, 0.0, i * r)) for i in range(6)]
    return Molecule(geometry, basis, multiplicity, charge)


__all__ = ["Molecule", "H2", "HeH_Ion", "LiH", "BeH2", "H2O", "H4", "H6"]
