"""Fermi-Hubbard lattice Hamiltonian and symmetry observables.

Replaces OpenFermion's ``fermi_hubbard`` builder
(``reference/models/hva.py:147-153``) and the observable factories
(``get_particle_number_operator`` / ``get_total_spin`` /
``get_spin_operators``, ``reference/models/hva.py:29-82``).

Conventions (identical to OpenFermion so reference configurations carry over):
  * sites row-major: ``site = x + y * x_dimension``
  * spin-orbitals interleaved: up on even wires ``2*site``, down on odd
    ``2*site + 1``
  * hopping ``-t (a^_i a_j + a^_j a_i)`` per (unordered) lattice edge and spin
  * on-site interaction ``U n_up n_down`` (or the particle-hole symmetric
    variant ``U (n_up - 1/2)(n_down - 1/2)``)
  * periodic wrap edges included, but never double-counted (a 2-site
    direction has a single bond)
"""

from __future__ import annotations

from typing import List, Set, Tuple

from .fermion import FermionOperator, down_index, number_operator, up_index


def hubbard_edges(x_dimension: int, y_dimension: int, periodic: bool = True) -> List[Tuple[int, int]]:
    """Unordered, deduplicated nearest-neighbour site pairs (row-major sites)."""
    edges: Set[Tuple[int, int]] = set()

    def site(x, y):
        return x + y * x_dimension

    for y in range(y_dimension):
        for x in range(x_dimension):
            i = site(x, y)
            # right neighbour
            if x + 1 < x_dimension:
                edges.add(tuple(sorted((i, site(x + 1, y)))))
            elif periodic and x_dimension > 1:
                edges.add(tuple(sorted((i, site(0, y)))))
            # bottom neighbour
            if y + 1 < y_dimension:
                edges.add(tuple(sorted((i, site(x, y + 1)))))
            elif periodic and y_dimension > 1:
                edges.add(tuple(sorted((i, site(x, 0)))))
    return sorted(edges)


def fermi_hubbard(
    x_dimension: int,
    y_dimension: int,
    tunneling: float,
    coulomb: float,
    chemical_potential: float = 0.0,
    magnetic_field: float = 0.0,
    periodic: bool = True,
    spinless: bool = False,
    particle_hole_symmetry: bool = False,
) -> FermionOperator:
    """2D Fermi-Hubbard Hamiltonian as a FermionOperator."""
    n_sites = x_dimension * y_dimension
    edges = hubbard_edges(x_dimension, y_dimension, periodic)
    H = FermionOperator.zero()

    if spinless:
        for (i, j) in edges:
            H += FermionOperator(((i, 1), (j, 0)), -tunneling)
            H += FermionOperator(((j, 1), (i, 0)), -tunneling)
            ni = FermionOperator(((i, 1), (i, 0)))
            nj = FermionOperator(((j, 1), (j, 0)))
            if particle_hole_symmetry:
                ni = ni - FermionOperator((), 0.5)
                nj = nj - FermionOperator((), 0.5)
            H += coulomb * ni * nj
        for i in range(n_sites):
            if chemical_potential:
                H += FermionOperator(((i, 1), (i, 0)), -chemical_potential)
        return H

    for (i, j) in edges:
        for sigma_index in (up_index, down_index):
            a, b = sigma_index(i), sigma_index(j)
            H += FermionOperator(((a, 1), (b, 0)), -tunneling)
            H += FermionOperator(((b, 1), (a, 0)), -tunneling)

    for i in range(n_sites):
        nu = FermionOperator(((up_index(i), 1), (up_index(i), 0)))
        nd = FermionOperator(((down_index(i), 1), (down_index(i), 0)))
        if particle_hole_symmetry:
            H += coulomb * (nu - FermionOperator((), 0.5)) * (nd - FermionOperator((), 0.5))
        else:
            H += coulomb * nu * nd
        if chemical_potential:
            H += (-chemical_potential) * (nu + nd)
        if magnetic_field:
            H += (-magnetic_field) * (nu - nd) * 0.5

    return H


# -- symmetry observables ----------------------------------------------------


def particle_number_operator(x_dimension: int, y_dimension: int, spinless: bool = False) -> FermionOperator:
    """Total particle number (``reference/models/hva.py:29-43``)."""
    n_sites = x_dimension * y_dimension
    total = FermionOperator.zero()
    for site in range(n_sites):
        if spinless:
            total += number_operator(n_sites, site, 1.0)
        else:
            total += number_operator(2 * n_sites, up_index(site), 1.0)
            total += number_operator(2 * n_sites, down_index(site), 1.0)
    return total


def total_spin_number(n_sites: int, spin_type: str) -> FermionOperator:
    """Number of spin-up or spin-down electrons (hva.py:45-59)."""
    total = FermionOperator.zero()
    for site in range(n_sites):
        if spin_type == "spin-up":
            total += number_operator(2 * n_sites, up_index(site), 1.0)
        elif spin_type == "spin-down":
            total += number_operator(2 * n_sites, down_index(site), 1.0)
        else:
            raise ValueError("spin_type must be either spin-up or spin-down")
    return total


def spin_operator(n_sites: int, spin_type: str) -> FermionOperator:
    """Sx / Sy / Sz / S^2 collective spin operators (hva.py:61-82)."""
    Sx = FermionOperator.zero()
    Sy = FermionOperator.zero()
    Sz = FermionOperator.zero()
    for site in range(n_sites):
        iu, idn = up_index(site), down_index(site)
        Sx += FermionOperator(((iu, 1), (idn, 0)), 0.5) + FermionOperator(((idn, 1), (iu, 0)), 0.5)
        Sy += FermionOperator(((iu, 1), (idn, 0)), -0.5j) - FermionOperator(((idn, 1), (iu, 0)), -0.5j)
        Sz += FermionOperator(((iu, 1), (iu, 0)), 0.5) - FermionOperator(((idn, 1), (idn, 0)), 0.5)
    if spin_type == "Sx":
        return Sx
    if spin_type == "Sy":
        return Sy
    if spin_type == "Sz":
        return Sz
    if spin_type == "S^2":
        return Sx * Sx + Sy * Sy + Sz * Sz
    raise ValueError(f"unknown spin_type {spin_type!r}")
