"""Shared driver infrastructure: problem setup, ground truth, device policy.

Counterpart of ``qsfh_tpu/algos/base.py``.  Exact diagonalization is not
ported yet: ``HubbardProblem.ground_state`` reads the npz cache that the
JAX package writes (same path schema), or an explicit cache file.
"""

from __future__ import annotations

import os

import torch

from ..engine.circuits import get_non_interacting_ground_state_indices
from ..engine.expectation import Observable
from ..io import checkpoint as ckpt
from ..ops.fourier import fourier_transform, fourier_transform_matrix
from ..ops.givens import givens_decomposition_square
from ..ops.jw import jordan_wigner
from ..ops.lattice import (
    fermi_hubbard,
    particle_number_operator,
    spin_operator,
    total_spin_number,
)
from ..ops.tools import get_interacting_term, get_quadratic_term


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    CUDA device exists; there is no silent move to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def default_dtype(device) -> torch.dtype:
    """complex64 on CUDA (the kernels' float32 policy), complex128 elsewhere."""
    return torch.complex64 if torch.device(device).type == "cuda" else torch.complex128


class HubbardProblem:
    """A configured Fermi-Hubbard instance with everything drivers need."""

    def __init__(
        self,
        x_dimension: int,
        y_dimension: int,
        tunneling: float,
        coulomb: float,
        n_electrons: int,
        n_spin_up: int,
        n_spin_down: int,
        periodic: bool = True,
        spinless: bool = False,
        particle_hole_symmetry: bool = False,
        results_root: str = "./results",
    ):
        if n_spin_up + n_spin_down != n_electrons:
            raise ValueError("n_spin_up + n_spin_down must equal n_electrons")
        self.x_dimension = x_dimension
        self.y_dimension = y_dimension
        self.tunneling = tunneling
        self.coulomb = coulomb
        self.n_electrons = n_electrons
        self.n_spin_up = n_spin_up
        self.n_spin_down = n_spin_down
        self.periodic = periodic
        self.n_sites = x_dimension * y_dimension
        self.n_qubits = 2 * self.n_sites
        self.results_root = results_root

        self.fermion_hamiltonian = fermi_hubbard(
            x_dimension,
            y_dimension,
            tunneling,
            coulomb,
            periodic=periodic,
            spinless=spinless,
            particle_hole_symmetry=particle_hole_symmetry,
        )
        self.qubit_hamiltonian = jordan_wigner(self.fermion_hamiltonian)
        self.quadratic_term = get_quadratic_term(self.fermion_hamiltonian)
        self.interacting_term = get_interacting_term(self.fermion_hamiltonian)

        self.fermion_operators = {
            "hopping": self.quadratic_term,
            "coulomb": self.interacting_term,
            "particle number": particle_number_operator(x_dimension, y_dimension, spinless),
            "spin up": total_spin_number(self.n_sites, "spin-up"),
            "spin down": total_spin_number(self.n_sites, "spin-down"),
            "Sx": spin_operator(self.n_sites, "Sx"),
            "Sy": spin_operator(self.n_sites, "Sy"),
            "Sz": spin_operator(self.n_sites, "Sz"),
            "S^2": spin_operator(self.n_sites, "S^2"),
        }
        self.observables = {
            "H": Observable(self.qubit_hamiltonian, self.n_qubits),
            "Sz": Observable(jordan_wigner(self.fermion_operators["Sz"]), self.n_qubits),
            "S^2": Observable(jordan_wigner(self.fermion_operators["S^2"]), self.n_qubits),
        }

        # momentum-space structure
        self.ft_matrix = fourier_transform_matrix(x_dimension, y_dimension)
        self.decomposition, self.diagonal = givens_decomposition_square(self.ft_matrix)
        self.k_quadratic_term = fourier_transform(self.quadratic_term, x_dimension, y_dimension)
        self.spin_up_indices, self.spin_down_indices = get_non_interacting_ground_state_indices(
            self.k_quadratic_term, self.n_qubits, n_spin_up, n_spin_down
        )

    # -- file identity ---------------------------------------------------------

    def tag(self, algo: str, **extra) -> str:
        return ckpt.config_tag(
            algo,
            self.x_dimension,
            self.y_dimension,
            self.tunneling,
            self.coulomb,
            self.n_electrons,
            self.n_spin_up,
            self.n_spin_down,
            **extra,
        )

    def ground_state_path(self) -> str:
        tag = ckpt.config_tag(
            "Hubbard",
            self.x_dimension,
            self.y_dimension,
            self.tunneling,
            self.coulomb,
            self.n_electrons,
        )
        return os.path.join(self.results_root, "ground_state_results", tag + ".npz")

    # -- exact ground truth ----------------------------------------------------

    def ground_state(self, degenerate: bool = False, n_states: int = 4, path: str = None):
        """Cached exact ground state (energy, wavefunction or list of them).

        Reads ``path`` when given, else the cache under ``results_root``
        (the JAX package's schema, ``deg{n}`` suffix for a degenerate
        manifold).  Exact diagonalization itself is not ported yet, so a
        missing cache raises.
        """
        if path is None:
            path = self.ground_state_path()
            if degenerate:
                path = path.replace(".npz", f" deg{n_states}.npz")
        resolved = ckpt.resolve(path)
        if not os.path.exists(resolved):
            raise FileNotFoundError(
                f"no cached ground state at {path!r}: exact diagonalization is "
                "not ported to qsfh_torch yet; write the cache with the JAX "
                "package (qsfh_tpu HubbardProblem.ground_state) or pass "
                "ground_truth=False"
            )
        energy, wfs = ckpt.load_ground_state(resolved)
        if degenerate and len(wfs) != n_states:
            raise ValueError(f"{path!r} holds {len(wfs)} states, expected {n_states}")
        return (energy, wfs) if degenerate else (energy, wfs[0])
