"""Shared driver infrastructure: problem setup, ground truth, device policy.

Counterpart of ``qsfh_tpu/algos/base.py``.  ``HubbardProblem.ground_state``
reads the npz ground-state cache (the JAX package's path schema and file
format, so either package reads what the other wrote) or computes it with
the sector Lanczos solver in complex128 on the card (or the CPU, when the
caller asks for it) and writes it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..engine.circuits import get_non_interacting_ground_state_indices
from ..engine.expectation import Observable, diagonal_weight_vector
from ..engine.state import resolve_device
from ..io import checkpoint as ckpt
from ..linalg.lanczos import degenerate_ground_space, ground_state as lanczos_ground_state
from ..ops.fourier import fourier_transform, fourier_transform_matrix
from ..ops.givens import givens_decomposition_square
from ..ops.hva import get_hva_commuting_hopping_terms
from ..ops.jw import jordan_wigner
from ..ops.lattice import (
    fermi_hubbard,
    particle_number_operator,
    spin_operator,
    total_spin_number,
)
from ..ops.tools import get_interacting_term, get_quadratic_term


def state_on_device(psi, device=None) -> torch.Tensor:
    """A state as a tensor: a tensor as it is, on its own device; an array
    copied to ``resolve_device(device)``."""
    if torch.is_tensor(psi):
        return psi
    return torch.as_tensor(np.asarray(psi)).to(resolve_device(device))


def adam_step(thetas, grads, optimizer):
    """One step of ``optimizer`` (a ``torch.optim.Adam`` over ``[thetas]``)
    on ``grads``, ``thetas`` updated in place: (thetas, optimizer, gnorm)."""
    gnorm = torch.linalg.vector_norm(grads)
    thetas.grad = grads
    optimizer.step()
    return thetas, optimizer, gnorm


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

    def ground_state(self, degenerate: bool = False, n_states: int = 4, force: bool = False,
                     path: str = None, device=None):
        """Cached exact ground state (energy, wavefunction or list of them,
        as host arrays).

        Reads ``path`` when given, else the cache under ``results_root``
        (``deg{n}`` suffix for a degenerate manifold), else the same file
        name in the shared directory ``QSFH_ED_CACHE_DIR`` (copied to the
        per-root path); otherwise, or with ``force``, solves with the
        sector Lanczos solver (:mod:`qsfh_torch.linalg.lanczos`, complex128)
        on ``resolve_device(device)``, the card unless the caller asks for
        the CPU, and writes the per-root file and the shared one: the states
        come to the host there.
        """
        dev = resolve_device(device)
        if path is None:
            path = self.ground_state_path()
            if degenerate:
                path = path.replace(".npz", f" deg{n_states}.npz")

        def done(energy, wfs):
            return (energy, wfs) if degenerate else (energy, wfs[0])

        resolved = ckpt.resolve(path)
        if os.path.exists(resolved) and not force:
            return done(*ckpt.load_ground_state(resolved))
        # read-through shared cache: the config tag is the cache identity, so
        # independent results_roots share one solve; the per-root copy is
        # still written
        shared_dir = os.environ.get("QSFH_ED_CACHE_DIR")
        shared = os.path.join(shared_dir, os.path.basename(path)) if shared_dir else None
        if shared and os.path.exists(shared) and not force:
            energy, wfs = ckpt.load_ground_state(shared)
            ckpt.save_ground_state(path, energy, wfs)
            return done(energy, wfs)

        args = (self.qubit_hamiltonian, self.n_qubits, self.n_electrons, self.n_spin_up,
                self.n_spin_down)
        if degenerate:
            energy, states = degenerate_ground_space(*args, n_states=n_states, device=dev)
        else:
            energy, wf = lanczos_ground_state(*args, device=dev)
            states = [wf]
        wfs = [s.cpu().numpy() for s in states]
        ckpt.save_ground_state(path, energy, wfs)
        if shared:
            ckpt.save_ground_state(shared, energy, wfs)
        return done(energy, wfs)

    # -- HVA structure ------------------------------------------------------------

    def hva_generators(self):
        """(horizontal, vertical) JW generators of the HVA's hopping classes."""
        h, v = get_hva_commuting_hopping_terms(self.x_dimension, self.y_dimension, self.periodic)
        return [jordan_wigner(g) for g in h], [jordan_wigner(g) for g in v]

    def coulomb_diagonal(self, dtype=torch.float64, device="cpu") -> torch.Tensor:
        """The diagonal of JW(U term) on ``device``: the whole Coulomb
        Trotter layer is one elementwise pass.  The identity component is
        subtracted, as ``rotation_terms()`` drops it (the reference's
        Trotterize skips identity terms, ``hva.py:90-91``), so the diagonal
        and the rotation forms of the layer agree exactly, global phase
        included."""
        ujw = jordan_wigner(self.interacting_term)
        shift = ujw.constant().real
        D = diagonal_weight_vector(ujw, self.n_qubits, dtype=torch.float64, device=device)
        return (D - shift).to(dtype)
