from .fermion import (
    FermionOperator,
    down_index,
    hermitian_conjugated,
    normal_ordered,
    number_operator,
    up_index,
)
from .fourier import fourier_transform, fourier_transform_matrix, inverse_fourier_transform
from .givens import givens_decomposition_square
from .hva import compile_hva_hopping_indices, get_hva_commuting_hopping_terms
from .jw import jordan_wigner
from .lattice import fermi_hubbard, particle_number_operator, spin_operator
from .pauli import PauliSum, qubit_operator
from .tools import get_interacting_term, get_quadratic_term

__all__ = [
    "FermionOperator",
    "down_index",
    "hermitian_conjugated",
    "normal_ordered",
    "number_operator",
    "up_index",
    "fourier_transform",
    "fourier_transform_matrix",
    "inverse_fourier_transform",
    "givens_decomposition_square",
    "compile_hva_hopping_indices",
    "get_hva_commuting_hopping_terms",
    "jordan_wigner",
    "fermi_hubbard",
    "particle_number_operator",
    "spin_operator",
    "PauliSum",
    "qubit_operator",
    "get_interacting_term",
    "get_quadratic_term",
]
