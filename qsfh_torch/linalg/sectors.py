"""(N, Sz)-symmetry-sector utilities.

Counterpart of ``qsfh_tpu/linalg/sectors.py``: the sector's statevector
indices in the reference's embedding order, its dimension, and sector
masks computed elementwise from bit counts over the flat index.

Bit convention: statevector index ``b`` has qubit/mode ``q`` occupied iff bit
``(n_qubits - 1 - q)`` is set; spin-up lives on even modes.
"""

from __future__ import annotations

import itertools
from math import comb
from typing import List, Optional

import torch

from ..engine.state import index_bits, qmask_to_bmask, real_dtype


def jw_number_spin_indices(
    n_electrons: int, spin_up: int, spin_down: int, n_qubits: int
) -> List[int]:
    """Statevector indices of the fixed (N, N_up) sector.

    Occupations are enumerated lexicographically, then reversed, as the
    reference does (``exact_diagonalization.py:16-23``), so the
    sector<->full-space embedding is bit-for-bit the JAX package's.
    """
    if spin_up + spin_down != n_electrons:
        raise ValueError("spin up plus spin down must equal to n_electrons!")
    new_occupations = []
    for occ in itertools.combinations(range(n_qubits), n_electrons):
        if sum(1 for p in occ if p % 2 == 0) == spin_up:
            new_occupations.append(occ)
    return [
        sum(1 << (n_qubits - n - 1) for n in occupation)
        for occupation in reversed(new_occupations)
    ]


def sector_dimension(n_electrons: int, spin_up: int, n_qubits: int) -> int:
    """Dimension of the (N, N_up) sector; spin-up lives on the even half."""
    n_sites = n_qubits // 2
    spin_down = n_electrons - spin_up
    return comb(n_sites, spin_up) * comb(n_sites, spin_down)


def _bit_count(v: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Set bits of each non-negative int64 value below 2^n_bits."""
    total = torch.zeros_like(v)
    for q in range(n_bits):
        total += (v >> q) & 1
    return total


def sector_mask(n_qubits: int, n_electrons: int, spin_up: int, device="cpu") -> torch.Tensor:
    """Boolean mask over flat indices: membership in the (N, N_up) sector."""
    idx = index_bits(n_qubits, device)
    even_qubits = sum(1 << q for q in range(0, n_qubits, 2))
    up_bmask = qmask_to_bmask(even_qubits, n_qubits)
    total = _bit_count(idx, n_qubits)
    ups = _bit_count(idx & up_bmask, n_qubits)
    return (total == n_electrons) & (ups == spin_up)


def project_to_sector(
    psi: torch.Tensor, n_qubits: int, n_electrons: int, spin_up: int
) -> torch.Tensor:
    mask = sector_mask(n_qubits, n_electrons, spin_up, psi.device)
    return torch.where(mask, psi, torch.zeros((), dtype=psi.dtype, device=psi.device))


def random_sector_state(
    n_qubits: int,
    n_electrons: int,
    spin_up: int,
    generator: Optional[torch.Generator] = None,
    dtype=torch.complex128,
    device="cpu",
) -> torch.Tensor:
    """Normalized random vector supported on the sector (a Lanczos seed).

    ``generator`` seeds the draw (a fresh one seeded 0 when None); its
    numbers differ from ``jax.random``'s for the same seed.
    """
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    rdt = real_dtype(dtype)
    dim = 1 << n_qubits
    re = torch.randn(dim, generator=generator, dtype=rdt, device=device)
    im = torch.randn(dim, generator=generator, dtype=rdt, device=device)
    v = project_to_sector(torch.complex(re, im), n_qubits, n_electrons, spin_up)
    return v / torch.linalg.vector_norm(v)
