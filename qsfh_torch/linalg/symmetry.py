"""Lattice point-group symmetry analysis of Hubbard eigenstates.

Counterpart of ``qsfh_tpu/linalg/symmetry.py``: the C4 irrep (s / px / py
/ d-wave) resolution of degenerate ground manifolds and total-momentum
weights.  A lattice symmetry permutes modes; its action on a Jordan-Wigner
Fock state carries the parity sign of sorting the permuted occupied-mode
list (``permute_modes``; ``signed=False`` keeps the unsigned map, which
does not commute with H, for tests that show it).  The C4 character
projectors are ``P_s = (1+r+r^2+r^3)/4``, ``P_d = (1-r+r^2-r^3)/4``,
``P_E = (1-r^2)/2``, E split into px/py by the x-axis reflection.

Site maps: rot90 is ``(x, y) -> (y, -x mod nx)`` (square lattices only),
the reflections ``(x, y) -> (x, -y mod ny)`` / ``(-x mod nx, y)``,
row-major sites.  The state work runs in torch on the state's device: a
tensor stays where it is, a numpy state goes to
``resolve_device(device)``; the occupancy of the nonzero amplitudes is an
int64 (m, n) matrix there.  The ground space comes from the port's ED
(:mod:`qsfh_torch.linalg.exact`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..algos.base import state_on_device
from .exact import jw_get_ground_state

__all__ = [
    "rot90_site_map",
    "reflect_site_map",
    "translation_site_map",
    "mode_permutation",
    "permute_modes",
    "c4_irrep_components",
    "symmetry_adapted_states",
    "symmetry_adapted_ground_space",
    "irrep_weights",
    "momentum_weights",
    "momentum_project",
]


# -- site / mode permutations -------------------------------------------------


def rot90_site_map(nx: int, ny: int) -> List[int]:
    """90-degree lattice rotation as a site permutation (row-major sites):
    ``map[s_old] = s_new`` with ``(x, y) -> (y, (-x) mod nx)``."""
    if nx != ny:
        raise ValueError(f"rot90 needs a square lattice, got {nx}x{ny}")
    return [y + ((-x) % nx) * nx for y in range(ny) for x in range(nx)]


def reflect_site_map(nx: int, ny: int, axis: str) -> List[int]:
    """Reflection site permutation: 'x' fixes x (``y -> -y``), 'y' fixes y."""
    out = []
    for y in range(ny):
        for x in range(nx):
            if axis == "x":
                xn, yn = x, (-y) % ny
            elif axis == "y":
                xn, yn = (-x) % nx, y
            else:
                raise ValueError(f"axis must be 'x' or 'y', got {axis!r}")
            out.append(xn + yn * nx)
    return out


def translation_site_map(nx: int, ny: int, dx: int, dy: int) -> List[int]:
    """Periodic lattice translation ``(x, y) -> (x+dx, y+dy)`` as a site
    permutation."""
    return [
        ((x + dx) % nx) + ((y + dy) % ny) * nx for y in range(ny) for x in range(nx)
    ]


def mode_permutation(site_map: Sequence[int]) -> np.ndarray:
    """Lift a site permutation to JW modes (spin-up on even, 2s / 2s+1)."""
    p = np.zeros(2 * len(site_map), dtype=np.int64)
    for s, sn in enumerate(site_map):
        p[2 * s] = 2 * sn
        p[2 * s + 1] = 2 * sn + 1
    return p


def _complex_state(psi, device) -> torch.Tensor:
    """The state on its device (:func:`state_on_device`), as complex."""
    psi = state_on_device(psi, device)
    return psi if psi.is_complex() else psi.to(torch.complex128)


def permute_modes(psi, perm, signed: bool = True, device=None) -> torch.Tensor:
    """Apply the second-quantized unitary ``U: a^dag_q -> a^dag_{perm[q]}``.

    ``psi`` is a full ``2^n`` statevector; mode ``q`` occupies bit
    ``n-1-q``.  ``U|n> = sign * |n'>`` where ``n'`` occupies the permuted
    modes and ``sign`` is the parity of sorting the image list of the
    (ascending) occupied modes.  Vectorized over the nonzero amplitudes:
    an int64 occupancy matrix, new indices by one weighted sum, inversion
    counts by one contraction with the permutation's pair table.
    """
    psi = state_on_device(psi, device)
    perm = torch.as_tensor(np.asarray(perm, dtype=np.int64), device=psi.device)
    n = perm.numel()
    if tuple(psi.shape) != (1 << n,):
        raise ValueError(f"state has shape {tuple(psi.shape)}, expected ({1 << n},)")
    idx = torch.nonzero(psi).reshape(-1)
    shifts = n - 1 - torch.arange(n, device=psi.device)
    occ = (idx[:, None] >> shifts[None, :]) & 1  # (m, n) int64
    new_idx = (occ * (torch.ones_like(perm) << (n - 1 - perm))[None, :]).sum(dim=1)
    out = torch.zeros_like(psi)
    if signed:
        q = torch.arange(n, device=psi.device)
        pair = (q[:, None] < q[None, :]) & (perm[:, None] > perm[None, :])
        # the inversion counts (at most n^2 / 2) are exact in float64; CUDA
        # has no integer matrix product
        occ_f = occ.to(torch.float64)
        inv = ((occ_f @ pair.to(torch.float64)) * occ_f).sum(dim=1).round().to(torch.int64)
        sign = 1 - 2 * (inv % 2)
        out[new_idx] = sign.to(psi.dtype) * psi[idx]
    else:
        out[new_idx] = psi[idx]
    return out


# -- irrep projections ----------------------------------------------------------


def c4_irrep_components(psi, rotate: Callable) -> Dict[str, torch.Tensor]:
    """Character projections of ``psi`` under the cyclic group {1, r, r2,
    r3}: the (unnormalized) A ('s'), B ('d') and E components."""
    r1 = rotate(psi)
    r2 = rotate(r1)
    r3 = rotate(r2)
    return {
        "s": (psi + r1 + r2 + r3) / 4.0,
        "d": (psi - r1 + r2 - r3) / 4.0,
        "E": (psi - r2) / 2.0,
    }


def symmetry_adapted_states(
    psi0, nx: int, ny: int, tol: float = 1e-8, device=None
) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Resolve a (generic) ground vector into normalized s/px/py/d states.

    Components whose projection norm falls below ``tol`` are omitted.
    Returns ``(states, norms)`` where ``norms`` maps every label to the
    pre-normalization projection norm.
    """
    psi0 = state_on_device(psi0, device)
    rot_perm = mode_permutation(rot90_site_map(nx, ny))
    mx_perm = mode_permutation(reflect_site_map(nx, ny, "x"))
    comps = c4_irrep_components(psi0, lambda s: permute_modes(s, rot_perm))
    e = comps.pop("E")
    mx_e = permute_modes(e, mx_perm)
    comps["px"] = (e + mx_e) / 2.0  # even under y -> -y, transforms like x
    comps["py"] = (e - mx_e) / 2.0
    states: Dict[str, torch.Tensor] = {}
    norms: Dict[str, float] = {}
    for label in ("s", "px", "py", "d"):
        v = comps[label]
        nv = float(torch.linalg.vector_norm(v))
        norms[label] = nv
        if nv > tol:
            states[label] = v / nv
    return states, norms


def symmetry_adapted_ground_space(
    sparse_operator,
    particle_number: int,
    spin_up: int,
    spin_down: int,
    nx: int,
    ny: int,
    tol: float = 1e-8,
    device=None,
) -> Tuple[float, Dict[str, torch.Tensor], Dict[str, float]]:
    """The sector ground state (the port's ED, host complex128) resolved
    into labeled C4 irrep members on ``resolve_device(device)``.  Returns
    ``(energy, states, norms)``."""
    energy, psi0 = jw_get_ground_state(sparse_operator, particle_number, spin_up, spin_down)
    states, norms = symmetry_adapted_states(psi0, nx, ny, tol=tol, device=device)
    return energy, states, norms


def _translations(psi, nx: int, ny: int):
    """(dx, dy, T_(dx,dy) psi) for every translation of the lattice, each
    built from its neighbour by one signed permutation pass."""
    tx = mode_permutation(translation_site_map(nx, ny, 1, 0))
    ty = mode_permutation(translation_site_map(nx, ny, 0, 1))
    shifted_x = psi
    for dx in range(nx):
        shifted = shifted_x
        for dy in range(ny):
            yield dx, dy, shifted
            if dy + 1 < ny:
                shifted = permute_modes(shifted, ty)
        if dx + 1 < nx:
            shifted_x = permute_modes(shifted_x, tx)


def momentum_project(psi, nx: int, ny: int, kx: int, ky: int, device=None) -> torch.Tensor:
    """Project onto total lattice momentum ``(2*pi*kx/nx, 2*pi*ky/ny)``:
    ``P_k = (1/N) sum_R exp(-i k . R) T_R`` over all ``N = nx*ny``
    translations, each applied with fermionic signs."""
    psi = _complex_state(psi, device)
    acc = torch.zeros_like(psi)
    for dx, dy, shifted in _translations(psi, nx, ny):
        phase = complex(np.exp(-2j * np.pi * (kx * dx / nx + ky * dy / ny)))
        acc = acc + phase * shifted
    return acc / (nx * ny)


def momentum_weights(psi, nx: int, ny: int, device=None) -> Dict[Tuple[int, int], float]:
    """Weight ``||P_k psi||^2 = (1/N) sum_R e^{-i k.R} <psi|T_R|psi>`` of a
    state in each momentum sector (the weights sum to ``||psi||^2``): the
    N translated states are built once and every weight is a phase-weighted
    sum of the same N overlaps."""
    psi = _complex_state(psi, device)
    overlaps = np.zeros((nx, ny), dtype=complex)  # <psi | T_(dx,dy) psi>
    vals = [(dx, dy, torch.vdot(psi, shifted)) for dx, dy, shifted in _translations(psi, nx, ny)]
    got = torch.stack([v for _, _, v in vals]).cpu().numpy()
    for (dx, dy, _), o in zip(vals, got):
        overlaps[dx, dy] = o
    dxs = np.arange(nx)[:, None]
    dys = np.arange(ny)[None, :]
    out: Dict[Tuple[int, int], float] = {}
    for kx in range(nx):
        for ky in range(ny):
            phases = np.exp(-2j * np.pi * (kx * dxs / nx + ky * dys / ny))
            out[(kx, ky)] = float(np.real((phases * overlaps).sum()) / (nx * ny))
    return out


def irrep_weights(psi, states: Dict[str, torch.Tensor], device=None) -> Dict[str, float]:
    """``|<irrep_state | psi>|^2`` per labeled manifold member (their sum is
    the manifold fidelity where the labeled states span the manifold)."""
    p = state_on_device(psi, device)
    return {k: float(torch.abs(torch.vdot(v, p.to(device=v.device, dtype=v.dtype))) ** 2)
            for k, v in states.items()}
