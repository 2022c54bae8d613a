"""Plain reference of the ADAPT-VQE Fermi-Hubbard step and the float64
polish evaluation, worked out again from the configuration alone.

Imports numpy and torch only: nothing of the measured port, nor of the JAX
package.  Every operator acts on a dense statevector over the 2^n
Jordan-Wigner basis of n = 2 * sites spin-orbitals:

* the occupation of mode p is flat-index bit ``n - 1 - p`` (the layout of
  the committed ground-state cache);
* the Jordan-Wigner map a^dag_p = |1><0|_p Z_0 ... Z_{p-1}: a ladder
  operator's sign is the parity of the occupied modes below it, and the
  basis state of the occupied set s_1 < ... < s_k is a^dag_{s_1} ...
  a^dag_{s_k} |0>;
* the Hubbard Hamiltonian -t sum_<ij>,s (a^dag_is a_js + h.c.) + U sum_i
  n_i,up n_i,dn with spin-orbital 2 * site + spin (up = 0), sites row-major
  (x + nx * y), periodic bonds counted once (a two-site direction has one
  bond);
* the pool of momentum-space double excitations G = i (T - T^dag), T =
  c^dag_a c^dag_b c_c c_d over (spin, k1, k2, q != 0), k-mode 2 * (kx + nx
  * ky) + spin, kept in build order and unique up to sign: the simplified
  (opposite-spin) channel, then the same-spin complement for the extended
  pool;
* the ansatz prod_i exp(-i theta_i G_i) |occ> in momentum space.  Each G
  is a single double excitation, so exp(theta (T - T^dag)) mixes each pair
  (|s>, T|s>) by a plane rotation (T^3 = 0 and (T - T^dag)^3 = -(T -
  T^dag)), with no Trotter error;
* the momentum-to-real-space network: the many-body image of the
  spin-block discrete Fourier matrix F (a^dag_k -> sum_r F[k, r]
  a^dag_r), applied through this module's own adjacent-mode Givens
  factorisation (any factorisation of one mode map gives the same
  many-body unitary);
* the occupied k-modes: the lowest single-particle energies of each spin,
  ties to the lower mode index;
* Sz, S^2 = S_- S_+ + Sz^2 + Sz, the fidelity to a degenerate manifold as
  the sum of |<phi_i|psi>|^2, and torch's Adam update.

A ``store`` precision below complex128 rounds every stored state, angle and
moment to it after each operation: the control of the comparison
(``"bfloat16"``, ``"complex64"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# -- the lattice ----------------------------------------------------------------


def lattice_edges(nx: int, ny: int, periodic: bool = True) -> List[Tuple[int, int]]:
    """Unordered nearest-neighbour site pairs, each once (sites x + nx * y)."""
    edges = set()
    for y in range(ny):
        for x in range(nx):
            i = x + nx * y
            for dx, dy, size in ((1, 0, nx), (0, 1, ny)):
                xx, yy = x + dx, y + dy
                if (xx if dx else yy) >= size:
                    if not periodic or size < 2:
                        continue
                    xx, yy = xx % nx, yy % ny
                j = xx + nx * yy
                if i != j:
                    edges.add((min(i, j), max(i, j)))
    return sorted(edges)


def kmode(kx: int, ky: int, spin: int, nx: int, ny: int) -> int:
    return 2 * ((kx % nx) + nx * (ky % ny)) + spin


def occupied_kmodes(nx, ny, t, n_up, n_down, periodic=True) -> List[int]:
    """The lowest single-particle momentum modes of each spin (energies
    rounded to 6 decimals, ties to the lower mode index)."""
    n_sites = nx * ny
    h = np.zeros((n_sites, n_sites))
    for i, j in lattice_edges(nx, ny, periodic):
        h[i, j] = h[j, i] = -t
    xs, ys = np.arange(n_sites) % nx, np.arange(n_sites) // nx
    energy = {}
    for k in range(n_sites):
        kx, ky = k % nx, k // nx
        wave = np.exp(2j * np.pi * (kx * xs / nx + ky * ys / ny)) / math.sqrt(n_sites)
        e = round(float(np.real(np.vdot(wave, h @ wave))), 6)
        for spin in (0, 1):
            energy[2 * k + spin] = e
    up = sorted((m for m in energy if m % 2 == 0), key=lambda m: (energy[m], m))[:n_up]
    down = sorted((m for m in energy if m % 2 == 1), key=lambda m: (energy[m], m))[:n_down]
    return sorted(up + down)


def fourier_matrix(nx: int, ny: int) -> np.ndarray:
    """F[k, r]: the spin-block DFT, F[(k, s), (r, s)] = e^{-2 pi i k.r} /
    sqrt(N) over mode indices 2 * site + spin."""
    n_sites = nx * ny
    n = 2 * n_sites
    F = np.zeros((n, n), complex)
    for row in range(n):
        kx, ky, s = (row // 2) % nx, (row // 2) // nx, row % 2
        for col in range(n):
            x, y, s2 = (col // 2) % nx, (col // 2) // nx, col % 2
            if s == s2:
                F[row, col] = np.exp(-2j * np.pi * (kx * x / nx + ky * y / ny))
    return F / math.sqrt(n_sites)


def _pool_candidates(nx, ny, same_spin):
    n_sites = nx * ny
    for spin in (0, 1):
        other = spin if same_spin else spin ^ 1
        for k1 in range(n_sites):
            for k2 in range(n_sites):
                for q in range(1, n_sites):
                    x1, y1 = k1 % nx, k1 // nx
                    x2, y2 = k2 % nx, k2 // nx
                    qx, qy = q % nx, q // nx
                    yield (kmode(x1 + qx, y1 + qy, spin, nx, ny),
                           kmode(x2 - qx, y2 - qy, other, nx, ny),
                           kmode(x2, y2, other, nx, ny),
                           kmode(x1, y1, spin, nx, ny))


def _unique_doubles(cands):
    out, seen = [], set()
    for a, b, c, d in cands:
        if a == b or c == d or {a, b} == {c, d}:
            continue  # c^2 = 0, or i (T - T^dag) = 0
        key = frozenset((frozenset((a, b)), frozenset((c, d))))
        if key in seen:
            continue
        seen.add(key)
        out.append((a, b, c, d))
    return out


def pool_excitations(nx: int, ny: int, pool: str) -> List[Tuple[int, int, int, int]]:
    """(a, b, c, d) of each pool generator i (c^dag_a c^dag_b c_c c_d -
    h.c.), in pool order: ``"simplified"`` or ``"extended"``."""
    ops = _unique_doubles(_pool_candidates(nx, ny, same_spin=False))
    if pool == "extended":
        ops += _unique_doubles(_pool_candidates(nx, ny, same_spin=True))
    elif pool != "simplified":
        raise ValueError(f"pool {pool!r}")
    return ops


# -- statevector primitives -------------------------------------------------------


def _parity(x: torch.Tensor) -> torch.Tensor:
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


class Basis:
    """Bit helpers over the 2^n flat basis (mode p at bit n - 1 - p)."""

    def __init__(self, n: int, device):
        self.n = n
        self.dim = 1 << n
        self.device = torch.device(device)

    def bit(self, mode: int) -> int:
        return 1 << (self.n - 1 - mode)

    def below(self, mode: int) -> int:
        """Flat mask of the modes 0 .. mode - 1."""
        return (self.dim - 1) ^ ((1 << (self.n - mode)) - 1)

    def ladder_support(self, ladder: Sequence[Tuple[int, int]]):
        """(src int64, sign float64) of a product of ladder operators on
        distinct modes ((mode, dagger) left to right, applied right to
        left): every basis state it does not annihilate and the sign of
        its image src ^ (bits of the modes)."""
        src, sign = self.ladder_supports([ladder])
        return src[0], sign[0]

    def ladder_supports(self, ladders):
        """:meth:`ladder_support` of ladders of one length at once: (B, S)
        tensors."""
        for ladder in ladders:
            if len({m for m, _ in ladder}) != len(ladder):
                raise ValueError("ladder operators on repeated modes")
        dev = self.device

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=dev)[:, None]

        fixed = col([sorted(self.n - 1 - m for m, _ in ladder) for ladder in ladders])[:, 0]
        free = torch.arange(1 << (self.n - fixed.shape[1]), dtype=torch.int64, device=dev)
        free = free[None, :].expand(len(ladders), -1)
        for j in range(fixed.shape[1]):  # open a zero at each fixed bit, lowest first
            p = fixed[:, j:j + 1]
            free = ((free >> p) << (p + 1)) | (free & ((1 << p) - 1))
        src = free | col([sum(self.bit(m) for m, dagger in ladder if not dagger)
                          for ladder in ladders])
        cur = src.clone()
        par = torch.zeros_like(src)
        for j in range(len(ladders[0]) - 1, -1, -1):
            par ^= _parity(cur & col([self.below(ladder[j][0]) for ladder in ladders]))
            cur ^= col([self.bit(ladder[j][0]) for ladder in ladders])
        return src, (1 - 2 * par).to(torch.float64)

    def occupation(self, mode: int) -> torch.Tensor:
        idx = torch.arange(self.dim, dtype=torch.int64, device=self.device)
        return ((idx >> (self.n - 1 - mode)) & 1).to(torch.float64)


# -- precision of the stored values ----------------------------------------------


def make_store(store: str):
    """The rounding applied to every stored complex state and real tensor."""
    if store == "complex128":
        return (lambda z: z), (lambda r: r)
    if store == "complex64":
        return ((lambda z: z.to(torch.complex64).to(torch.complex128)),
                (lambda r: r.to(torch.float32).to(torch.float64)))
    if store == "bfloat16":
        def cz(z):
            return torch.complex(z.real.to(torch.bfloat16).to(torch.float64),
                                 z.imag.to(torch.bfloat16).to(torch.float64))
        return cz, (lambda r: r.to(torch.bfloat16).to(torch.float64))
    raise ValueError(f"store {store!r}")


# -- the problem ------------------------------------------------------------------


@dataclass
class Problem:
    nx: int
    ny: int
    t: float
    u: float
    n_up: int
    n_down: int
    pool: str
    periodic: bool = True


class Reference:
    """The configured problem on one device in complex128 (or rounded to
    ``store``): H, Sz, S^2, the pool, the initial state and the network."""

    def __init__(self, problem: Problem, device="cpu", store: str = "complex128",
                 ground_states: Optional[np.ndarray] = None):
        self.p = problem
        self.n = 2 * problem.nx * problem.ny
        self.basis = Basis(self.n, device)
        self.device = self.basis.device
        self.round_c, self.round_r = make_store(store)
        b = self.basis
        # H's diagonal (U n_up n_dn), Sz's diagonal, the hopping supports
        n_sites = problem.nx * problem.ny
        occ = [b.occupation(m) for m in range(self.n)]
        self.h_diag = problem.u * sum(occ[2 * i] * occ[2 * i + 1] for i in range(n_sites))
        self.sz_diag = 0.5 * sum(occ[2 * i] - occ[2 * i + 1] for i in range(n_sites))
        del occ
        self.hops = []
        for i, j in lattice_edges(problem.nx, problem.ny, problem.periodic):
            for s in (0, 1):
                a, c = 2 * i + s, 2 * j + s
                src, sign = b.ladder_support([(a, 1), (c, 0)])
                self.hops.append((src, src ^ (b.bit(a) | b.bit(c)), sign))
        self.splus = []
        for i in range(n_sites):
            src, sign = b.ladder_support([(2 * i, 1), (2 * i + 1, 0)])
            self.splus.append((src, src ^ (b.bit(2 * i) | b.bit(2 * i + 1)), sign))
        self.excitations = pool_excitations(problem.nx, problem.ny, problem.pool)
        self.occupied = occupied_kmodes(problem.nx, problem.ny, problem.t, problem.n_up,
                                        problem.n_down, problem.periodic)
        self._givens = _adjacent_givens(fourier_matrix(problem.nx, problem.ny).T)
        self.gs = (None if ground_states is None else
                   torch.as_tensor(np.asarray(ground_states, np.complex128), device=self.device))
        self._gen_cache = {}

    # -- operators ------------------------------------------------------------

    def h_apply(self, psi: torch.Tensor) -> torch.Tensor:
        out = self.h_diag * psi
        for src, dst, sign in self.hops:
            out[dst] -= self.p.t * sign * psi[src]
            out[src] -= self.p.t * sign * psi[dst]
        return out

    def energy(self, psi) -> float:
        return float(torch.vdot(psi, self.h_apply(psi)).real)

    def rayleigh(self, psi) -> float:
        return self.energy(psi) / float(torch.vdot(psi, psi).real)

    def sz(self, psi) -> float:
        return float(torch.sum(self.sz_diag * psi.abs() ** 2))

    def s2(self, psi) -> float:
        up = torch.zeros_like(psi)
        for src, dst, sign in self.splus:
            up[dst] += sign * psi[src]
        w = psi.abs() ** 2
        return float(torch.vdot(up, up).real + torch.sum((self.sz_diag ** 2 + self.sz_diag) * w))

    def fidelity(self, psi) -> float:
        if self.gs is None or not len(self.gs):
            return 0.0
        return float(sum(torch.vdot(phi, psi).abs() ** 2 for phi in self.gs))

    # -- circuit ----------------------------------------------------------------

    def initial_state(self) -> torch.Tensor:
        psi = torch.zeros(self.basis.dim, dtype=torch.complex128, device=self.device)
        index = 0
        for m in self.occupied:
            index |= self.basis.bit(m)
        psi[index] = 1.0
        return psi

    def generators(self, indices):
        """{pool index: (pairs, ssgn)} of the pool generators in
        ``indices``: ``pairs`` (2, S) the states s that T = c^dag_a c^dag_b
        c_c c_d maps and their images T s, ``ssgn`` (2, S) the signs of
        exp(theta (T - T^dag)) on the pair: -<Ts|T|s> and +<Ts|T|s>."""
        new = sorted({int(i) for i in indices} - set(self._gen_cache))
        if new:
            ladders = [[(a, 1), (b, 1), (c, 0), (d, 0)]
                       for a, b, c, d in (self.excitations[i] for i in new)]
            src, sign = self.basis.ladder_supports(ladders)
            masks = torch.tensor([sum(self.basis.bit(m) for m, _ in ladder) for ladder in ladders],
                                 dtype=torch.int64, device=self.device)[:, None]
            pairs = torch.stack([src, src ^ masks], 1)
            ssgn = torch.stack([-sign, sign], 1)
            for j, i in enumerate(new):
                self._gen_cache[i] = (pairs[j], ssgn[j])
        return {int(i): self._gen_cache[int(i)] for i in indices}

    @staticmethod
    def _rotate(z, gen, theta: float, xy=None):
        """exp(theta (T - T^dag)) on the last axis of z, in place (``xy``:
        z's pair entries, if already gathered)."""
        pairs, ssgn = gen
        if xy is None:
            xy = z[..., pairs]
        z[..., pairs] = torch.addcmul(math.cos(theta) * xy, ssgn, xy.flip(-2),
                                      value=math.sin(theta))
        return z

    def network(self, psi, inverse=False):
        """The Fourier network's many-body unitary (or its inverse)."""
        rots, diag = self._givens
        if not inverse:
            psi = self._diag_phase(psi, diag)
            for p, u in reversed(rots):
                psi = self._pair_unitary(psi, p, u.conj().T)
        else:
            for p, u in rots:
                psi = self._pair_unitary(psi, p, u)
            psi = self._diag_phase(psi, diag.conj())
        return self.round_c(psi)

    def _diag_phase(self, psi, diag):
        ang = torch.zeros(self.basis.dim, dtype=torch.float64, device=self.device)
        for m in range(self.n):
            v = ang.view(1 << m, 2, -1)
            v[:, 1, :] += float(np.angle(diag[m]))
        return psi * torch.exp(1j * ang)

    def _pair_unitary(self, psi, p: int, u: np.ndarray):
        """The many-body image of the 2x2 mode map u on modes (p, p + 1):
        a^dag_p -> u00 a^dag_p + u10 a^dag_{p+1}, a^dag_{p+1} -> u01
        a^dag_p + u11 a^dag_{p+1}."""
        v = psi.view(1 << p, 2, 2, -1)
        cp, cq = v[:, 1, 0, :].clone(), v[:, 0, 1, :].clone()
        v[:, 1, 0, :] = complex(u[0, 0]) * cp + complex(u[0, 1]) * cq
        v[:, 0, 1, :] = complex(u[1, 0]) * cp + complex(u[1, 1]) * cq
        v[:, 1, 1, :] *= complex(u[0, 0] * u[1, 1] - u[0, 1] * u[1, 0])
        return psi

    def kstate(self, theta, indices) -> torch.Tensor:
        gens = self.generators(indices)
        psi = self.initial_state()
        for th, i in zip(np.asarray(theta, np.float64).tolist(), indices):
            psi = self.round_c(self._rotate(psi, gens[int(i)], th))
        return psi

    def state(self, theta, indices) -> torch.Tensor:
        return self.network(self.kstate(theta, indices))

    def value_and_grad(self, theta, indices):
        """(E, psi, dE/dtheta) of E = <psi|H|psi> through the reverse
        sweep: dE/dtheta_k = 2 Re <chi_k|(T_k - T_k^dag) phi_k>, phi_k the
        momentum-space state after generator k and chi_k the network's
        inverse of H psi swept back to it."""
        theta = np.asarray(theta, np.float64)
        gens = self.generators(indices)
        phi = self.kstate(theta, indices)
        psi = self.network(phi.clone())
        hpsi = self.round_c(self.h_apply(psi))
        e = float(torch.vdot(psi, hpsi).real)
        both = torch.stack([phi, self.network(hpsi, inverse=True)])
        parts = []
        for k in range(len(indices) - 1, -1, -1):
            gen = gens[int(indices[k])]
            xy = both[:, gen[0]]  # (phi, chi) at (s, T s)
            # sum over pairs of sign (conj(chi[Ts]) phi[s] - conj(chi[s]) phi[Ts])
            parts.append(torch.sum(gen[1] * (xy[1].flip(0).conj() * xy[0])))
            both = self.round_c(self._rotate(both, gen, -float(theta[k]), xy))
        grads = -2.0 * torch.stack(parts[::-1]).real
        return e, psi, self.round_r(grads).cpu().numpy()

    # -- training ---------------------------------------------------------------

    def train(self, theta0, indices, lr: float, steps: int, chunks: int = 1,
              betas=(0.9, 0.999), eps=1e-8):
        """``chunks`` x ``steps`` Adam steps from theta0 and a fresh Adam
        state: per-step E and ||g||; at the end of each chunk of ``steps``,
        Sz, S^2 and fidelity of its last step's state, the Rayleigh energy
        of the state after its last update and the angles after it (lists,
        one entry a chunk); and the first step's gradient."""
        th = self.round_r(torch.as_tensor(np.asarray(theta0, np.float64)))
        m = torch.zeros_like(th)
        v = torch.zeros_like(th)
        rows = dict(energy=[], gnorm=[], Sz=[], S2=[], fidelity=[], e_df=[], theta=[])
        g1 = None
        for step in range(1, chunks * steps + 1):
            e, psi, g = self.value_and_grad(th.numpy(), indices)
            g = torch.as_tensor(g)
            g1 = g.numpy().copy() if g1 is None else g1
            rows["energy"].append(e)
            rows["gnorm"].append(float(torch.linalg.vector_norm(g)))
            m = self.round_r(betas[0] * m + (1 - betas[0]) * g)
            v = self.round_r(betas[1] * v + (1 - betas[1]) * g * g)
            bc1, bc2 = 1 - betas[0] ** step, 1 - betas[1] ** step
            th = self.round_r(th - lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + eps))
            if step % steps == 0:
                rows["Sz"].append(self.sz(psi))
                rows["S2"].append(self.s2(psi))
                rows["fidelity"].append(self.fidelity(psi))
                rows["e_df"].append(self.rayleigh(self.state(th.numpy(), indices)))
                rows["theta"].append(th.numpy().copy())
        rows["g1"] = g1
        return rows


def _adjacent_givens(M: np.ndarray):
    """([(p, u)], diag): 2x2 unitaries u on adjacent rows (p, p + 1) with
    u_L ... u_1 M = diag(diag), in application order 1 .. L, so M = u_1^dag
    ... u_L^dag diag."""
    M = np.array(M, complex)
    n = M.shape[0]
    rots = []
    for col in range(n - 1):
        for row in range(n - 1, col, -1):
            a, b = M[row - 1, col], M[row, col]
            if abs(b) < 1e-14:
                continue
            r = math.hypot(abs(a), abs(b))
            u = np.array([[a.conjugate(), b.conjugate()], [-b, a]]) / r
            M[row - 1:row + 1, :] = u @ M[row - 1:row + 1, :]
            M[row, col] = 0.0
            rots.append((row - 1, u))
    off = M - np.diag(np.diag(M))
    if np.abs(off).max() > 1e-10:
        raise AssertionError("the Givens factorisation did not diagonalise")
    return rots, np.diag(M).copy()
