"""Operator pools for adaptive ansatz growth (ADAPT-VQE).

Native rebuild of ``reference/operators/pool.py``: the same five pool
families with identical operator content and iteration order, built on the
in-repo fermionic algebra.  The reference deduplicates by an O(|pool|) list
scan per candidate (``pool.py:252``); here candidates are keyed by a
canonical (sign-normalized) form in a dict, which is O(1) per candidate and
keeps identical pool contents/order.

All pools are momentum-space: mode indexing is ``2*(kx + ky*Nx) + spin``
(``pool.py:225-226``), matching the lattice Fourier convention of
:mod:`qsfh_torch.ops.fourier`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .fermion import (
    FermionOperator,
    hermitian_conjugated,
    normal_ordered,
)


def _canonical_key(op: FermionOperator, up_to_sign: bool, decimals: int = 10):
    """Hashable key identifying ``op`` (optionally up to overall sign).

    With ``up_to_sign`` the sign is fixed by the coefficient of the
    lexicographically smallest term, so ``key(op) == key(-op)``.
    """
    if not op.terms:
        return ()
    items = sorted(op.terms.items())
    sign = 1.0
    if up_to_sign:
        c0 = items[0][1]
        if (round(c0.real, decimals), round(c0.imag, decimals)) < (0.0, 0.0):
            sign = -1.0
    return tuple(
        (term, round(sign * c.real, decimals), round(sign * c.imag, decimals))
        for term, c in items
    )


class _SignDedup:
    """Ordered collection of unique operators.

    ``up_to_sign=True`` matches the reference's ``op not in pool and
    -op not in pool`` scans (pool.py:252); ``False`` matches its exact
    ``op not in pool`` scans (pool.py:292, :353) -- there ±op pairs survive,
    which matters when a channel is later summed.
    """

    def __init__(self, up_to_sign: bool = True):
        self._seen: Dict[tuple, None] = {}
        self.ops: List[FermionOperator] = []
        self.up_to_sign = up_to_sign

    def add(self, op: FermionOperator) -> bool:
        key = _canonical_key(op, self.up_to_sign)
        if key in self._seen:
            return False
        self._seen[key] = None
        self.ops.append(op)
        return True


def _k_indexers(Nx: int, Ny: int):
    def tuple2index(kx: int, ky: int, spin: int) -> int:
        return 2 * (kx % Nx + (ky % Ny) * Nx) + spin

    def index2tuple(index: int) -> Tuple[int, int]:
        return (index % Nx, index // Nx)

    return tuple2index, index2tuple


# -- UCCSD-style index lists (pool.py:15-46) -----------------------------------


def excitations(n_electrons: int, n_orbitals: int, delta_sz: int = 0, generalized: bool = True):
    """Single/double excitation index lists with a spin-projection filter.

    Parity with ``excitations`` (reference/operators/pool.py:15-46):
    spin-orbital sz is +1/2 on even indices, -1/2 on odd.
    """
    n_so = n_orbitals * 2
    sz = np.where(np.arange(n_so) % 2 == 0, 0.5, -0.5)

    singles = []
    end = n_so if generalized else n_electrons
    for q in range(end):
        start = q + 1 if generalized else n_so
        for p in range(start, n_so):
            if sz[p] - sz[q] == delta_sz:
                singles.append([q, p])

    doubles = []
    for s in range(end - 1):
        for r in range(s + 1, end):
            start = r + 1 if generalized else n_electrons
            for q in range(start, n_so - 1):
                for p in range(q + 1, n_so):
                    if sz[p] + sz[q] - sz[r] - sz[s] == delta_sz:
                        doubles.append([s, r, q, p])
    return singles, doubles


# -- spin-complemented real-space pool (pool.py:48-131) -------------------------


def spin_complemented_pool(n_electrons: int, n_orbitals: int, generalized: bool = True):
    """Spin-complemented singles + doubles pool.

    Parity with ``spin_complemented_pool`` (pool.py:48-131) EXCEPT one
    deliberate fix: the reference's doubles block reads ``p_up``/``p_down``
    left over from the singles loop (stale closure variables, pool.py:115-121)
    instead of deriving them from the loop variable ``p``; here they follow
    the documented intent p_up = 2p, p_down = 2p+1.
    """
    n_occ = n_electrons // 2
    pool: List[FermionOperator] = []

    end = n_orbitals if generalized else n_occ
    for q in range(end):
        qu, qd = 2 * q, 2 * q + 1
        start = q + 1 if generalized else n_occ
        for p in range(start, n_orbitals):
            pu, pd = 2 * p, 2 * p + 1
            tau_up = FermionOperator(f"{pu}^ {qu}") - FermionOperator(f"{qu}^ {pu}")
            tau_down = FermionOperator(f"{pd}^ {qd}") - FermionOperator(f"{qd}^ {pd}")
            op = normal_ordered(tau_up + tau_down)
            if op.many_body_order() > 0:
                pool.append(op)

    for s in range(end):
        su, sd = 2 * s, 2 * s + 1
        for r in range(s, end):
            ru, rd = 2 * r, 2 * r + 1
            start = r + 1 if generalized else n_occ
            for q in range(start, n_orbitals):
                qu, qd = 2 * q, 2 * q + 1
                for p in range(q, n_orbitals):
                    pu, pd = 2 * p, 2 * p + 1
                    op1 = FermionOperator(f"{pu}^ {qu}^ {ru} {su}")
                    op1 += FermionOperator(f"{pd}^ {qd}^ {rd} {sd}")
                    op1 -= hermitian_conjugated(op1)
                    op1 = normal_ordered(op1)
                    op2 = FermionOperator(f"{pu}^ {qd}^ {ru} {sd}")
                    op2 += FermionOperator(f"{pd}^ {qu}^ {rd} {su}")
                    op2 -= hermitian_conjugated(op2)
                    op2 = normal_ordered(op2)
                    if op1.many_body_order() > 0:
                        pool.append(op1)
                    if op2.many_body_order() > 0:
                        pool.append(op2)
    return pool


# -- momentum-space interaction pools (pool.py:133-340) -------------------------


def hubbard_interaction_pool(Nx: int, Ny: int, hermitian: bool = False):
    """ZS / ZS2 / BCS channel scattering operators over all (k1, k2, q, spin).

    Parity with ``hubbard_interaction_pool`` (pool.py:133-218), including the
    asymmetry that only the ZS channel is deduplicated in the anti-Hermitian
    branch.
    """
    t2i, i2t = _k_indexers(Nx, Ny)
    n_sites = Nx * Ny
    channels = {"ZS channel": [], "ZS2 channel": [], "BCS channel": []}
    zs_dedup = _SignDedup()

    for spin in (0, 1):
        for k1 in range(n_sites):
            for k2 in range(n_sites):
                for q in range(n_sites):
                    kx1, ky1 = i2t(k1)
                    kx2, ky2 = i2t(k2)
                    qx, qy = i2t(q)

                    # ZS: c†_{k1+q,s} c†_{k2-q,-s} c_{k2,-s} c_{k1,s}
                    idx = (
                        t2i(kx1 + qx, ky1 + qy, spin),
                        t2i(kx2 - qx, ky2 - qy, spin ^ 1),
                        t2i(kx2, ky2, spin ^ 1),
                        t2i(kx1, ky1, spin),
                    )
                    if hermitian:
                        channels["ZS channel"].append(_hermitian_pair(idx))
                    else:
                        op = normal_ordered(_antihermitian_pair(idx))
                        if zs_dedup.add(op):
                            channels["ZS channel"].append(op)

                    # ZS2: c†_{k1+q,s} c†_{k2-q,-s} c_{k2,s} c_{k1,-s}
                    idx = (
                        t2i(kx1 + qx, ky1 + qy, spin),
                        t2i(kx2 - qx, ky2 - qy, spin ^ 1),
                        t2i(kx2, ky2, spin),
                        t2i(kx1, ky1, spin ^ 1),
                    )
                    channels["ZS2 channel"].append(
                        _hermitian_pair(idx) if hermitian else _antihermitian_pair(idx)
                    )

                    # BCS: c†_{k1,s} c†_{-k1+q,-s} c_{-k2+q,-s} c_{k2,s}
                    idx = (
                        t2i(kx1, ky1, spin),
                        t2i(-kx1 + qx, -ky1 + qy, spin ^ 1),
                        t2i(-kx2 + qx, -ky2 + qy, spin ^ 1),
                        t2i(kx2, ky2, spin),
                    )
                    channels["BCS channel"].append(
                        _hermitian_pair(idx) if hermitian else _antihermitian_pair(idx)
                    )
    return channels


def _antihermitian_pair(idx) -> FermionOperator:
    i1, i2, i3, i4 = idx
    return FermionOperator(f"{i1}^ {i2}^ {i3} {i4}", 1j) - FermionOperator(
        f"{i3}^ {i4}^ {i1} {i2}", 1j
    )


def _hermitian_pair(idx) -> FermionOperator:
    i1, i2, i3, i4 = idx
    return FermionOperator(f"{i1}^ {i2}^ {i3} {i4}") + FermionOperator(
        f"{i3}^ {i4}^ {i1} {i2}"
    )


def hubbard_interaction_pool_simplified(Nx: int, Ny: int) -> List[FermionOperator]:
    """The pool ADAPT actually trains with (pool.py:220-255).

    Anti-Hermitian ZS-channel scattering i(c†c†cc − h.c.) over all
    (spin, k1, k2, q != 0), normal-ordered, deduplicated up to overall sign.
    """
    t2i, i2t = _k_indexers(Nx, Ny)
    n_sites = Nx * Ny
    dedup = _SignDedup()

    for spin in (0, 1):
        for k1 in range(n_sites):
            for k2 in range(n_sites):
                for q in range(1, n_sites):
                    kx1, ky1 = i2t(k1)
                    kx2, ky2 = i2t(k2)
                    qx, qy = i2t(q)
                    idx = (
                        t2i(kx1 + qx, ky1 + qy, spin),
                        t2i(kx2 - qx, ky2 - qy, spin ^ 1),
                        t2i(kx2, ky2, spin ^ 1),
                        t2i(kx1, ky1, spin),
                    )
                    dedup.add(normal_ordered(_antihermitian_pair(idx)))
    return dedup.ops


def hubbard_interaction_pool_modified(Nx: int, Ny: int):
    """Five-channel nearest-neighbor-q pool, each channel summed into one
    Hermitian operator (pool.py:257-340).

    Unlike the other builders this returns {channel: FermionOperator} where
    each value is the SUM of the channel's deduplicated monomials.
    """
    t2i, i2t = _k_indexers(Nx, Ny)
    n_sites = Nx * Ny
    channel_names = ["ZS channel", "ZS2 channel", "W channel", "BCS channel", "BCS2 channel"]
    dedups = {name: _SignDedup(up_to_sign=False) for name in channel_names}

    for spin in (0, 1):
        for k1 in range(n_sites):
            for k2 in range(n_sites):
                for qx, qy in [(1, 0), (0, 1), (-1, 0), (0, -1)]:
                    kx1, ky1 = i2t(k1)
                    kx2, ky2 = i2t(k2)
                    ns = spin ^ 1

                    cand = {
                        # ZS: c†_{k1+q,s} c†_{k2-q,-s} c_{k2,-s} c_{k1,s}
                        "ZS channel": (
                            t2i(kx1 + qx, ky1 + qy, spin),
                            t2i(kx2 - qx, ky2 - qy, ns),
                            t2i(kx2, ky2, ns),
                            t2i(kx1, ky1, spin),
                        ),
                        # ZS2: c†_{k1+q,s} c†_{k2-q,-s} c_{k1,-s} c_{k2,s}
                        "ZS2 channel": (
                            t2i(kx1 + qx, ky1 + qy, spin),
                            t2i(kx2 - qx, ky2 - qy, ns),
                            t2i(kx1, ky1, ns),
                            t2i(kx2, ky2, spin),
                        ),
                        # W: c†_{k1,s} c†_{k2,-s} c_{k2+Q+q,-s} c_{k1-Q-q,s}
                        "W channel": (
                            t2i(kx1, ky1, spin),
                            t2i(kx2, ky2, ns),
                            t2i(kx2 + Nx // 2 + qx, ky2 + Ny // 2 + qy, ns),
                            t2i(kx1 - Nx // 2 - qx, ky1 - Ny // 2 - qy, spin),
                        ),
                        # BCS: c†_{k1,s} c†_{-k1+q,-s} c_{-k2+q,-s} c_{k2,s}
                        "BCS channel": (
                            t2i(kx1, ky1, spin),
                            t2i(-kx1 + qx, -ky1 + qy, ns),
                            t2i(-kx2 + qx, -ky2 + qy, ns),
                            t2i(kx2, ky2, spin),
                        ),
                        # BCS2: c†_{k1,s} c†_{-k1+Q+q,-s} c_{-k2+Q+q,-s} c_{k2,s}
                        "BCS2 channel": (
                            t2i(kx1, ky1, spin),
                            t2i(-kx1 + Nx // 2 + qx, -ky1 + Ny // 2 + qy, ns),
                            t2i(-kx2 + Nx // 2 + qx, -ky2 + Ny // 2 + qy, ns),
                            t2i(kx2, ky2, spin),
                        ),
                    }
                    for name, (i1, i2, i3, i4) in cand.items():
                        op = normal_ordered(FermionOperator(f"{i1}^ {i2}^ {i3} {i4}"))
                        dedups[name].add(op)

    out = {}
    for name in channel_names:
        total = FermionOperator.zero()
        for op in dedups[name].ops:
            total += op
        out[name] = total
    return out


def hubbard_interaction_pool_same_spin(Nx: int, Ny: int) -> List[FermionOperator]:
    """ZS-channel scattering with BOTH fermions in the SAME spin sector.

    The reference's simplified pool (pool.py:220-255) only emits
    opposite-spin pairs ``(spin, spin^1)``; this builder is the missing
    same-spin complement ``i(c^_{k1+q,s} c^_{k2-q,s} c_{k2,s} c_{k1,s} -
    h.c.)``.  Motivation (flagship 3x3 diagnostic,
    ``benchmarks/demo_3x3/screen_extended.json``): at the 727-op
    simplified-pool saturation point the steepest simplified direction is
    |g| = 1.6e-3 while the steepest same-spin direction is 5.7e-3 -- and a
    full scan of ALL momentum/Sz-conserving two-body generators tops out at
    that same operator, i.e. this channel captures the best two-body
    descent direction the simplified pool cannot express.
    """
    t2i, i2t = _k_indexers(Nx, Ny)
    n_sites = Nx * Ny
    dedup = _SignDedup()
    for spin in (0, 1):
        for k1 in range(n_sites):
            for k2 in range(n_sites):
                for q in range(1, n_sites):
                    kx1, ky1 = i2t(k1)
                    kx2, ky2 = i2t(k2)
                    qx, qy = i2t(q)
                    idx = (
                        t2i(kx1 + qx, ky1 + qy, spin),
                        t2i(kx2 - qx, ky2 - qy, spin),
                        t2i(kx2, ky2, spin),
                        t2i(kx1, ky1, spin),
                    )
                    if len({idx[0], idx[1]}) < 2 or len({idx[2], idx[3]}) < 2:
                        continue  # c^2 = 0
                    op = normal_ordered(_antihermitian_pair(idx))
                    dedup.add(op)
    return [op for op in dedup.ops if op.terms]


def hubbard_interaction_pool_extended(Nx: int, Ny: int) -> List[FermionOperator]:
    """Simplified pool + same-spin complement, simplified ops FIRST.

    Order contract: the first ``len(hubbard_interaction_pool_simplified(...))``
    entries are exactly the simplified pool in its deterministic build
    order, so ADAPT checkpoints recorded against the simplified pool
    (``selected_indices`` are raw pool positions, io/checkpoint.py) resume
    unchanged under this pool and future epochs may select from both
    channels.
    """
    return (hubbard_interaction_pool_simplified(Nx, Ny)
            + hubbard_interaction_pool_same_spin(Nx, Ny))


def general_operator_pool(Nx: int, Ny: int) -> List[FermionOperator]:
    """All anti-Hermitian one- and two-body generalized excitations
    (pool.py:342-364, including its ``k1 != k2 != k3 != k4`` chained
    comparison, which only excludes adjacent-index collisions).
    """
    n_so = Nx * Ny * 2
    dedup = _SignDedup(up_to_sign=False)
    for k1 in range(n_so):
        for k2 in range(n_so):
            if k1 != k2:
                op = normal_ordered(
                    FermionOperator(f"{k1}^ {k2}", 1j) - FermionOperator(f"{k2}^ {k1}", 1j)
                )
                dedup.add(op)
            for k3 in range(n_so):
                for k4 in range(n_so):
                    if k1 != k2 and k2 != k3 and k3 != k4:
                        op = normal_ordered(
                            FermionOperator(f"{k1}^ {k2}^ {k3} {k4}", 1j)
                            - FermionOperator(f"{k3}^ {k4}^ {k1} {k2}", 1j)
                        )
                        dedup.add(op)
    return dedup.ops
