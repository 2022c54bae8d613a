"""Fused groups of the float32 tile kernels (``streaming.fused_groups``), on
the CPU.

* The groups: the tile layout's fused groups against
  ``streaming.group_terms``' groups (consecutive terms of one flip mask,
  one parameter and one parity of x & z, at most 8), both ways, on the
  flagship 3x3 checkpoint's train segment, the HVA 3x3 program (reps =
  10), a 3x3 Trotter step, an iQCC epoch (single strings: none fuse) and
  the 3x3 Givens network; a group of rank above 4 is cut into maximal
  consecutive pieces of rank 4, and the pieces of 3 terms or more fuse
  (a pair runs its terms alone).  The flagship's share of terms in
  closed form, pinned.
* Each fused group a register group of its own, every other term a plain
  code word; a layout without parameter indices fuses nothing.
* What a launch does, from its layout on the engine's route: the flagship's
  sweep one resident span of 609 runs each way, a 2x6 segment's tile runs
  one pass a run with every double excitation fused.
* An emulation: the tile kernels' walk written out in torch from the
  layout's tables alone, the fused groups as the kernels run them (the
  table of 2^R angles from the call's angles, each slot's pattern from
  the record's outer pattern, base and register columns, one entry a
  pair; the adjoint's products at the group's end state in each term's
  signed sum) and every other term alone, against the sequential
  per-term plain versions at complex128 within 1e-10: a mixed program
  (8-string odd-parity groups, 2-string even and odd groups, same-x
  groups of different parameters, a diagonal group of rank 6, a same-key
  stretch past the cap, single strings, a string that fits no tile
  between two spans) at 10 and 12 qubits.
"""

import os
import types

import numpy as np
import pytest
import torch
from fused_programs import mixed_segment

from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.algos.dynamics import TrotterEvolution
from qsfh_torch.algos.hva import hva_program_rot
from qsfh_torch.algos.iqcc import IQCC
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.compiled import CompiledCircuit, _tile_route
from qsfh_torch.engine.state import parity
from qsfh_torch.ops.dressing import dis_generators
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.lattice import fermi_hubbard
from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL64 = 1e-10
K_RES, C_RES = streaming.RESIDENT_TILE_BITS, streaming.RESIDENT_TILE_LOW_BITS


def _rank(zs) -> int:
    return len(streaming.group_basis(zs)[0])


# -- the groups on the main-path segments ----------------------------------------------------


_DRIVER = []


def _flagship_driver():
    """The committed 1719-operator 3x3 checkpoint, loaded on the CPU (once)."""
    if not _DRIVER:
        _DRIVER.append(ADAPT(
            pool=hubbard_interaction_pool_extended(3, 3), n_epoch=0, threshold1=1e-3,
            threshold2=1e-3, x_dimension=3, y_dimension=3, n_electrons=9, n_spin_up=5,
            n_spin_down=4, tunneling=1, coulomb=6, degenerate_subspace=4, load_model=True,
            plot=False, log_metrics=False, device="cpu",
            results_root=os.path.join(ROOT, "benchmarks", "demo_3x3")))
    return _DRIVER[0]


def _flagship():
    a = _flagship_driver()
    return CompiledCircuit(a._ansatz_ops(a.selected_indices) + a._net_ops, 18).segments[0]


def _hva():
    p = HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4)
    h, v = p.hva_generators()
    ops = hva_program_rot(10, [g.rotation_terms() for g in v], [g.rotation_terms() for g in h],
                          jordan_wigner(p.interacting_term).rotation_terms())
    return CompiledCircuit(ops, 18).segments[0]


def _trotter():
    return TrotterEvolution(HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4), dt=0.05, order=2,
                            device="cpu").segment


def _iqcc():
    h = jordan_wigner(fermi_hubbard(2, 2, 1.0, 4.0, periodic=True))
    selected = [(int(P.x[0]), int(P.z[0])) for _, P in dis_generators(h)]
    return IQCC.segment(types.SimpleNamespace(n_qubits=8), selected)


def _network():
    return CompiledCircuit(_flagship_driver()._net_ops, 18).segments[0]


# (segment, qubits, tile shape, whether any group fuses)
CASES = {
    "flagship": (_flagship, 18, (K_RES, C_RES), True),
    "hva3x3": (_hva, 18, (K_RES, C_RES), True),
    "trotter3x3": (_trotter, 18, (K_RES, C_RES), True),
    "iqcc2x2": (_iqcc, 8, (6, 2), False),
    "network3x3": (_network, 18, (K_RES, C_RES), True),
}


@pytest.fixture(scope="module")
def segments():
    return {}


def _segment(segments, name):
    if name not in segments:
        segments[name] = CASES[name][0]()
    return segments[name]


def _layout_groups(layout):
    """The layout's fused groups as term indices of its list."""
    return [(t0 + a, t0 + b) for tiles, t0, _ in layout.spans if tiles is not None
            for a, b in tiles.fused.tolist()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_groups_are_the_group_terms_groups(segments, name):
    seg = _segment(segments, name)
    _, n, (k, c), fuses = CASES[name]
    d = seg.data
    for direction in (1, -1):
        arr = [np.asarray(d[key][::direction]) for key in ("xb", "zb", "pidx", "phre", "phim")]
        xs, zs = arr[0].astype(np.int64), arr[1].astype(np.int64)
        goff = streaming.group_terms(xs, zs, np.ones(xs.size), *arr[2:])[3].tolist()
        layout = seg.tiles(direction, n, k, c)
        got = _layout_groups(layout)
        assert got == streaming.fused_groups(*arr)  # every group fits its tiles
        pieces = iter(got)
        piece = next(pieces, None)
        for g0, g1 in zip(goff[:-1], goff[1:]):
            a = g0  # maximal consecutive pieces of rank 4 (the whole group where its rank is)
            while a < g1:
                b = a + 1
                while b < g1 and _rank(zs[a:b + 1]) <= streaming.FUSED_MAX_RANK:
                    b += 1
                if b - a >= streaming.FUSED_MIN_TERMS:  # 3 terms or more
                    assert piece == (a, b)
                    piece = next(pieces, None)
                else:  # pairs and terms alone run per term
                    assert piece is None or piece[0] >= b
                a = b
        assert piece is None
        for a, b in got:  # one flip mask, one parameter, one parity, 3 to 8 terms, rank 4 at most
            assert 3 <= b - a <= streaming.FUSED_CAP
            assert _rank(zs[a:b]) <= streaming.FUSED_MAX_RANK
            assert len(set(xs[a:b].tolist())) == 1 and len(set(arr[2][a:b].tolist())) == 1
            assert len({bin(int(x) & int(z)).count("1") & 1 for x, z in zip(xs[a:b], zs[a:b])}) == 1
        assert (layout.fused_terms > 0) == fuses
        assert layout.fused_terms == sum(b - a for a, b in got)


def test_flagship_terms_in_closed_form(segments):
    seg = _segment(segments, "flagship")
    assert len(seg) == 14123
    for direction in (1, -1):
        layout = seg.tiles(direction, 18, K_RES, C_RES)
        fused = _layout_groups(layout)
        # 1719 double excitations of 8 strings and the Fourier network's two RZ layers of 8,
        # each cut into 2 pieces of rank 4; its 145 Givens pairs run per term
        assert (len(fused), layout.fused_terms) == (1723, 13768)
        assert layout.fused_terms / len(seg) >= 0.95
        # the runs of the layout without fused groups; a register group per fused group
        # (1794 register groups without them)
        assert (layout.n_runs, layout.n_single, layout.n_groups) == (
            609, 0, {1: 1799, -1: 1800}[direction])


@pytest.mark.parametrize("name", ["flagship", "hva3x3", "network3x3"])
def test_fused_groups_are_register_groups(segments, name):
    """Each fused group is a register group of its own (the kernels run it
    through shared memory); every other term keeps a plain code word; a
    layout built without parameter indices fuses nothing."""
    seg = _segment(segments, name)
    d = seg.data
    plain = streaming.TileLayout(d["xb"], d["zb"], 18, K_RES, C_RES)
    assert plain.fused_terms == 0
    for tiles, _, _ in plain.spans:
        assert tiles.frec.size == 0 and not (tiles.code >> 8).any()
    for direction in (1, -1):
        for tiles, _, _ in seg.tiles(direction, 18, K_RES, C_RES).spans:
            starts = tiles.group_start.tolist()
            alone = np.ones(tiles.n_terms, bool)
            flagged = []
            for a, b in tiles.fused.tolist():
                g = starts.index(a)
                assert starts[g + 1] == b
                flagged.append(g)
                alone[a:b] = False
                assert (int(tiles.code[a]) >> streaming.FUSED_SIZE_SHIFT & 7) == b - a - 1
            flags = np.flatnonzero(tiles.group_regs & streaming.FUSED_GROUP).tolist()
            assert flags == flagged  # exactly the fused groups' register words
            assert not (tiles.code[alone] >> 8).any()


# -- what a launch does, read from its layout --------------------------------------------------


@pytest.mark.parametrize("direction", [1, -1])
def test_flagship_sweep_is_one_resident_span(segments, direction):
    """The checkpoint's train segment on the engine's route at 18 qubits:
    one span of 609 runs, every term in a tile, so a sweep is one resident
    launch that stages 608 runs a run ahead (every run but the first)."""
    seg = _segment(segments, "flagship")
    layout, resident = _tile_route(seg, direction, 18)
    assert resident and layout.n_single == 0 and len(layout.spans) == 1
    tiles, t0, t1 = layout.spans[0]
    assert (len(tiles), layout.n_runs, layout.passes, t0, t1) == (609, 609, 609, 0, len(seg))


@pytest.fixture(scope="module")
def segment_2x6(tmp_path_factory):
    """(segment, operators): a 2x6 train segment of 60 seeded
    simplified-pool operators and the Givens network (host arrays only)."""
    a = ADAPT(n_epoch=0, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6,
              n_electrons=12, n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=2,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path_factory.mktemp("r")))
    idx = [int(i) for i in np.random.default_rng(23).choice(len(a.fermion_pool), 60,
                                                             replace=False)]
    return CompiledCircuit(a._ansatz_ops(idx) + a._net_ops, 24).segments[0], idx


@pytest.mark.parametrize("direction", [1, -1])
def test_2x6_tile_runs_one_pass_a_run(segment_2x6, direction):
    """The 2x6 segment on the engine's route at 24 qubits: tile runs and no
    term alone, so a call makes one launch and one pass over the state a
    run; each double excitation of the ansatz is a fused group of 8 strings."""
    seg, idx = segment_2x6
    layout, resident = _tile_route(seg, direction, 24)
    assert not resident and layout.n_single == 0
    assert layout.passes == layout.n_runs == sum(len(t) for t, _, _ in layout.spans)
    assert layout.fused_terms >= 8 * len(idx)


# -- the emulation ----------------------------------------------------------------------------


def _positions(mask):
    return [b for b in range(int(mask).bit_length()) if int(mask) >> b & 1]


def _deposit(v, positions):
    out = torch.zeros_like(v)
    for j, p in enumerate(positions):
        out |= ((v >> j) & 1) << p
    return out


_J = torch.arange(16)


def _fused_group(tiles, rec, t, states, outer, base, angles, phre, phim, adjoint):
    """One fused group as the kernels run it; returns the adjoint's per-term
    shares (with the string phase), None for a rotation."""
    code = int(tiles.code[t])
    head = int(rec[0])
    S, R, unit = ((code >> streaming.FUSED_SIZE_SHIFT) & 7) + 1, (head >> 12) & 7, head >> 15 & 1
    assert head & 255 == t - int(tiles.run_start[np.searchsorted(tiles.run_start, t, "right") - 1])
    assert S == (head >> 8 & 7) + 1
    # the table: phi_q = sum_m a_m w_m (1 - 2 parity(q & coef_m)), cos and dir sin
    w = phim if unit else phre
    coef = [(int(tiles.code[t + m]) >> streaming.FUSED_COEF_SHIFT) & 15 for m in range(S)]
    phi = torch.tensor([sum(float(angles[t + m]) * float(w[t + m])
                            * (1 - 2 * (bin(q & coef[m]).count("1") & 1)) for m in range(S))
                        for q in range(16)], dtype=torch.float64)
    sgn = -1.0 if adjoint else 1.0
    tab_c, tab_s = torch.cos(phi), sgn * torch.sin(phi)
    # each (block, thread, slot)'s pattern: the outer pattern, the base, the columns
    q = torch.zeros((outer.numel(), base.numel(), 16), dtype=torch.int64)
    cols = int(rec[1])
    for i in range(R):
        zreg = sum((cols >> (4 * jb + i) & 1) << jb for jb in range(4))
        bit = (parity(outer & int(rec[6 + i]))[:, None, None]
               ^ parity(base & int(rec[2 + i]))[None, :, None] ^ parity(_J & zreg)[None, None, :])
        q |= bit << i
    x = code & 15
    shares = None
    if adjoint:  # the products at the group's end state, each term's signed sum of them
        p, lam = states
        d = lam.conj() * p[..., _J ^ x]
        shares = []
        for m in range(S):
            cm = int(tiles.code[t + m])
            odd = (parity(outer & int(tiles.z_out[t + m]))[:, None, None]
                   ^ parity(base & int(tiles.z_tile[t + m]))[None, :, None]
                   ^ parity(_J & ((cm >> 4) & 15))[None, None, :])
            val = ((1.0 - 2.0 * odd.to(torch.float64)) * d).sum()
            shares.append(complex(phre[t + m], phim[t + m]) * val)
    pivot = 8 if x & 8 else 4 if x & 4 else 2 if x & 2 else 1
    out = []
    for s in states:
        s = s.clone()
        for j in range(16):
            c, sn = tab_c[q[..., j]], tab_s[q[..., j]]
            if x == 0:
                s[..., j] = (c - 1j * sn) * s[..., j]
            elif j & pivot == 0:
                k = j ^ x
                a, b = s[..., j].clone(), s[..., k].clone()
                if unit == 0:
                    s[..., j], s[..., k] = c * a - 1j * sn * b, c * b - 1j * sn * a
                else:
                    s[..., j], s[..., k] = c * a + sn * b, c * b - sn * a
        out.append(s)
    states[:] = out
    return shares


def _emulate(tiles, n, psi, lam, angles, phre, phim, adjoint):
    """The tile kernels on (psi, lam), from the layout's tables: per run,
    every block's tile; per register group, each fused group at once and
    every other term alone.  Returns the adjoint's per-term <lam | P psi>
    (empty for a rotation)."""
    k, c = tiles.k, tiles.c
    v = torch.zeros(tiles.n_terms, dtype=psi.dtype)
    blocks = torch.arange(1 << (n - k))
    slots = torch.arange(1 << k)
    fused = 0
    for r in range(len(tiles)):
        mask = int(tiles.run_mask[r])
        outer = _deposit(blocks, _positions(((1 << n) - 1) & ~mask))
        hi = _positions(mask & ~((1 << c) - 1))
        addr = outer[:, None] | (_deposit(slots >> c, hi) | (slots & ((1 << c) - 1)))[None, :]
        full = [psi[addr]] + ([lam[addr]] if adjoint else [])
        recs = tiles.frec[tiles.run_fgroup[r]:tiles.run_fgroup[r + 1]]
        for g in range(tiles.run_group[r], tiles.run_group[r + 1]):
            regs = [(int(tiles.group_regs[g]) >> (4 * b)) & 15 for b in range(4)]
            base = torch.arange(1 << (k - 4))
            for p in regs:  # ascending: insert a zero bit at each
                base = ((base >> p) << (p + 1)) | (base & ((1 << p) - 1))
            slot = base[:, None] | _deposit(_J, regs)[None, :]
            states = [s[:, slot] for s in full]  # (blocks, threads, 16)
            t = int(tiles.group_start[g])
            if int(tiles.group_regs[g]) & streaming.FUSED_GROUP:  # the group at once
                code = int(tiles.code[t])
                rec = recs[code >> streaming.FUSED_INDEX_SHIFT]
                shares = _fused_group(tiles, rec, t, states, outer, base, angles, phre, phim,
                                      adjoint)
                S = ((code >> streaming.FUSED_SIZE_SHIFT) & 7) + 1
                assert t + S == tiles.group_start[g + 1]
                if adjoint:
                    v[t:t + S] = torch.tensor(shares)
                fused += S
                t += S
            while t < tiles.group_start[g + 1]:
                code = int(tiles.code[t])
                assert code >> 8 == 0
                x_reg, z_reg = code & 15, (code >> 4) & 15
                odd = (parity(outer & int(tiles.z_out[t]))[:, None, None]
                       ^ parity(base & int(tiles.z_tile[t]))[None, :, None]
                       ^ parity(_J & z_reg)[None, None, :])
                sign = 1.0 - 2.0 * odd.to(torch.float64)
                ph = complex(phre[t], phim[t])
                cs, sn = np.cos(float(angles[t])), np.sin(float(angles[t]))
                moved = [ph * sign * s[:, :, _J ^ x_reg] for s in states]
                if adjoint:
                    v[t] = (states[1].conj() * moved[0]).sum()
                    states = [cs * s + 1j * sn * m for s, m in zip(states, moved)]
                else:
                    states = [cs * states[0] - 1j * sn * moved[0]]
                t += 1
            for s, rv in zip(full, states):
                s[:, slot] = rv
        psi[addr] = full[0]
        if adjoint:
            lam[addr] = full[1]
    assert fused == tiles.fused_terms
    return v


def _state(rng, n):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return torch.as_tensor(v / np.linalg.norm(v))


@pytest.mark.parametrize("n,k,c", [(10, 7, 2), (12, 8, 3)])
def test_fused_emulation_matches_the_per_term_plain_versions(n, k, c):
    rng = np.random.default_rng(100 + n)
    seg, _ = mixed_segment(rng, n, wide=True)
    d = seg.data
    T = len(seg)
    # arbitrary per-term angles: the closed form holds for any angles of commuting terms
    angles = rng.uniform(-1.5, 1.5, size=T)
    for direction in (1, -1):
        layout = seg.tiles(direction, n, k, c)
        assert layout.n_single == 1 and len(layout.spans) == 3 and layout.n_runs > 1
        groups = _layout_groups(layout)
        sizes = sorted({b - a for a, b in groups})
        assert {3, 8} <= set(sizes) and layout.fused_terms < T
        xs = d["xb"][::direction].astype(np.int64)
        assert any(xs[a] == 0 for a, _ in groups)  # the diagonal pieces
        assert any(bin(int(xs[a]) & int(d["zb"][::direction][a])).count("1") & 1
                   for a, _ in groups)  # odd parity
        args = [torch.as_tensor(np.ascontiguousarray(a)) for a in
                (xs, d["zb"][::direction].astype(np.int64), angles[::direction],
                 d["phre"][::direction], d["phim"][::direction])]
        psi, lam = _state(rng, n), _state(rng, n)
        ref = K.pauli_rotation_plain(psi.clone(), *args)
        rp, rl = psi.clone(), lam.clone()
        rv = K.adjoint_rotation_plain(rp, rl, *args)
        got, gp, gl = psi.clone(), psi.clone(), lam.clone()
        gv = []
        for tiles, t0, t1 in layout.spans:
            part = [a[t0:t1] for a in args]
            if tiles is None:  # the term that fits no tile
                K.pauli_rotation_plain(got, *part)
                gv.append(K.adjoint_rotation_plain(gp, gl, *part))
                continue
            K.rotation_resident_plain(psi.clone(), *part, tiles)  # the layout check
            _emulate(tiles, n, got, None, *part[2:], adjoint=False)
            gv.append(_emulate(tiles, n, gp, gl, *part[2:], adjoint=True))
        gv = torch.cat(gv)
        assert (got - ref).norm() <= TOL64 * ref.norm()
        assert (gp - rp).norm() <= TOL64 and (gl - rl).norm() <= TOL64 * rl.norm()
        assert (gv - rv).abs().max() <= TOL64 * rv.abs().max()
