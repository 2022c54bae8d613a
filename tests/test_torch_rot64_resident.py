"""The float64 group engine's resident route, on the CPU.

``rot64_resident`` / ``adjoint64_resident`` walk a float64 group program
(``qsfh_torch.native.statevec.Rot64Program``) over tile runs in one
cooperative launch a pass, from the host layout ``streaming.Group64Runs``.
A CUDA kernel has no CPU mode, so these tests hold what surrounds it:

* (a) the layout of the committed 3x3 checkpoint (1931 groups): every
  group's flip mask inside its run's tile bits, the runs covering the
  groups in order, each group's GF(2) basis reproducing its phase masks,
  the table budget, and the run count at the shipped tile shape; runs
  that close on the staging budget, whose two stage buffers fit beside
  the tiles at 11 and 12 bits;
* (b) a torch emulation of the kernels' tile walk built from the layout
  alone (gather and scatter indices from the run masks, each group's
  pattern from its tile-coordinate basis and the tile's outer bits, its
  tables from the coefficient masks, the partner's pattern by ``pxor``;
  the adjoint's per-(group, tile) partials folded per parameter in the
  kernel's order) at n = 8 (2x2) and n = 12 (2x3) with tiles of 6 and 7
  bits, against ``rot64_groups_plain`` / ``adjoint64_groups_plain`` and
  the JAX package's native float64 engine within 1e-12;
* (c) the route: a group that fits no tile, or n < k, takes the per-group
  kernels; a layout fault raises in the plain version.
"""

import copy
import os

import numpy as np
import pytest
import torch

from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_tpu.native import statevec as jax_statevec
from qsfh_tpu.ops.pool import hubbard_interaction_pool_extended as jax_pool_extended
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.native.statevec import Rot64Program
from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-12
# the shipped shape's run count on the 3x3 checkpoint
CHECKPOINT_RUNS = {(11, 1): 521, (11, 2): 553, (12, 1): 424}

# lattice -> (driver arguments, extended pool?, ansatz indices, tile bits)
CASES = {
    "2x2": (dict(x_dimension=2, y_dimension=2, n_electrons=4, n_spin_up=2, n_spin_down=2,
                 tunneling=1, coulomb=6), False, [0, 3, 7, 11, 2, 5], 6),
    "2x3": (dict(x_dimension=2, y_dimension=3, n_electrons=6, n_spin_up=3, n_spin_down=3,
                 tunneling=1, coulomb=4, ground_truth=False), True,
            [0, 5, 10, 20, 40, 60, 80, 90, 100, 110], 7),
}


def _parity(a):
    a = np.asarray(a, np.int64)
    return np.array([bin(int(v)).count("1") & 1 for v in a.ravel()], np.int64).reshape(a.shape)


def _deposit(values, mask: int) -> np.ndarray:
    """The low bits of each value placed at the set bits of ``mask``."""
    values = np.asarray(values, np.int64)
    out = np.zeros_like(values)
    for j, p in enumerate(b for b in range(mask.bit_length()) if mask >> b & 1):
        out |= ((values >> j) & 1) << p
    return out


@pytest.fixture(scope="module")
def checkpoint():
    kw = dict(n_epoch=0, threshold1=1e-3, threshold2=1e-3, x_dimension=3, y_dimension=3,
              n_electrons=9, n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6,
              degenerate_subspace=4, load_model=True, plot=False, log_metrics=False,
              results_root=os.path.join(ROOT, "benchmarks", "demo_3x3"))
    vqe = ADAPT(pool=hubbard_interaction_pool_extended(3, 3), device="cpu",
                dtype=torch.complex128, **kw)
    return Rot64Program.from_adapt(vqe)


def test_checkpoint_layout(checkpoint):
    prog = checkpoint
    runs = prog.runs
    k, c = streaming.RESIDENT64_TILE_BITS, streaming.RESIDENT64_TILE_LOW_BITS
    assert prog.route == "resident" and (runs.n, runs.k, runs.c) == (18, k, c)
    assert len(runs) == CHECKPOINT_RUNS[(k, c)]
    runs.check("checkpoint")
    # the runs cover the groups in order, each run's tile is k bits with the low c
    assert runs.run_start[0] == 0 and runs.run_start[-1] == prog.G
    assert (np.diff(runs.run_start) >= 1).all()
    masks = runs.run_mask.astype(np.int64)
    assert all(bin(int(m)).count("1") == k for m in masks)
    assert ((masks & ((1 << c) - 1)) == (1 << c) - 1).all()
    assert (prog.gx & ~runs.group_mask() == 0).all()
    # tables within the budget, groups within the cap; 2^rank entries a group
    entries = np.diff(runs.toff[runs.run_start])
    assert entries.max() == runs.most_entries <= streaming.RESIDENT64_RUN_ENTRIES
    assert runs.most_groups <= streaming.RESIDENT64_RUN_GROUPS
    ranks = np.diff(runs.bstart)
    assert np.bincount(ranks).tolist() == [0, 65, 145, 0, 1719, 0, 0, 0, 2]
    assert runs.n_entries == int(np.maximum(2, 1 << ranks).sum()) == 28726
    # each group's basis reproduces its phase masks and the partner map
    for g in range(prog.G):
        zs = prog.zsub[prog.goff[g]:prog.goff[g + 1]].astype(np.int64)
        basis = runs.zb[runs.bstart[g]:runs.bstart[g + 1]].astype(np.int64)
        coef = runs.csub[prog.goff[g]:prog.goff[g + 1]].astype(np.int64)
        for z, cm in zip(zs, coef):
            rebuilt = 0
            for j, zb in enumerate(basis):
                if cm >> j & 1:
                    rebuilt ^= int(zb)
            assert rebuilt == z
        # parity(x & z_k) = parity(pxor & coef_k): all ones where the unit is i
        np.testing.assert_array_equal(_parity(prog.gx[g] & zs), _parity(runs.pxor[g] & coef))
        assert (_parity(prog.gx[g] & zs) == prog.gflip[g]).all()


def test_group_runs_close_on_budget_and_cap(checkpoint):
    prog = checkpoint
    runs = streaming.Group64Runs(prog.gx, prog.goff, prog.zsub, 18, 11, 1, max_entries=272,
                                 max_groups=3)
    runs.check("budget")
    entries = np.diff(runs.toff[runs.run_start])
    assert entries.max() == 272  # a 256-entry group and a 16-entry one
    assert np.diff(runs.run_start).max() <= 3
    assert len(runs) > len(prog.runs)
    # a group's tables alone past the budget: no layout
    assert streaming.order_group_runs(prog.gx, [300] * prog.G, 11, 1, 256, 64) is None
    with pytest.raises(ValueError, match="fits no"):
        streaming.Group64Runs(prog.gx, prog.goff, prog.zsub, 18, 11, 1, max_entries=64)


def test_checkpoint_stages_a_run_ahead(checkpoint):
    """The checkpoint keeps its 521 runs (568 table entries and 46 groups
    at most) under the staging budget: a launch stages 520 runs ahead, and
    both blocks hold two stage buffers within the shared memory a block
    may take."""
    runs = checkpoint.runs
    assert (len(runs), runs.most_entries, runs.most_groups) == (521, 568, 46)
    assert len(runs) - 1 == 520
    for adjoint in (False, True):
        assert streaming.resident64_smem(adjoint, runs.k, runs.most_entries,
                                         runs.most_groups) <= streaming.RESIDENT64_SMEM


@pytest.mark.parametrize("k", [11, 12])
def test_runs_close_on_the_staging_budget(k):
    """Groups of rank 8 (256 table entries each) on one flip mask fill a
    run's tables: at 11 bits the runs close on RESIDENT64_RUN_ENTRIES; at
    12, where two stage buffers of that many entries would not fit beside
    the adjoint's psi and lam tiles, on the fewer entries of
    resident64_run_entries, so that both blocks fit."""
    n, G = 14, 40
    gx = np.full(G, 0b110, np.int64)
    goff = np.arange(0, 8 * (G + 1), 8)
    rng = np.random.default_rng(k)
    zsub = (1 << (3 + np.tile(np.arange(8), G))) | (rng.integers(0, 8, 8 * G) << 11)
    runs = streaming.Group64Runs(gx, goff, zsub, n, k, 1)
    runs.check("budget")
    budget = streaming.resident64_run_entries(k)
    assert (np.diff(runs.bstart) == 8).all() and runs.n_entries == 256 * G
    assert runs.most_entries <= budget < runs.most_entries + 256  # the runs reach the budget
    assert len(runs) == -(-G // (budget // 256))
    for adjoint in (False, True):
        assert streaming.resident64_smem(adjoint, k, runs.most_entries,
                                         runs.most_groups) <= streaming.RESIDENT64_SMEM
    full = streaming.resident64_smem(True, k, streaming.RESIDENT64_RUN_ENTRIES,
                                     streaming.RESIDENT64_RUN_GROUPS)
    if k == 11:
        assert budget == streaming.RESIDENT64_RUN_ENTRIES and full <= streaming.RESIDENT64_SMEM
    else:
        assert budget < streaming.RESIDENT64_RUN_ENTRIES and full > streaming.RESIDENT64_SMEM


def test_group_basis_is_greedy_in_term_order():
    basis, coef = streaming.group_basis([0b0110, 0b0011, 0b0101, 0b0110, 0, 0b1000])
    assert basis == [0b0110, 0b0011, 0b1000]
    assert coef == [0b001, 0b010, 0b011, 0b001, 0b000, 0b100]


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    kw, extended, indices, k = CASES[request.param]
    kw = dict(kw, n_epoch=0, threshold1=1e-2, threshold2=1e-2, plot=False, log_metrics=False,
              results_root=str(tmp_path_factory.mktemp("res64")))
    nx, ny = kw["x_dimension"], kw["y_dimension"]
    vqe = ADAPT(pool=hubbard_interaction_pool_extended(nx, ny) if extended else None,
                device="cpu", dtype=torch.complex128, **kw)
    jax_vqe = JaxADAPT(pool=jax_pool_extended(nx, ny) if extended else None, **kw)
    prog = Rot64Program.from_adapt(vqe, indices, tile_bits=k, low_bits=1)
    th = np.random.default_rng(11).normal(0.0, 0.4, len(indices))
    return dict(name=request.param, prog=prog, vqe=vqe, jax_vqe=jax_vqe, indices=indices, th=th,
                psi0=vqe._initial_state().numpy())


def _tables(prog, runs, theta_ext):
    """The launch's table fill: per entry (cos, sin)(theta r) and r."""
    r = np.zeros(runs.n_entries)
    for e in range(runs.n_entries):
        g = int(runs.tgroup[e])
        q = e - int(runs.toff[g])
        for t in range(prog.goff[g], prog.goff[g + 1]):
            w = prog.wsub[t]
            r[e] += -w if bin(q & int(runs.csub[t])).count("1") & 1 else w
    ang = theta_ext[np.where(prog.gpidx < 0, prog.n_params, prog.gpidx)][runs.tgroup] * r
    return np.cos(ang), np.sin(ang), r


def _walk(prog, psi, lam, theta_ext, adjoint):
    """The kernels' tile walk on complex128 tensors, in place: per run its
    tiles gathered by the run's mask, the groups applied in (reverse)
    order, the tiles scattered back.  Returns the adjoint's partials
    (G, n_tiles), else None."""
    runs, n, k = prog.runs, prog.n, prog.runs.k
    n_tiles = 1 << (n - k)
    cs_c, cs_s, tab_r = (torch.as_tensor(a) for a in _tables(prog, runs, theta_ext))
    partials = torch.zeros((prog.G, n_tiles), dtype=torch.float64)
    slots = np.arange(1 << k)
    order = range(len(runs))
    for r in (reversed(order) if adjoint else order):
        mask = int(runs.run_mask[r])
        outer = _deposit(np.arange(n_tiles), ((1 << n) - 1) & ~mask)
        idx = torch.as_tensor(outer[:, None] | _deposit(slots, mask)[None, :])
        pt = psi[idx]
        lt = lam[idx] if adjoint else None
        g0, g1 = int(runs.run_start[r]), int(runs.run_start[r + 1])
        for g in (reversed(range(g0, g1)) if adjoint else range(g0, g1)):
            b0, b1 = runs.bstart[g], runs.bstart[g + 1]
            q = np.zeros((n_tiles, 1 << k), np.int64)
            for j in range(b1 - b0):  # outer bits' parity, then the tile's
                bit = _parity(outer & int(runs.zb[b0 + j]))[:, None] ^ _parity(
                    slots & int(runs.zbt[b0 + j]))[None, :]
                q |= bit << j
            # the same patterns from the flat index
            flat = idx.numpy()
            for j in range(b1 - b0):
                assert (((q >> j) & 1) == _parity(flat & int(runs.zb[b0 + j]))).all()
            e = torch.as_tensor(runs.toff[g] + q)
            c, s, rr = cs_c[e], cs_s[e], tab_r[e]
            xt = int(runs.xt[g])
            partner = torch.as_tensor(slots ^ xt)
            # the partner's pattern is q ^ pxor
            at_partner = np.take_along_axis(q, np.broadcast_to(slots ^ xt, q.shape), 1)
            assert (at_partner == q ^ int(runs.pxor[g])).all()
            sign = 1.0 if adjoint else -1.0  # the adjoint rotates back
            if xt == 0:
                rot = torch.complex(c, sign * s)
                if adjoint:
                    partials[g] = (rr * (lt.conj() * pt).imag).sum(dim=1)
                    lt = rot * lt
                pt = rot * pt
                continue
            pp = pt[:, partner]
            unit_i = bool(prog.gflip[g])
            if adjoint:
                lp = lt[:, partner]
                v = lt.conj() * pp
                partials[g] = (rr * (v.real if unit_i else v.imag)).sum(dim=1)
                mix = -s if unit_i else 1j * s
                pt, lt = c * pt + mix * pp, c * lt + mix * lp
            else:
                mix = s if unit_i else -1j * s
                pt = c * pt + mix * pp
        psi[idx] = pt
        if adjoint:
            lam[idx] = lt
    return partials if adjoint else None


def _fold(prog, partials):
    """grad[j]: parameter j's groups in ascending order, each group's tiles
    in tile order (the kernel's fold; float sums in that order)."""
    grad = np.zeros(prog.n_params)
    for j in range(prog.n_params):
        acc = 0.0
        for g in np.flatnonzero(prog.gpidx == j):
            acc += float(partials[g].sum())
        grad[j] = acc
    return grad


def test_tile_walk_forward(case):
    prog, th = case["prog"], case["th"]
    assert prog.route == "resident" and len(prog.runs) > 1 and prog.n - prog.runs.k >= 2
    theta_ext = np.concatenate([th, [1.0]])
    psi = torch.as_tensor(case["psi0"]).clone()
    _walk(prog, psi, None, theta_ext, adjoint=False)
    ref = K.rot64_groups_plain(torch.as_tensor(case["psi0"]).clone(), prog.groups,
                               torch.as_tensor(theta_ext))
    np.testing.assert_allclose(psi.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    jax_prog = jax_statevec.Rot64Program.from_adapt(case["jax_vqe"], case["indices"])
    np.testing.assert_allclose(psi.numpy(), jax_prog.apply(th, case["psi0"]), rtol=0, atol=ATOL)
    # the program's own route (the wrappers' plain versions on the CPU)
    np.testing.assert_allclose(prog.apply(th, case["psi0"]).numpy(), ref.numpy(), rtol=0,
                               atol=ATOL)


def test_tile_walk_adjoint(case):
    prog, th = case["prog"], case["th"]
    theta_ext = np.concatenate([th, [1.0]])
    psi = prog.apply(th, case["psi0"])
    lam = 2.0 * prog.h_apply(psi)
    p, l = psi.clone(), lam.clone()
    grad = _fold(prog, _walk(prog, p, l, theta_ext, adjoint=True))
    p_ref, l_ref = psi.clone(), lam.clone()
    g_ref = K.adjoint64_groups_plain(p_ref, l_ref, prog.groups, torch.as_tensor(theta_ext))
    np.testing.assert_allclose(grad, g_ref.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.numpy(), p_ref.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), l_ref.numpy(), rtol=0, atol=ATOL)
    jax_prog = jax_statevec.Rot64Program.from_adapt(case["jax_vqe"], case["indices"])
    _, g_jax = jax_prog.value_and_grad(th, case["psi0"])
    np.testing.assert_allclose(grad, g_jax, rtol=0, atol=ATOL)
    _, g = prog.value_and_grad(th, case["psi0"])
    np.testing.assert_allclose(g, g_jax, rtol=0, atol=ATOL)


def _one_group_program(x, n, k=None, c=None, route=None):
    seg = dict(xb=np.array([x], np.uint32), zb=np.array([0], np.uint32),
               scale=np.array([0.5]), pidx=np.array([0], np.int32), phre=np.array([1.0]),
               phim=np.array([0.0]))
    h = (np.array([0], np.uint32), np.array([1], np.uint32), np.array([1.0]), np.array([0.0]))
    return Rot64Program(n, seg, h, 1, device="cpu", route=route, tile_bits=k, low_bits=c)


def test_route_from_the_layout(case):
    # n < k: the per-group kernels for the whole program
    assert _one_group_program(1, 8).route == "groups" and _one_group_program(1, 8).runs is None
    # a group whose flip bits above c exceed k - c bits fits no tile
    assert _one_group_program(0b1111110, 8, k=6, c=1).route == "groups"
    assert _one_group_program(0b0111110, 8, k=6, c=1).route == "resident"
    with pytest.raises(ValueError, match="fits no"):
        _one_group_program(0b1111110, 8, k=6, c=1, route="resident")
    with pytest.raises(ValueError, match="route"):
        _one_group_program(1, 8, route="tiles")
    # the case programs: resident at small tiles; at the shipped shape per-group where n < k
    prog = case["prog"]
    shipped = Rot64Program.from_adapt(case["vqe"], case["indices"])
    assert shipped.route == ("groups" if prog.n < streaming.RESIDENT64_TILE_BITS else "resident")
    forced = Rot64Program.from_adapt(case["vqe"], case["indices"], route="groups",
                                     tile_bits=prog.runs.k, low_bits=1)
    assert forced.route == "groups" and forced.runs is None
    e, g = prog.value_and_grad(case["th"], case["psi0"])
    e2, g2 = forced.value_and_grad(case["th"], case["psi0"])
    assert abs(e - e2) < ATOL and np.abs(g - g2).max() < ATOL


def test_layout_fault_raises_in_the_plain_version(case):
    prog = case["prog"]
    faulty = copy.copy(prog.runs)
    g = int(np.flatnonzero(prog.gx)[0])
    r = int(np.searchsorted(prog.runs.run_start, g, side="right") - 1)
    mask = int(faulty.run_mask[r])
    bit = int(prog.gx[g]) & -int(prog.gx[g])
    spare = next(1 << b for b in range(prog.n) if not mask >> b & 1)
    faulty.run_mask = faulty.run_mask.copy()
    faulty.run_mask[r] = mask ^ bit ^ spare  # k bits still, one flip bit of group g missing
    faulty._place()
    th_ext = torch.as_tensor(np.concatenate([case["th"], [1.0]]))
    psi = torch.as_tensor(case["psi0"]).clone()
    with pytest.raises(ValueError, match="outside its run's tile"):
        K.rot64_resident(psi, prog.groups, th_ext, faulty)
    with pytest.raises(ValueError, match="outside its run's tile"):
        K.adjoint64_resident(psi, psi.clone(), prog.groups, th_ext, faulty)
