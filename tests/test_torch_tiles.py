"""Tile runs and the last two TPU kernels, on the CPU.

* ``xor_gather`` and ``pauli_rotation_one`` (their plain versions, which
  the wrappers take for CPU tensors) against ``xor_gather_pallas`` and
  ``pauli_rotation_pallas`` in interpret mode, at n = 10 and 12, complex64,
  within 1e-5 relative (float32 rounding; the gather is exact).
* The tile layout of the 2x6 rot segment: every term in exactly one run,
  in order; each tile the low c bits and k - c others; the state passes
  per call that PERF.md records.
* A tile emulation: the tile-run kernels' indexing written out in torch
  from the layout's tables alone (run masks, register groups, compressed
  masks, z_tile, z_out), against the sequential plain versions at
  complex128 within 1e-10, with small tiles (k = 6, c = 2) so that the bit
  sets vary from run to run.  It is the only check of the host mask
  translation on a machine without a card; nothing on the main path
  uses it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.engine.pallas_kernels import HAVE_PALLAS, pauli_rotation_pallas, xor_gather_pallas
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.compiled import CompiledCircuit
from qsfh_torch.engine.state import index_bits, parity

pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")

RTOL32 = 1e-5
TOL64 = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _state(rng, n, dtype=np.complex128):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v)).astype(dtype)


# -- kernels 11 and 12 against the JAX functions ----------------------------------------


def _masks(n):
    """0, low, high and mixed flat masks."""
    return [0, 0b101, 1 << (n - 1), (1 << (n - 1)) | (1 << (n - 3)) | 0b11, (1 << n) - 1]


@pallas
@pytest.mark.parametrize("n", [10, 12])
def test_xor_gather_vs_xor_gather_pallas(n):
    psi = _state(np.random.default_rng(n), n, np.complex64)
    for x in _masks(n):
        ref = np.asarray(xor_gather_pallas(jnp.asarray(psi), n, jnp.uint32(x)))
        got = K.xor_gather(torch.as_tensor(psi), x)
        got_t = K.xor_gather(torch.as_tensor(psi), torch.tensor([x]))
        assert got.dtype == torch.complex64
        assert _rel(got.numpy(), ref) <= RTOL32
        assert torch.equal(got, got_t)


@pallas
@pytest.mark.parametrize("n", [10, 12])
def test_pauli_rotation_one_vs_pauli_rotation_pallas(n):
    rng = np.random.default_rng(20 + n)
    psi = _state(rng, n, np.complex64)
    zs = [0, 0b110, 1 << (n - 2), (1 << (n - 1)) | 1, (1 << n) - 1]
    for x, z in zip(_masks(n), zs):  # x = 0 first: a diagonal term
        theta = float(rng.uniform(-1.5, 1.5))
        ph = (-1j) ** (bin(x & z).count("1") % 4)
        ref = np.asarray(pauli_rotation_pallas(jnp.asarray(psi), n, jnp.uint32(x), jnp.uint32(z),
                                               theta, ph.real, ph.imag))
        tpsi = torch.as_tensor(psi)
        got = K.pauli_rotation_one(tpsi, x, z, theta, ph.real, ph.imag)
        assert torch.equal(tpsi, torch.as_tensor(psi))  # out of place
        assert got.dtype == torch.complex64
        assert _rel(got.numpy(), ref) <= RTOL32


def test_xor_gather_plain_matches_index_gather():
    """The wrappers' CPU route at complex128 (the card rejects it, as the
    JAX function does)."""
    psi = torch.as_tensor(_state(np.random.default_rng(3), 8))
    for x in _masks(8):
        assert torch.equal(K.xor_gather(psi, x), psi[index_bits(8) ^ x])


# -- the tile layout at 2x6 ---------------------------------------------------------------


@pytest.fixture(scope="module")
def segment_2x6(tmp_path_factory):
    a = ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6,
              n_electrons=12, n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=6,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path_factory.mktemp("t26")))
    n = a.n_qubits
    seg = CompiledCircuit(a._ansatz_ops(range(6)) + a._net_ops, n).segments[0]
    net = CompiledCircuit(a._net_ops, n).segments[0]
    return n, seg, net


# (direction, k, c) -> (runs, terms that fit no tile, register groups); the
# shipped setting (TILE_BITS = 12, TILE_LOW_BITS = 4) and the neighbours
# PERF.md weighs it against.  Each of the 6 double excitations (72 terms in
# closed form: streaming.fused_groups) is a register group of its own: 6
# more than the greedy grouping alone gives (146, 145, 158, 158, 140, 140,
# 139, 139).
COUNTS_2X6 = {
    (1, 12, 4): (46, 0, 152),
    (-1, 12, 4): (46, 0, 151),
    (1, 12, 5): (52, 0, 164),
    (-1, 12, 5): (52, 0, 164),
    (1, 13, 4): (41, 0, 146),
    (1, 13, 5): (41, 0, 146),
    (-1, 13, 5): (41, 0, 145),
    (1, 14, 5): (36, 0, 145),
}


@pytest.mark.parametrize("key", sorted(COUNTS_2X6), ids=str)
def test_tile_layout_counts_2x6(segment_2x6, key):
    n, seg, _ = segment_2x6
    direction, k, c = key
    layout = seg.tiles(direction, n, k, c)
    assert (layout.n_runs, layout.n_single, layout.n_groups) == COUNTS_2X6[key]
    assert layout.passes <= 60


def test_tile_layout_covers_the_terms_in_order(segment_2x6):
    n, seg, net = segment_2x6
    k, c = streaming.TILE_BITS, streaming.TILE_LOW_BITS
    for s, direction in ((seg, 1), (seg, -1), (net, 1), (net, -1)):
        xs = s.data["xb"].astype(np.int64)[::direction]
        layout = s.tiles(direction, n, k, c)
        assert [t for _, t0, t1 in layout.spans for t in range(t0, t1)] == list(range(len(xs)))
        for tiles, t0, t1 in layout.spans:
            assert tiles is not None  # every 2x6 term fits a tile
            assert list(tiles.run_start) == sorted(set(tiles.run_start))
            for r in range(len(tiles)):
                mask = int(tiles.run_mask[r])
                assert mask & ((1 << c) - 1) == (1 << c) - 1
                assert bin(mask).count("1") == k and mask < 1 << n
                run = xs[t0 + tiles.run_start[r]:t0 + tiles.run_start[r + 1]]
                assert not (run & ~mask).any()
                assert tiles.run_start[r + 1] - tiles.run_start[r] <= streaming.MAX_RUN_TERMS


def test_terms_that_fit_no_tile_become_single_spans():
    # k - c = 3 bits above the low two: four flips above them fit no tile,
    # nor do five flips anywhere (a register group holds four)
    xs = np.asarray([0b11, 0b1111_0000, 1 << 9, 0b1111 << 6, 0b110, 0b11111], np.int64)
    layout = streaming.TileLayout(xs, np.zeros(6, np.int64), 10, k=5, c=2)
    assert [(tiles is None, t0, t1) for tiles, t0, t1 in layout.spans] == [
        (False, 0, 1), (True, 1, 2), (False, 2, 3), (True, 3, 4), (False, 4, 5), (True, 5, 6)]
    assert (layout.n_runs, layout.n_single, layout.passes) == (3, 3, 6)


# -- the tile emulation ----------------------------------------------------------------------


def _positions(mask):
    return [b for b in range(int(mask).bit_length()) if int(mask) >> b & 1]


def _deposit(v, positions):
    out = torch.zeros_like(v)
    for j, p in enumerate(positions):
        out |= ((v >> j) & 1) << p
    return out


def _emulate(tiles, n, psi, lam, angles, phre, phim, adjoint):
    """The tile-run kernels on (psi, lam), from the layout's tables: per
    run, gather every block's tile row by row, run the register groups
    (16 slots per thread, partner j ^ x_reg, sign parity(j & z_reg) ^
    parity(base & z_tile) ^ parity(outer & z_out)), scatter back.  Returns
    the adjoint's per-term <lam | P psi> (empty for a rotation)."""
    k, c = tiles.k, tiles.c
    j = torch.arange(16)
    v = torch.zeros(tiles.n_terms, dtype=psi.dtype)
    blocks = torch.arange(1 << (n - k))
    slots = torch.arange(1 << k)
    for r in range(len(tiles)):
        mask = int(tiles.run_mask[r])
        outer = _deposit(blocks, _positions(((1 << n) - 1) & ~mask))
        hi = _positions(mask & ~((1 << c) - 1))
        addr = outer[:, None] | (_deposit(slots >> c, hi) | (slots & ((1 << c) - 1)))[None, :]
        states = [psi[addr]] + ([lam[addr]] if adjoint else [])
        for g in range(tiles.run_group[r], tiles.run_group[r + 1]):
            regs = [(int(tiles.group_regs[g]) >> (4 * b)) & 15 for b in range(4)]
            base = torch.arange(1 << (k - 4))
            for p in regs:  # ascending: insert a zero bit at each
                base = ((base >> p) << (p + 1)) | (base & ((1 << p) - 1))
            off = _deposit(j, regs)
            slot = base[:, None] | off[None, :]  # (threads, 16)
            regs_v = [s[:, slot] for s in states]  # (blocks, threads, 16)
            for t in range(tiles.group_start[g], tiles.group_start[g + 1]):
                code = int(tiles.code[t])
                x_reg, z_reg = code & 15, (code >> 4) & 15
                odd = (parity(outer & int(tiles.z_out[t]))[:, None, None]
                       ^ parity(base & int(tiles.z_tile[t]))[None, :, None]
                       ^ parity(j & z_reg)[None, None, :])
                sign = 1.0 - 2.0 * odd.to(torch.float64)
                ph = complex(phre[t], phim[t])
                cs, sn = np.cos(float(angles[t])), np.sin(float(angles[t]))
                moved = [ph * sign * s[:, :, j ^ x_reg] for s in regs_v]
                if adjoint:
                    v[t] = (regs_v[1].conj() * moved[0]).sum()
                    regs_v = [cs * s + 1j * sn * m for s, m in zip(regs_v, moved)]
                else:
                    regs_v = [cs * regs_v[0] - 1j * sn * moved[0]]
            for s, rv in zip(states, regs_v):
                s[:, slot] = rv
        psi[addr] = states[0]
        if adjoint:
            lam[addr] = states[1]
    return v


def _random_program(rng, n, T):
    """Terms whose flip masks have 0-4 bits anywhere (the Hubbard shapes)."""
    xs = np.zeros(T, np.int64)
    for t in range(T):
        bits = rng.choice(n, size=rng.choice([0, 1, 2, 2, 4]), replace=False)
        xs[t] = sum(1 << int(b) for b in bits)
    zs = rng.integers(0, 1 << n, size=T)
    ph = np.array([(-1j) ** (bin(int(x) & int(z)).count("1") % 4) for x, z in zip(xs, zs)])
    return xs, zs, rng.uniform(-1.5, 1.5, size=T), ph


def _check_emulation(xs, zs, angles, ph, n, k, c, rng):
    layout = streaming.TileLayout(xs, zs, n, k, c)
    assert layout.n_single == 0 and layout.n_runs > 1
    masks = {int(m) for tiles, _, _ in layout.spans for m in tiles.run_mask}
    assert len(masks) > 1  # the bit sets vary from run to run
    args = [torch.as_tensor(np.ascontiguousarray(a)) for a in (xs, zs, angles, ph.real, ph.imag)]
    psi, lam = (torch.as_tensor(_state(rng, n)) for _ in range(2))
    ref = K.pauli_rotation_plain(psi.clone(), *args)
    rp, rl = psi.clone(), lam.clone()
    rv = K.adjoint_rotation_plain(rp, rl, *args)
    got, gp, gl = psi.clone(), psi.clone(), lam.clone()
    gv = []
    for tiles, t0, t1 in layout.spans:
        part = [a[t0:t1] for a in args]
        _emulate(tiles, n, got, None, *part[2:], adjoint=False)
        gv.append(_emulate(tiles, n, gp, gl, *part[2:], adjoint=True))
    assert _rel(got.numpy(), ref.numpy()) <= TOL64
    assert _rel(gp.numpy(), rp.numpy()) <= TOL64
    assert _rel(gl.numpy(), rl.numpy()) <= TOL64
    assert _rel(torch.cat(gv).numpy(), rv.numpy()) <= TOL64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_emulation_random_programs(seed):
    rng = np.random.default_rng(40 + seed)
    n = 12
    xs, zs, angles, ph = _random_program(rng, n, 40)
    _check_emulation(xs, zs, angles, ph, n, k=6, c=2, rng=rng)


@pytest.mark.parametrize("direction", [1, -1])
def test_tile_emulation_adapt_2x3_segment(direction, tmp_path):
    """The 2x3 ADAPT rot segment (first 6 pool operators and the Givens
    network, 12 qubits), forward and reversed as the engine walks it."""
    a = ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=3,
              n_electrons=6, n_spin_up=3, n_spin_down=3, tunneling=1, coulomb=6,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path))
    seg = CompiledCircuit(a._ansatz_ops(range(6)) + a._net_ops, a.n_qubits).segments[0]
    d = seg.data
    rng = np.random.default_rng(7)
    thetas = np.append(rng.uniform(-1, 1, size=6), 1.0)
    angles = thetas[d["pidx"]] * d["scale"]
    step = slice(None, None, direction)
    ph = (d["phre"] + 1j * d["phim"])[step]
    _check_emulation(d["xb"].astype(np.int64)[step], d["zb"].astype(np.int64)[step],
                     angles[step], ph, a.n_qubits, k=6, c=2, rng=rng)
