"""The engine's inner products over the inner-product tiles, on the CPU.

* An emulation: the inner-product tile kernel's indexing written out in
  torch from the layout's tables alone (``streaming.GroupTiles`` with
  ``inner_diagonal``): the launch plan (chunks of units, partial rows),
  each unit's slice of a tile's items on the swizzled tile (lanes, chunks,
  buckets, signs, the terms' 16-bucket sums), the diagonal unit's
  Walsh-Hadamard transform of conj(a) psi per tile position in the
  kernel's stage order with the signs of the phase bits off the tile, the
  partials of each (row, position slice), and the fold (v in input order,
  sum_t Re(c_t v_t), 2 Im(c_t v_t)).  It is held against
  ``pauli_inner_plain`` at complex128 within 1e-10: random term lists
  with x = 0 terms whose phase masks have bits off every tile and masks
  that fit no tile (seeds 0-2), and the 2x3 pool, H, Sz and S^2 at tile
  shapes 12/2 and 9/2.  It is the only check of the host tables on a
  machine without a card.
* The schedule: units cover every item once, slices of at least
  ``INNER_SLICE_ITEMS`` items unless the tile has fewer, the diagonal on
  the last tile; the 3x3 counts pinned at the shipped shape (the layout
  of the application and the inner products' own).
* ``Observable.expectation_scan`` and ``PackedPool.screen_scan`` on the new
  route against ``expectation_chain_pallas`` / ``screen_chain_pallas`` in
  interpret mode at n = 10 and 11 (relative 1e-5, float32 rounding) and
  against the JAX XLA scan at complex128 (1e-10).
* ``pauli_rotation_one`` (the out-of-place rotation) against
  ``pauli_rotation_pallas`` in interpret mode with x = 0 and one-element
  tensor scalars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.engine.expectation import PackedPool as JaxPool
from qsfh_tpu.engine.pallas_kernels import (
    HAVE_PALLAS,
    expectation_chain_pallas,
    pauli_rotation_pallas,
    screen_chain_pallas,
)
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.expectation import Observable, PackedPool
from qsfh_torch.engine.state import parity
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pauli import PauliSum
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

TOL64 = 1e-10
RTOL32 = 1e-5
SMS = 132  # an H100's SMs: the schedule the card takes
ARGS_2X3 = (2, 3, 1.0, 6.0, 6, 3, 3)
ARGS_3X3 = (3, 3, 1.0, 6.0, 9, 5, 4)

pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _state(rng, n, dtype=np.complex128):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v)).astype(dtype)


def _positions(mask):
    return [b for b in range(int(mask).bit_length()) if int(mask) >> b & 1]


def _deposit(v, positions):
    out = torch.zeros_like(v)
    for j, p in enumerate(positions):
        out |= ((v >> j) & 1) << p
    return out


def _xor_span(values, cols):
    out = torch.zeros_like(values)
    for b, col in enumerate(cols):
        out ^= ((values >> b) & 1) * int(col)
    return out


def _random_terms(rng, n, T, wide=0):
    """Terms on a few flip masks of 0-4 bits anywhere (the Hubbard shapes),
    a quarter of them x = 0 with phase masks on every bit (so on bits off
    any tile), ``wide`` on a mask of n - 2 bits (it fits no tile), and
    complex coefficients."""
    masks = []
    for _ in range(max(1, T // 4)):
        bits = rng.choice(n, size=rng.choice([1, 2, 2, 4, 4]), replace=False)
        masks.append(sum(1 << int(b) for b in bits))
    xs = rng.choice(np.asarray(masks, np.int64), size=T)
    xs[::4] = 0
    for t in rng.choice(np.arange(1, T, 4), size=wide, replace=False):
        xs[t] = ((1 << n) - 1) ^ 0b101
    c = rng.standard_normal(T) + 1j * rng.standard_normal(T)
    return xs, rng.integers(0, 1 << n, size=T), c


def _wht_kernel_order(u, k):
    """U[m] = sum_t (-1)^popc(t & m) u[t] over the last axis, the stages in
    the kernel's order: the register bits (tile bits 8 to k - 1), the lane
    bits (0-4), the warp bits (5-7); a butterfly keeps lo + up at the
    clear bit and lo - up at the set one."""
    lead = u.shape[:-1]
    for b in list(range(8, k)) + list(range(5)) + list(range(5, 8)):
        v = u.reshape(*lead, -1, 2, 1 << b)
        lo, up = v[..., 0, :], v[..., 1, :]
        u = torch.stack([lo + up, lo - up], -2).reshape(*lead, 1 << k)
    return u


def _emulate(tiles, n, a, psi, cap=K.PARTIALS_CAP):
    """The kernel on (a, psi) from the layout's tables, launch by launch of
    ``tiles.plan``: per unit and position slice, the unit's items on the
    a and psi tiles at their swizzled slots (lane l, chunk ch and bucket j
    read slot lane_off(l) ^ chunk_off(ch) ^ jo(j), psi at slot j ^ item_x
    of the same 16, with the sign parity((l | ch << 5) & zlc) ^
    parity(outer & zout)) summed into 16 buckets over the slice's
    positions, a term the signed sum of its item's buckets; or the
    diagonal: conj(a) psi on the tile, transformed (the kernel's stages),
    U[zin] signed by parity(outer & zout) and summed over the slice.  Each
    (row, slice) partial is written once; v[order[row]] is the row's sum.
    The terms of masks that fit no tile (the per-term kernel) stay NaN."""
    k = tiles.k
    t = torch.arange(1 << k)
    slot = t.clone()
    for b in range(4, k):
        slot ^= ((t >> b) & 1) * streaming.INNER_SWIZZLE[b - 4]
    lane, ch, j = torch.arange(32), torch.arange(1 << (k - 9)), torch.arange(16)
    had = 1.0 - 2.0 * parity(j[:, None] & j[None, :]).to(torch.float64)
    positions, width, rows, plan = tiles.plan(n, SMS, cap)
    units = tiles.schedule(n, SMS)[1]
    every = 1 << (n - k)
    diag_row = int(tiles.item_start[-1])
    v = torch.full((tiles.n_terms,), float("nan"), dtype=psi.dtype)
    written = set()
    for u0, n_units, t0, n_rows, most in plan:
        partials = torch.full((n_rows, width), float("nan"), dtype=psi.dtype)
        assert n_rows <= rows and most == max(int(units[u, 2]) for u in range(u0, u0 + n_units))
        for u in range(u0, u0 + n_units):
            r, i0, n_items, diag = (int(q) for q in units[u])
            mask = int(tiles.tile_mask[r])
            rest = _positions(((1 << n) - 1) & ~mask)
            for s in range(width):
                outer = _deposit(torch.arange(s * positions, min((s + 1) * positions, every)), rest)
                flat = outer[:, None] | _deposit(t, _positions(mask))[None, :]
                if diag:
                    U = _wht_kernel_order(a[flat].conj() * psi[flat], k)
                    for e in range(tiles.n_diag):
                        sign = 1.0 - 2.0 * parity(outer & int(tiles.idiag_zout[e])).to(torch.float64)
                        partials[diag_row + e - t0, s] = (sign * U[:, int(tiles.idiag_zin[e])]).sum()
                        written.add((diag_row + e, s))
                    continue
                sa, sp = (torch.zeros((outer.numel(), 1 << k), dtype=psi.dtype) for _ in range(2))
                sa[:, slot], sp[:, slot] = a[flat], psi[flat]
                for it in range(i0, i0 + n_items):
                    cols = tiles.item_cols[it]
                    base = _xor_span(lane, cols[:5])[:, None] ^ _xor_span(ch, cols[9:k])[None, :]
                    addr = base[:, :, None] ^ _xor_span(j, cols[5:9])[None, None, :]
                    partner = addr[:, :, j ^ int(tiles.item_x[it])]
                    l9 = lane[:, None] | (ch[None, :] << 5)
                    odd = (parity(l9 & int(tiles.item_zlc[it]))[None]
                           ^ parity(outer & int(tiles.item_zout[it]))[:, None, None])
                    sign = 1.0 - 2.0 * odd.to(torch.float64)
                    B = (sign[..., None] * sa[:, addr].conj() * sp[:, partner]).sum((0, 1, 2))
                    t_lo, t_hi = int(tiles.item_start[it]), int(tiles.item_start[it + 1])
                    d = torch.as_tensor(tiles.term_d[t_lo:t_hi].astype(np.int64))
                    partials[t_lo - t0:t_hi - t0, s] = had.to(psi.dtype)[d] @ B
                    written.update((row, s) for row in range(t_lo, t_hi))
        assert not partials.isnan().any()  # every (row, slice) of the launch written
        v[torch.as_tensor(tiles.order[t0:t0 + n_rows])] = partials.sum(1)
    assert len(written) == len(tiles.order) * width  # each (row, slice) once
    return v


def _check_schedule(tiles, n):
    positions, units = tiles.schedule(n, SMS)
    every = 1 << (n - tiles.k)
    items = []
    for r, i0, n_items, diag in units.tolist():
        if diag:
            assert (r, n_items) == (tiles.n_tiles - 1, 0)
            continue
        assert tiles.tile_items[r] <= i0 and i0 + n_items <= tiles.tile_items[r + 1]
        items.extend(range(i0, i0 + n_items))
    assert items == list(range(tiles.n_items))  # every item once, in order
    assert int(units[:, 3].sum()) == int(bool(tiles.n_diag))
    assert units[:, 0].tolist() == sorted(units[:, 0].tolist())
    assert all(1 <= n_items <= streaming.MAX_TILE_ITEMS
               for _, _, n_items, diag in units.tolist() if not diag)
    if len(units) * -(-every // positions) < streaming.INNER_BLOCKS_PER_SM * SMS:
        # the card still short of blocks: one position a block, the least slices
        assert positions == 1
        assert all(n_items <= streaming.INNER_SLICE_ITEMS for _, _, n_items, _ in units.tolist())
    return positions, units


def _check(xs, zs, n, k, c, rng, cap=K.PARTIALS_CAP, coeffs=None):
    tiles = streaming.GroupTiles(xs, zs, n, k, c, diagonal=False, inner_diagonal=True)
    _check_schedule(tiles, n)
    assert not (np.asarray(xs)[tiles.order[:int(tiles.item_start[-1])]] == 0).any()
    assert sorted(tiles.order.tolist() + tiles.spill_index.tolist()) == list(range(len(xs)))
    a, psi = (torch.as_tensor(_state(rng, n)) for _ in range(2))
    txs, tzs = torch.as_tensor(np.asarray(xs, np.int64)), torch.as_tensor(np.asarray(zs, np.int64))
    c = torch.as_tensor(rng.standard_normal(len(xs)) + 1j * rng.standard_normal(len(xs))
                        if coeffs is None else np.asarray(coeffs, np.complex128))
    for left in (a, psi):
        ref = K.pauli_inner_plain(left, psi, txs, tzs)
        got = _emulate(tiles, n, left, psi, cap)
        spill = torch.as_tensor(tiles.spill_index)
        got[spill] = K.pauli_inner_plain(left, psi, txs[spill], tzs[spill])  # the per-term kernel
        assert _rel(got.numpy(), ref.numpy()) <= TOL64
        # the fold: E and the screen's contributions, and the wrappers' CPU route
        e_ref = (c * ref).real.sum()
        assert abs(float((c * got).real.sum() - e_ref)) <= TOL64 * float(c.abs().sum())
        # the screen's contributions, within 1e-10 of the larger of their norm
        # and 2 ||c|| (a = psi makes them vanish for a Hermitian pool)
        diff = torch.linalg.vector_norm(2.0 * (c * (got - ref)).imag)
        assert diff <= TOL64 * max(torch.linalg.vector_norm(2.0 * (c * ref).imag),
                                   2.0 * torch.linalg.vector_norm(c))
        assert torch.equal(K.pauli_inner_grouped(left, psi, txs, tzs, tiles), ref)
        assert torch.equal(K.screen_grouped(left, psi, txs, tzs, c.real, c.imag, tiles),
                           2.0 * (c * ref).imag)
    assert torch.equal(K.expectation_grouped(psi, txs, tzs, c.real, c.imag, tiles),
                       (c * K.pauli_inner_plain(psi, psi, txs, tzs)).real.sum())
    return tiles


# -- the emulation -----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inner_tiles_emulation_random_terms(seed):
    """Random lists at 12 qubits, tiles of 9 bits (several tiles, item
    slices, a diagonal whose phase masks leave every tile); seeds 1 and 2
    add masks that fit no tile, seed 2 a partials cap that cuts the tiles
    into several launches."""
    rng = np.random.default_rng(70 + seed)
    xs, zs, c = _random_terms(rng, 12, 120, wide=2 * seed)
    cap = 64 * 8 if seed == 2 else K.PARTIALS_CAP
    tiles = _check(xs, zs, 12, 9, 2, rng, cap, c)
    assert tiles.n_tiles > 1 and tiles.n_diag == 30 and bool(tiles.spill_index.size) == (seed > 0)
    assert tiles.idiag_zout.any()  # phase bits off the diagonal's tile
    if seed == 2:
        assert len(tiles.plan(12, SMS, cap)[3]) > 1


@pytest.fixture(scope="module")
def lists_2x3():
    problem = HubbardProblem(*ARGS_2X3)
    pool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(2, 3)], 12)
    out = {"pool": pool.scan_arrays()}
    for k in ("H", "Sz", "S^2"):
        out[k] = problem.observables[k]._scan_terms()
    return out


@pytest.mark.parametrize("what", ["pool", "H", "Sz", "S^2"])
@pytest.mark.parametrize("shape", [(12, 2), (9, 2)], ids=["12-2", "9-2"])
def test_inner_tiles_emulation_adapt_2x3(lists_2x3, what, shape):
    """The 2x3 lists (12 qubits) at tile shapes 12/2 (one tile position)
    and 9/2, with their own coefficients."""
    xs, zs, cre, cim = lists_2x3[what][:4]
    tiles = _check(np.asarray(xs, np.int64), np.asarray(zs, np.int64), 12, *shape,
                   np.random.default_rng(9), coeffs=np.asarray(cre) + 1j * np.asarray(cim))
    assert bool(tiles.n_diag) == (what != "pool") and not tiles.spill_index.size
    if what == "Sz":
        assert (tiles.n_tiles, tiles.n_items) == (1, 0)  # the diagonal alone


def test_wht_kernel_order_is_the_transform():
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(1 << 10))
    m = torch.arange(1 << 10)
    sign = 1.0 - 2.0 * parity(m[:, None] & m[None, :]).to(torch.float64)
    assert torch.allclose(_wht_kernel_order(u, 10), sign @ u, atol=1e-9)


# -- the 3x3 counts ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lists_3x3():
    problem = HubbardProblem(*ARGS_3X3)
    pool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(3, 3)], 18)
    out = {"pool": pool.scan_arrays()[:2]}
    for k in ("H", "Sz", "S^2"):
        out[k] = problem.observables[k]._scan_terms()[:2]
    return out


# list -> (terms, flip masks, items, tiles, x = 0 items, x = 0 terms) at the
# shipped 12 / 2, the layout with x = 0 items (the application's)
COUNTS_3X3 = {"pool": (2592, 324, 324, 12, 0, 0), "H": (100, 37, 56, 2, 20, 28),
              "Sz": (18, 1, 15, 1, 15, 18), "S^2": (442, 37, 142, 4, 106, 154)}
# list -> (items, tiles, diagonal terms, units, tile positions a block,
# blocks) of the inner products' layout at 12 / 2 on 132 SMs
INNER_3X3 = {"pool": (324, 12, 0, 26, 1, 1664), "H": (36, 2, 28, 6, 1, 384),
             "Sz": (0, 1, 18, 1, 1, 64), "S^2": (36, 4, 154, 7, 1, 448)}


@pytest.mark.parametrize("what", sorted(COUNTS_3X3))
def test_inner_tile_counts_3x3(lists_3x3, what):
    assert (streaming.INNER_TILE_BITS, streaming.INNER_TILE_LOW_BITS) == (12, 2)
    xs, zs = (np.asarray(v, np.int64) for v in lists_3x3[what])
    old = streaming.GroupTiles(xs, zs, 18, 12, 2)
    zero_items = int((old.item_x == 0).sum())
    assert (len(xs), len(np.unique(xs)), old.n_items, old.n_tiles, zero_items,
            int((xs == 0).sum())) == COUNTS_3X3[what]
    tiles = streaming.GroupTiles(xs, zs, 18, 12, 2, diagonal=False, inner_diagonal=True)
    positions, units = _check_schedule(tiles, 18)
    blocks = len(units) * (1 << 6) // positions
    assert (tiles.n_items, tiles.n_tiles, tiles.n_diag, len(units), positions,
            blocks) == INNER_3X3[what]
    assert not tiles.spill_index.size and len(tiles.plan(18, SMS, K.PARTIALS_CAP)[3]) == 1


# -- the engine's route against the JAX package -----------------------------------------------


def _random_op(rng, n, T):
    """A Pauli sum of T terms on a few flip masks (qubit masks), a quarter
    of them diagonal, complex coefficients: the torch and the JAX
    PauliSum of the same arrays."""
    xs, zs, c = _random_terms(rng, n, T)
    args = (xs.astype(np.uint64), zs.astype(np.uint64), c)
    return PauliSum(*args), JaxPauliSum(*args)


def _random_pool(rng, n, G=6):
    gens = [_random_op(rng, n, int(rng.integers(2, 9))) for _ in range(G)]
    return [g[0] for g in gens], [g[1] for g in gens]


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_expectation_scan_vs_expectation_chain_pallas(n):
    rng = np.random.default_rng(600 + n)
    op, _ = _random_op(rng, n, 40)
    obs = Observable(op, n)
    xs, zs, cre, cim = obs._scan_terms()
    psi = _state(rng, n, np.complex64)
    ref = float(expectation_chain_pallas(jnp.asarray(psi), n, jnp.asarray(xs), jnp.asarray(zs),
                                         jnp.asarray(cre, jnp.float32),
                                         jnp.asarray(cim, jnp.float32)))
    got = float(obs.expectation_scan(torch.as_tensor(psi)))
    assert abs(got - ref) <= RTOL32 * max(1.0, abs(ref))
    assert obs._tensor_cache.get("inner_groups") is not None  # the tile route ran
    assert obs.inner_groups().n_diag


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_screen_scan_vs_screen_chain_pallas(n):
    rng = np.random.default_rng(700 + n)
    gens, _ = _random_pool(rng, n)
    pool = PackedPool(gens, n)
    xs, zs, cre, cim, ks = pool.scan_arrays()
    psi, w = _state(rng, n, np.complex64), _state(rng, n, np.complex64)
    contribs = np.asarray(screen_chain_pallas(
        jnp.asarray(psi), jnp.asarray(w), n, jnp.asarray(xs), jnp.asarray(zs),
        jnp.asarray(cre, jnp.float32), jnp.asarray(cim, jnp.float32)))
    ref = np.zeros(pool.size)
    np.add.at(ref, ks, contribs)
    got = pool.screen_scan(torch.as_tensor(psi), torch.as_tensor(w)).numpy()
    assert _rel(got, ref) <= RTOL32
    assert pool._tensor_cache.get("inner_groups") is not None


@pytest.mark.parametrize("n", [10, 11])
def test_expectation_and_screen_scan_vs_jax_xla_complex128(n):
    rng = np.random.default_rng(800 + n)
    op, jop = _random_op(rng, n, 40)
    psi, w = _state(rng, n), _state(rng, n)
    ref = float(JaxObservable(jop, n).expectation_scan(jnp.asarray(psi)))
    got = float(Observable(op, n).expectation_scan(torch.as_tensor(psi)))
    assert abs(got - ref) <= TOL64 * max(1.0, abs(ref))
    gens, jgens = _random_pool(rng, n)
    ref = np.asarray(JaxPool(jgens, n).screen_scan(jnp.asarray(psi), jnp.asarray(w)))
    got = PackedPool(gens, n).screen_scan(torch.as_tensor(psi), torch.as_tensor(w)).numpy()
    assert _rel(got, ref) <= TOL64


# -- the one-term rotation ---------------------------------------------------------------------


@pallas
@pytest.mark.parametrize("n", [10, 12])
def test_pauli_rotation_one_tensor_scalars_vs_pallas(n):
    """x = 0 and x != 0, the angle and the masks as one-element tensors."""
    rng = np.random.default_rng(40 + n)
    psi = _state(rng, n, np.complex64)
    for x, z in ((0, 0b1011), ((1 << (n - 1)) | 0b11, 0b110)):
        theta = float(rng.uniform(-1.5, 1.5))
        ph = (-1j) ** (bin(x & z).count("1") % 4)
        ref = np.asarray(pauli_rotation_pallas(jnp.asarray(psi), n, jnp.uint32(x), jnp.uint32(z),
                                               theta, ph.real, ph.imag))
        tpsi = torch.as_tensor(psi)
        got = K.pauli_rotation_one(tpsi, torch.tensor([x]), torch.tensor(z, dtype=torch.int32),
                                   torch.tensor([theta], dtype=torch.float32), ph.real, ph.imag)
        assert torch.equal(tpsi, torch.as_tensor(psi))  # out of place
        assert got.dtype == torch.complex64
        assert _rel(got.numpy(), ref) <= RTOL32
