"""The inner-product tile layout (``streaming.GroupTiles``), on the CPU.

* The layout: every term in exactly one item or among the terms of masks
  that fit no tile (those take the per-term kernel); an item's terms share one flip mask x and agree off
  4 bits J containing x (x's bits first); each tile the low c bits and
  k - c others with every item inside; each item's columns address every
  slot of the tile once; results in input order; the 2x6 state passes per
  call that PERF.md records (pool, H, S^2, Sz).
* An emulation: the tile kernel's indexing written out in torch from the
  layout's tables alone (tile masks, swizzled slots, each item's lane,
  bucket and chunk columns, its signs, the terms' 16-bucket sums),
  against ``pauli_inner_plain`` at complex128 within 1e-10, with small
  tiles (k = 9, the least the kernel takes) at 12 qubits so that the bit
  sets vary from tile to tile and some masks fit no tile.  It is the only
  check of the host mask translation on a machine without a card.
* The grouped route on the CPU against the JAX package's XLA scan
  (complex128, 1e-10) with small tiles and a small item cap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.engine.expectation import PackedPool as JaxPool
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.pool import hubbard_interaction_pool_simplified as jax_pool_ops
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.expectation import Observable, PackedPool
from qsfh_torch.engine.state import index_bits, parity
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

TOL64 = 1e-10
N = 12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _state(rng, n=N):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _positions(mask):
    return [b for b in range(int(mask).bit_length()) if int(mask) >> b & 1]


def _deposit(v, positions):
    out = torch.zeros_like(v)
    for j, p in enumerate(positions):
        out |= ((v >> j) & 1) << p
    return out


def _random_terms(rng, n, T, wide=0):
    """Terms whose flip masks have 0-4 bits anywhere (the Hubbard shapes),
    drawn from a few masks so that masks repeat, plus ``wide`` masks of
    n - 2 bits (they fit no small tile)."""
    masks = []
    for _ in range(max(1, T // 4)):
        bits = rng.choice(n, size=rng.choice([0, 1, 2, 2, 4, 4]), replace=False)
        masks.append(sum(1 << int(b) for b in bits))
    xs = rng.choice(np.asarray(masks, np.int64), size=T)
    for t in rng.choice(T, size=wide, replace=False):
        xs[t] = ((1 << n) - 1) ^ 0b101
    return xs, rng.integers(0, 1 << n, size=T)


def _rank(values):
    """Rank over GF(2) of a list of ints."""
    basis = {}
    for v in map(int, values):
        while v:
            top = v.bit_length() - 1
            if top not in basis:
                basis[top] = v
                break
            v ^= basis[top]
    return len(basis)


def _check_layout(tiles, xs, zs, n, max_items=streaming.MAX_TILE_ITEMS):
    k, c = tiles.k, tiles.c
    xs, zs = np.asarray(xs, np.int64), np.asarray(zs, np.int64)
    # every term once, in an item or among the terms of masks that fit no tile
    assert sorted(tiles.order.tolist() + tiles.spill_index.tolist()) == list(range(xs.size))
    assert tiles.tile_items.size == tiles.n_tiles + 1
    assert tiles.item_start[-1] == tiles.order.size == tiles.term_d.size
    for r in range(tiles.n_tiles):
        mask = int(tiles.tile_mask[r])
        assert mask & ((1 << c) - 1) == (1 << c) - 1
        assert bin(mask).count("1") == k and mask < 1 << n
        assert 0 < tiles.tile_items[r + 1] - tiles.tile_items[r] <= max_items
        pos = _positions(mask)
        for it in range(tiles.tile_items[r], tiles.tile_items[r + 1]):
            idx = tiles.order[tiles.item_start[it]:tiles.item_start[it + 1]]
            assert idx.size and len(set(xs[idx])) == 1  # one flip mask per item
            x = int(xs[idx[0]])
            assert not x & ~mask  # inside the tile
            cols = [int(v) for v in tiles.item_cols[it][:k]]
            assert not tiles.item_cols[it][k:].any()
            # the columns of the tile bits, each once: lane, bucket and
            # chunk bits address every slot of the tile once
            assert sorted(cols) == sorted(streaming.inner_column(b) for b in range(k))
            assert _rank(cols) == k
            tb = [[streaming.inner_column(b) for b in range(k)].index(v) for v in cols]
            jb = tb[5:9]
            assert int(tiles.item_x[it]) == (1 << bin(x).count("1")) - 1
            assert sum(1 << pos[b] for b in jb[:bin(x).count("1")]) == x  # x first in J
            J = sum(1 << pos[b] for b in jb)
            common = zs[idx] & ~J  # the phase masks agree off J
            assert (common == common[0]).all()
            l9 = tb[:5] + tb[9:]
            zlc = streaming.pext(common[:1], [pos[b] for b in l9])[0]
            assert int(tiles.item_zlc[it]) == int(zlc)
            assert int(tiles.item_zout[it]) == int(common[0]) & ~mask
            d = tiles.term_d[tiles.item_start[it]:tiles.item_start[it + 1]]
            assert (d == streaming.pext(zs[idx], [pos[b] for b in jb])).all()
            if k >= 12:  # each half-warp's 4 lane columns reach all 16 bank pairs
                assert _rank([v & 15 for v in cols[:4]]) == 4
    low = (1 << c) - 1
    spilled = xs[tiles.spill_index]
    assert (np.bitwise_count(spilled) > streaming.REG_BITS).all()
    assert (np.bitwise_count(xs[tiles.order]) <= streaming.REG_BITS).all()
    assert (np.bitwise_count(xs[tiles.order] & ~low) <= k - c).all()
    chunks = tiles.chunks(7, 7 * 40)
    assert [r for r0, r1 in chunks for r in range(r0, r1)] == list(range(tiles.n_tiles))


def _emulate(tiles, n, a, psi, xs, zs):
    """The tile kernel on (a, psi) from the layout's tables: per tile, the
    a and psi tiles of every position stored at their swizzled slots
    (``INNER_SWIZZLE``); per item, lane l, chunk ch and bucket j read the
    slot lane_off(l) ^ chunk_off(ch) ^ jo(j) (XORs of the item's columns)
    and slot j ^ item_x of the same 16 for psi, with the sign
    parity((l | ch << 5) & zlc) ^ parity(outer & zout), summed over lanes,
    chunks and positions into 16 buckets; a term is the sum of the buckets
    with the signs (-1)^popc(j & d), at out[order[t]].  The terms of masks
    that fit no tile: one signed sum per term (the per-term kernel)."""
    k = tiles.k
    t = torch.arange(1 << k)
    slot = t.clone()
    for b in range(4, k):
        slot ^= ((t >> b) & 1) * streaming.INNER_SWIZZLE[b - 4]
    lane, ch, j = torch.arange(32), torch.arange(1 << (k - 9)), torch.arange(16)
    had = 1.0 - 2.0 * parity(j[:, None] & j[None, :]).to(torch.float64)

    def xor_span(values, cols):
        out = torch.zeros_like(values)
        for b, col in enumerate(cols):
            out ^= ((values >> b) & 1) * int(col)
        return out

    out = torch.full((tiles.n_terms,), float("nan"), dtype=psi.dtype)
    for r in range(tiles.n_tiles):
        mask = int(tiles.tile_mask[r])
        outer = _deposit(torch.arange(1 << (n - k)), _positions(((1 << n) - 1) & ~mask))
        flat = outer[:, None] | _deposit(t, _positions(mask))[None, :]
        sa, sp = (torch.zeros((outer.numel(), 1 << k), dtype=psi.dtype) for _ in range(2))
        sa[:, slot], sp[:, slot] = a[flat], psi[flat]
        for it in range(tiles.tile_items[r], tiles.tile_items[r + 1]):
            cols = tiles.item_cols[it]
            base = xor_span(lane, cols[:5])[:, None] ^ xor_span(ch, cols[9:k])[None, :]
            addr = base[:, :, None] ^ xor_span(j, cols[5:9])[None, None, :]  # (lane, chunk, j)
            partner = addr[:, :, j ^ int(tiles.item_x[it])]
            l9 = lane[:, None] | (ch[None, :] << 5)
            odd = (parity(l9 & int(tiles.item_zlc[it]))[None]
                   ^ parity(outer & int(tiles.item_zout[it]))[:, None, None])
            sign = 1.0 - 2.0 * odd.to(torch.float64)
            B = (sign[..., None] * sa[:, addr].conj() * sp[:, partner]).sum((0, 1, 2))
            span = slice(tiles.item_start[it], tiles.item_start[it + 1])
            d = torch.as_tensor(tiles.term_d[span].astype(np.int64))
            out[torch.as_tensor(tiles.order[span])] = had.to(psi.dtype)[d] @ B
    idx = index_bits(n)
    for t in tiles.spill_index.tolist():
        sign = 1.0 - 2.0 * parity(idx & int(zs[t])).to(torch.float64)
        out[t] = (sign * a.conj() * psi[idx ^ int(xs[t])]).sum()
    return out


def _check_emulation(xs, zs, n, k, c, rng, max_items=streaming.MAX_TILE_ITEMS, spill=False):
    tiles = streaming.GroupTiles(xs, zs, n, k, c, max_items)
    _check_layout(tiles, xs, zs, n, max_items)
    assert tiles.n_tiles > 1 and len({int(m) for m in tiles.tile_mask}) > 1
    assert bool(tiles.spill_index.size) == spill
    a, psi = (torch.as_tensor(_state(rng, n)) for _ in range(2))
    txs, tzs = torch.as_tensor(np.asarray(xs, np.int64)), torch.as_tensor(np.asarray(zs, np.int64))
    for left in (a, psi):
        got = _emulate(tiles, n, left, psi, xs, zs)
        ref = K.pauli_inner_plain(left, psi, txs, tzs)
        assert _rel(got.numpy(), ref.numpy()) <= TOL64
        assert torch.equal(K.pauli_inner_grouped(left, psi, txs, tzs, tiles), ref)  # CPU: plain
    return tiles


# -- the layout --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_tiles_emulation_random_terms(seed):
    """Random term lists; seeds 1 and 2 add masks that fit no tile."""
    rng = np.random.default_rng(60 + seed)
    xs, zs = _random_terms(rng, N, 90, wide=3 * seed)
    _check_emulation(xs, zs, N, 9, 2, rng, max_items=24, spill=seed > 0)


def test_masks_that_fit_no_tile_are_split_off():
    # more than REG_BITS = 4 flip bits: the masks of terms 2 and 4
    xs = np.asarray([0b11, 0b1111_0000, 0b111111 << 4, 1 << 9, 0b111111 << 4, 0], np.int64)
    tiles = streaming.GroupTiles(xs, np.arange(6), 12, 9, 4)
    assert tiles.spill_index.tolist() == [2, 4]
    assert tiles.n_tiles == 1 and len(tiles) == 3  # one tile pass, one pass per spilled term
    assert sorted(tiles.order.tolist()) == [0, 1, 3, 5]


def test_group_tiles_items():
    """Terms that differ only on their flip bits share one item (a pool
    generator); Z_q terms (one mask, x = 0) share an item only where q
    lies in the 4 bits the item takes, and a mask with more items than a
    tile takes is cut into pieces, one tile each."""
    x = 0b1001_0110
    zs = np.asarray([0b1_0000_0001 | (x & (7 * v)) for v in range(8)], np.int64)
    tiles = streaming.GroupTiles(np.full(8, x), zs, N, 9, 4)
    assert (tiles.n_tiles, tiles.n_items) == (1, 1)
    tiles = streaming.GroupTiles(np.zeros(12, np.int64), 1 << np.arange(12), N, 9, 4)
    assert (tiles.n_tiles, tiles.n_items) == (1, 9)
    assert sorted(np.diff(tiles.item_start).tolist()) == [1] * 8 + [4]
    tiles = streaming.GroupTiles(np.zeros(12, np.int64), 1 << np.arange(12), N, 9, 4, 4)
    assert (tiles.n_tiles, tiles.n_items) == (3, 9)


def test_group_tiles_plain_rejects_another_layout():
    xs = torch.tensor([0b11, 1 << 10])
    tiles = streaming.GroupTiles(np.asarray([0b11, 0b11]), np.zeros(2, np.int64), N, 9, 4)
    psi = torch.as_tensor(_state(np.random.default_rng(3)))
    with pytest.raises(ValueError, match="leaves"):
        K.pauli_inner_grouped_plain(psi, psi, xs, torch.zeros(2, dtype=torch.int64), tiles)


@pytest.fixture(scope="module")
def adapt_2x3(tmp_path_factory):
    return ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=3,
                 n_electrons=6, n_spin_up=3, n_spin_down=3, tunneling=1, coulomb=6,
                 ground_truth=False, plot=False, log_metrics=False, device="cpu",
                 results_root=str(tmp_path_factory.mktemp("g23")))


@pytest.mark.parametrize("what", ["pool", "H", "S^2"])
@pytest.mark.parametrize("c", [2, 4])
def test_group_tiles_emulation_adapt_2x3(adapt_2x3, what, c):
    """The 2x3 pool, H and S^2 (12 qubits) in tiles of 9 bits."""
    a = adapt_2x3
    arrays = a.packed_pool.scan_arrays() if what == "pool" else (
        a.problem.observables[what]._scan_terms())
    xs, zs = (np.asarray(v, np.int64) for v in arrays[:2])
    _check_emulation(xs, zs, a.n_qubits, 9, c, np.random.default_rng(8), max_items=16)


# -- the 2x6 counts --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lists_2x6(tmp_path_factory):
    a = ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6,
              n_electrons=12, n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=6,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path_factory.mktemp("g26")))
    out = {"pool": a.packed_pool.scan_arrays()[:2]}
    for k in ("H", "S^2", "Sz"):
        out[k] = a.problem.observables[k]._scan_terms()[:2]
    return out


# (list, k, c) -> state passes (tiles) at MAX_TILE_ITEMS = 128: the shipped
# shape (12 / 2) and the neighbours that chip_smoke.py --tiles weighs it
# against; one pass per flip mask before (pool 684, H 37, S^2 68, Sz 1)
PASSES_2X6 = {
    ("pool", 12, 4): 46, ("pool", 13, 4): 31, ("pool", 12, 2): 30,
    ("H", 12, 4): 4, ("H", 13, 4): 3, ("H", 12, 2): 3,
    ("S^2", 12, 4): 11, ("S^2", 13, 4): 11, ("S^2", 12, 2): 9,
    ("Sz", 12, 4): 1, ("Sz", 12, 2): 1,
}


@pytest.mark.parametrize("key", sorted(PASSES_2X6), ids=str)
def test_group_tiles_counts_2x6(lists_2x6, key):
    what, k, c = key
    xs, zs = lists_2x6[what]
    tiles = streaming.GroupTiles(xs, zs, 24, k, c)
    assert not tiles.spill_index.size  # every 2x6 mask fits a tile
    assert (tiles.n_tiles, len(tiles)) == (PASSES_2X6[key],) * 2
    sizes = [t1 - t0 for t0, t1 in map(tiles.tile_terms, range(tiles.n_tiles))]
    assert max(np.diff(tiles.tile_items)) <= streaming.MAX_TILE_ITEMS and sum(sizes) == len(xs)
    assert sorted(tiles.order.tolist()) == list(range(len(xs)))


def test_shipped_shape_is_the_observables_layout(lists_2x6):
    assert (streaming.INNER_TILE_BITS, streaming.INNER_TILE_LOW_BITS) == (12, 2)
    xs, zs = lists_2x6["pool"]
    _check_layout(streaming.GroupTiles(xs, zs, 24, 12, 2), xs, zs, 24)


# -- the grouped route against the JAX package ---------------------------------------------------


@pytest.fixture
def small_inner_tiles(monkeypatch):
    """The grouped route (the engine's at every size from 9 qubits) at 12
    qubits, tiles of 9 bits (the low 2), at most 4 items a tile, so several
    tiles and pieces of masks occur."""
    monkeypatch.setattr(streaming, "INNER_TILE_BITS", 9)
    monkeypatch.setattr(streaming, "INNER_TILE_LOW_BITS", 2)
    monkeypatch.setattr(streaming, "MAX_TILE_ITEMS", 4)


@pytest.mark.parametrize("what", ["H", "Sz", "S^2"])
def test_grouped_expectation_matches_jax_xla_complex128(small_inner_tiles, what):
    args = (2, 3, 1.0, 6.0, 6, 3, 3)
    jp, tp = JaxProblem(*args), HubbardProblem(*args)
    psi = _state(np.random.default_rng(11))
    ref = float(JaxObservable(jp.observables[what].op, N).expectation_scan(jnp.asarray(psi)))
    tobs = Observable(tp.observables[what].op, N)
    got = float(tobs.expectation_scan(torch.as_tensor(psi)))
    assert abs(got - ref) <= TOL64 * max(1.0, abs(ref))
    tiles = tobs.inner_groups()
    assert tiles.k == 9 and len(tiles) >= 1 and not tiles.spill_index.size


def test_grouped_screening_matches_jax_xla_complex128(small_inner_tiles):
    psi = _state(np.random.default_rng(12))
    w = _state(np.random.default_rng(13))
    jpool = JaxPool([jax_jw(g) for g in jax_pool_ops(2, 3)], N)
    tpool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(2, 3)], N)
    ref = np.asarray(jpool.screen_scan(jnp.asarray(psi), jnp.asarray(w)))
    got = tpool.screen_scan(torch.as_tensor(psi), torch.as_tensor(w)).numpy()
    assert _rel(got, ref) <= TOL64
    assert tpool.inner_groups().n_tiles > 1
