"""The application of a Pauli sum over inner-product tiles
(``kernels.pauli_apply_grouped`` on ``streaming.GroupTiles``), on the CPU.

* An emulation: the tile kernel's indexing written out in torch from the
  layout's tables alone (tile masks, the psi tile, each thread's
  register slots, the items' 16-entry tables formed from the
  coefficients by term index, their bucket bits and signs, the runs of
  items of one flip mask sharing one partner load, the tile order with the
  first tile storing the output and each later one adding to it, a
  tile's x = 0 terms as one diagonal (a Walsh-Hadamard transform of
  their spectrum) or as items, the terms of masks that fit no tile added
  last), against
  ``pauli_apply_plain`` at complex128 within 1e-10: random term lists with
  x = 0 terms and masks that fit no tile (seeds 0-2), and the 2x3 H and
  S^2 at tile shapes 12/2 and 9/2.  It is the only check of the host
  tables on a machine without a card.
* The grouped route against the JAX package's Pallas kernels in interpret
  mode, at complex64: ``apply_chain_pallas`` at n = 10, 11 (relative
  1e-5, float32 rounding) and ``apply_stream_pallas`` on the 2x3 H
  (absolute 2e-5, the JAX stream tests' tolerance); ``Observable.apply_scan``
  at complex128 against the JAX XLA ``apply`` within 1e-10.
* The item and tile counts of the 3x3 and 2x6 H at the shipped shape.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine import pallas_kernels as jpk
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.engine.state import parity
from qsfh_torch.ops.pauli import PauliSum

TOL64 = 1e-10
RTOL32 = 1e-5
ARGS_2X3 = (2, 3, 1.0, 6.0, 6, 3, 3)

pallas = pytest.mark.skipif(not jpk.HAVE_PALLAS, reason="pallas unavailable")


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


def _random_terms(rng, n, T, wide=0):
    """Terms on a few flip masks of 0-4 bits anywhere (the Hubbard shapes,
    x = 0 included), ``wide`` of them on a mask of n - 2 bits (it fits no
    tile), and complex coefficients."""
    masks = [0]
    for _ in range(max(1, T // 4)):
        bits = rng.choice(n, size=rng.choice([0, 1, 2, 2, 4, 4]), replace=False)
        masks.append(sum(1 << int(b) for b in bits))
    xs = rng.choice(np.asarray(masks, np.int64), size=T)
    for t in rng.choice(T, size=wide, replace=False):
        xs[t] = ((1 << n) - 1) ^ 0b101
    c = rng.standard_normal(T) + 1j * rng.standard_normal(T)
    return xs, rng.integers(0, 1 << n, size=T), c


def _emulate(tiles, n, psi, cre, cim, xs, zs):
    """The tile kernel on psi from the layout's tables, one launch per
    tile: thread tid's register slot r is tile slot tid | r << (k - top) at
    flat index outer | deposit(t >> c, hi) | (t & low), and the tile sits
    in shared memory in tile order; an item's table holds C[j], the coefficients of its
    terms (read at their input index ``order``) summed with the signs
    (-1)^popc(j & d), and -C[j] at j | 16; slot r of thread tid takes the
    entry (jb(tid) | s << 4) ^ er(r), s = parity(tid & zt) ^ parity(outer
    & zout) and er from item_ehi (the top bits' buckets and signs), into
    coef; the last item of a run of one x multiplies coef by
    the psi tile at the slot XOR item_xa (x on the tile) into acc.  A tile with diagonal
    entries (``tile_diag``) takes its x = 0 items as one diagonal instead:
    the spectrum (entry e at diag_zin[e], the sum of its terms' coefficients
    signed by parity(outer & diag_zout)) Walsh-Hadamard transformed over
    the tile, times psi.  The first tile stores
    out, later tiles add; the terms of masks that fit no tile (the
    per-term kernel) come last."""
    k, c = tiles.k, tiles.c
    top = streaming.APPLY_TOP_BITS
    hb = k - top
    tid, r = torch.arange(1 << hb), torch.arange(1 << top)
    t = tid[:, None] | (r[None, :] << hb)  # (thread, register) tile slots
    low = (1 << c) - 1
    j16 = torch.arange(16)
    had = 1.0 - 2.0 * parity(j16[:, None] & j16[None, :]).to(torch.float64)
    coeffs = torch.complex(cre.to(torch.float64), cim.to(torch.float64)).to(psi.dtype)
    out = torch.zeros_like(psi)
    for rt in range(tiles.n_tiles):
        mask = int(tiles.tile_mask[rt])
        outer = _deposit(torch.arange(1 << (n - k)), _positions(((1 << n) - 1) & ~mask))
        g = outer[:, None, None] | _deposit(t >> c, _positions(mask & ~low))[None] | (t & low)[None]
        sp = torch.zeros((outer.numel(), 1 << k), dtype=psi.dtype)
        sp[:, t.reshape(-1)] = psi[g].reshape(outer.numel(), -1)
        i0, i1 = int(tiles.tile_items[rt]), int(tiles.tile_items[rt + 1])
        acc = torch.zeros(g.shape, dtype=psi.dtype)
        coef = torch.zeros(g.shape, dtype=psi.dtype)
        d0, d1 = int(tiles.tile_diag[rt]), int(tiles.tile_diag[rt + 1])
        if d1 > d0:  # the diagonal: a Walsh-Hadamard transform of its spectrum
            spec = torch.zeros((outer.numel(), 1 << k), dtype=psi.dtype)
            for e in range(d0, d1):
                span = slice(int(tiles.diag_start[e]), int(tiles.diag_start[e + 1]))
                zout = torch.as_tensor(tiles.diag_zout[span].astype(np.int64))
                sign = 1.0 - 2.0 * parity(outer[:, None] & zout[None, :]).to(psi.real.dtype)
                terms = torch.as_tensor(tiles.diag_term[span].astype(np.int64))
                spec[:, int(tiles.diag_zin[e])] = (sign * coeffs[terms][None, :]).sum(1)
            for b in range(k):
                spec = spec.reshape(outer.numel(), -1, 2, 1 << b)
                lo, up = spec[:, :, 0], spec[:, :, 1]
                spec = torch.stack([lo + up, lo - up], 2)
            diagonal = spec.reshape(outer.numel(), 1 << k)[:, t]  # (position, tid, r)
            acc += diagonal * sp[:, t]
        for it in range(i0, i1):
            if d1 > d0 and int(tiles.item_x[it]) == 0:
                continue
            span = slice(int(tiles.item_start[it]), int(tiles.item_start[it + 1]))
            d = torch.as_tensor(tiles.term_d[span].astype(np.int64))
            C = had.to(psi.dtype)[:, d] @ coeffs[torch.as_tensor(tiles.order[span])]
            jt, zt = int(tiles.item_jt[it]), int(tiles.item_zt[it])
            ehi, zo = int(tiles.item_ehi[it]), int(tiles.item_zout[it])
            jb = sum(((tid >> (jt >> (4 * m) & 15)) & 1) << m for m in range(4))
            er = torch.zeros(1 << top, dtype=torch.int64)  # index of the top bits: j | sign << 4
            for b in range(top):
                er ^= ((r >> b) & 1) * (ehi >> (5 * b) & 31)
            flips = parity(tid & zt)[None, :, None] ^ parity(outer & zo)[:, None, None]
            idx = (jb[None, :, None] | flips << 4) ^ er[None, None, :]  # (position, tid, r)
            table = torch.cat([C, -C])  # entry j | s << 4 = (-1)^s C[j]
            coef += table[idx]
            xa = int(tiles.item_xa[it])
            if it + 1 == i1 or int(tiles.item_xa[it + 1]) != xa:
                acc += coef * sp[:, t ^ xa]
                coef.zero_()
        if rt == 0:
            out[g] = acc
        else:
            out[g] += acc
    if tiles.spill_index.size:
        idx = torch.as_tensor(tiles.spill_index)
        out += K.pauli_apply_plain(psi, torch.as_tensor(xs)[idx], torch.as_tensor(zs)[idx],
                                   cre[idx], cim[idx])
    return out


def _check_emulation(xs, zs, c, n, k, low, rng, spill=False, diagonal=True):
    tiles = streaming.GroupTiles(xs, zs, n, k, low, diagonal=diagonal)
    assert bool(tiles.spill_index.size) == spill
    assert tiles.n_tiles >= 1
    psi = torch.as_tensor(_state(rng, n))
    args = (torch.as_tensor(np.asarray(xs, np.int64)), torch.as_tensor(np.asarray(zs, np.int64)),
            torch.as_tensor(c.real), torch.as_tensor(c.imag))
    ref = K.pauli_apply_plain(psi, *args)
    got = _emulate(tiles, n, psi, args[2], args[3], args[0], args[1])
    assert _rel(got.numpy(), ref.numpy()) <= TOL64
    assert torch.equal(K.pauli_apply_grouped(psi, *args, tiles), ref)  # CPU: plain
    return tiles


@pytest.mark.parametrize("diagonal", [True, False], ids=["diagonal", "items"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_tiles_emulation_random_terms(seed, diagonal):
    """12 qubits, tiles of 9 bits (the low 2): several tiles with their own
    bit sets; seeds 1 and 2 add masks that fit no tile.  The x = 0 terms
    as a tile's diagonal, or (a layout without diagonals) as items."""
    rng = np.random.default_rng(90 + seed)
    xs, zs, c = _random_terms(rng, 12, 80, wide=3 * seed)
    tiles = _check_emulation(xs, zs, c, 12, 9, 2, rng, spill=seed > 0, diagonal=diagonal)
    assert tiles.n_tiles > 1 and len({int(m) for m in tiles.tile_mask}) > 1
    assert (xs[tiles.order] == 0).any()
    assert bool(tiles.diag_zin.size) == diagonal


@pytest.fixture(scope="module")
def problem_2x3():
    return HubbardProblem(*ARGS_2X3)


@pytest.mark.parametrize("shape", [(12, 2), (9, 2)], ids=["12-2", "9-2"])
@pytest.mark.parametrize("what", ["H", "S^2"])
def test_apply_tiles_emulation_adapt_2x3(problem_2x3, what, shape):
    xs, zs, cre, cim = problem_2x3.observables[what]._scan_terms()
    tiles = _check_emulation(np.asarray(xs, np.int64), np.asarray(zs, np.int64), cre + 1j * cim,
                             12, *shape, np.random.default_rng(17))
    assert tiles.k == shape[0]


def test_apply_tiles_emulation_strided_coefficients(problem_2x3):
    """The real and imaginary views of one complex tensor, as the engine
    hands them at complex64: read with a stride of 2, no copy (float32
    rounding, 1e-5)."""
    obs = problem_2x3.observables["H"]
    psi = torch.as_tensor(_state(np.random.default_rng(18), 12, np.complex64))
    xs, zs, c = obs._tensors(psi)
    tiles = obs.groups()
    cre, cim, stride = K._coefficient_planes(psi, c.real, c.imag, len(xs), "test")
    assert stride == 2 and cre.data_ptr() == c.data_ptr() and cim.data_ptr() == c.data_ptr() + 4
    got = _emulate(tiles, 12, psi, cre, cim, xs, zs)
    assert _rel(got.numpy(), K.pauli_apply_plain(psi, xs, zs, c.real, c.imag).numpy()) <= RTOL32


def test_apply_grouped_plain_rejects_another_layout():
    tiles = streaming.GroupTiles(np.asarray([0b11, 0b11]), np.zeros(2, np.int64), 12, 9, 4)
    psi = torch.as_tensor(_state(np.random.default_rng(3), 12))
    one = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="leaves"):
        K.pauli_apply_grouped_plain(psi, torch.tensor([0b11, 1 << 10]),
                                    torch.zeros(2, dtype=torch.int64), one, one, tiles)
    with pytest.raises(ValueError, match="layout"):
        K.pauli_apply_grouped_plain(psi, torch.tensor([0b11]), torch.zeros(1, dtype=torch.int64),
                                    one[:1], one[:1], tiles)


# -- the grouped route against the JAX package -----------------------------------------------------


@pallas
@pytest.mark.parametrize("n", [10, 11])
def test_apply_grouped_vs_apply_chain_pallas(n):
    """Random terms (x = 0 included) at complex64: the wrapper's CPU route
    and the emulated kernel in float32 against the Pallas chain kernel."""
    rng = np.random.default_rng(400 + n)
    xs, zs, c = _random_terms(rng, n, 24)
    c = c.astype(np.complex64)
    psi = _state(rng, n, np.complex64)
    ref = np.asarray(jpk.apply_chain_pallas(
        jnp.asarray(psi), n, jnp.asarray(xs.astype(np.uint32)), jnp.asarray(zs.astype(np.uint32)),
        jnp.asarray(c.real), jnp.asarray(c.imag)))
    tiles = streaming.GroupTiles(xs, zs, n, streaming.INNER_TILE_BITS,
                                 streaming.INNER_TILE_LOW_BITS)
    args = (torch.as_tensor(xs), torch.as_tensor(zs), torch.as_tensor(c.real),
            torch.as_tensor(c.imag))
    got = K.pauli_apply_grouped(torch.as_tensor(psi), *args, tiles)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) <= RTOL32
    emulated = _emulate(tiles, n, torch.as_tensor(psi), args[2], args[3], args[0], args[1])
    assert _rel(emulated.numpy(), ref) <= RTOL32


@pytest.fixture(scope="module")
def h_2x3():
    jp, tp = JaxProblem(*ARGS_2X3), HubbardProblem(*ARGS_2X3)
    return JaxObservable(jp.qubit_hamiltonian, 12), Observable(tp.qubit_hamiltonian, 12)


def test_apply_grouped_vs_apply_stream_pallas(h_2x3, monkeypatch):
    """The 2x3 H at complex64 through ``apply_scan`` (the grouped route at
    12 qubits) against the JAX stream kernel in interpret mode."""
    jobs, tobs = h_2x3
    psi = _state(np.random.default_rng(8), 12, np.complex64)
    xs, zs, cre, cim = jobs._scan_terms()
    monkeypatch.setenv("QSFH_PALLAS_STREAM_ROWS", "8")
    ref = np.asarray(jpk.apply_stream_pallas(
        jnp.asarray(psi), 12, xs, zs, cre.astype(np.float32), cim.astype(np.float32)))
    calls = []
    impl = dataclasses.replace(K.KERNELS, apply=None,
                               apply_grouped=lambda *a: calls.append(a[-1]) or
                               K.pauli_apply_grouped(*a))
    got = tobs.apply_scan(torch.as_tensor(psi), impl=impl)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    assert calls == [tobs.groups()]
    txs, tzs, tc = tobs._tensors(torch.as_tensor(psi))
    emulated = _emulate(tobs.groups(), 12, torch.as_tensor(psi), tc.real, tc.imag, txs, tzs)
    np.testing.assert_allclose(emulated.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("what", ["H", "Sz", "S^2"])
def test_apply_scan_matches_jax_xla_complex128(what):
    jp, tp = JaxProblem(*ARGS_2X3), HubbardProblem(*ARGS_2X3)
    psi = _state(np.random.default_rng(21), 12)
    ref = np.asarray(JaxObservable(jp.observables[what].op, 12).apply(jnp.asarray(psi)))
    tobs = Observable(tp.observables[what].op, 12)
    got = tobs.apply_scan(torch.as_tensor(psi))
    assert _rel(got.numpy(), ref) <= TOL64
    assert tobs._tensor_cache.get("groups") is not None  # the grouped route ran


def test_apply_scan_routes_by_size():
    """From the smallest tile the kernel takes (9 qubits) the grouped
    route; below it the per-term kernel."""
    calls = []

    def recorded(name):
        fn = getattr(K.PLAIN, name)
        return lambda *args: calls.append(name) or fn(*args)

    impl = K.Impl(*(recorded(f.name) for f in dataclasses.fields(K.Impl)))
    for n in (K.INNER_TILE_MIN_BITS - 1, K.INNER_TILE_MIN_BITS):
        rng = np.random.default_rng(n)
        xs, zs, c = _random_terms(rng, n, 12)
        op = PauliSum(xs.astype(np.uint64), zs.astype(np.uint64), c)
        Observable(op, n).apply_scan(torch.as_tensor(_state(rng, n)), impl=impl)
    assert calls == ["apply", "apply_grouped"]


# -- the main paths' counts -----------------------------------------------------------------------


# (lattice) -> (terms, flip masks, items, tiles) of H at the shipped 12 / 2
COUNTS = {"3x3": (100, 37, 56, 2), "2x6": (109, 37, 65, 3)}
LATTICES = {"3x3": (3, 3, 1.0, 6.0, 9, 5, 4), "2x6": (2, 6, 1.0, 6.0, 12, 6, 6)}


@pytest.mark.parametrize("lattice", sorted(COUNTS))
def test_apply_tile_counts(lattice):
    problem = HubbardProblem(*LATTICES[lattice])
    xs, zs = problem.observables["H"]._scan_terms()[:2]
    tiles = streaming.GroupTiles(xs, zs, problem.n_qubits, 12, 2)
    assert (streaming.INNER_TILE_BITS, streaming.INNER_TILE_LOW_BITS) == (12, 2)
    assert not tiles.spill_index.size
    assert (len(xs), len(np.unique(xs)), tiles.n_items, tiles.n_tiles) == COUNTS[lattice]
    # the items of one flip mask are consecutive in each tile: one partner load per mask
    for r in range(tiles.n_tiles):
        xa = tiles.item_xa[tiles.tile_items[r]:tiles.tile_items[r + 1]]
        runs = 1 + int((xa[1:] != xa[:-1]).sum())
        assert runs == len(np.unique(xs[tiles.order[tiles.item_start[tiles.tile_items[r]]:
                                                     tiles.item_start[tiles.tile_items[r + 1]]]]))
