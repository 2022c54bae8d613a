"""The float64 tile kernels (``kernels.expectation_norm_f64_tiles`` and
``kernels.happly64_tiles`` on ``streaming.GroupTiles``), on the CPU.

* The layouts' tables against their term lists: every term in exactly one
  item, on the diagonal or spilled (masks that fit no tile); the float64
  coefficient planes the kernels read are the float64 inputs bit for bit
  (the readout's through ``dfloat.f64_layout``, H's through
  ``Rot64Program.h_args``), never float32 planes.
* Emulations of both kernels' tile walks in complex128, from the layouts'
  tables alone: the readout's units and position slices (the diagonal
  unit always present, taking N), each item's 8 paired buckets on the
  swizzled complex64 tile (the pairing B[j ^ XJ] = conj(B[j]) checked bit
  for bit against all 16 buckets), its coefficient table folded by pair,
  the diagonal's Walsh-Hadamard transform of |psi|^2 in the kernel's
  stage order; H psi's threads of 8 register slots, the items' tables and
  runs of one flip mask, a tile's diagonal, the tiles in order with the
  first storing the unscaled sum and the last scaling it and taking E and
  N before the scale; spilled terms through the per-term float64 kernels'
  plain versions.  Held to the plain versions within 1e-13 relative on
  seeded random terms (with and without a spilled mask) and on the 2x3
  and 3x3 H.
* Held to the JAX package on the same numpy inputs: the readout's tile
  walk against ``qsfh_tpu.engine.dfloat.expectation_norm_df`` within
  1e-12 relative; H psi and E against the JAX host engine
  (``qsfh_tpu.native.statevec.Rot64Program``) within 1e-12.
* The routes: the tile kernels from ``F64_TILE_MIN_QUBITS`` qubits on,
  the per-term kernels below; the 3x3 and 2x6 layouts' counts at the
  shipped shapes, and the H psi launches they give an evaluation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.engine import dfloat as jax_dfloat
from qsfh_tpu.native import statevec as jax_statevec
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.dfloat import combine_rayleigh, expectation_norm_df, f64_layout, f64_route
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.engine.state import parity
from qsfh_torch.native.statevec import Rot64Program

RTOL = 1e-13  # the emulations against the plain versions, both complex128
JAX_RTOL = 1e-12
SMS = 132  # an H100's SMs: the schedule the card takes
TOP = 3  # happly64_tiles' register bits (kApply64TopBits)
ARGS_2X3 = (2, 3, 1.0, 6.0, 6, 3, 3)
ARGS_3X3 = (3, 3, 1.0, 6.0, 9, 5, 4)
ARGS_2X6 = (2, 6, 1.0, 6.0, 12, 6, 6)


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


def _sign(bits):
    return 1.0 - 2.0 * parity(bits).to(torch.float64)


def _state(rng, n, dtype=np.complex128):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v) * 1.3).astype(dtype)  # not normalized


def _random_terms(rng, n, T, spill=False):
    """Terms on flip masks of 0-4 bits anywhere (the Hubbard shapes), a
    quarter of them x = 0 with phase masks on every bit, with ``spill``
    three on a mask of n - 2 bits (it fits no tile); complex coefficients."""
    masks = [0]
    for _ in range(max(1, T // 4)):
        bits = rng.choice(n, size=rng.choice([1, 2, 2, 4, 4]), replace=False)
        masks.append(sum(1 << int(b) for b in bits))
    xs = rng.choice(np.asarray(masks, np.int64), size=T)
    xs[::4] = 0
    if spill:
        xs[rng.choice(np.arange(1, T, 4), size=3, replace=False)] = ((1 << n) - 1) ^ 0b101
    c = rng.standard_normal(T) + 1j * rng.standard_normal(T)
    return xs, rng.integers(0, 1 << n, size=T), c


def _wht_kernel_order(u, k):
    """U[m] = sum_t (-1)^popc(t & m) u[t] over the last axis, the stages in
    the readout diagonal's order: the register bits (tile bits 8 to k - 1),
    the lane bits (0-4), the warp bits (5-7)."""
    lead = u.shape[:-1]
    for b in list(range(8, k)) + list(range(5)) + list(range(5, 8)):
        v = u.reshape(*lead, -1, 2, 1 << b)
        lo, up = v[..., 0, :], v[..., 1, :]
        u = torch.stack([lo + up, lo - up], -2).reshape(*lead, 1 << k)
    return u


def _as(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# -- the readout's tile walk ---------------------------------------------------------------------


def _emulate_readout(tiles, n, psi, cre, cim, xs, zs):
    """expectation_f64_tiles_kernel on psi's complex64 rounding from the
    layout's tables: per unit and position slice of ``schedule(n, SMS,
    diagonal_unit=True)`` one (E, N) partial; an item unit puts conj(psi[i])
    psi[i ^ x] into the buckets j = 2m of each lane and chunk (slot
    lane_off ^ chunk_off ^ jo(j), partner slot ^ jo(XJ), sign
    parity((l | ch << 5) & zlc) ^ parity(outer & zout)) and adds (Cre[j] +
    Cre[j ^ XJ]) Re B[j] + (Cim[j ^ XJ] - Cim[j]) Im B[j]; the diagonal unit
    transforms |psi|^2 over the tile (the kernel's stage order), adds
    cre U[zin] signed by parity(outer & zout) per diagonal term and U[0] to
    N.  The partials summed; spilled terms through the per-term readout's
    plain version.  Returns [E, 0, N, 0]."""
    k = tiles.k
    p = psi.to(torch.complex64).to(torch.complex128)
    c = torch.complex(cre, cim)
    t = torch.arange(1 << k)
    slot = t.clone()
    for b in range(4, k):
        slot ^= ((t >> b) & 1) * streaming.INNER_SWIZZLE[b - 4]
    lane, ch, je = torch.arange(32), torch.arange(1 << (k - 9)), 2 * torch.arange(8)
    j16 = torch.arange(16)
    had = _sign(j16[:, None] & j16[None, :]).to(torch.complex128)
    positions, units = tiles.schedule(n, SMS, diagonal_unit=True)
    assert units[-1, 3] == 1 and int(units[:, 3].sum()) == 1  # the diagonal unit, last
    every = 1 << (n - k)
    slices = -(-every // positions)
    partials = torch.full((len(units), slices, 2), float("nan"), dtype=torch.float64)
    diag_rows = torch.as_tensor(tiles.order[int(tiles.item_start[-1]):])
    for u, (r, i0, n_items, diag) in enumerate(units.tolist()):
        mask = tiles.diag_mask if diag else int(tiles.tile_mask[r])
        rest = _positions(((1 << n) - 1) & ~mask)
        for s in range(slices):
            outer = _deposit(torch.arange(s * positions, min((s + 1) * positions, every)), rest)
            flat = outer[:, None] | _deposit(t, _positions(mask))[None, :]
            if diag:
                U = _wht_kernel_order(p[flat].real ** 2 + p[flat].imag ** 2, k)
                e = torch.zeros((), dtype=torch.float64)
                for q in range(tiles.n_diag):
                    v = (_sign(outer & int(tiles.idiag_zout[q])) * U[:, int(tiles.idiag_zin[q])])
                    e += cre[diag_rows[q]] * v.sum()
                partials[u, s] = torch.stack([e, U[:, 0].sum()])
                continue
            tile = torch.zeros((outer.numel(), 1 << k), dtype=torch.complex128)
            tile[:, slot] = p[flat]
            e = torch.zeros((), dtype=torch.float64)
            for it in range(i0, i0 + n_items):
                cols = tiles.item_cols[it]
                xj = int(tiles.item_x[it])
                assert xj in (1, 3, 7, 15)  # no x = 0 item: the list's diagonal has them
                base = _xor_span(lane, cols[:5])[:, None] ^ _xor_span(ch, cols[9:k])[None, :]
                jo = _xor_span(j16, cols[5:9])
                addr = base[:, :, None] ^ jo[None, None, :]  # (lane, chunk, bucket)
                odd = (parity((lane[:, None] | ch[None, :] << 5) & int(tiles.item_zlc[it]))[None]
                       ^ parity(outer & int(tiles.item_zout[it]))[:, None, None])
                prod = tile[:, addr].conj() * tile[:, addr ^ int(jo[xj])]
                B16 = (_sign(odd)[..., None] * prod).sum((0, 1, 2))
                assert torch.equal(B16[je ^ xj], B16[je].conj())  # the pairing, bit for bit
                B = B16[je]
                span = slice(int(tiles.item_start[it]), int(tiles.item_start[it + 1]))
                d = torch.as_tensor(tiles.term_d[span].astype(np.int64))
                C = had[:, d] @ c[torch.as_tensor(tiles.order[span])]
                e += ((C[je].real + C[je ^ xj].real) * B.real
                      + (C[je ^ xj].imag - C[je].imag) * B.imag).sum()
            partials[u, s] = torch.stack([e, torch.zeros((), dtype=torch.float64)])
    assert not partials.isnan().any()  # each (unit, slice) partial written
    e, nn = partials.sum((0, 1))
    if tiles.spill_index.size:
        idx, starts = K._spill64(tiles, psi.device)
        assert (np.diff(np.asarray(xs)[idx.numpy()]) >= 0).all()  # grouped by mask
        e = e + K.expectation_norm_f64_plain(psi, xs[idx], zs[idx], cre[idx], cim[idx],
                                             starts)[0]
    zero = torch.zeros((), dtype=torch.float64)
    return torch.stack([e, zero, nn, zero])


def _readout_layout(xs, zs, n, k, c):
    return streaming.GroupTiles(xs, zs, n, k, c, diagonal=False, inner_diagonal=True)


def _check_readout(xs, zs, cvals, n, k, c, rng, spill):
    tiles = _readout_layout(xs, zs, n, k, c)
    assert bool(tiles.spill_index.size) == spill
    psi = torch.as_tensor(_state(rng, n, np.complex64))
    txs, tzs, cre, cim = _as(np.asarray(xs, np.int64), np.asarray(zs, np.int64), cvals.real,
                             cvals.imag)
    ref = K.expectation_norm_f64_tiles_plain(psi, txs, tzs, cre, cim, tiles)
    got = _emulate_readout(tiles, n, psi, cre, cim, txs, tzs)
    scale = float((cre.abs() + cim.abs()).sum())  # each |<psi|P|psi>| <= |psi|^2 = 1.69
    assert abs(float(got[0] - ref[0])) <= RTOL * scale
    assert abs(float(got[2] - ref[2])) <= RTOL * float(ref[2])
    assert torch.equal(K.expectation_norm_f64_tiles(psi, txs, tzs, cre, cim, tiles), ref)  # CPU
    return tiles


# -- H psi's tile walk ---------------------------------------------------------------------------


def _emulate_apply(tiles, n, psi, cre, cim, xs, zs, scale):
    """happly64_tiles_kernel on a complex128 psi from the layout's tables,
    one launch per tile: thread tid's register slot r is tile slot tid | r
    << (k - 3) at flat index outer | deposit(t >> c, hi) | (t & low); an
    item's table holds C[j] (its terms' coefficients, by input index,
    signed by (-1)^popc(j & d)) and -C[j] at j | 16, slot r of thread tid
    reads the entry (jb(tid) | s << 4) ^ er(r) (er from item_ehi's entries
    1-3, the top 3 tile bits), the last item of a run of one x multiplies
    the summed entries by the tile at the slot XOR item_xa; a tile's
    diagonal is the Walsh-Hadamard transform of its spectrum.  The first
    tile stores its sum, later ones add it; the last takes E = sum Re
    conj(psi) h and N from the unscaled h, then stores scale h.  Spilled
    terms through the per-term kernel's plain version, added last.
    Returns (out, [E, 0, N, 0])."""
    k, c = tiles.k, tiles.c
    hb = k - TOP
    tid, r = torch.arange(1 << hb), torch.arange(1 << TOP)
    t = tid[:, None] | (r[None, :] << hb)  # (thread, register) tile slots
    low = (1 << c) - 1
    j16 = torch.arange(16)
    had = _sign(j16[:, None] & j16[None, :]).to(torch.complex128)
    coeffs = torch.complex(cre, cim)
    out = torch.zeros_like(psi)
    e = nn = None
    for rt in range(tiles.n_tiles):
        mask = int(tiles.tile_mask[rt])
        outer = _deposit(torch.arange(1 << (n - k)), _positions(((1 << n) - 1) & ~mask))
        g = outer[:, None, None] | _deposit(t >> c, _positions(mask & ~low))[None] | (t & low)[None]
        sp = torch.zeros((outer.numel(), 1 << k), dtype=psi.dtype)
        sp[:, t.reshape(-1)] = psi[g].reshape(outer.numel(), -1)
        acc = torch.zeros(g.shape, dtype=psi.dtype)
        coef = torch.zeros(g.shape, dtype=psi.dtype)
        d0, d1 = int(tiles.tile_diag[rt]), int(tiles.tile_diag[rt + 1])
        if d1 > d0:
            spec = torch.zeros((outer.numel(), 1 << k), dtype=psi.dtype)
            for q in range(d0, d1):
                span = slice(int(tiles.diag_start[q]), int(tiles.diag_start[q + 1]))
                zout = torch.as_tensor(tiles.diag_zout[span].astype(np.int64))
                terms = torch.as_tensor(tiles.diag_term[span].astype(np.int64))
                spec[:, int(tiles.diag_zin[q])] = (_sign(outer[:, None] & zout[None, :])
                                                   * coeffs[terms][None, :]).sum(1)
            for b in range(k):
                spec = spec.reshape(outer.numel(), -1, 2, 1 << b)
                lo, up = spec[:, :, 0], spec[:, :, 1]
                spec = torch.stack([lo + up, lo - up], 2)
            acc += spec.reshape(outer.numel(), 1 << k)[:, t] * sp[:, t]
        i0, i1 = int(tiles.tile_items[rt]), int(tiles.tile_items[rt + 1])
        for it in range(i0, i1):
            if d1 > d0 and int(tiles.item_x[it]) == 0:
                continue
            span = slice(int(tiles.item_start[it]), int(tiles.item_start[it + 1]))
            d = torch.as_tensor(tiles.term_d[span].astype(np.int64))
            C = had[:, d] @ coeffs[torch.as_tensor(tiles.order[span])]
            jt, zt = int(tiles.item_jt[it]), int(tiles.item_zt[it])
            ehi, zo = int(tiles.item_ehi[it]), int(tiles.item_zout[it])
            jb = sum(((tid >> (jt >> (4 * m) & 15)) & 1) << m for m in range(4))
            er = torch.zeros(1 << TOP, dtype=torch.int64)
            for b in range(TOP):  # the top 3 tile bits: item_ehi's entries 1-3
                er ^= ((r >> b) & 1) * (ehi >> (5 * (b + streaming.APPLY_TOP_BITS - TOP)) & 31)
            flips = parity(tid & zt)[None, :, None] ^ parity(outer & zo)[:, None, None]
            idx = (jb[None, :, None] | flips << 4) ^ er[None, None, :]
            coef += torch.cat([C, -C])[idx]
            xa = int(tiles.item_xa[it])
            if it + 1 == i1 or int(tiles.item_xa[it + 1]) != xa:
                acc += coef * sp[:, t ^ xa]
                coef.zero_()
        h = acc if rt == 0 else out[g] + acc
        if rt == tiles.n_tiles - 1:
            a = sp[:, t]
            e = (a.conj() * h).real.sum()
            nn = (a.real ** 2 + a.imag ** 2).sum()
            h = scale * h
        out[g] = h
    if tiles.spill_index.size:
        idx = K._spill64(tiles, psi.device)[0]
        hs, st = K.happly64_plain(psi, xs[idx], zs[idx], cre[idx], cim[idx], scale)
        out += hs
        e = e + st[0]
    zero = torch.zeros((), dtype=torch.float64)
    return out, torch.stack([e, zero, nn, zero])


def _check_apply(xs, zs, cvals, n, k, c, rng, spill, scale=2.0):
    tiles = streaming.GroupTiles(xs, zs, n, k, c)
    assert bool(tiles.spill_index.size) == spill and tiles.n_tiles >= 1
    psi = torch.as_tensor(_state(rng, n))
    txs, tzs, cre, cim = _as(np.asarray(xs, np.int64), np.asarray(zs, np.int64), cvals.real,
                             cvals.imag)
    ref, st_ref = K.happly64_tiles_plain(psi, txs, tzs, cre, cim, tiles, scale)
    got, st = _emulate_apply(tiles, n, psi, cre, cim, txs, tzs, scale)
    assert torch.linalg.vector_norm(got - ref) <= RTOL * torch.linalg.vector_norm(ref)
    assert abs(float(st[0] - st_ref[0])) <= RTOL * float(torch.linalg.vector_norm(ref)) * 1.3
    assert abs(float(st[2] - st_ref[2])) <= RTOL * float(st_ref[2])
    out, st_cpu = K.happly64_tiles(psi, txs, tzs, cre, cim, tiles, scale)  # CPU: plain
    assert torch.equal(out, ref) and torch.equal(st_cpu, st_ref)
    return tiles


# -- the layouts ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def h_lists():
    return {name: HubbardProblem(*args).observables["H"]._scan_terms()
            for name, args in (("2x3", ARGS_2X3), ("3x3", ARGS_3X3), ("2x6", ARGS_2X6))}


@pytest.mark.parametrize("seed", [0, 1])
def test_layouts_hold_every_term_once(seed, h_lists):
    """Random lists (seed 1 with a spilled mask) and the Hubbard H: each
    input term in exactly one item, on the readout's diagonal, or spilled;
    the application layout's diagonals hold only its x = 0 items' terms."""
    rng = np.random.default_rng(40 + seed)
    xs, zs, _ = _random_terms(rng, 12, 80, spill=bool(seed))
    cases = [(xs, zs, 12)] + [(np.asarray(h[0], np.int64), np.asarray(h[1], np.int64), n)
                              for h, n in ((h_lists["2x3"], 12), (h_lists["3x3"], 18))]
    for xs, zs, n in cases:
        for k, c in ((9, 2), (12, 2)):
            rd = _readout_layout(xs, zs, n, k, c)
            rows = int(rd.item_start[-1])
            assert rd.order.size - rows == rd.n_diag
            assert (xs[rd.order[:rows]] != 0).all() and (xs[rd.order[rows:]] == 0).all()
            every = np.concatenate([rd.order, rd.spill_index])
            assert sorted(every.tolist()) == list(range(len(xs)))
            ap = streaming.GroupTiles(xs, zs, n, k, c)
            every = np.concatenate([ap.order, ap.spill_index])
            assert sorted(every.tolist()) == list(range(len(xs)))
            items_x0 = {int(i) for it in range(ap.n_items) if ap.item_x[it] == 0
                        for i in ap.order[ap.item_start[it]:ap.item_start[it + 1]]}
            assert set(ap.diag_term.tolist()) <= items_x0
            assert np.array_equal(xs[ap.spill_index], ap.spill_xs)


def test_coefficient_planes_are_the_float64_inputs(h_lists):
    """The planes the float64 tile kernels read: float64 inputs as they are
    (the same storage, every bit), float32 widened exactly; the readout's
    layout and the polish program's H carry the observables' float64
    coefficients bit for bit."""
    psi = torch.zeros(1 << 12, dtype=torch.complex64)
    c = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 7)))
    re, im = K._f64_planes(psi, c[0], c[1], 7, "test")
    assert re.data_ptr() == c[0].data_ptr() and im.data_ptr() == c[1].data_ptr()
    c32 = c.to(torch.float32)
    re, im = K._f64_planes(psi, c32[0], c32[1], 7, "test")
    assert re.dtype == torch.float64 and torch.equal(re, c32[0].double())
    with pytest.raises(TypeError):
        K._f64_planes(psi, c[0].to(torch.float16), c[1], 7, "test")

    problem = HubbardProblem(*ARGS_2X3)
    obs = problem.observables["H"]
    xs, zs, cre, cim = obs._scan_terms()
    lx, lz, lre, lim, tiles = f64_layout(obs, torch.device("cpu"))
    assert lre.dtype == lim.dtype == torch.float64
    assert np.array_equal(lre.numpy().view(np.int64), np.asarray(cre, np.float64).view(np.int64))
    assert np.array_equal(lim.numpy().view(np.int64), np.asarray(cim, np.float64).view(np.int64))
    assert f64_layout(obs, torch.device("cpu"))[4] is tiles  # built once
    prog = Rot64Program(12, _one_rotation(), (xs, zs, cre, cim), 1, device="cpu")
    hre, him = prog.h_arrays("tiles")[2:]  # the tile route's planes, in input order
    assert hre.dtype == torch.float64 and np.array_equal(hre.numpy(), np.asarray(cre))
    assert np.array_equal(him.numpy(), np.asarray(cim))


def _one_rotation():
    return dict(xb=np.array([0b11], np.uint32), zb=np.array([0], np.uint32),
                scale=np.array([0.5]), pidx=np.array([0], np.int32), phre=np.array([1.0]),
                phim=np.array([0.0]))


# -- the emulations ------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_readout_emulation_random_terms(seed):
    """12 qubits, tiles of 9 bits (the low 2): several tiles, item slices, a
    diagonal whose phase masks leave its tile; seeds 1 and 2 add a mask
    that fits no tile (the per-term readout takes it)."""
    rng = np.random.default_rng(50 + seed)
    xs, zs, c = _random_terms(rng, 12, 120, spill=seed > 0)
    tiles = _check_readout(xs, zs, c, 12, 9, 2, rng, spill=seed > 0)
    assert tiles.n_tiles > 1 and tiles.n_diag >= 30 and tiles.idiag_zout.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_emulation_random_terms(seed):
    """12 qubits, tiles of 9 bits: several tiles, x = 0 items as a tile's
    diagonal; seeds 1 and 2 add a mask that fits no tile (the per-term H
    psi takes it)."""
    rng = np.random.default_rng(60 + seed)
    xs, zs, c = _random_terms(rng, 12, 80, spill=seed > 0)
    tiles = _check_apply(xs, zs, c, 12, 9, 2, rng, spill=seed > 0)
    assert tiles.n_tiles > 1 and tiles.diag_zin.size


@pytest.mark.parametrize("lattice,n,shapes", [("2x3", 12, ((12, 2), (9, 2))),
                                              ("3x3", 18, ((12, 2),))])
def test_readout_emulation_hubbard(h_lists, lattice, n, shapes):
    xs, zs, cre, cim = h_lists[lattice]
    for k, c in shapes:
        _check_readout(np.asarray(xs, np.int64), np.asarray(zs, np.int64),
                       np.asarray(cre) + 1j * np.asarray(cim), n, k, c,
                       np.random.default_rng(n + k), spill=False)


@pytest.mark.parametrize("lattice,n,shapes", [("2x3", 12, ((11, 2), (9, 2))),
                                              ("3x3", 18, ((11, 2),))])
def test_apply_emulation_hubbard(h_lists, lattice, n, shapes):
    xs, zs, cre, cim = h_lists[lattice]
    for k, c in shapes:
        _check_apply(np.asarray(xs, np.int64), np.asarray(zs, np.int64),
                     np.asarray(cre) + 1j * np.asarray(cim), n, k, c,
                     np.random.default_rng(n + k), spill=False)


# -- against the JAX package -------------------------------------------------------------------


def test_readout_tiles_against_jax_double_float():
    """The readout's tile walk on the shipped layout (one tile position of
    12 bits, the 2x3 H) and the port's ``expectation_norm_df`` against the
    JAX double-float readout on the same float32 planes, Rayleigh quotient
    within 1e-12 relative."""
    n = 12
    problem = HubbardProblem(*ARGS_2X3)
    obs = problem.observables["H"]
    psi = _state(np.random.default_rng(7), n, np.complex64)
    xs, zs, cre, cim, tiles = f64_layout(obs, torch.device("cpu"))
    assert (tiles.k, tiles.c) == (streaming.INNER64_TILE_BITS, streaming.INNER64_TILE_LOW_BITS)
    got = _emulate_readout(tiles, n, torch.as_tensor(psi), cre, cim, xs.long(), zs.long())
    port = expectation_norm_df(torch.as_tensor(psi), n, obs)
    reim = np.stack([psi.real, psi.imag]).astype(np.float32)
    op = obs.op
    jop = JaxPauliSum(op.x, op.z, op.c)
    ref = combine_rayleigh(np.asarray(jax_dfloat.expectation_norm_df(jnp.asarray(reim), n, jop)))
    for val in (combine_rayleigh(got.numpy()), combine_rayleigh(port.numpy())):
        assert abs(val - ref) <= JAX_RTOL * abs(ref)


@pytest.mark.skipif(not jax_statevec.available(),
                    reason="the JAX package's native statevec64 engine is unavailable")
@pytest.mark.parametrize("lattice", ["2x3", "3x3"])
def test_apply_tiles_against_jax_native_engine(h_lists, lattice):
    """H psi (the tile walk on the polish program's shipped H layout, and
    ``Rot64Program.h_apply``) and E (the walk's, before the scale of 2 that
    value_and_grad asks for) against the JAX host engine on the same
    program, state and angles, within 1e-12."""
    n = {"2x3": 12, "3x3": 18}[lattice]
    h = h_lists[lattice]
    rng = np.random.default_rng(11)
    seg = dict(xb=np.array([0b11, 0b1100, 0], np.uint32),
               zb=np.array([0, 0b100, 0b101], np.uint32), scale=np.array([0.5, -0.25, 0.3]),
               pidx=np.array([0, 1, -1], np.int32), phre=np.array([1.0, 0.0, 1.0]),
               phim=np.array([0.0, 1.0, 0.0]))
    jax_prog = jax_statevec.Rot64Program(n, seg, h, 2)
    prog = Rot64Program(n, seg, h, 2, device="cpu")
    assert prog.h_route == ("tiles" if n >= K.F64_TILE_MIN_QUBITS["happly64_tiles"] else "terms")
    tiles = streaming.apply64_layout(prog.hx, prog.hz, n)
    assert not tiles.spill_index.size
    th, psi0 = rng.normal(size=2), _state(rng, n)
    psi = jax_prog.apply(th, psi0)
    ref = jax_prog.h_apply(psi)
    xs, zs, cre, cim = prog.h_arrays("tiles")
    out, st = _emulate_apply(tiles, n, torch.as_tensor(psi), cre, cim, xs.long(), zs.long(), 2.0)
    assert np.linalg.norm(out.numpy() / 2.0 - ref) <= JAX_RTOL * np.linalg.norm(ref)
    assert np.linalg.norm(prog.h_apply(psi).numpy() - ref) <= JAX_RTOL * np.linalg.norm(ref)
    e_ref = jax_prog.energy(th, psi0)
    assert abs(float(st[0]) - e_ref) <= JAX_RTOL * max(1.0, abs(e_ref))
    assert abs(float(st[2]) - float(np.vdot(psi, psi).real)) <= JAX_RTOL
    assert abs(prog.energy(th, psi0) - e_ref) <= JAX_RTOL * max(1.0, abs(e_ref))


# -- the routes and the shipped counts ----------------------------------------------------------


def test_routes_follow_the_layout():
    obs8 = HubbardProblem(2, 2, 1.0, 4.0, 4, 2, 2).observables["H"]
    obs12 = HubbardProblem(*ARGS_2X3).observables["H"]
    assert K.F64_TILE_MIN_QUBITS == {"expectation_norm_f64_tiles": 9, "happly64_tiles": 18}
    assert f64_route(obs8, "cpu") == "terms" and f64_route(obs12, "cpu") == "tiles"
    for kernel, n in K.F64_TILE_MIN_QUBITS.items():  # no layout built under the threshold
        assert K.f64_tile_layout(kernel, n - 1, lambda: pytest.fail(kernel)) is None
    h18 = HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4).observables["H"]._scan_terms()
    for n, h in ((8, obs8._scan_terms()), (12, obs12._scan_terms())):
        prog = Rot64Program(n, _one_rotation(), h, 1, device="cpu")
        assert prog.h_route == "terms" and prog.h_tiles is None
        assert prog.h_launches() == {"happly64": 1}
        assert np.all(np.diff(prog.h_args[0].numpy()) >= 0)  # the per-term kernel's order
    prog = Rot64Program(18, _one_rotation(), h18, 1, device="cpu")
    assert prog.h_route == "tiles" and prog.h_tiles.k == 11
    assert prog.h_launches() == {"happly64_tiles": prog.h_tiles.n_tiles}  # one launch a tile
    # an H with a spilled mask: the tiles and one per-term launch
    rng = np.random.default_rng(5)
    xs, zs, c = _random_terms(rng, 18, 40, spill=True)
    prog = Rot64Program(18, _one_rotation(), (xs.astype(np.uint32), zs.astype(np.uint32),
                                              c.real, c.imag), 1, device="cpu")
    assert prog.h_route == "tiles" and prog.h_tiles.spill_index.size == 3
    assert prog.h_launches() == {"happly64_tiles": prog.h_tiles.n_tiles, "happly64": 1}
    psi = torch.as_tensor(_state(rng, 18))
    ref = K.pauli_apply_plain(psi, *_as(xs, zs, c.real, c.imag))
    assert torch.linalg.vector_norm(prog.h_apply(psi) - ref) <= RTOL * torch.linalg.vector_norm(ref)


@pytest.mark.parametrize("lattice,n,readout,apply", [
    ("3x3", 18, (2, 36, 28), (11, 2, 56, [39, 17])),
    ("2x6", 24, (3, 36, 37), (12, 3, 65, [43, 14, 8])),
])
def test_shipped_layout_counts(h_lists, lattice, n, readout, apply):
    """The readout's tiles, items and diagonal terms at 12 / 2 and H psi's
    tile bits, tiles, items and items a tile (``apply64_layout``: 11 / 2 to
    18 qubits, 12 / 2 above; the launches of one H psi)."""
    xs, zs = (np.asarray(a, np.int64) for a in h_lists[lattice][:2])
    rd = _readout_layout(xs, zs, n, streaming.INNER64_TILE_BITS, streaming.INNER64_TILE_LOW_BITS)
    assert (rd.n_tiles, rd.n_items, rd.n_diag) == readout and not rd.spill_index.size
    ap = streaming.apply64_layout(xs, zs, n)
    assert ap.c == streaming.APPLY64_TILE_LOW_BITS
    assert (ap.k, ap.n_tiles, ap.n_items, np.diff(ap.tile_items).tolist()) == apply
    assert not ap.spill_index.size and ap.diag_zin.size
