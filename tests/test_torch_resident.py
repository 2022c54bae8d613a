"""The resident route (the 18-qubit rotations and adjoint sweep: a span of
tile runs in one cooperative launch), on the CPU.

* A schedule emulation: the resident kernels' work written out in torch
  from the layout's tables alone, as the persistent grid does it (runs in
  sequence; in each run block b takes tiles b, b + G, ... with G smaller
  than the tiles of a run; the outer signs set per tile; the adjoint's
  per-warp shares summed per tile into partials[t, tile], then each
  term's row summed as a warp does), against the sequential plain
  versions at complex128 within 1e-10.  Random 12-qubit programs with
  tiles of 6-8 bits, and the 2x3 ADAPT segment both ways.
* The resident route through ``rotate_segment`` / ``adjoint_sweep`` (the
  wrappers' plain versions on the CPU) against ``pauli_chain_pallas`` /
  ``adjoint_chain_pallas`` in interpret mode at n = 10 and 12, complex64,
  with the tolerances of ``tests/test_torch_kernels.py`` (1e-5 relative:
  float32 rounding) and the resident tile shape patched down to 6 bits.
* A recording ``Impl``: up to the chain cap the engine makes one resident
  call per span of tile runs and a per-term call only for terms that fit
  no tile.
* The 3x3 layouts at the shipped resident shape, pinned: runs of the
  467-term bench segment and of the 371-term Givens network each way.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.engine.pallas_kernels import HAVE_PALLAS, adjoint_chain_pallas, pauli_chain_pallas
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.compiled import (
    CompiledCircuit,
    Segment,
    adjoint_sweep,
    rotate_segment,
    run_rot_adjoint,
    run_segments,
)
from qsfh_torch.engine.state import parity

pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")

RTOL32 = 1e-5
TOL64 = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _state(rng, n, dtype=np.complex128):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v)).astype(dtype)


def _random_program(rng, n, T, wide=()):
    """Terms whose flip masks have 0-4 bits anywhere (the Hubbard shapes);
    the terms at ``wide`` flip 5 bits (they fit no tile)."""
    xs = np.zeros(T, np.int64)
    for t in range(T):
        size = 5 if t in wide else rng.choice([0, 1, 2, 2, 4])
        xs[t] = sum(1 << int(b) for b in rng.choice(n, size=size, replace=False))
    zs = rng.integers(0, 1 << n, size=T)
    ph = np.array([(-1j) ** (bin(int(x) & int(z)).count("1") % 4) for x, z in zip(xs, zs)])
    return xs, zs, rng.uniform(-1.5, 1.5, size=T), ph


def _resident_shape(monkeypatch, k=6, c=2):
    monkeypatch.setattr(streaming, "RESIDENT_TILE_BITS", k)
    monkeypatch.setattr(streaming, "RESIDENT_TILE_LOW_BITS", c)


# -- the schedule emulation ---------------------------------------------------------------


def _positions(mask):
    return [b for b in range(int(mask).bit_length()) if int(mask) >> b & 1]


def _deposit(v, positions):
    out = torch.zeros_like(v)
    for j, p in enumerate(positions):
        out |= ((v >> j) & 1) << p
    return out


def _warp_sum(values):
    """A row summed as a warp does: lane l adds entries l, l + 32, ... in
    order, then the lanes fold by XOR over 16, 8, 4, 2, 1."""
    acc = [sum(values[lane::32], torch.zeros((), dtype=values.dtype)) for lane in range(32)]
    for off in (16, 8, 4, 2, 1):
        acc = [acc[lane] + acc[lane ^ off] for lane in range(32)]
    return acc[0]


def _emulate_resident(tiles, n, G, psi, lam, angles, phre, phim, adjoint):
    """The resident kernels' schedule on (psi, lam) from the layout's tables,
    with G blocks; returns the adjoint's v (empty for a rotation)."""
    k, c = tiles.k, tiles.c
    n_tiles, threads = 1 << (n - k), 1 << (k - 4)
    assert G < n_tiles
    j = torch.arange(16)
    slots = torch.arange(1 << k)
    low = (1 << c) - 1
    partials = torch.zeros((tiles.n_terms, n_tiles), dtype=psi.dtype)
    for r in range(len(tiles)):  # runs in sequence: a grid barrier between them
        mask = int(tiles.run_mask[r])
        local = _deposit(slots >> c, _positions(mask & ~low)) | (slots & low)
        rest = _positions(((1 << n) - 1) & ~mask)
        t0 = int(tiles.run_start[r])
        for b in range(G):
            for o in range(b, n_tiles, G):
                outer = int(_deposit(torch.tensor(o), rest))  # the outer signs of this tile
                addr = outer | local
                states = [psi[addr]] + ([lam[addr]] if adjoint else [])
                for g in range(tiles.run_group[r], tiles.run_group[r + 1]):
                    regs = [(int(tiles.group_regs[g]) >> (4 * q)) & 15 for q in range(4)]
                    base = torch.arange(threads)
                    for p in regs:  # ascending: a zero bit inserted at each
                        base = ((base >> p) << (p + 1)) | (base & ((1 << p) - 1))
                    slot = base[:, None] | _deposit(j, regs)[None, :]  # (threads, 16)
                    regs_v = [s[slot] for s in states]
                    for t in range(tiles.group_start[g], tiles.group_start[g + 1]):
                        code = int(tiles.code[t])
                        odd = (parity(torch.tensor(outer & int(tiles.z_out[t])))
                               ^ parity(base & int(tiles.z_tile[t]))[:, None]
                               ^ parity(j & ((code >> 4) & 15))[None, :])
                        sign = 1.0 - 2.0 * odd.to(torch.float64)
                        ph = complex(phre[t], phim[t])
                        cs, sn = np.cos(float(angles[t])), np.sin(float(angles[t]))
                        moved = [sign * s[:, j ^ (code & 15)] for s in regs_v]
                        if adjoint:
                            share = (regs_v[1].conj() * moved[0]).sum(1)  # per thread
                            warps = [share[w:w + 32].sum() for w in range(0, threads, 32)]
                            partials[t, o] = ph * sum(warps, torch.zeros((), dtype=psi.dtype))
                            regs_v = [cs * s + 1j * sn * ph * m for s, m in zip(regs_v, moved)]
                        else:
                            regs_v = [cs * regs_v[0] - 1j * sn * ph * moved[0]]
                    for s, rv in zip(states, regs_v):
                        s[slot] = rv
                psi[addr] = states[0]
                if adjoint:
                    lam[addr] = states[1]
        assert t0 == int(tiles.group_start[tiles.run_group[r]])
    if not adjoint:
        return torch.zeros(0, dtype=psi.dtype)
    return torch.stack([_warp_sum(partials[t]) for t in range(tiles.n_terms)])


def _check_schedule(xs, zs, angles, ph, n, k, c, G, rng):
    layout = streaming.TileLayout(xs, zs, n, k, c)
    assert layout.n_single == 0 and len(layout.spans) == 1 and layout.n_runs > 2
    (tiles, _, _), = layout.spans
    assert len({int(m) for m in tiles.run_mask}) > 1  # the bit sets vary from run to run
    args = [torch.as_tensor(np.ascontiguousarray(a)) for a in (xs, zs, angles, ph.real, ph.imag)]
    psi, lam = (torch.as_tensor(_state(rng, n)) for _ in range(2))
    ref = K.pauli_rotation_plain(psi.clone(), *args)
    rp, rl = psi.clone(), lam.clone()
    rv = K.adjoint_rotation_plain(rp, rl, *args)
    got, gp, gl = psi.clone(), psi.clone(), lam.clone()
    _emulate_resident(tiles, n, G, got, None, *args[2:], adjoint=False)
    gv = _emulate_resident(tiles, n, G, gp, gl, *args[2:], adjoint=True)
    assert _rel(got.numpy(), ref.numpy()) <= TOL64
    assert _rel(gp.numpy(), rp.numpy()) <= TOL64
    assert _rel(gl.numpy(), rl.numpy()) <= TOL64
    assert _rel(gv.numpy(), rv.numpy()) <= TOL64


@pytest.mark.parametrize("seed,k,c,G", [(0, 6, 2, 5), (1, 7, 3, 3), (2, 8, 2, 3)])
def test_schedule_emulation_random_programs(seed, k, c, G):
    rng = np.random.default_rng(60 + seed)
    xs, zs, angles, ph = _random_program(rng, 12, 40)
    _check_schedule(xs, zs, angles, ph, 12, k, c, G, rng)


@pytest.fixture(scope="module")
def adapt_2x3(tmp_path_factory):
    return ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=3,
                 n_electrons=6, n_spin_up=3, n_spin_down=3, tunneling=1, coulomb=6,
                 ground_truth=False, plot=False, log_metrics=False, device="cpu",
                 results_root=str(tmp_path_factory.mktemp("r23")))


@pytest.mark.parametrize("direction", [1, -1])
def test_schedule_emulation_adapt_2x3_segment(adapt_2x3, direction):
    """The 2x3 ADAPT rot segment (first 6 pool operators and the Givens
    network, 12 qubits), forward and reversed as the engine walks it, on
    tiles of 8 bits and 5 blocks."""
    a = adapt_2x3
    d = CompiledCircuit(a._ansatz_ops(range(6)) + a._net_ops, a.n_qubits).segments[0].data
    rng = np.random.default_rng(8)
    angles = np.append(rng.uniform(-1, 1, size=6), 1.0)[d["pidx"]] * d["scale"]
    step = slice(None, None, direction)
    _check_schedule(d["xb"].astype(np.int64)[step], d["zb"].astype(np.int64)[step],
                    angles[step], (d["phre"] + 1j * d["phim"])[step], a.n_qubits, 8, 3, 5, rng)


# -- the resident route against the Pallas chain kernels -------------------------------------


def _segment(xs, zs, ph, scale):
    """A segment with one parameter per term."""
    return Segment("rot", dict(xb=xs.astype(np.uint32), zb=zs.astype(np.uint32), scale=scale,
                               pidx=np.arange(len(xs), dtype=np.int32), phre=ph.real,
                               phim=ph.imag))


@pallas
@pytest.mark.parametrize("n", [10, 12])
def test_resident_route_vs_pauli_chain_pallas(n, monkeypatch):
    """rotate_segment on the resident route, forward and inverse, against
    pauli_chain_pallas on the same terms (and the reversed terms with
    negated angles); one term flips 5 bits and takes the per-term kernel."""
    _resident_shape(monkeypatch)
    rng = np.random.default_rng(110 + n)
    xs, zs, _, ph = _random_program(rng, n, 24, wide=(13,))
    ang = rng.uniform(-1.5, 1.5, size=24).astype(np.float32)
    psi = _state(rng, n, np.complex64)
    seg = _segment(xs, zs, ph, np.ones(24))
    layout = seg.tiles(1, n, 6, 2)
    assert layout.n_single == 1 and layout.n_runs > 2
    for direction in (1, -1):
        step = slice(None, None, direction)
        ref = pauli_chain_pallas(jnp.asarray(psi), n, jnp.asarray(xs[step], jnp.uint32),
                                 jnp.asarray(zs[step], jnp.uint32),
                                 jnp.asarray(direction * ang[step]),
                                 jnp.asarray(ph.real[step], jnp.float32),
                                 jnp.asarray(ph.imag[step], jnp.float32))
        got = run_segments([seg], torch.as_tensor(psi), torch.as_tensor(ang), n,
                           direction=direction)
        assert got.dtype == torch.complex64
        assert _rel(got.numpy(), ref) <= RTOL32


@pallas
@pytest.mark.parametrize("n", [10, 12])
def test_resident_route_vs_adjoint_chain_pallas(n, monkeypatch):
    """adjoint_sweep on the resident route (through run_rot_adjoint, one
    parameter per term) against adjoint_chain_pallas on the reversed terms:
    psi0, lambda0 and every per-term contribution."""
    _resident_shape(monkeypatch)
    rng = np.random.default_rng(510 + n)
    xs, zs, _, ph = _random_program(rng, n, 24, wide=(7,))
    ang = rng.uniform(-1.5, 1.5, size=24).astype(np.float32)
    scale = rng.uniform(-1, 1, size=24).astype(np.float32)
    psi, lam = _state(rng, n, np.complex64), _state(rng, n, np.complex64)
    rev = slice(None, None, -1)
    rpsi, rlam, rcontrib = adjoint_chain_pallas(
        jnp.asarray(psi), jnp.asarray(lam), n, jnp.asarray(xs[rev], jnp.uint32),
        jnp.asarray(zs[rev], jnp.uint32), jnp.asarray(ang[rev] * scale[rev]),
        jnp.asarray(scale[rev]), jnp.asarray(ph.real[rev], jnp.float32),
        jnp.asarray(ph.imag[rev], jnp.float32))
    seg = _segment(xs, zs, ph, scale.astype(np.float64))
    assert seg.tiles(-1, n, 6, 2).n_single == 1
    gpsi, glam, grads = run_rot_adjoint(seg, torch.as_tensor(psi), torch.as_tensor(lam),
                                        torch.as_tensor(ang), n)
    assert _rel(gpsi.numpy(), rpsi) <= RTOL32
    assert _rel(glam.numpy(), rlam) <= RTOL32
    assert _rel(grads.numpy()[::-1], rcontrib) <= RTOL32


# -- which wrappers the engine calls -----------------------------------------------------------


def _recording():
    calls = []

    def recorded(name):
        fn = getattr(K.PLAIN, name)
        return lambda *args: calls.append(name) or fn(*args)

    impl = K.Impl(*(recorded(f.name) for f in dataclasses.fields(K.Impl)))
    return impl, calls


@pytest.mark.parametrize("wide", [(), (9,), (0, 30)])
def test_engine_calls_one_resident_launch_per_span(wide, monkeypatch):
    """Up to the chain cap: one resident call per span of tile runs, each
    forward, inverse and adjoint; the per-term kernels only for terms that
    fit no tile."""
    _resident_shape(monkeypatch)
    n = 12
    rng = np.random.default_rng(70 + len(wide))
    xs, zs, angles, ph = _random_program(rng, n, 32, wide=wide)
    seg = _segment(xs, zs, ph, np.ones(32))
    arrs = [torch.as_tensor(np.ascontiguousarray(a)) for a in (xs, zs, angles, ph.real, ph.imag)]
    rev = [a.flip(0) for a in arrs]
    psi, lam = (torch.as_tensor(_state(rng, n)) for _ in range(2))
    impl, calls = _recording()
    rotate_segment(seg, psi.clone(), arrs, n, 1, impl)
    rotate_segment(seg, psi.clone(), rev, n, -1, impl)
    v = adjoint_sweep(seg, psi.clone(), lam.clone(), rev, n, impl)
    assert v.shape == (32,)
    spans = sum(sum(t is not None for t, _, _ in seg.tiles(d, n, 6, 2).spans) for d in (1, -1, -1))
    assert calls.count("rotation_resident") + calls.count("adjoint_resident") == spans
    assert calls.count("adjoint_resident") == sum(t is not None
                                                 for t, _, _ in seg.tiles(-1, n, 6, 2).spans)
    assert calls.count("rotation") == 2 * len(wide)  # one span per term that fits no tile here
    assert calls.count("adjoint") == len(wide)
    assert not {"rotation_runs", "adjoint_runs"} & set(calls)
    if not wide:
        assert calls == ["rotation_resident", "rotation_resident", "adjoint_resident"]


def test_engine_routes_by_size(monkeypatch):
    """Past the chain cap the tile runs, one call per span; below the
    smallest tile the per-term kernels, one call per segment."""
    _resident_shape(monkeypatch)
    monkeypatch.setattr(streaming, "TILE_BITS", 6)
    monkeypatch.setattr(streaming, "TILE_LOW_BITS", 2)
    for n, cap, want in ((12, 11, "rotation_runs"), (K.TILE_MIN_BITS - 1, 18, "rotation"),
                         (K.TILE_MIN_BITS, 18, "rotation_resident")):
        monkeypatch.setattr(streaming, "CHAIN_MAX_QUBITS", cap)
        rng = np.random.default_rng(n)
        xs, zs, angles, ph = _random_program(rng, n, 16)
        seg = _segment(xs, zs, ph, np.ones(16))
        arrs = [torch.as_tensor(np.ascontiguousarray(a))
                for a in (xs, zs, angles, ph.real, ph.imag)]
        impl, calls = _recording()
        psi = torch.as_tensor(_state(rng, n))
        got = rotate_segment(seg, psi.clone(), arrs, n, 1, impl)
        assert set(calls) == {want}
        assert _rel(got.numpy(), K.pauli_rotation_plain(psi.clone(), *arrs).numpy()) <= TOL64


# -- the 3x3 layouts at the shipped shape -----------------------------------------------------


@pytest.fixture(scope="module")
def segments_3x3(tmp_path_factory):
    a = ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=3, y_dimension=3,
              n_electrons=9, n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path_factory.mktemp("r33")))
    n = a.n_qubits
    seg = CompiledCircuit(a._ansatz_ops(range(12)) + a._net_ops, n).segments[0]
    net = CompiledCircuit(a._net_ops, n).segments[0]
    return n, seg, net


# (k, c) -> runs of the 467-term bench segment forward and reversed, and of
# the 371-term network forward and reversed; every term fits a tile
RUNS_3X3 = {
    (10, 3): (33, 33, 28, 28),
    (10, 4): (33, 33, 28, 28),
    (11, 3): (25, 25, 21, 21),
    (11, 4): (29, 29, 24, 24),
    (12, 3): (21, 21, 18, 18),
    (12, 4): (22, 22, 18, 18),
    (13, 4): (17, 17, 14, 14),
}


@pytest.mark.parametrize("shape", sorted(RUNS_3X3), ids=str)
def test_resident_layout_counts_3x3(segments_3x3, shape):
    n, seg, net = segments_3x3
    assert (n, len(seg), len(net)) == (18, 467, 371)
    k, c = shape
    layouts = [s.tiles(d, n, k, c) for s in (seg, net) for d in (1, -1)]
    assert tuple(lay.n_runs for lay in layouts) == RUNS_3X3[shape]
    for lay in layouts:  # one span each: one resident launch per call
        assert lay.n_single == 0 and len(lay.spans) == 1


def test_shipped_resident_shape_is_pinned():
    assert (streaming.RESIDENT_TILE_BITS, streaming.RESIDENT_TILE_LOW_BITS) in RUNS_3X3
