"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips from inside its fixture where no CUDA
device exists.  Run on a machine with a card (the JAX conftest is not
needed there):

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: ||kernel - plain|| / ||plain|| <= 1e-5 on states and on the
per-term vectors, which is float32 rounding over differently ordered sums.
"""

import gc
import os
import time

import numpy as np
import pytest
import torch

from qsfh_torch.engine import kernels as K

pytestmark = pytest.mark.gpu

RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _terms(rng, n, T):
    """Random flat masks (x = 0 terms included) and unit string phases."""
    xs = rng.integers(0, 1 << n, size=T)
    xs[:: 4] = 0
    zs = rng.integers(0, 1 << n, size=T)
    k = rng.integers(0, 4, size=T)
    ph = (-1j) ** k
    return xs, zs, ph


def _state(rng, n):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _t(a, dev, dtype):
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("n", [10, 18])
def test_pauli_rotation(dev, n):
    rng = np.random.default_rng(n)
    xs, zs, ph = _terms(rng, n, 64)
    ang = rng.uniform(-1, 1, size=64)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    got = K.pauli_rotation(psi.clone(), *args)
    ref = K.pauli_rotation_plain(psi.clone(), *args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n", [10, 18])
def test_pauli_apply(dev, n):
    rng = np.random.default_rng(n + 1)
    xs, zs, _ = _terms(rng, n, 300)
    c = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64),
            _t(c.real, dev, torch.float32), _t(c.imag, dev, torch.float32))
    got = K.pauli_apply(psi, *args)
    ref = K.pauli_apply_plain(psi, *args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n", [10, 18])
def test_pauli_inner(dev, n):
    rng = np.random.default_rng(n + 2)
    xs, zs, _ = _terms(rng, n, 200)
    psi = _t(_state(rng, n), dev, torch.complex64)
    w = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64))
    for a in (psi, w):
        got = K.pauli_inner(a, psi, *args)
        ref = K.pauli_inner_plain(a, psi, *args)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n", [10, 18])
def test_adjoint_rotation(dev, n):
    rng = np.random.default_rng(n + 3)
    xs, zs, ph = _terms(rng, n, 64)
    ang = rng.uniform(-1, 1, size=64)
    psi = _t(_state(rng, n), dev, torch.complex64)
    lam = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    p1, l1 = psi.clone(), lam.clone()
    p2, l2 = psi.clone(), lam.clone()
    got = K.adjoint_rotation(p1, l1, *args)
    ref = K.adjoint_rotation_plain(p2, l2, *args)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL
    assert _rel(p1, p2) <= RTOL
    assert _rel(l1, l2) <= RTOL


def test_launch_counts_and_dtype_guard(dev):
    rng = np.random.default_rng(7)
    n = 10
    xs, zs, ph = _terms(rng, n, 5)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(np.ones(5), dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    K.reset_launch_counts()
    K.pauli_rotation(psi, *args)
    K.pauli_inner(psi, psi, *args[:2])
    assert K.launch_counts()["pauli_rotation"] == 5
    assert K.launch_counts()["pauli_inner"] == 1
    with pytest.raises(TypeError):
        K.pauli_rotation(psi.to(torch.complex128), *args)


def _tile_program(rng, n, T):
    """Random terms with 0-4 flip bits anywhere (the Hubbard shapes), z
    masks on every bit, unit string phases."""
    xs = np.zeros(T, np.int64)
    for t in range(T):
        bits = rng.choice(n, size=rng.choice([0, 1, 2, 2, 4]), replace=False)
        xs[t] = sum(1 << int(b) for b in bits)
    zs = rng.integers(0, 1 << n, size=T)
    ph = (-1j) ** rng.integers(0, 4, size=T)
    return xs, zs, ph


def _walk(layout, tile_fn, term_fn, args):
    """Apply the spans of a tile layout: tile runs to tile_fn, the terms
    that fit no tile to term_fn; returns the per-span results."""
    return [tile_fn(*(a[t0:t1] for a in args), tiles) if tiles is not None
            else term_fn(*(a[t0:t1] for a in args)) for tiles, t0, t1 in layout.spans]


@pytest.mark.parametrize("n,k,c", [(12, 9, 2), (20, 13, 5), (20, 12, 4)])
def test_rotation_tile_runs(dev, n, k, c):
    """rotation_tile_runs against its plain version (and the per-term
    kernel where a term fits no tile), one launch per run."""
    from qsfh_torch.engine.streaming import TileLayout

    rng = np.random.default_rng(n + 4)
    xs, zs, ph = _tile_program(rng, n, 96)
    layout = TileLayout(xs, zs, n, k, c)
    ang = rng.uniform(-1, 1, size=96)
    psi = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    got, ref = psi.clone(), psi.clone()
    K.reset_launch_counts()
    _walk(layout, lambda *a: K.rotation_tile_runs(got, *a),
          lambda *a: K.pauli_rotation(got, *a), args)
    _walk(layout, lambda *a: K.rotation_tile_runs_plain(ref, *a),
          lambda *a: K.pauli_rotation_plain(ref, *a), args)
    torch.cuda.synchronize()
    assert layout.n_runs > 1
    assert K.launch_counts()["rotation_tile_runs"] == layout.n_runs
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("n,k,c", [(12, 9, 2), (20, 12, 5), (20, 13, 4)])
def test_adjoint_tile_runs(dev, n, k, c, monkeypatch):
    """adjoint_tile_runs against its plain version: the per-term vector,
    psi and lambda; a small sweep-partials cap at n = 12 splits the sweep
    into several partial-sum passes."""
    from qsfh_torch.engine.streaming import TileLayout

    rng = np.random.default_rng(n + 5)
    xs, zs, ph = _tile_program(rng, n, 96)
    layout = TileLayout(xs, zs, n, k, c)
    ang = rng.uniform(-1, 1, size=96)
    psi = _t(_state(rng, n), dev, torch.complex64)
    lam = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    if n == 12:
        monkeypatch.setattr(K, "SWEEP_PARTIALS_CAP", 20 << (n - k))
    p1, l1, p2, l2 = psi.clone(), lam.clone(), psi.clone(), lam.clone()
    got = torch.cat(_walk(layout, lambda *a: K.adjoint_tile_runs(p1, l1, *a),
                          lambda *a: K.adjoint_rotation(p1, l1, *a), args))
    ref = torch.cat(_walk(layout, lambda *a: K.adjoint_tile_runs_plain(p2, l2, *a),
                          lambda *a: K.adjoint_rotation_plain(p2, l2, *a), args))
    torch.cuda.synchronize()
    assert _rel(got, ref) <= RTOL
    assert _rel(p1, p2) <= RTOL
    assert _rel(l1, l2) <= RTOL


def _resident_case(dev, n, k, c, seed, T=200):
    """A random program whose terms all fit tiles of (k, c), in at least 20
    runs, on the card: (layout, term arrays, psi, lam)."""
    from qsfh_torch.engine.streaming import TileLayout

    rng = np.random.default_rng(seed)
    xs, zs, ph = _tile_program(rng, n, T)
    layout = TileLayout(xs, zs, n, k, c)
    assert layout.n_single == 0 and len(layout.spans) == 1 and layout.n_runs >= 20
    ang = rng.uniform(-1, 1, size=T)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(ang, dev, torch.float32),
            _t(ph.real, dev, torch.float32), _t(ph.imag, dev, torch.float32))
    psi = _t(_state(rng, n), dev, torch.complex64)
    lam = _t(_state(rng, n), dev, torch.complex64)
    return layout.spans[0][0], args, psi, lam


# (n, k, c, blocks): blocks caps the grid below the tiles of a run, so that a
# block takes several tiles per run (and reads tiles other SMs wrote in the
# run before)
RESIDENT_CASES = [(12, 9, 2, None), (18, 11, 3, None), (18, 11, 3, 7), (18, 10, 4, 40),
                  (18, 12, 4, None), (20, 11, 3, None), (20, 11, 3, 33)]


@pytest.mark.parametrize("n,k,c,blocks", RESIDENT_CASES)
def test_rotation_resident(dev, n, k, c, blocks):
    """rotation_resident against its plain version: one launch per span; a
    second call, and a call on another grid, give the same bits."""
    tiles, args, psi, _ = _resident_case(dev, n, k, c, n + k + 11)
    got, ref = psi.clone(), psi.clone()
    K.reset_launch_counts()
    K.rotation_resident(got, *args, tiles, blocks=blocks)
    K.rotation_resident_plain(ref, *args, tiles)
    torch.cuda.synchronize()
    assert K.launch_counts()["rotation_resident"] == sum(K.launch_counts().values()) == 1
    assert K.resident_grid(psi, tiles, False, blocks) <= 1 << (n - k)
    assert _rel(got, ref) <= RTOL
    for other in (blocks, 3):
        again = K.rotation_resident(psi.clone(), *args, tiles, blocks=other)
        torch.cuda.synchronize()
        assert torch.equal(again, got)


@pytest.mark.parametrize("n,k,c,blocks", RESIDENT_CASES)
def test_adjoint_resident(dev, n, k, c, blocks):
    """adjoint_resident against its plain version (the per-term vector, psi
    and lambda), one launch per span; a second call, and a call on another
    grid, give the same bits."""
    tiles, args, psi, lam = _resident_case(dev, n, k, c, n + k + 12)
    p1, l1, p2, l2 = psi.clone(), lam.clone(), psi.clone(), lam.clone()
    K.reset_launch_counts()
    got = K.adjoint_resident(p1, l1, *args, tiles, blocks=blocks)
    ref = K.adjoint_resident_plain(p2, l2, *args, tiles)
    torch.cuda.synchronize()
    assert K.launch_counts()["adjoint_resident"] == 1
    assert _rel(got, ref) <= RTOL
    assert _rel(p1, p2) <= RTOL
    assert _rel(l1, l2) <= RTOL
    for other in (blocks, 3):
        p3, l3 = psi.clone(), lam.clone()
        again = K.adjoint_resident(p3, l3, *args, tiles, blocks=other)
        torch.cuda.synchronize()
        assert torch.equal(again, got) and torch.equal(p3, p1) and torch.equal(l3, l1)


def test_resident_rejects_what_it_cannot_launch(dev):
    """A resident wrapper raises, and launches nothing, on a layout built
    for other terms or a tile shape the kernel does not take."""
    from qsfh_torch.engine.streaming import TileLayout

    tiles, args, psi, lam = _resident_case(dev, 12, 9, 2, 5)
    K.reset_launch_counts()
    with pytest.raises(ValueError):
        K.rotation_resident(psi, *(a[1:] for a in args), tiles)
    small = TileLayout(np.asarray([0b11]), np.asarray([0]), 12, 6, 2).spans[0][0]
    with pytest.raises(ValueError):
        K.adjoint_resident(psi, lam, *(a[:1] for a in args), small)
    wide = TileLayout(np.asarray([0b11]), np.asarray([0]), 14, 13, 4).spans[0][0]
    psi14 = torch.zeros(1 << 14, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):  # the adjoint kernel takes tiles of 12 bits at most
        K.adjoint_resident(psi14, psi14.clone(), *(a[:1] for a in args), wide)
    assert K.launch_counts()["rotation_resident"] == K.launch_counts()["adjoint_resident"] == 0


# -- fused groups (streaming.fused_groups) ------------------------------------------------


def _segment_arrays(seg, dev, thetas, rdt):
    """A rot segment's term arrays on the card, forward and reversed: the
    masks, each term's angle theta_ext[pidx] * scale, the string phases."""
    d = seg.tensors(dev, rdt, thetas.shape[0])
    ext = torch.cat([thetas.to(device=dev, dtype=rdt), torch.ones(1, dtype=rdt, device=dev)])
    arrs = (d["xb"], d["zb"], ext[d["pidx"]] * d["scale"], d["phre"], d["phim"])
    return arrs, tuple(a.flip(0) for a in arrs)


def _fused_against_plain(dev, seg, n, thetas, rng, unfused=False):
    """The segment forward and its reverse sweep on the engine's route
    (``rotate_segment`` / ``adjoint_sweep``: the resident kernels up to 18
    qubits, the tile runs above) against the per-term plain versions in
    complex128; a second call gives the same bits.  Returns the forward
    layout and the errors (state, per-term vector over its largest entry,
    psi and lam after the sweep); with ``unfused`` also those of the same
    kernels on layouts that fuse nothing (every term alone)."""
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import _tile_route, adjoint_sweep, rotate_segment

    fwd, rev = _segment_arrays(seg, dev, thetas, torch.float32)
    fwd64, rev64 = _segment_arrays(seg, dev, thetas, torch.float64)
    psi = torch.as_tensor(_state(rng, n), device=dev)
    lam = torch.as_tensor(_state(rng, n), device=dev)
    ref = rotate_segment(seg, psi.clone(), fwd64, n, 1, K.PLAIN)
    pr, lr = psi.clone(), lam.clone()
    vr = adjoint_sweep(seg, pr, lr, rev64, n, K.PLAIN)

    def errors(runs):
        got, v, p, l = (a.to(torch.complex128) for a in runs)
        return (_rel(got, ref), float((v - vr).abs().max() / vr.abs().max()), _rel(p, pr),
                _rel(l, lr))

    runs = []
    for _ in range(2):
        p, l = psi.to(torch.complex64), lam.to(torch.complex64)
        got = rotate_segment(seg, p.clone(), fwd, n, 1, K.KERNELS)
        runs.append((got, adjoint_sweep(seg, p, l, rev, n, K.KERNELS), p, l))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    layout, resident = _tile_route(seg, 1, n)
    if not unfused:
        return layout, errors(runs[0])
    d = seg.data
    one = [streaming.TileLayout(d["xb"][::s], d["zb"][::s], n, layout.k, layout.c).spans[0][0]
           for s in (1, -1)]
    rot, adj = ((K.rotation_resident, K.adjoint_resident) if resident
                else (K.rotation_tile_runs, K.adjoint_tile_runs))
    p, l = psi.to(torch.complex64), lam.to(torch.complex64)
    got = rot(p.clone(), *fwd, one[0])
    alone = (got, adj(p, l, *rev, one[1]), p, l)
    torch.cuda.synchronize()
    return layout, errors(runs[0]), errors(alone)


@pytest.mark.parametrize("n", [18, 24])
def test_fused_groups_mixed_program(dev, n):
    """Every shape of fused group (tests/fused_programs.py) and terms alone,
    through the resident kernels at 18 qubits and the tile runs at 24,
    against the per-term plain versions; the same bits twice; the launches
    are those of the fused layouts: one a span (resident) or a run."""
    from fused_programs import mixed_segment

    from qsfh_torch.engine.compiled import _tile_route

    rng = np.random.default_rng(n + 41)
    seg, n_params = mixed_segment(rng, n)
    K.reset_launch_counts()
    layout, errs = _fused_against_plain(dev, seg, n, torch.as_tensor(
        rng.uniform(-1.5, 1.5, n_params)), rng)
    assert 0 < layout.fused_terms < len(seg)
    assert max(errs) <= RTOL
    counts = K.launch_counts()
    for direction, rot, alone in ((1, "rotation", "pauli_rotation"),
                                  (-1, "adjoint", "adjoint_rotation")):  # two calls each way
        fused, resident = _tile_route(seg, direction, n)
        spans = sum(tiles is not None for tiles, _, _ in fused.spans)
        assert resident == (n <= 18)
        if resident:
            assert (counts[f"{rot}_resident"], counts[f"{rot}_tile_runs"]) == (2 * spans, 0)
        else:
            assert (counts[f"{rot}_resident"], counts[f"{rot}_tile_runs"]) == (0, 2 * fused.n_runs)
        assert counts[alone] == 2 * fused.n_single


@pytest.fixture(scope="module")
def checkpoint_3x3():
    """(segment, angles) of the committed 1719-operator 3x3 checkpoint's
    train segment (14,123 terms, 609 resident runs each way)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine.compiled import CompiledCircuit
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a = ADAPT(pool=hubbard_interaction_pool_extended(3, 3), n_epoch=0, threshold1=1e-3,
              threshold2=1e-3, x_dimension=3, y_dimension=3, n_electrons=9, n_spin_up=5,
              n_spin_down=4, tunneling=1, coulomb=6, degenerate_subspace=4, load_model=True,
              plot=False, log_metrics=False, device="cpu",
              results_root=os.path.join(root, "benchmarks", "demo_3x3"))
    seg = CompiledCircuit(a._ansatz_ops(a.selected_indices) + a._net_ops, 18).segments[0]
    return seg, torch.as_tensor(a.params_t.detach().cpu().numpy())


def test_fused_groups_checkpoint_3x3(dev, checkpoint_3x3):
    """The committed 1719-operator 3x3 checkpoint's train segment (14,123
    terms, 13,768 of them in 1,723 fused groups) on the resident kernels
    against the per-term plain versions, at the checkpoint's angles: within
    1e-4 (the chip smoke test's gradient tolerance) and no further off than
    the same kernels with every term alone."""
    from qsfh_torch.engine.compiled import _tile_route

    seg, thetas = checkpoint_3x3
    K.reset_launch_counts()
    layout, errs, alone = _fused_against_plain(dev, seg, 18, thetas, np.random.default_rng(3),
                                               unfused=True)
    assert max(errs) <= 1e-4 and all(e <= e1 for e, e1 in zip(errs, alone))
    counts = K.launch_counts()
    assert counts["rotation_resident"] == counts["adjoint_resident"] == 3
    assert counts["rotation_tile_runs"] == counts["adjoint_tile_runs"] == 0
    for direction in (1, -1):  # the layouts the first two calls took each way
        fused = _tile_route(seg, direction, 18)[0]
        assert fused.fused_terms == 13768 and fused.fused_terms / len(seg) >= 0.95


def test_resident_checkpoint_3x3(dev, checkpoint_3x3):
    """The checkpoint's train segment at the shipped resident layout (one
    span of 609 runs each way, at the checkpoint's angles):
    rotation_resident and adjoint_resident against the plain version in
    complex128, the states within RTOL of their 2-norm and the per-term
    vector within 1e-4 of its largest entry (as the test above: float32
    over 14,123 terms reads ~1.5e-5 there), bit-equal to rotation_tile_runs
    / adjoint_tile_runs over the same layout (the same staging and register
    groups, one launch a run): one launch a sweep, which stages 608 runs a
    run ahead, against 609 of the tile runs."""
    from qsfh_torch.engine.compiled import _tile_route

    seg, thetas = checkpoint_3x3
    fwd, rev = _segment_arrays(seg, dev, thetas, torch.float32)
    fwd64, rev64 = _segment_arrays(seg, dev, thetas, torch.float64)
    (flayout, resident), (alayout, _) = _tile_route(seg, 1, 18), _tile_route(seg, -1, 18)
    assert resident and len(flayout.spans) == len(alayout.spans) == 1
    ftiles, atiles = flayout.spans[0][0], alayout.spans[0][0]
    assert len(ftiles) == len(atiles) == 609
    rng = np.random.default_rng(24)
    psi = torch.as_tensor(_state(rng, 18), device=dev)
    lam = torch.as_tensor(_state(rng, 18), device=dev)
    ref = K.rotation_resident_plain(psi.clone(), *fwd64, ftiles)
    pr, lr = psi.clone(), lam.clone()
    v_ref = K.adjoint_resident_plain(pr, lr, *rev64, atiles)
    p32, l32 = psi.to(torch.complex64), lam.to(torch.complex64)
    K.reset_launch_counts()
    got = K.rotation_resident(p32.clone(), *fwd, ftiles)
    p, l = p32.clone(), l32.clone()
    v = K.adjoint_resident(p, l, *rev, atiles)
    tiled = K.rotation_tile_runs(p32.clone(), *fwd, ftiles)
    tp, tl = p32.clone(), l32.clone()
    tv = K.adjoint_tile_runs(tp, tl, *rev, atiles)
    torch.cuda.synchronize()
    c128 = torch.complex128
    assert _rel(got.to(c128), ref) <= RTOL
    assert float((v.to(c128) - v_ref).abs().max() / v_ref.abs().max()) <= 1e-4
    assert _rel(p.to(c128), pr) <= RTOL and _rel(l.to(c128), lr) <= RTOL
    assert torch.equal(got, tiled)
    assert torch.equal(v, tv) and torch.equal(p, tp) and torch.equal(l, tl)
    counts = K.launch_counts()
    assert counts["rotation_resident"] == counts["adjoint_resident"] == 1
    assert counts["rotation_tile_runs"] == counts["adjoint_tile_runs"] == 609


def test_tile_run_counters_checkpoint_2x6(dev, tmp_path):
    """The committed 2x6 checkpoint (portbench/data/adapt2x6_checkpoint.npz,
    24 qubits) through one forward pass and one adjoint sweep of its train
    step: the tile-run wrappers launch once a run of the layouts (one pass
    of the state each), the resident wrappers never; most of the terms are
    fused."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine.compiled import CompiledCircuit, _tile_route

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = np.load(os.path.join(root, "portbench", "data", "adapt2x6_checkpoint.npz"))
    a = ADAPT(n_epoch=0, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6,
              n_electrons=12, n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=2,
              ground_truth=False, plot=False, log_metrics=False, device=dev,
              results_root=str(tmp_path))
    idx = [int(i) for i in ck["param__selected_indices"]]
    raw = a._build_stages(tuple(idx))
    seg = CompiledCircuit(a._ansatz_ops(idx) + a._net_ops, 24).segments[0]
    fwd, resident = _tile_route(seg, 1, 24)
    adj, _ = _tile_route(seg, -1, 24)
    assert not resident and fwd.n_single == adj.n_single == 0
    th = torch.as_tensor(ck["param__t"], dtype=torch.float32, device=dev)
    K.reset_launch_counts()
    psi = raw["fwd_from"](a._initial_state(), th)
    raw["adjoint"](psi, raw["cotangent"](psi), th)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["rotation_tile_runs"] == fwd.n_runs == fwd.passes
    assert counts["adjoint_tile_runs"] == adj.n_runs == adj.passes
    assert counts["rotation_resident"] == counts["adjoint_resident"] == 0
    # a double excitation is 8 strings in one fused group
    assert fwd.fused_terms == adj.fused_terms >= 8 * len(idx)
    assert fwd.fused_terms / len(seg) >= 0.5


@pytest.mark.parametrize("n", [10, 18])
def test_xor_gather(dev, n):
    rng = np.random.default_rng(n + 7)
    psi = _t(_state(rng, n), dev, torch.complex64)
    for x in (0, 1, 0b110, 1 << (n - 1), int(rng.integers(0, 1 << n))):
        ref = K.xor_gather_plain(psi, x)
        assert torch.equal(K.xor_gather(psi, x), ref)
        assert torch.equal(K.xor_gather(psi, torch.tensor([x], device=dev)), ref)
        assert torch.equal(K.xor_gather(psi, torch.tensor(x, dtype=torch.int32, device=dev)), ref)
    with pytest.raises(TypeError):
        K.xor_gather(psi.to(torch.complex128), 3)


@pytest.mark.parametrize("n", [10, 18])
def test_pauli_rotation_one(dev, n):
    """The out-of-place rotation (``pauli_rotation_out`` through
    ``pauli_rotation_one``) against its plain version: x = 0, x = 1, masks
    with bit 0 clear and set; scalars as numbers and as one-element device
    tensors (int32 and int64 masks, a float32 and a float64 angle); two
    calls give the same bits, psi is untouched, one launch a call."""
    rng = np.random.default_rng(n + 8)
    psi = _t(_state(rng, n), dev, torch.complex64)
    saved = psi.clone()
    for x, z in ((0, 0b1011), (1, 0b110), (0b11, 0b1), (0b1100, 0b101),
                 ((1 << (n - 1)) | 1, 1 << (n - 2)), ((1 << (n - 1)) | 0b110, (1 << n) - 1)):
        ph = (-1j) ** (bin(x & z).count("1") % 4)
        ref = K.pauli_rotation_one_plain(psi, x, z, 0.37, ph.real, ph.imag)
        K.reset_launch_counts()
        got = K.pauli_rotation_one(psi, x, z, 0.37, ph.real, ph.imag)
        again = K.pauli_rotation_one(psi, torch.tensor([x], dtype=torch.int32, device=dev),
                                     torch.tensor(z, device=dev),
                                     torch.tensor([0.37], dtype=torch.float64, device=dev),
                                     torch.tensor(ph.real, dtype=torch.float32, device=dev),
                                     ph.imag)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= RTOL
        assert torch.equal(got, again)
        assert K.launch_counts()["pauli_rotation_out"] == 2
    assert torch.equal(psi, saved)
    with pytest.raises(TypeError):
        K.pauli_rotation_one(psi.to(torch.complex128), 3, 1, 0.1, 1.0, 0.0)
    with pytest.raises(ValueError):
        K.pauli_rotation_out(psi, torch.empty(1 << (n - 1), dtype=psi.dtype, device=dev), 3, 1,
                             0.1, 1.0, 0.0)


def _inner_terms(rng, n, T, wide):
    """T terms on about 40 flip masks of 0-4 bits, one mask with 300 terms
    (more than one tile takes), and ``wide`` terms on a mask of n - 2 bits
    (it fits no tile)."""
    masks = _tile_program(rng, n, 40)[0]
    xs = rng.choice(masks, size=T)
    xs[:300] = masks[1]
    xs[rng.choice(np.arange(300, T), size=wide, replace=False)] = ((1 << n) - 1) ^ 0b101
    return xs, rng.integers(0, 1 << n, size=T)


@pytest.mark.parametrize("n,k,c", [(12, 9, 2), (20, 12, 4), (20, 12, 2), (20, 13, 4)])
def test_pauli_inner_grouped(dev, n, k, c, monkeypatch):
    """The inner-product tile kernel against its plain version: masks that
    fit a tile and masks that fit none (the per-term kernel), a = psi
    (one tile load per position) and a != psi, and a small partials cap,
    so that the tiles go in several launches."""
    from qsfh_torch.engine.streaming import GroupTiles

    rng = np.random.default_rng(n + k + 6)
    xs, zs = _inner_terms(rng, n, 700, wide=5)
    tiles = GroupTiles(xs, zs, n, k, c)
    assert tiles.n_tiles > 1 and tiles.spill_index.size == 5
    psi = _t(_state(rng, n), dev, torch.complex64)
    w = _t(_state(rng, n), dev, torch.complex64)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64))
    positions = tiles.schedule(n, K.sm_count(dev))[0]
    monkeypatch.setattr(K, "PARTIALS_CAP", 64 * -(-(1 << (n - k)) // positions))
    K.reset_launch_counts()
    for a in (psi, w):
        got = K.pauli_inner_grouped(a, psi, *args, tiles)
        ref = K.pauli_inner_plain(a, psi, *args)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= RTOL
    counts = K.launch_counts()
    assert counts["pauli_inner_grouped"] == 2 * len(tiles.chunks(
        -(-(1 << (n - k)) // positions), K.PARTIALS_CAP)) > 2
    assert counts["pauli_inner"] == 2 * len(K._chunks(5, K._load().qsfh_inner_blocks(n)))


# (lattice of the observables, qubits): H and S^2 of a Hubbard model at 10,
# 18 and 24 qubits (1x5, 3x3, 2x6)
APPLY_LATTICES = {10: (1, 5, 1.0, 6.0, 5, 3, 2), 18: (3, 3, 1.0, 6.0, 9, 5, 4),
                  24: (2, 6, 1.0, 6.0, 12, 6, 6)}


@pytest.mark.parametrize("diagonal", [True, False], ids=["diagonal", "items"])
@pytest.mark.parametrize("n", sorted(APPLY_LATTICES))
def test_pauli_apply_grouped(dev, n, diagonal):
    """The application tile kernel against its plain version on H, S^2
    and a random list with masks that fit no tile (the per-term kernel),
    at the shipped tile shape, with the x = 0 terms as a tile's diagonal
    or as items; two calls give the same bits."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.streaming import GroupTiles

    shape = (streaming.INNER_TILE_BITS, streaming.INNER_TILE_LOW_BITS)
    rng = np.random.default_rng(n + 9)
    problem = HubbardProblem(*APPLY_LATTICES[n])
    psi = _t(_state(rng, n), dev, torch.complex64)
    xs, zs = _inner_terms(rng, n, 700, wide=5)
    c = rng.standard_normal(700) + 1j * rng.standard_normal(700)
    cases = [(problem.observables[k], None) for k in ("H", "S^2")] + [(None, (xs, zs, c))]
    for obs, terms in cases:
        if obs is not None:
            txs, tzs, tc = obs._tensors(psi)
            terms = obs._scan_terms()[:2]
        else:
            txs, tzs = _t(terms[0], dev, torch.int64), _t(terms[1], dev, torch.int64)
            tc = _t(terms[2], dev, torch.complex64)
        tiles = GroupTiles(terms[0], terms[1], n, *shape, diagonal=diagonal)
        assert tiles.spill_index.size == (0 if obs is not None else 5)
        assert bool(tiles.diag_zin.size) == diagonal or obs is None
        args = (txs, tzs, tc.real, tc.imag)
        K.reset_launch_counts()
        got = K.pauli_apply_grouped(psi, *args, tiles)
        again = K.pauli_apply_grouped(psi, *args, tiles)
        ref = K.pauli_apply_plain(psi, *args)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= RTOL
        assert torch.equal(got, again)
        counts = K.launch_counts()
        assert counts["pauli_apply_grouped"] == 2 * tiles.n_tiles
        assert counts["pauli_apply"] == (2 if tiles.spill_index.size else 0)


def test_pauli_apply_grouped_rejects_what_it_cannot_launch(dev):
    from qsfh_torch.engine.streaming import GroupTiles

    rng = np.random.default_rng(5)
    xs, zs = _inner_terms(rng, 12, 400, wide=0)
    tiles = GroupTiles(xs, zs, 12, 12, 2)
    psi = _t(_state(rng, 12), dev, torch.complex64)
    one = torch.ones(400, device=dev)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), one, one)
    K.reset_launch_counts()
    with pytest.raises(TypeError):
        K.pauli_apply_grouped(psi.to(torch.complex128), *args, tiles)
    with pytest.raises(ValueError):
        K.pauli_apply_grouped(psi, *(a[1:] for a in args), tiles)
    with pytest.raises(ValueError):
        K.pauli_apply_grouped(psi, args[0], args[1], one.cpu(), one.cpu(), tiles)
    with pytest.raises(ValueError):
        K.pauli_apply_grouped(psi, args[0].cpu(), args[1].cpu(), one, one, tiles)
    assert K.launch_counts()["pauli_apply_grouped"] == 0


# (lattice, qubits) of the folded inner products: 1x5, 3x3 and 2x6
FOLD_LATTICES = {10: (1, 5, 1.0, 6.0, 5, 3, 2), 18: (3, 3, 1.0, 6.0, 9, 5, 4),
                 24: (2, 6, 1.0, 6.0, 12, 6, 6)}


def _tilted(rng, n, dev):
    """A random state scaled by 1.5 per clear bit and 0.5 per set bit: its
    <Z_q> do not cancel, so Sz and the diagonal S^2 terms are far from 0."""
    from qsfh_torch.engine.state import index_bits

    v = _t(_state(rng, n), dev, torch.complex64)
    idx = index_bits(n, dev)
    for q in range(n):
        v = v * (1.5 - ((idx >> q) & 1).to(torch.float32))
    return v / torch.linalg.vector_norm(v)


@pytest.mark.parametrize("n", sorted(FOLD_LATTICES))
def test_folded_inner_products(dev, n):
    """``expectation_grouped`` on H, Sz and S^2 (a tilted state: Sz does not
    cancel) and ``screen_grouped`` on the pool (at 10 and 18 qubits; the
    plain pool takes seconds at 24) against their plain versions, on the
    engine's layouts (the x = 0 terms as one diagonal), within 1e-5 of the
    larger of the result and sum_t |c_t| ||a|| ||psi||; two calls give the
    same bits; one launch a call."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine.expectation import PackedPool
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

    rng = np.random.default_rng(n + 30)
    problem = HubbardProblem(*FOLD_LATTICES[n])
    psi = _tilted(rng, n, dev)
    for name in ("H", "Sz", "S^2"):
        obs = problem.observables[name]
        xs, zs, c = obs._tensors(psi)
        tiles = obs.inner_groups()
        assert tiles.n_diag and not tiles.spill_index.size
        K.reset_launch_counts()
        got = K.expectation_grouped(psi, xs, zs, c.real, c.imag, tiles)
        again = K.expectation_grouped(psi, xs, zs, c.real, c.imag, tiles)
        ref = K.expectation_grouped_plain(psi, xs, zs, c.real, c.imag, tiles)
        torch.cuda.synchronize()
        scale = max(abs(float(ref)), float(c.abs().sum()))
        assert abs(float(got) - float(ref)) <= RTOL * scale, name
        assert torch.equal(got, again)
        assert K.launch_counts()["expectation_grouped"] == 2
        assert K.launch_counts()["pauli_inner"] == 0
    if n == 24:
        return
    x, y = FOLD_LATTICES[n][:2]
    pool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(x, y)], n)
    w = problem.observables["H"].apply_scan(psi)
    xs, zs, c, _ = pool._tensors(psi)
    tiles = pool.inner_groups()
    K.reset_launch_counts()
    got = K.screen_grouped(w, psi, xs, zs, c.real, c.imag, tiles)
    again = K.screen_grouped(w, psi, xs, zs, c.real, c.imag, tiles)
    ref = K.screen_grouped_plain(w, psi, xs, zs, c.real, c.imag, tiles)
    torch.cuda.synchronize()
    scale = float(c.abs().max() * torch.linalg.vector_norm(w) * torch.linalg.vector_norm(psi))
    den = max(float(torch.linalg.vector_norm(ref)), scale)
    assert float(torch.linalg.vector_norm(got - ref)) <= RTOL * den
    assert torch.equal(got, again)
    assert K.launch_counts()["screen_grouped"] == 2


def test_folded_inner_products_random_lists(dev, monkeypatch):
    """The folded wrappers on random lists at 12 qubits with x = 0 terms
    whose phase masks leave every tile, masks that fit no tile (the
    per-term kernel, folded in torch), tiles of 9 bits, complex
    coefficients, a != psi, and a small partials cap (several launches,
    the expectation summed across them)."""
    from qsfh_torch.engine.streaming import GroupTiles

    rng = np.random.default_rng(44)
    n = 12
    xs, zs = _inner_terms(rng, n, 700, wide=5)
    xs[1:300:7] = 0
    c = rng.standard_normal(700) + 1j * rng.standard_normal(700)
    tiles = GroupTiles(xs, zs, n, 9, 2, diagonal=False, inner_diagonal=True)
    assert tiles.n_diag and tiles.spill_index.size == 5 and tiles.n_tiles > 1
    psi = _t(_state(rng, n), dev, torch.complex64)
    w = _t(_state(rng, n), dev, torch.complex64)
    txs, tzs, tc = _t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(c, dev, torch.complex64)
    positions = tiles.schedule(n, K.sm_count(dev))[0]
    monkeypatch.setattr(K, "PARTIALS_CAP", 64 * -(-(1 << (n - 9)) // positions))
    K.reset_launch_counts()
    e = K.expectation_grouped(psi, txs, tzs, tc.real, tc.imag, tiles)
    e_ref = K.expectation_grouped_plain(psi, txs, tzs, tc.real, tc.imag, tiles)
    s = K.screen_grouped(w, psi, txs, tzs, tc.real, tc.imag, tiles)
    s_ref = K.screen_grouped_plain(w, psi, txs, tzs, tc.real, tc.imag, tiles)
    v = K.pauli_inner_grouped(w, psi, txs, tzs, tiles)
    v_ref = K.pauli_inner_plain(w, psi, txs, tzs)
    torch.cuda.synchronize()
    assert abs(float(e) - float(e_ref)) <= RTOL * float(tc.abs().sum())
    assert _rel(s, s_ref) <= RTOL
    assert _rel(v, v_ref) <= RTOL
    launches = len(tiles.chunks(-(-(1 << (n - 9)) // positions), K.PARTIALS_CAP))
    assert launches > 1
    counts = K.launch_counts()
    assert (counts["expectation_grouped"], counts["screen_grouped"]) == (launches, launches)
    assert counts["pauli_inner_grouped"] == launches and counts["pauli_inner"] == 3
    with pytest.raises(TypeError):
        K.expectation_grouped(psi.to(torch.complex128), txs, tzs, tc.real, tc.imag, tiles)
    with pytest.raises(ValueError):
        K.screen_grouped(w, psi, txs, tzs, tc.real.cpu(), tc.imag.cpu(), tiles)


@pytest.mark.parametrize("n,k", [(12, 9), (17, 12), (20, 12)])
def test_expectation_partner(dev, n, k, monkeypatch):
    """``expectation_partner`` (E over two states, the partner form of a
    sharded expectation) against its plain version: random lists with x = 0
    terms (the Walsh-Hadamard diagonal over conj(a) psi), complex
    coefficients, two seeded random states; two calls give the same bits;
    at 12 qubits a small partials cap (several launches, summed)."""
    from qsfh_torch.engine.streaming import GroupTiles

    rng = np.random.default_rng(n + 70)
    xs, zs = _inner_terms(rng, n, 400, wide=0)
    xs[::5] = 0
    c = rng.standard_normal(400) + 1j * rng.standard_normal(400)
    tiles = GroupTiles(xs, zs, n, k, 2, diagonal=False, inner_diagonal=True)
    assert tiles.n_diag and tiles.n_tiles and not tiles.spill_index.size
    a = _t(_state(rng, n), dev, torch.complex64)
    psi = _t(_state(rng, n), dev, torch.complex64)
    txs, tzs, tc = _t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(c, dev, torch.complex64)
    launches = 1
    if n == 12:
        positions = tiles.schedule(n, K.sm_count(dev))[0]
        monkeypatch.setattr(K, "PARTIALS_CAP", 64 * -(-(1 << (n - k)) // positions))
        launches = len(tiles.chunks(-(-(1 << (n - k)) // positions), K.PARTIALS_CAP))
        assert launches > 1
    K.reset_launch_counts()
    got = K.expectation_partner(a, psi, txs, tzs, tc.real, tc.imag, tiles)
    again = K.expectation_partner(a, psi, txs, tzs, tc.real, tc.imag, tiles)
    ref = K.expectation_partner_plain(a, psi, txs, tzs, tc.real, tc.imag, tiles)
    torch.cuda.synchronize()
    assert abs(float(got) - float(ref)) <= RTOL * max(abs(float(ref)), float(tc.abs().sum()))
    assert torch.equal(got, again)
    assert K.launch_counts()["expectation_partner"] == 2 * launches
    assert K.launch_counts()["expectation_grouped"] == 0


def test_folded_expectation_between_resident_launches(dev):
    """The folded expectation's arrival count is a word of its own: an
    adjoint sweep (one grid barrier per run, so the barrier word's top bit
    may be left set) then E, a resident rotation, E again, each against
    its plain version; both words end with their low bits at 0."""
    from qsfh_torch.algos.base import HubbardProblem

    tiles, args, psi, lam = _resident_case(dev, 18, 11, 3, 91)
    obs = HubbardProblem(*FOLD_LATTICES[18]).observables["H"]
    xs, zs, c = obs._tensors(psi)
    layout = obs.inner_groups()
    for _ in range(2):
        K.adjoint_resident(psi.clone(), lam.clone(), *args, tiles)
        e = K.expectation_grouped(psi, xs, zs, c.real, c.imag, layout)
        got, ref = psi.clone(), psi.clone()
        K.rotation_resident(got, *args, tiles)
        K.rotation_resident_plain(ref, *args, tiles)
        e_ref = K.expectation_grouped_plain(psi, xs, zs, c.real, c.imag, layout)
        torch.cuda.synchronize()
        assert abs(float(e) - float(e_ref)) <= RTOL * float(c.abs().sum())
        assert _rel(got, ref) <= RTOL
    assert int(K._fold_count(psi).item()) == 0
    assert int(K._barrier(psi).item()) & 0x7FFFFFFF == 0


@pytest.mark.parametrize("n", [12, 18])
def test_expectation_norm_f64(dev, n):
    """The float64 Rayleigh readout against its plain version (the state
    upcast to complex128) within 1e-12 relative; two calls, the same bits."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine.dfloat import combine_rayleigh, f64_terms

    lattice = {12: (2, 3, 1, 4, 6, 3, 3), 18: (3, 3, 1, 6, 9, 5, 4)}[n]
    obs = HubbardProblem(*lattice).observables["H"]
    psi = _t(_state(np.random.default_rng(n), n), dev, torch.complex64)
    terms = f64_terms(obs, dev)
    K.reset_launch_counts()
    got = K.expectation_norm_f64(psi, *terms)
    again = K.expectation_norm_f64(psi, *terms)
    ref = K.expectation_norm_f64_plain(psi, *terms)
    torch.cuda.synchronize()
    assert K.launch_counts()["expectation_norm_f64"] == 2
    assert torch.equal(got, again)
    e, e_ref = combine_rayleigh(got.cpu().numpy()), combine_rayleigh(ref.cpu().numpy())
    assert abs(e - e_ref) <= 1e-12 * abs(e_ref)
    assert abs(float(got[2]) - float(ref[2])) <= 1e-12 * float(ref[2])
    with pytest.raises(TypeError):
        K.expectation_norm_f64(psi.to(torch.complex128), *terms)


def test_float64_group_kernels(dev, tmp_path):
    """``rot64_groups``, ``happly64`` and ``adjoint64_groups`` at n = 12 (2x3,
    ten operators of the extended pool: groups of 8 and diagonal groups)
    against their plain versions in complex128: the state and H psi within
    1e-12 relative, E within 1e-12, the gradient within 1e-12 of max |g|;
    two calls give the same bits; a launch per group (the per-group route,
    asked for explicitly: the program's layout would take the resident
    kernels)."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine import streaming
    from qsfh_torch.native.statevec import Rot64Program
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    a = ADAPT(n_epoch=0, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=3,
              n_electrons=6, n_spin_up=3, n_spin_down=3, tunneling=1, coulomb=4,
              ground_truth=False, plot=False, log_metrics=False, device=dev,
              dtype=torch.complex128, pool=hubbard_interaction_pool_extended(2, 3),
              results_root=str(tmp_path))
    indices = [0, 5, 10, 20, 40, 60, 80, 90, 100, 110]
    prog = Rot64Program.from_adapt(a, indices, route="groups")
    plain = Rot64Program.from_adapt(a, indices, impl=K.PLAIN)
    assert prog.route == "groups" and Rot64Program.from_adapt(a, indices).route == "resident"
    assert np.diff(prog.goff).max() == 8 and (prog.gx == 0).any()
    th = np.random.default_rng(7).normal(0.0, 0.4, len(indices))
    psi0 = a._initial_state()
    K.reset_launch_counts()
    psi = prog.apply(th, psi0)
    e, g = prog.value_and_grad(th, psi0)
    e2, g2 = prog.value_and_grad(th, psi0)
    h = prog.h_apply(psi)
    counts = K.launch_counts()
    assert (counts["rot64_groups"], counts["happly64"], counts["adjoint64_groups"]) == (
        3 * prog.G, 3, 2 * prog.G)
    assert prog.h_route == "terms"  # H psi under 18 qubits: the per-term kernel
    psi_ref = plain.apply(th, psi0)
    e_ref, g_ref = plain.value_and_grad(th, psi0)
    h_ref = plain.h_apply(psi_ref)
    torch.cuda.synchronize()
    assert _rel(psi, psi_ref) <= 1e-12 and _rel(h, h_ref) <= 1e-12
    assert abs(e - e_ref) <= 1e-12 and np.abs(g - g_ref).max() <= 1e-12 * np.abs(g_ref).max()
    assert e2 == e and np.array_equal(g2, g)
    with pytest.raises(TypeError):
        K.happly64(psi.to(torch.complex64), *prog.h_arrays("terms"))
    with pytest.raises(TypeError):
        K.happly64_tiles(psi.to(torch.complex64), *prog.h_arrays("tiles"),
                         streaming.apply64_layout(prog.hx, prog.hz, prog.n))


F64_LATTICES = {12: (2, 3, 1, 4, 6, 3, 3), 18: (3, 3, 1, 6, 9, 5, 4), 24: (2, 6, 1, 6, 12, 6, 6)}


@pytest.mark.parametrize("n", sorted(F64_LATTICES))
def test_expectation_norm_f64_tiles(dev, n):
    """The float64 readout over the tiles (``expectation_norm_df``'s route
    from 9 qubits on) on the Hubbard H against its plain version and the
    per-term kernel: the Rayleigh quotient and N within 1e-12 relative; the
    same bits on two calls and in a CUDA graph's replays; one launch a
    call, the arrival count back at 0."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine.dfloat import combine_rayleigh, f64_layout, f64_terms

    obs = HubbardProblem(*F64_LATTICES[n]).observables["H"]
    psi = _t(_state(np.random.default_rng(n), n), dev, torch.complex64)
    layout = f64_layout(obs, dev)
    K.reset_launch_counts()
    got = K.expectation_norm_f64_tiles(psi, *layout)
    again = K.expectation_norm_f64_tiles(psi, *layout)
    counts = K.launch_counts()
    ref = K.expectation_norm_f64_tiles_plain(psi, *layout)
    old = K.expectation_norm_f64(psi, *f64_terms(obs, dev))
    torch.cuda.synchronize()
    assert counts["expectation_norm_f64_tiles"] == 2 and counts["expectation_norm_f64"] == 0
    assert torch.equal(got, again) and int(K._fold_count(psi).item()) == 0
    e_ref = combine_rayleigh(ref.cpu().numpy())
    for out in (got, old):
        assert abs(combine_rayleigh(out.cpu().numpy()) - e_ref) <= 1e-12 * abs(e_ref)
        assert abs(float(out[2]) - float(ref[2])) <= 1e-12 * float(ref[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.expectation_norm_f64_tiles(psi, *layout)  # the capture stream's count word
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = K.expectation_norm_f64_tiles(psi, *layout)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, got)


@pytest.mark.parametrize("n", sorted(F64_LATTICES))
def test_happly64_tiles(dev, n):
    """H psi over the application tiles in complex128 on the Hubbard H at
    tiles of 10, 11 and 12 bits against the plain version and the
    per-term kernel: H psi within 1e-12 relative, E (before the scale) and
    N within 1e-12; the same bits on two calls; one launch a tile."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine import streaming

    xs, zs, cre, cim = HubbardProblem(*F64_LATTICES[n]).observables["H"]._scan_terms()
    args = (_t(np.asarray(xs, np.int64), dev, torch.int32), _t(np.asarray(zs, np.int64), dev,
                                                                torch.int32),
            _t(cre, dev, torch.float64), _t(cim, dev, torch.float64))
    psi = _t(_state(np.random.default_rng(n + 1), n), dev, torch.complex128)
    ref, st_ref = K.happly64_plain(psi, *args, 2.0)
    for k in (10, 11, 12):
        tiles = streaming.GroupTiles(xs, zs, n, k, 2)
        K.reset_launch_counts()
        out, st = K.happly64_tiles(psi, *args, tiles, 2.0)
        out2, st2 = K.happly64_tiles(psi, *args, tiles, 2.0)
        assert K.launch_counts()["happly64_tiles"] == 2 * tiles.n_tiles
        old, st_old = K.happly64(psi, *args, 2.0)
        torch.cuda.synchronize()
        assert torch.equal(out, out2) and torch.equal(st, st2)
        for h, s in ((out, st), (old, st_old)):
            assert _rel(h, ref) <= 1e-12
            assert abs(float(s[0] - st_ref[0])) <= 1e-12 * abs(float(st_ref[0]))
            assert abs(float(s[2] - st_ref[2])) <= 1e-12 * float(st_ref[2])
        assert int(K._fold_count(psi).item()) == 0


def test_float64_tiles_spilled_mask(dev):
    """Random terms at 14 qubits with masks that fit no tile: both tile
    kernels against their plain versions (1e-12), the spilled terms through
    the per-term float64 kernels, one launch each."""
    from qsfh_torch.engine import streaming

    rng = np.random.default_rng(14)
    n, T = 14, 60
    xs = np.array([sum(1 << int(b) for b in rng.choice(n, size=int(rng.integers(0, 5)),
                                                       replace=False)) for _ in range(T)])
    xs[::7] = 0b1011011  # 5 bits: no tile
    zs = rng.integers(0, 1 << n, size=T)
    c = rng.standard_normal(T) + 1j * rng.standard_normal(T)
    args = (_t(xs, dev, torch.int64), _t(zs, dev, torch.int64), _t(c.real, dev, torch.float64),
            _t(c.imag, dev, torch.float64))
    rd = streaming.GroupTiles(xs, zs, n, 10, 2, diagonal=False, inner_diagonal=True)
    ap = streaming.GroupTiles(xs, zs, n, 10, 2)
    assert rd.spill_index.size and ap.spill_index.size and ap.n_tiles
    psi32 = _t(_state(rng, n), dev, torch.complex64)
    psi = psi32.to(torch.complex128)
    K.reset_launch_counts()
    got = K.expectation_norm_f64_tiles(psi32, *args, rd)
    out, st = K.happly64_tiles(psi, *args, ap, 1.0)
    counts = {k: v for k, v in K.launch_counts().items() if v}
    ref = K.expectation_norm_f64_tiles_plain(psi32, *args, rd)
    h_ref, st_ref = K.happly64_tiles_plain(psi, *args, ap, 1.0)
    torch.cuda.synchronize()
    assert counts == dict(expectation_norm_f64_tiles=1, expectation_norm_f64=1,
                          happly64_tiles=ap.n_tiles, happly64=1)
    assert abs(float(got[0] - ref[0])) <= 1e-12 * float(np.abs(c).sum())
    assert _rel(out, h_ref) <= 1e-12 and abs(float(st[0] - st_ref[0])) <= 1e-12 * np.abs(c).sum()


def _random_group_program(n, dev, seed, n_ops=40, n_params=12, **kw):
    """A float64 group program of random rotation terms at n qubits: flip
    masks of up to 4 bits (a fifth of them diagonal), runs of 1-8 terms
    sharing (x, parameter, parity) as the grouping takes them, static
    terms among them, unit string phases; H a random term list."""
    from qsfh_torch.native.statevec import Rot64Program

    rng = np.random.default_rng(seed)
    xb, zb, scale, pidx, phre, phim = [], [], [], [], [], []
    for _ in range(n_ops):
        x = 0 if rng.random() < 0.2 else int(sum(1 << int(b) for b in rng.choice(
            n, size=int(rng.integers(1, 5)), replace=False)))
        p = int(rng.integers(-1, n_params))
        for _ in range(int(rng.integers(1, 9))):
            z = int(rng.integers(0, 1 << n))
            odd = bin(x & z).count("1") & 1
            sign = 1.0 if rng.random() < 0.5 else -1.0
            xb.append(x)
            zb.append(z)
            scale.append(float(rng.normal(0.0, 0.5)))
            pidx.append(p)
            phre.append(0.0 if odd else sign)
            phim.append(sign if odd else 0.0)
    seg = dict(xb=np.array(xb, np.uint32), zb=np.array(zb, np.uint32), scale=np.array(scale),
               pidx=np.array(pidx, np.int32), phre=np.array(phre), phim=np.array(phim))
    T = 30
    h = (rng.integers(0, 1 << n, size=T).astype(np.uint32),
         rng.integers(0, 1 << n, size=T).astype(np.uint32), rng.normal(size=T),
         rng.normal(size=T) * 0.1)
    th = rng.normal(0.0, 0.5, n_params)
    psi0 = _state(rng, n)
    make = lambda **extra: Rot64Program(n, seg, h, n_params, device=dev, **kw,  # noqa: E731
                                        **extra)
    return make, th, psi0


@pytest.mark.parametrize("n,k", [(12, 8), (14, 9), (12, 6)])
def test_float64_resident_kernels(dev, n, k):
    """``rot64_resident`` and ``adjoint64_resident`` on random group
    programs at n = 12 and 14 over tiles of k bits (many tiles and runs):
    against the plain versions in complex128 (the state within 1e-12
    relative, E within 1e-12, the gradient within 1e-12 of max |g|),
    against the per-group kernels (the same state bits: the pair arithmetic
    is shared; the gradient within 1e-13 of max |g|), one launch each way a
    call, two calls and a grid of 3 blocks (several tiles a block, each
    forming its own patterns; at 6 bits 64 tiles a run) the same bits."""
    make, th, psi0 = _random_group_program(n, dev, seed=n, tile_bits=k, low_bits=1)
    prog, groups, plain = make(), make(route="groups"), make(impl=K.PLAIN)
    assert prog.route == "resident" and len(prog.runs) > 2 and (prog.gx == 0).any()
    K.reset_launch_counts()
    psi = prog.apply(th, psi0)
    e, g = prog.value_and_grad(th, psi0)
    e2, g2 = prog.value_and_grad(th, psi0)
    counts = K.launch_counts()
    assert {k_: v for k_, v in counts.items() if v} == dict(
        rot64_resident=3, adjoint64_resident=2, happly64=2)
    psi_g = groups.apply(th, psi0)
    e_g, g_g = groups.value_and_grad(th, psi0)
    psi_p = plain.apply(th, psi0)
    e_p, g_p = plain.value_and_grad(th, psi0)
    torch.cuda.synchronize()
    gmax = np.abs(g_p).max()
    assert _rel(psi, psi_p) <= 1e-12 and abs(e - e_p) <= 1e-12
    assert np.abs(g - g_p).max() <= 1e-12 * gmax
    assert torch.equal(psi, psi_g) and e == e_g and np.abs(g - g_g).max() <= 1e-13 * gmax
    assert e2 == e and np.array_equal(g2, g)
    th_ext = prog._angles(th).clone()
    few = K.rot64_resident(prog._state(psi0), prog.groups, th_ext, prog.runs, blocks=3)
    lam = 2.0 * prog.h_apply(psi)
    g_full = K.adjoint64_resident(psi.clone(), lam.clone(), prog.groups, th_ext, prog.runs)
    p_few, l_few = psi.clone(), lam.clone()
    g_few = K.adjoint64_resident(p_few, l_few, prog.groups, th_ext, prog.runs, blocks=3)
    p_full, l_full = psi.clone(), lam.clone()
    K.adjoint64_resident(p_full, l_full, prog.groups, th_ext, prog.runs)
    torch.cuda.synchronize()
    assert torch.equal(few, psi) and torch.equal(g_full, g_few)
    assert torch.equal(p_few, p_full) and torch.equal(l_few, l_full)
    with pytest.raises(TypeError):
        K.rot64_resident(psi.to(torch.complex64), prog.groups, th_ext, prog.runs)


def test_float64_resident_one_run(dev):
    """A program whose groups all fit one run (tiles of all 10 qubits: one
    tile, one block): nothing to stage ahead; the state bits of the
    per-group kernels and the gradient within 1e-13 of max |g|."""
    make, th, psi0 = _random_group_program(10, dev, seed=3, n_ops=3, tile_bits=10, low_bits=1)
    prog, groups = make(), make(route="groups")
    assert prog.route == "resident" and len(prog.runs) == 1
    psi = prog.apply(th, psi0)
    e, g = prog.value_and_grad(th, psi0)
    psi_g = groups.apply(th, psi0)
    e_g, g_g = groups.value_and_grad(th, psi0)
    torch.cuda.synchronize()
    assert torch.equal(psi, psi_g)
    assert abs(e - e_g) <= 1e-13 * abs(e_g) and np.abs(g - g_g).max() <= 1e-13 * np.abs(g_g).max()


def test_float64_resident_staging_budget(dev):
    """Groups of rank 8 (256 table entries each) at 14 qubits over tiles of
    12 bits: the runs close on ``streaming.resident64_run_entries`` (two
    stage buffers beside the adjoint's 128 KiB of tiles), both kernels
    launch at that shared memory, and they give the state bits of the
    per-group kernels and the gradient within 1e-13 of max |g|."""
    from qsfh_torch.engine import streaming
    from qsfh_torch.native.statevec import Rot64Program

    n, G, P = 14, 24, 6
    rng = np.random.default_rng(12)
    j = np.tile(np.arange(8), G)
    # flip bits 0-2, phase bits 3-13 (even parity: real phases), a unit phase bit a term
    seg = dict(xb=np.repeat(rng.choice([0b110, 0b101, 0b11], G), 8).astype(np.uint32),
               zb=((1 << (3 + j)) | (rng.integers(0, 8, 8 * G) << 11)).astype(np.uint32),
               scale=rng.normal(0.0, 0.5, 8 * G), pidx=np.repeat(np.arange(G) % P, 8),
               phre=rng.choice([-1.0, 1.0], 8 * G), phim=np.zeros(8 * G))
    T = 30
    h = (rng.integers(0, 1 << n, size=T).astype(np.uint32),
         rng.integers(0, 1 << n, size=T).astype(np.uint32), rng.normal(size=T), np.zeros(T))
    th = rng.normal(0.0, 0.5, P)
    psi0 = _state(rng, n)
    prog = Rot64Program(n, seg, h, P, device=dev, tile_bits=12, low_bits=1)
    groups = Rot64Program(n, seg, h, P, device=dev, route="groups")
    runs = prog.runs
    assert prog.route == "resident" and len(runs) > 2
    assert runs.most_entries + 256 > streaming.resident64_run_entries(12) >= runs.most_entries
    psi = prog.apply(th, psi0)
    e, g = prog.value_and_grad(th, psi0)
    psi_g = groups.apply(th, psi0)
    e_g, g_g = groups.value_and_grad(th, psi0)
    torch.cuda.synchronize()
    assert torch.equal(psi, psi_g)
    assert abs(e - e_g) <= 1e-13 * abs(e_g) and np.abs(g - g_g).max() <= 1e-13 * np.abs(g_g).max()


@pytest.fixture(scope="module")
def polish_3x3():
    """(program, angles) of the committed 1719-operator 3x3 checkpoint's
    float64 polish program on the card (1931 groups in 521 resident
    runs)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.native.statevec import Rot64Program
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a = ADAPT(pool=hubbard_interaction_pool_extended(3, 3), n_epoch=0, threshold1=1e-3,
              threshold2=1e-3, x_dimension=3, y_dimension=3, n_electrons=9, n_spin_up=5,
              n_spin_down=4, tunneling=1, coulomb=6, degenerate_subspace=4, load_model=True,
              plot=False, log_metrics=False, device="cuda", dtype=torch.complex128,
              results_root=os.path.join(root, "benchmarks", "demo_3x3"))
    return Rot64Program.from_adapt(a), a.params_t.detach().cpu().numpy()


def test_float64_resident_checkpoint_3x3(dev, polish_3x3):
    """The checkpoint's float64 program at its angles, both ways (521 runs,
    520 staged a run ahead a launch): the state bits of ``rot64_groups``,
    the gradient within 1e-12 of max |g| of ``adjoint64_groups``, and the
    same bits (state, gradient, the adjoint's psi and lam) on a second call
    and at ``blocks=3`` (several tiles a block) as at the full grid."""
    prog, x0 = polish_3x3
    runs = prog.runs
    assert prog.route == "resident" and len(runs) == 521
    th_ext = prog._angles(x0).clone()
    rng = np.random.default_rng(26)
    psi = torch.as_tensor(_state(rng, 18), device=dev)
    lam = torch.as_tensor(_state(rng, 18), device=dev)
    K.reset_launch_counts()
    states, sweeps = [], []
    for blocks in (None, None, 3):
        states.append(K.rot64_resident(psi.clone(), prog.groups, th_ext, runs, blocks=blocks))
        p, l = psi.clone(), lam.clone()
        sweeps.append((K.adjoint64_resident(p, l, prog.groups, th_ext, runs, blocks=blocks), p, l))
    by_group = K.rot64_groups(psi.clone(), prog.groups, th_ext)
    g_groups = K.adjoint64_groups(psi.clone(), lam.clone(), prog.groups, th_ext)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["rot64_resident"] == counts["adjoint64_resident"] == 3
    assert K.resident64_grid(psi, runs, False) > 3 and K.resident64_grid(psi, runs, True) > 3
    assert torch.equal(states[0], by_group)
    assert float((sweeps[0][0] - g_groups).abs().max()) <= 1e-12 * float(g_groups.abs().max())
    for state, sweep in zip(states[1:], sweeps[1:]):
        assert torch.equal(state, states[0])
        assert all(torch.equal(a, b) for a, b in zip(sweep, sweeps[0]))


def _fused_adapt(dev, tmp_path):
    from qsfh_torch.algos.adapt import ADAPT

    a = ADAPT(n_epoch=1, threshold1=1e-3, threshold2=1e-6, x_dimension=2, y_dimension=3,
              n_electrons=6, n_spin_up=3, n_spin_down=3, tunneling=1, coulomb=4, plot=False,
              log_metrics=False, device=dev, results_root=str(tmp_path))
    a.selected_indices = list(range(12))
    return a


def test_fused_chunk_replays_eager_steps(dev, tmp_path):
    """Two replays of a captured 4-step chunk (2x3, complex64, the resident
    kernels' cooperative launches inside the graph) against 8 eager steps:
    energy and gnorm within 1e-4 relative, with no reference to theta, the
    optimizer or the stages left outside the chunk and the free memory
    released to the device; the float64 readout of the graph's final
    state within 1e-10 of its plain complex128 Rayleigh quotient."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner
    from qsfh_torch.engine.dfloat import combine_rayleigh

    a = _fused_adapt(dev, tmp_path)
    th = torch.full((12,), 0.05, dtype=torch.float32, device=dev)
    opt = torch.optim.Adam([th], lr=1e-2)
    step = a._build_step(tuple(range(12)))
    eager = [step(th, opt) for _ in range(8)]
    eager = [(float(r[2]), float(r[6])) for r in eager]

    runner = FusedAdaptRunner(a, chunk_iters=4, verbose=False)

    def capture():  # theta, Adam and the stages live on only through the chunk
        th2 = torch.full((12,), 0.05, dtype=torch.float32, device=dev)
        return runner.build_chunk(th2, torch.optim.Adam([th2], lr=1e-2, capturable=True), 4)

    chunk = capture()
    gc.collect()
    torch.cuda.empty_cache()  # memory nothing holds is released
    # new tensors take any free block: a graph writing through a stale
    # pointer would leave NaNs here or read them
    fill = [torch.full((128,), float("nan"), device=dev) for _ in range(4096)]
    K.reset_launch_counts()
    res = [chunk(), chunk()]
    assert sum(K.launch_counts().values()) == 0  # replays launch through the graph only
    assert (runner.captures, runner.replays) == (1, 2)
    fused = [(e, g) for r in res for e, g in zip(r["energy"], r["gnorm"])]
    for (e, g), (e_ref, g_ref) in zip(fused, eager):
        assert abs(e - e_ref) <= 1e-4 * abs(e_ref)
        assert abs(g - g_ref) <= 1e-4 * abs(g_ref)
    assert all(bool(t.isnan().all()) for t in fill)
    ref = K.expectation_norm_f64_plain(runner.final_state, *_f64_terms(a, dev))
    e_df = combine_rayleigh(res[-1]["df"])
    assert abs(e_df - combine_rayleigh(ref.cpu().numpy())) <= 1e-10 * abs(e_df)


def _f64_terms(a, dev):
    from qsfh_torch.engine.dfloat import f64_terms

    return f64_terms(a.problem.observables["H"], dev)


def test_failed_capture_raises(dev, tmp_path, monkeypatch):
    """A chunk that cannot be captured (a host read inside it) raises: no
    eager fallback, no replay."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner

    a = _fused_adapt(dev, tmp_path)
    build = a._build_stages

    def stages_with_a_host_read(indices):
        raw = build(indices)
        energy = raw["energy"]
        raw["energy"] = lambda psi: torch.tensor(float(energy(psi)), device=psi.device)
        return raw

    monkeypatch.setattr(a, "_build_stages", stages_with_a_host_read)
    runner = FusedAdaptRunner(a, chunk_iters=2, verbose=False)
    th = torch.zeros(12, dtype=torch.float32, device=dev)
    with pytest.raises(RuntimeError):
        runner.build_chunk(th, torch.optim.Adam([th], lr=1e-2, capturable=True), 2)
    assert runner.replays == 0 and runner.captures == 0
    torch.cuda.synchronize()


@pytest.fixture
def recorder():
    from qsfh_torch.utils import profiling as P

    P.collect()
    P.enable()
    try:
        yield P
    finally:
        P.disable()
        P.collect()


def test_recorder_device_gap_matches_the_host_clock(dev):
    """Two launches through a wrapper with 5 ms of host work between them,
    inside the span ``probe.sleep``: on the host clock the first launch's
    interval ends before its call returns and the second's starts during
    its call (within the anchors' windows and 20 us of queueing), so the
    device gap reads the 5 ms plus the second call's own host work before
    its launch; its midpoint falls inside the span; the anchors' windows
    and the drift are under 0.1 ms."""
    from qsfh_torch.utils import profiling as P

    psi = torch.zeros(1 << 10, dtype=torch.complex64, device=dev)
    K.xor_gather(psi, 3)  # the library loaded and the kernel warm
    torch.cuda.synchronize()
    P.collect()
    P.enable()
    try:
        K.xor_gather(psi, 4)  # the recorder's own path warm
        torch.cuda.synchronize()
        P.collect()
        h0 = time.perf_counter_ns()
        K.xor_gather(psi, 5)
        h1 = time.perf_counter_ns()
        with P.span("probe.sleep"):
            while time.perf_counter_ns() - h1 < 5_000_000:
                pass
        h2 = time.perf_counter_ns()
        K.xor_gather(psi, 6)
        h3 = time.perf_counter_ns()
        tr = P.collect()
    finally:
        P.disable()
        P.collect()
    first, second = [d for d in tr["device"] if d["name"] == "xor_gather"]
    assert first["span"] == second["span"] == 0
    (sleep,) = [s for s in tr["spans"] if s["name"] == "probe.sleep"]
    slack = 1e6 * max(tr["anchor_ms"]) + 20_000
    gap_ms = 1e-6 * (second["start_ns"] - first["end_ns"])
    seen = dict(gap_ms=gap_ms, first=first, second=second, sleep=sleep, host=(h0, h1, h2, h3),
                anchor_ms=tr["anchor_ms"], drift_ms=tr["drift_ms"])
    assert h0 - slack <= first["start_ns"] <= first["end_ns"] <= h1 + slack, seen
    assert h2 - slack <= second["start_ns"] <= h3 + slack, seen
    assert 1e-6 * (h2 - h1 - 2 * slack) <= gap_ms <= 1e-6 * (h3 - h1 + 2 * slack), seen
    mid = 0.5 * (first["end_ns"] + second["start_ns"])
    assert sleep["start_ns"] <= mid <= sleep["end_ns"], seen
    assert max(tr["anchor_ms"]) < 0.1 and abs(tr["drift_ms"]) < 0.1, seen


def test_capture_with_the_recorder_on(dev, tmp_path, recorder, monkeypatch):
    """A chunk captured with the recorder on: every eager launch of the
    warm-up step has its device interval, no launch inside the capture
    has one, each replay is one ``fused.replay`` interval, and the replays
    match eager steps as in ``test_fused_chunk_replays_eager_steps``."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner

    P = recorder
    a = _fused_adapt(dev, tmp_path)
    th = torch.full((12,), 0.05, dtype=torch.float32, device=dev)
    opt = torch.optim.Adam([th], lr=1e-2)
    step = a._build_step(tuple(range(12)))
    eager = [step(th, opt) for _ in range(8)]
    eager = [(float(r[2]), float(r[6])) for r in eager]
    P.collect()

    launch, calls = K._launch, []

    def counted(name, fn, *args, **kw):
        calls.append((name, torch.cuda.is_current_stream_capturing()))
        return launch(name, fn, *args, **kw)

    monkeypatch.setattr(K, "_launch", counted)
    runner = FusedAdaptRunner(a, chunk_iters=4, verbose=False)
    th2 = torch.full((12,), 0.05, dtype=torch.float32, device=dev)
    chunk = runner.build_chunk(th2, torch.optim.Adam([th2], lr=1e-2, capturable=True), 4)
    built = P.collect()
    assert any(captured for _, captured in calls)
    assert [d["name"] for d in built["device"]] == [n for n, captured in calls if not captured]
    res = [chunk(), chunk()]
    replayed = P.collect()
    assert [d["name"] for d in replayed["device"]] == ["fused.replay"] * 2
    fused = [(e, g) for r in res for e, g in zip(r["energy"], r["gnorm"])]
    for (e, g), (e_ref, g_ref) in zip(fused, eager):
        assert abs(e - e_ref) <= 1e-4 * abs(e_ref)
        assert abs(g - g_ref) <= 1e-4 * abs(g_ref)


def test_float64_launch_intervals_inside_value_and_grad(dev, tmp_path, recorder):
    """Each float64 evaluation is one ``f64.value_and_grad`` span whose
    kernels' device intervals carry its id and lie inside it on the host
    clock (within the anchors' windows)."""
    from qsfh_torch.algos.adapt_fused import initial_state
    from qsfh_torch.native.statevec import Rot64Program

    P = recorder
    a = _fused_adapt(dev, tmp_path)
    prog = Rot64Program.from_adapt(a)
    psi0 = initial_state(a)
    x = np.full(12, 0.05)
    prog.value_and_grad(x, psi0)
    P.collect()
    for _ in range(3):
        prog.value_and_grad(x, psi0)
    tr = P.collect()
    spans = {s["id"]: s for s in tr["spans"] if s["name"] == "f64.value_and_grad"}
    assert len(spans) == 3 and len(tr["device"]) >= 3 * 3
    slack = 1e6 * max(tr["anchor_ms"])
    for d in tr["device"]:
        s = spans[d["span"]]
        assert s["start_ns"] - slack <= d["start_ns"] <= d["end_ns"] <= s["end_ns"] + slack


# (lattice, (Lx, Ly, electrons, up, down)): the 3x3 HVA at 18 qubits (the
# resident kernels) and the 2x6 HVA at 24 (the tile runs)
HVA_LATTICES = {"3x3": (3, 3, 9, 5, 4), "2x6": (2, 6, 12, 6, 6)}


@pytest.mark.parametrize("lattice", sorted(HVA_LATTICES))
def test_hva_adjoint_with_trainable_diagonal_terms(dev, lattice):
    """The HVA segment (reps = 2: Coulomb layers of x = 0 Z/ZZ terms sharing
    one trainable angle each) through the kernels' adjoint sweep against
    the plain sweep: gradients within 1e-4 of max |g|, the Coulomb angles'
    gradients nonzero, psi and lambda within 1e-5, and the launches one
    resident adjoint (18 qubits) or one tile-run adjoint per run (24)."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.hva import hva_program_rot
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import CompiledCircuit, run_rot_adjoint
    from qsfh_torch.ops.jw import jordan_wigner

    x, y, ne, up, down = HVA_LATTICES[lattice]
    p = HubbardProblem(x, y, 1, 6, ne, up, down)
    n, reps = p.n_qubits, 2
    h_gen, v_gen = p.hva_generators()
    u_rot = jordan_wigner(p.interacting_term).rotation_terms()
    seg = CompiledCircuit(hva_program_rot(reps, [g.rotation_terms() for g in v_gen],
                                          [g.rotation_terms() for g in h_gen], u_rot),
                          n).segments[0]
    n_params = reps + 1 + reps * (len(v_gen) + len(h_gen))
    rng = np.random.default_rng(n)
    th = _t(rng.normal(0, 0.05, size=n_params), dev, torch.float32)
    psi = _t(_state(rng, n), dev, torch.complex64)
    lam = _t(_state(rng, n), dev, torch.complex64)
    K.reset_launch_counts()
    p1, l1, g = run_rot_adjoint(seg, psi, lam, th, n, impl=K.KERNELS)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    p2, l2, g_ref = run_rot_adjoint(seg, psi, lam, th, n, impl=K.PLAIN)
    torch.cuda.synchronize()
    assert int((seg.data["xb"] == 0).sum()) == (reps + 1) * len(u_rot)
    assert float(g_ref[: reps + 1].abs().min()) > 0
    assert float((g - g_ref).abs().max()) <= 1e-4 * float(g_ref.abs().max())
    assert _rel(p1, p2) <= RTOL and _rel(l1, l2) <= RTOL
    if n <= streaming.CHAIN_MAX_QUBITS:
        assert counts["adjoint_resident"] == 1 and counts["adjoint_tile_runs"] == 0
    else:
        layout = seg.tiles(-1, n, streaming.TILE_BITS, streaming.TILE_LOW_BITS)
        assert counts["adjoint_tile_runs"] == layout.n_runs and counts["adjoint_resident"] == 0
    assert counts["adjoint_rotation"] == 0


def _iqcc_case(n, dev, seed=5):
    """(driver, H observable, params, segment) for 30 seeded selections on
    n qubits: the 2x3 Hubbard H at 12 qubits, a 1x5 chain at 10."""
    from qsfh_torch.algos.iqcc import IQCC
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.lattice import fermi_hubbard

    H = jordan_wigner(fermi_hubbard(2, 3, 1.0, 4.0) if n == 12 else
                      fermi_hubbard(1, 5, 1.0, 4.0, periodic=False))
    driver = IQCC(H, n_epoch=1, lr=1e-2, threshold=1e-3, n_qubits=n, ground_truth=False,
                  plot=False, log_metrics=False, results_root="unused", device=dev)
    rng = np.random.default_rng(seed)
    masks = [(int(rng.integers(1, 1 << n)), int(rng.integers(0, 1 << n))) for _ in range(30)]
    params = {k: torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
              for k, v in (("theta", rng.uniform(0, np.pi, n)),
                           ("phi", rng.uniform(-np.pi, np.pi, n)),
                           ("tau", rng.normal(0, 0.7, 30)))}
    return driver, Observable(H, n), params, driver.segment(masks)


@pytest.mark.parametrize("n", [10, 12])
def test_iqcc_differentiable_segment(dev, n):
    """The iQCC loss on the kernels (resident rotation forward, adjoint
    backward, inner-product and application tiles) against the plain
    versions: energy within 1e-5 relative, tau, theta and phi gradients
    within 1e-4 of max |g|."""
    driver, obs, params, seg = _iqcc_case(n, dev)
    out = {}
    for name, impl in (("kernel", K.KERNELS), ("plain", K.PLAIN)):
        for p in params.values():
            p.grad = None
        e = obs.expectation_auto(driver._state(params, seg, impl), impl=impl)
        e.backward()
        out[name] = (float(e.detach()), {k: p.grad.clone() for k, p in params.items()})
    (e_k, g_k), (e_p, g_p) = out["kernel"], out["plain"]
    assert abs(e_k - e_p) <= RTOL * abs(e_p)
    for k in params:
        assert float((g_k[k] - g_p[k]).abs().max()) <= 1e-4 * float(g_p[k].abs().max())


def test_dense_dressing_and_ilc_fold_on_card(dev):
    """dress_dense and fold_ilc_dense at 10 qubits on the card against the
    same functions on the CPU (float64): relative Frobenius error <= 1e-10."""
    from qsfh_torch.ops.dense_dressing import dense_dis_generators, dress_dense, \
        paulisum_to_dense_fast
    from qsfh_torch.ops.ilc import candidate_anticommuting_sets, fold_ilc_dense
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.lattice import fermi_hubbard

    n = 10
    H = paulisum_to_dense_fast(jordan_wigner(fermi_hubbard(1, 5, 1.0, 4.0, periodic=False)), n)
    gens = [P for _, P in dense_dis_generators(H, n)[0]]
    rng = np.random.default_rng(2)
    taus = rng.normal(0, 0.5, len(gens))
    D_cpu = dress_dense(H, gens, taus, n)
    D_gpu = dress_dense(H.to(dev), gens, taus, n)
    assert _rel(D_gpu.cpu(), D_cpu) <= 1e-10
    dressed = [P for _, P in dense_dis_generators(D_cpu, n)[0]]
    sets = candidate_anticommuting_sets(dressed, rng.uniform(size=len(dressed)), 12)
    sub = [dressed[i] for i in max(sets, key=len)]
    a = rng.normal(size=len(sub) + 1)
    a /= np.linalg.norm(a)
    F_cpu = fold_ilc_dense(D_cpu, sub, a, n)
    F_gpu = fold_ilc_dense(D_gpu, sub, a, n)
    assert len(sub) > 2 and _rel(F_gpu.cpu(), F_cpu) <= 1e-10


def test_product_state_and_closed_forms_on_card(dev):
    """A 20-qubit product state (the 2x5 lattice's H) built on the card
    against the host build (1e-6 absolute), E through the inner tiles
    against the float64 closed form (1e-5 relative), a rotated segment on
    the tile runs against the dressed closed form, its adjoint gradient
    with lambda = 2 H psi against central differences (1e-3 of max |g|)."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine import product_state as ps
    from qsfh_torch.engine.compiled import CompiledCircuit, run_rot_adjoint

    p = HubbardProblem(2, 5, 1.0, 6.0, 10, 5, 5)
    n, H = p.n_qubits, p.qubit_hamiltonian
    rng = np.random.default_rng(7)
    th, al = rng.uniform(0.4, 2.7, n), rng.uniform(-np.pi, np.pi, n)
    psi = ps.product_state(n, th, al, dev)
    host = torch.as_tensor(ps.product_state_host(n, th, al))
    assert float((psi.cpu().to(torch.complex128) - host).abs().max()) <= 1e-6
    obs = p.observables["H"]
    e_closed = ps.product_expectation(H, n, th, al)
    assert abs(float(obs.expectation_scan(psi)) - e_closed) <= 1e-5 * abs(e_closed)
    rots = [((1 << 0) | (1 << 2), (1 << 0), 0.4), ((1 << 5) | (1 << 7), 0, -0.3),
            ((1 << 10) | (1 << 12), (1 << 10) | (1 << 12), 0.5), (0, 0b11, 0.2)]
    ops, thetas = ps.rotation_ops(n, rots)
    cc = CompiledCircuit(ops, n)
    th_t = torch.tensor(thetas, dtype=torch.float32, device=dev)
    K.reset_launch_counts()
    out = cc.apply(psi, th_t)
    assert K.launch_counts()["rotation_tile_runs"] >= 1
    e_rot = ps.product_expectation(ps.rotated_hamiltonian(H, rots), n, th, al)
    assert abs(float(obs.expectation_scan(out)) - e_rot) <= 1e-5 * abs(e_rot)
    g = run_rot_adjoint(cc.segments[0], out, 2.0 * obs.apply_scan(out), th_t, n)[2].cpu()
    fd = []
    for t in range(len(rots)):
        e = [ps.product_expectation(ps.rotated_hamiltonian(
            H, [(x, z, a + (d if k == t else 0.0)) for k, (x, z, a) in enumerate(rots)]),
            n, th, al) for d in (1e-5, -1e-5)]
        fd.append((e[0] - e[1]) / 2e-5)
    fd = torch.tensor(fd)
    assert float((g.double() - fd).abs().max()) <= 1e-3 * float(fd.abs().max())


@pytest.mark.parametrize("mode", ["hea", "vqd"])
def test_hea_segment_and_vqd_loss_on_card(dev, mode):
    """The HEA circuit as one rot segment on the kernels (resident at 12
    qubits: the 2x3 lattice's H) against the plain versions: the energy
    (or the VQD loss with an overlap penalty) within 1e-5 relative, the
    angle gradients within 1e-4 of max |g|."""
    from qsfh_torch.algos.hea import HEASegment
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.engine.state import fidelity, zero_state
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.lattice import fermi_hubbard

    n, reps = 12, 2
    obs = Observable(jordan_wigner(fermi_hubbard(2, 3, 1.0, 4.0)), n)
    rng = np.random.default_rng(3)
    a = rng.uniform(-np.pi, np.pi, (reps + 1, n, 3))
    prior = _t(_state(rng, n), dev, torch.complex64)
    psi0 = zero_state(n, torch.complex64, dev)
    out = {}
    for name, impl in (("kernel", K.KERNELS), ("plain", K.PLAIN)):
        th = _t(a, dev, torch.float32).requires_grad_(True)
        psi = HEASegment(n, reps, impl)(th, psi0)
        loss = obs.expectation_auto(psi, impl=impl)
        if mode == "vqd":
            loss = loss + 5.0 * fidelity(psi, prior)
        loss.backward()
        out[name] = (float(loss.detach()), th.grad.clone())
    (l_k, g_k), (l_p, g_p) = out["kernel"], out["plain"]
    assert abs(l_k - l_p) <= RTOL * abs(l_p)
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())


def test_trotter_and_ite_steps_on_card(dev):
    """A 3x3 Strang step (one rotation_resident launch) and an order-2 ITE
    step (pauli_apply_grouped, one launch per tile of H) on the kernels
    against the plain versions: states within 1e-5, E and variance within
    1e-5 relative."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import TrotterEvolution
    from qsfh_torch.algos.ite import ImaginaryTimeEvolution

    p = HubbardProblem(3, 3, 1.0, 4.0, 9, 5, 4)
    rng = np.random.default_rng(4)
    psi = _t(_state(rng, 18), dev, torch.complex64)
    ev = TrotterEvolution(p, dt=0.05, order=2, device=dev)
    ite = ImaginaryTimeEvolution(p, dbeta=0.01, order=2, device=dev)
    K.reset_launch_counts()
    got = ev.step(psi)
    got_ite = ite._step(psi)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["rotation_resident"] == 1 and counts["pauli_rotation"] == 0
    assert counts["pauli_apply_grouped"] == 2 * p.observables["H"].groups().n_tiles
    ev.impl = ite.impl = K.PLAIN
    ref, ref_ite = ev.step(psi), ite._step(psi)
    assert _rel(got, ref) <= RTOL and _rel(got_ite[0], ref_ite[0]) <= RTOL
    for a, b in zip(got_ite[1:3], ref_ite[1:3]):
        assert abs(float(a) - float(b)) <= RTOL * abs(float(b))


def test_greens_function_on_card(dev):
    """The 2x3 Green's function on the card (the excitation through
    ``apply_auto``, the steps on rotation_resident, complex64) against the
    complex128 CPU version: within 1e-5 of |G(0)| = 1 scale."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import greens_function

    p = HubbardProblem(2, 3, 1.0, 4.0, 6, 3, 3)
    gs = _state(np.random.default_rng(9), 12)
    K.reset_launch_counts()
    _, got = greens_function(p, gs, -5.2, 4, dt=0.05, n_steps=6, device=dev)
    counts = K.launch_counts()
    assert counts["rotation_resident"] == 6
    assert counts["pauli_apply_grouped"] + counts["pauli_apply"] >= 1
    _, ref = greens_function(p, gs, -5.2, 4, dt=0.05, n_steps=6, device="cpu")
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def test_one_layout_correlations_on_card(dev):
    """The 3x3 spin correlation matrix and rho_up through one
    ``pauli_inner_grouped`` layout each (one launch per chunk of tiles, no
    per-term inner product) against the complex128 per-entry loop on the
    same state: within 1e-5 of the largest entry."""
    from qsfh_torch.ops import correlations as C

    psi = _t(_state(np.random.default_rng(12), 18), dev, torch.complex64)
    K.reset_launch_counts()
    spin = C.correlation_matrix(psi, 9, "spin")
    rho = C.one_body_density_matrix(psi, 9, "up")
    counts = K.launch_counts()
    assert counts["pauli_inner_grouped"] >= 2 and counts["pauli_inner"] == 0
    assert counts["expectation_grouped"] == 0
    ref = psi.to(torch.complex128)
    for got, want in ((spin, C.correlation_matrix(ref, 9, "spin", route="loop")),
                      (rho, C.one_body_density_matrix(ref, 9, "up", route="loop"))):
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_lanczos_on_card(dev):
    """A 3x3 Lanczos run of m = 12 on ``pauli_apply_grouped`` (one launch
    per tile of H a step) against the complex128 plain run on the card:
    alphas and betas within 1e-4 relative."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.linalg.spectral import lanczos_tridiagonal

    p = HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4)
    ham = p.observables["H"]
    phi = _state(np.random.default_rng(13), 18)
    K.reset_launch_counts()
    a, b, _ = lanczos_tridiagonal(ham.apply_auto, _t(phi, dev, torch.complex64), 12)
    assert K.launch_counts()["pauli_apply_grouped"] == 12 * ham.groups().n_tiles
    ra, rb, _ = lanczos_tridiagonal(lambda v: ham.apply_auto(v, K.PLAIN),
                                    _t(phi, dev, torch.complex128), 12)
    assert np.abs(a - ra).max() <= 1e-4 * np.abs(ra).max()
    assert np.abs(b - rb).max() <= 1e-4 * np.abs(rb).max()


def test_multistart_epoch_on_card(dev):
    """One epoch of a 3x3 reps = 2 ``MultistartHVA`` with B = 2: one
    ``rotation_resident`` and one ``adjoint_resident`` launch per start,
    energies within 1e-5 relative of the plain versions."""
    from qsfh_torch.algos.multistart import MultistartHVA

    ms = MultistartHVA(n_starts=2, n_epoch=1, reps=2, lr=1e-2, x_dimension=3, y_dimension=3,
                       n_electrons=9, n_spin_up=5, n_spin_down=4, ground_truth=False,
                       device=dev)
    K.reset_launch_counts()
    got = ms.run()
    counts = K.launch_counts()
    assert counts["rotation_resident"] == 2 * 2 and counts["adjoint_resident"] == 2
    assert counts["pauli_rotation"] == 0 and counts["adjoint_rotation"] == 0
    ms.impl = K.PLAIN
    ref = ms.run()
    np.testing.assert_allclose(got["energies"], ref["energies"], rtol=RTOL)
    np.testing.assert_allclose(got["final_energies"], ref["final_energies"], rtol=RTOL)


def test_index_fold_same_bits_on_card(dev):
    """``IndexFold`` on the card: within 1e-5 relative of ``index_add_``
    and the same bits on two calls; a 2x2 ``MultistartHVA`` (B = 4, 20
    epochs of Adam, whose steps divide by |g|) run twice gives the same
    energies bit for bit."""
    from qsfh_torch.algos.multistart import MultistartHVA
    from qsfh_torch.engine.state import IndexFold

    rng = np.random.default_rng(11)
    idx = rng.integers(0, 40, size=20000)
    vals = torch.as_tensor(rng.standard_normal(20000).astype(np.float32), device=dev)
    fold = IndexFold(idx, 37, dev)
    got = fold(vals)
    keep = torch.as_tensor(idx < 37, device=dev)
    ref = torch.zeros(37, dtype=torch.float32, device=dev).index_add_(
        0, torch.as_tensor(idx, device=dev)[keep], vals[keep])
    assert torch.linalg.vector_norm(got - ref) <= RTOL * torch.linalg.vector_norm(ref)
    assert torch.equal(got, fold(vals))

    lat = dict(x_dimension=2, y_dimension=2, tunneling=1.0, coulomb=6.0, n_electrons=4,
               n_spin_up=2, n_spin_down=2)
    runs = [MultistartHVA(n_starts=4, n_epoch=20, reps=2, lr=3e-2, init_scale=0.1, seed=0,
                          ground_truth=False, dtype=torch.complex64, device=dev, **lat).run()
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["energies"], runs[1]["energies"])
    np.testing.assert_array_equal(runs[0]["final_energies"], runs[1]["final_energies"])


def test_sector_lanczos_on_card_matches_cpu(dev):
    """The 2x3 sector Lanczos on the card against the same run on the CPU
    (complex128, the same start vector): energy within 1e-10, the states
    equal within 1e-10 up to a phase; the complex128 CSR product on the
    card against the host's on a complex sum (1e-12)."""
    from qsfh_torch.linalg import lanczos
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.lattice import fermi_hubbard
    from qsfh_torch.ops.pauli import PauliSum

    hp = jordan_wigner(fermi_hubbard(2, 3, 1.0, 4.0))
    e_card, wf_card = lanczos.ground_state(hp, 12, 6, 3, 3, device=dev)
    e_cpu, wf_cpu = lanczos.ground_state(hp, 12, 6, 3, 3, device="cpu")
    assert wf_card.device.type == "cuda" and wf_card.dtype == torch.complex128
    assert abs(e_card - e_cpu) <= 1e-10
    overlap = torch.vdot(wf_cpu, wf_card.cpu())
    assert abs(abs(complex(overlap)) - 1.0) <= 1e-10
    e4, states = lanczos.degenerate_ground_space(hp, 12, 6, 3, 3, n_states=2, device=dev)
    assert abs(e4 - e_cpu) <= 1e-10 and all(s.device.type == "cuda" for s in states)
    rng = np.random.default_rng(0)
    op = PauliSum(rng.integers(0, 1 << 12, 60), rng.integers(0, 1 << 12, 60),
                  rng.standard_normal(60) + 1j * rng.standard_normal(60))
    mat, idx = lanczos.sector_hamiltonian(op, 12, 6, 3, 3)
    v = rng.standard_normal(idx.size) + 1j * rng.standard_normal(idx.size)
    got = (lanczos.device_matrix(mat, dev) @ torch.as_tensor(v).to(dev)).cpu().numpy()
    np.testing.assert_allclose(got, mat @ v, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_u4_segment_on_card_matches_cpu(dev, dtype):
    """The 3x3 Givens network as a u4 segment (``grad.adjoint.
    givens_network_ops``) forward and inverse on the card against the CPU,
    within 1e-5 (complex64) or 1e-12 (complex128) relative."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine.compiled import CompiledCircuit
    from qsfh_torch.grad.adjoint import givens_network_ops

    p = HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4)
    cc = CompiledCircuit(givens_network_ops(18, p.diagonal, p.decomposition), 18)
    assert "u4" in [s.kind for s in cc.segments]
    psi = _state(np.random.default_rng(5), 18)
    empty = torch.zeros(0, dtype=torch.float64)
    tol = RTOL if dtype == torch.complex64 else 1e-12
    for run in (cc.apply, cc.apply_inverse):
        got = run(_t(psi, dev, dtype), empty.to(dev))
        ref = run(torch.as_tensor(psi).to(dtype), empty)
        assert _rel(got.cpu(), ref) <= tol
