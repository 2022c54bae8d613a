"""The port's stream route (past the caps of ``streaming``) against the JAX
package's HBM-streaming kernels, on the CPU at 12 qubits.

The caps and the tile sizes are monkeypatched down (tiles of k = 6 bits,
the low c = 2 and four chosen per run), so several tile runs occur at 12
qubits; on the CPU the wrappers take their plain versions through the same
route structure.  The JAX side runs its stream kernels in interpret mode
as ``tests/test_pallas.py:193-391`` does (``QSFH_PALLAS=1``,
``QSFH_PALLAS_MAX_N=11``, small ``QSFH_PALLAS_STREAM_ROWS``); its
block-crossing terms fold into the port's tile runs.  Tolerances are those of the JAX tests at complex64 (2e-6 on
rotated states, 2e-5 on expectations, applications and adjoint
gradients, 3e-5 on pool screening) and 1e-10 at complex128 against the
JAX XLA scan.

Host layouts: the tile spans of the 2x6 rot segment (forward and
reversed) and the groups cover the input in order, and an emulation of the grouped kernel's indexing reproduces
``pauli_inner_plain`` (the tile runs' emulation is in
``tests/test_torch_tiles.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_tpu.engine import pallas_kernels as jpk
from qsfh_tpu.engine.compiled import CompiledCircuit as JaxCircuit
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.engine.expectation import PackedPool as JaxPool
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.pool import hubbard_interaction_pool_simplified as jax_pool_ops
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine import streaming
from qsfh_torch.engine.compiled import CompiledCircuit, Segment, run_rot_adjoint
from qsfh_torch.engine.expectation import Observable, PackedPool
from qsfh_torch.engine.state import index_bits, parity_signs
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

N = 12
TILE_K, TILE_C = 6, 2

# the JAX stream tests' four-op program (tests/test_pallas.py:356-361)
OPS = [
    ("rot", ((0b11, 0b101, 0.5), (0b1100, 0b0110, -0.25)), 0),  # local
    ("rot", (((1 << 11) | 3, (1 << 10) | 1, 1.0),), 1),  # cross
    ("rot", ((1 << 5, (1 << 11) | (1 << 5), -0.5),), 2),  # local, hi-z
    ("rot", (((1 << 10), (1 << 3), 0.75),), 3),  # cross
]
THETAS = [0.3, -0.7, 0.41, 0.9]


def _state(rng, n=N):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _small_tiles(monkeypatch, k=TILE_K, c=TILE_C):
    monkeypatch.setattr(streaming, "TILE_BITS", k)
    monkeypatch.setattr(streaming, "TILE_LOW_BITS", c)


@pytest.fixture
def stream_route(monkeypatch):
    """The port's stream route at 12 qubits, with tiles of TILE_K bits."""
    monkeypatch.setattr(streaming, "CHAIN_MAX_QUBITS", N - 1)
    _small_tiles(monkeypatch)


def _jax_stream_env(monkeypatch, rows):
    monkeypatch.setenv("QSFH_PALLAS", "1")
    monkeypatch.setenv("QSFH_PALLAS_MAX_N", str(N - 1))
    monkeypatch.setenv("QSFH_PALLAS_STREAM_ROWS", str(rows))


# -- host layouts -------------------------------------------------------------------


@pytest.fixture(scope="module")
def segment_2x6(tmp_path_factory):
    """The 24-qubit rot segment of the JAX package's 24q configuration:
    the first 6 pool operators and the Givens network (host arrays only)."""
    a = ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6,
              n_electrons=12, n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=6,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path_factory.mktemp("s26")))
    return a, CompiledCircuit(a._ansatz_ops(range(6)) + a._net_ops, a.n_qubits).segments[0]


@pytest.mark.parametrize("bits", [13, 14])
@pytest.mark.parametrize("direction", [1, -1])
def test_tile_spans_cover_every_term_in_order(segment_2x6, bits, direction):
    """The layout's spans cover every term once, in order, per direction
    and tile size."""
    _, seg = segment_2x6
    layout = seg.tiles(direction, 24, bits, 5)
    assert [t for _, t0, t1 in layout.spans for t in range(t0, t1)] == list(range(len(seg)))


def test_run_layout_counts_2x6(segment_2x6):
    """The shipped tile layouts: every 2x6 term fits a tile, so a call is
    one pass per run (the JAX package's low-bit runs took 190 forward and
    222 adjoint passes, 158 and 180 of them one term each)."""
    _, seg = segment_2x6
    assert len(seg) == 718
    k, c = streaming.TILE_BITS, streaming.TILE_LOW_BITS
    fwd, adj = seg.tiles(1, 24, k, c), seg.tiles(-1, 24, k, c)
    assert (fwd.n_runs, fwd.n_single, fwd.passes) == (46, 0, 46)
    assert (adj.n_runs, adj.n_single, adj.passes) == (46, 0, 46)


@pytest.mark.parametrize("what", ["H", "S^2", "pool"])
def test_group_by_x_round_trips(segment_2x6, what):
    a, _ = segment_2x6
    arrays = a.packed_pool.scan_arrays() if what == "pool" else (
        a.problem.observables[what]._scan_terms())
    xs = np.asarray(arrays[0], np.int64)
    order, starts = streaming.group_by_x(xs, max_terms=8)
    assert sorted(order) == list(range(len(xs)))
    for g in range(len(starts) - 1):
        idx = order[starts[g]:starts[g + 1]]
        assert 0 < len(idx) <= 8
        assert len(set(xs[idx])) == 1  # one flip mask per group
        assert list(idx) == sorted(idx)  # input order inside a group


def test_grouped_layout_emulation_matches_plain():
    """The flip-mask grouping (``group_by_x``, which the inner-product
    tiles cut into items), written out in torch at 8 qubits: group g forms
    conj(a[b]) psi[b ^ x] once and writes a signed sum to out[order[t]]
    for each of its terms."""
    rng = np.random.default_rng(1)
    n = 8
    xs = rng.choice(rng.integers(0, 1 << n, size=5), size=60)
    zs = rng.integers(0, 1 << n, size=60)
    order, starts = streaming.group_by_x(xs, max_terms=7)
    a = torch.as_tensor(_state(rng, n))
    psi = torch.as_tensor(_state(rng, n))
    idx = index_bits(n)
    out = torch.zeros(60, dtype=psi.dtype)
    for g in range(len(starts) - 1):
        prod = a.conj() * psi[idx ^ int(xs[order[starts[g]]])]
        for t in order[starts[g]:starts[g + 1]]:
            s = parity_signs(idx, int(zs[t]), torch.float64)
            out[t] = (s * prod).sum()
    ref = K.pauli_inner_plain(a, psi, torch.as_tensor(xs), torch.as_tensor(zs))
    assert _rel(out.numpy(), ref.numpy()) <= 1e-12


def test_local_run_plain_rejects_crossing_masks():
    """The tile-run plain versions refuse a flip mask outside its run's
    tile (the layout was built for other terms)."""
    layout = streaming.TileLayout(np.asarray([0b11, 1 << 7]), np.zeros(2, np.int64), 10, 6, 2)
    (tiles, _, _), = layout.spans
    assert int(tiles.run_mask[0]) == 0b1001_1111  # the low 2 bits, bit 7, padding 2-4
    psi = torch.as_tensor(_state(np.random.default_rng(2), 10))
    args = [torch.tensor([0b11, 1 << 9]), torch.tensor([0, 0]), torch.tensor([0.1, 0.2]),
            torch.tensor([1.0, 1.0]), torch.tensor([0.0, 0.0])]
    with pytest.raises(ValueError, match="leaves"):
        K.rotation_tile_runs_plain(psi, *args, tiles)
    with pytest.raises(ValueError, match="leaves"):
        K.adjoint_tile_runs_plain(psi, psi.clone(), *args, tiles)


# -- rotations ------------------------------------------------------------------------


def test_rotation_stream_matches_jax_complex64(stream_route, monkeypatch):
    psi = _state(np.random.default_rng(5)).astype(np.complex64)
    th = np.asarray(THETAS, np.float32)
    _jax_stream_env(monkeypatch, 8)
    jcc = JaxCircuit(OPS, N)
    ref = np.asarray(jax.jit(lambda p, t: jcc.apply(p, t))(jnp.asarray(psi), jnp.asarray(th)))
    ref_inv = np.asarray(jcc.apply_inverse(jnp.asarray(psi), jnp.asarray(th)))
    cc = CompiledCircuit(OPS, N)
    layout = cc.segments[0].tiles(1, N, TILE_K, TILE_C)
    assert (layout.n_runs, layout.n_single) == (2, 0)  # JAX's crossing terms fold into runs
    got = cc.apply(torch.as_tensor(psi), torch.as_tensor(th))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)
    got_inv = cc.apply_inverse(torch.as_tensor(psi), torch.as_tensor(th))
    np.testing.assert_allclose(got_inv.numpy(), ref_inv, atol=2e-6)


def test_rotation_stream_matches_jax_xla_complex128(stream_route, monkeypatch):
    psi = _state(np.random.default_rng(6))
    th = np.asarray(THETAS)
    monkeypatch.setenv("QSFH_PALLAS", "0")
    jcc = JaxCircuit(OPS, N)
    cc = CompiledCircuit(OPS, N)
    for direction in (1, -1):
        fn = jcc.apply if direction == 1 else jcc.apply_inverse
        ref = np.asarray(fn(jnp.asarray(psi), jnp.asarray(th)))
        got = (cc.apply if direction == 1 else cc.apply_inverse)(
            torch.as_tensor(psi), torch.as_tensor(th))
        assert _rel(got.numpy(), ref) <= 1e-10


# -- expectation, apply, screening -----------------------------------------------------------


@pytest.fixture(scope="module")
def h_2x3():
    from qsfh_tpu.algos.base import HubbardProblem as JaxProblem

    from qsfh_torch.algos.base import HubbardProblem

    args = (2, 3, 1.0, 6.0, 6, 3, 3)
    jp, tp = JaxProblem(*args), HubbardProblem(*args)
    return (JaxObservable(jp.qubit_hamiltonian, N), Observable(tp.qubit_hamiltonian, N))


def test_expectation_stream_matches_jax(h_2x3, stream_route, monkeypatch):
    jobs, tobs = h_2x3
    psi = _state(np.random.default_rng(7)).astype(np.complex64)
    xs, zs, cre, cim = jobs._scan_terms()
    monkeypatch.setenv("QSFH_PALLAS_STREAM_ROWS", "8")
    ref = float(jpk.expectation_stream_pallas(
        jnp.asarray(psi), N, xs, zs, cre.astype(np.float32), cim.astype(np.float32)))
    got = float(tobs.expectation_scan(torch.as_tensor(psi)))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    assert len(tobs.inner_groups()) < len(tobs)  # the grouped route ran


@pytest.mark.parametrize("chain_cap, inner_bits", [(N, 12), (N - 1, 9)])
def test_each_family_follows_its_own_cap(h_2x3, monkeypatch, chain_cap, inner_bits):
    """Rotations and the adjoint sweep switch at CHAIN_MAX_QUBITS (resident
    launches up to it, tile runs past it); expectation values take the
    folded inner-product tiles and applications the application tiles from
    INNER_TILE_MIN_BITS (9) qubits whatever the cap, at the inner tile
    size ``inner_bits``."""
    monkeypatch.setattr(streaming, "CHAIN_MAX_QUBITS", chain_cap)
    monkeypatch.setattr(streaming, "INNER_TILE_BITS", inner_bits)
    # tiles of the low 3 bits and one more, both routes: the three terms
    # that flip two higher bits fit no tile and take the per-term kernels
    _small_tiles(monkeypatch, k=4, c=3)
    monkeypatch.setattr(streaming, "RESIDENT_TILE_BITS", 4)
    monkeypatch.setattr(streaming, "RESIDENT_TILE_LOW_BITS", 3)
    calls = []

    def recorded(name):
        fn = getattr(K.PLAIN, name)
        return lambda *args: calls.append(name) or fn(*args)

    impl = K.Impl(*(recorded(f.name) for f in dataclasses.fields(K.Impl)))
    tobs = Observable(h_2x3[1].op, N)  # a fresh layout cache at this tile size
    psi = torch.as_tensor(_state(np.random.default_rng(10)).astype(np.complex64))
    th = torch.as_tensor(np.asarray(THETAS, np.float32))
    cc = CompiledCircuit(OPS, N)
    out = cc.apply(psi, th, impl=impl)
    run_rot_adjoint(cc.segments[0], out, psi, th, N, impl=impl)
    tobs.expectation_scan(out, impl=impl)
    tobs.apply_scan(out, impl=impl)
    resident = chain_cap >= N
    assert ("rotation_runs" in calls) != resident
    assert ("adjoint_runs" in calls) != resident
    assert ("rotation_resident" in calls) == resident
    assert ("adjoint_resident" in calls) == resident
    assert calls.count("rotation") == 1  # the terms that fit no tile
    assert calls.count("adjoint") == 1
    assert calls.count("expectation_grouped") == 1 and "inner" not in calls
    assert tobs.inner_groups().k == inner_bits
    assert calls.count("apply_grouped") == 1 and "apply" not in calls


def test_apply_stream_matches_jax(h_2x3, stream_route, monkeypatch):
    jobs, tobs = h_2x3
    psi = _state(np.random.default_rng(8)).astype(np.complex64)
    xs, zs, cre, cim = jobs._scan_terms()
    monkeypatch.setenv("QSFH_PALLAS_STREAM_ROWS", "8")
    ref = np.asarray(jpk.apply_stream_pallas(
        jnp.asarray(psi), N, xs, zs, cre.astype(np.float32), cim.astype(np.float32)))
    got = tobs.apply_scan(torch.as_tensor(psi))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_screen_stream_matches_jax(h_2x3, stream_route, monkeypatch):
    jobs, _ = h_2x3
    psi = _state(np.random.default_rng(9)).astype(np.complex64)
    w = np.array(jobs.apply(jnp.asarray(psi)))  # a writable copy for torch
    jpool = JaxPool([jax_jw(g) for g in jax_pool_ops(2, 3)[:8]], N)
    tpool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(2, 3)[:8]], N)
    xs, zs, cre, cim, ks = jpool.scan_arrays()
    _jax_stream_env(monkeypatch, 8)
    contribs, perm = jpk.screen_stream_pallas(
        jnp.asarray(psi), jnp.asarray(w), N, xs, zs,
        cre.astype(np.float32), cim.astype(np.float32))
    ref = np.asarray(jax.ops.segment_sum(contribs, jnp.asarray(ks[perm]), num_segments=8))
    got = tpool.screen_scan(torch.as_tensor(psi), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5)


# -- adjoint --------------------------------------------------------------------------------


def test_adjoint_stream_matches_jax(stream_route, monkeypatch):
    """adjoint_stream_pallas called directly on a short reversed term list
    (16-row setting: 8-row blocks, 10 local bits): psi0, lam0 and every
    per-term contribution.  Each term has its own parameter, so the
    port's gradients are the per-term contributions."""
    rng = np.random.default_rng(10)
    # flat masks in application order: local, crossing (bits 10 / 11),
    # a diagonal term, and z masks above the local bits
    xs = np.asarray([0b11, (1 << 11) | 3, 0, 1 << 5, 1 << 10, 0b1100, (1 << 10) | (1 << 2)],
                    np.uint32)
    zs = np.asarray([0b101, (1 << 10) | 1, (1 << 11) | 1, (1 << 11) | (1 << 5), 1 << 3,
                     0b0110, 1 << 10], np.uint32)
    T = len(xs)
    k = rng.integers(0, 4, size=T)
    ph = (-1j) ** k
    th = rng.uniform(-1, 1, size=T).astype(np.float32)
    psi = _state(rng).astype(np.complex64)
    lam = _state(rng).astype(np.complex64)
    monkeypatch.setenv("QSFH_PALLAS_STREAM_ROWS", "16")
    rev = slice(None, None, -1)
    p0, l0, contribs = jpk.adjoint_stream_pallas(
        jnp.asarray(psi), jnp.asarray(lam), N, xs[rev], zs[rev], jnp.asarray(th[rev]),
        jnp.ones(T, jnp.float32), jnp.asarray(ph.real[rev], jnp.float32),
        jnp.asarray(ph.imag[rev], jnp.float32))
    seg = Segment("rot", dict(xb=xs, zb=zs, scale=np.ones(T), pidx=np.arange(T, dtype=np.int32),
                              phre=ph.real, phim=ph.imag))
    layout = seg.tiles(-1, N, TILE_K, TILE_C)
    assert (layout.n_runs, layout.n_single) == (2, 0)  # JAX's 3 crossing terms fold into runs
    gpsi, glam, grads = run_rot_adjoint(seg, torch.as_tensor(psi), torch.as_tensor(lam),
                                        torch.as_tensor(th), N)
    np.testing.assert_allclose(gpsi.numpy(), np.asarray(p0), atol=2e-6)
    np.testing.assert_allclose(glam.numpy(), np.asarray(l0), atol=2e-6)
    np.testing.assert_allclose(grads.numpy()[::-1], np.asarray(contribs), atol=2e-5)


# -- the slice as a whole -----------------------------------------------------------------------


@pytest.mark.parametrize("cdtype", ["complex64", "complex128"])
def test_adapt_step_and_selection_on_the_stream_route(cdtype, stream_route, monkeypatch, tmp_path):
    """A 2x3 ADAPT train step and selection, the port on its stream route
    against the JAX XLA path (QSFH_PALLAS=0), on the same theta: energy,
    gradient and the pool's screened gradients."""
    monkeypatch.setenv("QSFH_PALLAS", "0")
    kw = dict(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=3,
              n_electrons=6, n_spin_up=3, n_spin_down=3, tunneling=1, coulomb=6,
              ground_truth=False, plot=False, log_metrics=False)
    rtol = 1e-5 if cdtype == "complex64" else 1e-10
    j = JaxADAPT(**kw, results_root=str(tmp_path / "j"), dtype=getattr(jnp, cdtype))
    t = ADAPT(**kw, results_root=str(tmp_path / "t"), device="cpu",
              dtype=getattr(torch, cdtype))
    indices = (0, 1, 2)
    th = np.asarray([0.2, -0.3, 0.1])
    rdt = np.float32 if cdtype == "complex64" else np.float64
    jstep = j._build_step_split(indices, optax.adam(1e-2))
    jth = jnp.asarray(th, rdt)
    out_j = jstep(jth, optax.adam(1e-2).init(jth))
    raw = jstep.raw_stages
    psi_r = raw["fwd"](jth)
    jgrads = np.asarray(raw["adjoint"](psi_r, raw["cotangent"](psi_r), jth))
    tth = torch.as_tensor(th.astype(rdt))
    out_t = t._build_step(indices)(tth, torch.optim.Adam([tth], lr=1e-2))
    np.testing.assert_allclose(float(out_t[2]), float(out_j[2]), rtol=rtol)  # energy
    assert np.linalg.norm(tth.grad.numpy() - jgrads) <= rtol * np.linalg.norm(jgrads)
    jscreen = np.asarray(j._screen_for(indices)(jnp.asarray(th, rdt)))
    tscreen = t._screen_for(indices)(torch.as_tensor(th.astype(rdt))).numpy()
    assert np.linalg.norm(tscreen - jscreen) <= rtol * np.linalg.norm(jscreen)
    # the step and the selection went through the grouped route
    assert t.problem.observables["H"]._tensor_cache.get("groups") is not None
    assert t.problem.observables["H"]._tensor_cache.get("inner_groups") is not None
    assert t.packed_pool._tensor_cache.get("inner_groups") is not None
