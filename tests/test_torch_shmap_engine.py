"""The port's sharded engine (``qsfh_torch.parallel.shmap_engine``) against the
JAX package's single-shard functions, as ``tests/test_shmap_engine.py`` holds
the JAX sharded engine to them: gloo ranks on the CPU, complex128, D = 2 and
4 ranks (one spawn each, every case computed in it).  Also the stacked-pair
rotation runs on the host, against a dense reference, with no ranks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_bodies as bodies
from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine import gates as jg
from qsfh_tpu.engine.circuits import apply_givens_network
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.ops.pauli import qubit_operator as jax_qubit_operator
from qsfh_torch.engine import kernels as K
from qsfh_torch.parallel import spawn_ranks
from qsfh_torch.parallel.sharded_compiled import split_runs, stacked_masks
from qsfh_torch.parallel.shmap_engine import parities

N = 10
TOL = 1e-10
CASES = [
    ("local X", 1 << 9, 0),
    ("cross X", 1 << 0, 0),
    ("cross Y", 1 << 1, 1 << 1),
    ("mixed XZ", (1 << 0) | (1 << 8), (1 << 4) | (1 << 2)),
    ("Z only hi+lo", 0, (1 << 0) | (1 << 9)),
    ("wide string", (1 << 0) | (1 << 2) | (1 << 9), (1 << 1) | (1 << 5)),
]
ROT = [((1 << 0) | (1 << 3), (1 << 2), 0.5), (0, (1 << 0) | (1 << 9), -0.25)]
OP = [("Z0 Z3", 0.5), ("X0 X1", 0.25), ("Y0 Y9", -0.4), ("X2", 0.3)]
PAIRS = [(8, 9), (0, 9), (9, 0), (0, 1), (2, 5)]
HUBBARD = (2, 2, 1.0, 6.0, 4, 2, 2)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


PSI = _random_state(N, 0)
HPSI = _random_state(8, 7)
UNITARY = np.linalg.qr(np.random.default_rng(5).normal(size=(4, 4))
                       + 1j * np.random.default_rng(6).normal(size=(4, 4)))[0]
GIVENS = jg.givens_plan_matrix(0.61, -0.47)


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request):
    args = (PSI, N, CASES, ROT, OP, [(a, b, GIVENS) for a, b in PAIRS], UNITARY, HUBBARD, HPSI)
    return request.param, spawn_ranks(bodies.engine_cases, request.param, backend="gloo",
                                      device="cpu", timeout=120, args=args)


def _close(got, ref, name):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL, err_msg=name)


def test_local_qubits(ranks):
    d, out = ranks
    assert all(r["n_local"] == N - d.bit_length() + 1 for r in out)


@pytest.mark.parametrize("name,x,z", CASES)
def test_apply_pauli_and_rotation_match_single_shard(ranks, name, x, z):
    _, out = ranks
    psi = jnp.asarray(PSI)
    for r in out:
        _close(r[f"apply {name}"], jg.apply_pauli_string(psi, N, x, z), name)
        _close(r[f"rotation {name}"], jg.pauli_rotation(psi, N, x, z, 0.37), name)


def test_generator_rotation_and_apply(ranks):
    _, out = ranks
    psi = jnp.asarray(PSI)
    ref = sum(s * np.asarray(jg.apply_pauli_string(psi, N, x, z)) for x, z, s in ROT)
    for r in out:
        _close(r["generator"], jg.generator_rotation(psi, N, ROT, 0.8), "generator")
        _close(r["apply_generator"], ref, "apply_generator")
        # the packed generator's rotation runs, their exact inverse, G psi
        _close(r["generator_packed"], jg.generator_rotation(psi, N, ROT, 0.8), "packed")
        _close(r["generator_inverse"], PSI, "inverse")
        _close(r["apply_generator_packed"], ref, "apply_generator packed")


def test_small_operator(ranks):
    _, out = ranks
    op = jax_qubit_operator(*OP[0])
    for term in OP[1:]:
        op = op + jax_qubit_operator(*term)
    obs = JaxObservable(op, N)
    e = float(obs.expectation(jnp.asarray(PSI)))
    for r in out:
        assert abs(r["expectation"] - e) < TOL
        assert r["expectation"] == out[0]["expectation"]  # the same bits on every rank
        _close(r["apply_paulisum"], obs.apply(jnp.asarray(PSI)), "apply_paulisum")


def test_hubbard_hamiltonian_and_network(ranks):
    _, out = ranks
    p = JaxProblem(*HUBBARD)
    e = float(p.observables["H"].expectation(jnp.asarray(HPSI)))
    occ = tuple(p.spin_up_indices + p.spin_down_indices)
    basis = np.zeros(1 << p.n_qubits, np.complex128)
    basis[sum(1 << (p.n_qubits - 1 - q) for q in occ)] = 1.0
    net = apply_givens_network(jnp.asarray(basis), p.n_qubits, p.diagonal, p.decomposition)
    for r in out:
        assert abs(r["hubbard"] - e) < TOL
        assert r["hubbard_packed"] == r["hubbard"]  # expectation_local over the packing
        _close(r["basis"], basis, "basis")
        _close(r["network"], net, "network")
        _close(r["network_inverse"], basis, "network inverse")


def test_two_qubit_gates_and_rz_layer(ranks):
    _, out = ranks
    psi = jnp.asarray(PSI)
    rz = psi
    for q in range(N):
        rz = jg.rz(rz, N, 0.1 * (q + 1), q)
    for r in out:
        for qa, qb in PAIRS:
            _close(r[f"two {qa} {qb}"], jg.apply_two_qubit(psi, N, GIVENS, qa, qb), f"{qa} {qb}")
        _close(r["unitary"], jg.apply_two_qubit(psi, N, UNITARY, 1, 7), "unitary")
        _close(r["rz_layer"], rz, "rz_layer")


# -- the stacked pair on the host (no ranks) ----------------------------------------------


def test_split_runs():
    x_hi = [0, 0, 1, 0, 1, 0, 2, 2, 0, 3, 0, 0]
    runs = split_runs(x_hi)
    assert runs == [(0, 0, 2), (1, 2, 5), (0, 5, 6), (2, 6, 8), (0, 8, 9), (3, 9, 10),
                    (0, 10, 12)]
    assert split_runs([]) == [] and split_runs([0, 0]) == [(0, 0, 2)]


@pytest.mark.parametrize("k", [1, 2])
def test_stacked_pair_rotation_matches_dense(k):
    """A run of terms with x_hi in {0, m} on the stacked pair [own | partner]
    of n_local + 1 qubits, the device sign in the phase, gives each rank its
    shard of the rotated full state; the pair's <lam|P psi> is the sum of
    both shards' shares (n = 6, complex128, against the full-state plain
    rotation)."""
    n, rng = 6, np.random.default_rng(11)
    nl, lo = n - k, (1 << (n - k)) - 1
    psi = torch.as_tensor(_random_state(n, 3))
    lam = torch.as_tensor(_random_state(n, 4))
    m = 1 << (k - 1)
    # terms whose x_hi is 0 or m, z anywhere
    xs = np.asarray([(m << nl) | 0b101, 0b011, (m << nl) | 0b1, 0b100], np.int64)
    zs = np.asarray([int(v) for v in rng.integers(0, 1 << n, size=4)], np.int64)
    angles = torch.as_tensor(rng.normal(size=4))
    ph = [(-1j) ** (bin(int(x) & int(z)).count("1") % 4) for x, z in zip(xs, zs)]
    phre = torch.as_tensor([p.real for p in ph])
    phim = torch.as_tensor([p.imag for p in ph])
    full = K.pauli_rotation_plain(psi.clone(), torch.as_tensor(xs), torch.as_tensor(zs), angles,
                                  phre, phim)
    v_full = K.pauli_inner_plain(lam, psi, torch.as_tensor(xs), torch.as_tensor(zs))
    size = 1 << nl
    v_sum = torch.zeros(4, dtype=torch.complex128)
    for d in range(1 << k):
        sx, sz = stacked_masks(xs & lo, xs >> nl, zs & lo, zs >> nl, m, nl)
        sign = torch.as_tensor(1.0 - 2.0 * parities((zs >> nl) & d))
        own, partner = psi[d * size:(d + 1) * size], psi[(d ^ m) * size:((d ^ m) + 1) * size]
        pair = torch.cat([own, partner])
        K.pauli_rotation_plain(pair, torch.as_tensor(sx), torch.as_tensor(sz), angles,
                               phre * sign, phim * sign)
        np.testing.assert_allclose(pair[:size].numpy(), full[d * size:(d + 1) * size].numpy(),
                                   atol=1e-13)
        lpair = torch.cat([lam[d * size:(d + 1) * size], lam[(d ^ m) * size:((d ^ m) + 1) * size]])
        # the rank's sign times the pair's sum: shard d's share plus shard d ^ m's
        v_sum += 0.5 * sign * K.pauli_inner_plain(lpair, torch.cat([own, partner]),
                                                  torch.as_tensor(sx), torch.as_tensor(sz))
    np.testing.assert_allclose(v_sum.numpy(), v_full.numpy(), atol=1e-13)


@pytest.mark.parametrize("d", [2, 4])
def test_packing_matches_jax(d):
    """The host packings (pack_generator's same-x runs and its commuting
    check, pack_observable, pack_stream_groups) equal the JAX package's on
    the 2x2 pool, H and S^2 (no ranks: the packings are host work)."""
    from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
    from qsfh_tpu.ops.pool import hubbard_interaction_pool_simplified as jax_pool
    from qsfh_tpu.parallel.mesh import amplitude_mesh as jax_mesh
    from qsfh_tpu.parallel.sharded_compiled import pack_generator as jax_pack_generator
    from qsfh_tpu.parallel.sharded_compiled import pack_observable as jax_pack_observable
    from qsfh_tpu.parallel.sharded_stream import pack_stream_groups as jax_pack_stream
    from qsfh_tpu.parallel.shmap_engine import ShardedPauliEngine as JaxEngine
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified
    from qsfh_torch.parallel.mesh import Mesh
    from qsfh_torch.parallel.sharded_compiled import pack_generator, pack_observable
    from qsfh_torch.parallel.sharded_stream import pack_stream_groups
    from qsfh_torch.parallel.shmap_engine import ShardedPauliEngine

    jp, tp = JaxProblem(*HUBBARD), HubbardProblem(*HUBBARD)
    n = tp.n_qubits
    jeng = JaxEngine(n, jax_mesh(d))
    teng = ShardedPauliEngine(n, Mesh(d, 0, "gloo", torch.device("cpu")))

    def same(a, b):
        assert len(a) == len(b)
        for ta, tb in zip(a, b):
            assert len(ta) == len(tb)
            for u, v in zip(ta, tb):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))

    pools = zip([jax_jw(g).rotation_terms() for g in jax_pool(2, 2)[:8]],
                [jordan_wigner(g).rotation_terms() for g in hubbard_interaction_pool_simplified(2, 2)[:8]])
    for jr, tr in pools:
        same(jax_pack_generator(jeng, jr), pack_generator(teng, tr))
    with pytest.raises(ValueError, match="anticommute"):
        pack_generator(teng, ROT)
    same(jax_pack_generator(jeng, ROT, allow_noncommuting=True),
         pack_generator(teng, ROT, allow_noncommuting=True))
    for name in ("H", "S^2"):
        same(jax_pack_observable(jeng, jp.observables[name].op),
             pack_observable(teng, tp.observables[name].op))
    jg = jax_pack_stream(jp.qubit_hamiltonian, n, teng.k)
    tg = pack_stream_groups(tp.qubit_hamiltonian, n, teng.k)
    assert list(jg) == list(tg)
    same([jg[k] for k in jg], [tg[k] for k in tg])
