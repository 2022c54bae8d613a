"""The port's product-state module against the JAX one (complex128, CPU).

* ``product_state`` (built by halves, log-magnitudes summed) against the
  JAX ``product_state_host`` at n = 10-12 within 1e-13, pinned qubits
  included (no NaN);
* the closed forms (``product_pair_term_values``, ``product_expectation``,
  ``rotated_hamiltonian``, ``hermitian_string``) against the JAX functions
  on the 2x3 Hamiltonian within 1e-12, and against the dense state;
* the engine on a product state, both rotation routes (the resident
  kernels' and the tile runs', their plain versions here), against the
  closed forms, as ``chip_smoke.phase_product_state`` holds the kernels at
  26-30 qubits: E and |psi|^2, a rotated segment's E (the segment of
  ``rotation_ops`` equals the JAX gates' rotations within 1e-12), its
  adjoint gradient with lambda = 2 H psi against central differences of
  the closed form, the screen of two product states against 2 Im V_t,
  and <phi|H psi> against sum_t V_t.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine import product_state as jps
from qsfh_tpu.engine.gates import pauli_rotation as jax_pauli_rotation
from qsfh_torch.engine import product_state as tps
from qsfh_torch.engine import streaming
from qsfh_torch.engine.compiled import CompiledCircuit, run_rot_adjoint
from qsfh_torch.engine.expectation import Observable, PackedPool
from qsfh_torch.ops.pauli import PauliSum

N = 12
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states (several pytest workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _angles(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.4, 2.7, n), rng.uniform(-np.pi, np.pi, n)


def _port(op):
    return PauliSum(np.asarray(op.x), np.asarray(op.z), np.asarray(op.c))


@pytest.fixture(scope="module")
def ham():
    """The 2x3 Hubbard Hamiltonian (t=1, U=6), JAX's and the port's."""
    h = JaxProblem(2, 3, 1.0, 6.0, 6, 3, 3).qubit_hamiltonian
    return h, _port(h)


# hopping-like rotations (X X, Y Y strings across the register) and a Z Z one
ROTS = [((1 << 0) | (1 << 11), 0, 0.37), ((1 << 1) | (1 << 10), (1 << 1) | (1 << 10), -0.52),
        ((1 << 2) | (1 << 5), 1 << 2, 0.61), (0, 0b11, 0.44), ((1 << 3) | (1 << 4), 1 << 4, -0.28),
        ((1 << 6) | (1 << 9), (1 << 6) | (1 << 9), 0.73)]


@pytest.mark.parametrize("n", [10, 11, 12])
def test_product_state_matches_jax_host(n):
    th, al = _angles(n, n)
    ref = jps.product_state_host(n, th, al)
    got = tps.product_state(n, th, al, "cpu", dtype=torch.complex128).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)
    np.testing.assert_allclose(tps.product_state_host(n, th, al), ref, rtol=0, atol=0)
    assert abs(np.vdot(got, got).real - 1.0) < 1e-13


def test_pinned_qubits_and_signs_no_nan():
    th = np.array([0.0, np.pi, 2.0, -1.0, 3.5, 0.0, 1.0, np.pi, 0.3, 5.0])
    al = np.linspace(-3.0, 3.0, th.size)
    got = tps.product_state(th.size, th, al, "cpu", dtype=torch.complex128).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jps.product_state_host(th.size, th, al), rtol=0, atol=1e-13)


def test_closed_forms_match_jax(ham):
    jh, th_op = ham
    ang, w_ang = _angles(1), _angles(2)
    np.testing.assert_allclose(tps.product_pair_term_values(th_op, N, w_ang, ang),
                               jps.product_pair_term_values(jh, N, w_ang, ang), rtol=0, atol=TOL)
    e = tps.product_expectation(th_op, N, *ang)
    assert abs(e - jps.product_expectation(jh, N, *ang)) <= TOL
    psi = tps.product_state(N, *ang, "cpu", dtype=torch.complex128)
    assert abs(e - float(Observable(th_op, N).expectation(psi))) <= 1e-11
    for x, z in ((0b101, 0b110), (0b11, 0b11), (0, 0b1001)):
        j, t = jps.hermitian_string(x, z), tps.hermitian_string(x, z)
        assert (list(t.x), list(t.z), list(t.c)) == (list(j.x), list(j.z), list(j.c))
    jd, td = jps.rotated_hamiltonian(jh, ROTS), tps.rotated_hamiltonian(th_op, ROTS)
    assert len(td) == len(jd)
    assert abs(tps.product_expectation(td, N, *ang) - jps.product_expectation(jd, N, *ang)) <= TOL


def test_rotation_ops_segment_matches_jax_gates():
    """The segment of rotation_ops is U = exp(-i th_T P_T) ... exp(-i th_0
    P_0), P_t = hermitian_string(x_t, z_t), as the JAX gates rotate."""
    ang = _angles(3)
    psi = tps.product_state(N, *ang, "cpu", dtype=torch.complex128)
    ops, thetas = tps.rotation_ops(N, ROTS)
    cc = CompiledCircuit(ops, N)
    assert len(cc.segments) == 1 and len(cc.segments[0]) == len(ROTS)
    got = cc.apply(psi, torch.tensor(thetas)).numpy()
    ref = jnp.asarray(psi.numpy())
    for x, z, theta in ROTS:
        ref = jax_pauli_rotation(ref, N, x, z, theta)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        tps.rotation_ops(4, [(1 << 4, 0, 0.1)])


@pytest.fixture(params=["resident", "tile_runs"])
def route(request, monkeypatch):
    """The rotation route of a 12-qubit segment: the resident kernels'
    (the chain cap at 18) or the tile runs' (the cap below 12)."""
    if request.param == "tile_runs":
        monkeypatch.setattr(streaming, "CHAIN_MAX_QUBITS", 10)
    return request.param


def test_engine_on_product_states_matches_closed_forms(ham, route):
    _, th_op = ham
    ang, phi_ang = _angles(4), _angles(5)
    obs = Observable(th_op, N)
    psi = tps.product_state(N, *ang, "cpu", dtype=torch.complex128)
    assert abs(float(obs.expectation_scan(psi)) - tps.product_expectation(th_op, N, *ang)) <= 1e-11
    # the rotated state's energy against the dressed closed form
    ops, thetas = tps.rotation_ops(N, ROTS)
    cc = CompiledCircuit(ops, N)
    (seg,) = cc.segments
    th = torch.tensor(thetas)
    rotated = cc.apply(psi, th)
    e_rot = tps.product_expectation(tps.rotated_hamiltonian(th_op, ROTS), N, *ang)
    assert abs(float(obs.expectation_scan(rotated)) - e_rot) <= 1e-11
    # the adjoint gradient with lambda = 2 H psi against central differences
    lam = 2.0 * obs.apply_scan(rotated)
    grads = run_rot_adjoint(seg, rotated, lam, th, N)[2].numpy()
    h = 1e-5
    fd = []
    for t in range(len(ROTS)):
        e = []
        for d in (h, -h):
            shifted = [(x, z, a + (d if k == t else 0.0)) for k, (x, z, a) in enumerate(ROTS)]
            e.append(tps.product_expectation(tps.rotated_hamiltonian(th_op, shifted), N, *ang))
        fd.append((e[0] - e[1]) / (2 * h))
    fd = np.asarray(fd)
    assert np.abs(grads - fd).max() <= 1e-8 * np.abs(fd).max()
    # the screen of two product states and <phi|H psi>
    vals = tps.product_pair_term_values(th_op, N, phi_ang, ang)
    phi = tps.product_state(N, *phi_ang, "cpu", dtype=torch.complex128)
    pool = PackedPool([PauliSum([x], [z], [1.0]) for x, z in zip(th_op.x, th_op.z)], N)
    # one generator per term of H: 2 Im (c_adj <phi|D_z X_x|psi>), c = 1
    screen = pool.screen_scan(psi, phi).numpy()
    unit = tps.product_pair_term_values(PauliSum(th_op.x, th_op.z, np.ones(len(th_op))), N,
                                        phi_ang, ang)
    np.testing.assert_allclose(screen, 2.0 * unit.imag, rtol=0, atol=1e-12)
    h_psi = obs.apply_scan(psi)
    assert abs(complex(torch.vdot(phi, h_psi)) - vals.sum()) <= 1e-11
