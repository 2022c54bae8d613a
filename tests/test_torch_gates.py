"""The port's gate-level engine against the JAX package's.

* Each gate of ``qsfh_torch.engine.gates`` against ``qsfh_tpu.engine.gates``
  on the same random state (n = 6-8, complex128): within 1e-12.
* Autograd through the gates (complex128 and complex64) against
  ``jax.grad`` of the same function: within 1e-10 / 1e-5 relative.
* ``diagonal_weight_vector``, ``HubbardProblem.coulomb_diagonal`` and the
  plain unrolled ``Observable.expectation`` / ``apply`` against JAX: within
  1e-12; ``expectation_value``'s analytic backward against autograd.
* The Slater-prep helpers of ``engine.circuits`` against JAX: within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine import circuits as jcircuits
from qsfh_tpu.engine import expectation as jexp
from qsfh_tpu.engine import gates as jgates
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine import circuits, gates
from qsfh_torch.engine.expectation import (
    Observable,
    diagonal_weight_vector,
    expectation_value,
)
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pauli import PauliSum
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states: the tier-1 run puts
    several pytest workers on the cores, where torch's thread pool waits
    on descheduled threads (10-40x slower); the results do not change."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _state(rng, n):
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _unitary(rng, d):
    q, r = np.linalg.qr(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _both(fn_t, fn_j, psi, *args):
    got = fn_t(torch.tensor(psi), *args)
    ref = fn_j(jnp.asarray(psi), *args)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("n", [6, 7, 8])
def test_pauli_strings_and_rotations(n):
    rng = np.random.default_rng(n)
    psi = _state(rng, n)
    for _ in range(6):
        x, z = (int(v) for v in rng.integers(0, 1 << n, size=2))
        theta = float(rng.uniform(-1, 1))
        for xx in (x, 0):  # the diagonal branch too
            got, ref = _both(gates.apply_pauli_string, jgates.apply_pauli_string, psi, n, xx, z)
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
            got, ref = _both(gates.pauli_rotation, jgates.pauli_rotation, psi, n, xx, z, theta)
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_generator_and_diagonal_rotations():
    n = 8
    rng = np.random.default_rng(3)
    psi = _state(rng, n)
    pool = hubbard_interaction_pool_simplified(2, 2)
    for g in pool[:6]:
        rot = jordan_wigner(g).rotation_terms()
        theta = float(rng.uniform(-1, 1))
        got, ref = _both(gates.generator_rotation, jgates.generator_rotation, psi, n, rot, theta)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        gate = circuits.GeneratorGate(g, n)
        np.testing.assert_allclose(gate(torch.tensor(psi), theta).numpy(), ref, rtol=0, atol=ATOL)
    diag = rng.standard_normal(1 << n)
    got = gates.diagonal_rotation(torch.tensor(psi), torch.tensor(diag), 0.37).numpy()
    ref = np.asarray(jgates.diagonal_rotation(jnp.asarray(psi), jnp.asarray(diag), 0.37))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [6, 8])
def test_dense_gates(n):
    rng = np.random.default_rng(10 + n)
    psi = _state(rng, n)
    U2, U4 = _unitary(rng, 2), _unitary(rng, 4)
    for q in (0, 3, n - 1):
        for fn_t, fn_j, args in (
            (gates.apply_one_qubit, jgates.apply_one_qubit, (n, U2, q)),
            (gates.pauli_x, jgates.pauli_x, (n, q)),
            (gates.rz, jgates.rz, (n, 0.41, q)),
            (gates.ry, jgates.ry, (n, -0.23, q)),
            (gates.rx, jgates.rx, (n, 0.77, q)),
        ):
            got, ref = _both(fn_t, fn_j, psi, *args)
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    for qa, qb in ((0, 1), (4, 1), (2, n - 1), (n - 1, 0)):
        for fn_t, fn_j, args in (
            (gates.apply_two_qubit, jgates.apply_two_qubit, (n, U4, qa, qb)),
            (gates.cnot, jgates.cnot, (n, qa, qb)),
            (gates.single_excitation, jgates.single_excitation, (n, 0.61, qa, qb)),
        ):
            got, ref = _both(fn_t, fn_j, psi, *args)
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_host_matrices_and_phases():
    for th in (0.3, -1.1):
        np.testing.assert_array_equal(gates.ry_matrix(th), jgates.ry_matrix(th))
        np.testing.assert_array_equal(gates.rx_matrix(th), jgates.rx_matrix(th))
        np.testing.assert_array_equal(gates.givens_plan_matrix(th, 0.7),
                                      jgates.givens_plan_matrix(th, 0.7))
    angles = [0.1 * q - 0.2 for q in range(7)]
    np.testing.assert_array_equal(gates.static_rz_layer_phases(angles, 7),
                                  jgates.static_rz_layer_phases(angles, 7))


def _chain_energy(mod, psi, n, thetas, obs):
    """A small differentiable circuit: rotations (one diagonal), a single
    excitation, an RY and a diagonal rotation, then <H>."""
    psi = mod.pauli_rotation(psi, n, 0b000101, 0b000110, thetas[0])
    psi = mod.pauli_rotation(psi, n, 0, 0b110000, thetas[1])
    psi = mod.single_excitation(psi, n, thetas[2], 1, 4)
    psi = mod.ry(psi, n, thetas[3], 2)
    psi = mod.rz(psi, n, thetas[1] * 0.5, 5)
    return obs.expectation(psi)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64], ids=["c128", "c64"])
def test_autograd_through_gates_matches_jax_grad(dtype):
    n = 6
    rng = np.random.default_rng(21)
    psi = _state(rng, n)
    th = rng.uniform(-1, 1, size=4)
    op = (jordan_wigner(hubbard_interaction_pool_simplified(2, 2)[0])
          + PauliSum.from_string("Z0 Z3", 0.5))
    jth = jnp.asarray(th)
    jobs = jexp.Observable(op, n)
    g_ref = np.asarray(jax.grad(lambda t: _chain_energy(jgates, jnp.asarray(psi), n, t, jobs))(jth))
    tth = torch.tensor(th, dtype=torch.float64 if dtype == torch.complex128 else torch.float32,
                       requires_grad=True)
    e = _chain_energy(gates, torch.tensor(psi).to(dtype), n, tth, Observable(op, n))
    e.backward()
    tol = 1e-10 if dtype == torch.complex128 else 1e-5
    assert np.abs(tth.grad.double().numpy() - g_ref).max() <= tol * max(1.0, np.abs(g_ref).max())


def test_weight_vectors_and_plain_observables():
    p = JaxProblem(2, 2, 1.0, 6.0, 4, 2, 2)
    tp = HubbardProblem(2, 2, 1.0, 6.0, 4, 2, 2)
    n = p.n_qubits
    D = diagonal_weight_vector(tp.qubit_hamiltonian, n).numpy()
    D_ref = np.asarray(jexp.diagonal_weight_vector(p.qubit_hamiltonian, n))
    np.testing.assert_allclose(D, D_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tp.coulomb_diagonal().numpy(), np.asarray(p.coulomb_diagonal()),
                               rtol=0, atol=ATOL)
    psi = _state(np.random.default_rng(4), n)
    for key in ("H", "Sz", "S^2"):
        obs, jobs = tp.observables[key], p.observables[key]
        np.testing.assert_allclose(float(obs.expectation(torch.tensor(psi))),
                                   float(jobs.expectation(jnp.asarray(psi))), rtol=0, atol=ATOL)
        np.testing.assert_allclose(obs.apply(torch.tensor(psi)).numpy(),
                                   np.asarray(jobs.apply(jnp.asarray(psi))), rtol=0, atol=ATOL)


def test_expectation_value_backward_is_the_analytic_cotangent():
    tp = HubbardProblem(2, 2, 1.0, 4.0, 4, 2, 2)
    obs = tp.observables["H"]
    psi = torch.tensor(_state(np.random.default_rng(8), tp.n_qubits), requires_grad=True)
    (g_auto,) = torch.autograd.grad(obs.expectation(psi), psi)
    (g_adj,) = torch.autograd.grad(expectation_value(obs, psi), psi)
    np.testing.assert_allclose(g_adj.numpy(), g_auto.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
def test_givens_network_and_slater_state(dims):
    x, y = dims
    ne = x * y
    p = JaxProblem(x, y, 1.0, 4.0, ne, ne // 2, ne - ne // 2)
    n = p.n_qubits
    occ = p.spin_up_indices + p.spin_down_indices
    psi = _state(np.random.default_rng(n), n)
    got = circuits.apply_givens_network(torch.tensor(psi), n, p.diagonal, p.decomposition)
    ref = jcircuits.apply_givens_network(jnp.asarray(psi), n, p.diagonal, p.decomposition)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    back = circuits.apply_givens_network_adjoint(got, n, p.diagonal, p.decomposition)
    ref_back = jcircuits.apply_givens_network_adjoint(ref, n, p.diagonal, p.decomposition)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref_back), rtol=0, atol=ATOL)
    np.testing.assert_allclose(back.numpy(), psi, rtol=0, atol=ATOL)
    s = circuits.slater_prep_state(n, occ, p.diagonal, p.decomposition)
    s_ref = jcircuits.slater_prep_state(n, occ, p.diagonal, p.decomposition)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=ATOL)
