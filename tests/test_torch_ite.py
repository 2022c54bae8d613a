"""The port's imaginary-time evolution (``algos/ite.py``) against the JAX
module (complex128, CPU).

* ``suggest_dbeta`` and one Taylor ``_step`` (state, energy, variance,
  log-weight) within 1e-12 at 2x2 (the per-term ``pauli_apply``) and 2x3
  (12 qubits: ``pauli_apply_grouped``'s plain version), orders 1, 2, 4;
* ``run`` in blocks with a remainder, and its variance stop: the energy
  and variance series and the final state within 1e-10;
* ``thermal_expectation`` fed the JAX draws (``draws=``, the sector states
  and the full-space Gaussians the JAX keys give): estimates, standard
  errors and weights within 1e-10; a ``torch.Generator`` draw repeats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos import ite as jite
from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.linalg.sectors import random_sector_state as jax_random_sector_state
from qsfh_torch.algos import ite as tite
from qsfh_torch.algos.base import HubbardProblem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states (several pytest workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _problems(nx, ny, u=6.0):
    n_e = nx * ny
    args = (nx, ny, 1.0, u, n_e, (n_e + 1) // 2, n_e // 2)
    return JaxProblem(*args), HubbardProblem(*args)


@pytest.fixture(scope="module")
def p2x2():
    return _problems(2, 2)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("size, order", [((2, 2), 1), ((2, 2), 4), ((2, 3), 2)])
def test_step_matches_jax(size, order):
    jp, tp = _problems(*size)
    assert tite.suggest_dbeta(tp.qubit_hamiltonian) == jite.suggest_dbeta(jp.qubit_hamiltonian)
    j = jite.ImaginaryTimeEvolution(jp, dbeta=0.02, order=order)
    t = tite.ImaginaryTimeEvolution(tp, dbeta=0.02, order=order, device="cpu")
    assert t.dtype == torch.complex128
    v = _random_state(tp.n_qubits, order)
    got = t._step(torch.tensor(v))
    ref = j._step(jnp.asarray(v))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-12)
    for a, b in zip(got[1:], ref[1:]):
        assert abs(float(a) - float(b)) <= 1e-12 * max(1.0, abs(float(b)))


def test_run_blocks_and_early_stop_match_jax(p2x2):
    jp, tp = p2x2
    j = jite.ImaginaryTimeEvolution(jp, dbeta=0.05, order=2)
    t = tite.ImaginaryTimeEvolution(tp, dbeta=0.05, order=2, device="cpu")
    v = _random_state(8, 3)
    psi_j, rec_j = j.run(v, n_steps=7, block=3)
    psi_t, rec_t = t.run(v, n_steps=7, block=3)
    np.testing.assert_allclose(psi_t.numpy(), psi_j, rtol=0, atol=1e-10)
    for key in ("energies", "variances"):
        assert rec_t[key].shape == (7,)
        np.testing.assert_allclose(rec_t[key], rec_j[key], rtol=0, atol=1e-10)
    tol = float(rec_j["variances"][3]) * 1.01  # stops after the second block
    _, stop_j = j.run(v, n_steps=12, block=2, variance_tol=tol)
    _, stop_t = t.run(v, n_steps=12, block=2, variance_tol=tol)
    assert len(stop_t["energies"]) == len(stop_j["energies"]) < 12
    np.testing.assert_allclose(stop_t["energies"], stop_j["energies"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("sector", [None, False])
def test_thermal_expectation_with_jax_draws(p2x2, sector):
    jp, tp = p2x2
    j = jite.ImaginaryTimeEvolution(jp, dbeta=0.05, order=4)
    t = tite.ImaginaryTimeEvolution(tp, dbeta=0.05, order=4, device="cpu")
    key, n_samples, beta = jax.random.PRNGKey(3), 4, 1.0
    draws = []
    for k in jax.random.split(key, n_samples):  # the JAX driver's draw, key by key
        if sector is False:
            kr, ki = jax.random.split(k)
            v = (np.asarray(jax.random.normal(kr, (256,), dtype=jnp.float64))
                 + 1j * np.asarray(jax.random.normal(ki, (256,), dtype=jnp.float64)))
            draws.append(v / np.linalg.norm(v))
        else:
            draws.append(np.asarray(jax_random_sector_state(8, 4, 2, key=k)))
    kw = {} if sector is None else dict(sector=False)
    est_j, diag_j = j.thermal_expectation(beta, {"H": jp.observables["H"]}, n_samples,
                                          key=key, **kw)
    est_t, diag_t = t.thermal_expectation(beta, {"H": tp.observables["H"]}, draws=draws)
    assert abs(est_t["H"] - est_j["H"]) <= 1e-10
    assert abs(diag_t["stderrs"]["H"] - diag_j["stderrs"]["H"]) <= 1e-10
    for name in ("beta_effective", "n_samples", "log_weight_spread", "effective_samples"):
        assert abs(diag_t[name] - diag_j[name]) <= 1e-10


def test_thermal_generator_draw_repeats(p2x2):
    _, tp = p2x2
    t = tite.ImaginaryTimeEvolution(tp, dbeta=0.05, order=2, device="cpu")
    obs = {"H": tp.observables["H"]}
    a = t.thermal_expectation(0.5, obs, 3, generator=torch.Generator().manual_seed(1))
    b = t.thermal_expectation(0.5, obs, 3, generator=torch.Generator().manual_seed(1))
    assert a[0] == b[0] and a[1]["n_samples"] == 3
    with pytest.raises(ValueError):
        tite.ImaginaryTimeEvolution(tp, order=0, device="cpu")
