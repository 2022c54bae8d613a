"""The port's real-time dynamics (``algos/dynamics.py``) against the JAX
module (complex128, CPU).

* Lie and Strang steps (one rot segment of two angles) equal the JAX
  steps (the Coulomb diagonal and the hopping classes on the gates),
  global phase included, within 1e-12: 2x2 (the per-term kernels' route)
  and 2x3 (12 qubits: the resident and the tile-run routes, their plain
  versions here);
* ``evolve`` records (observables, overlaps) and the final state within
  1e-10 of the JAX scan; a ``ScheduledEvolution`` ramp of both couplings
  with its ``shift_phase``; the particle and hole ``greens_function``
  (2x2, and 2x3 for the particle);
* ``neel_occupied``, ``excitation_operator``, ``apply_on_host`` and the
  argument checks as the JAX module has them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos import dynamics as jdyn
from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.ops.jw import jordan_wigner as jax_jordan_wigner
from qsfh_torch.algos import dynamics as tdyn
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine import streaming
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.engine.state import basis_state
from qsfh_torch.ops.jw import jordan_wigner

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states (several pytest workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _problems(nx, ny, u=4.0):
    n_e = nx * ny
    args = (nx, ny, 1.0, u, n_e, (n_e + 1) // 2, n_e // 2)
    return JaxProblem(*args), HubbardProblem(*args)


@pytest.fixture(scope="module")
def quench_2x2():
    return _problems(2, 2)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("order", [1, 2])
def test_steps_match_jax_2x2(quench_2x2, order):
    jp, tp = quench_2x2
    v = _random_state(8, order)
    j = jdyn.TrotterEvolution(jp, dt=0.07, order=order)
    t = tdyn.TrotterEvolution(tp, dt=0.07, order=order, device="cpu")
    assert t.dtype == torch.complex128 and len(t.segment) > 0
    got = t.step(torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(j.step(jnp.asarray(v))), rtol=0, atol=TOL)
    got = t.step(torch.tensor(v), t_scale=0.7, u_scale=1.3).numpy()
    ref = np.asarray(j.step(jnp.asarray(v), 0.7, 1.3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("route", ["resident", "tile_runs"])
def test_strang_evolve_2x3_matches_jax(route, monkeypatch):
    if route == "tile_runs":
        monkeypatch.setattr(streaming, "CHAIN_MAX_QUBITS", 10)
    jp, tp = _problems(2, 3)
    occ = tdyn.neel_occupied(2, 3)
    assert occ == jdyn.neel_occupied(2, 3)
    psi0 = basis_state(12, occ)
    j = jdyn.TrotterEvolution(jp, dt=0.05, order=2)
    t = tdyn.TrotterEvolution(tp, dt=0.05, order=2, device="cpu")
    ud = jordan_wigner(tp.interacting_term)
    jobs = {"UD": JaxObservable(jax_jordan_wigner(jp.interacting_term), 12)}
    psi_j, rec_j = j.evolve(psi0.numpy(), 3, observables=jobs)
    psi_t, rec_t = t.evolve(psi0, 3, observables={"UD": Observable(ud, 12)})
    np.testing.assert_allclose(psi_t.numpy(), psi_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rec_t["UD"], rec_j["UD"], rtol=0, atol=1e-10)


def test_evolve_records_and_overlaps_match_jax(quench_2x2):
    jp, tp = quench_2x2
    psi0 = basis_state(8, tdyn.neel_occupied(2, 2)).numpy()
    ref = _random_state(8, 3)
    j = jdyn.TrotterEvolution(jp, dt=0.1, order=1)
    t = tdyn.TrotterEvolution(tp, dt=0.1, order=1, device="cpu")
    psi_j, rec_j = j.evolve(psi0, 6, observables={"H": jp.observables["H"]},
                            overlaps={"ref": ref, "self": psi0})
    psi_t, rec_t = t.evolve(psi0, 6, observables={"H": tp.observables["H"]},
                            overlaps={"ref": ref, "self": psi0})
    np.testing.assert_allclose(psi_t.numpy(), psi_j, rtol=0, atol=1e-10)
    assert sorted(rec_t) == sorted(rec_j)
    for name in rec_j:
        assert rec_t[name].shape == (6,)
        np.testing.assert_allclose(rec_t[name], rec_j[name], rtol=0, atol=1e-10)
    _, empty = t.evolve(psi0, 0, observables={"H": tp.observables["H"]}, overlaps={"r": ref})
    assert empty["H"].shape == empty["r"].shape == (0,)
    with pytest.raises(ValueError, match="namespace"):
        t.evolve(psi0, 1, observables={"H": tp.observables["H"]}, overlaps={"H": ref})


def test_scheduled_ramp_matches_jax(quench_2x2):
    jp, tp = quench_2x2
    psi0 = basis_state(8, tdyn.neel_occupied(2, 2)).numpy()
    ramp = dict(coulomb=lambda tau: 4.0 + 8.0 * tau, tunneling=np.linspace(1.0, 0.5, 5))
    j = jdyn.ScheduledEvolution(jp, dt=0.08, order=2)
    t = tdyn.ScheduledEvolution(tp, dt=0.08, order=2, device="cpu")
    psi_j, rec_j = j.evolve(psi0, 5, observables={"H": jp.observables["H"]},
                            overlaps={"psi0": psi0}, **ramp)
    psi_t, rec_t = t.evolve(psi0, 5, observables={"H": tp.observables["H"]},
                            overlaps={"psi0": psi0}, **ramp)
    np.testing.assert_allclose(psi_t.numpy(), psi_j, rtol=0, atol=1e-10)
    for name in ("H", "psi0", "shift_phase"):
        np.testing.assert_allclose(rec_t[name], rec_j[name], rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="one value per step"):
        t.evolve(psi0, 5, coulomb=np.ones(3))
    with pytest.raises(ValueError, match="reserved"):
        t.evolve(psi0, 1, overlaps={"shift_phase": psi0})


@pytest.mark.parametrize("kind, mode", [("particle", 2), ("hole", 5)])
def test_greens_function_matches_jax(quench_2x2, kind, mode):
    jp, tp = quench_2x2
    gs = _random_state(8, 7)
    tj, gj = jdyn.greens_function(jp, gs, -3.1, mode, dt=0.1, n_steps=5, kind=kind)
    tt, gt = tdyn.greens_function(tp, gs, -3.1, mode, dt=0.1, n_steps=5, kind=kind,
                                  device="cpu")
    np.testing.assert_allclose(tt, tj, rtol=0, atol=0)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10)


def test_greens_function_2x3_matches_jax():
    """12 qubits: the excitation applied through ``apply_auto`` and the
    steps on the resident route's plain version."""
    jp, tp = _problems(2, 3)
    gs = _random_state(12, 9)
    tj, gj = jdyn.greens_function(jp, gs, -5.2, 4, dt=0.05, n_steps=4)
    tt, gt = tdyn.greens_function(tp, gs, -5.2, 4, dt=0.05, n_steps=4, device="cpu")
    np.testing.assert_allclose(tt, tj, rtol=0, atol=0)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10)


def test_helpers_and_checks_match_jax(quench_2x2):
    _, tp = quench_2x2
    for mode, kind in ((3, "particle"), (7, "particle"), (1, "hole")):
        j = jdyn.excitation_operator(mode, kind)
        t = tdyn.excitation_operator(mode, kind)
        assert dict(t.terms) == dict(j.terms)
    op = tdyn.excitation_operator(2)
    assert tdyn.excitation_operator(op) is op
    with pytest.raises(ValueError):
        tdyn.excitation_operator(0, "other")
    v = _random_state(8, 11)
    jo = JaxObservable(jax_jordan_wigner(jdyn.excitation_operator(3, "hole")), 8)
    to = Observable(jordan_wigner(tdyn.excitation_operator(3, "hole")), 8)
    ref = jdyn.apply_on_host(jo, v, jnp.complex128)
    np.testing.assert_allclose(tdyn.apply_on_host(to, v), ref, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tdyn.apply_on_host(to, torch.tensor(v)), ref, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="order"):
        tdyn.TrotterEvolution(tp, dt=0.1, order=3, device="cpu")
