"""The port's Lanczos resolvent (``qsfh_torch/linalg/spectral.py``) against
the JAX module (complex128, CPU), tolerance 1e-10.

* ``lanczos_tridiagonal`` from a seeded vector: alphas, betas and norm2
  at 2x2 (m = 20) and 2x3 (m = 12), each package's own H application.
* ``spectral_function_lanczos`` (site and momentum ladders, both branches)
  and ``dynamical_structure_factor`` (spin and charge) from the ground
  state: poles, weights, A(omega) and the sum rule.  At 2x2 the Krylov
  space of c^(dag)|gs> closes after 8 steps (breakdown, beta ~ 1e-13 by
  rounding, which differs between the packages around the 1e-12 cut), so
  there the poles carrying weight are compared.
* Breakdown truncation on an exactly closing Krylov space, the empty seed,
  and the device/dtype policy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.linalg import spectral as J
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.linalg import spectral as T
from qsfh_torch.ops.fermion import FermionOperator

TOL = 1e-10
CASES = {(2, 2): 20, (2, 3): 12}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", params=list(CASES), ids=lambda p: f"{p[0]}x{p[1]}")
def setup(request, tmp_path_factory):
    nx, ny = request.param
    n_e = nx * ny
    args = (nx, ny, 1.0, 6.0, n_e, (n_e + 1) // 2, n_e // 2)
    root = str(tmp_path_factory.mktemp("spectral"))
    tp = HubbardProblem(*args, results_root=root)
    e0, gs = tp.ground_state()
    return JaxProblem(*args, results_root=root), tp, e0, gs, CASES[request.param]


def _weighted(res, floor=1e-10):
    live = res["weights"] > floor
    return res["poles"][live], res["weights"][live]


def _compare(jres, tres, closed):
    assert abs(jres["norm2"] - tres["norm2"]) < TOL
    assert abs(jres["weights"].sum() - tres["weights"].sum()) < TOL
    if closed:  # compare the poles that carry weight
        (jp, jw), (tp_, tw) = _weighted(jres), _weighted(tres)
        assert jp.shape == tp_.shape
        np.testing.assert_allclose(tp_, jp, rtol=0, atol=1e-8)
        np.testing.assert_allclose(tw, jw, rtol=0, atol=TOL)
    else:
        np.testing.assert_allclose(tres["poles"], jres["poles"], rtol=0, atol=TOL)
        np.testing.assert_allclose(tres["weights"], jres["weights"], rtol=0, atol=TOL)
    if "A" in jres:
        np.testing.assert_allclose(tres["A"], jres["A"], rtol=0, atol=1e-9)


def test_lanczos_tridiagonal_matches_jax(setup):
    jp, tp, _, _, m = setup
    rng = np.random.default_rng(tp.n_qubits)
    phi = rng.standard_normal(1 << tp.n_qubits) + 1j * rng.standard_normal(1 << tp.n_qubits)
    ja, jb, jn = J.lanczos_tridiagonal(JaxObservable(jp.qubit_hamiltonian, jp.n_qubits).apply_auto,
                                       phi, m)
    ta, tb, tn = T.lanczos_tridiagonal(tp.observables["H"].apply_auto, torch.tensor(phi), m)
    assert ta.shape == tb.shape == (m,) and ja.shape == (m,)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=TOL)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=TOL)
    assert abs(tn - jn) < TOL * jn
    tw = T.resolvent_poles(ta, tb, tn)
    jw = J.resolvent_poles(ja, jb, jn)
    np.testing.assert_allclose(tw[0], jw[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(tw[1], jw[1], rtol=0, atol=TOL)


def _k_ladder(nx, ny, kx, ky, dagger, fermion_cls):
    op = fermion_cls.zero()
    for s in range(nx * ny):
        x, y = s % nx, s // nx
        phase = np.exp(1j * 2 * np.pi * (kx * x / nx + ky * y / ny)) / np.sqrt(nx * ny)
        op += fermion_cls(((2 * s, 1 if dagger else 0),), phase if dagger else np.conj(phase))
    return op


@pytest.mark.parametrize("kind", ["particle", "hole"])
@pytest.mark.parametrize("ladder", ["site", "momentum"])
def test_spectral_function_matches_jax(setup, kind, ladder):
    from qsfh_tpu.ops.fermion import FermionOperator as JaxFermion

    jp, tp, e0, gs, m = setup
    nx, ny = tp.x_dimension, tp.y_dimension
    if ladder == "site":
        jmode = tmode = 1
    else:
        dagger = kind == "particle"
        jmode = _k_ladder(nx, ny, 1, 0, dagger, JaxFermion)
        tmode = _k_ladder(nx, ny, 1, 0, dagger, FermionOperator)
    omegas = np.linspace(-4.0, 12.0, 41)
    jres = J.spectral_function_lanczos(jp, gs, e0, jmode, kind, m=m, omegas=omegas,
                                       dtype=jnp.complex128)
    tres = T.spectral_function_lanczos(tp, gs, e0, tmode, kind, m=m, omegas=omegas,
                                       device="cpu")
    _compare(jres, tres, closed=tp.n_qubits == 8)


@pytest.mark.parametrize("kind,q", [("spin", (1, 0)), ("spin", (0, 0)), ("charge", (1, 1)),
                                    ("charge", (0, 0))])
def test_dynamical_structure_factor_matches_jax(setup, kind, q):
    jp, tp, e0, gs, m = setup
    omegas = np.linspace(0.0, 10.0, 21)
    jres = J.dynamical_structure_factor(jp, gs, e0, q, kind=kind, m=m, omegas=omegas,
                                        eta=0.1, dtype=jnp.complex128)
    tres = T.dynamical_structure_factor(tp, torch.tensor(gs), e0, q, kind=kind, m=m,
                                        omegas=omegas, eta=0.1)
    if jres["norm2"] == 0.0:  # the mean-subtracted q = 0 charge seed vanishes
        assert tres["norm2"] < 1e-20 and tres["poles"].size == 0
        return
    _compare(jres, tres, closed=True)


def test_breakdown_truncation_matches_jax():
    # a diagonal H on a vector with 3 nonzero amplitudes: the Krylov space
    # closes after 3 steps in both packages
    d = np.linspace(-1.0, 2.0, 16)
    phi = np.zeros(16, dtype=np.complex128)
    phi[[1, 6, 11]] = [0.5, 1.0j, -0.3]
    ja, jb, jn = J.lanczos_tridiagonal(lambda v: jnp.asarray(d) * v, phi, 10)
    dt = torch.tensor(d)
    ta, tb, tn = T.lanczos_tridiagonal(lambda v: dt * v, torch.tensor(phi), 10)
    assert ja.shape == ta.shape == (3,)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=TOL)
    np.testing.assert_allclose(tb[:-1], jb[:-1], rtol=0, atol=TOL)
    assert tb[-1] < 1e-12 and jb[-1] < 1e-12
    poles, weights = T.resolvent_poles(ta, tb, tn)
    np.testing.assert_allclose(np.sort(poles), d[[1, 6, 11]], atol=1e-12)
    assert abs(weights.sum() - tn) < 1e-14
    # an empty seed: no poles
    a, b, n2 = T.lanczos_tridiagonal(lambda v: v, torch.zeros(16, dtype=torch.complex128), 5)
    assert a.size == b.size == 0 and n2 == 0.0
    assert all(x.size == 0 for x in T.resolvent_poles(a, b, n2))


def test_device_policy(setup, monkeypatch):
    _, tp, e0, gs, _ = setup
    with pytest.raises(ValueError, match="kind"):
        T.dynamical_structure_factor(tp, torch.tensor(gs), e0, (0, 1), kind="orbital")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.spectral_function_lanczos(tp, gs, e0, 1, m=2)  # a numpy state: the card
