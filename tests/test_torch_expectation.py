"""``Observable`` and ``PackedPool`` of the port against the JAX package.

``expectation_scan`` and ``apply_scan`` for H, Sz and S^2, and
``screen_scan`` over the full pool, on random 2x2 and 2x3 states at
complex128 within 1e-10 (JAX on its XLA scan path); the same for one
18-qubit 3x3 state, with a slice of the 3x3 pool.  ``PackedPool.screen``
(the JAX package's unrolled screen) against JAX's ``screen`` and the
port's ``screen_scan``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.expectation import PackedPool as JaxPool
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.pool import hubbard_interaction_pool_simplified as jax_pool_ops
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine.expectation import PackedPool
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

TOL = 1e-10
CONFIGS = {"2x2": (2, 2, 1, 4, 4, 2, 2), "2x3": (2, 3, 1, 4, 6, 3, 3)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _state(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module", params=list(CONFIGS))
def problems(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("exp"))
    args = CONFIGS[request.param]
    return JaxProblem(*args, results_root=root), HubbardProblem(*args, results_root=root)


@pytest.mark.parametrize("key", ["H", "Sz", "S^2"])
def test_expectation_and_apply(problems, key):
    jp, tp = problems
    n = tp.n_qubits
    psi = _state(n, n)
    jobs, tobs = jp.observables[key], tp.observables[key]
    ref_e = float(jobs.expectation_scan(jnp.asarray(psi)))
    got_e = float(tobs.expectation_scan(torch.as_tensor(psi)))
    assert abs(got_e - ref_e) <= TOL * max(1.0, abs(ref_e))
    ref_a = np.asarray(jobs.apply_scan(jnp.asarray(psi)))
    got_a = tobs.apply_scan(torch.as_tensor(psi))
    assert got_a.dtype == torch.complex128
    assert _rel(got_a.numpy(), ref_a) <= TOL


def test_screen_full_pool(problems):
    jp, tp = problems
    n = tp.n_qubits
    x, y = tp.x_dimension, tp.y_dimension
    jpool = JaxPool([jax_jw(g) for g in jax_pool_ops(x, y)], n)
    tpool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(x, y)], n)
    psi, w = _state(1, n), _state(2, n)
    ref = np.asarray(jpool.screen_scan(jnp.asarray(psi), jnp.asarray(w)))
    got = tpool.screen_scan(torch.as_tensor(psi), torch.as_tensor(w))
    assert got.shape == (tpool.size,)
    assert _rel(got.numpy(), ref) <= TOL


def test_screen_matches_jax_screen_and_screen_scan(problems):
    _, tp = problems
    n = tp.n_qubits
    x, y = tp.x_dimension, tp.y_dimension
    jpool = JaxPool([jax_jw(g) for g in jax_pool_ops(x, y)], n)
    tpool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(x, y)], n)
    psi, w = _state(3, n), _state(4, n)
    ref = np.asarray(jpool.screen(jnp.asarray(psi), jnp.asarray(w)))
    got = tpool.screen(torch.as_tensor(psi), torch.as_tensor(w))
    assert got.shape == (tpool.size,) and got.dtype == torch.float64
    assert _rel(got.numpy(), ref) <= TOL
    scan = tpool.screen_scan(torch.as_tensor(psi), torch.as_tensor(w))
    assert torch.equal(got, scan)


@pytest.fixture(scope="module")
def problems_3x3(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("exp33"))
    args = (3, 3, 1, 6, 9, 5, 4)
    return JaxProblem(*args, results_root=root), HubbardProblem(*args, results_root=root)


@pytest.mark.parametrize("key", ["H", "Sz", "S^2"])
def test_expectation_and_apply_3x3(problems_3x3, key):
    """One 18-qubit state of the main path's lattice."""
    jp, tp = problems_3x3
    psi = _state(33, tp.n_qubits)
    jobs, tobs = jp.observables[key], tp.observables[key]
    ref_e = float(jobs.expectation_scan(jnp.asarray(psi)))
    got_e = float(tobs.expectation_scan(torch.as_tensor(psi)))
    assert abs(got_e - ref_e) <= TOL * max(1.0, abs(ref_e))
    ref_a = np.asarray(jobs.apply_scan(jnp.asarray(psi)))
    assert _rel(tobs.apply_scan(torch.as_tensor(psi)).numpy(), ref_a) <= TOL


def test_screen_3x3_pool_slice(problems_3x3):
    """The first 40 generators of the 3x3 pool on an 18-qubit state (the
    full 2592-term pool takes ~20 s through the CPU plain version; the
    chip smoke test holds it on the card)."""
    n = 18
    jpool = JaxPool([jax_jw(g) for g in jax_pool_ops(3, 3)[:40]], n)
    tpool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(3, 3)[:40]], n)
    psi, w = _state(3, n), _state(4, n)
    ref = np.asarray(jpool.screen_scan(jnp.asarray(psi), jnp.asarray(w)))
    got = tpool.screen_scan(torch.as_tensor(psi), torch.as_tensor(w))
    assert _rel(got.numpy(), ref) <= TOL
