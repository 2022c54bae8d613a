"""Host operator layer of the port against the JAX package.

The port copies the numpy-only modules (fermion algebra, Jordan-Wigner,
lattice, Fourier, Givens, pool) rather than importing them; these tests
hold the copies to IDENTICAL arrays: the PauliSum x/z/c of H, Sz and S^2,
the flat per-term arrays the kernels consume, the pool, the occupied
momentum modes and the static Givens network.  No statevector is involved,
so the 3x3 lattice is cheap here.
"""

import jax  # noqa: F401  (the conftest pins JAX to the CPU with x64)
import numpy as np
import pytest

from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.compiled import givens_network_static_ops as jax_network
from qsfh_tpu.engine.expectation import PackedPool as JaxPool
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.pool import hubbard_interaction_pool_simplified as jax_pool_ops
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine.compiled import givens_network_static_ops
from qsfh_torch.engine.expectation import PackedPool
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

# (x, y, t, U, n_electrons, up, down)
CONFIGS = {
    "2x2": (2, 2, 1, 4, 4, 2, 2),
    "2x3": (2, 3, 1, 4, 6, 3, 3),
    "3x3": (3, 3, 1, 6, 9, 5, 4),
}

_cache = {}


def _problems(name, tmp_path_factory):
    if name not in _cache:
        root = str(tmp_path_factory.mktemp("ops"))
        args = CONFIGS[name]
        _cache[name] = (JaxProblem(*args, results_root=root), HubbardProblem(*args, results_root=root))
    return _cache[name]


def _pools(name):
    key = ("pool", name)
    if key not in _cache:
        x, y = CONFIGS[name][:2]
        jops, tops = jax_pool_ops(x, y), hubbard_interaction_pool_simplified(x, y)
        n = 2 * x * y
        _cache[key] = (
            jops, tops,
            JaxPool([jax_jw(g) for g in jops], n), PackedPool([jordan_wigner(g) for g in tops], n),
        )
    return _cache[key]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pauli_sums_identical(name, tmp_path_factory):
    jp, tp = _problems(name, tmp_path_factory)
    for key in ("H", "Sz", "S^2"):
        jop, top = jp.observables[key].op, tp.observables[key].op
        _same(jop.x, top.x)
        _same(jop.z, top.z)
        _same(jop.c, top.c)
    _same(jp.qubit_hamiltonian.c, tp.qubit_hamiltonian.c)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scan_terms_identical(name, tmp_path_factory):
    jp, tp = _problems(name, tmp_path_factory)
    for key in ("H", "Sz", "S^2"):
        for a, b in zip(jp.observables[key]._scan_terms(), tp.observables[key]._scan_terms()):
            _same(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pool_identical(name):
    jops, tops, jpacked, tpacked = _pools(name)
    assert len(jops) == len(tops)
    for a, b in zip(jops, tops):
        assert a.terms == b.terms
    assert jpacked.size == tpacked.size
    for a, b in zip(jpacked.scan_arrays(), tpacked.scan_arrays()):
        _same(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_occupied_modes_identical(name, tmp_path_factory):
    jp, tp = _problems(name, tmp_path_factory)
    assert jp.spin_up_indices == tp.spin_up_indices
    assert jp.spin_down_indices == tp.spin_down_indices
    if name == "3x3":
        assert tuple(tp.spin_up_indices + tp.spin_down_indices) == (0, 2, 4, 6, 12, 1, 3, 5, 7)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_givens_network_identical(name, tmp_path_factory):
    jp, tp = _problems(name, tmp_path_factory)
    _same(jp.diagonal, tp.diagonal)
    assert jp.decomposition == tp.decomposition
    jops, jphase = jax_network(jp.n_qubits, jp.diagonal, jp.decomposition)
    tops, tphase = givens_network_static_ops(tp.n_qubits, tp.diagonal, tp.decomposition)
    assert jops == tops
    assert jphase == tphase


def test_config_tags_identical(tmp_path_factory):
    jp, tp = _problems("3x3", tmp_path_factory)
    assert jp.tag("ADAPT") == tp.tag("ADAPT")
    assert jp.ground_state_path() == tp.ground_state_path()
