"""The port's dense-exact iQCC dressing (torch, complex128) against the JAX
package's (host numpy), at 8 qubits (the 2x2 Hubbard H) and 10 qubits (a
seeded Hermitian Pauli sum): ``fwht``, ``dense_to_paulisum``,
``paulisum_to_dense_fast``, ``dense_dis_generators`` (the same generator
order and nnz), ``dress_dense`` and ``DenseObservable`` (value and
gradient), and the matrices of ``utils.dense``, within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_torch.ops import dense_dressing as port
from qsfh_torch.ops.dressing import dis_generators
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.lattice import fermi_hubbard
from qsfh_torch.ops.pauli import PauliSum
from qsfh_torch.utils.dense import _qubit_masks_to_bit_masks, apply_paulisum_dense, \
    paulisum_to_dense
from qsfh_tpu.ops import dense_dressing as ref
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum
from qsfh_tpu.utils import dense as jax_dense
from qsfh_tpu.utils.dense import paulisum_to_dense as jax_paulisum_to_dense

TOL = 1e-10


def random_hermitian(n, n_terms, seed):
    """A seeded Hermitian Pauli sum: random masks, real string coefficients."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << n, n_terms).astype(np.uint64)
    z = rng.integers(0, 1 << n, n_terms).astype(np.uint64)
    c_str = rng.normal(size=n_terms)
    c = c_str * (1j) ** (np.bitwise_count(x & z) % 4)
    return PauliSum(x, z, c).simplify()


def _jax(P):
    return JaxPauliSum(P.x, P.z, P.c)


@pytest.fixture(scope="module", params=[8, 10], ids=["8q", "10q"])
def case(request):
    n = request.param
    H = jordan_wigner(fermi_hubbard(2, 2, 1.0, 4.0, periodic=True)) if n == 8 \
        else random_hermitian(n, 120, 3)
    gens = [P for _, P in dis_generators(H)][:5]
    taus = np.random.default_rng(n).normal(0, 0.6, len(gens))
    return n, H, gens, taus


def test_fwht():
    a = np.random.default_rng(0).normal(size=(3, 256)) + 1j * np.random.default_rng(1).normal(
        size=(3, 256))
    np.testing.assert_allclose(port.fwht(torch.as_tensor(a)).numpy(), ref.fwht(a), rtol=0,
                               atol=1e-12)


def test_paulisum_to_dense_fast_and_back(case):
    n, H, _, _ = case
    M = port.paulisum_to_dense_fast(H, n)
    M_ref = ref.paulisum_to_dense_fast(_jax(H), n)
    np.testing.assert_allclose(M.numpy(), M_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(M.numpy(), paulisum_to_dense(H, n), rtol=0, atol=TOL)
    back, back_ref = port.dense_to_paulisum(M, n), ref.dense_to_paulisum(M_ref, n)
    np.testing.assert_array_equal(back.x, back_ref.x)
    np.testing.assert_array_equal(back.z, back_ref.z)
    np.testing.assert_allclose(back.c, back_ref.c, rtol=0, atol=TOL)
    assert len(back) == len(H)


def test_dress_dense_and_dis(case):
    n, H, gens, taus = case
    M = port.paulisum_to_dense_fast(H, n)
    M_ref = jax_paulisum_to_dense(_jax(H), n)
    D = port.dress_dense(M, gens, taus, n)
    D_ref = ref.dress_dense(M_ref, [_jax(P) for P in gens], taus, n)
    np.testing.assert_allclose(D.numpy(), D_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(port.similarity(port.dressing_unitary(gens, taus, n), M).numpy(),
                               D.numpy(), rtol=0, atol=0)
    # the spectrum is kept: a similarity transform
    np.testing.assert_allclose(torch.linalg.eigvalsh(D).numpy(), np.linalg.eigvalsh(M_ref),
                               rtol=0, atol=1e-9)
    dis, nnz = port.dense_dis_generators(D, n)
    dis_ref, nnz_ref = ref.dense_dis_generators(D_ref, n)
    assert nnz == nnz_ref
    assert [f for f, _ in dis] == [f for f, _ in dis_ref]
    for (_, p), (_, q) in zip(dis, dis_ref):
        assert (p.x[0], p.z[0], p.c[0]) == (q.x[0], q.z[0], q.c[0])
    assert len(dis) > len(gens)


def test_dense_observable(case):
    n, H, gens, taus = case
    D = port.dress_dense(port.paulisum_to_dense_fast(H, n), gens, taus, n)
    rng = np.random.default_rng(n + 1)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi /= np.linalg.norm(psi)
    obs = port.DenseObservable(D, n)
    obs_ref = ref.DenseObservable(D.numpy(), n)
    np.testing.assert_allclose(obs.apply_auto(torch.as_tensor(psi)).numpy(),
                               np.asarray(obs_ref.apply_auto(jnp.asarray(psi))), rtol=0,
                               atol=TOL)
    p = torch.tensor(psi, requires_grad=True)
    e = obs.expectation_auto(p)
    e.backward()
    e_ref, g_ref = jax.value_and_grad(obs_ref.expectation_auto)(jnp.asarray(psi))
    assert float(e.detach()) == pytest.approx(float(e_ref), abs=TOL)
    # jax.grad of a real function of a complex input is conj(torch's .grad)
    np.testing.assert_allclose(p.grad.numpy(), np.conj(np.asarray(g_ref)), rtol=0, atol=TOL)
    assert port.DenseObservable(D, n, torch.complex64)._H.dtype == torch.complex64


def test_utils_dense(case):
    n, H, _, _ = case
    np.testing.assert_allclose(paulisum_to_dense(H, n), jax_paulisum_to_dense(_jax(H), n),
                               rtol=0, atol=TOL)
    psi = np.random.default_rng(n).normal(size=1 << n) + 0j
    np.testing.assert_allclose(apply_paulisum_dense(H, psi, n),
                               jax_dense.apply_paulisum_dense(_jax(H), psi, n), rtol=0, atol=TOL)
    for mask in (0, 1, 5, (1 << n) - 1, 0b1011):
        assert _qubit_masks_to_bit_masks(mask, n) == jax_dense._qubit_masks_to_bit_masks(mask, n)
