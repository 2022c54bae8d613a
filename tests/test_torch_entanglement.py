"""The port's entanglement diagnostics (``qsfh_torch/ops/entanglement.py``)
against the JAX module (complex128, CPU): the reduced density matrix, the
von Neumann and Renyi entropies and the mutual information on seeded
states, ``site_qubits``, and the argument checks.  Tolerance 1e-10.
"""

import numpy as np
import pytest
import torch

from qsfh_tpu.ops import entanglement as J
from qsfh_torch.ops import entanglement as T

TOL = 1e-10


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


CASES = [(8, (0, 3)), (8, (5, 1, 2)), (10, T.site_qubits((0, 1))), (10, (9,))]


def test_site_qubits():
    assert T.site_qubits((0, 2, 5)) == J.site_qubits((0, 2, 5)) == (0, 1, 4, 5, 10, 11)


@pytest.mark.parametrize("n,keep", CASES)
def test_reduced_density_matrix(n, keep):
    v = _state(n, n + len(keep))
    got = T.reduced_density_matrix(torch.tensor(v), n, keep)
    np.testing.assert_allclose(got.numpy(), J.reduced_density_matrix(v, n, keep), atol=TOL)
    # a numpy state on the CPU on request
    got = T.reduced_density_matrix(v, n, keep, device="cpu")
    np.testing.assert_allclose(got.numpy(), J.reduced_density_matrix(v, n, keep), atol=TOL)


@pytest.mark.parametrize("n,keep", CASES)
def test_entropies(n, keep):
    v = _state(n, 2 * n + len(keep))
    psi = torch.tensor(v)
    for base in (np.e, 2.0):
        assert abs(T.entanglement_entropy(psi, n, keep, base)
                   - J.entanglement_entropy(v, n, keep, base)) < TOL
    for alpha in (0.5, 1.0, 2.0, 3.0):
        assert abs(T.renyi_entropy(psi, n, keep, alpha)
                   - J.renyi_entropy(v, n, keep, alpha)) < TOL


@pytest.mark.parametrize("n,a,b", [(8, (0,), (1, 2)), (10, (0, 1), (6, 7, 8))])
def test_mutual_information(n, a, b):
    v = _state(n, 7)
    got = T.mutual_information(torch.tensor(v), n, a, b, base=2.0)
    assert abs(got - J.mutual_information(v, n, a, b, base=2.0)) < TOL


def test_product_state_and_argument_checks():
    psi = torch.zeros(1 << 6, dtype=torch.complex128)
    psi[0b101100] = 1.0
    assert abs(T.entanglement_entropy(psi, 6, (0, 2))) < TOL
    for bad in ((0, 0), (6,), (-1,)):
        with pytest.raises(ValueError):
            T.entanglement_entropy(psi, 6, bad)
    with pytest.raises(ValueError, match="alpha"):
        T.renyi_entropy(psi, 6, (0,), alpha=0.0)
    with pytest.raises(ValueError, match="disjoint"):
        T.mutual_information(psi, 6, (0, 1), (1, 2))
