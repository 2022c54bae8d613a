"""The port's symbolic iQCC dressing against the JAX package's.

``dis_generators``, ``dress_once`` (the single-string fast path and the
generic products), ``compact`` and ``dress_hamiltonian`` (with
``max_terms`` and ``compaction_eps``) on the 2x2 Hubbard H dressed by
seeded (P, tau) lists past the 2048 terms where the JAX package hands the
dressing and the merge to its C++ routines: the same terms in the same
order, coefficients within 1e-12, the same dropped count and weight.
"""

import numpy as np
import pytest

from qsfh_torch.ops import dressing as port
from qsfh_torch.ops.jw import jordan_wigner as port_jw
from qsfh_torch.ops.lattice import fermi_hubbard as port_fh
from qsfh_torch.ops.pauli import PauliSum
from qsfh_tpu.ops import dressing as ref
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fh
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum


def _to_port(P):
    return PauliSum(P.x, P.z, P.c)


def _to_jax(P):
    return JaxPauliSum(P.x, P.z, P.c)


def _same_sum(got, want, atol=1e-12):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.z, want.z)
    np.testing.assert_allclose(got.c, want.c, rtol=0, atol=atol)


def _same_dis(got, want):
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, p), (_, q) in zip(got, want):
        _same_sum(p, q, atol=0)


@pytest.fixture(scope="module")
def dressed():
    """(port H, JAX H, port H1, JAX H1, seeded lists): the 2x2 H and the
    same H dressed by its 8 DIS generators at seeded angles (513 terms)."""
    H_p = port_jw(port_fh(2, 2, 1.0, 4.0, periodic=True))
    H_j = jax_jw(jax_fh(2, 2, 1.0, 4.0, periodic=True))
    _same_sum(H_p, H_j, atol=0)
    rng = np.random.default_rng(5)
    gens = [P for _, P in port.dis_generators(H_p)]
    taus = rng.normal(0, 0.4, len(gens))
    H1_p, _, _ = port.dress_hamiltonian(H_p, gens, taus)
    H1_j, _, _ = ref.dress_hamiltonian(H_j, [_to_jax(P) for P in gens], taus)
    _same_sum(H1_p, H1_j)
    return H_p, H_j, H1_p, H1_j, rng


def test_dis_generators(dressed):
    H_p, H_j, H1_p, H1_j, _ = dressed
    _same_dis(port.dis_generators(H_p), ref.dis_generators(H_j))
    _same_dis(port.dis_generators(H1_p), ref.dis_generators(H1_j))
    assert len(port.dis_generators(H1_p)) == 63


@pytest.mark.parametrize("tau", [0.0, 0.37, -1.3])
def test_dress_once_fast_path(dressed, tau):
    _, _, H1_p, H1_j, _ = dressed
    P = PauliSum.from_string("Y1 X2 X5")
    _same_sum(port.dress_once(H1_p, P, tau), ref.dress_once(H1_j, _to_jax(P), tau))


def test_dress_once_generic_path(dressed):
    """A two-string P (not a single involutory string): the commutator
    products."""
    H_p, H_j, _, _, _ = dressed
    P = PauliSum.from_terms([("Y0 X1", 0.6), ("X2 Z3", 0.8)])
    got = port.dress_once(H_p, P, 0.41)
    _same_sum(got, ref.dress_once(H_j, _to_jax(P), 0.41))
    assert len(got) > len(H_p)


def test_compact(dressed):
    _, _, H1_p, H1_j, _ = dressed
    for eps in (0.0, 1e-3, 0.05):
        got, k, w = port.compact(H1_p, eps)
        want, k_j, w_j = ref.compact(H1_j, eps)
        _same_sum(got, want, atol=0)
        assert k == k_j
        assert w == pytest.approx(w_j, abs=1e-15)
    assert port.compact(H1_p, 0.05)[1] > 0


@pytest.mark.parametrize("max_terms, eps", [(None, None), (2600, None), (None, 2e-3),
                                            (1500, 2e-3)])
def test_dress_hamiltonian_past_merge_size(dressed, max_terms, eps):
    """12 of H1's DIS generators at seeded angles: 3880 terms, past the
    2048 where the JAX package switches to its C++ dressing and merge."""
    _, _, H1_p, H1_j, _ = dressed
    rng = np.random.default_rng(5)
    pool = [P for _, P in port.dis_generators(H1_p)]
    pick = rng.choice(len(pool), 12, replace=False)
    gens = [pool[i] for i in pick]
    taus = rng.normal(0, 0.4, 12)
    got, dropped, weight = port.dress_hamiltonian(H1_p, gens, taus, max_terms=max_terms,
                                                  compaction_eps=eps)
    want, dropped_j, weight_j = ref.dress_hamiltonian(
        H1_j, [_to_jax(P) for P in gens], taus, max_terms=max_terms, compaction_eps=eps)
    _same_sum(got, want)
    assert dropped == dropped_j
    assert weight == pytest.approx(weight_j, rel=1e-12, abs=1e-15)
    if max_terms is None and eps is None:
        assert len(got) > 2048 and dropped == 0
    else:
        assert dropped > 0
