"""The port's shot-based measurement (``qsfh_torch/engine/sampling.py``)
against the JAX module (complex128, CPU).

* ``string_support``, ``qwc_groups`` and ``pack_groups`` equal JAX's on
  the 2x2 and 2x3 Hubbard Hamiltonians and a hand-made Pauli sum;
  ``rotate_to_group_basis`` and the data-driven rotation give JAX's
  rotated states (1e-12).
* Fed JAX's uniforms (the draws of its key), ``sample_bitstrings`` and
  ``sample_counts`` return JAX's samples and counts exactly.
* Fed the uniforms of JAX's per-group keys, ``estimate_expectation`` and
  ``estimate_expectation_scan`` return JAX's estimates (1e-10).
* A basis state samples its own index; a torch ``Generator`` reproduces
  its draws; the identity-only and non-Hermitian cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_tpu.engine import sampling as J
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fermi_hubbard
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum
from qsfh_torch.engine import sampling as T
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.lattice import fermi_hubbard
from qsfh_torch.ops.pauli import PauliSum

TOL = 1e-10
SHOTS = 300


def _hams():
    out = {}
    for nx, ny in [(2, 2), (2, 3)]:
        out[f"{nx}x{ny}"] = (jax_jw(jax_fermi_hubbard(nx, ny, 1.0, 6.0)),
                             jordan_wigner(fermi_hubbard(nx, ny, 1.0, 6.0)), 2 * nx * ny)
    terms = [("Z0 Z1", 0.5), ("X0 X1", 0.25), ("Y0 Y1", 0.25), ("Z2", -0.7), ("X2 Y3", 0.1),
             ("", 1.5), ("Y3", 0.3)]
    out["strings"] = (JaxPauliSum.from_terms(terms), PauliSum.from_terms(terms), 4)
    return out


HAMS = _hams()


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _uniforms(key, shots):
    pad = (-shots) % 256  # the JAX sampler's chunk padding
    return np.asarray(jax.random.uniform(key, (shots + pad,), dtype=jnp.float64))[:shots]


@pytest.mark.parametrize("name", list(HAMS))
def test_groups_and_packing_equal_jax(name):
    jop, top, n = HAMS[name]
    for a, b in zip(J.string_support(jop), T.string_support(top)):
        np.testing.assert_array_equal(a, b)
    jg, tg = J.qwc_groups(jop), T.qwc_groups(top)
    assert len(jg) == len(tg) and all(np.array_equal(a, b) for a, b in zip(jg, tg))
    jpack, tpack = J.pack_groups(jop, n, jg), T.pack_groups(top, n, tg)
    assert jpack[0] == tpack[0]
    for a, b in zip(jpack[1:], tpack[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(HAMS))
def test_rotated_states_equal_jax(name):
    jop, top, n = HAMS[name]
    v = _state(n, n)
    const, packed = J._split_identity(jop, J.qwc_groups(jop), n)
    _, _, _, x_bits, y_bits = T.pack_groups(top, n, T.qwc_groups(top))
    for i, (_, _, xb, yb) in enumerate(packed):
        ref = np.asarray(J.rotate_to_group_basis(jnp.asarray(v), n, xb, yb))
        got = T.rotate_to_group_basis(torch.tensor(v), n, xb, yb)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
        ref = np.asarray(J._rotate_data_driven(jnp.asarray(v), n, jnp.asarray(x_bits[i]),
                                               jnp.asarray(y_bits[i])))
        got = T._rotate_data_driven(torch.tensor(v), n, x_bits[i], y_bits[i])
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,seed", [(8, 1), (12, 2)])
def test_samples_and_counts_equal_jax_given_its_uniforms(n, seed):
    v = _state(n, seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(J.sample_bitstrings(jnp.asarray(v), n, SHOTS, key)).astype(np.int64)
    u = _uniforms(key, SHOTS)
    got = T.sample_bitstrings(torch.tensor(v), n, SHOTS, uniforms=u)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert T.sample_counts(torch.tensor(v), n, SHOTS, uniforms=u) == \
        J.sample_counts(jnp.asarray(v), n, SHOTS, key)


@pytest.mark.parametrize("name", list(HAMS))
@pytest.mark.parametrize("scan", [False, True])
def test_estimates_equal_jax_given_its_uniforms(name, scan):
    jop, top, n = HAMS[name]
    v = _state(n, 3)
    key = jax.random.PRNGKey(7)
    _, packed = J._split_identity(jop, J.qwc_groups(jop), n)
    u = np.stack([_uniforms(k, SHOTS) for k in jax.random.split(key, len(packed))])
    jfn, tfn = ((J.estimate_expectation_scan, T.estimate_expectation_scan) if scan else
                (J.estimate_expectation, T.estimate_expectation))
    ref = jfn(jnp.asarray(v), n, jop, SHOTS, key)
    got = tfn(torch.tensor(v), n, top, SHOTS, uniforms=u)
    assert got.n_groups == ref.n_groups == len(got.group_means)
    assert got.shots_per_group == SHOTS
    assert abs(got.mean - ref.mean) < TOL and abs(got.stderr - ref.stderr) < TOL
    np.testing.assert_allclose(got.group_means, ref.group_means, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.group_stderrs, ref.group_stderrs, rtol=0, atol=TOL)


def test_basis_state_generator_and_edge_cases():
    psi = torch.zeros(16, dtype=torch.complex128)
    psi[5] = 1.0
    gen = torch.Generator().manual_seed(0)
    assert (T.sample_bitstrings(psi, 4, 64, generator=gen) == 5).all()
    assert T.sample_counts(psi, 4, 10, generator=gen) == {"0101": 10}
    v = torch.tensor(_state(8, 4))
    a = T.sample_bitstrings(v, 8, 50, generator=torch.Generator().manual_seed(3))
    b = T.sample_bitstrings(v, 8, 50, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="uniforms"):
        T.sample_bitstrings(v, 8, 50, uniforms=np.zeros(49))
    ident = PauliSum.from_terms([("", 2.5)])
    res = T.estimate_expectation_scan(v, 8, ident, 10)
    assert res.mean == 2.5 and res.n_groups == 0 and res.group_means.size == 0
    with pytest.raises(ValueError, match="Hermitian"):
        T.estimate_expectation(v, 8, PauliSum.from_terms([("X0", 1j)]), 10)
    top = HAMS["2x2"][1]
    res = T.estimate_expectation(v, 8, top, 4000, generator=torch.Generator().manual_seed(1))
    exact = float(Observable(top, 8).expectation(v))
    assert abs(res.mean - exact) < 5 * res.stderr
