"""The port's correlators (``qsfh_torch/ops/correlations.py``) against the
JAX module (complex128, CPU), tolerance 1e-10.

* At 2x2 (8 qubits: the per-term ``pauli_inner`` route) and 2x3 (12
  qubits: the grouped layout's plain route), on seeded states: the spin
  and density correlation matrices (connected and not), the one-body
  density matrix per spin, the pair correlator, the structure factor and
  the momentum distribution, each through the one-layout evaluation
  (``route="layout"``) and the per-entry ``Observable`` loop
  (``route="loop"``, the CPU default).
* The one-layout evaluation against the per-entry loop, entry by entry,
  and a shifted entry index (a planted fault) that must disagree.
* A layout in which one Z string recurs across entries: no merging, each
  entry its own value.
* The fluctuation operators ``spin_q_operator`` / ``charge_q_operator``
  equal JAX's term for term.
"""

import numpy as np
import pytest
import torch

from qsfh_tpu.ops import correlations as J
from qsfh_torch.engine import kernels as K
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.ops import correlations as T
from qsfh_torch.ops.pauli import PauliSum

TOL = 1e-10
LATTICES = [(2, 2), (2, 3)]


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module", params=LATTICES, ids=lambda p: f"{p[0]}x{p[1]}")
def lattice(request):
    nx, ny = request.param
    v = _state(2 * nx * ny, nx * ny)
    return nx, ny, v, torch.tensor(v)


@pytest.mark.parametrize("route", ["layout", "loop"])
@pytest.mark.parametrize("kind,connected", [("spin", False), ("density", False),
                                            ("density", True)])
def test_correlation_matrix_and_structure_factor(lattice, route, kind, connected):
    nx, ny, v, psi = lattice
    ref = J.correlation_matrix(v, nx * ny, kind=kind, connected=connected)
    got = T.correlation_matrix(psi, nx * ny, kind=kind, connected=connected, route=route)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    s_ref, s_got = J.structure_factor(ref, nx, ny), T.structure_factor(got, nx, ny)
    assert s_ref.keys() == s_got.keys()
    assert max(abs(s_ref[k] - s_got[k]) for k in s_ref) < TOL


@pytest.mark.parametrize("route", ["layout", "loop"])
@pytest.mark.parametrize("spin", ["up", "down"])
def test_one_body_density_matrix_and_momentum_distribution(lattice, route, spin):
    nx, ny, v, psi = lattice
    ref = J.one_body_density_matrix(v, nx * ny, spin=spin)
    got = T.one_body_density_matrix(psi, nx * ny, spin=spin, route=route)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    n_ref, n_got = J.momentum_distribution(ref, nx, ny), T.momentum_distribution(got, nx, ny)
    assert max(abs(n_ref[k] - n_got[k]) for k in n_ref) < TOL


@pytest.mark.parametrize("route", ["layout", "loop"])
def test_pair_correlation_matrix(lattice, route):
    nx, ny, v, psi = lattice
    ref = J.pair_correlation_matrix(v, nx * ny)
    got = T.pair_correlation_matrix(psi, nx * ny, route=route)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("matrix", ["spin", "density", "rho", "pair"])
def test_one_layout_against_per_entry_loop(lattice, matrix):
    nx, ny, _, psi = lattice
    n_sites = nx * ny
    entries = {"spin": T.spin_entries, "density": T.density_entries,
               "rho": lambda s: T.one_body_entries(s, "down"), "pair": T.pair_entries}[matrix](
        n_sites)
    got = entries.values(psi)
    loop = torch.stack([Observable(op, 2 * n_sites).expectation(psi) for op in entries.ops])
    np.testing.assert_allclose(got.numpy(), loop.numpy(), rtol=0, atol=TOL)
    assert len(entries) == sum(len(op) for op in entries.ops)  # no term merged
    if 2 * n_sites >= K.INNER_TILE_MIN_BITS:
        assert entries.inner_groups().n_terms == len(entries)
    # a planted fault: the entry index shifted by one must disagree
    shifted = torch.roll(torch.as_tensor(entries.entry), 1)
    bad = entries.values(psi, entry=shifted)
    assert float((bad - loop).abs().max()) > 1e-3


@pytest.mark.parametrize("n", [8, 10])
def test_recurring_z_string_across_entries(n):
    z0 = PauliSum.from_string("Z0", 1.0)
    ops = [z0, z0 + PauliSum.from_string("Z1", 0.5), 2.0 * z0 + PauliSum.from_string("X0 X2", 1.0),
           PauliSum.from_string("Z0", -1.0) + PauliSum.identity(0.25), z0]
    entries = T.EntryTerms(ops, n)
    assert len(entries) == 1 + 2 + 2 + 2 + 1
    psi = torch.tensor(_state(n, 21))
    got = entries.values(psi).numpy()
    ref = np.array([float(Observable(op, n).expectation(psi)) for op in ops])
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert abs(got[0] - got[4]) < TOL and abs(got[0] + got[3] - 0.25) < TOL


def test_fluctuation_operators_equal_jax():
    for q in [(0, 0), (1, 0), (1, 2)]:
        for jop, top in [(J.spin_q_operator(3, 3, *q), T.spin_q_operator(3, 3, *q)),
                         (J.charge_q_operator(3, 3, *q, filling=1.0),
                          T.charge_q_operator(3, 3, *q, filling=1.0))]:
            assert jop.terms.keys() == top.terms.keys()
            assert max(abs(jop.terms[k] - top.terms[k]) for k in jop.terms) < 1e-15


def test_argument_checks(lattice):
    nx, ny, _, psi = lattice
    with pytest.raises(ValueError, match="kind"):
        T.correlation_matrix(psi, nx * ny, kind="pairing")
    with pytest.raises(ValueError, match="spin"):
        T.one_body_density_matrix(psi, nx * ny, spin="sideways")
    with pytest.raises(ValueError, match="route"):
        T.pair_correlation_matrix(psi, nx * ny, route="fast")
