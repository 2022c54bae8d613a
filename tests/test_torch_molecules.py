"""The port's molecules (numpy and ``scipy.special`` copies, FCI on the
port's Lanczos) against ``qsfh_tpu.molecules``.

* H2 (r = 0.74) and LiH (r = 0.8, the reference's iQCC molecule): the
  one- and two-body MO integrals, nuclear repulsion, orbital energies, HF
  energy and the JW molecular Hamiltonian's terms within 1e-10 (LiH
  without the FCI, which the JAX package solves with its own Lanczos);
* the H2 FCI energy within 1e-10;
* one ``IQCC(H2(0.74))`` epoch against the JAX driver: ``loss_history``
  within 1e-9, the same selection, the FCI energy as ground truth.
"""

import numpy as np
import pytest

from qsfh_torch import molecules as port
from qsfh_torch.algos.iqcc import IQCC
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_tpu import molecules as ref
from qsfh_tpu.algos.iqcc import IQCC as JaxIQCC
from qsfh_tpu.ops.jw import jordan_wigner as jax_jordan_wigner

TOL = 1e-10
LIH = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 0.8))]


@pytest.fixture(scope="module")
def h2():
    return port.H2(0.74), ref.H2(0.74)


@pytest.fixture(scope="module")
def lih():
    return port.Molecule(LIH, run_fci=False), ref.Molecule(LIH, run_fci=False)


@pytest.mark.parametrize("name", ["h2", "lih"])
def test_integrals_hf_and_hamiltonian(name, request):
    got, want = request.getfixturevalue(name)
    assert (got.n_qubits, got.n_electrons, got.n_orbitals, got.name) == \
        (want.n_qubits, want.n_electrons, want.n_orbitals, want.name)
    assert got.nuclear_repulsion == pytest.approx(want.nuclear_repulsion, abs=TOL)
    assert got.hf_energy == pytest.approx(want.hf_energy, abs=TOL)
    np.testing.assert_allclose(got.orbital_energies, want.orbital_energies, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.one_body_integrals, want.one_body_integrals, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.two_body_integrals, want.two_body_integrals, rtol=0,
                               atol=TOL)
    H, H_ref = jordan_wigner(got.get_molecular_hamiltonian()), \
        jax_jordan_wigner(want.get_molecular_hamiltonian())
    assert len(H) == len(H_ref) > 10
    np.testing.assert_array_equal(H.x, H_ref.x)
    np.testing.assert_array_equal(H.z, H_ref.z)
    np.testing.assert_allclose(H.c, H_ref.c, rtol=0, atol=TOL)


def test_h2_fci(h2):
    got, want = h2
    assert got.fci_energy == pytest.approx(want.fci_energy, abs=TOL)
    assert got.fci_energy < got.hf_energy


def test_iqcc_h2_epoch(h2, tmp_path):
    kw = dict(n_epoch=1, lr=1e-2, threshold=1e-2, max_inner_iterations=30, plot=False,
              log_metrics=False, tag="iqcc-H2")
    j = JaxIQCC(h2[1], results_root=str(tmp_path / "j"), **kw)
    j.run()
    t = IQCC(h2[0], results_root=str(tmp_path / "t"), device="cpu", **kw)
    t.run()
    assert t.ground_state_energy == pytest.approx(j.ground_state_energy, abs=TOL)
    assert t.n_electrons == 2 and t.selected_ops == j.selected_ops and t.selected_ops
    for key in ("iteration", "epoch"):
        np.testing.assert_allclose(t.loss_history[key], j.loss_history[key], rtol=0, atol=1e-9)
