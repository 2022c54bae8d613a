"""The port's exact diagonalization against the JAX package's.

* Sector indices equal JAX's at 2x2 and 2x3; the sector mask selects them.
* Lanczos ground energies within 1e-10 of JAX ``ground_state`` at 2x2 and
  2x3 (complex128; the start vectors differ, so states are compared by
  overlap); the 1x4 degenerate subspace's projector within 1e-8 of JAX
  ``degenerate_ground_space``'s; both against the port's scipy ``exact``.
* ``HubbardProblem.ground_state`` writes the npz cache in the JAX schema
  (read back by ``qsfh_tpu.io.checkpoint.load_ground_state``), re-reads
  it, honours ``QSFH_ED_CACHE_DIR`` and ``force``; ``ADAPT`` with ground
  truth builds without a JAX-written cache.
"""

import os

import numpy as np
import pytest
import torch

from qsfh_tpu.io import checkpoint as jax_ckpt
from qsfh_tpu.linalg import exact as jax_exact
from qsfh_tpu.linalg import lanczos as jax_lanczos
from qsfh_tpu.linalg.sectors import jw_number_spin_indices as jax_indices
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fermi_hubbard
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.linalg import exact, lanczos, sectors
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.lattice import fermi_hubbard

# (x, y, electrons, up, down, U)
LATTICES = {"2x2": (2, 2, 4, 2, 2, 4.0), "2x3": (2, 3, 6, 3, 3, 4.0)}


def _hamiltonians(x, y, U):
    return (jordan_wigner(fermi_hubbard(x, y, 1.0, U)),
            jax_jw(jax_fermi_hubbard(x, y, 1.0, U)))


def _projector(states):
    m = np.stack([np.asarray(s) for s in states])
    return m.T @ m.conj()


@pytest.mark.parametrize("name", LATTICES)
def test_sector_indices_match_jax(name):
    x, y, ne, up, down, _ = LATTICES[name]
    n = 2 * x * y
    idx = sectors.jw_number_spin_indices(ne, up, down, n)
    assert idx == jax_indices(ne, up, down, n)
    assert len(idx) == sectors.sector_dimension(ne, up, n)
    mask = sectors.sector_mask(n, ne, up)
    assert sorted(idx) == torch.nonzero(mask).flatten().tolist()


def test_random_sector_state_is_seeded_and_in_sector():
    n, ne, up = 8, 4, 2
    a = sectors.random_sector_state(n, ne, up, torch.Generator().manual_seed(5))
    b = sectors.random_sector_state(n, ne, up, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.dtype == torch.complex128
    assert abs(float(torch.linalg.vector_norm(a)) - 1.0) < 1e-12
    outside = ~sectors.sector_mask(n, ne, up)
    assert float(a[outside].abs().max()) == 0.0
    assert torch.equal(sectors.project_to_sector(a, n, ne, up), a)


@pytest.mark.parametrize("name", LATTICES)
def test_ground_energy_matches_jax(name):
    x, y, ne, up, down, U = LATTICES[name]
    n = 2 * x * y
    hp, jhp = _hamiltonians(x, y, U)
    e, wf = lanczos.ground_state(hp, n, ne, up, down, device="cpu")
    je, jwf = jax_lanczos.ground_state(jhp, n, ne, up, down)
    assert abs(e - je) <= 1e-10
    assert wf.dtype == torch.complex128 and wf.shape == (1 << n,)
    assert abs(abs(np.vdot(wf.numpy(), np.asarray(jwf))) - 1.0) <= 1e-8


def test_degenerate_space_1x4_matches_jax():
    hp, jhp = _hamiltonians(4, 1, 6.0)
    e, states = lanczos.degenerate_ground_space(hp, 8, 3, 2, 1, n_states=2, k=120,
                                                 device="cpu")
    je, jstates = jax_lanczos.degenerate_ground_space(jhp, 8, 3, 2, 1, n_states=2, k=120)
    assert abs(e - je) <= 1e-10
    assert len(states) == len(jstates) >= 1
    np.testing.assert_allclose(_projector(states), _projector(jstates), rtol=0, atol=1e-8)
    gram = np.stack([s.numpy() for s in states]).conj() @ np.stack([s.numpy() for s in states]).T
    np.testing.assert_allclose(gram, np.eye(len(states)), rtol=0, atol=1e-10)


def test_lanczos_matches_scipy_exact():
    hp, jhp = _hamiltonians(2, 2, 6.0)
    sp = exact.get_sparse_operator(fermi_hubbard(2, 2, 1.0, 6.0), 8)
    # the port's sparse matrix is the JAX package's
    assert abs(sp - jax_exact.get_sparse_operator(jhp, 8)).max() == 0.0
    e_ref, wf_ref = exact.jw_get_ground_state(sp, 4, 2, 2)
    e, wf = lanczos.ground_state(hp, 8, 4, 2, 2, seed=3, device="cpu")
    assert abs(e - e_ref) <= 1e-10
    assert abs(abs(np.vdot(wf.numpy(), wf_ref)) - 1.0) <= 1e-8
    # the degenerate 1x4 level against ARPACK's lowest states
    sp4 = exact.get_sparse_operator(jordan_wigner(fermi_hubbard(4, 1, 1.0, 6.0)), 8)
    e4, states = lanczos.degenerate_ground_space(
        jordan_wigner(fermi_hubbard(4, 1, 1.0, 6.0)), 8, 3, 2, 1, n_states=2, k=120,
        device="cpu")
    e4_ref, states_ref = exact.jw_get_ground_space(sp4, 3, 2, 1, n_states=2, n_probe=6)
    assert abs(e4 - e4_ref) <= 1e-10
    dense = sp4.toarray()
    for v in states:
        assert np.linalg.norm(dense @ v.numpy() - e4 * v.numpy()) <= 1e-8


def test_sector_hamiltonian_is_the_restriction():
    hp, _ = _hamiltonians(2, 3, 4.0)
    mat, idx = lanczos.sector_hamiltonian(hp, 12, 6, 3, 3)
    full = exact.get_sparse_operator(hp, 12)
    ref = exact.jw_number_spin_restrict_operator(full, 6, 3, 3, 12)
    assert list(idx) == sectors.jw_number_spin_indices(6, 3, 3, 12)
    assert abs(mat - ref).max() <= 1e-12


def _problem(root):
    return HubbardProblem(2, 2, 1, 4, 4, 2, 2, results_root=str(root))


def test_ground_state_cache(tmp_path, monkeypatch):
    shared = tmp_path / "shared"
    monkeypatch.setenv("QSFH_ED_CACHE_DIR", str(shared))
    p = _problem(tmp_path / "a")
    energy, wf = p.ground_state(device="cpu")
    path = p.ground_state_path()
    name = os.path.basename(path)
    assert os.path.exists(path) and os.path.exists(shared / name)
    # the JAX package reads the port's file
    je, jwfs = jax_ckpt.load_ground_state(path)
    assert je == energy and np.array_equal(jwfs[0], wf)
    # re-read, not recomputed
    assert p.ground_state(device="cpu")[0] == energy
    # a fresh results_root reads through the shared cache and keeps a copy
    q = _problem(tmp_path / "b")
    e2, wf2 = q.ground_state(device="cpu")
    assert e2 == energy and np.array_equal(wf2, wf)
    assert os.path.exists(q.ground_state_path())
    # force solves again
    e3, _ = q.ground_state(force=True, device="cpu")
    assert abs(e3 - energy) <= 1e-10
    # the degenerate manifold carries the deg{n} suffix
    ed, states = p.ground_state(degenerate=True, n_states=2, device="cpu")
    assert len(states) <= 2 and abs(ed - energy) <= 1e-10
    assert os.path.exists(path.replace(".npz", " deg2.npz"))
    again = p.ground_state(degenerate=True, n_states=2, device="cpu")  # the states found, read back
    assert again[0] == ed and len(again[1]) == len(states)
    # an explicit path is written where asked
    explicit = str(tmp_path / "c" / "gs.npz")
    monkeypatch.delenv("QSFH_ED_CACHE_DIR")
    e4, _ = _problem(tmp_path / "d").ground_state(path=explicit, device="cpu")
    assert os.path.exists(explicit) and abs(e4 - energy) <= 1e-10


def test_adapt_builds_ground_truth_without_jax_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QSFH_ED_CACHE_DIR", str(tmp_path / "empty"))
    a = ADAPT(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=2,
              n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=4, plot=False,
              log_metrics=False, device="cpu", results_root=str(tmp_path / "root"))
    _, jhp = _hamiltonians(2, 2, 4.0)
    je, _ = jax_lanczos.ground_state(jhp, 8, 4, 2, 2)
    assert abs(a.ground_state_energy - je) <= 1e-10
    assert len(a._gs) == 1 and a._gs[0].dtype == torch.complex128
