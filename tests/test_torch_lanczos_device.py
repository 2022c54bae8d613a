"""The sector Lanczos's ``device`` argument (``qsfh_torch.linalg.lanczos``).

* ``device="cpu"``: energies within 1e-10 of JAX ``ground_state`` at 2x2
  and 2x3 (states by overlap, the start vectors differ), the 1x4
  degenerate manifold's projector within 1e-8 of JAX
  ``degenerate_ground_space``'s, every state complex128 on the CPU;
  ``HubbardProblem.ground_state(device="cpu")`` writes host arrays;
* with no device, ``ground_state``, ``degenerate_ground_space`` and
  ``HubbardProblem.ground_state`` raise where CUDA is unavailable (the
  card is the default);
* the per-mask sector matrix equals the per-term restriction (one entry
  list per term, duplicates summed) within 1e-12 on the 2x3 Hamiltonian,
  on S^2 (many terms a mask) and on a random complex Pauli sum, and its
  torch CSR product equals scipy's.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from qsfh_tpu.linalg import lanczos as jax_lanczos
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fermi_hubbard
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.linalg import lanczos
from qsfh_torch.ops.jw import jordan_wigner
from qsfh_torch.ops.lattice import fermi_hubbard, spin_operator
from qsfh_torch.ops.pauli import PauliSum

LATTICES = {"2x2": (2, 2, 4, 2, 2, 6.0), "2x3": (2, 3, 6, 3, 3, 4.0)}


def _projector(states):
    m = np.stack([np.asarray(s) for s in states])
    return m.T @ m.conj()


@pytest.mark.parametrize("name", LATTICES)
def test_cpu_ground_state_matches_jax(name):
    x, y, ne, up, down, U = LATTICES[name]
    n = 2 * x * y
    e, wf = lanczos.ground_state(jordan_wigner(fermi_hubbard(x, y, 1.0, U)), n, ne, up, down,
                                 device="cpu")
    je, jwf = jax_lanczos.ground_state(jax_jw(jax_fermi_hubbard(x, y, 1.0, U)), n, ne, up, down)
    assert abs(e - je) <= 1e-10
    assert wf.device.type == "cpu" and wf.dtype == torch.complex128
    assert abs(abs(np.vdot(wf.numpy(), np.asarray(jwf))) - 1.0) <= 1e-8


def test_cpu_degenerate_space_1x4_matches_jax():
    args = (8, 3, 2, 1)
    e, states = lanczos.degenerate_ground_space(
        jordan_wigner(fermi_hubbard(4, 1, 1.0, 6.0)), *args, n_states=2, k=120, device="cpu")
    je, jstates = jax_lanczos.degenerate_ground_space(
        jax_jw(jax_fermi_hubbard(4, 1, 1.0, 6.0)), *args, n_states=2, k=120)
    assert abs(e - je) <= 1e-10
    assert len(states) == len(jstates) == 2
    assert all(s.device.type == "cpu" and s.dtype == torch.complex128 for s in states)
    np.testing.assert_allclose(_projector(states), _projector(jstates), rtol=0, atol=1e-8)


def test_problem_ground_state_on_cpu_writes_host_arrays(tmp_path, monkeypatch):
    monkeypatch.delenv("QSFH_ED_CACHE_DIR", raising=False)
    p = HubbardProblem(2, 2, 1.0, 6.0, 4, 2, 2, results_root=str(tmp_path))
    e, states = p.ground_state(degenerate=True, n_states=1, device="cpu")
    je, _ = jax_lanczos.ground_state(jax_jw(jax_fermi_hubbard(2, 2, 1.0, 6.0)), 8, 4, 2, 2)
    assert abs(e - je) <= 1e-10
    assert isinstance(states[0], np.ndarray) and states[0].dtype == np.complex128


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.delenv("QSFH_ED_CACHE_DIR", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = jordan_wigner(fermi_hubbard(2, 2, 1.0, 6.0))
    p = HubbardProblem(2, 2, 1.0, 6.0, 4, 2, 2, results_root=str(tmp_path))
    for solve in (lambda: lanczos.ground_state(hp, 8, 4, 2, 2),
                  lambda: lanczos.degenerate_ground_space(hp, 8, 4, 2, 2, n_states=1),
                  lambda: p.ground_state(),
                  lambda: p.ground_state(degenerate=True, n_states=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve()


def _per_term(op, n, ne, up, down):
    """The sector restriction built one entry list per term (duplicates
    summed)."""
    idx = np.asarray(lanczos.jw_number_spin_indices(ne, up, down, n), dtype=np.int64)
    pos = np.full(1 << n, -1, dtype=np.int64)
    pos[idx] = np.arange(idx.size)
    xs, zs, cre, cim = Observable(op, n)._scan_terms()
    rows, cols, data = [], [], []
    r = np.arange(idx.size)
    for x, z, c in zip(xs.astype(np.int64), zs.astype(np.int64), cre + 1j * cim):
        col = pos[idx ^ x]
        keep = col >= 0
        rows.append(r[keep])
        cols.append(col[keep])
        data.append(c * (1.0 - 2.0 * (np.bitwise_count(idx[keep] & z) % 2)))
    return scipy.sparse.coo_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=(idx.size, idx.size)).tocsr()


def _random_sum(n, seed=0, T=60):
    rng = np.random.default_rng(seed)
    return PauliSum(rng.integers(0, 1 << n, T), rng.integers(0, 1 << n, T),
                    rng.standard_normal(T) + 1j * rng.standard_normal(T))


@pytest.mark.parametrize("which", ["hubbard_2x3", "s2_2x3", "random_complex"])
def test_per_mask_matrix_equals_per_term_restriction(which):
    n, ne, up, down = 12, 6, 3, 3
    op = {"hubbard_2x3": lambda: jordan_wigner(fermi_hubbard(2, 3, 1.0, 4.0)),
          "s2_2x3": lambda: jordan_wigner(spin_operator(6, "S^2")),
          "random_complex": lambda: _random_sum(n)}[which]()
    mat, idx = lanczos.sector_hamiltonian(op, n, ne, up, down)
    ref = _per_term(op, n, ne, up, down)
    assert list(idx) == lanczos.jw_number_spin_indices(ne, up, down, n)
    assert abs(mat - ref).max() <= 1e-12
    assert mat.nnz <= ref.nnz
    v = np.random.default_rng(1).standard_normal((idx.size, 2)) @ np.array([1.0, 1j])
    got = lanczos.device_matrix(mat, "cpu") @ torch.from_numpy(v)
    np.testing.assert_allclose(got.numpy(), ref @ v, rtol=0, atol=1e-12)
