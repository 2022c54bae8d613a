"""The port's HEA (``algos/hea.py``) against the JAX driver (complex128).

* ``_u3`` and the unrolled ``hea_circuit`` equal the JAX ones within
  1e-12; the kernel route's rot segment (``HEASegment``: u3 as three Pauli
  rotations, each CNOT as three static rotations and e^{i pi/4}) equals
  the JAX gate circuit, global phase included, within 1e-12 at 4 qubits
  (the per-term kernels' route) and at 10 qubits on the resident and the
  tile-run routes (their plain versions here);
* H2 r = 0.8, reps = 5, lr 0.1 (the reference configuration), 6 epochs
  of ``run()`` from the same angles: losses within 1e-10 and the final
  angles within 1e-9, the unrolled lowering within 1e-10 of the segment;
* the 2x3 Hubbard lattice as a 12-qubit "molecule" (reps = 1): 3 steps
  from the same angles and the JAX optimizer state of 2 earlier steps
  (``hea_from_jax``): energies, gradient norms and angles within 1e-10.
  (LiH's 631-term H takes the JAX compiler ~15 s; the card runs LiH.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qsfh_tpu.algos import hea as jhea
from qsfh_tpu.molecules import H2 as JaxH2
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fermi_hubbard
from qsfh_torch.algos import hea as thea
from qsfh_torch.engine import streaming
from qsfh_torch.io.convert import hea_from_jax, load_adam_state
from qsfh_torch.molecules import H2
from qsfh_torch.ops.lattice import fermi_hubbard


class _Lattice:
    """A Hubbard lattice where the HEA drivers take a molecule."""

    n_orbitals = n_electrons = 6
    n_qubits = 12
    name = "2x3"
    fci_energy = None

    def __init__(self, build):
        self.build = build

    def get_molecular_hamiltonian(self):
        return self.build(2, 3, 1.0, 4.0, periodic=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states (several pytest workers
    share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _angles(reps, n, seed):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (reps + 1, n, 3))


def test_u3_and_unrolled_circuit_match_jax():
    a = _angles(2, 4, 1)
    for rx, ry, rz in a[0]:
        ref = np.asarray(jhea._u3(rx, ry, rz, jnp.complex128))
        got = thea._u3(*torch.tensor([rx, ry, rz]), torch.complex128).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14)
    ref = np.asarray(jhea.hea_circuit(jnp.asarray(a), 4, 2, jnp.complex128))
    got = thea.hea_circuit(torch.tensor(a), 4, 2, torch.complex128).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n, route", [(4, "per-term"), (10, "resident"), (10, "tile_runs")])
def test_segment_matches_jax_gate_circuit(n, route, monkeypatch):
    if route == "tile_runs":
        monkeypatch.setattr(streaming, "CHAIN_MAX_QUBITS", 9)
    reps = 2
    a = _angles(reps, n, n)
    ref = np.asarray(jhea.hea_circuit(jnp.asarray(a), n, reps, jnp.complex128))
    ops, phase = thea.hea_program(n, reps)
    assert abs(phase - np.exp(1j * np.pi / 4 * n * reps)) < 1e-15
    seg = thea.HEASegment(n, reps)
    assert len(seg.segment) == 3 * n * (reps + 1) + 3 * n * reps
    psi0 = torch.zeros(1 << n, dtype=torch.complex128)
    psi0[0] = 1.0
    got = seg(torch.tensor(a), psi0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _pair(jax_mol, port_mol, tmp_path, **kw):
    j = jhea.VQE(jax_mol, results_root=str(tmp_path / "j"), plot=False, log_metrics=False, **kw)
    t = thea.VQE(port_mol, results_root=str(tmp_path / "t"), plot=False, log_metrics=False,
                 device="cpu", **kw)
    return j, t


def test_h2_reference_run_matches_jax(tmp_path):
    kw = dict(n_epoch=6, reps=5, lr=1e-1, threshold=0.002)
    j, t = _pair(JaxH2(r=0.8), H2(r=0.8), tmp_path, **kw)
    a = _angles(5, 4, 7)
    j.params = jnp.asarray(a)
    t.params = torch.tensor(a)
    assert t.dtype == torch.complex128 and t.circuit_mode == "segment"
    jl, tl = j.run(), t.run()
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-10)
    np.testing.assert_allclose(t.params.numpy(), np.asarray(j.params), rtol=0, atol=1e-9)
    u = thea.VQE(H2(r=0.8), results_root=str(tmp_path / "u"), plot=False, log_metrics=False,
                 device="cpu", circuit_mode="unrolled", **kw)
    u.params = torch.tensor(a)
    np.testing.assert_allclose(u.run(), tl, rtol=0, atol=1e-10)


def test_12_qubit_steps_from_jax_adam_state(tmp_path):
    kw = dict(n_epoch=0, reps=1, lr=5e-2, threshold=0.0)
    j, t = _pair(_Lattice(jax_fermi_hubbard), _Lattice(fermi_hubbard), tmp_path, **kw)
    assert t.n_qubits == 12
    params = jnp.asarray(_angles(1, 12, 3))
    opt_state = optax.adam(kw["lr"]).init(params)
    for _ in range(2):
        params, opt_state, _, _ = j._step(params, opt_state)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(opt_state)]
    th, adam = hea_from_jax(np.asarray(params), leaves)
    optimizer = torch.optim.Adam([th], lr=kw["lr"])
    load_adam_state(optimizer, th, adam)
    for _ in range(3):
        params, opt_state, e_j, g_j = j._step(params, opt_state)
        th, optimizer, e_t, g_t = t._step(th, optimizer)
        assert abs(float(e_t) - float(e_j)) <= 1e-10
        assert abs(float(g_t) - float(g_j)) <= 1e-10
    np.testing.assert_allclose(th.numpy(), np.asarray(params), rtol=0, atol=1e-10)


def test_hea_from_jax_checks_shapes():
    a = np.zeros((2, 3, 3))
    th, state = hea_from_jax(a)
    assert state is None and th.shape == (2, 3, 3)
    with pytest.raises(ValueError):
        hea_from_jax(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        hea_from_jax(a, [np.asarray(1), np.zeros((2, 3, 2)), np.zeros((2, 3, 3))])
