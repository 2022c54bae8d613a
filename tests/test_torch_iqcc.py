"""The port's iQCC driver against the JAX driver: the slice as a whole.

* ``product_state`` and its gradient in theta and phi (torch autograd)
  against ``jax.grad`` on a Rayleigh quotient, within 1e-10.
* The differentiable segment (``engine.compiled.rot_segment`` under
  ``Observable.expectation_auto``) at 10 qubits with 30 seeded
  selections on a seeded Hermitian Pauli sum: the energy and the
  gradients for tau, theta and phi against ``jax.value_and_grad`` of the
  JAX driver's loss (its ``_state`` lowers 30 selections to its scan
  circuit), within 1e-10.  On the CPU the kernel route's wrappers run
  their plain versions.
* ``select_operator`` at a seeded product state: the same generators,
  labels and gradients (1e-10).
* The 2x2 reference config (U = 4, lr 1e-2, threshold 5e-3, Adam,
  symbolic dressing) over 2 epochs, and the dense + ILC driver
  (``ilc_cap=16``) over 2 epochs: ``loss_history`` within 1e-9, equal
  ``selected_ops``; the dense matrices within 1e-10.
* Each package resumes the other's epoch-1 checkpoint (the ``.dense.npy``
  sidecar included) and matches the other package carried on in process;
  both refuse a dense checkpoint whose sidecar is lost, and a symbolic
  checkpoint resumes in the dense mode from its dressed sum.
* One L-BFGS epoch (Adam warm-up, then L-BFGS; threshold 1e-5): the
  converged epoch energy within 1e-6 of the JAX driver's.  The two
  optimizers take different steps (optax's zoom line search, torch's
  strong-Wolfe one), so the iteration counts are not held.
"""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsfh_torch.algos.iqcc import IQCC, product_state
from qsfh_torch.engine.expectation import Observable
from qsfh_torch.io.convert import iqcc_from_jax
from qsfh_torch.ops.lattice import fermi_hubbard
from qsfh_torch.ops.pauli import PauliSum
from qsfh_torch.utils.dense import paulisum_to_dense
from qsfh_tpu.algos.iqcc import IQCC as JaxIQCC
from qsfh_tpu.algos.iqcc import product_state as jax_product_state
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fermi_hubbard
from qsfh_tpu.ops.pauli import PauliSum as JaxPauliSum

KW_2X2 = dict(lr=1e-2, threshold=5e-3, max_inner_iterations=12, plot=False, log_metrics=False)
MODES = {
    "adam": dict(tag="iqcc-adam"),
    "dense_ilc": dict(tag="iqcc-dense", dense_dressing=True, ilc=True, ilc_cap=16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states (several pytest workers
    share the cores); the results do not change."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def random_hermitian(n, n_terms, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << n, n_terms).astype(np.uint64)
    z = rng.integers(0, 1 << n, n_terms).astype(np.uint64)
    c = rng.normal(size=n_terms) * (1j) ** (np.bitwise_count(x & z) % 4)
    return PauliSum(x, z, c).simplify()


def _h2x2():
    return fermi_hubbard(2, 2, 1.0, 4.0, periodic=True)


def _jax_h2x2():
    return jax_fermi_hubbard(2, 2, 1.0, 4.0, periodic=True)


def _same_history(a, b, tol=1e-9):
    for key in ("iteration", "epoch"):
        assert len(a[key]) == len(b[key])
        np.testing.assert_allclose(a[key], b[key], rtol=0, atol=tol)


def test_product_state_and_gradient():
    n = 6
    rng = np.random.default_rng(0)
    th, ph = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)
    M = rng.normal(size=(1 << n, 1 << n)) + 1j * rng.normal(size=(1 << n, 1 << n))
    M = M + M.conj().T

    def jax_f(t, p):
        psi = jax_product_state(t, p, n, jnp.complex128)
        return jnp.real(jnp.vdot(psi, jnp.asarray(M) @ psi))

    t = torch.tensor(th, requires_grad=True)
    p = torch.tensor(ph, requires_grad=True)
    psi = product_state(t, p, n, torch.complex128)
    np.testing.assert_allclose(psi.detach().numpy(),
                               np.asarray(jax_product_state(th, ph, n, jnp.complex128)),
                               rtol=0, atol=1e-12)
    e = torch.real(torch.vdot(psi, torch.as_tensor(M) @ psi))
    e.backward()
    e_ref, (gt, gp) = jax.value_and_grad(jax_f, argnums=(0, 1))(jnp.asarray(th), jnp.asarray(ph))
    assert float(e.detach()) == pytest.approx(float(e_ref), abs=1e-10)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gt), rtol=0, atol=1e-10)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), rtol=0, atol=1e-10)


def test_differentiable_segment_10q():
    """30 seeded selections on 10 qubits: energy and tau, theta, phi
    gradients against jax.value_and_grad of the JAX loss."""
    n = 10
    H = random_hermitian(n, 150, 7)
    rng = np.random.default_rng(1)
    masks = [(int(rng.integers(1, 1 << n)), int(rng.integers(0, 1 << n))) for _ in range(30)]
    params = {"theta": rng.uniform(0, np.pi, n), "phi": rng.uniform(-np.pi, np.pi, n),
              "tau": rng.normal(0, 0.7, 30)}

    jax_driver = JaxIQCC(JaxPauliSum(H.x, H.z, H.c), n_epoch=1, lr=1e-2, threshold=1e-3,
                         n_qubits=n, ground_truth=False, plot=False, log_metrics=False,
                         results_root="unused")
    jax_obs = JaxObservable(JaxPauliSum(H.x, H.z, H.c), n)

    def jax_loss(p):
        return jax_obs.expectation_auto(jax_driver._state(p, masks))

    e_ref, g_ref = jax.value_and_grad(jax_loss)({k: jnp.asarray(v) for k, v in params.items()})

    driver = IQCC(H, n_epoch=1, lr=1e-2, threshold=1e-3, n_qubits=n, ground_truth=False,
                  plot=False, log_metrics=False, results_root="unused", device="cpu")
    p = iqcc_from_jax(params, device="cpu")["params"]
    e = Observable(H, n).expectation_auto(driver._state(p, driver.segment(masks)))
    e.backward()
    assert float(e.detach()) == pytest.approx(float(e_ref), abs=1e-10)
    for k in ("tau", "theta", "phi"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_ref[k]), rtol=0, atol=1e-10)
    assert float(np.abs(np.asarray(g_ref["tau"])).max()) > 1e-2


def test_select_operator():
    rng = np.random.default_rng(3)
    th = np.array([np.pi] * 4 + [0.0] * 4) + rng.normal(0, 0.3, 8)
    ph = rng.normal(0, 0.3, 8)
    kw = dict(n_epoch=1, lr=1e-2, threshold=5e-3, ground_truth=False, plot=False,
              log_metrics=False, results_root="unused")
    j = JaxIQCC(_jax_h2x2(), **kw)
    j.params = dict(j.params, theta=jnp.asarray(th), phi=jnp.asarray(ph))
    t = IQCC(_h2x2(), device="cpu", **kw)
    t.params = iqcc_from_jax({"theta": th, "phi": ph, "tau": np.zeros(0)})["params"]
    gens, labels, grads = t.select_operator(Observable(t.current_hamiltonian, 8))
    gens_r, labels_r, grads_r = j.select_operator(JaxObservable(j.current_hamiltonian, 8))
    assert labels == labels_r and len(labels) > 1
    np.testing.assert_allclose(grads, grads_r, rtol=0, atol=1e-10)
    for P, Q in zip(gens, gens_r):
        assert (P.x[0], P.z[0], P.c[0]) == (Q.x[0], Q.z[0], Q.c[0])


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request, tmp_path_factory):
    """Epoch 1 in each package, each checkpoint copied for the other package
    to resume, then each package carried on in process to epoch 2 and each
    copy resumed to epoch 2 by the other package."""
    root = tmp_path_factory.mktemp(request.param)
    kw = dict(KW_2X2, **MODES[request.param])
    j = JaxIQCC(_jax_h2x2(), n_epoch=1, results_root=str(root / "j"), **kw)
    j.run()
    t = IQCC(_h2x2(), n_epoch=1, results_root=str(root / "t"), device="cpu", **kw)
    t.run()
    shutil.copytree(root / "j", root / "t_from_j")
    shutil.copytree(root / "t", root / "j_from_t")
    j.n_epoch = t.n_epoch = 2
    j.run()
    t.run()
    t_from_j = IQCC(_h2x2(), n_epoch=2, results_root=str(root / "t_from_j"), device="cpu",
                    load_model=True, **kw)
    t_from_j.run()
    j_from_t = JaxIQCC(_jax_h2x2(), n_epoch=2, results_root=str(root / "j_from_t"),
                       load_model=True, **kw)
    j_from_t.run()
    return request.param, root, kw, j, t, t_from_j, j_from_t


def test_two_epochs_match(runs):
    mode, _, _, j, t, _, _ = runs
    _same_history(t.loss_history, j.loss_history)
    assert t.selected_ops == j.selected_ops
    assert len(t.loss_history["epoch"]) == 2
    if mode == "dense_ilc":
        assert any(s.startswith("ILC[") for s in t.selected_ops)
        np.testing.assert_allclose(t._dense_h.numpy(), j._dense_h, rtol=0, atol=1e-10)
    else:
        assert len(t.current_hamiltonian) == len(j.current_hamiltonian) > 153
        np.testing.assert_array_equal(t.current_hamiltonian.x, j.current_hamiltonian.x)
        np.testing.assert_allclose(t.current_hamiltonian.c, j.current_hamiltonian.c, rtol=0,
                                   atol=1e-10)
    assert t.epoch_stats[-1]["selected"] > 0 and len(t.epoch_stats) == 2


def test_cross_resume(runs):
    mode, root, _, j, t, t_from_j, j_from_t = runs
    for resumed, straight in ((t_from_j, j), (j_from_t, t)):
        _same_history(resumed.loss_history, straight.loss_history)
        assert resumed.selected_ops == straight.selected_ops
    if mode == "dense_ilc":
        assert glob.glob(str(root / "t_from_j" / "**" / "*.dense.npy"), recursive=True)
        np.testing.assert_allclose(t_from_j._dense_h.numpy(), j._dense_h, rtol=0, atol=1e-10)
        np.testing.assert_allclose(j_from_t._dense_h, t._dense_h.numpy(), rtol=0, atol=1e-10)


def test_dense_resume_sidecar(runs):
    """A dense checkpoint whose sidecar is lost is refused by both packages
    (its npz holds the undressed H); a symbolic checkpoint (no sidecar,
    the dressed sum in the npz) resumes in the dense mode from that sum."""
    mode, root, kw, j, _, _, _ = runs
    dense_kw = dict(kw, dense_dressing=True)
    if mode == "adam":
        resumed = IQCC(_h2x2(), n_epoch=2, results_root=str(root / "j"), device="cpu",
                       load_model=True, **dense_kw)
        assert resumed.loss_history == j.loss_history
        np.testing.assert_allclose(
            resumed._dense_h.numpy(),
            paulisum_to_dense(PauliSum(*(np.asarray(a) for a in (
                j.current_hamiltonian.x, j.current_hamiltonian.z, j.current_hamiltonian.c))),
                8), rtol=0, atol=1e-12)
        return
    for name, make in (("t", lambda r: JaxIQCC(_jax_h2x2(), n_epoch=2, results_root=r,
                                                 load_model=True, **dense_kw)),
                       ("j", lambda r: IQCC(_h2x2(), n_epoch=2, results_root=r, device="cpu",
                                            load_model=True, **dense_kw))):
        lost = root / f"{name}_lost"
        shutil.copytree(root / name, lost)
        sidecars = glob.glob(str(lost / "**" / "*.dense.npy"), recursive=True)
        assert sidecars
        for s in sidecars:
            os.remove(s)
        with pytest.raises(RuntimeError, match="sidecar"):
            make(str(lost))


def test_lbfgs_epoch_energy(tmp_path):
    kw = dict(n_epoch=1, lr=1e-2, threshold=1e-5, max_inner_iterations=300,
              inner_optimizer="lbfgs", plot=False, log_metrics=False, tag="iqcc-lbfgs")
    j = JaxIQCC(_jax_h2x2(), results_root=str(tmp_path / "j"), **kw)
    j.run()
    t = IQCC(_h2x2(), results_root=str(tmp_path / "t"), device="cpu", **kw)
    t.run()
    assert t.selected_ops == j.selected_ops
    assert t.loss_history["epoch"][0] == pytest.approx(j.loss_history["epoch"][0], abs=1e-6)
    # the warm-up stops short of the threshold: L-BFGS iterations did run
    assert len(t.loss_history["iteration"]) > 75
    assert t.loss_history["epoch"][0] < t.loss_history["iteration"][74] - 1.0
