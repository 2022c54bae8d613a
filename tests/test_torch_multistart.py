"""The port's batched multistart VQE (``qsfh_torch/algos/multistart.py``)
against the JAX module (complex128, CPU).

* ``batched_train`` on a generic loss (B = 3, 10 epochs): trajectories,
  final energies and parameters against JAX's (1e-12).
* ``MultistartHVA`` 2x2 (B = 4, 20 epochs; the per-term kernels' plain
  route) and ``MultistartHEA`` H2 (B = 2, 10 epochs): the same numpy
  initial draws bit for bit, per-start trajectories and final energies
  within 1e-9 of JAX's, the same best start, the result dict's keys.
* ``multistart_from_jax`` carries JAX ``batch_params`` over; the
  validation errors (no starts; every start non-finite; a warning when
  some are).
"""

import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qsfh_tpu.algos import multistart as J
from qsfh_tpu.molecules import H2 as JaxH2
from qsfh_torch.algos import multistart as T
from qsfh_torch.io.convert import multistart_from_jax
from qsfh_torch.molecules import H2

TRAJ_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_batched_train_generic_loss():
    target = np.array([1.0, -2.0, 3.0])
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 3))
    w0 = rng.normal(size=(3, 2))

    def jloss(p):
        return jnp.sum((p["x"] - target) ** 2) + jnp.sum(jnp.sin(p["w"]) * p["x"][:2])

    tt = torch.tensor(target)

    def tloss(p):
        return ((p["x"] - tt) ** 2).sum() + (torch.sin(p["w"]) * p["x"][:2]).sum()

    jf, jtraj, je = J.batched_train(jloss, {"x": jnp.asarray(x0), "w": jnp.asarray(w0)},
                                    optax.adam(0.2), 10)
    batch = {"x": torch.tensor(x0), "w": torch.tensor(w0)}
    tf, ttraj, te = T.batched_train(tloss, batch, functools.partial(torch.optim.Adam, lr=0.2), 10)
    assert ttraj.shape == (10, 3)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-12)
    for k in ("x", "w"):
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), rtol=0, atol=1e-12)
    assert torch.equal(batch["x"], torch.tensor(x0))  # the caller's tensors are not changed
    # a plain tensor batch
    _, traj, fin = T.batched_train(lambda r: (r ** 2).sum(), torch.tensor(x0),
                                   functools.partial(torch.optim.Adam, lr=0.1), 3)
    assert traj.shape == (3, 3) and fin.shape == (3,)


def _compare(jres, tres, key):
    assert set(tres) == set(jres)
    np.testing.assert_allclose(tres["energies"], np.asarray(jres["energies"]), rtol=0,
                               atol=TRAJ_TOL)
    np.testing.assert_allclose(tres["final_energies"], jres["final_energies"], rtol=0,
                               atol=TRAJ_TOL)
    assert tres["best_index"] == jres["best_index"]
    assert abs(tres["best_energy"] - jres["best_energy"]) < TRAJ_TOL
    assert abs(tres[key] - jres[key]) < 1e-10
    assert abs(tres["best_gap"] - jres["best_gap"]) < TRAJ_TOL


def test_multistart_hva_2x2_matches_jax(tmp_path):
    kw = dict(n_starts=4, n_epoch=20, reps=2, lr=3e-2, init_scale=0.1, seed=0,
              results_root=str(tmp_path))
    j = J.MultistartHVA(**kw)
    t = T.MultistartHVA(**kw, device="cpu")
    assert t.dtype == torch.complex128
    for k, v in j.batch_params.items():
        np.testing.assert_array_equal(t.batch_params[k].numpy(), np.asarray(v))
    jres, tres = j.run(), t.run()
    _compare(jres, tres, "ground_state_energy")
    for k, v in jres["best_params"].items():
        np.testing.assert_allclose(tres["best_params"][k], np.asarray(v), rtol=0, atol=TRAJ_TOL)
    # one start's loss equals the JAX loss on the same angles
    row = {k: v[1] for k, v in t.batch_params.items()}
    jrow = {k: v[1] for k, v in j.batch_params.items()}
    assert abs(float(t.loss(row)) - float(j.loss(jrow))) < 1e-12


def test_multistart_hea_h2_matches_jax():
    kw = dict(n_starts=2, n_epoch=10, reps=2, lr=0.1, seed=1)
    j = J.MultistartHEA(JaxH2(r=0.8), **kw)
    t = T.MultistartHEA(H2(r=0.8), **kw, device="cpu")
    np.testing.assert_array_equal(t.batch_params.numpy(), np.asarray(j.batch_params))
    jres, tres = j.run(), t.run()
    _compare(jres, tres, "fci_energy")
    np.testing.assert_allclose(tres["best_params"], np.asarray(jres["best_params"]), rtol=0,
                               atol=TRAJ_TOL)


def test_multistart_from_jax(tmp_path):
    j = J.MultistartHVA(n_starts=3, n_epoch=1, reps=1, lr=1e-2, seed=4, ground_truth=False,
                        results_root=str(tmp_path))
    got = multistart_from_jax({k: np.asarray(v) for k, v in j.batch_params.items()})
    for k, v in j.batch_params.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    h = J.MultistartHEA(JaxH2(r=0.8), n_starts=2, n_epoch=1, reps=1, lr=0.1, seed=2)
    got = multistart_from_jax(np.asarray(h.batch_params), dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, 4, 3)
    with pytest.raises(ValueError, match="lack"):
        multistart_from_jax({"theta_U": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="HEA angles"):
        multistart_from_jax(np.zeros((2, 3)))


def test_validation_errors(tmp_path):
    with pytest.raises(ValueError, match="n_starts"):
        T.MultistartHVA(n_starts=0, n_epoch=1, reps=1, lr=1e-2, ground_truth=False,
                        results_root=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="n_starts"):
        T.MultistartHEA(H2(r=0.8), n_starts=0, n_epoch=1, reps=1, lr=0.1, device="cpu")
    batch = torch.zeros(3, 2, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="diverged"):
        T._run_batched(lambda r: r.sum() / 0.0 * 0.0, batch, 0.1, 1)
    with pytest.warns(UserWarning, match="non-finite"):
        res = T._run_batched(lambda r: (r.sum() + 1.0).log() * (1.0 if float(r[0].detach()) == 0
                                                                   else float("nan")),
                             torch.tensor([[1.0, 1.0], [0.0, 0.0]]), 0.0, 1)
    assert res["best_index"] == 1
