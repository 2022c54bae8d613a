"""The port's ADAPT driver against the JAX driver: the slice as a whole.

* A 2x2 run (t=1, U=4, 2 up / 2 down; 2 epochs, <= 5 inner iterations)
  gives the same selected operators in the same order and the same
  per-iteration energy, Sz, S^2, fidelity and gradient norm within 1e-9
  at complex128.  The port reads JAX's cached ground state through the
  same results_root layout.
* One 2x3 train step (t=1, U=4, 3 up / 3 down; the 12-operator ansatz at
  theta = 0.05, Adam lr 1e-2) matches at complex64 within 1e-5 relative.
* ``from_jax`` round-trips a JAX checkpoint, and ``torch.optim.Adam``
  matches ``optax.adam`` over 5 updates.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_tpu.io import checkpoint as jax_ckpt
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.io import checkpoint as ckpt
from qsfh_torch.io.convert import from_jax, load_adam_state

RUN_2X2 = dict(
    n_epoch=2, threshold1=1e-3, threshold2=1e-6, x_dimension=2, y_dimension=2,
    n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=4,
    max_inner_iterations=5, plot=False,
)


def _metrics(a):
    with open(a.metrics.jsonl_path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory):
    jroot = str(tmp_path_factory.mktemp("jax_adapt"))
    troot = str(tmp_path_factory.mktemp("torch_adapt"))
    j = JaxADAPT(**RUN_2X2, results_root=jroot)
    jres = j.run()
    shutil.copytree(os.path.join(jroot, "ground_state_results"),
                    os.path.join(troot, "ground_state_results"))
    t = ADAPT(**RUN_2X2, results_root=troot, device="cpu")
    tres = t.run()
    return j, jres, t, tres


def test_run_2x2_selects_the_same_operators(runs_2x2):
    j, jres, t, tres = runs_2x2
    assert t.dtype == torch.complex128
    assert t.selected_indices == j.selected_indices
    assert tres["selected operators"] == jres["selected operators"]
    assert tres["n_params"] == jres["n_params"]


@pytest.mark.parametrize("key", ["iteration loss", "epoch loss", "Sz", "S^2", "fidelity"])
def test_run_2x2_histories_match(runs_2x2, key):
    _, jres, _, tres = runs_2x2
    assert len(tres[key]) == len(jres[key]) > 0
    np.testing.assert_allclose(tres[key], jres[key], rtol=0, atol=1e-9)


def test_run_2x2_gradient_norms_and_weights_match(runs_2x2):
    j, _, t, _ = runs_2x2
    jm, tm = _metrics(j), _metrics(t)
    assert len(jm) == len(tm)
    np.testing.assert_allclose([m["norm"] for m in tm], [m["norm"] for m in jm], rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.params_t.numpy(), np.asarray(j.params_t), rtol=0, atol=1e-9)


def test_run_2x2_checkpoint_resumes(runs_2x2):
    _, _, t, _ = runs_2x2
    root = os.path.dirname(os.path.dirname(t.model_filepath))
    again = ADAPT(**RUN_2X2, results_root=root, device="cpu", load_model=True)
    assert again.selected_indices == t.selected_indices
    assert torch.equal(again.params_t, t.params_t)
    assert again.results["iteration loss"] == t.results["iteration loss"]


def test_jax_checkpoint_loads_in_the_port(runs_2x2):
    j, _, t, _ = runs_2x2
    params, meta, _ = ckpt.load_model(j.model_filepath)
    thetas, selected, state = from_jax(params)
    assert selected == t.selected_indices and state is None
    assert meta["pool_size"] == len(t.fermion_pool)
    np.testing.assert_allclose(thetas.numpy(), t.params_t.numpy(), rtol=0, atol=1e-9)


def test_step_2x3_complex64_matches(tmp_path):
    kw = dict(n_epoch=1, threshold1=1e-3, threshold2=1e-6, x_dimension=2, y_dimension=3,
              n_electrons=6, n_spin_up=3, n_spin_down=3, tunneling=1, coulomb=4,
              plot=False, log_metrics=False)
    j = JaxADAPT(**kw, results_root=str(tmp_path / "j"), dtype=jnp.complex64)
    t = ADAPT(**kw, results_root=str(tmp_path / "t"), device="cpu", dtype=torch.complex64,
              ground_state_path=j.problem.ground_state_path())
    indices = tuple(range(12))
    jstep = j._build_step_split(indices, optax.adam(1e-2))
    jth = jnp.full(12, 0.05, jnp.float32)
    out_j = jstep(jth, optax.adam(1e-2).init(jth))
    tth = torch.full((12,), 0.05, dtype=torch.float32)
    out_t = t._build_step(indices)(tth, torch.optim.Adam([tth], lr=1e-2))
    for a, b in zip(out_t[2:], out_j[2:]):  # energy, Sz, S^2, fidelity, gnorm
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-6)
    # the gradient the step fed to Adam, against JAX's adjoint stage
    raw = jstep.raw_stages
    psi_r = raw["fwd"](jth)
    jgrads = np.asarray(raw["adjoint"](psi_r, raw["cotangent"](psi_r), jth))
    tgrads = tth.grad.numpy()
    assert np.linalg.norm(tgrads - jgrads) <= 1e-5 * np.linalg.norm(jgrads)
    # Adam's first step is sign-like, so only well-resolved components of
    # the update are comparable at float32
    big = np.abs(jgrads) > 1e-3
    assert big.sum() >= 4
    np.testing.assert_allclose(out_t[0].numpy()[big], np.asarray(out_j[0])[big], rtol=1e-5)


def _adam_trajectories(n_updates=5, lr=3e-2):
    rng = np.random.default_rng(11)
    grads = rng.standard_normal((n_updates, 7))
    x0 = rng.standard_normal(7)
    opt = optax.adam(lr)
    jx, js = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    tx = torch.tensor(x0)
    topt = torch.optim.Adam([tx], lr=lr)
    for g in grads:
        upd, js = opt.update(jnp.asarray(g), js)
        jx = optax.apply_updates(jx, upd)
        tx.grad = torch.tensor(g)
        topt.step()
    return jx, js, tx, topt


def test_adam_matches_optax():
    jx, _, tx, _ = _adam_trajectories()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-13)


def test_from_jax_round_trips_a_checkpoint(tmp_path):
    jx, js, _, _ = _adam_trajectories(3)
    path = str(tmp_path / "ckpt.npz")
    jax_ckpt.save_model(path, {"t": np.asarray(jx), "selected_indices": np.arange(7)},
                        meta={"pool_size": 10}, opt_state=js)
    params, meta, leaves = ckpt.load_model(path)
    thetas, selected, state = from_jax(params, leaves)
    assert selected == list(range(7)) and meta == {"pool_size": 10}
    # rebuild the JAX arrays from the port's tensors: nothing is lost
    back_params = {"t": thetas.numpy().copy(), "selected_indices": np.asarray(selected)}
    back_leaves = [np.asarray(int(state["step"]), dtype=np.int32),
                   state["exp_avg"].numpy(), state["exp_avg_sq"].numpy()]
    for a, b in zip(back_leaves, leaves):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back_params["t"], params["t"])
    # one more update from the carried state agrees with optax
    g = np.random.default_rng(5).standard_normal(7)
    upd, _ = optax.adam(3e-2).update(jnp.asarray(g), js)
    ref = optax.apply_updates(jx, upd)
    topt = torch.optim.Adam([thetas], lr=3e-2)
    load_adam_state(topt, thetas, state)
    thetas.grad = torch.tensor(g)
    topt.step()
    np.testing.assert_allclose(thetas.numpy(), np.asarray(ref), rtol=0, atol=1e-13)
    # the port writes the same layout back
    out = str(tmp_path / "port.npz")
    ckpt.save_model(out, back_params, meta, back_leaves)
    p2, m2, l2 = jax_ckpt.load_model(out)
    assert m2 == meta and len(l2) == 3
    np.testing.assert_array_equal(p2["t"], params["t"])


def test_run_2x2_state_matches(runs_2x2):
    j, _, t, _ = runs_2x2
    np.testing.assert_allclose(t.state().numpy(), np.asarray(j.state()), rtol=0, atol=1e-9)
