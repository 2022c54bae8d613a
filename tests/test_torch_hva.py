"""The port's HVA driver against the JAX driver: the slice as a whole.

* The program: ``hva_program`` (the Coulomb layer as ``diag`` segments)
  equals ``hva_program_rot`` (one rot segment) in the port, JAX's
  ``CompiledCircuit`` of ``hva_program_rot`` and JAX's gate-level
  ``hva_circuit``, at 2x3 (reps = 2, complex128): within 1e-12.  psi0 is
  JAX's ``_psi0_reim`` state, phase included, within 1e-12.
* Split = unrolled gradients in the port within 1e-10 (complex128).
* A 2x2 ``run()`` (reps = 4, lr 5e-2, 10 epochs, complex128) against the
  JAX driver: per-iteration loss, Sz, S^2, fidelity and gnorm within 1e-9,
  sharing JAX's ground-state cache.  Both start from the same angles drawn
  from ``default_rng(11)``, normal(0, 0.05): at zero angles the 2x2
  gradient is rounding noise (|g| ~ 1e-16) and Adam's first steps, which
  are sign-like, amplify it chaotically (from there the port's own split
  and unrolled lowerings part by 1.5e-3 in loss within 10 epochs).
* One 2x3 split step at complex64 within 1e-5 relative of JAX's.
* The 18-qubit program of ``__graft_entry__.entry`` (3x3, reps = 2, theta
  = 0.05; built here from ``qsfh_tpu`` modules, not through ``entry()``):
  its energy at complex64 within 1e-5 relative.
* Checkpoints resume across packages both ways, Adam leaves included,
  against an uninterrupted run of the other package within 1e-9.
* The composed ``raw_stages`` equal the step.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qsfh_tpu.algos.hva import HVA as JaxHVA
from qsfh_tpu.algos.hva import hva_circuit as jax_hva_circuit
from qsfh_tpu.algos.hva import hva_program_rot as jax_hva_program_rot
from qsfh_tpu.engine.circuits import slater_prep_reim
from qsfh_tpu.engine.compiled import CompiledCircuit as JaxCompiledCircuit
from qsfh_tpu.engine.state import from_reim
from qsfh_tpu.io import checkpoint as jax_ckpt
from qsfh_tpu.ops.jw import jordan_wigner as jax_jordan_wigner
from qsfh_torch.algos.hva import (
    HVA,
    flatten_hva_params,
    hva_circuit,
    hva_program,
    hva_program_rot,
)
from qsfh_torch.engine.compiled import CompiledCircuit
from qsfh_torch.io.convert import hva_from_jax, hva_to_jax_leaves, load_adam_state

KW_2X2 = dict(reps=4, lr=5e-2, x_dimension=2, y_dimension=2, n_electrons=4, n_spin_up=2,
              n_spin_down=2, tunneling=1.0, coulomb=6.0, plot=False)
KW_2X3 = dict(n_epoch=1, reps=2, lr=1e-2, x_dimension=2, y_dimension=3, n_electrons=6,
              n_spin_up=3, n_spin_down=3, tunneling=1.0, coulomb=4.0, plot=False,
              log_metrics=False, ground_truth=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small states: the tier-1 run puts
    several pytest workers on the cores, where torch's thread pool waits
    on descheduled threads (10-40x slower); the results do not change."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seeded(n_params, seed=11):
    return np.random.default_rng(seed).normal(0, 0.05, size=n_params)


def _jax_params(flat, sizes):
    b = np.cumsum((0,) + tuple(sizes))
    return {k: jnp.asarray(flat[b[i]:b[i + 1]])
            for i, k in enumerate(("theta_U", "theta_v", "theta_h"))}


def _metrics(driver):
    import json

    with open(driver.metrics.jsonl_path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def pair_2x3(tmp_path_factory):
    root = tmp_path_factory.mktemp("hva_2x3")
    j = JaxHVA(**KW_2X3, results_root=str(root / "j"), circuit_mode="split")
    t = HVA(**KW_2X3, results_root=str(root / "t"), device="cpu")
    return j, t


def test_psi0_matches_jax_phase_included(pair_2x3):
    j, t = pair_2x3
    ref = np.asarray(from_reim(j._psi0_reim, jnp.complex128))
    np.testing.assert_allclose(t._psi0.numpy(), ref, rtol=0, atol=1e-12)


def test_program_forms_agree_with_each_other_and_jax(pair_2x3):
    j, t = pair_2x3
    n = t.n_qubits
    flat = _seeded(sum(t.sizes), seed=3)
    th = torch.tensor(flat)
    psi_diag = CompiledCircuit(hva_program(t.reps, t._v_rot, t._h_rot, t._coulomb_diag),
                               n).apply(t._psi0, th)
    psi_rot = CompiledCircuit(hva_program_rot(t.reps, t._v_rot, t._h_rot, t._u_rot),
                              n).apply(t._psi0, th)
    psi_gates = hva_circuit(t._psi0, n, t._coulomb_diag, t._v_rot, t._h_rot, t.reps, th)
    np.testing.assert_allclose(psi_diag.numpy(), psi_rot.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(psi_gates.numpy(), psi_rot.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.state(th).numpy(), psi_rot.numpy(), rtol=0, atol=1e-12)
    psi0 = from_reim(j._psi0_reim, jnp.complex128)
    u_rot = jax_jordan_wigner(j.problem.interacting_term).rotation_terms()
    jcc = JaxCompiledCircuit(jax_hva_program_rot(j.reps, j._v_rot, j._h_rot, u_rot), n)
    ref = np.asarray(jcc.apply(psi0, jnp.asarray(flat)))
    np.testing.assert_allclose(psi_rot.numpy(), ref, rtol=0, atol=1e-12)
    params = _jax_params(flat, t.sizes)
    assert torch.equal(flatten_hva_params({k: np.asarray(v) for k, v in params.items()}), th)
    ref_gates = jax_hva_circuit(psi0, n, j._coulomb_diag, j._v_rot, j._h_rot, j.reps, params)
    np.testing.assert_allclose(psi_diag.numpy(), np.asarray(ref_gates), rtol=0, atol=1e-12)


def test_split_and_unrolled_gradients_agree(pair_2x3, tmp_path):
    _, t = pair_2x3
    u = HVA(**KW_2X3, results_root=str(tmp_path), device="cpu", circuit_mode="unrolled")
    flat = _seeded(sum(t.sizes), seed=4)
    outs, grads = [], []
    for driver in (t, u):
        th = torch.tensor(flat)
        out = driver._build_step()(th, torch.optim.Adam([th], lr=1e-2))
        outs.append([float(v) for v in out[2:]])
        grads.append(th.grad.numpy().copy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-10)


def test_raw_stages_compose_to_the_step(pair_2x3):
    _, t = pair_2x3
    raw = t._step.raw_stages
    flat = _seeded(sum(t.sizes), seed=7)
    a, b = torch.tensor(flat), torch.tensor(flat)
    oa, ob = torch.optim.Adam([a], lr=1e-2), torch.optim.Adam([b], lr=1e-2)
    for _ in range(3):
        out = t._step(a, oa)
        psi = raw["fwd"](b)
        e = raw["energy"](psi)
        g = raw["adjoint"](psi, raw["cotangent"](psi), b)
        sz, s2, fid = raw["metrics"](psi)
        _, _, gn = raw["update"](b, g, ob)
        assert [float(v) for v in out[2:]] == [float(v) for v in (e, sz, s2, fid, gn)]
    assert torch.equal(a, b)
    psi = raw["fwd"](b)
    assert torch.equal(raw["fwd_from"](t._psi0, b), psi)


def test_step_2x3_complex64_matches(tmp_path):
    j = JaxHVA(**KW_2X3, results_root=str(tmp_path / "j"), dtype=jnp.complex64)
    t = HVA(**KW_2X3, results_root=str(tmp_path / "t"), device="cpu", dtype=torch.complex64)
    flat = _seeded(sum(t.sizes)).astype(np.float32)
    params = _jax_params(flat, t.sizes)
    out_j = j._step(params, optax.adam(1e-2).init(params))
    th = torch.tensor(flat)
    out_t = t._step(th, torch.optim.Adam([th], lr=1e-2))
    for a, b in zip(out_t[2:], out_j[2:]):  # energy, Sz, S^2, fidelity, gnorm
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-6)
    raw = j._step.raw_stages
    psi_r = raw["fwd"](jnp.asarray(flat))
    jgrads = np.asarray(raw["adjoint"](psi_r, raw["cotangent"](psi_r), jnp.asarray(flat)))
    assert np.linalg.norm(th.grad.numpy() - jgrads) <= 1e-5 * np.linalg.norm(jgrads)


def test_graft_entry_program_18_qubits_complex64(tmp_path):
    """The program ``__graft_entry__.entry`` builds: 3x3, reps = 2, theta =
    0.05, the whole circuit one rot segment, E from the scan lowering."""
    kw = dict(n_epoch=0, reps=2, lr=1e-2, x_dimension=3, y_dimension=3, n_electrons=9,
              n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6, plot=False,
              log_metrics=False, ground_truth=False)
    t = HVA(**kw, results_root=str(tmp_path), device="cpu", dtype=torch.complex64)
    assert t.n_qubits == 18 and len(t._step.raw_stages) == 7
    th = torch.full((sum(t.sizes),), 0.05, dtype=torch.float32)
    raw = t._step.raw_stages
    e = float(raw["energy"](raw["fwd"](th)))

    from qsfh_tpu.algos.base import HubbardProblem as JaxProblem

    p = JaxProblem(3, 3, 1, 6, 9, 5, 4)
    h_gen, v_gen = p.hva_generators()
    cc = JaxCompiledCircuit(
        jax_hva_program_rot(2, [g.rotation_terms() for g in v_gen],
                            [g.rotation_terms() for g in h_gen],
                            jax_jordan_wigner(p.interacting_term).rotation_terms()), 18)
    psi0 = from_reim(slater_prep_reim(18, p.spin_up_indices + p.spin_down_indices, p.diagonal,
                                      p.decomposition, dtype=jnp.complex64), jnp.complex64)
    e_ref = float(p.observables["H"].expectation_scan(
        cc.apply(psi0, jnp.full(sum(t.sizes), 0.05, jnp.float32))))
    assert abs(e - e_ref) <= 1e-5 * abs(e_ref)


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory):
    jroot = str(tmp_path_factory.mktemp("jax_hva"))
    troot = str(tmp_path_factory.mktemp("torch_hva"))
    j = JaxHVA(n_epoch=10, **KW_2X2, results_root=jroot)
    t = HVA(n_epoch=10, **KW_2X2, results_root=troot, device="cpu")
    flat = _seeded(sum(t.sizes))
    j.params = _jax_params(flat, t.sizes)
    t.params_t = torch.tensor(flat)
    jres = j.run()
    shutil.copytree(os.path.join(jroot, "ground_state_results"),
                    os.path.join(troot, "ground_state_results"), dirs_exist_ok=True)
    tres = t.run()
    return j, jres, t, tres, flat


@pytest.mark.parametrize("key", ["loss", "Sz", "S^2", "fidelity"])
def test_run_2x2_histories_match(runs_2x2, key):
    _, jres, t, tres, _ = runs_2x2
    assert t.dtype == torch.complex128
    assert len(tres[key]) == len(jres[key]) == 10
    np.testing.assert_allclose(tres[key], jres[key], rtol=0, atol=1e-9)


def test_run_2x2_gradient_norms_and_weights_match(runs_2x2):
    j, _, t, _, _ = runs_2x2
    jm, tm = _metrics(j), _metrics(t)
    assert [m["iter"] for m in tm] == [m["iter"] for m in jm]
    np.testing.assert_allclose([m["norm"] for m in tm], [m["norm"] for m in jm], rtol=0,
                               atol=1e-9)
    for k, v in t.params.items():
        np.testing.assert_allclose(v, np.asarray(j.params[k]), rtol=0, atol=1e-9)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_resume_across_packages(runs_2x2, tmp_path, direction):
    j, _, t, _, flat = runs_2x2
    kw = dict(KW_2X2, log_metrics=False)
    kw_port = dict(kw, device="cpu")
    root = str(tmp_path)
    shutil.copytree(os.path.join(os.path.dirname(os.path.dirname(t.model_filepath)),
                                 "ground_state_results"),
                    os.path.join(root, "ground_state_results"))
    if direction == "jax_to_port":
        first = JaxHVA(n_epoch=3, **kw, results_root=root)
        first.params = _jax_params(flat, t.sizes)
        first.run()
        _, _, leaves = jax_ckpt.load_model(first.model_filepath)
        assert len(leaves) == 7  # count, mu and nu over the sorted keys
        second = HVA(n_epoch=10, **kw_port, results_root=root, load_model=True)
        reference = j.results  # JAX's uninterrupted 10-epoch run from the same angles
    else:
        first = HVA(n_epoch=3, **kw_port, results_root=root)
        first.params_t = torch.tensor(flat)
        first.run()
        second = JaxHVA(n_epoch=10, **kw, results_root=root, load_model=True)
        reference = t.results  # the port's uninterrupted run
    res = second.run()
    for key in ("loss", "Sz", "S^2", "fidelity"):
        np.testing.assert_allclose(res[key], reference[key], rtol=0, atol=1e-9)


def test_adam_leaves_convert_in_tree_order():
    sizes = (3, 4, 5)
    rng = np.random.default_rng(2)
    params = {k: jnp.asarray(rng.standard_normal(s))
              for k, s in zip(("theta_U", "theta_v", "theta_h"), sizes)}
    opt = optax.adam(3e-2)
    state = opt.init(params)
    for _ in range(3):
        g = {k: jnp.asarray(rng.standard_normal(v.shape)) for k, v in params.items()}
        upd, state = opt.update(g, state)
        params = optax.apply_updates(params, upd)
    import jax

    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    flat, adam = hva_from_jax({k: np.asarray(v) for k, v in params.items()}, leaves)
    th = flat.clone()
    topt = torch.optim.Adam([th], lr=3e-2)
    load_adam_state(topt, th, adam)
    back = hva_to_jax_leaves(topt, th, sizes)
    assert len(back) == len(leaves) == 7
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a, b)
    # one more update from the carried state agrees with optax
    g = {k: jnp.asarray(rng.standard_normal(v.shape)) for k, v in params.items()}
    upd, _ = opt.update(g, state)
    ref = optax.apply_updates(params, upd)
    th.grad = torch.tensor(np.concatenate([np.asarray(g[k]) for k in
                                           ("theta_U", "theta_v", "theta_h")]))
    topt.step()
    np.testing.assert_allclose(th.numpy(), np.concatenate(
        [np.asarray(ref[k]) for k in ("theta_U", "theta_v", "theta_h")]), rtol=0, atol=1e-13)
