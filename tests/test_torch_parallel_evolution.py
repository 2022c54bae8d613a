"""The port's sharded evolution, spectroscopy and multistart start axis against
the JAX package: ``TrotterEvolution`` / ``ScheduledEvolution`` /
``greens_function`` / ``ImaginaryTimeEvolution`` (``mesh=``), the Lanczos
functions (``mesh=``) and ``MultistartHVA(mesh_devices=)``, on gloo ranks on
the CPU (D = 2 and 4, one spawn each, every case computed in it; the rank
body is ``tests/torch_rank_bodies.evolution_cases``).  The JAX references are
computed here: Trotter and Lanczos on the conftest's virtual 8-device mesh,
as the JAX tests run them, the rest unsharded.  complex128 within 1e-10
(Lanczos and the spectral drivers 1e-9, their JAX tests' tolerance); the
multistart within 1e-12 of the port's one-process run and 1e-9 of the JAX
driver; every record the same bits on every rank.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_bodies as bodies
from qsfh_tpu.algos import dynamics as jdyn
from qsfh_tpu.algos import ite as jite
from qsfh_tpu.algos import multistart as jms
from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.expectation import Observable as JaxObservable
from qsfh_tpu.linalg import spectral as jspec
from qsfh_tpu.linalg.sectors import random_sector_state as jax_random_sector_state
from qsfh_tpu.parallel import amplitude_mesh as jax_mesh
from qsfh_torch.algos.base import HubbardProblem
from qsfh_torch.algos.multistart import MultistartHEA, MultistartHVA, start_mesh
from qsfh_torch.molecules import H2
from qsfh_torch.parallel import spawn_ranks

TOL = 1e-10
LANCZOS_TOL = 1e-9
MS_TOL = 1e-12
MS_JAX_TOL = 1e-9
QUENCH = (2, 2, 1.0, 4.0, 4, 2, 2)
ITE = (2, 2, 1.0, 6.0, 4, 2, 2)
TROTTER_STEPS = 20
ITE_STEPS = 7
LANCZOS_M = 12
SPECTRAL_M = 20
SPECTRAL_MODES = (("particle", 0), ("hole", 0))
DSF_CASES = (("spin", (1, 0)), ("charge", (1, 1)))
MS = dict(n_starts=8, n_epoch=4, reps=2, lr=3e-2, init_scale=0.1, seed=0)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return v / np.linalg.norm(v)


def _lanczos_phi():
    """tests/test_spectral.py's seeded phi of the mesh case."""
    rng = np.random.default_rng(5)
    return rng.standard_normal(256) + 1j * rng.standard_normal(256)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The ranks' inputs (the ED state solved here; the ranks read its
    cache) and the port's one-process multistart run."""
    root = str(tmp_path_factory.mktemp("results"))
    e0, gs = HubbardProblem(*ITE, results_root=root).ground_state(device="cpu")
    psi0 = np.zeros(256, np.complex128)
    psi0[sum(1 << (7 - q) for q in (0, 3, 5, 6))] = 1.0  # the JAX quench's Neel state
    draws = [np.asarray(jax_random_sector_state(8, 4, 2, key=k))
             for k in jax.random.split(jax.random.PRNGKey(3), 4)]
    ms = dict(MS, results_root=root)
    single = MultistartHVA(device="cpu", **ms).run()
    inp = dict(quench=QUENCH, psi0=psi0, greens_gs=_random_state(8, 7), ite=ITE,
               ite_v=_random_state(8, 3), thermal_draws=draws, spectral=ITE,
               lanczos_phi=_lanczos_phi(),
               spectral_gs=np.asarray(gs), spectral_e0=float(e0), spectral_m=SPECTRAL_M,
               spectral_modes=SPECTRAL_MODES, dsf_cases=DSF_CASES,
               omegas=np.linspace(-4.0, 12.0, 41), multistart=ms)
    return dict(inp=inp, single=single, root=root)


@pytest.fixture(scope="module")
def spawned(inputs):
    """Both groups (D = 2 and 4) started at once, each from a thread of this
    process; their results are collected where first needed, so the JAX
    references are computed while the ranks run."""
    pool = ThreadPoolExecutor(2)
    futures = {d: pool.submit(spawn_ranks, bodies.evolution_cases, d, backend="gloo",
                              device="cpu", timeout=300, args=(inputs["inp"],))
               for d in (2, 4)}
    yield futures
    pool.shutdown()


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request, spawned, jax_refs):
    d = request.param
    return d, spawned[d].result()


@pytest.fixture(scope="module")
def jax_refs(inputs):
    inp = inputs["inp"]
    out = {}
    jq = JaxProblem(*QUENCH)
    mesh = jax_mesh(8)
    ev = jdyn.TrotterEvolution(jq, dt=0.05, order=2, dtype=jnp.complex128, mesh=mesh)
    out["trotter"] = ev.evolve(inp["psi0"], TROTTER_STEPS, {"H": jq.observables["H"]})
    sched = jdyn.ScheduledEvolution(jq, dt=0.08, order=2, dtype=jnp.complex128)
    out["scheduled"] = sched.evolve(inp["psi0"], 5, observables={"H": jq.observables["H"]},
                                    overlaps={"psi0": inp["psi0"]}, coulomb=bodies.u_ramp,
                                    tunneling=bodies.T_RAMP)
    out["greens"] = {kind: jdyn.greens_function(jq, inp["greens_gs"], -3.1, 0, dt=0.1,
                                                n_steps=5, kind=kind, dtype=jnp.complex128)
                     for kind in ("particle", "hole")}
    ji = JaxProblem(*ITE, results_root=inputs["root"])
    out["ite"] = jite.ImaginaryTimeEvolution(ji, dbeta=0.05, order=2).run(
        inp["ite_v"], n_steps=ITE_STEPS, block=3)
    out["thermal"] = jite.ImaginaryTimeEvolution(ji, dbeta=0.05, order=4).thermal_expectation(
        1.0, {"H": ji.observables["H"]}, 4, key=jax.random.PRNGKey(3))
    ham = JaxObservable(ji.qubit_hamiltonian, 8)
    with mesh:
        out["lanczos"] = jspec.lanczos_tridiagonal(ham.apply_auto, inp["lanczos_phi"],
                                                   m=LANCZOS_M, mesh=mesh)
    gs, e0, omegas = inp["spectral_gs"], inp["spectral_e0"], inp["omegas"]
    out["spectral"] = {f"{kind} {mode}": jspec.spectral_function_lanczos(
        ji, gs, e0, mode, kind, m=SPECTRAL_M, omegas=omegas, dtype=jnp.complex128)
        for kind, mode in SPECTRAL_MODES}
    out["dsf"] = {f"{kind} {q}": jspec.dynamical_structure_factor(
        ji, gs, e0, q, kind=kind, m=SPECTRAL_M, omegas=omegas, eta=0.1, dtype=jnp.complex128)
        for kind, q in DSF_CASES}
    out["multistart"] = jms.MultistartHVA(**inp["multistart"]).run()
    return out


def _same_on_every_rank(out, *keys):
    for r in out[1:]:
        for key in keys:
            a, b = out[0], r
            for k in key.split("."):
                a, b = a[k], b[k]
            if isinstance(a, dict):
                assert sorted(a) == sorted(b), key
                for k in a:
                    assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), f"{key}.{k}"
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b)), key


# -- real time ---------------------------------------------------------------------------------


def test_trotter_matches_jax(ranks, jax_refs):
    """20 Strang steps of the 2x2 Neel quench: the gathered final state and
    the H record within 1e-10 of the JAX evolution on the virtual mesh; a
    start given as the rank's shard gives the same bits; per step one
    exchange a pair run and one per cross x_hi of H, and ONE rank-order sum."""
    _, out = ranks
    psi_j, rec_j = jax_refs["trotter"]
    for r in out:
        t = r["trotter"]
        np.testing.assert_allclose(t["state"], np.asarray(psi_j), rtol=0, atol=TOL)
        np.testing.assert_allclose(t["H"], rec_j["H"], rtol=0, atol=TOL)
        assert t["shard_in_same"]
        assert t["pair_runs"] > 0 and t["cross"] > 0
        assert t["counts"]["exchanges"] == TROTTER_STEPS * (t["pair_runs"] + t["cross"])
        assert t["counts"]["sums"] == TROTTER_STEPS
    _same_on_every_rank(out, "trotter.H", "trotter.state")


def test_scheduled_evolution_matches_jax(ranks, jax_refs):
    """A U ramp and a t schedule (5 Strang steps): the records, shift_phase
    and the final state within 1e-10."""
    _, out = ranks
    psi_j, rec_j = jax_refs["scheduled"]
    for r in out:
        s = r["scheduled"]
        np.testing.assert_allclose(s["state"], np.asarray(psi_j), rtol=0, atol=TOL)
        for name in ("H", "psi0", "shift_phase"):
            np.testing.assert_allclose(s[name], rec_j[name], rtol=0, atol=TOL, err_msg=name)
    _same_on_every_rank(out, "scheduled.H", "scheduled.psi0")


def test_greens_function_top_bit_matches_jax(ranks, jax_refs):
    """Mode 0: the ladder's strings flip qubit 0, the top flat bit, so phi is
    built by the partner apply with complex coefficients."""
    _, out = ranks
    for kind, (tj, gj) in jax_refs["greens"].items():
        for r in out:
            np.testing.assert_allclose(r["greens"][kind]["times"], tj, rtol=0, atol=0)
            np.testing.assert_allclose(r["greens"][kind]["G"], gj, rtol=0, atol=TOL,
                                       err_msg=kind)
    _same_on_every_rank(out, "greens.particle.G", "greens.hole.G")


# -- imaginary time ----------------------------------------------------------------------------


def test_ite_matches_jax(ranks, jax_refs):
    """7 order-2 steps in blocks of 3: energies, variances and the gathered
    state within 1e-10; two rank-order sums a step and one exchange per
    cross x_hi of H an application."""
    _, out = ranks
    psi_j, rec_j = jax_refs["ite"]
    for r in out:
        i = r["ite"]
        np.testing.assert_allclose(i["state"], np.asarray(psi_j), rtol=0, atol=TOL)
        for key in ("energies", "variances"):
            assert i[key].shape == (ITE_STEPS,)
            np.testing.assert_allclose(i[key], rec_j[key], rtol=0, atol=TOL, err_msg=key)
        assert i["counts"]["sums"] == 2 * ITE_STEPS
        assert i["counts"]["exchanges"] == ITE_STEPS * 2 * i["cross"] > 0
    _same_on_every_rank(out, "ite.energies", "ite.variances")


def test_thermal_expectation_matches_jax(ranks, jax_refs):
    """The JAX driver's four sector draws, whole on every rank: the estimate
    and the diagnostics within 1e-10."""
    _, out = ranks
    est_j, diag_j = jax_refs["thermal"]
    for r in out:
        est, diag = r["thermal"]["estimates"], r["thermal"]["diagnostics"]
        assert abs(est["H"] - est_j["H"]) <= TOL
        assert abs(diag["stderrs"]["H"] - diag_j["stderrs"]["H"]) <= TOL
        for name in ("beta_effective", "n_samples", "log_weight_spread", "effective_samples"):
            assert abs(diag[name] - diag_j[name]) <= TOL, name
    _same_on_every_rank(out, "thermal.estimates")


# -- Lanczos -----------------------------------------------------------------------------------


def test_lanczos_tridiagonal_matches_jax(ranks, jax_refs):
    """m = 12 from the seeded phi of the JAX test, given whole (n_qubits=8):
    alpha, beta and norm2 within 1e-9 of the JAX recursion on the virtual
    mesh; two rank-order sums a step (and two for phi's norm)."""
    _, out = ranks
    a_j, b_j, n_j = jax_refs["lanczos"]
    for r in out:
        lz = r["lanczos"]
        assert lz["alphas"].shape == (LANCZOS_M,)
        np.testing.assert_allclose(lz["alphas"], a_j, rtol=0, atol=LANCZOS_TOL)
        np.testing.assert_allclose(lz["betas"], b_j, rtol=0, atol=LANCZOS_TOL)
        assert abs(lz["norm2"] - n_j) <= LANCZOS_TOL * n_j
        assert lz["counts"]["sums"] == 2 * LANCZOS_M + 2
    _same_on_every_rank(out, "lanczos.alphas", "lanczos.betas")


def _poles_match(got, ref):
    """The poles that carry weight (above 1e-10: the closed 2x2 Krylov space
    ends in near-zero-weight poles where one recursion runs past its
    breakdown and the other stops) and their weights, and A(omega)."""
    assert abs(got["norm2"] - ref["norm2"]) < LANCZOS_TOL
    live_g, live_r = got["weights"] > 1e-10, ref["weights"] > 1e-10
    assert live_g.sum() == live_r.sum()
    np.testing.assert_allclose(got["poles"][live_g], ref["poles"][live_r], rtol=0,
                               atol=LANCZOS_TOL)
    np.testing.assert_allclose(got["weights"][live_g], ref["weights"][live_r], rtol=0,
                               atol=LANCZOS_TOL)
    np.testing.assert_allclose(got["A"], ref["A"], rtol=0, atol=LANCZOS_TOL)


def test_spectral_drivers_match_jax(ranks, jax_refs):
    """spectral_function_lanczos (mode 0 both ways: the ladder flips the top bit) and
    dynamical_structure_factor (spin and charge) from the ED ground state:
    poles carrying weight, weights and A(omega) within 1e-9."""
    _, out = ranks
    for group in ("spectral", "dsf"):
        for key, ref in jax_refs[group].items():
            for r in out:
                _poles_match(r[group][key], ref)
            _same_on_every_rank(out, f"{group}.{key}")


# -- multistart's start axis -------------------------------------------------------------------


def test_multistart_start_axis(ranks, inputs, jax_refs):
    """MultistartHVA(mesh_devices=D), 2x2 B = 8 reps = 2: every rank returns
    the one-process run's result (within 1e-12; the same bits in practice:
    the rows' kernels and Adam are elementwise) and the JAX driver's (1e-9);
    the epochs make no exchange and no sum; the results take one gather
    each (the parameter blocks, the trajectories, the final energies)."""
    d, out = ranks
    single, jres = inputs["single"], jax_refs["multistart"]
    for r in out:
        res = r["multistart"]["result"]
        assert res["energies"].shape == (MS["n_epoch"], MS["n_starts"])
        for key in ("energies", "final_energies"):
            np.testing.assert_allclose(res[key], single[key], rtol=0, atol=MS_TOL, err_msg=key)
            np.testing.assert_allclose(res[key], np.asarray(jres[key]), rtol=0,
                                       atol=MS_JAX_TOL, err_msg=key)
        assert res["best_index"] == single["best_index"] == jres["best_index"]
        for k, v in single["best_params"].items():
            np.testing.assert_allclose(res["best_params"][k], v, rtol=0, atol=MS_TOL)
            np.testing.assert_allclose(res["best_params"][k], np.asarray(jres["best_params"][k]),
                                       rtol=0, atol=MS_JAX_TOL)
        assert abs(res["best_gap"] - single["best_gap"]) <= MS_TOL
        counts = r["multistart"]["counts"]
        assert counts["exchanges"] == counts["sums"] == 0
        assert counts["gathers"] == r["multistart"]["leaves"] + 2
    _same_on_every_rank(out, "multistart.result.energies", "multistart.result.final_energies",
                        "multistart.result.best_params")


def test_multistart_mesh_validation(tmp_path):
    """n_starts % mesh_devices raises ValueError before any group is needed
    (both drivers); mesh_devices > 1 outside a group raises; the start mesh
    has no power-of-two rule and is of one without a group."""
    with pytest.raises(ValueError, match="divide evenly"):
        MultistartHVA(n_starts=6, n_epoch=1, reps=1, lr=1e-2, mesh_devices=4,
                      ground_truth=False, results_root=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        MultistartHEA(H2(r=0.8), n_starts=3, n_epoch=1, reps=1, lr=0.1, mesh_devices=2,
                      device="cpu")
    with pytest.raises(RuntimeError, match="spawn_ranks"):
        MultistartHVA(n_starts=6, n_epoch=1, reps=1, lr=1e-2, mesh_devices=3,
                      ground_truth=False, results_root=str(tmp_path), device="cpu")
    mesh = start_mesh(device="cpu")
    assert mesh.size == 1 and mesh.rank == 0
    with pytest.raises(ValueError, match="divide evenly"):
        jms.MultistartHVA(n_starts=6, n_epoch=1, reps=1, lr=1e-2, mesh_devices=4,
                          ground_truth=False, results_root=str(tmp_path))

