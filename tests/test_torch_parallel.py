"""The port's amplitude-sharded engine (``qsfh_torch.parallel``) against the JAX
package's, as ``tests/test_parallel.py`` holds the JAX one: gloo ranks on the
CPU (D = 2 and 4, one spawn each, every case computed in it; the rank bodies
in ``tests/torch_rank_bodies.py``), the JAX functions on the conftest's
virtual CPU mesh.  complex128 within 1e-10 (the partner-form streaming
expectation: complex64, within float32 rounding); the drivers' runs within
1e-9 of the single-rank run and of the JAX driver, the same bits of thetas
on every rank.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_rank_bodies as bodies
from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_tpu.algos.base import HubbardProblem as JaxProblem
from qsfh_tpu.engine.expectation import PackedPool as JaxPool
from qsfh_tpu.ops.jw import jordan_wigner as jax_jw
from qsfh_tpu.ops.lattice import fermi_hubbard as jax_fermi_hubbard
from qsfh_tpu.ops.pool import hubbard_interaction_pool_simplified as jax_pool
from qsfh_tpu.parallel import amplitude_mesh as jax_mesh
from qsfh_tpu.parallel.pool_screening import build_sharded_pool_screen as jax_pool_screen
from qsfh_tpu.parallel.sharded_adapt import (build_sharded_adapt_train_step as jax_adapt_step,
                                             build_sharded_screen_fn as jax_screen_fn)
from qsfh_tpu.parallel.sharded_hva_shmap import (build_sharded_hva_step_shmap as jax_hva_shmap,
                                                 build_sharded_hva_train_step as jax_hva_train)
from qsfh_tpu.parallel.sharded_stream import sharded_expectation_stream as jax_stream
from qsfh_tpu.parallel.shmap_engine import ShardedPauliEngine as JaxEngine
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.algos.hva import HVA
from qsfh_torch.parallel import amplitude_mesh, comm, local_qubits, spawn_ranks

TOL = 1e-10
RUN_TOL = 1e-9
ADAPT_PROBLEM = (2, 2, 1.0, 6.0, 4, 2, 2)
POOL_PROBLEM = (2, 3, 1.0, 6.0, 6, 3, 3)
SELECTED = [2, 3, 5, 1]
THETAS = np.asarray([0.07, -0.05, 0.11, 0.03])
REPS = 2
STREAM_LATTICE = (7, 1, 1.0, 4.0, True)  # 1x7: 14 qubits, 12 local at D = 4
# terms that flip only the sharded qubits 0 and 1 (x_lo = 0): the tile
# kernel's Walsh-Hadamard diagonal with a != psi
STREAM_EXTRA = (("X0 X1", 0.3), ("Y0 Y1 Z5", -0.2), ("X1 Z9", 0.15), ("Y0 Z1", 0.1))
ADAPT_RUN = dict(n_epoch=1, threshold1=1e-2, threshold2=1e-1, x_dimension=2, y_dimension=2,
                 n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1.0, coulomb=6.0,
                 max_inner_iterations=10, plot=False, log_metrics=False)
HVA_RUN = dict(n_epoch=4, reps=REPS, lr=1e-2, x_dimension=2, y_dimension=2, n_electrons=4,
               n_spin_up=2, n_spin_down=2, tunneling=1.0, coulomb=6.0, plot=False,
               log_metrics=False)


def _random_state(n, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v)).astype(dtype)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the JAX problem's ground state (the ranks read the same
    ED cache) and the single-rank driver runs."""
    root = str(tmp_path_factory.mktemp("results"))
    jp = JaxProblem(*ADAPT_PROBLEM)
    _, gs = jp.ground_state()
    gs = np.asarray(gs)
    pool_problem = JaxProblem(*POOL_PROBLEM)
    pool_psi = _random_state(pool_problem.n_qubits, 3)
    pool_w = np.asarray(pool_problem.observables["H"].apply(jnp.asarray(pool_psi)))
    n_params = sum((REPS + 1, REPS * len(jp.hva_generators()[1]), REPS * len(jp.hva_generators()[0])))
    hva_init = 0.1 * np.random.default_rng(9).standard_normal(n_params)
    single = ADAPT(device="cpu", results_root=root, **ADAPT_RUN)
    single.run()
    hva = HVA(device="cpu", results_root=root, **HVA_RUN)
    hva.params_t.copy_(torch.as_tensor(hva_init))
    hva.run()
    inp = dict(adapt_problem=ADAPT_PROBLEM, selected=SELECTED, thetas=THETAS, gs=[gs],
               pool_problem=POOL_PROBLEM, pool_psi=pool_psi, pool_w=pool_w,
               hva_problem=ADAPT_PROBLEM, reps=REPS, hva_thetas=hva_init + 0.0,
               adapt_run=dict(ADAPT_RUN, results_root=root),
               hva_run=dict(HVA_RUN, results_root=root, init=hva_init))
    return dict(inp=inp, gs=gs, single=single, hva=hva, root=root)


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request, setup):
    d = request.param
    inp = dict(setup["inp"], stream_psi=_random_state(14, 23, np.complex64),
               stream_lattice=STREAM_LATTICE, stream_extra=STREAM_EXTRA)
    return d, spawn_ranks(bodies.parallel_cases, d, backend="gloo", device="cpu", timeout=240,
                          args=(inp,))


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The JAX functions on the virtual mesh of 2 devices (the sharded JAX
    engine's results do not depend on D beyond rounding; the ADAPT step and
    screen are also taken at D = 4 in their tests)."""
    jp = JaxProblem(*ADAPT_PROBLEM)
    gs_reim = [np.stack([setup["gs"].real, setup["gs"].imag])]
    mesh = jax_mesh(2)
    with mesh:
        train, params0, _ = jax_hva_train(jp, REPS, mesh, dtype=jnp.complex128, gs_reim=gs_reim,
                                          optimizer=optax.sgd(1.0))
        sizes = [params0[k].shape[0] for k in ("theta_U", "theta_v", "theta_h")]
        init = np.split(setup["inp"]["hva_thetas"], np.cumsum(sizes)[:-1])
        params = {k: jnp.asarray(v) for k, v in zip(("theta_U", "theta_v", "theta_h"), init)}
        out = train(params, optax.sgd(1.0).init(params))
        hva_train = dict(thetas=np.concatenate([np.asarray(out[0][k]) for k in
                                                ("theta_U", "theta_v", "theta_h")]),
                         e=float(out[2]), sz=float(out[3]), s2=float(out[4]),
                         fid=float(out[5]), gnorm=float(out[6]))
        shmap, _, _ = jax_hva_shmap(jp, REPS, mesh, dtype=jnp.complex128, lr=1e-2)
        flat = jnp.asarray(setup["inp"]["hva_thetas"])
        out = shmap(jnp.array(flat), optax.adam(1e-2).init(flat))
        hva_shmap = dict(thetas=np.asarray(out[0]), e=float(out[2]), gnorm=float(out[3]))
    return dict(hva_train=hva_train, hva_shmap=hva_shmap)


def _jax_adapt(d, gs):
    jp = JaxProblem(*ADAPT_PROBLEM)
    pool = jax_pool(2, 2)
    pool_rot = [jax_jw(g).rotation_terms() for g in pool]
    mesh = jax_mesh(d)
    th = jnp.asarray(THETAS)
    with mesh:
        step, _, _ = jax_adapt_step(jp, pool_rot, SELECTED, mesh, dtype=jnp.complex128,
                                    gs_reim=[np.stack([gs.real, gs.imag])],
                                    optimizer=optax.sgd(1.0))
        out = step(jnp.array(th), optax.sgd(1.0).init(th))
        screen = jax_screen_fn(jp, pool_rot, SELECTED, JaxPool([jax_jw(g) for g in pool], 8),
                               mesh, dtype=jnp.complex128)(th)
    return dict(thetas=np.asarray(out[0]), e=float(out[2]), sz=float(out[3]), s2=float(out[4]),
                fid=float(out[5]), gnorm=float(out[6])), np.asarray(screen)


def _same_on_every_rank(out, *keys):
    for r in out[1:]:
        for key in keys:
            a, b = out[0], r
            for k in key.split("."):
                a, b = a[k], b[k]
            assert np.array_equal(np.asarray(a), np.asarray(b)), key


# -- the mesh ----------------------------------------------------------------------------------


def test_mesh_and_local_qubits(ranks):
    d, out = ranks
    assert [r["rank"] for r in out] == list(range(d)) and all(r["size"] == d for r in out)
    mesh = amplitude_mesh(1, device="cpu")
    assert mesh.size == 1 and local_qubits(12, mesh) == 12
    assert local_qubits(12, comm_mesh(d)) == 12 - d.bit_length() + 1


def comm_mesh(d):
    from qsfh_torch.parallel.mesh import Mesh

    return Mesh(d, 0, "gloo", torch.device("cpu"))


def test_power_of_two_required_and_a_group():
    with pytest.raises(ValueError, match="power-of-two"):
        amplitude_mesh(6, device="cpu")
    with pytest.raises(RuntimeError, match="spawn_ranks"):
        amplitude_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="spawn_ranks"):
        ADAPT(device="cpu", mesh_devices=2, ground_truth=False, **ADAPT_RUN)


def test_a_hanging_group_fails_at_its_timeout():
    with pytest.raises(TimeoutError):
        spawn_ranks(bodies.hang, 2, backend="gloo", device="cpu", timeout=6)


# -- the ADAPT step, the screen, the pool screen ----------------------------------------------


def test_sharded_adapt_train_step_and_screen_match_jax(ranks, setup):
    """E, Sz, S^2, fidelity, gnorm and the gradient (thetas after one SGD
    step at lr 1) of build_sharded_adapt_train_step, and the pool gradients
    of build_sharded_screen_fn, against the JAX functions at the same D."""
    d, out = ranks
    ref, screen = _jax_adapt(d, setup["gs"])
    for r in out:
        for key in ("e", "sz", "s2", "fid", "gnorm"):
            assert abs(r["train"][key] - ref[key]) < TOL, key
        np.testing.assert_allclose(r["train"]["thetas"], ref["thetas"], rtol=0, atol=TOL)
        np.testing.assert_allclose(r["step"]["thetas"], ref["thetas"], rtol=0, atol=TOL)
        assert abs(r["step"]["e"] - ref["e"]) < TOL
        np.testing.assert_allclose(r["screen"], screen, rtol=0, atol=TOL)
    _same_on_every_rank(out, "train.thetas", "train.e", "screen")


def test_pool_screening_matches_jax(ranks, setup):
    d, out = ranks
    jp = JaxProblem(*POOL_PROBLEM)
    pool = JaxPool([jax_jw(g) for g in jax_pool(2, 3)], jp.n_qubits)
    mesh = jax_mesh(d)
    with mesh:
        ref = np.asarray(jax_pool_screen(pool, mesh)(jnp.asarray(setup["inp"]["pool_psi"]),
                                                     jnp.asarray(setup["inp"]["pool_w"])))
    for r in out:
        assert r["pool_screen"].shape == (pool.size,)
        np.testing.assert_allclose(r["pool_screen"], ref, rtol=0, atol=TOL)
    _same_on_every_rank(out, "pool_screen")


# -- HVA ---------------------------------------------------------------------------------------


def test_hva_steps_match_jax_and_each_other(ranks, jax_refs):
    """The train step (SGD at lr 1: the gradient) against JAX's
    build_sharded_hva_train_step; the shmap step against JAX's
    build_sharded_hva_step_shmap (Adam); the GSPMD form served by the
    explicit engine against the shmap step, as tests/test_parallel.py:288
    holds the two JAX forms."""
    _, out = ranks
    ref, shm = jax_refs["hva_train"], jax_refs["hva_shmap"]
    for r in out:
        for key in ("e", "sz", "s2", "fid", "gnorm"):
            assert abs(r["hva_train"][key] - ref[key]) < TOL, key
        np.testing.assert_allclose(r["hva_train"]["thetas"], ref["thetas"], rtol=0, atol=TOL)
        for key in ("e", "gnorm"):
            assert abs(r["hva_shmap"][key] - shm[key]) < TOL, key
            assert abs(r["hva_gspmd"][key] - r["hva_shmap"][key]) < 1e-12, key
        np.testing.assert_allclose(r["hva_shmap"]["thetas"], shm["thetas"], rtol=0, atol=TOL)
        np.testing.assert_allclose(r["hva_gspmd"]["thetas"], r["hva_shmap"]["thetas"], rtol=0,
                                   atol=1e-12)
    _same_on_every_rank(out, "hva_train.thetas", "hva_shmap.thetas")


# -- the partner form of the streaming expectation --------------------------------------------


def test_streaming_partner_expectation_matches_jax(ranks):
    """1x7 (14 qubits; 13 and 12 local qubits at D = 2 and 4) with terms on
    the sharded qubits alone, complex64: the port's partner form (the plain
    version of expectation_partner here) against JAX's
    sharded_expectation_stream (its Pallas kernels in interpret mode) at the
    same D; both x_hi != 0 and z_hi != 0 groups occur, and cross terms with
    x_lo = 0 (the tile kernel's diagonal with a != psi) are among them."""
    d, out = ranks
    psi = _random_state(14, 23, np.complex64)
    from qsfh_tpu.ops.pauli import qubit_operator

    h = jax_jw(jax_fermi_hubbard(*STREAM_LATTICE))
    for term in STREAM_EXTRA:
        h = h + qubit_operator(*term)
    mesh = jax_mesh(d)
    engine = JaxEngine(14, mesh)
    from qsfh_tpu.parallel import shard_statevector

    with mesh:
        ref = float(jax_stream(engine, h)(shard_statevector(jnp.asarray(psi), mesh)))
    for r in out:
        groups = r["stream"]["groups"]
        assert any(xh for xh, _ in groups) and any(zh for _, zh in groups)
        assert r["stream"]["x_lo_zero_cross"] > 0
        assert r["stream"]["e"] == pytest.approx(ref, abs=5e-5)
    _same_on_every_rank(out, "stream.e")


# -- the drivers on the mesh -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_adapt_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_adapt")
    run = JaxADAPT(results_root=str(root), **ADAPT_RUN)
    run.run()
    return run


def test_adapt_mesh_run_matches_single_rank_and_jax(ranks, setup, jax_adapt_run):
    """ADAPT(mesh_devices=D) over one 2x2 epoch: the single-rank run's
    selected operators and losses within 1e-9, and the JAX ADAPT's; the same
    bits of thetas on every rank; the state gathered from the shards."""
    _, out = ranks
    single, jax_run = setup["single"], jax_adapt_run
    for r in out:
        res = r["adapt_run"]["results"]
        assert res["selected operators"] == single.results["selected operators"]
        assert res["selected operators"] == jax_run.results["selected operators"]
        for key in ("iteration loss", "Sz", "S^2", "fidelity"):
            np.testing.assert_allclose(res[key], single.results[key], rtol=0, atol=RUN_TOL)
        np.testing.assert_allclose(res["epoch loss"], jax_run.results["epoch loss"], rtol=0,
                                   atol=RUN_TOL)
        np.testing.assert_allclose(r["adapt_run"]["state"], single.state().numpy(), rtol=0,
                                   atol=RUN_TOL)
        assert r["adapt_run"]["counts"]["exchanges"] > 0
    _same_on_every_rank(out, "adapt_run.thetas")


def test_hva_mesh_run_matches_single_rank(ranks, setup):
    """HVA(mesh_devices=D) from seeded angles: the single-rank run's losses,
    Sz, S^2 and fidelity within 1e-9, its final state, the same bits of
    thetas on every rank."""
    _, out = ranks
    hva = setup["hva"]
    for r in out:
        for key in ("loss", "Sz", "S^2", "fidelity"):
            np.testing.assert_allclose(r["hva_run"]["results"][key], hva.results[key], rtol=0,
                                       atol=RUN_TOL)
        np.testing.assert_allclose(r["hva_run"]["thetas"], hva.params_t.numpy(), rtol=0,
                                   atol=RUN_TOL)
        np.testing.assert_allclose(r["hva_run"]["state"], hva.state().numpy(), rtol=0,
                                   atol=RUN_TOL)
    _same_on_every_rank(out, "hva_run.thetas")
