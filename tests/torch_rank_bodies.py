"""Rank bodies of the sharded-engine tests (``tests/test_torch_shmap_engine.py``,
``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_evolution.py``,
``tests/test_torch_cli.py``).

Each function runs on every rank of a group that ``qsfh_torch.parallel.
spawn_ranks`` started, takes the mesh and plain host inputs, and returns
host values (full states gathered from the shards, scalars, parameter
vectors).  This module imports no JAX, so a rank does not pay its import;
the tests compute the JAX references in their own process.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qsfh_torch.parallel import comm
from qsfh_torch.parallel.mesh import gather_statevector, local_qubits, shard_statevector


def _full(t, mesh):
    return gather_statevector(t, mesh).numpy()


def engine_cases(mesh, psi, n, cases, rot, op_terms, two_qubit, unitary, hubbard, hpsi):
    """Every case of the shmap-engine test on this rank's shard of psi (and
    of hpsi for the Hubbard problem ``hubbard``)."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.ops.pauli import qubit_operator
    from qsfh_torch.parallel.sharded_compiled import (apply_generator, expectation_local,
                                                      generator_rotation, pack_generator,
                                                      pack_observable)
    from qsfh_torch.parallel.shmap_engine import ShardedPauliEngine, sharded_expectation

    eng = ShardedPauliEngine(n, mesh)
    pl = shard_statevector(torch.as_tensor(psi), mesh)
    out = {"n_local": local_qubits(n, mesh)}
    for name, x, z in cases:
        out[f"apply {name}"] = _full(eng.apply_pauli(pl, x, z), mesh)
        out[f"rotation {name}"] = _full(eng.pauli_rotation(pl, x, z, 0.37), mesh)
    out["generator"] = _full(eng.generator_rotation(pl, rot, 0.8), mesh)
    packed = pack_generator(eng, rot, allow_noncommuting=True)
    fwd = generator_rotation(eng, pl, packed, 0.8)
    out["generator_packed"] = _full(fwd, mesh)
    out["generator_inverse"] = _full(generator_rotation(eng, fwd, packed, 0.8, inverse=True), mesh)
    out["apply_generator_packed"] = _full(apply_generator(eng, pl, packed), mesh)
    out["apply_generator"] = _full(eng.apply_generator(pl, rot), mesh)
    op = qubit_operator(*op_terms[0])
    for term in op_terms[1:]:
        op = op + qubit_operator(*term)
    out["expectation"] = float(sharded_expectation(eng, op)(pl))
    out["apply_paulisum"] = _full(eng.apply_paulisum(pl, op), mesh)
    for qa, qb, M in two_qubit:
        out[f"two {qa} {qb}"] = _full(eng.apply_two_qubit(pl, M, qa, qb), mesh)
    out["unitary"] = _full(eng.apply_two_qubit(pl, unitary, 1, 7), mesh)
    p = HubbardProblem(*hubbard)
    heng = ShardedPauliEngine(p.n_qubits, mesh)
    hpsi_l = shard_statevector(torch.as_tensor(hpsi), mesh)
    out["hubbard"] = float(heng.expectation(hpsi_l, p.qubit_hamiltonian))
    out["hubbard_packed"] = float(expectation_local(heng, hpsi_l,
                                                    pack_observable(heng, p.qubit_hamiltonian)))
    occ = tuple(p.spin_up_indices + p.spin_down_indices)
    basis = heng.basis_state(occ, torch.complex128)
    out["basis"] = _full(basis, mesh)
    net = heng.givens_network(basis, p.diagonal, p.decomposition)
    out["network"] = _full(net, mesh)
    out["network_inverse"] = _full(heng.givens_network_inverse(net, p.diagonal,
                                                               p.decomposition), mesh)
    out["rz_layer"] = _full(eng.rz_layer(pl, [0.1 * (q + 1) for q in range(n)]), mesh)
    return out


def stacked_pair_sweep(mesh, psi, lam, terms, thetas):
    """A rot program's forward state and its adjoint gradient on the shards
    (``ShardedRotations``), with the exchanges counted."""
    from qsfh_torch.parallel.sharded_compiled import ShardedRotations
    from qsfh_torch.parallel.shmap_engine import ShardedPauliEngine

    n = int(np.log2(psi.shape[0]))
    eng = ShardedPauliEngine(n, mesh)
    prog = ShardedRotations(eng, [("rot", tuple(t), k) for k, t in enumerate(terms)])
    th = torch.as_tensor(thetas)
    comm.reset_counts()
    fwd = prog.apply(shard_statevector(torch.as_tensor(psi), mesh), th)
    exchanges = comm.counts()["exchanges"]
    grads = prog.adjoint(fwd, shard_statevector(torch.as_tensor(lam), mesh), th)
    return dict(state=_full(fwd, mesh), grads=grads.numpy(), exchanges=exchanges,
                runs=[m for m, _ in prog.pieces])


def _problem(cfg):
    from qsfh_torch.algos.base import HubbardProblem

    return HubbardProblem(*cfg)


def parallel_cases(mesh, inp):
    """The cases of ``tests/test_torch_parallel.py`` on one group."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.algos.hva import HVA
    from qsfh_torch.engine.expectation import PackedPool
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified
    from qsfh_torch.parallel import (build_sharded_hva_step, build_sharded_hva_step_shmap,
                                     build_sharded_hva_train_step, sharded_expectation_stream)
    from qsfh_torch.parallel.pool_screening import build_sharded_pool_screen
    from qsfh_torch.parallel.sharded_adapt import (build_sharded_adapt_step,
                                                   build_sharded_adapt_train_step,
                                                   build_sharded_screen_fn)
    from qsfh_torch.parallel.shmap_engine import ShardedPauliEngine
    from qsfh_torch.parallel.sharded_stream import pack_stream_groups

    out = {"size": mesh.size, "rank": mesh.rank}
    dev = mesh.device
    c128 = torch.complex128

    # the ADAPT train step (SGD at lr 1: thetas - grads) and the screen
    p = _problem(inp["adapt_problem"])
    pool = hubbard_interaction_pool_simplified(p.x_dimension, p.y_dimension)
    pool_rot = [jordan_wigner(g).rotation_terms() for g in pool]
    sel = inp["selected"]
    th = torch.as_tensor(inp["thetas"], device=dev)
    gs = [torch.as_tensor(g) for g in inp["gs"]]
    step, th0, _ = build_sharded_adapt_train_step(p, pool_rot, sel, mesh, c128, gs=gs)
    assert th0.shape == th.shape and not th0.any()
    t = th.clone()
    _, _, e, sz, s2, fid, gn = step(t, torch.optim.SGD([t], lr=1.0))
    out["train"] = dict(thetas=t.numpy(), e=float(e), sz=float(sz), s2=float(s2), fid=float(fid),
                        gnorm=float(gn))
    step4, _, _ = build_sharded_adapt_step(p, pool_rot, sel, mesh, c128)
    t = th.clone()
    _, _, e, gn = step4(t, torch.optim.SGD([t], lr=1.0))
    out["step"] = dict(thetas=t.numpy(), e=float(e), gnorm=float(gn))
    packed_pool = PackedPool([jordan_wigner(g) for g in pool], p.n_qubits)
    out["screen"] = build_sharded_screen_fn(p, pool_rot, sel, packed_pool, mesh, c128)(th).numpy()

    # pool screening: the pool's terms over the ranks, the states whole
    pp = _problem(inp["pool_problem"])
    pool_p = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(
        pp.x_dimension, pp.y_dimension)], pp.n_qubits)
    out["pool_screen"] = build_sharded_pool_screen(pool_p, mesh)(
        torch.as_tensor(inp["pool_psi"]), torch.as_tensor(inp["pool_w"])).numpy()

    # the HVA steps: the train step (SGD), the 4-tuple step and the GSPMD form (Adam)
    hp, reps = _problem(inp["hva_problem"]), inp["reps"]
    hth = torch.as_tensor(inp["hva_thetas"], device=dev)
    train, h0, _ = build_sharded_hva_train_step(hp, reps, mesh, c128, gs=gs)
    assert h0.shape == hth.shape
    t = hth.clone()
    _, _, e, sz, s2, fid, gn = train(t, torch.optim.SGD([t], lr=1.0))
    out["hva_train"] = dict(thetas=t.numpy(), e=float(e), sz=float(sz), s2=float(s2),
                            fid=float(fid), gnorm=float(gn))
    shmap, _, _ = build_sharded_hva_step_shmap(hp, reps, mesh, c128, lr=1e-2)
    t = hth.clone()
    _, _, e, gn = shmap(t, torch.optim.Adam([t], lr=1e-2))
    out["hva_shmap"] = dict(thetas=t.numpy(), e=float(e), gnorm=float(gn))
    gspmd, params0, _ = build_sharded_hva_step(hp, reps, mesh, c128, lr=1e-2)
    sizes = [v.shape[0] for v in params0.values()]
    params = {k: v.clone() for k, v in zip(params0, torch.split(hth.clone(), sizes))}
    params, _, e, gn = gspmd(params, torch.optim.Adam(list(params.values()), lr=1e-2))
    out["hva_gspmd"] = dict(thetas=torch.cat(list(params.values())).numpy(), e=float(e),
                            gnorm=float(gn))

    # the partner form of the streaming expectation (complex64)
    if "stream_psi" in inp:
        from qsfh_torch.ops.jw import jordan_wigner as jw
        from qsfh_torch.ops.lattice import fermi_hubbard

        from qsfh_torch.ops.pauli import qubit_operator

        h = jw(fermi_hubbard(*inp["stream_lattice"]))
        for term in inp["stream_extra"]:
            h = h + qubit_operator(*term)
        n = int(np.log2(inp["stream_psi"].shape[0]))
        eng = ShardedPauliEngine(n, mesh)
        fn = sharded_expectation_stream(eng, h)
        psi = shard_statevector(torch.as_tensor(inp["stream_psi"]), mesh)
        out["stream"] = dict(e=float(fn(psi)),
                             groups=sorted(pack_stream_groups(h, n, eng.k)),
                             x_lo_zero_cross=int(sum(
                                 int((xlo == 0).sum()) for (xh, _), (xlo, *_r) in
                                 pack_stream_groups(h, n, eng.k).items() if xh)))

    # the drivers: one ADAPT epoch and an HVA run on the mesh
    if "adapt_run" in inp:
        cfg = inp["adapt_run"]
        comm.reset_counts()
        t0 = time.perf_counter()
        a = ADAPT(mesh_devices=mesh.size, device=dev, **cfg)
        a.run()
        out["adapt_run"] = dict(results=a.results, thetas=a.params_t.numpy(),
                                seconds=time.perf_counter() - t0, counts=comm.counts(),
                                state=a.state().numpy())
    if "hva_run" in inp:
        cfg = dict(inp["hva_run"])
        init = cfg.pop("init")
        v = HVA(mesh_devices=mesh.size, device=dev, **cfg)
        v.params_t.copy_(torch.as_tensor(init))
        v.run()
        out["hva_run"] = dict(results=v.results, thetas=v.params_t.numpy(),
                              state=v.state().numpy())
    return out


def hang(mesh):
    """Rank 1 waits for an exchange that rank 0 never makes."""
    if mesh.rank == 1:
        comm.exchange(torch.zeros(4), 1)
    time.sleep(600)


# -- the sharded evolution, spectroscopy and multistart (test_torch_parallel_evolution.py) --

# the ScheduledEvolution case's couplings (a U ramp and a t schedule of 5 steps)
T_RAMP = np.linspace(1.0, 0.5, 5)


def u_ramp(tau):
    return 4.0 + 8.0 * tau


def _with_collectives(fn):
    """(fn(), the collectives it made)."""
    comm.reset_counts()
    out = fn()
    return out, comm.counts()


def evolution_cases(mesh, inp):
    """Every case of ``tests/test_torch_parallel_evolution.py`` on one group,
    complex128 on the shards: Trotter, a schedule, Green's functions, ITE and
    its thermal estimate, Lanczos and both spectral drivers, multistart; each
    with its collectives counted."""
    from qsfh_torch.algos.dynamics import ScheduledEvolution, TrotterEvolution, greens_function
    from qsfh_torch.algos.ite import ImaginaryTimeEvolution
    from qsfh_torch.algos.multistart import MultistartHVA
    from qsfh_torch.linalg.spectral import (dynamical_structure_factor, lanczos_tridiagonal,
                                            spectral_function_lanczos)
    from qsfh_torch.parallel.sharded_compiled import ShardedObservable

    c128 = torch.complex128
    out = {"rank": mesh.rank, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now

    p = _problem(inp["quench"])
    obs = {"H": p.observables["H"]}
    psi0 = inp["psi0"]

    ev = TrotterEvolution(p, dt=0.05, order=2, dtype=c128, mesh=mesh)
    (psi, rec), counts = _with_collectives(lambda: ev.evolve(psi0, 20, obs))
    psi_s, rec_s = ev.evolve(shard_statevector(torch.as_tensor(psi0), mesh), 20, obs)
    out["trotter"] = dict(state=_full(psi, mesh), H=rec["H"], counts=counts,
                          pair_runs=ev.program.exchanges,
                          cross=len(ev.sharded(obs["H"]).cross),
                          shard_in_same=bool(torch.equal(psi, psi_s)
                                             and np.array_equal(rec["H"], rec_s["H"])))

    sched = ScheduledEvolution(p, dt=0.08, order=2, dtype=c128, mesh=mesh)
    psi, rec = sched.evolve(psi0, 5, observables=obs, overlaps={"psi0": psi0}, coulomb=u_ramp,
                            tunneling=T_RAMP)
    out["scheduled"] = dict(state=_full(psi, mesh), **rec)
    lap("real time")

    out["greens"] = {}
    for kind in ("particle", "hole"):
        times, g = greens_function(p, inp["greens_gs"], -3.1, 0, dt=0.1, n_steps=5, kind=kind,
                                   dtype=c128, mesh=mesh)
        out["greens"][kind] = dict(times=times, G=g)
    lap("greens")

    pi = _problem(inp["ite"])
    ite = ImaginaryTimeEvolution(pi, dbeta=0.05, order=2, dtype=c128, mesh=mesh)
    (psi, rec), counts = _with_collectives(lambda: ite.run(inp["ite_v"], n_steps=7, block=3))
    out["ite"] = dict(state=_full(psi, mesh), counts=counts,
                      cross=len(ite.sharded_h.cross), **rec)
    thermal = ImaginaryTimeEvolution(pi, dbeta=0.05, order=4, dtype=c128, mesh=mesh)
    est, diag = thermal.thermal_expectation(1.0, {"H": pi.observables["H"]},
                                            draws=inp["thermal_draws"])
    out["thermal"] = dict(estimates=est, diagnostics=diag)
    lap("imaginary time")

    ps = _problem(inp["spectral"])
    from qsfh_torch.parallel.shmap_engine import ShardedPauliEngine

    ham = ShardedObservable.of(ShardedPauliEngine(ps.n_qubits, mesh), ps.qubit_hamiltonian)
    (a, b, n2), counts = _with_collectives(lambda: lanczos_tridiagonal(
        lambda v: ham.apply(v), torch.as_tensor(inp["lanczos_phi"]), 12, mesh=mesh,
        n_qubits=ps.n_qubits))
    out["lanczos"] = dict(alphas=a, betas=b, norm2=n2, counts=counts)
    gs, e0, omegas = inp["spectral_gs"], inp["spectral_e0"], inp["omegas"]
    out["spectral"] = {
        f"{kind} {mode}": spectral_function_lanczos(ps, gs, e0, mode, kind, m=inp["spectral_m"],
                                                    omegas=omegas, dtype=c128, mesh=mesh)
        for kind, mode in inp["spectral_modes"]}
    out["dsf"] = {
        f"{kind} {q}": dynamical_structure_factor(ps, gs, e0, q, kind=kind, m=inp["spectral_m"],
                                                  omegas=omegas, eta=0.1, dtype=c128,
                                                  mesh=mesh)
        for kind, q in inp["dsf_cases"]}
    lap("lanczos")

    ms = MultistartHVA(mesh_devices=mesh.size, device=mesh.device, dtype=c128,
                       **inp["multistart"])
    res, counts = _with_collectives(ms.run)
    out["multistart"] = dict(result=res, counts=counts,
                             leaves=len(ms.batch_params))
    lap("multistart")
    return out
